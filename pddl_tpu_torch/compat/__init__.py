"""API-compat shims for the reference's third-party distribution APIs (the
port of :mod:`pddl_tpu.compat`).

Currently: :mod:`pddl_tpu_torch.compat.hvd`, a Horovod-surface shim
(``import pddl_tpu_torch.compat.hvd as hvd``) covering everything
``imagenet-resnet50-hvd.py`` uses, on ``torch.distributed``.
"""
