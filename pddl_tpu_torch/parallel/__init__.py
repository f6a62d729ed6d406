"""Distribution strategies: the reference's four modes on
``torch.distributed`` (the port of :mod:`pddl_tpu.parallel`).

Reference surface (SURVEY.md §1-§2):

- none / single device (``imagenet-resnet50.py``)
- ``tf.distribute.MirroredStrategy`` (``imagenet-resnet50-mirror.py:21``)
- ``tf.distribute.MultiWorkerMirroredStrategy`` + Slurm + NCCL
  (``imagenet-resnet50-multiworkers.py:16-25``)
- ``ParameterServerStrategy`` + ``MinSizePartitioner`` + gRPC cluster
  (``imagenet-resnet50-ps.py:31-84``)
- Horovod (``imagenet-resnet50-hvd.py``) — lives in
  :mod:`pddl_tpu_torch.compat.hvd` as an API shim over the same core.

Beyond the reference: tensor and expert parallelism
(:class:`TensorParallelStrategy`, :class:`ExpertParallelStrategy`,
``parallel/tensor_parallel.py``) over the mesh's ``model`` and ``expert``
axes, pipeline parallelism (:class:`PipelineStrategy`,
``parallel/pipeline.py``) over its ``stage`` axis, and sequence
parallelism over its ``seq`` axis (a mirrored strategy over a
``data`` x ``seq`` mesh, ``parallel/base.py``).

One process per device; a Strategy decides (a) which processes form the
mesh, (b) where optimizer state and weights live, (c) batch-size
arithmetic, (d) who logs/saves.
"""

from pddl_tpu_torch.parallel.base import Strategy, get_strategy
from pddl_tpu_torch.parallel.single import SingleDeviceStrategy
from pddl_tpu_torch.parallel.mirrored import MirroredStrategy
from pddl_tpu_torch.parallel.multiworker import MultiWorkerMirroredStrategy
from pddl_tpu_torch.parallel.ps import ParameterServerStrategy
from pddl_tpu_torch.parallel.tensor_parallel import (
    ExpertParallelStrategy,
    TensorParallelStrategy,
)
from pddl_tpu_torch.parallel.pipeline import PipelineStrategy

__all__ = [
    "Strategy",
    "get_strategy",
    "SingleDeviceStrategy",
    "MirroredStrategy",
    "MultiWorkerMirroredStrategy",
    "ParameterServerStrategy",
    "TensorParallelStrategy",
    "ExpertParallelStrategy",
    "PipelineStrategy",
]
