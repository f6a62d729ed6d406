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

One process per device; a Strategy decides (a) which processes form the
mesh, (b) where optimizer state lives, (c) batch-size arithmetic, (d) who
logs/saves. Tensor, expert and pipeline parallelism are ROADMAP.md queue
1 item 7: ``get_strategy`` names it for them.
"""

from pddl_tpu_torch.parallel.base import Strategy, get_strategy
from pddl_tpu_torch.parallel.single import SingleDeviceStrategy
from pddl_tpu_torch.parallel.mirrored import MirroredStrategy
from pddl_tpu_torch.parallel.multiworker import MultiWorkerMirroredStrategy
from pddl_tpu_torch.parallel.ps import ParameterServerStrategy

__all__ = [
    "Strategy",
    "get_strategy",
    "SingleDeviceStrategy",
    "MirroredStrategy",
    "MultiWorkerMirroredStrategy",
    "ParameterServerStrategy",
]
