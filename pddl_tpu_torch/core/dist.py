"""Multi-process bootstrap on ``torch.distributed`` (the port of
:mod:`pddl_tpu.core.dist`).

The port keeps PyTorch's layout of one process per device, the layout of
the reference's Horovod and multi-worker scripts
(``imagenet-resnet50-hvd.py:16,36-41``). Every process calls
:func:`initialize` once; it opens the default process group over TCP to
the coordinator, NCCL when the process trains on a ``cuda`` device and gloo
on the ``cpu``.

Discovery order for the coordinator and this process's place in the job:

1. explicit arguments,
2. ``PDDL_COORDINATOR`` / ``PDDL_NUM_PROCESSES`` / ``PDDL_PROCESS_ID``,
3. Slurm (``SLURM_STEP_NODELIST`` / ``SLURM_NTASKS`` / ``SLURM_PROCID``),
4. torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
   ``RANK``, in the place of the JAX package's TPU-pod metadata step,
   which has no counterpart on a GPU host.

A single process opens no group, as the JAX function initializes nothing,
so a script runs unchanged from one device to many. A group that already
exists (opened by torchrun's caller or by hand) is used as it is.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Optional

import torch
import torch.distributed as tdist

log = logging.getLogger(__name__)

_DEFAULT_PORT = 8476


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Resolved multi-host process layout (the ``ClusterSpec`` analogue)."""

    coordinator_address: Optional[str]
    num_processes: int
    process_id: int

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def _first_slurm_host(nodelist: str) -> str:
    """Expand the first host of a Slurm nodelist like ``nid[001-004]``.

    Mirrors what ``SlurmClusterResolver`` does internally to pick worker 0
    as chief.
    """
    m = re.match(r"([^\[,]+)(?:\[(\d+)[-,\d]*\])?", nodelist.strip())
    if not m:
        return nodelist.split(",")[0]
    base, first = m.group(1), m.group(2)
    return f"{base}{first}" if first else base


def resolve_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> ClusterSpec:
    """Resolve the process layout from args > PDDL_* env > Slurm env."""
    env = os.environ
    coord = coordinator_address or env.get("PDDL_COORDINATOR")
    nproc = num_processes if num_processes is not None else _int_env("PDDL_NUM_PROCESSES")
    pid = process_id if process_id is not None else _int_env("PDDL_PROCESS_ID")

    if nproc is None and "SLURM_NTASKS" in env:
        nproc = int(env["SLURM_NTASKS"])
    if pid is None and "SLURM_PROCID" in env:
        pid = int(env["SLURM_PROCID"])
    if coord is None and "SLURM_STEP_NODELIST" in env:
        coord = f"{_first_slurm_host(env['SLURM_STEP_NODELIST'])}:{_DEFAULT_PORT}"
    elif coord is None and "SLURM_JOB_NODELIST" in env:
        coord = f"{_first_slurm_host(env['SLURM_JOB_NODELIST'])}:{_DEFAULT_PORT}"

    return ClusterSpec(coord, nproc or 1, pid or 0)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _torchrun_cluster() -> Optional[ClusterSpec]:
    """Step 4: the layout torchrun exports, None when it exported none."""
    env = os.environ
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        return None
    return ClusterSpec(f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', _DEFAULT_PORT)}",
                       int(env["WORLD_SIZE"]), int(env.get("RANK", "0")))


def backend_for(device) -> str:
    """NCCL for a ``cuda`` device, gloo for the ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> ClusterSpec:
    """Open the default process group if (and only if) running
    multi-process. Idempotent.

    ``backend`` defaults to :func:`backend_for` the process's ``device``
    (``None`` means ``cuda``: entry points run on the card).
    """
    if tdist.is_initialized():
        return ClusterSpec(coordinator_address, tdist.get_world_size(),
                           tdist.get_rank())
    spec = resolve_cluster(coordinator_address, num_processes, process_id)
    if not spec.is_multiprocess:
        spec = _torchrun_cluster() or spec
    if spec.is_multiprocess:
        if spec.coordinator_address is None:
            raise ValueError(
                f"{spec.num_processes} processes but no coordinator address: "
                "pass coordinator_address or set PDDL_COORDINATOR")
        backend = backend or backend_for(device or "cuda")
        log.info("init_process_group(%s, tcp://%s, world_size=%d, rank=%d)",
                 backend, spec.coordinator_address, spec.num_processes,
                 spec.process_id)
        tdist.init_process_group(
            backend, init_method=f"tcp://{spec.coordinator_address}",
            world_size=spec.num_processes, rank=spec.process_id)
    return spec


def process_index() -> int:
    """This process's rank (Horovod ``rank()`` / TF ``task_id``); 0 with
    no process group."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    """Number of processes in the job (Horovod ``size()``); 1 with no
    process group."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the chief process — gates logging/saving the way the
    reference gates on ``hvd.rank() == 0``
    (``imagenet-resnet50-hvd.py:28,96,117``)."""
    return process_index() == 0


def local_size() -> int:
    """Processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else every
    process of the job (one host)."""
    v = _int_env("LOCAL_WORLD_SIZE")
    return v if v is not None else process_count()


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``, Slurm's
    ``SLURM_LOCALID``, else the rank modulo :func:`local_size`): the card
    it drives, ``cuda:{local_rank}``."""
    for name in ("LOCAL_RANK", "SLURM_LOCALID"):
        v = _int_env(name)
        if v is not None:
            return v
    return process_index() % local_size()


def default_device() -> torch.device:
    """``cuda:{local_rank()}``, the card this process drives."""
    return torch.device("cuda", local_rank())
