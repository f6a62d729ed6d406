"""Multi-worker mirrored strategy: multi-host sync data parallelism (the
port of :mod:`pddl_tpu.parallel.multiworker`).

Parity with ``tf.distribute.MultiWorkerMirroredStrategy`` + Slurm resolver +
NCCL (``imagenet-resnet50-multiworkers.py:16-25``). The resolver/NCCL-options
block collapses into :func:`pddl_tpu_torch.core.dist.initialize` (``PDDL_*``,
Slurm or torchrun discovery) plus one mesh over every process of the job;
the gradient all-reduce is NCCL's, inside a host over NVLink and between
hosts over the network.

Dataset sharding follows the DATA auto-shard policy the reference sets
(``imagenet-resnet50-multiworkers.py:66-69``): each process feeds its local
part of the global batch (``SyntheticImageClassification(process_index=,
process_count=)``), and the parts in rank order are the global batch.

Failure detection (the capability the reference waves at with
``GRPC_FAIL_FAST`` and a Horovod re-broadcast comment, SURVEY.md §5):
a lost worker does not produce a tidy error — the surviving processes
HANG in the next collective. :class:`HeartbeatMonitor` turns that hang
into a detection: every process beats a per-worker file on the shared
checkpoint filesystem at batch boundaries (atomic replace, no
coordination), and every process checks the others' beat ages on a
coarser cadence. A stale beat raises :class:`WorkerLost` / flips the
shared RESTART marker, so every survivor exits its step loop at a batch
boundary instead of hanging in the dead collective. The beat files and the
marker are the JAX package's, so either package's workers read the
other's. :class:`HeartbeatCallback` packages the beat/check/stop cycle as
a Trainer callback.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

from pddl_tpu_torch.core import dist
from pddl_tpu_torch.core.mesh import MeshConfig, build_hybrid_mesh, build_mesh
from pddl_tpu_torch.parallel.base import Strategy, register_strategy
from pddl_tpu_torch.train.callbacks import Callback

log = logging.getLogger(__name__)


@register_strategy("multiworker")
class MultiWorkerMirroredStrategy(Strategy):
    """Data parallelism over every device of every participating host."""

    def __init__(self, coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 hybrid: bool = False, device=None,
                 backend: Optional[str] = None):
        super().__init__(MeshConfig(), device=device, backend=backend)
        self._bootstrap = (coordinator_address, num_processes, process_id)
        self._hybrid = hybrid
        self.cluster: Optional[dist.ClusterSpec] = None

    def setup(self):
        if self._mesh is None:
            self.cluster = self._initialize(*self._bootstrap)
            # A hybrid mesh orders the data axis host-major, so the
            # all-reduce is hierarchical (inside a host, then between).
            build = build_hybrid_mesh if self._hybrid else build_mesh
            self._mesh = build(MeshConfig(), device=self._device)
        return self._mesh

    @property
    def num_workers(self) -> int:
        """Worker count as the reference derives from ``SLURM_NTASKS``
        (``imagenet-resnet50-multiworkers.py:29``)."""
        return dist.process_count()


# ---------------------------------------------------------------------------
# Failure detection: shared-filesystem heartbeats + coordinated restart.


class WorkerLost(RuntimeError):
    """One or more workers stopped heartbeating — the collective they
    were part of will never complete. Carries the lost process ids."""

    def __init__(self, lost, timeout_s: float):
        self.lost = sorted(lost)
        super().__init__(
            f"worker(s) {self.lost} missed the heartbeat deadline "
            f"({timeout_s:.1f}s) — coordinate a restart at the new "
            "world size and resume from the shared checkpoint")


class HeartbeatMonitor:
    """Worker liveness over a shared directory — no extra network.

    Each process atomically replaces ``hb_<pid>`` with the current
    wall-clock time (`beat`); any process can ask who has gone quiet
    (`failed` / `check`). The directory rides the checkpoint
    filesystem (GCS/NFS — already required for multi-host saves), so
    detection needs no side channel that could itself be partitioned
    away from the data path.

    Coordinated restart: `request_restart` drops one RESTART marker
    every worker polls (`restart_requested`) at batch boundaries — the
    survivors exit their step loops cleanly instead of hanging in the
    dead collective, and the relaunched job clears the marker
    (`clear_restart`) before resuming from the shared checkpoint.

    ``clock`` is injectable (tests drive fake time); it must be a
    WALL clock shared across hosts (``time.time``), not a per-process
    monotonic clock.
    """

    def __init__(self, directory: str, process_id: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 timeout_s: float = 60.0, clock=time.time):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.process_id = (process_id if process_id is not None
                           else dist.process_index())
        self.num_processes = (num_processes if num_processes is not None
                              else dist.process_count())
        self.timeout_s = float(timeout_s)
        self._clock = clock
        # Never-beat grace reference: a worker that never starts is as
        # lost as one that dies, but only after a full timeout from
        # when WE started watching (start() refreshes it).
        self._started_s = float(clock())

    # ------------------------------------------------------------ paths
    def _beat_path(self, pid: int) -> str:
        return os.path.join(self.directory, f"hb_{pid}")

    @property
    def _restart_path(self) -> str:
        return os.path.join(self.directory, "RESTART")

    # ------------------------------------------------------------ beats
    def beat(self) -> None:
        """Stamp this worker alive (atomic replace: readers never see a
        torn timestamp)."""
        path = self._beat_path(self.process_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(repr(float(self._clock())))
        os.replace(tmp, path)

    def last_seen(self) -> Dict[int, Optional[float]]:
        """Beat timestamp per expected worker (None = never beat)."""
        out: Dict[int, Optional[float]] = {}
        for pid in range(self.num_processes):
            try:
                with open(self._beat_path(pid)) as f:
                    out[pid] = float(f.read().strip())
            except (OSError, ValueError):
                out[pid] = None
        return out

    def failed(self) -> List[int]:
        """Workers whose beat is stale (or missing) for more than a
        timeout since max(their last beat, this monitor's start) — the
        grace from OUR start covers both a worker that never launches
        and a relaunched incarnation reading the previous run's stale
        beat files: every peer gets one fresh timeout from the moment
        this monitor begins watching."""
        now = float(self._clock())
        lost = []
        for pid, seen in self.last_seen().items():
            if pid == self.process_id:
                continue
            ref = max(seen, self._started_s) if seen is not None \
                else self._started_s
            if now - ref > self.timeout_s:
                lost.append(pid)
        return lost

    def start(self) -> None:
        """Open the never-beat grace window and stamp our first beat."""
        self._started_s = float(self._clock())
        self.beat()

    def check(self) -> None:
        """Raise :class:`WorkerLost` if anyone has gone quiet."""
        lost = self.failed()
        if lost:
            raise WorkerLost(lost, self.timeout_s)

    # ----------------------------------------------- coordinated restart
    def request_restart(self, reason: str = "") -> None:
        tmp = f"{self._restart_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(reason or f"requested by process {self.process_id}")
        os.replace(tmp, self._restart_path)

    def restart_requested(self) -> bool:
        return os.path.exists(self._restart_path)

    def clear_restart(self) -> None:
        try:
            os.remove(self._restart_path)
        except FileNotFoundError:
            pass


class HeartbeatCallback(Callback):
    """The beat/check/stop cycle as a Trainer callback.

    Beats every batch (one atomic file replace — microseconds against a
    training step), checks the fleet every ``check_every_steps``. On
    detection it requests the coordinated restart, stops training at
    the batch boundary (``trainer.stop_training``, so every callback
    gets its train-end hook), and re-raises :class:`WorkerLost` at train end so
    the supervisor sees a non-zero exit. Workers that merely OBSERVE
    the restart marker stop the same way without raising — only the
    detector reports. Compose with ``CheckpointEveryN`` + a relaunch at
    the new world size + ``fit(resume=...)`` for the full elastic
    story: a save is world-size free (``ckpt/checkpoint.py``).
    """

    def __init__(self, monitor: HeartbeatMonitor,
                 check_every_steps: int = 10):
        self.monitor = monitor
        self.check_every_steps = max(1, int(check_every_steps))
        self.lost: Optional[WorkerLost] = None
        self._n = 0

    def on_train_begin(self):
        self.lost = None
        self._n = 0
        # A new incarnation starts clean: the previous run's RESTART
        # marker did its job (every survivor stopped); leaving it would
        # stop the relaunched job on its first batch. Stale beat files
        # are covered by start()'s fresh grace window.
        self.monitor.clear_restart()
        self.monitor.start()
        return None

    def on_train_batch_end(self, step, logs):
        self.monitor.beat()
        self._n += 1
        if self._n % self.check_every_steps:
            return None
        # Marker poll AND liveness check ride the same coarse cadence:
        # both are shared-filesystem metadata round-trips, and their
        # consumer (a supervisor relaunch after a heartbeat timeout)
        # tolerates seconds of latency — only the beat itself needs to
        # be per-batch.
        if self.monitor.restart_requested():
            log.warning("heartbeat: restart requested by another worker "
                        "— stopping at the batch boundary")
            self.trainer.stop_training = True
            return None
        try:
            self.monitor.check()
        except WorkerLost as lost:
            log.error("heartbeat: %s", lost)
            self.lost = lost
            self.monitor.request_restart(str(lost))
            self.trainer.stop_training = True
        return None

    def on_train_end(self, logs):
        if self.lost is not None:
            raise self.lost
        return None
