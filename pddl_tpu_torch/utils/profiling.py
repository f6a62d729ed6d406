"""Tracing / profiling: the observability layer the reference lacks (the
port of :mod:`pddl_tpu.utils.profiling`, on ``torch.profiler``).

The reference's entire measurement surface is one wall-clock print around
``model.fit`` on Horovod rank 0 (``imagenet-resnet50-hvd.py:119-126``).
Here: ``torch.profiler`` traces of CPU and CUDA activity (Chrome trace
JSON, which TensorBoard's PyTorch profiler plugin and ``chrome://tracing``
read, with every kernel launch and its device time), named regions on the
trace timeline, per-step timing on the device, and images/sec per device.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from pddl_tpu_torch.core import dist
from pddl_tpu_torch.core.mesh import global_device_count
from pddl_tpu_torch.train.callbacks import Callback


@contextlib.contextmanager
def trace(name: str, step: Optional[int] = None):
    """Annotate a host-side region so it shows up on the trace timeline
    (a ``torch.profiler.record_function`` range; ``step`` names it
    ``"{name} step {step}"``, so the timeline groups device work by
    training step)."""
    label = name if step is None else f"{name} step {step}"
    with torch.profiler.record_function(label):
        yield


def _sync(device=None) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _start(logdir: str) -> torch.profiler.profile:
    """A running profiler over CPU and CUDA activity (what this build of
    torch can trace) that writes its Chrome trace into ``logdir`` when it
    stops."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=sorted(torch.profiler.supported_activities(),
                          key=lambda a: a.name),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    return prof


@contextlib.contextmanager
def capture(logdir: str):
    """Capture a profiler trace for the enclosed region into ``logdir``
    (``{host}_{pid}.{time}.pt.trace.json``); the device is synchronized
    before the trace stops, so the region's kernels land inside it."""
    prof = _start(logdir)
    try:
        yield prof
    finally:
        _sync()
        prof.stop()


class Profiler(Callback):
    """Capture a ``torch.profiler`` trace for selected steps of an epoch.

    Skips the first ``start_step`` steps of epoch ``epoch`` (warm-up:
    kernel builds, the allocator, cuDNN's autotuning) and records the next
    ``num_steps`` — the standard "profile a steady-state window" recipe;
    a window that outlasts the epoch stops at its end, after the
    validation pass. Coordinator-only, like all reference logging. The
    device is synchronized before the trace stops.
    """

    def __init__(self, logdir: str, epoch: int = 0, start_step: int = 2,
                 num_steps: int = 5):
        self.logdir = logdir
        self.epoch = epoch
        self.start_step = start_step
        self.num_steps = num_steps
        self._prof: Optional[torch.profiler.profile] = None
        self._epoch_step = 0
        self._in_epoch = False

    def _begin(self) -> None:
        if dist.is_coordinator():
            self._prof = _start(self.logdir)

    def on_epoch_begin(self, epoch):
        self._in_epoch = epoch == self.epoch
        self._epoch_step = 0
        if self._in_epoch and self.start_step == 0:
            self._begin()

    def on_train_batch_end(self, step, logs):
        if not self._in_epoch:
            return
        self._epoch_step += 1  # steps run in this epoch
        if self._prof is not None:
            if self._epoch_step >= self.start_step + self.num_steps:
                self._stop()
        elif self._epoch_step == self.start_step:
            self._begin()

    def _stop(self) -> None:
        _sync(self.trainer.device if self.trainer is not None else None)
        self._prof.stop()
        self._prof = None

    def on_epoch_end(self, epoch, logs):
        if self._prof is not None:
            self._stop()

    def on_train_end(self, logs):
        if self._prof is not None:
            self._stop()


class StepTimer(Callback):
    """Per-step wall-time stats (mean/p50/p90/p99, the first
    ``skip_steps`` excluded: they hold the kernel builds and the
    allocator's warm-up) and steady-state images/sec per device — the
    per-device number the strategies multiply out.

    Each step is timed on the device: the timer synchronizes the
    trainer's device at every step boundary before it reads the host
    clock, so a step's time is its work, not its launch.

    :meth:`snapshot` emits the stats in the same flat-dict shape as
    ``ServeMetrics.snapshot()`` (stable keys, ``None`` before data), so
    the training step loop and the serving engine share one Prometheus
    export path (``pddl_tpu_torch/obs/export.py``)."""

    def __init__(self, global_batch_size: Optional[int] = None,
                 skip_steps: int = 1, verbose: int = 1):
        self.global_batch_size = global_batch_size
        self.skip_steps = skip_steps
        self.verbose = verbose
        self.step_times: List[float] = []
        self._last: Optional[float] = None
        self._step_in_run = 0

    def _now(self) -> float:
        _sync(self.trainer.device if self.trainer is not None else None)
        return time.perf_counter()

    def on_train_begin(self):
        self._last = self._now()

    def on_train_batch_end(self, step, logs):
        now = self._now()
        if self._step_in_run >= self.skip_steps:
            self.step_times.append(now - self._last)
        self._last = now
        self._step_in_run += 1

    @property
    def stats(self) -> Dict[str, float]:
        if not self.step_times:
            return {}
        ts = sorted(self.step_times)
        n = len(ts)
        out = {
            "step_time_mean_s": statistics.fmean(ts),
            "step_time_p50_s": ts[n // 2],
            "step_time_p90_s": ts[min(n - 1, int(0.9 * n))],
            "step_time_p99_s": ts[min(n - 1, int(0.99 * n))],
            "steps_timed": float(n),
        }
        if self.global_batch_size:
            per_sec = self.global_batch_size / out["step_time_mean_s"]
            out["images_per_sec"] = per_sec
            out["images_per_sec_per_chip"] = per_sec / global_device_count()
        return out

    def snapshot(self) -> Dict[str, Optional[float]]:
        """The export dict (`ServeMetrics.snapshot()` discipline):
        every key always present, ``None`` where nothing was measured
        yet."""
        stats = self.stats
        return {
            "step_time_mean_s": stats.get("step_time_mean_s"),
            "step_time_p50_s": stats.get("step_time_p50_s"),
            "step_time_p90_s": stats.get("step_time_p90_s"),
            "step_time_p99_s": stats.get("step_time_p99_s"),
            "steps_timed": stats.get("steps_timed", 0.0),
            "images_per_sec": stats.get("images_per_sec"),
            "images_per_sec_per_chip": stats.get("images_per_sec_per_chip"),
        }

    def on_train_end(self, logs):
        if self.verbose and dist.is_coordinator() and self.step_times:
            parts = [f"{k}: {v:.4g}" for k, v in self.stats.items()]
            print("StepTimer: " + " - ".join(parts), file=sys.stderr)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Device memory stats (bytes) of this process's device — the port
    runs one process per device: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the caching allocator
    (``torch.cuda.memory_stats``), ``bytes_limit`` the card's total memory
    (``torch.cuda.mem_get_info``). On a host without a card the CPU
    reports ``-1`` for each, as the JAX function does where the backend
    exposes no stats."""
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                        "bytes_limit": -1}}
    index = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index)
    _, total = torch.cuda.mem_get_info(index)
    return {f"cuda:{index}": {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }}
