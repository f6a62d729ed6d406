"""One process of a gloo cluster for tests/test_torch_hvd.py (not a test
file). Imports only the port, never jax.

Run as ``python _torch_hvd_child.py MODE`` with the ``PDDL_*`` bootstrap
set (and ``PDDL_HEARTBEAT_DIR``). ``MODE`` ``hvd`` runs the Horovod
shim's surface and the reference's hvd workflow; ``multiworker`` runs the
checks of ``tests/_multiworker_child.py``: bootstrap from the ``PDDL_*``
environment, coordinator gating, global-batch assembly, one training step,
a phantom worker that never beats and the restart marker. Prints one JSON
line of observables, then ``child {rank} OK``; exits non-zero on any
failed check.
"""

import json
import os
import sys
import time

import numpy as np
import torch

import pddl_tpu_torch.compat.hvd as hvd
from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.models.resnet import tiny_resnet
from pddl_tpu_torch.parallel import MirroredStrategy, MultiWorkerMirroredStrategy
from pddl_tpu_torch.parallel.multiworker import HeartbeatMonitor, WorkerLost
from pddl_tpu_torch.train.callbacks import Callback
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import get_learning_rate

CPU = "cpu"


def hvd_surface(n, rank):
    hvd.init(device=CPU)
    seen = dict(size=hvd.size(), rank=hvd.rank(), local_rank=hvd.local_rank(),
                local_size=hvd.local_size(),
                num_data_shards=hvd.num_data_shards(),
                data_shard_index=hvd.data_shard_index(),
                lr=0.1 * hvd.size(), batch=32 * hvd.size())

    # Explicit regime: each process's gradient is its rank; the step
    # takes their mean (the literal ring-allreduce moment).
    w = torch.nn.Parameter(torch.zeros(8, 4))
    opt = hvd.DistributedOptimizer("sgd", learning_rate=1.0,
                                   axis_name="data")([w])
    w.grad = torch.full_like(w, float(rank))
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), -(n - 1) / 2.0)

    summed = hvd.allreduce(np.float32(rank), average=False)
    np.testing.assert_allclose(summed, n * (n - 1) / 2.0)
    mean = hvd.allreduce({"a": np.arange(3.0) + rank})
    np.testing.assert_allclose(mean["a"], np.arange(3.0) + (n - 1) / 2.0)
    # Ragged gather: process r holds r + 1 rows.
    got = hvd.allgather(np.full((rank + 1, 2), float(rank), np.float32))
    want = np.concatenate([np.full((r + 1, 2), float(r), np.float32)
                           for r in range(n)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hvd.allgather(np.int64(rank)),
                                  np.arange(n))
    root = n - 1
    np.testing.assert_allclose(hvd.broadcast(np.float32(rank),
                                             root_rank=root), float(root))
    try:
        hvd.broadcast(np.float32(0), root_rank=n)
        raise AssertionError("out-of-range root accepted")
    except ValueError as e:
        assert "root_rank" in str(e)

    # The reference's hvd workflow: scaled LR, DistributedOptimizer,
    # warmup + broadcast + metric-average callbacks, rank-0 gating. Rank
    # 1 starts from other weights: the broadcast makes them rank 0's.
    base_lr = 0.01
    scaled = base_lr * hvd.size() / 8
    model = tiny_resnet(num_classes=10, device=CPU, seed=rank)
    trainer = Trainer(model,
                      optimizer=hvd.DistributedOptimizer(
                          "adam", learning_rate=scaled),
                      strategy=MirroredStrategy(device=CPU), seed=11,
                      device=CPU)
    cbs = [hvd.callbacks.BroadcastGlobalVariablesCallback(0),
           hvd.callbacks.MetricAverageCallback(),
           hvd.callbacks.LearningRateWarmupCallback(warmup_epochs=2)]
    ds = SyntheticImageClassification(batch_size=16, image_size=32,
                                      num_classes=10, seed=4)
    lrs = []

    class Record(Callback):
        def on_train_batch_end(self, step, logs):
            lrs.append(get_learning_rate(self.trainer.optimizer))

    hist = trainer.fit(ds, epochs=3, steps_per_epoch=4,
                       callbacks=cbs + [Record()], verbose=0)
    losses = hist.history["loss"]
    assert losses[-1] < losses[0], losses
    assert abs(get_learning_rate(trainer.optimizer) - scaled) <= 1e-12
    for key, t in model.state_dict().items():
        got = collectives.all_gather(t)
        assert all(torch.equal(got[0], g) for g in got), key
    seen.update(losses=losses, lrs=lrs, scaled=scaled)
    return seen


def multiworker(n, rank):
    # Bootstrap purely from PDDL_* env (discovery order step 2).
    spec = dist.initialize(device=CPU)
    assert spec.is_multiprocess and spec.num_processes == n, spec
    assert dist.process_count() == n and dist.process_index() == rank
    assert dist.is_coordinator() == (rank == 0)

    strategy = MultiWorkerMirroredStrategy(device=CPU)
    mesh = strategy.setup()
    assert mesh.size == n and strategy.num_workers == n
    assert strategy.num_replicas_in_sync == n
    # Reference batch arithmetic at multi-host scale: 32 * replicas
    # (imagenet-resnet50-multiworkers.py:70).
    assert strategy.scale_batch_size(32) == 32 * n

    # DATA-sharded feeding: each process contributes its local rows; in
    # rank order they are the global batch.
    local = np.full((2, 3), float(rank), np.float32)
    mine = strategy.distribute_batch({"image": local})["image"]
    batch = collectives.all_gather(torch.from_numpy(mine), mesh.group,
                                   tiled=True)
    assert tuple(batch.shape) == (2 * n, 3)
    np.testing.assert_allclose(float(batch.mean()), (n - 1) / 2.0,
                               atol=1e-6)

    # One real training step (the gradient all-reduce across every
    # process).
    data = SyntheticImageClassification(
        batch_size=strategy.scale_batch_size(2), image_size=16,
        num_classes=4, seed=0, process_index=strategy.process_index,
        process_count=strategy.data_process_count)
    trainer = Trainer(tiny_resnet(num_classes=4, device=CPU),
                      learning_rate=1e-2, strategy=strategy, device=CPU)
    loss = trainer.fit(data, epochs=1, steps_per_epoch=2,
                       verbose=0).history["loss"][-1]
    assert np.isfinite(loss), loss

    # Heartbeats over the real topology (shared-dir beats + restart).
    hb_dir = os.environ["PDDL_HEARTBEAT_DIR"]
    mon = HeartbeatMonitor(hb_dir, timeout_s=30.0)
    mon.start()
    deadline = time.time() + 20.0
    while time.time() < deadline:
        if all(s is not None for s in mon.last_seen().values()):
            break
        mon.beat()
        time.sleep(0.05)
    assert all(s is not None for s in mon.last_seen().values()), \
        mon.last_seen()
    assert mon.failed() == [], mon.failed()
    # A worker that never beat reads as lost once the timeout passes.
    fake_now = [time.time()]
    ghost = HeartbeatMonitor(hb_dir, process_id=mon.process_id,
                             num_processes=n + 1, timeout_s=5.0,
                             clock=lambda: fake_now[0])
    ghost.start()
    fake_now[0] += 6.0
    try:
        ghost.check()
        raise AssertionError("phantom worker not detected")
    except WorkerLost as e:
        assert n in e.lost, e.lost
    # Coordinated restart: the LAST rank requests it; every process
    # observes the shared marker.
    if rank == n - 1:
        mon.request_restart("elastic scale-down drill")
    deadline = time.time() + 20.0
    while time.time() < deadline and not mon.restart_requested():
        time.sleep(0.05)
    assert mon.restart_requested()
    return dict(loss=loss, coordinator=strategy.is_coordinator)


def main() -> None:
    torch.set_num_threads(1)
    n = int(os.environ["PDDL_NUM_PROCESSES"])
    rank = int(os.environ["PDDL_PROCESS_ID"])
    seen = (hvd_surface if sys.argv[1] == "hvd" else multiworker)(n, rank)
    print(json.dumps(seen), flush=True)
    print(f"child {rank} OK", flush=True)


if __name__ == "__main__":
    main()
