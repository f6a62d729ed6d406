"""One process of a gloo cluster for tests/test_torch_ckpt_dist.py (not a
test file). Imports only the port, never jax.

Run as ``python _torch_ckpt_child.py WORKDIR`` with the ``PDDL_*``
bootstrap set. For ``ps``, ``mirrored`` and the Horovod workflow
(``hvd``) it trains a ``tiny_resnet`` 4 steps uninterrupted, then 2
steps under ``CheckpointEveryN`` (stopped after the save at step 2),
then resumes a fresh trainer from that save to step 4 with
``fit(resume=)``; it restores the ps save into ``mirrored`` (continuing
to step 4) and into one process (``strategy=None``, the global batch);
under ``multiworker`` a ``BackupAndRestore`` save after epoch 1 restores
into a fresh trainer beside ``ModelCheckpoint``'s epoch saves; last, the
Horovod shim's final save. Writes what it saw to ``WORKDIR/out_{rank}.json`` and prints
``child {rank} OK``.
"""

import json
import os
import sys

import numpy as np
import torch

import pddl_tpu_torch.compat.hvd as hvd
from pddl_tpu_torch.ckpt import (
    BackupAndRestore,
    CheckpointEveryN,
    Checkpointer,
    ModelCheckpoint,
    latest_epoch,
    tree_checksums,
)
from pddl_tpu_torch.ckpt.checkpoint import OWNERS, local_state
from pddl_tpu_torch.core import dist
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.models.resnet import tiny_resnet
from pddl_tpu_torch.parallel import (
    MirroredStrategy,
    MultiWorkerMirroredStrategy,
    ParameterServerStrategy,
)
from pddl_tpu_torch.train.callbacks import Callback
from pddl_tpu_torch.train.loop import Trainer

CPU = "cpu"
STEPS, SAVE_AT, LR = 4, 2, 1e-3


class _Stop(Exception):
    pass


class StopAt(Callback):
    """Ends the run after step ``n`` (the checkpoint callback before it
    has saved)."""

    def __init__(self, n):
        self.n = n

    def on_train_batch_end(self, step, logs):
        if self.trainer.step == self.n:
            raise _Stop


class Losses(Callback):
    """Each step's loss."""

    def __init__(self):
        self.seen = []

    def on_train_batch_end(self, step, logs):
        self.seen.append(float(logs["loss"]))


def strategy(name):
    if name in ("mirrored", "hvd"):
        return MirroredStrategy(device=CPU)
    if name == "multiworker":
        return MultiWorkerMirroredStrategy(device=CPU)
    if name == "ps":  # a small threshold: the tiny model's convs shard
        return ParameterServerStrategy(device=CPU, min_shard_bytes=1024)
    return None


def data(name, n, rank):
    """The global batch for one feeder (mirrored, one process), else this
    process's part of it."""
    kw = dict(batch_size=8, image_size=32, num_classes=10, seed=0)
    if name in ("ps", "multiworker"):
        kw.update(process_index=rank, process_count=n)
    return SyntheticImageClassification(**kw)


def trainer(name):
    """The run's trainer; ``hvd``: the reference's Horovod workflow on
    the shim (``DistributedOptimizer``, the broadcast callback)."""
    opt = hvd.DistributedOptimizer("adam", learning_rate=LR) \
        if name == "hvd" else "adam"
    return Trainer(tiny_resnet(num_classes=10, device=CPU), optimizer=opt,
                   learning_rate=LR, strategy=strategy(name), device=CPU,
                   seed=11)


def hvd_callbacks(name):
    return ([hvd.callbacks.BroadcastGlobalVariablesCallback(0)]
            if name == "hvd" else [])


class StopAtEpochEnd(Callback):
    def on_epoch_end(self, epoch, logs):
        raise _Stop


def fit(tr, ds, **kw):
    return tr.fit(ds, epochs=1, steps_per_epoch=STEPS, verbose=0, **kw)


def model_sums(tr):
    return tree_checksums(tr.model.state_dict())


def main(workdir):
    spec = dist.initialize(device=CPU)
    n, rank = spec.num_processes, dist.process_index()
    hvd.init(device=CPU)
    out = {}
    finals = {}
    for name in ("ps", "mirrored", "hvd"):
        ds = data(name, n, rank)
        clean, clean_losses = trainer(name), Losses()
        fit(clean, ds, callbacks=hvd_callbacks(name) + [clean_losses])
        finals[name] = clean
        directory = os.path.join(workdir, name)
        cut = trainer(name)
        try:
            fit(cut, ds, callbacks=hvd_callbacks(name) + [CheckpointEveryN(
                directory, every_n_steps=SAVE_AT, async_save=False),
                StopAt(SAVE_AT)])
            raise AssertionError("the run was not stopped")
        except _Stop:
            pass
        # A fresh trainer resumes; its own saves go elsewhere, so the
        # step-2 save stays the newest for the restores below.
        resumed, losses = trainer(name), Losses()
        fit(resumed, ds, resume=directory, callbacks=hvd_callbacks(name) + [
            CheckpointEveryN(directory + "_resumed", every_n_steps=SAVE_AT,
                             async_save=False), losses])
        meta = Checkpointer(directory, read_only=True).metadata(SAVE_AT)
        out[name] = {
            "state_equal": tree_checksums(resumed.state_dict())
            == tree_checksums(clean.state_dict()),
            "loss_equal": losses.seen == clean_losses.seen[SAVE_AT:],
            "steps": Checkpointer(directory + "_resumed",
                                  read_only=True).all_steps(),
            "owners": len(meta.get(OWNERS, {})),
            "loader": meta["loader"],
        }

    # The ps save at step 2 into mirrored (every process, the global
    # batch) and on to step 4: mirrored's update equals ps's bitwise.
    ps_dir = os.path.join(workdir, "ps")
    into = trainer("mirrored")
    fit(into, data("mirrored", n, rank), resume=ps_dir)
    out["ps_into_mirrored"] = model_sums(into) == model_sums(finals["ps"])

    # The same save into one process: every optimizer tensor whole, the
    # step and the model as saved; then on to step 4 on the global batch.
    state, meta = Checkpointer(ps_dir, read_only=True).restore(step=SAVE_AT)
    one = trainer(None)
    one.load_state_dict(local_state(one, state, meta))
    params = dict(one.model.named_parameters())
    shapes_whole = all(
        one.optimizer.state[params[nm]]["exp_avg"].shape == params[nm].shape
        for nm in params)
    one_sums = tree_checksums(one.state_dict())
    saved_sums = tree_checksums(state)
    fit(one, data("mirrored", n, rank), resume=ps_dir)
    diff = max(float((a.detach() - b.detach()).abs().max())
               for a, b in zip(one.model.state_dict().values(),
                               finals["ps"].model.state_dict().values())
               if a.is_floating_point())
    out["ps_into_one"] = {"step": one.step, "shapes_whole": shapes_whole,
                          "state_equal": one_sums == saved_sums,
                          "max_diff": diff}

    # multiworker, by epoch: BackupAndRestore's save after epoch 1 of 2,
    # restored by a fresh trainer at train start, bitwise the clean run;
    # ModelCheckpoint's epoch saves beside it.
    ds = data("multiworker", n, rank)
    epochs = dict(epochs=2, steps_per_epoch=SAVE_AT, verbose=0)
    clean = trainer("multiworker")
    clean.fit(ds, **epochs)
    backup = os.path.join(workdir, "backup")
    cut = trainer("multiworker")
    try:
        cut.fit(ds, callbacks=[BackupAndRestore(backup, async_save=False),
                               StopAtEpochEnd()], **epochs)
        raise AssertionError("the run was not stopped")
    except _Stop:
        pass
    # Epoch granularity: the caller repositions the stream itself.
    resumed = trainer("multiworker")
    resumed.fit(ds.with_offset(SAVE_AT),
                initial_epoch=latest_epoch(backup) + 1, callbacks=[
        BackupAndRestore(backup, async_save=False),
        ModelCheckpoint(os.path.join(workdir, "epochs"), async_save=False)],
        **epochs)
    out["multiworker"] = {
        "state_equal": tree_checksums(resumed.state_dict())
        == tree_checksums(clean.state_dict()),
        "backup_steps": Checkpointer(backup, read_only=True).all_steps(),
        "epoch_steps": Checkpointer(os.path.join(workdir, "epochs"),
                                    read_only=True).all_steps()}

    # The Horovod shim's final save: rank 0 alone writes.
    out["hvd_save"] = hvd.save_model(finals["mirrored"].model, "tiny",
                                     directory=workdir)
    with open(os.path.join(workdir, f"out_{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"child {rank} OK")


if __name__ == "__main__":
    torch.set_num_threads(1)
    np.seterr(all="ignore")
    main(sys.argv[1])
