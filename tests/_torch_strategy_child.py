"""One process of a gloo cluster for tests/test_torch_strategies.py (not a
test file). Imports only the port, never jax.

Run as ``python _torch_strategy_child.py WORKDIR`` with the ``PDDL_*``
bootstrap set. Reads ``WORKDIR/init.npz`` (a bridged ``tiny_resnet``'s
state_dict) and ``WORKDIR/bn.npz`` (a BatchNorm case), trains on the
CPU under each strategy and writes what it saw to ``WORKDIR/out_{rank}.npz``
for the test to hold against the JAX package.
"""

import os
import sys

import numpy as np
import torch

from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.models.resnet import BatchNorm, ResNet, bind_data_group, tiny_resnet
from pddl_tpu_torch.ops.augment import standard_augment
from pddl_tpu_torch.parallel import (
    MirroredStrategy,
    MultiWorkerMirroredStrategy,
    ParameterServerStrategy,
)
from pddl_tpu_torch.parallel.ps import optimizer_state_bytes
from pddl_tpu_torch.train.loop import Trainer

CPU = "cpu"
RUNS = (("adam", 1e-3, 1), ("sgd", 1e-2, 3))


def strategy(name, **kw):
    if name == "mirrored":
        return MirroredStrategy(device=CPU)
    if name == "multiworker":
        return MultiWorkerMirroredStrategy(device=CPU)
    return ParameterServerStrategy(device=CPU, **kw)


def images(name, n, rank, **kw):
    """The global batch for one feeder (mirrored), else this process's
    part of it."""
    cfg = dict(dict(batch_size=8, image_size=32, num_classes=10, seed=0),
               **kw)
    if name != "mirrored":
        cfg.update(process_index=rank, process_count=n)
    return SyntheticImageClassification(**cfg)


def state(out, tag, model):
    for k, v in model.state_dict().items():
        out[f"{tag}/sd/{k}"] = v.numpy()


def train(out, tag, model, strat, data, opt, lr, steps, **kw):
    tr = Trainer(model, optimizer=opt, learning_rate=lr, device=CPU,
                 strategy=strat, seed=11, **kw)
    hist = tr.fit(data, epochs=steps, steps_per_epoch=1, verbose=0)
    for key in ("loss", "grad_norm"):
        if key in hist.history:
            out[f"{tag}/{key}"] = np.asarray(hist.history[key])
    state(out, tag, model)
    return tr


def main() -> None:
    torch.set_num_threads(1)
    workdir = sys.argv[1]
    dist.initialize(device=CPU)
    n, rank = dist.process_count(), dist.process_index()
    init = {k: torch.from_numpy(v)
            for k, v in np.load(os.path.join(workdir, "init.npz")).items()}
    out = {}

    # Each strategy against the JAX one (adam 1 step, sgd 3 steps).
    for name in ("mirrored", "multiworker", "ps"):
        for opt, lr, steps in RUNS:
            model = tiny_resnet(device=CPU)
            model.load_state_dict(init)
            tr = train(out, f"{name}/{opt}", model,
                       strategy(name, min_shard_bytes=1 << 10),
                       images(name, n, rank), opt, lr, steps)
            out[f"{name}/{opt}/state_bytes"] = optimizer_state_bytes(
                tr.optimizer)

    # lamb's trust ratio over sharded state equals the replicated one.
    for name in ("mirrored", "ps"):
        model = tiny_resnet(device=CPU)
        model.load_state_dict(init)
        train(out, f"{name}/lamb", model, strategy(name, min_shard_bytes=1),
              images(name, n, rank), "lamb", 1e-3, 1)

    # The capped leaf: a 5-wide head bias splits under TF's partitioner
    # but no divisor of the axis divides 5.
    model = tiny_resnet(num_classes=5, device=CPU)
    strat = strategy("ps", min_shard_bytes=1)
    train(out, "capped", model, strat,
          images("ps", n, rank, num_classes=5), "adam", 1e-3, 1)
    out["capped/count"] = np.asarray(strat.capped_leaves)

    if n == 4:  # num_ps=2: every sharded leaf splits exactly 2 ways.
        model = tiny_resnet(device=CPU)
        model.load_state_dict(init)
        strat = strategy("ps", min_shard_bytes=1, num_ps=2)
        tr = train(out, "ps2/adam", model, strat, images("ps", n, rank),
                   "adam", 1e-3, 1)
        held = [q for g in tr.optimizer.param_groups for q in g["params"]]
        for (name, p), q in zip(model.named_parameters(), held):
            pl = strat.placements(model)[name]
            out[f"ps2/place/{name}"] = np.asarray(
                [pl.count, -1 if pl.dim is None else p.shape[pl.dim]])
            out[f"ps2/moment/{name}"] = np.asarray(
                tr.optimizer.state[q]["exp_avg"].shape)
        out["ps2/state_bytes"] = optimizer_state_bytes(tr.optimizer)

    # Synchronized BatchNorm alone: this process's rows of a global batch.
    bn = np.load(os.path.join(workdir, "bn.npz"))
    rows = bn["x"].shape[0] // n
    sl = slice(rank * rows, (rank + 1) * rows)
    norm = BatchNorm(bn["x"].shape[1], momentum=0.9, device=CPU)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(bn["scale"]))
        norm.bias.copy_(torch.from_numpy(bn["bias"]))
    bind_data_group(norm, None if n == 1 else torch.distributed.group.WORLD)
    x = torch.from_numpy(bn["x"][sl]).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = norm(x)
    (y * torch.from_numpy(bn["cot"][sl])).sum().backward()
    out["bn/y"] = y.detach().numpy()
    out["bn/dx"] = x.grad.numpy()
    out["bn/dscale"] = norm.weight.grad.numpy()
    out["bn/dbias"] = norm.bias.grad.numpy()
    out["bn/mean"] = norm.running_mean.numpy()
    out["bn/var"] = norm.running_var.numpy()

    # __graft_entry__.dryrun_multichip's DP+ZeRO ResNet shape: one SGD
    # step under ps with the augment, and the one-device run beside it.
    def graft_resnet():
        return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=100,
                      width_multiplier=0.125, small_input_stem=True,
                      device=CPU, seed=5)

    for tag, strat in (("graft/ps", strategy("ps", min_shard_bytes=1 << 10)),
                       ("graft/one", None)):
        data = SyntheticImageClassification(
            batch_size=2 * n, image_size=32, num_classes=100, seed=0,
            **({} if strat is None else dict(process_index=rank,
                                              process_count=n)))
        train(out, tag, graft_resnet(), strat, data, "sgd", 0.005, 1,
              augment=standard_augment(crop=32, flip=True),
              log_grad_norm=True)

    # A data-parallel run with the augment is the single-device run.
    for tag, strat in (("aug/dp", strategy("mirrored")), ("aug/one", None)):
        model = tiny_resnet(device=CPU)
        model.load_state_dict(init)
        train(out, tag, model, strat, images("mirrored", n, rank), "sgd",
              1e-2, 2, augment=standard_augment(crop=28, flip=True),
              log_grad_norm=True)

    # Every process ends with the same state.
    for key in [k for k in out if "/sd/" in k]:
        got = collectives.all_gather(torch.from_numpy(out[key]))
        if not all(torch.equal(got[0], g) for g in got):
            raise AssertionError(f"{key} differs between processes")

    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    print(f"child {rank} OK", flush=True)


if __name__ == "__main__":
    main()
