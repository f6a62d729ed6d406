"""The port's data-parallel strategies (`pddl_tpu_torch.parallel`,
`core/`, the synchronized BatchNorm of `models/resnet.py`, `Trainer(strategy=)`)
against the JAX package's, on the CPU.

Each gloo cluster (2 and 4 processes, `tests/_torch_strategy_child.py`,
imports only the port) trains a `tiny_resnet` bridged from the JAX model's
init; this process runs the JAX strategies over the same number of fake
devices meanwhile (`tests/conftest.py`'s 8). No process group is opened
here, and each cluster has a deadline that kills its survivors.

Tolerances (f32): Adam is compared after one step and SGD after three
(`tests/test_strategies.py:72-82`: Adam's update approaches sign(grad), so
legal reassociation flips near-zero gradients' signs after a step): losses
within rtol 1e-5 (Adam) and 1e-4 (SGD), parameters within 2·lr (Adam moves
a conv bias before BatchNorm by ±lr whatever its rounding-noise gradient,
`tests/test_torch_resnet.py`) and 1e-4 (SGD), BatchNorm buffers within
1e-5. Every process ends with the same state, bitwise. The ps strategy's
sharded update is elementwise the replicated one, so ps equals mirrored
bitwise for adam and sgd, and within 1e-6 for lamb (its whole-leaf norms
are sums over shards) and for sgd under a global-norm clip and 2-step
accumulation (the clip's norm sums over shards; the accumulator, like the
moments, is this process's slice). Synchronized BatchNorm alone matches flax's
`BatchNorm` over the global batch within 1e-5 (outputs, gradients,
running averages). `__graft_entry__.py:217-235`'s DP+ZeRO ResNet shape
against the port's one-device run: `_assert_matches_oracle`'s tolerances
(loss 5e-4, gradient norm 5e-2 relative, parameters 2e-2). A data-parallel
run with the augment equals the single-device run within 1e-5.
"""

import functools
import logging
import os
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.models.resnet as jres
from _torch_cluster import Cluster
from pddl_tpu.core.mesh import MeshConfig as JaxMeshConfig
from pddl_tpu.core.mesh import build_mesh as jax_build_mesh
from pddl_tpu.data.synthetic import SyntheticImageClassification as JaxImages
from pddl_tpu.parallel import MirroredStrategy as JaxMirrored
from pddl_tpu.parallel import ParameterServerStrategy as JaxPS
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import TrainState as JaxTrainState
from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
from pddl_tpu_torch import bridge
from pddl_tpu_torch.core.sharding import MinSizePartitioner
from pddl_tpu_torch.models.resnet import tiny_resnet

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_strategy_child.py")
SIZES = (2, 4)
RUNS = {"adam": (1e-3, 1), "sgd": (1e-2, 3)}
# The JAX strategy each size's port runs are held against (the JAX
# package's own test equates its ps with its mirrored numerically).
JAX_KIND = {2: "mirrored", 4: "ps"}


def _data(**kw):
    cfg = dict(batch_size=8, image_size=32, num_classes=10, seed=0)
    cfg.update(kw)
    return JaxImages(**cfg)


def _jax_strategy(kind, n, **kw):
    devices = jax.local_devices()[:n]
    if kind == "mirrored":
        return JaxMirrored(devices=devices)
    strat = JaxPS(**kw)
    strat._mesh = jax_build_mesh(JaxMeshConfig(data=n), devices=devices)
    return strat


def _jax_run(kind, n, opt):
    lr, steps = RUNS[opt]
    tr = JaxTrainer(jres.tiny_resnet(num_classes=10), optimizer=opt,
                    learning_rate=lr, seed=11,
                    strategy=_jax_strategy(kind, n, min_shard_bytes=1 << 10))
    hist = tr.fit(_data(), epochs=steps, steps_per_epoch=1, verbose=0)
    sd = bridge.resnet_params_from_jax(
        jax.tree.map(np.asarray, tr.state.params),
        jax.tree.map(np.asarray, tr.state.batch_stats))
    return np.asarray(hist.history["loss"]), {k: v.numpy()
                                              for k, v in sd.items()}


def _flax_batchnorm(bn):
    """flax's BatchNorm over the global batch (NHWC): outputs, the
    gradients of sum(y * cot) and the updated running averages."""
    x = jnp.asarray(bn["x"].transpose(0, 2, 3, 1))
    cot = jnp.asarray(bn["cot"].transpose(0, 2, 3, 1))
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                          epsilon=1.001e-5)
    variables = {"params": {"scale": jnp.asarray(bn["scale"]),
                            "bias": jnp.asarray(bn["bias"])},
                 "batch_stats": {"mean": jnp.zeros(x.shape[-1]),
                                 "var": jnp.ones(x.shape[-1])}}

    def loss(params, x):
        y, upd = layer.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             x, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y, stats)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    t = (0, 3, 1, 2)
    return {"y": np.asarray(y).transpose(t), "dx": np.asarray(dx).transpose(t),
            "dscale": np.asarray(dp["scale"]), "dbias": np.asarray(dp["bias"]),
            "mean": np.asarray(stats["mean"]), "var": np.asarray(stats["var"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both clusters' outputs by size and rank, and the JAX runs."""
    work = tmp_path_factory.mktemp("strategies")
    jtr = JaxTrainer(jres.tiny_resnet(num_classes=10), seed=11)
    jtr.init_state(_data().batch(0))
    init = bridge.resnet_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params),
        jax.tree.map(np.asarray, jtr.state.batch_stats))
    rng = np.random.RandomState(0)
    bn = dict(x=(rng.randn(8, 6, 5, 5) * 2 + 1).astype(np.float32),
              cot=rng.randn(8, 6, 5, 5).astype(np.float32),
              scale=(rng.rand(6) + 0.5).astype(np.float32),
              bias=rng.randn(6).astype(np.float32))
    dirs = {n: work / f"n{n}" for n in SIZES}
    for d in dirs.values():
        d.mkdir()
        np.savez(d / "init.npz", **{k: v.numpy() for k, v in init.items()})
        np.savez(d / "bn.npz", **bn)
    clusters = {n: Cluster(CHILD, n, str(dirs[n])) for n in SIZES}
    try:
        jax_runs = {(n, opt): _jax_run(JAX_KIND[n], n, opt)
                    for n in SIZES for opt in RUNS}
        flax_bn = _flax_batchnorm(bn)
        for cl in clusters.values():
            cl.wait(timeout=240)
    finally:
        for cl in clusters.values():
            cl.kill()
    outs = {n: [dict(np.load(dirs[n] / f"out_{r}.npz")) for r in range(n)]
            for n in SIZES}
    return {"port": outs, "jax": jax_runs, "bn": flax_bn, "bn_in": bn}


def _sd(out, tag):
    pre = f"{tag}/sd/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _max_diff(a, b, keys=None):
    keys = keys if keys is not None else a.keys()
    return max(float(np.abs(a[k] - b[k]).max()) for k in keys)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("opt", sorted(RUNS))
@pytest.mark.parametrize("name", ["mirrored", "multiworker", "ps"])
def test_strategy_matches_jax(runs, name, opt, n):
    out = runs["port"][n][0]
    want_loss, want_sd = runs["jax"][(n, opt)]
    got = _sd(out, f"{name}/{opt}")
    assert got.keys() == want_sd.keys()
    lr, steps = RUNS[opt]
    np.testing.assert_allclose(out[f"{name}/{opt}/loss"], want_loss,
                               rtol=1e-5 if opt == "adam" else 1e-4)
    params = [k for k in got if "running" not in k]
    buffers = [k for k in got if "running" in k]
    assert _max_diff(got, want_sd, params) <= (2 * lr if opt == "adam"
                                               else 1e-4)
    assert _max_diff(got, want_sd, buffers) <= 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_ps_sharded_update_equals_mirrored(runs, n):
    out = runs["port"][n][0]
    for opt in RUNS:
        assert _max_diff(_sd(out, f"ps/{opt}"), _sd(out, f"mirrored/{opt}")) \
            == 0.0, opt
    # Adam's moments of the sharded leaves are this process's slices.
    assert out["ps/adam/state_bytes"] < out["mirrored/adam/state_bytes"]
    assert _max_diff(_sd(out, "ps/lamb"), _sd(out, "mirrored/lamb")) <= 1e-6
    # A clipped, accumulated sgd: the global norm summed over the slices
    # (in another order: to f32 rounding), the accumulator sliced (2
    # updates of 2 micro-steps).
    assert _max_diff(_sd(out, "ps/options"), _sd(out, "mirrored/options")) \
        <= 1e-6
    assert out["ps/options/state_bytes"] < out["mirrored/options/state_bytes"]


@pytest.mark.parametrize("n", SIZES)
def test_sync_batchnorm_matches_flax_over_the_global_batch(runs, n):
    outs, want = runs["port"][n], runs["bn"]
    for key in ("y", "dx"):
        got = np.concatenate([o[f"bn/{key}"] for o in outs])
        np.testing.assert_allclose(got, want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    for key in ("dscale", "dbias"):
        got = sum(o[f"bn/{key}"] for o in outs)  # the gradient average's sum
        np.testing.assert_allclose(got, want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    for key in ("mean", "var"):
        for o in outs:
            np.testing.assert_allclose(o[f"bn/{key}"], want[key], rtol=0,
                                       atol=1e-5, err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_placements(n, min_shard_bytes, num_ps=None, num_classes=10):
    """Per port parameter name, the JAX ps strategy's (count, extent) on
    ``n`` fake devices for an adam TrainState of ``tiny_resnet``, and the
    count of its capped-leaf warning (`state_sharding` over the abstract
    state, as `Trainer.init_state` calls it)."""
    model = jres.tiny_resnet(num_classes=num_classes)
    tx = jax_make_optimizer("adam", 1e-3)

    def init(rng):
        v = model.init(rng, jnp.zeros((1, 32, 32, 3)), train=False)
        return JaxTrainState(step=jnp.zeros((), jnp.int32),
                             params=v["params"], batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]))

    abstract = jax.eval_shape(init, jax.random.key(0))
    strategy = _jax_strategy("ps", n, min_shard_bytes=min_shard_bytes,
                             num_ps=num_ps)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("pddl_tpu.parallel.ps")
    logger.addHandler(handler)
    try:
        shardings = strategy.state_sharding(abstract).params
    finally:
        logger.removeHandler(handler)
    counts = [int(re.match(r"(\d+) variable", r.getMessage()).group(1))
              for r in records]
    out = {}
    for path, leaves in bridge._flat(abstract.params):
        key = bridge._resnet_key(path)
        for leaf_name, leaf in leaves.items():
            sh = _leaf(shardings, path)[leaf_name]
            shape = tuple(leaf.shape)
            piece = sh.shard_shape(shape)
            split = [d for d in range(len(shape)) if piece[d] != shape[d]]
            torch_leaf = {"kernel": "weight", "scale": "weight"}.get(
                leaf_name, leaf_name)
            out[f"{key}.{torch_leaf}"] = (
                int(np.prod(shape) // np.prod(piece)),
                shape[split[0]] if split else -1)
    return out, (counts[0] if counts else 0)


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("n,ps_kw", [
    (4, dict(min_shard_bytes=1 << 10)),
    (4, dict(min_shard_bytes=1, num_ps=2)),
    (2, dict(min_shard_bytes=1, num_classes=5)),
    (4, dict(min_shard_bytes=1, num_classes=5)),
])
def test_ps_placement_per_leaf_matches_jax(n, ps_kw):
    """Shard count and the split dimension's extent per leaf (the port's
    OIHW / [out, in] layouts may split another dim index of the same
    extent), through the bridge's keys."""
    want, _ = _jax_placements(n, **ps_kw)
    model = tiny_resnet(num_classes=ps_kw.get("num_classes", 10),
                        device="cpu")
    part = MinSizePartitioner(min_shard_bytes=ps_kw["min_shard_bytes"],
                              max_shards=ps_kw.get("num_ps"))
    got = {}
    for name, p in model.named_parameters():
        count, dim = part.feasible_shards(tuple(p.shape), p.dtype, n)
        got[name] = (count, -1 if dim is None else p.shape[dim])
    assert got == want
    if "num_ps" in ps_kw:
        assert {c for c, _ in got.values()} == {2}


def test_ps_num_ps_2_splits_two_ways_on_four_processes(runs):
    out = runs["port"][4][0]
    model = tiny_resnet(device="cpu")
    for name, p in model.named_parameters():
        count, extent = out[f"ps2/place/{name}"]
        assert count == 2, name
        moment = tuple(out[f"ps2/moment/{name}"])
        dims = [d for d in range(p.ndim) if moment[d] != p.shape[d]]
        assert len(dims) == 1 and p.shape[dims[0]] == extent, name
        assert moment[dims[0]] * 2 == extent, name
    assert _max_diff(_sd(out, "ps2/adam"), _sd(out, "mirrored/adam")) == 0.0
    assert out["ps2/state_bytes"] < out["mirrored/adam/state_bytes"]


@pytest.mark.parametrize("n", SIZES)
def test_ps_capped_leaf_count_matches_jax(runs, n):
    _, want = _jax_placements(n, min_shard_bytes=1, num_classes=5)
    assert want > 0
    for out in runs["port"][n]:
        assert int(out["capped/count"]) == want


@pytest.mark.parametrize("n", SIZES)
def test_dp_zero_resnet_shape_matches_one_device(runs, n):
    """`dryrun_multichip`'s shape 1: ps with the augment, one SGD step."""
    out = runs["port"][n][0]
    loss_s, loss_o = out["graft/ps/loss"][0], out["graft/one/loss"][0]
    gn_s, gn_o = out["graft/ps/grad_norm"][0], out["graft/one/grad_norm"][0]
    assert abs(loss_s - loss_o) <= 5e-4
    assert abs(gn_s - gn_o) / gn_o <= 5e-2
    assert _max_diff(_sd(out, "graft/ps"), _sd(out, "graft/one")) <= 2e-2


@pytest.mark.parametrize("n", SIZES)
def test_dp_run_with_the_augment_equals_the_single_device_run(runs, n):
    out = runs["port"][n][0]
    np.testing.assert_allclose(out["aug/dp/loss"], out["aug/one/loss"],
                               rtol=1e-5)
    assert _max_diff(_sd(out, "aug/dp"), _sd(out, "aug/one")) <= 1e-5
