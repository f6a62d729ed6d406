"""The port's Horovod shim (`pddl_tpu_torch/compat/hvd.py`) against
`tests/test_hvd_compat.py`'s observables, in process-per-device terms, and
the multi-worker checks of `tests/_multiworker_child.py` over real gloo
clusters (`tests/_torch_hvd_child.py`, which imports only the port).

One process here (no group is opened) gives the world of one; a cluster
of 2 runs the shim's collectives, the explicit `DistributedOptimizer` and
the reference's hvd workflow; clusters of 2 and 4 run the multi-worker
bootstrap, global-batch assembly, a training step, a phantom worker and
the restart marker. Each cluster has a deadline that kills its survivors.
At the same replica count the arithmetic is the JAX shim's (`0.1 *
size()`, a global batch of `32 * size()`); `local_rank()` and
`num_data_shards()` differ by design (one process per replica here, one
process per host there), as the shim's docstring states.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import pddl_tpu.compat.hvd as jhvd
import pddl_tpu_torch.compat.hvd as hvd
from _torch_cluster import Cluster
from pddl_tpu.core.mesh import MeshConfig as JaxMeshConfig
from pddl_tpu.core.mesh import build_mesh as jax_build_mesh
from pddl_tpu_torch.models.resnet import tiny_resnet
from pddl_tpu_torch.train.state import make_optimizer

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CHILD = os.path.join(os.path.dirname(__file__), "_torch_hvd_child.py")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Observables by (mode, size), one JSON dict per rank."""
    hb = tmp_path_factory.mktemp("hb")
    outs = {}
    # Two waves of at most 4 processes, to keep the suite's load down.
    for wave in ({("hvd", 2): ("hvd",), ("multiworker", 2): ("multiworker",)},
                 {("multiworker", 4): ("multiworker",)}):
        runs = {}
        try:
            for (mode, n), args in wave.items():
                runs[(mode, n)] = Cluster(CHILD, n, *args,
                                          PDDL_HEARTBEAT_DIR=hb / f"{mode}{n}")
            outs.update({key: cl.wait(timeout=240)
                         for key, cl in runs.items()})
        finally:
            for cl in runs.values():
                cl.kill()
    seen = {}
    for key, texts in outs.items():
        for rank, text in enumerate(texts):
            assert f"child {rank} OK" in text, text
        seen[key] = [json.loads([line for line in t.splitlines()
                                 if line.startswith("{")][-1])
                     for t in texts]
    return seen


@pytest.fixture
def one(monkeypatch):
    monkeypatch.setattr(hvd, "_mesh", None)
    hvd.init(device="cpu")


def test_calls_before_init_raise(monkeypatch):
    monkeypatch.setattr(hvd, "_mesh", None)
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match=r"hvd\.init\(\) first"):
        hvd.size()


def test_world_shape_of_one_process(one):
    assert (hvd.size(), hvd.rank(), hvd.local_rank(), hvd.local_size(),
            hvd.num_data_shards(), hvd.data_shard_index()) == (1, 0, 0, 1,
                                                                1, 0)
    assert hvd.is_initialized() and hvd.mesh().device.type == "cpu"


def test_allreduce_and_broadcast_single_process_identity(one):
    x = {"a": np.arange(4.0), "b": 3.0}
    np.testing.assert_array_equal(hvd.allreduce(x)["a"], x["a"])
    np.testing.assert_array_equal(hvd.broadcast(x)["a"], x["a"])
    out = hvd.allgather(x)
    np.testing.assert_array_equal(out["a"], x["a"])
    np.testing.assert_array_equal(out["b"], np.asarray([3.0]))
    with pytest.raises(ValueError, match="root_rank"):
        hvd.broadcast(x, root_rank=1)


def test_distributed_optimizer_default_regime_is_plain_optimizer(one):
    build = hvd.DistributedOptimizer("adam", learning_rate=2e-3)
    w = torch.nn.Parameter(torch.ones(3))
    opt = build([w])
    assert isinstance(opt, torch.optim.Adam)
    assert opt.param_groups[0]["lr"] == 2e-3
    w.grad = torch.ones(3)
    opt.step()
    assert w.shape == (3,)
    # The Trainer's make_optimizer builds it over the model, and refuses
    # the factory-level options a prebuilt optimizer cannot take.
    model = tiny_resnet(device="cpu")
    assert isinstance(make_optimizer(model, build), torch.optim.Adam)
    with pytest.raises(ValueError, match="prebuilt"):
        make_optimizer(model, build, weight_decay=1e-4)
    with pytest.raises(ValueError, match="axis_name"):
        hvd.DistributedOptimizer("sgd", axis_name="model")


def test_world_shape_and_arithmetic_match_jax_at_two_replicas(
        clusters, monkeypatch):
    monkeypatch.setattr(jhvd, "_mesh", jax_build_mesh(
        JaxMeshConfig(data=2), devices=jax.local_devices()[:2]))
    for rank, seen in enumerate(clusters[("hvd", 2)]):
        assert seen["size"] == jhvd.size() == 2
        assert seen["lr"] == pytest.approx(0.1 * jhvd.size())
        assert seen["batch"] == 32 * jhvd.size()
        assert (seen["rank"], seen["data_shard_index"]) == (rank, rank)
        # One process per replica (the JAX shim: one per host).
        assert (seen["local_rank"], seen["local_size"],
                seen["num_data_shards"]) == (rank, 2, 2)


def test_reference_hvd_script_workflow_end_to_end(clusters):
    """Scaled LR, DistributedOptimizer, warmup + broadcast +
    metric-average callbacks: the loss falls, the warmup reaches the
    scaled rate, and both processes log the same global history."""
    a, b = clusters[("hvd", 2)]
    assert a["losses"] == b["losses"] and a["lrs"] == b["lrs"]
    assert a["losses"][-1] < a["losses"][0]
    scaled = a["scaled"]
    assert scaled == pytest.approx(0.01 * 2 / 8)
    warm = 2 * 4  # warmup_epochs x steps_per_epoch
    np.testing.assert_allclose(a["lrs"][:warm],
                               [scaled * (s + 1) / warm for s in range(warm)])
    assert a["lrs"][warm:] == [scaled] * (len(a["lrs"]) - warm)


@pytest.mark.parametrize("n", [2, 4])
def test_multiworker_bootstrap_batch_and_heartbeats(clusters, n):
    seen = clusters[("multiworker", n)]
    assert [s["coordinator"] for s in seen] == [True] + [False] * (n - 1)
    losses = {s["loss"] for s in seen}
    assert len(losses) == 1 and np.isfinite(losses.pop())
