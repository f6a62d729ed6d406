"""The port's distribution core without a process group: bootstrap
resolution (`core/dist.py`), meshes (`core/mesh.py`), the collectives of a
world of one (`core/collectives.py`), the parameter-server partitioner
(`core/sharding.py`), the heartbeat monitor and callback
(`parallel/multiworker.py`), `LearningRateWarmup` and the strategies'
arithmetic, each against the JAX package where it has a counterpart.
Pure Python or single-process: no process group is opened here (a
`torch.distributed` call that would open one is replaced by a recorder).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import pddl_tpu.core.dist as jdist
import pddl_tpu.parallel.multiworker as jmw
from pddl_tpu.core.mesh import MeshConfig as JaxMeshConfig
from pddl_tpu.core.sharding import MinSizePartitioner as JaxPartitioner
from pddl_tpu.parallel import MirroredStrategy as JaxMirrored
from pddl_tpu.train.callbacks import LearningRateWarmup as JaxWarmup
from pddl_tpu.train.state import TrainState as JaxTrainState
from pddl_tpu.train.state import get_learning_rate as jax_get_lr
from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
from pddl_tpu_torch.core import collectives, dist
from pddl_tpu_torch.core.mesh import (
    MeshConfig,
    build_hybrid_mesh,
    build_mesh,
    describe,
    slice_groups,
    validate_divisible,
)
from pddl_tpu_torch.core.sharding import MinSizePartitioner
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.models.resnet import tiny_resnet
from pddl_tpu_torch.parallel import (
    MirroredStrategy,
    MultiWorkerMirroredStrategy,
    ParameterServerStrategy,
    SingleDeviceStrategy,
    Strategy,
    get_strategy,
)
import pddl_tpu_torch.parallel.multiworker as mw
from pddl_tpu_torch.parallel.multiworker import HeartbeatMonitor, WorkerLost
from pddl_tpu_torch.train.callbacks import LearningRateWarmup
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import get_learning_rate, make_optimizer

ENV = ("PDDL_COORDINATOR", "PDDL_NUM_PROCESSES", "PDDL_PROCESS_ID",
       "SLURM_NTASKS", "SLURM_PROCID", "SLURM_STEP_NODELIST",
       "SLURM_JOB_NODELIST", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
       "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "SLURM_LOCALID")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert not tdist.is_initialized()


# ------------------------------------------------------------- bootstrap
@pytest.mark.parametrize("args,env", [
    ((), {}),
    (("host0:1234", 4, 2), {}),
    ((), {"PDDL_COORDINATOR": "a:1", "PDDL_NUM_PROCESSES": "3",
          "PDDL_PROCESS_ID": "1"}),
    ((), {"SLURM_NTASKS": "4", "SLURM_PROCID": "2",
          "SLURM_STEP_NODELIST": "nid[001-004]"}),
    ((), {"SLURM_NTASKS": "2", "SLURM_PROCID": "1",
          "SLURM_JOB_NODELIST": "a,b"}),
    ((), {"SLURM_NTASKS": "1", "SLURM_JOB_NODELIST": "node7"}),
    ((), {"SLURM_NTASKS": "8", "SLURM_STEP_NODELIST": "gpu[12,15]"}),
    (("c:9", None, 5), {"PDDL_NUM_PROCESSES": "6", "SLURM_PROCID": "3",
                        "SLURM_NTASKS": "9"}),
])
def test_resolve_cluster_matches_jax(monkeypatch, args, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = dist.resolve_cluster(*args), jdist.resolve_cluster(*args)
    assert (got.coordinator_address, got.num_processes, got.process_id,
            got.is_multiprocess) == (want.coordinator_address,
                                     want.num_processes, want.process_id,
                                     want.is_multiprocess)


@pytest.fixture
def opened(monkeypatch):
    """Record init_process_group calls in place of opening a group."""
    calls = []
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_initialize_skips_a_single_process(opened):
    spec = dist.initialize(device="cpu")
    assert (spec.num_processes, spec.process_id) == (1, 0)
    assert opened == [] and not tdist.is_initialized()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.is_coordinator() and dist.local_rank() == 0


@pytest.mark.parametrize("env,device,want", [
    ({"PDDL_COORDINATOR": "h:7", "PDDL_NUM_PROCESSES": "2",
      "PDDL_PROCESS_ID": "1"}, "cpu", ("gloo", "tcp://h:7", 2, 1)),
    ({"MASTER_ADDR": "m", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
      "RANK": "3"}, None, ("nccl", "tcp://m:29500", 4, 3)),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "0",
      "SLURM_STEP_NODELIST": "nid[007-008]"}, "cuda:1",
     ("nccl", "tcp://nid007:8476", 2, 0)),
])
def test_initialize_opens_the_group_of_the_discovered_job(
        monkeypatch, opened, env, device, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = dist.initialize(device=device)
    assert spec.is_multiprocess
    (args, kw), = opened
    assert (args[0], kw["init_method"], kw["world_size"], kw["rank"]) == want
    assert dist.initialize(device=device, backend="gloo") and len(opened) == 2


def test_initialize_needs_a_coordinator(opened):
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(num_processes=2, process_id=0)


def test_local_rank_and_size(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert (dist.local_size(), dist.local_rank()) == (4, 3)
    assert dist.default_device() == torch.device("cuda", 3)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("SLURM_LOCALID", "2")
    assert dist.local_rank() == 2


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("cfg,n", [
    (dict(), 8), (dict(data=2), 2), (dict(data=-1, model=2), 8),
    (dict(data=2, seq=4), 8), (dict(stage=-1), 6), (dict(data=3), 8),
    (dict(data=0), 4), (dict(data=-2), 4), (dict(data=-1, model=-1), 4),
    (dict(model=3), 8), (dict(data=2, expert=2), 3),
])
def test_mesh_config_axis_sizes_match_jax(cfg, n):
    try:
        want = JaxMeshConfig(**cfg).axis_sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshConfig(**cfg).axis_sizes(n)
        assert str(got.value) == str(e)
        return
    assert MeshConfig(**cfg).axis_sizes(n) == want


def test_build_mesh_of_one_process():
    mesh = build_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1, "expert": 1,
                          "stage": 1}
    assert (mesh.size, mesh.index, mesh.group) == (1, 0, None)
    assert describe(mesh) == "Mesh(1 device) on 1 cpu device(s)"
    validate_divisible(7, mesh)
    assert build_hybrid_mesh(device="cpu").ranks == (0,)
    with pytest.raises(ValueError, match="not both"):
        build_mesh(MeshConfig(), data=1)


def test_build_mesh_refuses_axes_other_than_data():
    for axis in ("model", "seq", "expert", "stage"):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue 1 item 7"):
            build_mesh(MeshConfig(data=1, **{axis: 2}), ranks=(0, 1),
                       device="cpu")
    with pytest.raises(ValueError, match="needs their group"):
        build_mesh(MeshConfig(data=2), ranks=(0, 1), device="cpu")
    mesh = build_mesh(MeshConfig(data=2), ranks=(0, 1), group=object(),
                      device="cpu")
    with pytest.raises(ValueError, match="not divisible by data-axis size 2"):
        validate_divisible(3, mesh)
    assert describe(mesh) == "Mesh(data=2) on 2 cpu device(s)"


def test_slice_groups_are_host_major(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert slice_groups(range(4)) == [[0, 1, 2, 3]]
    assert slice_groups(range(4), 2) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="not divisible into 3 slices"):
        slice_groups(range(4), 3)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert slice_groups([0, 1, 2, 3, 4, 5]) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="detected 3 slices"):
        slice_groups(range(6), 2)
    with pytest.raises(ValueError, match="uneven slices"):
        slice_groups([0, 1, 2])


# ------------------------------------------------------------ collectives
def test_collectives_of_a_world_of_one():
    x = torch.arange(6.0).reshape(2, 3)
    tree = {"a": x, "b": [x + 1, (x * 2,)]}
    for fn in (collectives.psum, collectives.pmean, collectives.pmax,
               collectives.pmin, collectives.broadcast):
        out = fn(tree)
        assert out["a"] is not x
        torch.testing.assert_close(out["b"][1][0], x * 2, rtol=0, atol=0)
    torch.testing.assert_close(collectives.all_gather(x), x[None])
    torch.testing.assert_close(collectives.all_gather(x, axis=1, tiled=True),
                               x)
    torch.testing.assert_close(collectives.reduce_scatter(x), x)
    torch.testing.assert_close(collectives.ppermute_ring(x, shift=3), x)
    assert (collectives.axis_index(), collectives.axis_size()) == (0, 1)
    grads = [x.clone()]
    collectives.flat_all_reduce_(grads, mean=True)
    torch.testing.assert_close(grads[0], x, rtol=0, atol=0)
    with pytest.raises(TypeError, match="tensors"):
        collectives.psum(3.0)


# ------------------------------------------------------------ partitioner
SHAPES = [(), (7,), (64,), (1000,), (3, 3, 3, 64), (3, 3, 64, 64),
          (7, 7, 3, 64), (2048, 1000), (1000, 2048), (5, 7, 11), (6, 10),
          (4096,), (512, 3), (12, 12, 12), (1, 1, 256, 1024)]


@pytest.mark.parametrize("axis", range(1, 9))
def test_partitioner_matches_jax_over_the_grid(axis):
    dtypes = [(torch.float32, np.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.int8, np.int8)]
    for shape, (tdt, jdt), cap, min_bytes in itertools.product(
            SHAPES, dtypes, (None, 1, 2, 3, 8), (1, 100, 1 << 10, 256 << 10)):
        ours = MinSizePartitioner(min_shard_bytes=min_bytes, max_shards=cap)
        theirs = JaxPartitioner(min_shard_bytes=min_bytes, max_shards=cap)
        case = (shape, tdt, cap, min_bytes)
        assert ours.num_shards(shape, tdt, axis) == theirs.num_shards(
            shape, jdt, axis), case
        assert ours.feasible_shards(shape, tdt, axis) == \
            theirs.feasible_shards(shape, jdt, axis), case


def test_placement_is_the_factored_layout():
    mesh = build_mesh(MeshConfig(data=8), ranks=tuple(range(8)),
                      group=object(), device="cpu")
    part = MinSizePartitioner(min_shard_bytes=1, max_shards=2)
    pl = part.sharding(mesh, (6, 10), torch.float32)
    assert (pl.count, pl.dim, pl.replicas) == (2, 1, 4)
    assert [pl.block(10, i) for i in range(8)] == [(0, 5)] * 4 + [(5, 5)] * 4
    full = MinSizePartitioner(min_shard_bytes=1).sharding(
        mesh, (16, 3), torch.float32)
    assert (full.count, full.dim, full.replicas) == (8, 0, 1)
    assert MinSizePartitioner().sharding(mesh, (7,), torch.float32).count == 1


# -------------------------------------------------------------- heartbeats
class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_heartbeat_monitor_matches_jax_on_the_same_beat_files(tmp_path):
    clock = _Clock()
    mine = HeartbeatMonitor(str(tmp_path), process_id=0, num_processes=3,
                            timeout_s=5.0, clock=clock)
    theirs = jmw.HeartbeatMonitor(str(tmp_path), process_id=0,
                                  num_processes=3, timeout_s=5.0, clock=clock)
    peer = HeartbeatMonitor(str(tmp_path), process_id=1, num_processes=3,
                            timeout_s=5.0, clock=clock)
    jpeer = jmw.HeartbeatMonitor(str(tmp_path), process_id=2,
                                 num_processes=3, timeout_s=5.0, clock=clock)
    mine.start()
    theirs.start()
    seq = []
    for dt, beats in ((1, (peer, jpeer)), (3, (peer,)), (2, ()),
                      (1, (jpeer,)), (4, ()), (2, (peer,)), (9, ())):
        clock.t += dt
        for m in beats:
            m.beat()
        assert mine.failed() == theirs.failed()
        assert mine.last_seen() == theirs.last_seen()
        seq.append(mine.failed())
    assert seq[-1] == [1, 2] and [] in seq and [2] in seq
    with pytest.raises(WorkerLost, match=r"\[1, 2\]") as e:
        mine.check()
    assert e.value.lost == [1, 2]
    peer.request_restart("drill")
    assert theirs.restart_requested() and mine.restart_requested()
    theirs.clear_restart()
    assert not mine.restart_requested()


def test_heartbeat_callback_matches_jax(tmp_path):
    """A peer that never beats: both callbacks stop at the same batch,
    drop the marker and raise `WorkerLost` at train end."""

    class FakeTrainer:
        stop_training = False

    def drive(mod, directory, jax_hooks):
        cb_cls, mon_cls = mod.HeartbeatCallback, mod.HeartbeatMonitor
        clock = _Clock()
        mon = mon_cls(str(directory), process_id=0, num_processes=2,
                      timeout_s=3.0, clock=clock)
        cb = cb_cls(mon, check_every_steps=2)
        cb.trainer = FakeTrainer()
        cb.on_train_begin(*(("state",) if jax_hooks else ()))
        stopped = None
        for step in range(8):
            clock.t += 1.0
            cb.on_train_batch_end(step, *(("state",) if jax_hooks else ()),
                                  {})
            if cb.trainer.stop_training:
                stopped = step
                break
        with pytest.raises(mod.WorkerLost) as e:
            cb.on_train_end(*(("state",) if jax_hooks else ()), {})
        return stopped, e.value.lost, mon.restart_requested()

    got = drive(mw, tmp_path / "p", False)
    want = drive(jmw, tmp_path / "j", True)
    assert got == want == (3, [1], True)


# ---------------------------------------------------------- LR warmup
@pytest.mark.parametrize("kw,spe,steps", [
    (dict(warmup_epochs=2), 3, 9),
    (dict(warmup_epochs=1, start_lr=0.01), 4, 6),
    (dict(warmup_epochs=3, steps_per_epoch=2), None, 8),
])
def test_learning_rate_warmup_matches_jax(kw, spe, steps):
    class FakeTrainer:
        steps_per_epoch = spe

    params = {"w": jnp.zeros(3)}
    tx = jax_make_optimizer("sgd", 0.2)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats={}, opt_state=tx.init(params))
    theirs = JaxWarmup(**kw)
    theirs.trainer = FakeTrainer()
    state = theirs.on_train_begin(state)
    want = [jax_get_lr(state)]
    for step in range(steps):
        state = theirs.on_train_batch_end(step, state, {}) or state
        want.append(jax_get_lr(state))

    trainer = FakeTrainer()
    trainer.optimizer = make_optimizer([torch.nn.Parameter(torch.zeros(3))],
                                       "sgd", 0.2)
    mine = LearningRateWarmup(**kw)
    mine.set_trainer(trainer)
    mine.on_train_begin()
    got = [get_learning_rate(trainer.optimizer)]
    for step in range(steps):
        mine.on_train_batch_end(step, {})
        got.append(get_learning_rate(trainer.optimizer))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == pytest.approx(0.2)


# ---------------------------------------------------------- strategies
def test_strategy_registry_and_refusals():
    for name, cls in (("single", SingleDeviceStrategy),
                      ("mirrored", MirroredStrategy),
                      ("multiworker", MultiWorkerMirroredStrategy),
                      ("ps", ParameterServerStrategy)):
        assert type(get_strategy(name)) is cls and cls.name == name
    # Tensor, expert and pipeline parallelism are ported (tests/
    # test_torch_tensor_parallel.py, tests/test_torch_pipeline.py).
    assert type(get_strategy("tensor_parallel", device="cpu")).__name__ == \
        "TensorParallelStrategy"
    assert type(get_strategy("expert_parallel", expert_parallel=1,
                             device="cpu")).__name__ == \
        "ExpertParallelStrategy"
    assert type(get_strategy("pipeline", n_stages=1,
                             device="cpu")).__name__ == "PipelineStrategy"
    with pytest.raises(ValueError, match="unknown strategy 'zero'"):
        get_strategy("zero")


@pytest.mark.parametrize("cls", [SingleDeviceStrategy, MirroredStrategy,
                                 MultiWorkerMirroredStrategy,
                                 ParameterServerStrategy])
def test_strategy_arithmetic_at_one_process(cls):
    s = cls(device="cpu")
    j = JaxMirrored(devices=jax.local_devices()[:1])
    assert s.num_replicas_in_sync == j.num_replicas_in_sync == 1
    assert s.scale_batch_size(32) == j.scale_batch_size(32) == 32
    assert s.scale_learning_rate(0.1) == j.scale_learning_rate(0.1)
    assert repr(s) == f"{cls.__name__}(replicas=1)"
    assert (s.process_index, s.is_coordinator, s.data_process_count) == \
        (0, True, 1)
    assert s.device == torch.device("cpu") and s.group is None
    batch = {"image": np.zeros((4, 2)), "label": np.arange(4)}
    assert s.distribute_batch(batch) is batch


def test_trainer_takes_a_strategy_at_one_process_bitwise():
    """A strategy over one process is `strategy=None`'s step, bitwise;
    only a `Strategy` is accepted, on its own device."""
    data = SyntheticImageClassification(batch_size=4, image_size=16,
                                        num_classes=10, seed=0)

    def run(strategy):
        model = tiny_resnet(device="cpu", seed=2)
        tr = Trainer(model, optimizer="momentum", learning_rate=0.05,
                     device="cpu", strategy=strategy, log_grad_norm=True)
        hist = tr.fit(data, epochs=2, steps_per_epoch=2, verbose=0)
        return ({k: v for k, v in hist.history.items()
                 if k != "images_per_sec"}, model.state_dict(),
                tr.predict(data.batch(9)["image"]))

    want = run(None)
    for strategy in (SingleDeviceStrategy("cpu"), MirroredStrategy("cpu"),
                     ParameterServerStrategy(min_shard_bytes=1,
                                             device="cpu")):
        got = run(strategy)
        assert got[0] == want[0]
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), k
        np.testing.assert_array_equal(got[2], want[2])
    model = tiny_resnet(device="cpu")
    with pytest.raises(TypeError, match="Strategy"):
        Trainer(model, device="cpu", strategy="mirrored")
    with pytest.raises(ValueError, match="trains on cpu"):
        Trainer(model, device="cuda:0", strategy=MirroredStrategy("cpu"))
    assert issubclass(MirroredStrategy, Strategy)
