"""Sequence parallelism of the port (`mesh` with a `seq` axis in Llama,
GPT and ViT over a mirrored strategy, `parallel/base.py`) against the
JAX package on the CPU.

One 2-process and one 4-process gloo cluster (`tests/_torch_sp_child.py
sp`, one deadline each that kills the survivors) train each leg from the
JAX initial weights, while the JAX single-device `Trainer` runs the same
steps in this process (attention `"reference"`, the global sequence):

- 2 processes (data 1 x seq 2): a ring GPT (learned positions sliced), a
  ring-flash GQA Llama with `remat="dots"` (the ring runs again in the
  recompute) under clipped Adam for 2 steps (then saved: the save
  restores into one process bitwise);
  A routed (MoE) ring Llama trains under seq 2 too: its routing runs
  over the whole row, so its capacity drops are the JAX module's.
- 4 processes: `dryrun_multichip` shape 2 (data 2 x seq 2 ring-flash
  ViT: the head's token mean a sum over `seq`) and shape 9 (a ring-flash
  GQA sliding-window Llama at seq 4, S 64: the band skips a rotation);
  then a seq axis of 2 beside another of 2 (`MESH_LEGS`): SP x TP (ring
  attention with the heads over `model`), SP x EP (routed experts over
  `expert`) and SP x PP (a ring `GPipeLlama`, its stages over `stage`),
  each against the JAX single-device `Trainer` (the sequential GPipe for
  the pipeline); and meshes of chosen ranks and of each host's processes
  with a seq axis, whose lines are the JAX meshes' over the same devices.

Each leg: the loss within 1e-5 relative, the gradient norm within 1e-4
relative, every parameter within 2e-5 (2·lr·steps for Adam). The same
2-process cluster decodes the seq-2-built Llama and GPT through
`generate()` and a paged `ServeEngine` (greedy tokens equal to the JAX
`generate` exactly, f32), and runs `SwitchFFN` over the two sequence
shards: the kept set and queue positions equal the JAX module's dense
dispatch exactly, the outputs, the aux loss, the drop rate and the
gradients within 1e-5. The mesh's coordinates equal JAX's. (A
one-process mesh's ring models against the JAX models:
tests/test_torch_gpt.py, test_torch_vit.py and test_torch_repairs.py.)
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cluster import REPO, Cluster
from _torch_sp_child import (
    BN_SEED,
    CLIP,
    DECODE_LEGS,
    LR,
    MESH_LEGS,
    MOE_CASES,
    MOE_H,
    SP_LEGS,
    bn_inputs,
    decode_prompts,
    leg_params,
    lm_keys,
    mesh_batch,
    moe_inputs,
    sp_batch,
)
from test_torch_moe import _jax_run, _port_dense
from test_torch_pipeline import _Sequential
from jax.sharding import PartitionSpec as P
from pddl_tpu.core.mesh import shard_map as jax_shard_map
from pddl_tpu.models import resnet as jres
from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.ops import moe as jax_moe
from pddl_tpu.core.mesh import MeshConfig as JaxMeshConfig
from pddl_tpu.core.mesh import build_mesh as jax_build_mesh
from pddl_tpu.models.gpt import GPT as JaxGPT
from pddl_tpu.models.llama import GPipeLlama as JaxGPipeLlama
from pddl_tpu.models.llama import Llama as JaxLlama
from pddl_tpu.models.vit import ViT as JaxViT
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
from pddl_tpu_torch import bridge
from pddl_tpu_torch.ckpt import Checkpointer
from pddl_tpu_torch.ckpt.checkpoint import local_state
from pddl_tpu_torch.core import mesh as tmesh
from pddl_tpu_torch.models.gpt import GPT, generate
from pddl_tpu_torch.models.llama import GPipeLlama, Llama
from pddl_tpu_torch.models.resnet import tiny_resnet
from pddl_tpu_torch.models.vit import ViT
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import make_optimizer

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

JAX_FAMILY = {"llama": JaxLlama, "gpt": JaxGPT, "vit": JaxViT}
PORT = {"llama": (Llama, bridge.llama_params_from_jax,
                  bridge.llama_params_to_jax),
        "gpt": (GPT, bridge.gpt_params_from_jax, bridge.gpt_params_to_jax),
        "vit": (ViT, bridge.vit_params_from_jax, bridge.vit_params_to_jax)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _jax_kw(family, kw):
    kw = dict(kw, attention="reference")
    kw.pop("image_size", None)
    return kw


def _jax_trainer(leg):
    _, family, kw, _, _, opt, _, _, _ = SP_LEGS[leg]
    optimizer = opt
    if opt == "adam":
        optimizer = jax_make_optimizer("adam", LR["adam"],
                                       grad_clip_norm=CLIP)
    jtr = JaxTrainer(JAX_FAMILY[family](**_jax_kw(family, kw)),
                     optimizer=optimizer, learning_rate=LR[opt], seed=0,
                     log_grad_norm=True, **lm_keys(family))
    jtr.init_state(sp_batch(leg, 0))
    return jtr


def _jax_mesh_trainer(leg):
    kind, kw = MESH_LEGS[leg]
    kw = dict(kw, attention="reference")
    if kind == "pp":
        mesh = jax_build_mesh(JaxMeshConfig(data=1, stage=2),
                              devices=jax.devices()[:2])
        model = _Sequential(JaxGPipeLlama(mesh=mesh, **kw))
    else:
        model = JaxLlama(**kw)
    jtr = JaxTrainer(model, optimizer="sgd", learning_rate=LR["sgd"],
                     seed=0, log_grad_norm=True, **lm_keys("llama"))
    jtr.init_state(mesh_batch(leg))
    return jtr


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The children's outputs (both clusters at once), and each leg's JAX
    run from the same weights (computed here while they run)."""
    work = tmp_path_factory.mktemp("sp")
    trainers = {leg: _jax_trainer(leg) for leg in SP_LEGS}
    trainers.update({leg: _jax_mesh_trainer(leg) for leg in MESH_LEGS})
    init = {}
    for leg, jtr in trainers.items():
        params = jax.tree.map(np.asarray, jtr.state.params)
        init.update({f"{leg}:{k}": v for k, v in _flat(params).items()})
    np.savez(work / "init.npz", **init)
    script = os.path.join(REPO, "tests", "_torch_sp_child.py")
    clusters = []
    try:
        for world in (2, 4):
            clusters.append(Cluster(script, world, "sp", str(work)))
        runs = {}
        for leg, jtr in trainers.items():
            steps = SP_LEGS[leg][6] if leg in SP_LEGS else 1
            data = ([sp_batch(leg, s) for s in range(steps)]
                    if leg in SP_LEGS else [mesh_batch(leg)])
            hist = jtr.fit(iter(data), epochs=steps, steps_per_epoch=1,
                           verbose=0)
            runs[leg] = (hist.history,
                         jax.tree.map(np.asarray, jtr.state.params))
        outs = [o for c in clusters for o in c.wait(timeout=240)]
    finally:
        for c in clusters:
            c.kill()
    assert all("OK" in o for o in outs)
    return work, runs


def _port_meta(family, kw):
    cls = PORT[family][0]
    return cls(device="meta", **{k: v for k, v in kw.items()
                                 if k != "attention"})


@pytest.mark.parametrize("leg", sorted(SP_LEGS))
def test_sequence_parallel_step_matches_jax_single_device(legs, leg):
    work, runs = legs
    _, family, kw, data, seq, opt, steps, _, _ = SP_LEGS[leg]
    got = np.load(work / f"{leg}.npz")
    hist, want = runs[leg]
    np.testing.assert_allclose(got["log/loss"], hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["log/grad_norm"], hist["grad_norm"],
                               rtol=1e-4)
    sd = {k[len("param/"):]: torch.from_numpy(got[k]) for k in got.files
          if k.startswith("param/")}
    to_jax = PORT[family][2](_port_meta(family, kw), sd)
    bound = 2 * LR[opt] * steps if opt == "adam" else 2e-5
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=bound), to_jax, want)
    calls = dict(zip(got["count_names"], got["counts"][:, 0]))
    depth = kw.get("depth", 1)
    # One K/V hop a rotation beyond the diagonal, every layer, every step
    # (again in a remat recompute); shape 9's window skips the last of
    # its 4 rotations.
    rotations = 3 if leg == "shape9_llama" else seq
    recompute = 2 if kw.get("remat", "none") != "none" else 1
    assert calls["ring_kv_fwd"] == (rotations - 1) * depth * steps * recompute
    assert calls["ring_dkv_bwd"] == (rotations - 1) * depth * steps
    if family == "vit":
        assert calls["seq_sum_fwd"] == calls["seq_sum_bwd"] == steps


@pytest.mark.parametrize("leg", sorted(MESH_LEGS))
def test_seq_beside_another_axis_matches_jax_single_device(legs, leg):
    """A seq axis of 2 beside model, expert or stage: one SGD step
    against the JAX single-device step (loss 1e-5 relative, gradient norm
    1e-4, every parameter 2e-5), each rank at JAX's coordinates."""
    work, runs = legs
    kind, kw = MESH_LEGS[leg]
    got = np.load(work / f"{leg}.npz")
    hist, want = runs[leg]
    np.testing.assert_allclose(got["log/loss"], hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["log/grad_norm"], hist["grad_norm"],
                               rtol=1e-4)
    sd = {k[len("param/"):]: torch.from_numpy(got[k]) for k in got.files
          if k.startswith("param/")}
    if kind == "pp":
        meta = GPipeLlama(mesh=_fake_seq_mesh(1, stage=2), device="meta",
                          **dict(kw, attention="reference"))
        to_jax = bridge.gpipe_params_to_jax(meta, sd)
    else:
        to_jax = bridge.llama_params_to_jax(
            Llama(device="meta", **dict(kw, attention="reference")), sd)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=2e-5), to_jax, want)
    other = {"tp": "model", "ep": "expert", "pp": "stage"}[kind]
    sizes = JaxMeshConfig(data=1, seq=2, **{other: 2}).axis_sizes(4)
    for rank, coords in enumerate(got["every_coords"]):
        want_c = tmesh.axis_coords(sizes, rank)
        assert coords.tolist() == [want_c[a] for a in tmesh.CANONICAL_AXES]
    calls = dict(zip(got["count_names"], got["counts"][:, 0]))
    # One K/V hop a layer beyond the diagonal: 2 layers, or the stage's
    # one block for each of 2 microbatches.
    assert calls["ring_kv_fwd"] == calls["ring_dkv_bwd"] == 2
    if kind == "pp":
        assert calls["pp_hop_fwd"] == calls["pp_hop_bwd"] == 2
    if kind == "tp":
        assert calls["reduce_from_fwd"] >= 2 * 2


def test_meshes_of_chosen_ranks_and_of_each_host(legs):
    """``build_mesh(ranks=...)`` with a seq axis, built by its members,
    and ``local_only`` over 2 hosts of 2: each rank's seq position, its
    line, and an all-gather over the line equal the JAX mesh's order over
    the same devices."""
    work, _ = legs
    rows = np.load(work / "chosen_meshes.npz")["rows"]
    devices = np.asarray(jax.devices()[:4])
    for rank in range(4):
        pair = (0, 1) if rank < 2 else (2, 3)
        jm = jax_build_mesh(JaxMeshConfig(data=1, seq=2),
                            devices=devices[list(pair)])
        line = [d.id for d in jm.devices.reshape(-1)]
        want = [line.index(rank), *line, *line]
        assert rows[rank].tolist() == [want, want]


def test_sequence_parallel_save_restores_into_one_process(legs):
    work, _ = legs
    _, family, kw, _, _, opt, steps, _, _ = SP_LEGS["sp_llama_adam"]
    got = np.load(work / "sp_llama_adam.npz")
    ckpt = Checkpointer(str(work / "ckpt_sp_llama_adam"), read_only=True)
    assert ckpt.all_steps() == [steps]
    one = Trainer(Llama(device="cpu", **dict(kw, attention="flash",
                                             remat="none")),
                  optimizer=lambda ps: make_optimizer(
                      ps, "adam", LR["adam"], grad_clip_norm=CLIP),
                  device="cpu", **lm_keys(family))
    state, meta = ckpt.restore()
    one.load_state_dict(local_state(one, state, meta))
    for name, t in one.model.state_dict().items():
        assert torch.equal(t, torch.from_numpy(got[f"param/{name}"])), name


def test_mesh_coordinates_equal_jax_and_what_stays_refused():
    devices = np.asarray(jax.devices()[:8])
    for cfg in (dict(data=2, seq=4), dict(data=-1, model=2, stage=2),
                dict(data=2, stage=4)):
        jm = jax_build_mesh(JaxMeshConfig(**cfg), devices=devices)
        sizes = JaxMeshConfig(**cfg).axis_sizes(8)
        for rank in range(8):
            coords = tmesh.axis_coords(sizes, rank)
            idx = tuple(coords[a] for a in tmesh.CANONICAL_AXES)
            assert jm.devices[idx].id == devices[rank].id
    sizes = JaxMeshConfig(data=2, seq=2).axis_sizes(4)
    assert tmesh.axis_lines(sizes, "data+seq", range(4)) == [(0, 1, 2, 3)]
    assert tmesh.axis_lines(sizes, "seq", range(4)) == [(0, 1), (2, 3)]
    # A seq axis beside model, expert or stage: every axis's lines are the
    # JAX mesh's.
    for beside in ("model", "expert", "stage"):
        cfg = JaxMeshConfig(data=-1, seq=2, **{beside: 2})
        jm = jax_build_mesh(cfg, devices=devices)
        sizes = cfg.axis_sizes(8)
        for axis in tmesh.CANONICAL_AXES:
            want = np.moveaxis(np.vectorize(lambda d: d.id)(jm.devices),
                               tmesh.CANONICAL_AXES.index(axis), -1)
            assert sorted(tmesh.axis_lines(sizes, axis, range(8))) == sorted(
                tuple(int(i) for i in line)
                for line in want.reshape(-1, sizes[axis]))
    mesh = _fake_seq_mesh(2)
    # A routed block under a seq axis builds (it routes over the row).
    Llama(vocab_size=16, device="meta", attention="ring", mesh=mesh,
          moe_experts=2)
    with pytest.raises(ValueError, match="use 'ring' or 'ring_flash'"):
        GPT(vocab_size=16, device="meta", attention="flash", mesh=mesh)
    with pytest.raises(ValueError, match="needs the mesh"):
        ViT(device="meta", attention="ring_flash")
    # A ring model built on a mesh decodes as the JAX one does: the cached
    # forward runs before any mesh attention.
    kw = dict(vocab_size=16, max_len=32, embed_dim=32, depth=1, num_heads=4)
    one = Llama(attention="ring", device="cpu",
                mesh=tmesh.build_mesh(device="cpu"), **kw)
    jm = JaxLlama(attention="reference", **kw)
    prompt = np.random.default_rng(3).integers(0, 16, (1, 4)).astype(
        np.int32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(prompt))["params"])
    one.load_state_dict(bridge.llama_params_from_jax(params))
    want = np.asarray(jax_generate(jm, {"params": params},
                                   jnp.asarray(prompt), 6))
    with torch.no_grad():
        np.testing.assert_array_equal(generate(one, prompt, 6).numpy(), want)


@pytest.mark.parametrize("leg", sorted(DECODE_LEGS))
def test_seq_mesh_built_model_decodes_like_jax(legs, leg):
    """A model built on the seq-2 mesh decodes the whole sequence in each
    process: ``generate()`` and the paged engine give the JAX
    ``generate``'s greedy tokens exactly (f32)."""
    work, _ = legs
    got = np.load(work / "sp_decode.npz")
    assert bool(got["same_on_every_process"])
    _, family, kw, *_ = SP_LEGS[leg]
    plen, new = DECODE_LEGS[leg]
    jm = JAX_FAMILY[family](**dict(_jax_kw(family, kw), remat="none")
                            if family == "llama" else _jax_kw(family, kw))
    prompts = decode_prompts(leg)
    want = np.asarray(jax_generate(jm, {"params": leg_params(work, leg)},
                                   jnp.asarray(prompts), new))
    np.testing.assert_array_equal(got[f"{leg}/generate"], want)
    np.testing.assert_array_equal(got[f"{leg}/engine"], want[:, plen:])


class _Routing:
    def __init__(self, got, case, top_k):
        self.expert, self.kept, self.position, self.gates = (
            [torch.from_numpy(got[f"{case}/{key}{j}"]) for j in range(top_k)]
            for key in ("expert", "kept", "position", "gate"))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_over_seq_shards_routes_like_jax(legs, monkeypatch, case):
    """``SwitchFFN`` over two sequence shards against the JAX module over
    the whole rows: the kept set and the queue positions exactly (the
    dense dispatch), the gates, outputs, aux loss, drop rate and the
    gradients of ``(y·g).sum() + aux`` within 1e-5."""
    work, _ = legs
    got = np.load(work / "sp_moe.npz")
    top_k, act, cf, train, bias = MOE_CASES[case]
    x, sd = moe_inputs(case)
    jm = jax_moe.SwitchFFN(num_experts=4, top_k=top_k, capacity_factor=cf,
                           expert_act=act,
                           **(dict(hidden_dim=MOE_H) if act == "swiglu"
                              else {}))
    params = bridge._moe_to_jax(sd, "")
    out, dispatch, combine, aux, drop = _jax_run(monkeypatch, jm, params, x,
                                                 train)
    capacity = dispatch.shape[-1]
    assert int(got[f"{case}/capacity"]) == capacity
    pd, pc = _port_dense(_Routing(got, case, top_k), 4, capacity)
    np.testing.assert_array_equal(pd, dispatch)
    np.testing.assert_allclose(pc, combine, rtol=0, atol=1e-6)
    assert (drop > 0) == (bias is not None and train)
    np.testing.assert_allclose(got[f"{case}/out"], out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got[f"{case}/aux"]), aux, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(got[f"{case}/drop"]), drop, rtol=0,
                               atol=1e-6)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        y, sown_ = jm.apply({"params": p}, xx, train,
                            mutable=["losses", "metrics"])
        return (y * g).sum() + jax.tree.leaves(sown_["losses"])[0]

    dp, dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(got[f"{case}/dx"], np.asarray(dx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[f"{case}/drouter"],
                               np.asarray(dp["router"]["kernel"]).T, rtol=0,
                               atol=1e-5)


def test_batchnorm_over_the_seq_axis_matches_jax_shard_map(legs):
    """``ResNet(axis_name="seq")`` over two processes, each holding half
    the rows: the outputs, the BatchNorm buffers and the summed gradients
    of ``(y·g).sum()`` against the JAX model under ``shard_map`` over the
    ``seq`` axis of two devices (``psum`` of the loss), within 1e-5."""
    work, _ = legs
    got = np.load(work / "sp_bn_axis.npz")
    assert got["bound"].size and got["bound"].all()
    x, g = bn_inputs()
    port = tiny_resnet(device="cpu", axis_name="seq", seed=BN_SEED)
    params, stats = bridge.resnet_params_to_jax(port.state_dict())
    jm = jres.tiny_resnet(axis_name="seq")
    mesh = jax_build_mesh(JaxMeshConfig(data=1, seq=2),
                          devices=jax.devices()[:2])

    def shard(params, x, g):
        y, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"], jax.lax.psum((y * g).sum(), "seq")

    run = jax_shard_map(shard, mesh=mesh, in_specs=(P(), P("seq"), P("seq")),
                        out_specs=(P("seq"), P(), P()))

    def loss(p):
        y, new_stats, total = run(p, jnp.asarray(x), jnp.asarray(g))
        return total, (y, new_stats)

    grads, (y, new_stats) = jax.jit(jax.grad(loss, has_aux=True))(params)
    np.testing.assert_allclose(got["out"], np.asarray(y), rtol=0, atol=1e-5)
    port.load_state_dict({k: torch.from_numpy(got[f"buffer/{k}"])
                          for k in port.state_dict() if f"buffer/{k}" in got},
                         strict=False)
    _, port_stats = bridge.resnet_params_to_jax(port.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-6), port_stats,
        jax.tree.map(np.asarray, new_stats))
    sd = {k: torch.from_numpy(got[f"grad/{k}"]) for k, _ in
          port.named_parameters()}
    sd.update({k: v for k, v in port.state_dict().items() if k not in sd})
    port_grads, _ = bridge.resnet_params_to_jax(sd)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max())), port_grads,
        jax.tree.map(np.asarray, grads))


def _fake_seq_mesh(seq, stage=1):
    sizes = {"data": 1, "model": 1, "seq": seq, "expert": 1, "stage": stage}
    return tmesh.Mesh(sizes, (0,), None, torch.device("cpu"))
