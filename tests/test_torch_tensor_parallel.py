"""Tensor and expert parallelism of the port (`pddl_tpu_torch/parallel/
tensor_parallel.py`, the multi-axis mesh, Megatron's collectives) against
the JAX package on the CPU.

- Placement: for every parameter of full-width Llama-1B (vocabulary
  128,256), GPT-2 small (50,257, which tiles no axis: the head and
  embedding replicate with a warning, as in JAX), ViT-S/16 and a routed
  Llama, the port's spec — judged on the JAX path and shape the bridge
  maps it to — equals the JAX strategy's ``_spec_for``, under TP2 and
  under EP2 (x TP2). The port's models are built on the ``meta`` device
  and the JAX trees come from ``jax.eval_shape``: no memory.
- The mesh: ranks in JAX's row-major order, one line per axis; the
  ``seq`` and ``stage`` axes and ``"pipeline"`` build, and the refusals
  that stay (chosen ranks, ``seq`` beside ``model``) name ROADMAP.md
  queue 1 item 7.
- Two gloo processes (`tests/_torch_tp_child.py`, one deadline) run one
  SGD step each of DP1 x TP2 Llama (GQA), DP1 x TP2 ViT, DP1 x EP2 routed
  Llama (top-2, tokens dropped) and DP1 x EP2 Switch ViT, and two
  clipped-Adam TP2 steps, each held against the JAX ``Trainer`` on one
  device from the same weights (run in this process meanwhile): the loss
  within 1e-5 relative, the gradient norm within 1e-4 relative, every
  gathered parameter within 2e-5 (2·lr·steps for Adam, lr 5e-6).
- In the same processes, TP2 ``generate`` and ``generate_speculative``
  are token-exact with the JAX ``generate`` in f32 (each process's cache
  holds half the K/V heads), with the top-2 logit margin of every
  decoded position reported; the clipped-Adam run's save restores into
  one process bitwise equal to the gathered state.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cluster import REPO, Cluster
from _torch_tp_child import (
    CLIP,
    DRAFT,
    LEGS,
    LR,
    NEW,
    batch,
    keys,
    model_kw,
    prompt,
)
from pddl_tpu.models.gpt import GPT_Small as JaxGPTSmall
from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.models.llama import Llama_1B as JaxLlama1B
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.models.vit import ViT_S16 as JaxViTS16
from pddl_tpu.models.vit import tiny_vit as jax_tiny_vit
from pddl_tpu.parallel import tensor_parallel as jtp
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
from pddl_tpu_torch import bridge
from pddl_tpu_torch.ckpt import Checkpointer
from pddl_tpu_torch.ckpt.checkpoint import local_state
from pddl_tpu_torch.core import mesh as tmesh
from pddl_tpu_torch.models.gpt import GPT_Small
from pddl_tpu_torch.models.llama import Llama_1B, tiny_llama
from pddl_tpu_torch.models.vit import ViT_S16
from pddl_tpu_torch.parallel import get_strategy
from pddl_tpu_torch.parallel import tensor_parallel as ttp
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import make_optimizer

ITEM_7 = r"ROADMAP\.md queue 1 item 7"


# ------------------------------------------------------------ placement
def _fake_mesh(model=1, expert=1):
    """A mesh record with the axis sizes (no processes: placement only)."""
    sizes = {"data": 1, "model": model, "seq": 1, "expert": expert,
             "stage": 1}
    return tmesh.Mesh(sizes, (0,), None, torch.device("cpu"))


def _jax_specs(jmodel, sample, strategy, **apply_kw):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), sample, train=False, **apply_kw))["params"]
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = "/" + "/".join(str(getattr(k, "key", k)) for k in keypath)
        out[path] = (tuple(leaf.shape),
                     tuple(strategy._spec_for(path, tuple(leaf.shape))))
    return out


FAMILIES = {
    "llama_1b": (lambda: Llama_1B(vocab_size=128256, device="meta"),
                 lambda: JaxLlama1B(vocab_size=128256),
                 lambda: jnp.ones((1, 8), jnp.int32), "LLAMA"),
    "gpt2_small": (lambda: GPT_Small(vocab_size=50257, device="meta"),
                   lambda: JaxGPTSmall(vocab_size=50257),
                   lambda: jnp.ones((1, 8), jnp.int32), "VIT"),
    "vit_s16": (lambda: ViT_S16(device="meta"), lambda: JaxViTS16(),
                lambda: jnp.ones((1, 224, 224, 3)), "VIT"),
    "moe_llama": (lambda: Llama_1B(vocab_size=128256, depth=4,
                                   moe_experts=8, moe_every=2,
                                   device="meta"),
                  lambda: JaxLlama1B(vocab_size=128256, depth=4,
                                     moe_experts=8, moe_every=2),
                  lambda: jnp.ones((1, 8), jnp.int32), "LLAMA"),
}


@pytest.mark.parametrize("kind", ["tp", "ep"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_placement_equals_jax_spec_for(family, kind, caplog):
    port_fn, jax_fn, sample, rules = FAMILIES[family]
    if kind == "tp":
        ours = ttp.TensorParallelStrategy(
            2, rules=getattr(ttp, f"{rules}_TP_RULES"), device="cpu")
        ours._mesh = _fake_mesh(model=2)
        theirs = jtp.TensorParallelStrategy(
            2, rules=getattr(jtp, f"{rules}_TP_RULES"))
    else:
        ours = ttp.ExpertParallelStrategy(
            2, model_parallel=2, rules=getattr(ttp, f"{rules}_EP_RULES"),
            device="cpu")
        ours._mesh = _fake_mesh(model=2, expert=2)
        theirs = jtp.ExpertParallelStrategy(
            2, model_parallel=2, rules=getattr(jtp, f"{rules}_EP_RULES"))
    want = _jax_specs(jax_fn(), sample(), theirs)
    with caplog.at_level(logging.WARNING):
        placed = ours.placements(port_fn())
    got = {pl.leaf.path: (pl.leaf.shape, pl.spec) for pl in placed.values()}
    assert got == want
    sharded = {n: pl for n, pl in placed.items() if pl.axis}
    assert sharded
    for name, pl in sharded.items():
        jd = pl.spec.index(pl.axis)
        assert pl.leaf.port_dims[jd] == pl.dim
    vocab_warned = "is not divisible by model axis 2" in caplog.text
    assert vocab_warned == (family == "gpt2_small")
    if family == "gpt2_small":
        assert got["/lm_head/kernel"][1] == ()
        assert got["/token_embed/embedding"][1] == ()
    if family == "moe_llama" and kind == "ep":
        assert got["/block3/moe/w1"][1] == ("expert",)
        assert got["/block3/moe/router/kernel"][1] == ()


def test_placement_maps_through_the_bridge():
    """A bound TP2 model's blocks are the bridged whole tensors cut along
    the JAX dims of their specs (``bridge.shard_state_dict``)."""
    seeded = tiny_llama(vocab_size=64, max_len=64, moe_experts=4,
                        moe_every=2, device="cpu", seed=3)
    whole = bridge.llama_params_from_jax(
        bridge.llama_params_to_jax(seeded))
    strat = ttp.ExpertParallelStrategy(2, model_parallel=2,
                                       rules=ttp.LLAMA_EP_RULES, device="cpu")
    strat._mesh = _fake_mesh(model=2, expert=2)
    model = tiny_llama(vocab_size=64, max_len=64, moe_experts=4,
                       moe_every=2, device="cpu")
    model.load_state_dict(whole)
    strat.bind(model)
    cut = bridge.shard_state_dict(whole, strat)
    for name, t in model.state_dict().items():
        assert torch.equal(t, cut[name]), name
    q = whole["blocks.0.attn.query.weight"]
    assert torch.equal(cut["blocks.0.attn.query.weight"], q[:q.shape[0] // 2])
    w1 = whole["blocks.1.moe.w1"]
    assert torch.equal(cut["blocks.1.moe.w1"], w1[:2])
    assert model.blocks[0].attn.num_heads == 2
    assert model.blocks[0].attn.num_kv_heads == 1
    assert model.cache_kv_heads == 1
    # The JAX cache rule: the 2 K/V heads split over the model axis.
    assert strat.decode_cache_sharding(2) == "model"
    assert strat.decode_cache_sharding(3) is None
    assert model.blocks[1].moe.n_local == 2


# ----------------------------------------------------------------- mesh
def test_mesh_rank_order_and_axis_lines():
    sizes = {"data": 2, "model": 2, "seq": 1, "expert": 2, "stage": 1}
    # rank = d*(model*expert) + m*expert + e, as JAX's row-major order.
    assert tmesh.axis_coords(sizes, 5) == {"data": 1, "model": 0, "seq": 0,
                                           "expert": 1, "stage": 0}
    ranks = tuple(range(8))
    assert tmesh.axis_lines(sizes, "model", ranks) == [
        (0, 2), (1, 3), (4, 6), (5, 7)]
    assert tmesh.axis_lines(sizes, "expert", ranks) == [
        (0, 1), (2, 3), (4, 5), (6, 7)]
    assert tmesh.axis_lines(sizes, "data", ranks) == [
        (0, 4), (1, 5), (2, 6), (3, 7)]
    jm = jax.sharding.Mesh(np.arange(8).reshape(2, 2, 1, 2, 1),
                           tmesh.CANONICAL_AXES)
    assert jm.devices[1, 0, 0, 1, 0] == 5


@pytest.mark.parametrize("axis", ["seq", "stage"])
def test_unported_axes_and_pipeline_name_item_7(axis):
    """The seq and stage axes run over the job's processes now, in JAX's
    rank order (tests/test_torch_sequence_parallel.py and
    tests/test_torch_pipeline.py train on them): ``"pipeline"`` builds
    and a Llama takes a mesh. What stays item 7: either axis on a mesh
    of chosen ranks, and a seq axis beside the model axis."""
    with pytest.raises(NotImplementedError, match=ITEM_7):
        tmesh.build_mesh(tmesh.MeshConfig(data=1, **{axis: 2}),
                         ranks=(0, 1), group=object())
    sizes = tmesh.MeshConfig(data=-1, model=2, **{axis: 2}).axis_sizes(8)
    if axis == "seq":
        with pytest.raises(NotImplementedError, match=ITEM_7):
            tmesh._check_axes(sizes, False)
    else:
        tmesh._check_axes(sizes, False)  # 3D: data x model x stage
    jm = jax.sharding.Mesh(np.arange(8).reshape(
        [sizes[a] for a in tmesh.CANONICAL_AXES]), tmesh.CANONICAL_AXES)
    for rank in range(8):
        c = tmesh.axis_coords(sizes, rank)
        assert jm.devices[tuple(c[a] for a in tmesh.CANONICAL_AXES)] == rank
    assert type(get_strategy("pipeline", n_stages=2)).__name__ == \
        "PipelineStrategy"
    mesh = tmesh.Mesh(dict(sizes, model=1, **{axis: 2}), (0,), None,
                      torch.device("cpu"))
    model = Llama_1B(vocab_size=64, device="meta", mesh=mesh,
                     attention="ring_flash")
    assert model.blocks[0].attn.seq.n == (2 if axis == "seq" else 1)


def test_strategies_take_the_jax_signatures():
    import inspect

    for name, ours, theirs in (
            ("tensor_parallel", ttp.TensorParallelStrategy,
             jtp.TensorParallelStrategy),
            ("expert_parallel", ttp.ExpertParallelStrategy,
             jtp.ExpertParallelStrategy)):
        jsig = inspect.signature(theirs.__init__).parameters
        tsig = inspect.signature(ours.__init__).parameters
        assert list(jsig) == list(tsig)[:len(jsig)]
        got = get_strategy(name, **({"expert_parallel": 1}
                                    if name == "expert_parallel" else {}),
                           device="cpu")
        assert type(got) is ours and ours.name == name
        assert got.mesh.shape["model"] == 1


# ------------------------------------------- two processes against JAX
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _jax_model(family, extra):
    kw = model_kw(family, extra)
    return jax_tiny_llama(**kw) if family == "llama" else jax_tiny_vit(**kw)


def _jax_trainer(name):
    family, extra, _, opt, _ = LEGS[name]
    optimizer = opt
    if opt == "adam":
        optimizer = jax_make_optimizer("adam", LR["adam"],
                                       grad_clip_norm=CLIP)
    jtr = JaxTrainer(_jax_model(family, extra), optimizer=optimizer,
                     learning_rate=LR[opt], seed=0, log_grad_norm=True,
                     **keys(family))
    jtr.init_state(batch(family, 0))
    return jtr


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """The children's outputs, and each leg's JAX run from the same
    weights (computed here while the children run)."""
    work = tmp_path_factory.mktemp("tp")
    trainers = {name: _jax_trainer(name) for name in LEGS}
    init = {}
    for name, (family, _, kind, _, _) in LEGS.items():
        params = jax.tree.map(np.asarray, trainers[name].state.params)
        for k, v in _flat(params).items():
            init[f"{family}_{kind}:{k}"] = v
    np.savez(work / "init.npz", **init)
    cluster = Cluster(os.path.join(REPO, "tests", "_torch_tp_child.py"), 2,
                      str(work))
    try:
        runs = {}
        for name, jtr in trainers.items():
            family, _, _, _, steps = LEGS[name]
            hist = jtr.fit(iter([batch(family, s) for s in range(steps)]),
                           epochs=steps, steps_per_epoch=1, verbose=0)
            runs[name] = (hist.history, jax.tree.map(np.asarray,
                                                     jtr.state.params))
        ref = np.asarray(jax_generate(
            _jax_model("llama", {}), {"params": _initial(work)},
            jnp.asarray(prompt()), NEW))
        outs = cluster.wait(timeout=240)
    finally:
        cluster.kill()
    assert all("OK" in o for o in outs)
    return work, runs, ref


def _initial(work):
    """The TP Llama's initial weights as a JAX tree (from init.npz)."""
    from _torch_tp_child import unflatten

    init = np.load(work / "init.npz")
    return unflatten({k.split(":", 1)[1]: init[k] for k in init.files
                      if k.startswith("llama_tp:")})


@pytest.mark.parametrize("name", sorted(LEGS))
def test_sharded_step_matches_jax_single_device(legs, name):
    work, runs, _ = legs
    family, extra, kind, opt, steps = LEGS[name]
    got = np.load(work / f"{name}.npz")
    hist, want = runs[name]
    np.testing.assert_allclose(got["log/loss"], hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["log/grad_norm"], hist["grad_norm"],
                               rtol=1e-4)
    if "moe_drop_rate" in hist:
        np.testing.assert_allclose(got["log/moe_drop_rate"],
                                   hist["moe_drop_rate"], rtol=0, atol=1e-6)
        if name == "ep_llama":
            assert hist["moe_drop_rate"][0] > 0  # the capacity drops
    model = (tiny_llama(device="meta", **model_kw(family, extra))
             if family == "llama" else None)
    sd = {k[len("param/"):]: torch.from_numpy(got[k]) for k in got.files
          if k.startswith("param/")}
    to_jax = (bridge.llama_params_to_jax(model, sd) if family == "llama"
              else bridge.vit_params_to_jax(_vit_meta(extra), sd))
    bound = 2 * LR[opt] * steps if opt == "adam" else 2e-5
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=bound), to_jax, want)
    names = list(got["count_names"])
    calls = dict(zip(names, got["counts"][:, 0]))
    if kind == "tp":
        # Two all-reduces a block forward, their two backward, the
        # vocabulary gather (Llama) a step.
        assert calls["reduce_from_fwd"] >= 2 * 2 * steps
        assert calls["copy_to_bwd"] >= 2 * 2 * steps
    else:
        assert calls["reduce_from_fwd"] == 2 * steps  # one per routed block


def _vit_meta(extra):
    from pddl_tpu_torch.models.vit import tiny_vit

    return tiny_vit(device="meta", **model_kw("vit", extra))


def test_generate_and_speculative_are_token_exact_at_tp2(legs):
    work, _, ref = legs
    got = np.load(work / "generate.npz")
    assert int(got["cache_heads"]) * 2 == int(got["whole_heads"])
    np.testing.assert_array_equal(got["tokens"], ref)
    np.testing.assert_array_equal(got["spec"], ref)
    # The margin of each decoded position's top-2 logits: the tokens are
    # not decided by a rounding tie.
    tm = tiny_llama(device="cpu", **model_kw("llama", {}))
    tm.load_state_dict(bridge.llama_params_from_jax(_initial(work)))
    with torch.no_grad():
        logits = tm(torch.tensor(ref[:, :-1]).long(), train=False)
    top2 = logits[:, ref.shape[1] - NEW - 1:].topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    print(f"tp2 generate top-2 margin {margin:.3g}, draft_len {DRAFT}")
    assert margin > 1e-5


def test_tp2_save_restores_into_one_process_bitwise(legs):
    work, _, _ = legs
    got = np.load(work / "tp_adam.npz")
    ckpt = Checkpointer(str(work / "ckpt"), read_only=True)
    assert ckpt.all_steps() == [LEGS["tp_adam"][4]]
    one = Trainer(tiny_llama(device="cpu", **model_kw("llama", {})),
                  optimizer=lambda ps: make_optimizer(
                      ps, "adam", LR["adam"], grad_clip_norm=CLIP),
                  device="cpu", **keys("llama"))
    state, meta = ckpt.restore()
    one.load_state_dict(local_state(one, state, meta))
    for name, t in one.model.state_dict().items():
        assert torch.equal(t, torch.from_numpy(got[f"param/{name}"])), name
    moments = [t for st in one.optimizer.state.values() for t in st.values()
               if isinstance(t, torch.Tensor) and t.ndim]
    shapes = {tuple(p.shape) for p in one.model.parameters()}
    assert moments and all(tuple(t.shape) in shapes for t in moments)
