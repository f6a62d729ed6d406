"""Pipeline parallelism of the port (`ops/pipeline.py`, `models/gpipe.py`,
`parallel/pipeline.py`) against the JAX package on the CPU.

- A 2-process gloo cluster (`tests/_torch_sp_child.py pp`, one deadline)
  binds `GPipeLlama` (M 1, 2, 4, and M 2 with `remat_stages`),
  `GPipeGPT` and `GPipeViT` (M 2) at stage 2 from the JAX GPipe's
  initial weights (`bridge.gpipe_params_from_jax`) and runs the forward
  and the backward of a fixed cotangent; the outputs and every gathered
  gradient are held against the JAX GPipe's (`jax.vjp` of `apply` on the
  fake mesh, at M 2: the JAX pipeline is the same function at every M)
  and the port's own `apply_sequential` at each leg's options:
  outputs within 1e-5, each gradient within 1e-4 of its own max-abs. The same
  cluster takes an Adam step of `GPipeLlama` and saves it: the save
  restores bitwise into one process's whole model.
- A 4-process cluster trains `dryrun_multichip` shape 5 (data 2 x stage 2
  `GPipeViT`) and shape 7 (stage 2 x model 2, Megatron TP inside each
  stage) one SGD step each, against the JAX single-device `Trainer` over
  the sequential oracle: the loss within 1e-5 relative, the gradient norm
  within 1e-4 relative, every parameter within 2e-5.
- A process of a mesh whose `stage` axis spans processes lays out only
  its stage, the embed and the head, each equal to the whole model's.
- Placement on `meta`: every parameter of full-width `GPipeLlama`
  (Llama-1B widths, 2 stages x 8 blocks) and of `GPipeViT` at ViT-S/16
  (2 x 6), judged on its JAX path and stacked shape, gets the JAX
  `PipelineStrategy._spec_for` under `PIPELINE_RULES` and
  `PIPELINE_TP_RULES` (the JAX trees from `jax.eval_shape`).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from _torch_cluster import REPO, Cluster
from _torch_sp_child import (
    LR,
    PP_ADAM,
    PP_FWD,
    PP_LEG_KW,
    PP_LEGS,
    pp_input,
    pp_kw,
    pp_leg_batch,
    port_extra,
)
from pddl_tpu.core.mesh import MeshConfig, build_mesh
from pddl_tpu.models.gpt import GPipeGPT as JaxGPipeGPT
from pddl_tpu.models.llama import GPipeLlama as JaxGPipeLlama
from pddl_tpu.models.vit import GPipeViT as JaxGPipeViT
from pddl_tpu.parallel import pipeline as jpp
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch import bridge
from pddl_tpu_torch.ckpt import Checkpointer
from pddl_tpu_torch.ckpt.checkpoint import local_state
from pddl_tpu_torch.core import mesh as tmesh
from pddl_tpu_torch.models.gpipe import DroppedStage
from pddl_tpu_torch.models.gpt import GPipeGPT
from pddl_tpu_torch.models.llama import GPipeLlama
from pddl_tpu_torch.models.vit import GPipeViT
from pddl_tpu_torch.ops.pipeline import gpipe_apply
from pddl_tpu_torch.parallel import get_strategy
from pddl_tpu_torch.parallel import pipeline as tpp
from pddl_tpu_torch.train.loop import Trainer

JAX_GPIPE = {"llama": JaxGPipeLlama, "gpt": JaxGPipeGPT, "vit": JaxGPipeViT}
PORT_GPIPE = {"llama": GPipeLlama, "gpt": GPipeGPT, "vit": GPipeViT}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _jax_mesh(data=1, stage=2, model=1):
    n = data * stage * model
    return build_mesh(MeshConfig(data=data, stage=stage, model=model),
                      devices=jax.devices()[:n])


def _fake_mesh(stage=2, model=1):
    """A mesh record with the axis sizes (no processes)."""
    sizes = {"data": 1, "model": model, "seq": 1, "expert": 1,
             "stage": stage}
    return tmesh.Mesh(sizes, (0,), None, torch.device("cpu"))


class _Sequential:
    """The JAX GPipe model's unpipelined path behind the Trainer's
    ``init``/``apply`` surface (``__graft_entry__._SequentialGPipeOracle``)."""

    def __init__(self, gpipe):
        self._gpipe = gpipe

    def init(self, rng, x, train: bool = False):
        return self._gpipe.init(rng, x, train=train)

    def apply(self, variables, x, *, train=True, mutable=False, rngs=None):
        out = self._gpipe.apply_sequential(variables, x)
        return (out, {}) if mutable else out


def _jax_leg_model(leg, mesh):
    return JaxGPipeViT(mesh=mesh, patch_size=PP_LEGS[leg][3], **PP_LEG_KW)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both clusters' outputs, and the JAX runs (computed meanwhile)."""
    work = tmp_path_factory.mktemp("pp")
    init, params = {}, {}
    mesh = _jax_mesh()
    for family in ("llama", "gpt", "vit"):
        x, _ = pp_input(family)
        jm = JAX_GPIPE[family](mesh=mesh, **pp_kw(family, {}, 2))
        params[family] = jax.tree.map(np.asarray, jm.init(
            jax.random.key(3), jnp.asarray(x))["params"])
        init.update({f"fwd_{family}:{k}": v
                     for k, v in _flat(params[family]).items()})
    trainers = {}
    for leg in PP_LEGS:
        jtr = JaxTrainer(_Sequential(_jax_leg_model(leg, mesh)),
                         optimizer="sgd", learning_rate=LR["sgd"], seed=0,
                         log_grad_norm=True)
        jtr.init_state(pp_leg_batch(leg))
        trainers[leg] = jtr
        init.update({f"{leg}:{k}": v for k, v in _flat(jax.tree.map(
            np.asarray, jtr.state.params)).items()})
    np.savez(work / "init.npz", **init)
    script = os.path.join(REPO, "tests", "_torch_sp_child.py")
    clusters = []
    try:
        for world in (2, 4):
            clusters.append(Cluster(script, world, "pp", str(work)))
        want = {}
        for family in ("llama", "gpt", "vit"):
            # The JAX pipeline at M 2 (its output and gradients are the
            # same function at every M, tests/test_pipeline.py).
            x, g = pp_input(family)
            jm = JAX_GPIPE[family](mesh=mesh, **pp_kw(family, {}, 2))

            def run(p, xx, gg, jm=jm):
                out, vjp = jax.vjp(lambda q: jm.apply({"params": q}, xx), p)
                return out, vjp(gg)[0]

            out, grads = jax.jit(run)(params[family], jnp.asarray(x),
                                      jnp.asarray(g))
            want[family] = (np.asarray(out),
                            jax.tree.map(np.asarray, grads))
        for leg, jtr in trainers.items():
            hist = jtr.fit(iter([pp_leg_batch(leg)]), epochs=1,
                           steps_per_epoch=1, verbose=0)
            want[leg] = (hist.history,
                         jax.tree.map(np.asarray, jtr.state.params))
        outs = [o for c in clusters for o in c.wait(timeout=240)]
    finally:
        for c in clusters:
            c.kill()
    assert all("OK" in o for o in outs)
    return work, want, params


def _sequential_run(family, extra, m, params):
    """The port's ``apply_sequential``: output and gradients by name."""
    model = PORT_GPIPE[family](mesh=_fake_mesh(), device="cpu",
                               **pp_kw(family, extra, m),
                               **port_extra(family))
    model.load_state_dict(bridge.gpipe_params_from_jax(params))
    x, g = pp_input(family)
    out = model.apply_sequential(torch.from_numpy(x).long()
                                 if family != "vit" else torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), {n: p.grad for n, p in
                                  model.named_parameters()}, model


# A reference gradient whose max-abs is below this share of the model's
# largest (eight f32 ulps of it) is nought to rounding: the key biases',
# 0 in exact arithmetic (a key bias shifts each query's logits by one
# constant, which the softmax ignores), read ~1e-8 of the largest here;
# every other leaf reads above 1e-2 of it.
ROUNDING = 2.0 ** -20


def _grad_tol(ref, top):
    """1e-4 of ``ref``'s own max-abs; a leaf nought to rounding is held to
    the rounding level of the model's largest gradient, ``top``."""
    own = float(ref.abs().max())
    return ROUNDING * top if own <= ROUNDING * top else 1e-4 * own


@pytest.mark.parametrize("leg", sorted(PP_FWD))
def test_gpipe_forward_and_gradients_match_jax_and_sequential(runs, leg):
    work, want, params = runs
    family, extra, m, _ = PP_FWD[leg]
    got = np.load(work / f"pp_{leg}.npz")
    w_out, w_grads = want[family]
    np.testing.assert_allclose(got["out"], w_out, rtol=0, atol=1e-5)
    seq_out, seq_grads, model = _sequential_run(family, extra, m,
                                                params[family])
    np.testing.assert_allclose(got["out"], seq_out, rtol=0, atol=1e-5)
    grads = {k[len("grad/"):]: torch.from_numpy(got[k]) for k in got.files
             if k.startswith("grad/")}
    assert set(grads) == set(seq_grads)
    # Each leaf within 1e-4 of its own reference max-abs.
    top = max(float(w.abs().max()) for w in seq_grads.values())
    for name, g in grads.items():
        torch.testing.assert_close(g, seq_grads[name], rtol=0,
                                   atol=_grad_tol(seq_grads[name], top))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=_grad_tol(torch.from_numpy(np.array(b)), top)),
        bridge.gpipe_params_to_jax(model, grads), w_grads)
    calls = dict(zip(got["count_names"], got["counts"][:, 0]))
    # Each microbatch hops once forward and once back; the outputs reach
    # every stage once. Each process holds half the blocks.
    assert calls["pp_hop_fwd"] == calls["pp_hop_bwd"] == m
    assert calls["pp_outputs_fwd"] == 1
    stage0 = sum(t.numel() for n, t in grads.items()
                 if n.startswith("stages.0."))
    assert int(got["local_params"]) == (sum(t.numel() for t in
                                            grads.values()) - stage0)


class _Allocations(TorchDispatchMode):
    """Bytes of every new CPU storage the ops under it return."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {t.untyped_storage().data_ptr() for t in
                 tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)
                 and t.device.type == "cpu"}
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.device.type == "cpu"
                    and t.untyped_storage().data_ptr() not in given):
                self.bytes += t.untyped_storage().nbytes()
        return out


@pytest.mark.parametrize("family", sorted(PORT_GPIPE))
def test_a_stage_process_lays_out_only_its_stage(family):
    """Built on a mesh whose ``stage`` axis spans processes (here a record
    that places this process at stage 1), a GPipe model allocates its own
    stage, the embed and the head and nothing more, and those weights
    equal the whole model's, stage by stage."""
    sizes = {"data": 1, "model": 1, "seq": 1, "expert": 1, "stage": 2}
    held = tmesh.Mesh(sizes, (0,), None, torch.device("cpu"),
                      axis_ranks={"stage": (1, 0)},
                      groups={"stage": object()})
    kw = dict(pp_kw(family, {}, 2), **port_extra(family), device="cpu",
              seed=3)
    with _Allocations() as seen:
        model = PORT_GPIPE[family](mesh=held, **kw)
    whole = PORT_GPIPE[family](mesh=_fake_mesh(), **kw)
    assert model.stage_index == 1 and not model.is_whole
    assert isinstance(model.stages[0], DroppedStage)
    mine = model.state_dict()
    assert seen.bytes == sum(t.numel() * t.element_size()
                             for t in mine.values())
    every = whole.state_dict()
    assert set(every) - set(mine) == {k for k in every
                                      if k.startswith("stages.0.")}
    for name, t in mine.items():
        assert torch.equal(t, every[name]), name
    # Each part has draws of its own: the two stages differ.
    assert not torch.equal(every["stages.0.blocks.0.attn.query.weight"],
                           every["stages.1.blocks.0.attn.query.weight"])


@pytest.mark.parametrize("leg", sorted(PP_LEGS))
def test_pipeline_step_matches_jax_single_device(runs, leg):
    work, want, _ = runs
    got = np.load(work / f"{leg}.npz")
    hist, w_params = want[leg]
    np.testing.assert_allclose(got["log/loss"], hist["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["log/grad_norm"], hist["grad_norm"],
                               rtol=1e-4)
    sd = {k[len("param/"):]: torch.from_numpy(got[k]) for k in got.files
          if k.startswith("param/")}
    meta = GPipeViT(mesh=_fake_mesh(), device="meta",
                    patch_size=PP_LEGS[leg][3], image_size=32, **PP_LEG_KW)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=2e-5),
        bridge.gpipe_params_to_jax(meta, sd), w_params)
    assert bool(got["replicated_equal"])  # the embed and head, everywhere
    calls = dict(zip(got["count_names"], got["counts"][:, 0]))
    assert calls["pp_hop_fwd"] == calls["pp_hop_bwd"] == 2
    if PP_LEGS[leg][2] > 1:  # Megatron inside the stage
        assert calls["reduce_from_fwd"] >= 2 * 2


def test_pipeline_save_restores_into_one_process(runs):
    work, _, _ = runs
    got = np.load(work / "pp_adam.npz")
    ckpt = Checkpointer(str(work / "ckpt_pp"), read_only=True)
    assert ckpt.all_steps() == [PP_ADAM["steps"]]
    whole = GPipeLlama(mesh=_fake_mesh(), device="cpu",
                       **pp_kw("llama", {}, PP_ADAM["m"]))
    one = Trainer(whole, optimizer="adam", learning_rate=1e-3,
                  device="cpu", input_key="tokens", target_key="targets")
    state, meta = ckpt.restore()
    one.load_state_dict(local_state(one, state, meta))
    for name, t in one.model.state_dict().items():
        assert torch.equal(t, torch.from_numpy(got[name])), name
    moments = {n: one.optimizer.state[p] for n, p in
               one.model.named_parameters()}
    assert all(st["exp_avg"].shape == p.shape for (n, st), p in
               zip(moments.items(), one.model.parameters()))
    x, _ = pp_input("llama", 1)
    assert torch.isfinite(one.model.apply_sequential(
        torch.from_numpy(x).long())).all()


# ------------------------------------------------------------- placement
PLACED = {
    "gpipe_llama_1b": (
        lambda mesh, dev: GPipeLlama(
            vocab_size=128256, n_stages=2, blocks_per_stage=8,
            n_microbatches=2, mesh=mesh, embed_dim=2048, num_heads=32,
            num_kv_heads=8, intermediate_dim=8192, rope_theta=500000.0,
            device=dev),
        lambda mesh: JaxGPipeLlama(
            vocab_size=128256, n_stages=2, blocks_per_stage=8,
            n_microbatches=2, mesh=mesh, embed_dim=2048, num_heads=32,
            num_kv_heads=8, intermediate_dim=8192, rope_theta=500000.0),
        lambda: jnp.ones((2, 8), jnp.int32)),
    "gpipe_vit_s16": (
        lambda mesh, dev: GPipeViT(
            n_stages=2, blocks_per_stage=6, n_microbatches=2, mesh=mesh,
            patch_size=16, embed_dim=384, num_heads=6, num_classes=1000,
            device=dev),
        lambda mesh: JaxGPipeViT(
            n_stages=2, blocks_per_stage=6, n_microbatches=2, mesh=mesh,
            patch_size=16, embed_dim=384, num_heads=6, num_classes=1000),
        lambda: jnp.ones((2, 224, 224, 3))),
}


@pytest.mark.parametrize("mp", [1, 2], ids=["pp_rules", "pp_tp_rules"])
@pytest.mark.parametrize("family", sorted(PLACED))
def test_placement_equals_jax_spec_for(family, mp, caplog):
    port_fn, jax_fn, sample = PLACED[family]
    jmesh = _jax_mesh(data=8 // (2 * mp), stage=2, model=mp)
    theirs = jpp.PipelineStrategy(n_stages=2, model_parallel=mp)
    theirs._mesh = jmesh
    shapes = jax.eval_shape(lambda: jax_fn(jmesh).init(
        jax.random.key(0), sample()))["params"]
    want = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = "/" + "/".join(str(getattr(k, "key", k)) for k in keypath)
        want[path] = (tuple(leaf.shape),
                      tuple(a for a in theirs._spec_for(
                          path, tuple(leaf.shape))))
    ours = tpp.PipelineStrategy(2, model_parallel=mp, device="cpu")
    ours._mesh = _fake_mesh(stage=2, model=mp)
    with caplog.at_level(logging.WARNING):
        placed = ours.placements(port_fn(ours._mesh, "meta"))
    got = {}
    for pl in placed.values():
        got.setdefault(pl.leaf.path, set()).add((pl.leaf.shape, pl.spec))
    assert set(got) == set(want)
    for path, specs in got.items():
        assert specs == {want[path]}, path
    staged = [pl for pl in placed.values() if pl.stage is not None]
    assert {pl.stage for pl in staged} == {0, 1}
    assert all(pl.spec[0] == "stage" for pl in staged)
    if mp > 1:
        q = [pl for n, pl in placed.items()
             if n.endswith("attn.query.weight")]
        assert q and all(pl.axis == "model" and pl.dim == 0 for pl in q)


def test_gpipe_apply_checks_and_the_degenerate_stage():
    mesh = _fake_mesh(stage=1)
    x = torch.randn(6, 4)
    with pytest.raises(ValueError, match="per-data-shard batch 6 not "
                                         "divisible by 4 microbatches"):
        gpipe_apply({}, x, mesh=mesh, stage_fn=lambda p, h: h,
                    n_microbatches=4)
    w = torch.randn(4, 4, requires_grad=True)
    out = gpipe_apply({"w": w}, x, mesh=mesh,
                      stage_fn=lambda p, h: h @ p["w"], n_microbatches=2,
                      remat_stages=True)
    torch.testing.assert_close(out, x @ w)
    with pytest.raises(ValueError, match="must match"):
        GPipeViT(n_stages=2, blocks_per_stage=1, n_microbatches=2,
                 mesh=_fake_mesh(stage=1), device="meta")
    strat = get_strategy("pipeline", n_stages=2, device="cpu")
    strat._mesh = _fake_mesh(stage=2)
    with pytest.raises(ValueError, match="on the strategy's mesh"):
        strat.bind(GPipeViT(n_stages=2, blocks_per_stage=1, n_microbatches=2,
                            mesh=_fake_mesh(), device="meta"))
    with pytest.raises(ValueError, match="batch 3 not divisible by the "
                                         "data axis size"):
        strat._mesh = tmesh.Mesh({"data": 2, "model": 1, "seq": 1,
                                  "expert": 1, "stage": 2}, (0, 1), object(),
                                 torch.device("cpu"))
        strat.distribute_batch({"x": np.zeros((3, 2))})
    assert tpp.PIPELINE_RULES[0][0] == jpp.PIPELINE_RULES[0][0]
    assert [p for p, _ in tpp.PIPELINE_TP_RULES] == [
        p for p, _ in jpp.PIPELINE_TP_RULES]
