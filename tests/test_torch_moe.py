"""The port's routed experts (`pddl_tpu_torch/ops/moe.py`) against the JAX
package's `SwitchFFN` on the CPU, f32.

- The JAX module's dense dispatch and combine tensors are read as it
  runs (its `einsum` calls, through a recording stand-in for the module's
  `jnp`), so the port's routing is held to them: the kept set and each
  kept token's queue position EXACTLY, the gates within 1e-6, the aux
  loss and `moe_drop_rate` within 1e-6, the output within 1e-5. Cases:
  top-1 and top-2, GELU and SwiGLU experts, a capacity that drops (a
  router biased toward two experts) and the eval-dropless path.
- Routed Llama (Mixtral blocks), GPT and ViT logits equal the JAX
  models' through the bridge within 1e-5, in train and eval modes.
- One `Trainer` step of a routed Llama against the JAX `Trainer`: the
  loss with its aux term within rtol 1e-5, the logged `moe_drop_rate`
  within 1e-6, the parameters within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.moe as jax_moe
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.models.vit import tiny_vit as jax_tiny_vit
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch import bridge
from pddl_tpu_torch.models.gpt import tiny_gpt
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.models.vit import tiny_vit
from pddl_tpu_torch.ops.moe import SwitchFFN, sown
from pddl_tpu_torch.train.loop import Trainer

B, S, E, N, H = 2, 16, 32, 4, 48


def _init(jm, key, *args, **kw):
    """``jm.init`` compiled once (faster than flax's eager init)."""
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init(k, *args, **kw))(jax.random.key(key))["params"])


class _Recorder:
    """The JAX module's ``jnp`` with its dispatch/combine einsums
    recorded."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *args, **kw):
        if spec in ("bsnc,bsd->bncd", "bsnc,bncd->bsd"):
            self.seen[spec] = np.asarray(args[0])
        return jnp.einsum(spec, *args, **kw)


def _jax_run(monkeypatch, module, params, x, train):
    rec = _Recorder()
    monkeypatch.setattr(jax_moe, "jnp", rec)
    out, sown_ = module.apply({"params": params}, jnp.asarray(x), train,
                              mutable=["losses", "metrics"])
    monkeypatch.setattr(jax_moe, "jnp", jnp)
    return (np.asarray(out), rec.seen["bsnc,bsd->bncd"],
            rec.seen["bsnc,bncd->bsd"],
            float(jax.tree.leaves(sown_["losses"])[0]),
            float(jax.tree.leaves(sown_["metrics"])[0]))


def _port_dense(routing, n, capacity):
    """The port's routing as the JAX module's dense dispatch and combine."""
    b, s = routing.expert[0].shape
    dispatch = np.zeros((b, s, n, capacity), np.float32)
    combine = np.zeros_like(dispatch)
    for idx, keep, pos, gate in zip(routing.expert, routing.kept,
                                    routing.position, routing.gates):
        for bi, si in zip(*np.nonzero(keep.numpy())):
            e, c = int(idx[bi, si]), int(pos[bi, si])
            dispatch[bi, si, e, c] += 1
            combine[bi, si, e, c] += float(gate[bi, si])
    return dispatch, combine


CASES = {
    # name: (top_k, expert_act, capacity_factor, train, router bias)
    "top1_gelu_drops": (1, "gelu", 1.0, True, True),
    "top2_swiglu_drops": (2, "swiglu", 1.0, True, True),
    "top2_gelu_roomy": (2, "gelu", 2.0, True, False),
    "top2_swiglu_eval_dropless": (2, "swiglu", 1.0, False, True),
    "top1_gelu_eval_dropless": (1, "gelu", 0.5, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_switch_ffn_routing_and_output_match_jax(monkeypatch, case):
    top_k, act, cf, train, biased = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    kw = dict(num_experts=N, top_k=top_k, capacity_factor=cf,
              expert_act=act)
    if act == "swiglu":
        kw["hidden_dim"] = H
    jm = jax_moe.SwitchFFN(**kw)
    params = _init(jm, 1, jnp.asarray(x))
    if biased:  # most tokens want experts 0 and 1: their queues overflow
        params["router"]["bias"] = np.array([2.0, 1.5, 0.0, 0.0],
                                            np.float32)
    out, dispatch, combine, aux, drop = _jax_run(monkeypatch, jm, params, x,
                                                 train)
    tm = SwitchFFN(E, N, top_k=top_k, capacity_factor=cf, expert_act=act,
                   hidden_dim=H if act == "swiglu" else None, device="cpu")
    sd = {}
    bridge._moe_from_jax(params, "", sd)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train)
        routing = tm.routing(torch.from_numpy(x), train)
    capacity = dispatch.shape[-1]
    assert routing.capacity == capacity
    pd, pc = _port_dense(routing, N, capacity)
    np.testing.assert_array_equal(pd, dispatch)      # kept set, positions
    np.testing.assert_allclose(pc, combine, rtol=0, atol=1e-6)
    values = tm.sown
    np.testing.assert_allclose(float(values["losses"]["moe_aux_loss"]), aux,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(values["metrics"]["moe_drop_rate"]),
                               drop, rtol=0, atol=1e-6)
    assert (drop > 0) == (train and biased)
    np.testing.assert_allclose(got.numpy(), out, rtol=0, atol=1e-5)


def test_switch_ffn_refuses_what_jax_refuses():
    for kw, match in ((dict(top_k=5), "top_k=5"),
                      (dict(expert_act="relu"), "unknown expert_act")):
        with pytest.raises(ValueError, match=match):
            SwitchFFN(E, N, device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jax_moe.SwitchFFN(num_experts=N, **kw).init(
                jax.random.key(0), jnp.ones((1, 4, E)))


FAMILIES = {
    "llama": (jax_tiny_llama, tiny_llama, bridge.llama_params_from_jax,
              dict(vocab_size=64, max_len=64, moe_experts=4, moe_top_k=2,
                   moe_every=1, moe_capacity_factor=1.0)),
    "gpt": (jax_tiny_gpt, tiny_gpt, bridge.gpt_params_from_jax,
            dict(vocab_size=64, max_len=64, moe_experts=4, moe_top_k=2)),
    "vit": (jax_tiny_vit, tiny_vit, bridge.vit_params_from_jax,
            dict(moe_experts=4, moe_top_k=1, moe_every=1)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_routed_models_match_jax_through_the_bridge(family):
    jfn, tfn, from_jax, kw = FAMILIES[family]
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
         if family == "vit" else
         rng.integers(0, 64, (2, 24)).astype(np.int32))
    jm = jfn(**kw)
    params = _init(jm, 2, jnp.asarray(x), train=False)
    tm = tfn(device="cpu", **kw)
    tm.load_state_dict(from_jax(params))
    to_jax = {"llama": bridge.llama_params_to_jax,
              "gpt": bridge.gpt_params_to_jax,
              "vit": bridge.vit_params_to_jax}[family](tm)
    jax.tree.map(np.testing.assert_array_equal, to_jax, params)
    for train in (True, False):
        ref, coll = jax.jit(lambda p, t=train: jm.apply(
            {"params": p}, jnp.asarray(x), train=t,
            mutable=["losses", "metrics"],
            rngs={"dropout": jax.random.key(0)}))(params)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
        values = sown(tm)
        np.testing.assert_allclose(
            [float(v) for v in values["losses"]["moe_aux_loss"]],
            [float(v) for v in jax.tree.leaves(coll["losses"])], atol=1e-6)


def test_trainer_step_adds_aux_loss_and_logs_drop_rate():
    kw = FAMILIES["llama"][3]
    rng = np.random.default_rng(9)
    seq = rng.integers(0, 64, (4, 17)).astype(np.int32)
    data = [{"tokens": seq[:, :-1], "targets": seq[:, 1:]}]
    jtr = JaxTrainer(jax_tiny_llama(**kw), optimizer="sgd",
                     learning_rate=0.1, seed=0, input_key="tokens",
                     target_key="targets")
    jtr.init_state(data[0])
    tm = tiny_llama(device="cpu", **kw)
    tm.load_state_dict(bridge.llama_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(tm, optimizer="sgd", learning_rate=0.1, seed=0,
                 input_key="tokens", target_key="targets", device="cpu")
    jh = jtr.fit(iter(data), epochs=1, steps_per_epoch=1, verbose=0)
    th = tr.fit(iter(data), epochs=1, steps_per_epoch=1, verbose=0)
    assert set(th.history) == set(jh.history)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-5)
    assert jh.history["moe_drop_rate"][0] > 0
    np.testing.assert_allclose(th.history["moe_drop_rate"],
                               jh.history["moe_drop_rate"], rtol=0,
                               atol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                         atol=1e-5),
                 bridge.llama_params_to_jax(tm),
                 jax.tree.map(np.asarray, jtr.state.params))
    ev_t = tr.evaluate(iter(data), steps=1, verbose=0)
    ev_j = jtr.evaluate(iter(data), steps=1, verbose=0)
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)
    assert ev_t["moe_drop_rate"] == ev_j["moe_drop_rate"] == 0.0
