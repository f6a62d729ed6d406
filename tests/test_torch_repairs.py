"""Options of the JAX package that the port now takes, or refuses with the
right error, held against the JAX package on the CPU.

- A sliding-window Llama whose decode would need a rolling ring cache
  builds and trains: 3 steps of the port's `Trainer` against the JAX
  `Trainer` from the same bridged weights, losses within the tolerances
  of `tests/test_torch_train.py` (sgd rtol 1e-5, adamw rtol 1e-4). The
  serving engine and the paged cache refuse it with
  `NotImplementedError` in the JAX package's words (they need
  full-length caches), and `generate` decodes it through its ring cache,
  token-exact with the JAX `generate`.
- `flash_attention(fused_backward=False)` takes the reference path: its
  output (within 1e-5, f32) and first-order gradients (within 1e-4) match
  the JAX twin's, and so does a second-order gradient (a gradient
  penalty's, within 1e-4), which the kernels' backward cannot give.
- The metric and loss registry: `perplexity` (logged in log space per
  batch, the epoch value the exp of the mean), `top_5_accuracy`,
  `categorical_crossentropy` and `mse` give the JAX `Trainer`'s `History`
  over 2 steps (losses and perplexity within rtol 1e-5, accuracies
  exactly).
- Every other option of the JAX signatures that the port lacks is
  accepted at the JAX default and raises `NotImplementedError` naming its
  ROADMAP.md item for any other value (`mesh` among them); the `Llama`'s
  `moe_*` options, ported with the routed experts, each give the JAX
  model's training logits (within 1e-5) and drop rate on a routed tiny
  Llama; the trainer's `donate_state`, `eval_with_ema`, retry
  and recovery knobs and `fit(prefetch=)`, ported with the rest of the
  trainer, are held to what each does; `submit`'s `adapter` and `constraint`, ported with
  tenancy, raise the JAX engine's `ValueError` on an engine without a
  `TenantConfig`; `ServeEngine`'s `variables`, `param_transform` and
  `spec_draft_variables`, ported with int8 serving, load or transform
  the weights passed;
  `paged_decode_attention` accepts and ignores `blocks_per_chunk`, and
  the four attention entry points the Pallas `interpret` switch.
- `attention_reference(k_offset=)` gives the JAX twin's output within
  1e-5 (f32), with GQA and with a window.
- bf16 parameter storage: `adam` keeps f32 moments as the JAX
  `make_optimizer` does, and 5 steps over a 64x64 bf16 weight give the
  JAX package's parameters but for at most 1 bf16 ulp in at most 16 of
  the 4,096 elements (the test states why).
"""

import inspect
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.attention as jatt
from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.models.llama import Llama as JaxLlama
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.serve.engine import ServeEngine as JaxServeEngine
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.gpt import generate
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.serve.engine import ServeEngine
from pddl_tpu_torch.serve.kvcache import paged_decode_cache
from pddl_tpu_torch.train.loop import Trainer, _mean_logs

VOCAB = 64
LM = dict(batch_size=4, seq_len=32, vocab_size=VOCAB, seed=3)
KEYS = dict(input_key="tokens", target_key="targets")
ROADMAP_ITEM = r"ROADMAP\.md queue \d item \d"


def _trainers(optimizer, lr, metrics=("accuracy",), loss=None, first=None,
              **model_kw):
    """A JAX and a port Trainer on one bridged tiny Llama."""
    kw = dict(optimizer=optimizer, learning_rate=lr, seed=0,
              metrics=metrics, **KEYS)
    if loss is not None:
        kw["loss"] = loss
    jm = jax_tiny_llama(vocab_size=VOCAB, attention="flash", **model_kw)
    jtr = JaxTrainer(jm, **kw)
    jtr.init_state(first if first is not None else JaxLM(**LM).batch(0))
    tm = tiny_llama(vocab_size=VOCAB, attention="flash", device="cpu",
                    **model_kw)
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    return jm, jtr, tm, Trainer(tm, device="cpu", **kw)


# -------------------------------------------------- the sliding-window Llama
@pytest.mark.parametrize("optimizer,lr,loss_rtol", [("sgd", 0.1, 1e-5),
                                                    ("adamw", 1e-3, 1e-4)])
def test_windowed_llama_trains_like_jax(optimizer, lr, loss_rtol):
    jm, jtr, tm, tr = _trainers(optimizer, lr, max_len=512,
                                sliding_window=8)
    assert jm.uses_ring_cache and tm.uses_ring_cache
    jh = jtr.fit(JaxLM(**LM), epochs=3, steps_per_epoch=1, verbose=0)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=3, steps_per_epoch=1,
                verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=loss_rtol)
    np.testing.assert_allclose(th.history["accuracy"],
                               jh.history["accuracy"], atol=1e-6)


def test_ring_cache_model_is_refused_where_decode_would_build_one():
    model = tiny_llama(vocab_size=VOCAB, max_len=512, sliding_window=8,
                       device="cpu")
    with pytest.raises(NotImplementedError,
                       match="engine needs full-length KV caches"):
        ServeEngine(model, device="cpu", max_slots=2, prefill_len=16)
    with pytest.raises(NotImplementedError,
                       match="requires a full-length cache"):
        paged_decode_cache(model, num_blocks=4, block_size=8)
    with pytest.raises(NotImplementedError, match="ring cache"):
        JaxServeEngine(jax_tiny_llama(vocab_size=VOCAB, max_len=512,
                                      sliding_window=8), {})
    # A window whose ring would be no smaller than max_len needs no ring.
    wide = tiny_llama(vocab_size=VOCAB, max_len=128, sliding_window=100,
                      device="cpu")
    assert not wide.uses_ring_cache
    ServeEngine(wide, device="cpu", max_slots=2, prefill_len=16)


def test_ring_cache_model_decodes_through_generate():
    """The model the engine refuses decodes through `generate`, through
    its rolling ring cache (ring 128 under max_len 512), token-exact with
    the JAX `generate` on the same bridged weights."""
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=512, sliding_window=8)
    params = jm.init(jax.random.key(2), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    model = tiny_llama(vocab_size=VOCAB, max_len=512, sliding_window=8,
                       device="cpu")
    model.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    prompt = np.random.RandomState(5).randint(0, VOCAB, (1, 12))
    ref = jax_generate(jm, {"params": params}, jnp.asarray(prompt, jnp.int32),
                       8)
    got = generate(model, prompt, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------- flash_attention, reference path
def _attn_inputs(seed=0, b=2, h=4, hkv=2, s=48, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, h, s, d).astype(np.float32))


@pytest.mark.parametrize("window", [None, 12])
def test_flash_without_fused_backward_matches_jax_to_second_order(window):
    q, k, v, g = _attn_inputs()
    kw = dict(causal=True, window=window, fused_backward=False)

    def jax_loss(q_, k_, v_):
        return jnp.sum(jatt.flash_attention(q_, k_, v_, **kw) * g)

    def jax_penalty(q_, k_, v_):
        dq = jax.grad(jax_loss)(q_, k_, v_)
        return jnp.sum(dq ** 2)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    j_out = jatt.flash_attention(jq, jk, jv, **kw)
    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    j_second = jax.grad(jax_penalty, argnums=1)(jq, jk, jv)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = dict(tatt._kernels.launch_counts)
    t_out = tatt.flash_attention(tq, tk, tv, **kw)
    t_grads = torch.autograd.grad((t_out * torch.tensor(g)).sum(),
                                  (tq, tk, tv), create_graph=True)
    (t_second,) = torch.autograd.grad((t_grads[0] ** 2).sum(), tk)
    assert tatt._kernels.launch_counts == before

    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_second.numpy(), np.asarray(j_second),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------- metrics and losses
def test_perplexity_and_top5_match_jax_trainer():
    metrics = ("accuracy", "perplexity", "top_5_accuracy")
    _, jtr, _, tr = _trainers("sgd", 0.1, metrics=metrics, max_len=64)
    jh = jtr.fit(JaxLM(**LM), epochs=2, steps_per_epoch=2, verbose=0)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=2, steps_per_epoch=2,
                verbose=0)
    for key in ("loss", "perplexity"):
        np.testing.assert_allclose(th.history[key], jh.history[key],
                                   rtol=1e-5, err_msg=key)
    for key in ("accuracy", "top_5_accuracy"):
        np.testing.assert_array_equal(th.history[key], jh.history[key])
    # The epoch value is exp(mean of the per-batch log-space values).
    logs = [tr.train_step(SyntheticLanguageModeling(**LM).batch(i))
            for i in range(2)]
    ce = [float(d["perplexity"]) for d in logs]
    assert _mean_logs(logs)["perplexity"] == pytest.approx(
        float(np.exp(np.mean(ce))), rel=1e-12)


@pytest.mark.parametrize("loss", ["categorical_crossentropy", "mse"])
def test_one_hot_losses_match_jax_trainer(loss):
    data = SyntheticLanguageModeling(**LM)
    batches = []
    for i in range(2):
        batch = data.batch(i)
        onehot = np.eye(VOCAB, dtype=np.float32)[batch["targets"]]
        batches.append({"tokens": batch["tokens"], "targets": onehot})
    _, jtr, _, tr = _trainers("sgd", 0.5, metrics=(), loss=loss,
                              first=batches[0], max_len=64)
    jh = jtr.fit(batches, epochs=2, verbose=0)
    th = tr.fit(batches, epochs=2, verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-5)


# ---------------------------------------- options refused with the right error
def _jax_default(fn, name):
    return inspect.signature(fn).parameters[name].default


# (where, option, a value other than the JAX default)
SWEEP = [
    ("trainer", "donate_state", False),
    ("trainer", "eval_with_ema", False),
    ("trainer", "max_retries", 5),
    ("trainer", "retry_backoff_s", 0.5),
    ("trainer", "max_recoveries", 2),
    ("trainer", "retry_sleep", lambda s: None),
    ("fit", "prefetch", 4),
    ("engine", "param_transform", lambda p: p),
    ("engine", "max_retries", 5),
    ("engine", "retry_backoff_s", 0.5),
    ("engine", "backoff_sleep", lambda s: None),
    ("engine", "max_replays", 1),
    ("engine", "degraded_cooldown_s", 1.0),
    ("engine", "spec_draft_variables", {}),
    ("submit", "adapter", "tenant-a"),
    ("submit", "constraint", {"regex": "[0-9]+"}),
    ("model", "moe_top_k", 1),
    ("model", "moe_every", 2),
    ("model", "moe_capacity_factor", 1.25),
    ("model", "moe_eval_dropless", False),
    ("model", "mesh", "a one-process mesh"),
]
# Ported since the sweep was written: checked against the JAX engine.
TENANCY = {("submit", "adapter"), ("submit", "constraint")}
# Ported since too (int8 serving): each transforms or loads the weights
# passed with it, and raises the JAX engine's error without them.
WEIGHTS = {("engine", "param_transform"), ("engine", "spec_draft_variables")}
# Ported since too (fault recovery): each retry or replay knob is held to
# what it does under a seeded fault plan.
RESILIENCE = {("engine", "max_retries"), ("engine", "retry_backoff_s"),
              ("engine", "backoff_sleep"), ("engine", "max_replays"),
              ("engine", "degraded_cooldown_s")}
# Ported since too (the trainer's EMA, fault boundary and prefetch): each
# is held to what it does on the port's trainer.
TRAINER = {("trainer", "donate_state"), ("trainer", "eval_with_ema"),
           ("trainer", "max_retries"), ("trainer", "retry_backoff_s"),
           ("trainer", "max_recoveries"), ("trainer", "retry_sleep"),
           ("fit", "prefetch")}
# Ported since too (routed experts): each gives the JAX model's numbers.
MOE = {("model", "moe_top_k"), ("model", "moe_every"),
       ("model", "moe_capacity_factor"), ("model", "moe_eval_dropless")}
# Ported since too (sequence parallelism): a Llama over a mesh gives the
# JAX model's logits.
MESH = {("model", "mesh")}
JAX_FN = {"trainer": JaxTrainer.__init__, "fit": JaxTrainer.fit,
          "engine": JaxServeEngine.__init__, "submit": JaxServeEngine.submit,
          "model": JaxLlama}


def _call(where, **kw):
    if where == "model":
        return tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu", **kw)
    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    if where == "trainer":
        return Trainer(model, device="cpu", **KEYS, **kw)
    if where == "fit":
        return Trainer(model, device="cpu", **KEYS).fit(
            SyntheticLanguageModeling(**LM), steps_per_epoch=1, verbose=0,
            **kw)
    if where == "engine":
        return ServeEngine(model, device="cpu", max_slots=2, prefill_len=16,
                           **kw)
    eng = ServeEngine(model, device="cpu", max_slots=2, prefill_len=16)
    return eng.submit([1, 2, 3], 2, **kw)


@pytest.mark.parametrize("where,name,other", SWEEP,
                         ids=[f"{w}-{n}" for w, n, _ in SWEEP])
def test_unported_option_takes_the_jax_default_and_refuses_others(
        where, name, other):
    """An option not ported yet takes the JAX default and refuses any
    other value, naming its item. Tenancy is ported: ``submit``'s
    ``adapter``/``constraint`` on an engine without a ``TenantConfig``
    raise the JAX engine's ``ValueError``, in both packages."""
    default = _jax_default(JAX_FN[where], name)
    assert default is not inspect.Parameter.empty
    _call(where, **{name: default})
    if (where, name) in TENANCY:
        jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64)
        params = jm.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                         train=False)["params"]
        jeng = JaxServeEngine(jm, {"params": params}, max_slots=2,
                              prefill_len=16)
        errors = []
        for call in (lambda: jeng.submit([1, 2, 3], 2, **{name: other}),
                     lambda: _call(where, **{name: other})):
            with pytest.raises(ValueError,
                               match="need a tenant-enabled engine") as info:
                call()
            errors.append(str(info.value))
        assert errors[0] == errors[1]
        return
    if (where, name) in WEIGHTS:
        _check_ported_weights(name, other)
        return
    if (where, name) in RESILIENCE:
        _check_ported_resilience(name, other)
        return
    if (where, name) in TRAINER:
        _check_ported_trainer(name, other)
        return
    if (where, name) in MOE:
        _check_ported_moe(name, other)
        return
    if (where, name) in MESH:
        _check_ported_mesh()
        return
    with pytest.raises(NotImplementedError, match=ROADMAP_ITEM):
        _call(where, **{name: other})


def _check_ported_mesh():
    """A ring Llama over a one-process mesh gives the JAX ring Llama's
    logits over one device (tests/test_torch_sequence_parallel.py runs
    the seq axis over processes)."""
    from pddl_tpu.core.mesh import MeshConfig, build_mesh
    from pddl_tpu_torch.core.mesh import build_mesh as port_mesh

    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 12)).astype(
        np.int32)
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention="ring",
                        mesh=build_mesh(MeshConfig(data=1),
                                        devices=jax.devices()[:1]))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(tokens), train=False)["params"])
    tm = _call("model", attention="ring", mesh=port_mesh(device="cpu"))
    tm.load_state_dict(llama_params_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        {"params": params}, jnp.asarray(tokens), train=False)), rtol=0,
        atol=1e-5)


def _lm_fit(epochs=2, fit_kw=None, **kw):
    """A tiny Llama trained by sgd for ``epochs`` x 2 steps; the trainer and
    its loss history."""
    tr = Trainer(tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu"),
                 device="cpu", optimizer="sgd", learning_rate=0.1, **KEYS,
                 **kw)
    hist = tr.fit(SyntheticLanguageModeling(**LM), epochs=epochs,
                  steps_per_epoch=2, verbose=0, **(fit_kw or {}))
    return tr, hist.history["loss"]


def _check_ported_trainer(name, other):
    """On the port's trainer: ``donate_state`` and ``prefetch`` change no
    number; ``eval_with_ema=False`` evaluates the live weights, not the
    shadows; under a fault plan ``max_retries`` is the in-place retries
    before the state is lost, ``retry_backoff_s`` the base of the doubling
    waits, ``retry_sleep`` what waits them, and ``max_recoveries`` the
    restore-and-replay attempts before the step gives up."""
    from pddl_tpu_torch.ckpt import CheckpointEveryN
    from pddl_tpu_torch.train.callbacks import LambdaCallback
    from pddl_tpu_torch.train.faults import (FaultKind, FaultSpec,
                                             TrainFaultPlan,
                                             TrainStateLost)

    if name in ("donate_state", "prefetch"):
        kw = {name: other} if name == "donate_state" else {}
        fit_kw = {name: other} if name == "prefetch" else {"prefetch": 0}
        a, la = _lm_fit()
        b, lb = _lm_fit(fit_kw=fit_kw, **kw)
        assert la == lb
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(p, q)
        return
    if name == "eval_with_ema":
        val = SyntheticLanguageModeling(**{**LM, "seed": 9})
        shadowed, _ = _lm_fit(ema_decay=0.5)
        live, _ = _lm_fit(ema_decay=0.5, eval_with_ema=other)
        plain, _ = _lm_fit()
        assert live.evaluate(val, steps=1) == plain.evaluate(val, steps=1)
        assert shadowed.evaluate(val, steps=1) != plain.evaluate(val,
                                                                steps=1)
        return
    slept = []
    if name == "max_recoveries":
        def fail_from_now(step, logs):
            if step == 2:
                plan._rates = (1.0, 0.0, 0.0)  # every later check fails

        plan = TrainFaultPlan()
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(RuntimeError, match=r"budget exhausted \(2"):
                _lm_fit(fault_plan=plan, max_retries=0, max_recoveries=other,
                        retry_sleep=slept.append,
                        fit_kw={"callbacks": [
                            CheckpointEveryN(d, every_n_steps=2,
                                             async_save=False),
                            LambdaCallback(on_train_batch_end=fail_from_now)]})
        return
    kw = {"retry_sleep": slept.append}
    count = 2
    if name == "retry_sleep":
        kw["retry_sleep"] = lambda s: (slept.append(s), other(s))
    else:
        kw[name] = other
    if name == "max_retries":
        count = other
    plan = TrainFaultPlan(scheduled=[FaultSpec(1, "train_step",
                                               FaultKind.TRANSIENT, count)])
    tr, losses = _lm_fit(fault_plan=plan, **kw)
    _, clean = _lm_fit()
    assert losses == clean and tr.fault_stats["retries"] == count
    backoff = kw.get("retry_backoff_s", 0.02)
    assert slept == [backoff * 2 ** i for i in range(count)]
    if name == "max_retries":  # one more is past the budget
        plan = TrainFaultPlan(scheduled=[FaultSpec(
            1, "train_step", FaultKind.TRANSIENT, count + 1)])
        with pytest.raises(TrainStateLost):
            _lm_fit(fault_plan=plan, **kw)


def _check_ported_moe(name, other):
    """A routed tiny Llama (4 experts) with the option at ``other``: the
    JAX model's training logits and drop rate through the bridge."""
    from pddl_tpu_torch.ops.moe import sown

    kw = dict(vocab_size=VOCAB, max_len=64, moe_experts=4, **{name: other})
    tokens = np.random.default_rng(4).integers(0, VOCAB, (2, 24)).astype(
        np.int32)
    jm = jax_tiny_llama(**kw)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(
        k, jnp.asarray(tokens), train=False))(jax.random.key(0))["params"])
    tm = tiny_llama(device="cpu", **kw)
    tm.load_state_dict(llama_params_from_jax(params))
    want, coll = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(tokens), train=True,
        mutable=["losses", "metrics"]))(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        [float(v) for v in sown(tm)["metrics"]["moe_drop_rate"]],
        [float(v) for v in jax.tree.leaves(coll["metrics"])], atol=1e-6)


def _check_ported_resilience(name, other):
    """Under a fault plan, on the port's engine: ``max_retries`` is the
    in-place retries before a replay, ``retry_backoff_s`` the base of the
    doubling waits, ``backoff_sleep`` what waits them, ``max_replays``
    the rebuilds before a request fails, ``degraded_cooldown_s`` how long
    an OOM keeps the engine degraded. Every surviving stream equals the
    fault-free one."""
    from pddl_tpu_torch.serve.faults import FaultKind, FaultPlan, FaultSpec
    from pddl_tpu_torch.serve.request import RequestState

    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    plain = ServeEngine(model, device="cpu", max_slots=2, prefill_len=16)
    want = plain.submit(prompt, 6)
    plain.run(max_steps=50)
    slept = []
    kw = dict(device="cpu", max_slots=2, prefill_len=16,
              backoff_sleep=slept.append)
    clock = [0.0]
    if name == "backoff_sleep":
        kw["backoff_sleep"] = lambda s: (slept.append(s), other(s))
    elif name == "degraded_cooldown_s":
        kw["clock"] = lambda: clock[0]
    if name != "backoff_sleep":
        kw[name] = other
    if name == "max_replays":
        plan = FaultPlan(sites=("tick",), transient_rate=1.0)
        eng = ServeEngine(model, fault_plan=plan, max_retries=0, **kw)
        h = eng.submit(prompt, 6)
        eng.run(max_steps=50)
        assert h.state is RequestState.FAILED
        assert h.replays == other + 1
        return
    kind, count = ((FaultKind.OOM, 1) if name == "degraded_cooldown_s"
                   else (FaultKind.TRANSIENT, 5 if name == "max_retries"
                         else 2))
    eng = ServeEngine(model, fault_plan=FaultPlan(scheduled=[
        FaultSpec(1, "tick", kind, count)]), **kw)
    h = eng.submit(prompt, 6)
    eng.step()
    eng.step()
    if name == "degraded_cooldown_s":
        assert eng.degraded and eng.metrics.replays == 1
        clock[0] = 0.5 * other
        eng.step()
        assert eng.degraded
        clock[0] = 1.5 * other
        eng.step()
        assert not eng.degraded
        assert eng.metrics.degraded_time_s == 1.5 * other
    eng.run(max_steps=50)
    assert h.tokens == want.tokens
    if name == "max_retries":
        assert eng.metrics.retries == other and eng.metrics.replays == 0
    elif name == "retry_backoff_s":
        assert slept == [other, 2 * other]
    elif name == "backoff_sleep":
        assert slept == [0.02, 0.04] and eng.metrics.replays == 0


def _check_ported_weights(name, other):
    """``param_transform`` applies to the ``variables`` passed with it (an
    identity over the model's own weights serves as the plain engine
    does) and alone raises; ``spec_draft_variables`` without a draft model
    raises the JAX engine's ``ValueError`` in both packages."""
    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    kw = dict(device="cpu", max_slots=2, prefill_len=16)
    if name == "param_transform":
        with pytest.raises(ValueError, match="param_transform transforms"):
            _call("engine", param_transform=other)
        streams = []
        for extra in ({}, dict(param_transform=other)):
            eng = ServeEngine(model, {"params": model.state_dict()}, **kw,
                              **extra)
            handle = eng.submit([1, 2, 3], 4)
            eng.run(max_steps=20)
            streams.append(handle.tokens)
        assert streams[0] == streams[1]
        return
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64)
    params = jm.init(jax.random.key(0), jnp.ones((1, 4), jnp.int32),
                     train=False)["params"]
    errors = []
    for call in (lambda: JaxServeEngine(jm, {"params": params}, max_slots=2,
                                        prefill_len=16,
                                        spec_draft_variables=other),
                 lambda: _call("engine", spec_draft_variables=other)):
        with pytest.raises(ValueError,
                           match="without spec_draft_model") as info:
            call()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_jax_defaults_of_the_sweep():
    """The defaults the sweep accepts are the JAX package's own."""
    assert _jax_default(JaxTrainer.__init__, "retry_sleep") is time.sleep
    assert _jax_default(JaxServeEngine.__init__, "backoff_sleep") \
        is time.sleep
    assert _jax_default(JaxTrainer.fit, "prefetch") == 2


def test_paged_decode_ignores_blocks_per_chunk():
    gen = torch.Generator().manual_seed(0)
    kp, vp = (torch.randn(13, 2, 4, 8, generator=gen) for _ in range(2))
    table = (torch.randperm(12, generator=gen) + 1).view(2, 6).int()
    q = torch.randn(2, 4, 1, 8, generator=gen)
    index = torch.tensor([17, 3], dtype=torch.int32)
    want = tatt.paged_decode_attention(q, kp, vp, table, index)
    for chunk in (None, 1, 4):
        got = tatt.paged_decode_attention(q, kp, vp, table, index,
                                          blocks_per_chunk=chunk)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert "blocks_per_chunk" in inspect.signature(
        jatt.paged_decode_attention).parameters


def test_engine_takes_the_jax_second_positional_variables_at_none():
    """``None`` serves the model's own weights. A tree, once refused
    (queue 1 item 8), now loads for the engine: its own ``state_dict``
    serves the same tokens, another model's weights that model's stream
    while the given model keeps its own, and a tree that is not the
    model's raises."""
    params = list(inspect.signature(JaxServeEngine.__init__).parameters)
    assert params[:3] == ["self", "model", "variables"]
    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    kw = dict(device="cpu", max_slots=2, prefill_len=16)
    streams = []
    for variables in (None, {"params": model.state_dict()}):
        eng = ServeEngine(model, variables, **kw)
        handle = eng.submit([1, 2, 3], 6)
        eng.run(max_steps=20)
        streams.append(handle.tokens)
    assert streams[0] == streams[1]
    other = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu", seed=4)
    own = model.head.lm_head.weight.clone()
    want = []
    for eng in (ServeEngine(model, {"params": other.state_dict()}, **kw),
                ServeEngine(other, **kw)):
        handle = eng.submit([1, 2, 3], 6)
        eng.run(max_steps=20)
        want.append(handle.tokens)
    assert want[0] == want[1]
    torch.testing.assert_close(model.head.lm_head.weight, own, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="do not match"):
        ServeEngine(model, {"params": {}}, **kw)


def _qkv(seed, h=4, hkv=2, s=12, d=8, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(2, h, s, d, generator=gen).to(dtype),
            torch.randn(2, hkv, s, d, generator=gen).to(dtype),
            torch.randn(2, hkv, s, d, generator=gen).to(dtype))


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_lse",
                                  "paged_decode_attention",
                                  "paged_decode_attention_kernel"])
def test_interpret_is_accepted_and_ignored(name):
    assert "interpret" in inspect.signature(getattr(jatt, name)).parameters
    fn = getattr(tatt, name)
    if name.startswith("flash"):
        q, k, v = _qkv(0)
        args, kw = (q, k, v), dict(causal=True)
    else:
        gen = torch.Generator().manual_seed(1)
        kp, vp = (torch.randn(13, 2, 4, 8, generator=gen) for _ in range(2))
        table = (torch.randperm(12, generator=gen) + 1).view(2, 6).int()
        q = torch.randn(2, 4, 1, 8, generator=gen)
        args = (q, kp, vp, table, torch.tensor([17, 3], dtype=torch.int32))
        kw = {}
    want = fn(*args, **kw)
    for interpret in (None, True, False):
        got = fn(*args, interpret=interpret, **kw)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("k_offset,window", [(0, None), (4, None), (-3, None),
                                             (5, 6), (-2, 3)])
def test_attention_reference_k_offset_matches_jax(k_offset, window):
    q, k, v = _qkv(2)
    want = jatt.attention_reference(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, k_offset=k_offset,
        window=window)
    got = tatt.attention_reference(q, k, v, causal=True, k_offset=k_offset,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ------------------------------------- bf16 storage: the rule runs in f32
def test_bf16_adam_keeps_f32_moments_like_jax():
    """A 64x64 bf16 weight, 5 gradients x 1e-2 (both from
    ``default_rng(0)``), ``adam`` at 1e-3 in both packages. The JAX
    ``make_optimizer`` pins the moments to f32 and rounds the f32 sum into
    the bf16 parameter once; the port, which handed bf16 parameters
    straight to ``torch.optim.Adam`` (bf16 moments and arithmetic, 29 of
    the 4,096 parameters apart after 5 steps), now runs the rule on an f32
    proxy. The moments are f32 and the parameters equal JAX's but for at
    most 1 bf16 ulp in at most 16 elements: JAX squares the bf16 gradient
    in bf16 (optax's ``g ** 2`` on a bf16 leaf) where the port squares its
    f32 proxy's, and torch's Adam divides by ``sqrt(v)/sqrt(1-b2^t) + eps``
    where optax takes ``sqrt(v/(1-b2^t)) + eps``; both move the f32 update
    in its last bits, which flips the rounding of a sum that sits at a
    bf16 tie."""
    from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
    from pddl_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    grads = [rng.standard_normal((64, 64)).astype(np.float32) * 1e-2
             for _ in range(5)]
    tree = {"w": jnp.asarray(w, jnp.bfloat16)}
    tx = jax_make_optimizer("adam", 1e-3)
    st = tx.init(tree)
    p = torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16))
    opt = make_optimizer([p], "adam", 1e-3)
    for g in grads:
        u, st = tx.update({"w": jnp.asarray(g, jnp.bfloat16)}, st, tree)
        tree = jax.tree.map(lambda a, b: (a + b).astype(a.dtype), tree, u)
        p.grad = torch.tensor(g).to(torch.bfloat16)
        opt.step()
    assert {t.dtype for t in opt.state[p].values()} == {torch.float32}
    assert p.dtype == torch.bfloat16
    want = np.asarray(tree["w"], np.float32)
    got = p.detach().float().numpy()
    ulp = np.spacing(np.abs(want)) * 2 ** 16
    assert np.all(np.abs(got - want) <= ulp)
    assert np.count_nonzero(got != want) <= 16


# ------------------------------------------ the queue-3 faults, repaired
@pytest.mark.parametrize("sub", ["train", "models", "ops", "data"])
def test_subpackages_export_the_jax_names(sub):
    """Queue 3 fault 1: `from pddl_tpu_torch.train import Trainer` (and
    every other JAX name whose module is ported) imports, and is the
    module's own object; `tests/test_torch_import_gate.py` pins the names
    against the JAX `__all__`."""
    import importlib

    jax_pkg = importlib.import_module(f"pddl_tpu.{sub}")
    port = importlib.import_module(f"pddl_tpu_torch.{sub}")
    assert set(port.__all__) <= set(jax_pkg.__all__)
    for name in port.__all__:
        value = getattr(port, name)
        module = port._EXPORTS[name]
        owner = importlib.import_module(f"pddl_tpu_torch.{sub}.{module}")
        assert value is (owner if module == name else getattr(owner, name))
    for name in sorted(set(jax_pkg.__all__) - set(port.__all__)):
        with pytest.raises(AttributeError):
            getattr(port, name)


def test_queue3_imports_and_fcfs():
    from pddl_tpu.serve import FCFSScheduler as JaxFCFS
    from pddl_tpu.serve import SLOScheduler as JaxSLO
    from pddl_tpu_torch.models import ResNet50
    from pddl_tpu_torch.models.resnet import ResNet50 as resnet50
    from pddl_tpu_torch.serve import FCFSScheduler, SLOScheduler
    from pddl_tpu_torch.train import Trainer as trainer

    assert trainer is Trainer and ResNet50 is resnet50
    assert JaxFCFS is JaxSLO and FCFSScheduler is SLOScheduler
    import pddl_tpu_torch.serve as serve

    assert "FCFSScheduler" in serve.__all__


def _preset_fields(jax_preset, port_preset, **kw):
    """The JAX preset's dataclass fields (with ``kw``) against the port
    preset's arguments, field for field where the port has the field."""
    import dataclasses

    assert jax_preset.keywords == port_preset.keywords
    jm = jax_preset(**kw)
    params = inspect.signature(port_preset.func).parameters
    shared = [f.name for f in dataclasses.fields(jm) if f.name in params
              and f.name not in ("dtype", "param_dtype", "mesh", "parent",
                                 "name")]
    assert set(port_preset.keywords) <= set(shared)
    for name in shared:
        value = {**port_preset.keywords, **kw}.get(name,
                                                   params[name].default)
        assert value == getattr(jm, name), name


def test_vit_l16_is_the_jax_preset():
    """Queue 3 fault 2: `ViT_L16` at its full width, depth 2: bridged
    weights give the JAX logits within 1e-5 (f32, as
    `tests/test_torch_vit.py` holds the ViT)."""
    from pddl_tpu.models import vit as jvit
    from pddl_tpu_torch.bridge import vit_params_from_jax
    from pddl_tpu_torch.models import ViT_L16
    from pddl_tpu_torch.models import vit as tvit

    assert ViT_L16 is tvit.ViT_L16
    _preset_fields(jvit.ViT_L16, tvit.ViT_L16)
    kw = dict(num_classes=10, depth=2, attention="reference")
    jm = jvit.ViT_L16(**kw)
    img = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(img), train=False)["params"])
    tm = tvit.ViT_L16(image_size=32, device="cpu", **kw)
    assert (tm.embed_dim, tm.depth, tm.num_heads, tm.patch_size) == (
        1024, 2, 16, 16)
    tm.load_state_dict(vit_params_from_jax(params))
    ref = jm.apply({"params": params}, jnp.asarray(img), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(img), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_llama_300m_is_the_jax_preset():
    """Queue 3 fault 2: `Llama_300M` at its full width (1280, GQA 20/4,
    MLP 3456), depth 2: bridged weights give the JAX logits within 1e-5
    (f32, as `tests/test_torch_llama.py` holds the Llama)."""
    from pddl_tpu.models import llama as jllama
    from pddl_tpu_torch.models import llama as tllama

    _preset_fields(jllama.Llama_300M, tllama.Llama_300M, vocab_size=VOCAB)
    kw = dict(vocab_size=VOCAB, max_len=64, depth=2, attention="reference")
    jm = jllama.Llama_300M(**kw)
    tokens = np.random.RandomState(0).randint(0, VOCAB, (2, 16))
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(tokens), train=False)["params"])
    tm = tllama.Llama_300M(device="cpu", **kw)
    assert (tm.embed_dim, tm.num_heads, tm.num_kv_heads) == (1280, 20, 4)
    tm.load_state_dict(llama_params_from_jax(params))
    ref = jm.apply({"params": params}, jnp.asarray(tokens), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_checkpointer_takes_the_jax_call_form(tmp_path):
    """Queue 3 fault 3: the JAX `save(state, epoch, metrics, force=True)`
    writes; a JAX-form `restore(target)` raises a `TypeError` naming the
    port's form (it used to read the target as a step)."""
    from pddl_tpu.ckpt.checkpoint import Checkpointer as JaxCheckpointer
    from pddl_tpu_torch.ckpt import Checkpointer

    jax_params = inspect.signature(JaxCheckpointer.save).parameters
    port_params = inspect.signature(Checkpointer.save).parameters
    assert [(p.name, p.default) for p in port_params.values()] == [
        (p.name, p.default) for p in jax_params.values()]
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    state = {"step": 3, "model": {"w": torch.ones(2)}}
    assert ckpt.save(state, epoch=0, metrics=None, force=True) == 3
    assert ckpt.save({**state, "step": 4}, 1, {"loss": 0.5}, True) == 4
    restored, meta = ckpt.restore(step=3)
    assert torch.equal(restored["model"]["w"], torch.ones(2))
    assert meta["epoch"] == 0 and ckpt.all_steps() == [3, 4]
    with pytest.raises(TypeError, match=r"restore\(step=None, verify=True\)"):
        ckpt.restore(state)
