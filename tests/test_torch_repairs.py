"""Options of the JAX package that the port now takes, or refuses with the
right error, held against the JAX package on the CPU.

- A sliding-window Llama whose decode would need a rolling ring cache
  builds and trains: 3 steps of the port's `Trainer` against the JAX
  `Trainer` from the same bridged weights, losses within the tolerances
  of `tests/test_torch_train.py` (sgd rtol 1e-5, adamw rtol 1e-4). The
  serving engine and the decode cache refuse it with
  `NotImplementedError`, as the JAX engine does.
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
  ROADMAP.md item for any other value (the `Llama`'s `moe_*` options and
  `mesh`, and `ServeEngine`'s second positional `variables`, among them);
  `paged_decode_attention` accepts and ignores `blocks_per_chunk`, and
  the four attention entry points the Pallas `interpret` switch.
- `attention_reference(k_offset=)` gives the JAX twin's output within
  1e-5 (f32), with GQA and with a window.
"""

import inspect
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.attention as jatt
from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.llama import Llama as JaxLlama
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.serve.engine import ServeEngine as JaxServeEngine
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import llama_params_from_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
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
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        ServeEngine(model, device="cpu", max_slots=2, prefill_len=16)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        paged_decode_cache(model, num_blocks=4, block_size=8)
    with pytest.raises(NotImplementedError, match="ring cache"):
        JaxServeEngine(jax_tiny_llama(vocab_size=VOCAB, max_len=512,
                                      sliding_window=8), {})
    # A window whose ring would be no smaller than max_len needs no ring.
    wide = tiny_llama(vocab_size=VOCAB, max_len=128, sliding_window=100,
                      device="cpu")
    assert not wide.uses_ring_cache
    ServeEngine(wide, device="cpu", max_slots=2, prefill_len=16)


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
    ("engine", "spec_ngram", 2),
    ("engine", "spec_draft_model", object()),
    ("engine", "spec_draft_variables", {}),
    ("submit", "adapter", "tenant-a"),
    ("submit", "constraint", {"regex": "[0-9]+"}),
    ("model", "moe_top_k", 1),
    ("model", "moe_every", 2),
    ("model", "moe_capacity_factor", 1.25),
    ("model", "moe_eval_dropless", False),
    ("model", "mesh", object()),
]
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
    default = _jax_default(JAX_FN[where], name)
    assert default is not inspect.Parameter.empty
    _call(where, **{name: default})
    with pytest.raises(NotImplementedError, match=ROADMAP_ITEM):
        _call(where, **{name: other})


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
    params = list(inspect.signature(JaxServeEngine.__init__).parameters)
    assert params[:3] == ["self", "model", "variables"]
    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    eng = ServeEngine(model, None, device="cpu", max_slots=2,
                      prefill_len=16)
    assert eng.submit([1, 2, 3], 2) is not None
    with pytest.raises(NotImplementedError, match=r"queue 1 item 8"):
        ServeEngine(model, {"params": {}}, device="cpu", max_slots=2,
                    prefill_len=16)


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
