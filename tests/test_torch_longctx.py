"""The port's long-context training path against the JAX package on the
CPU: block rematerialization (`models/vit.py`'s `remat_block`, the
Llama's `remat`), the chunked large-vocab cross-entropy
(`ops/large_vocab.py`), the fused LM loss (`models/gpt.py`) and the
two-sweep flash backward's dispatch.

Inputs are drawn with numpy from a seed and handed to both packages. The
JAX flash attention runs its Pallas kernels in interpret mode (32-token
sequences tile into 32-row blocks); the port runs its kernels' plain
versions, the only thing it runs on CPU tensors. Tolerances, f32 unless
stated:

- remat: logits and gradients within 1e-6 of the port's `remat="none"`
  (the same arithmetic, replayed), and within 1e-5 of JAX's, the
  tolerance `tests/test_torch_train.py` holds the flash Llama to;
- `chunked_cross_entropy`: the loss within 1e-6 and the gradients within
  1e-5 of JAX's; with bf16 features and kernel, the loss within 1e-5 and
  each gradient within 1e-2 of its max-abs — both sides take exact bf16
  products summed in f32 in another order, then round the gradients to
  bf16 (an ulp is 2^-8 to 2^-7 of the value);
- the trainers: the tolerances of `test_trainer_matches_jax_trainer`.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pddl_tpu.ops.attention as jatt
from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.gpt import fused_lm_loss as jax_fused_lm_loss
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.ops.large_vocab import chunked_cross_entropy as jax_chunked_ce
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import llama_params_from_jax, llama_params_to_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.gpt import fused_lm_loss
from pddl_tpu_torch.models.llama import LlamaBlock, tiny_llama
from pddl_tpu_torch.models.vit import REMAT_POLICIES, remat_block
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.ops.large_vocab import chunked_cross_entropy
from pddl_tpu_torch.train.loop import Trainer

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VOCAB, SEQ = 64, 32
LM = dict(batch_size=4, seq_len=SEQ, vocab_size=VOCAB, seed=3)


def _jax_params(jm):
    return jax.tree.map(np.asarray, jm.init(
        jax.random.key(1), jnp.ones((1, 8), jnp.int32), train=False)["params"])


def _port(params, **kw):
    tm = tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                    device="cpu", **kw)
    tm.load_state_dict(llama_params_from_jax(params))
    return tm


def _batch(seed, b=2, s=SEQ):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (b, s)).astype(np.int32),
            rng.randint(0, VOCAB, (b, s)).astype(np.int32))


def _jax_ce(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, targets[..., None], axis=-1).mean()


def _port_loss_and_grads(tm, tokens, targets, loss_fn=None):
    """The port's loss, logits (or None) and per-parameter gradients in
    the JAX package's tree layout."""
    tm.zero_grad(set_to_none=True)
    tok, tgt = torch.tensor(tokens), torch.tensor(targets)
    if loss_fn is None:
        logits = tm(tok)
        loss = F.cross_entropy(logits.reshape(-1, VOCAB),
                               tgt.reshape(-1).long())
    else:
        logits, loss = None, loss_fn(tm, tok, tgt)
    loss.backward()
    grads = copy.deepcopy(tm)
    grads.load_state_dict({n: p.grad for n, p in tm.named_parameters()})
    return (loss.item(), None if logits is None else logits.detach().numpy(),
            llama_params_to_jax(grads))


def _tree_close(got, want, atol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=atol), got, want)


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matmuls that actually run (a cached selective-checkpoint
    output never reaches this mode)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_matches_no_remat_and_jax(remat, monkeypatch):
    """Each policy gives the unwrapped model's logits and gradients, and
    JAX's `tiny_llama(remat=...)`'s. Under `dots` and `full` the flash
    forward runs again in the backward (it is no matmul, as under JAX's
    `checkpoint_dots`); `dots` recomputes no matmul, `full` every one of
    the blocks' seven projections."""
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                        remat=remat)
    params = _jax_params(jm)
    tokens, targets = _batch(0)

    def jax_loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens))
        return _jax_ce(logits, jnp.asarray(targets)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        params)
    ref = _port_loss_and_grads(_port(params), tokens, targets)

    tm = _port(params, remat=remat)
    assert tm.remat == remat
    assert all(type(b).__name__ == ("LlamaBlock" if remat == "none"
                                    else "RematLlamaBlock")
               for b in tm.blocks)
    calls = []
    forward = tatt.flash_forward
    monkeypatch.setattr(tatt, "flash_forward",
                        lambda *a, **k: calls.append(1) or forward(*a, **k))
    tm.zero_grad(set_to_none=True)
    logits = tm(torch.tensor(tokens))
    loss = F.cross_entropy(logits.reshape(-1, VOCAB),
                           torch.tensor(targets).reshape(-1).long())
    forward_calls = len(calls)
    with _CountMM() as counter:
        loss.backward()
    assert forward_calls == tm.depth
    assert len(calls) == tm.depth * (1 if remat == "none" else 2)
    plain = _port(params)
    plain_loss = F.cross_entropy(plain(torch.tensor(tokens)).reshape(
        -1, VOCAB), torch.tensor(targets).reshape(-1).long())
    with _CountMM() as plain_counter:
        plain_loss.backward()
    recomputed = counter.mm - plain_counter.mm
    if remat == "full":
        assert recomputed >= 7 * tm.depth, recomputed
    else:
        assert recomputed == 0, recomputed

    grads = copy.deepcopy(tm)
    grads.load_state_dict({n: p.grad for n, p in tm.named_parameters()})
    got = (loss.item(), logits.detach().numpy(), llama_params_to_jax(grads))
    assert got[0] == pytest.approx(ref[0], rel=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    _tree_close(got[2], ref[2], 1e-6)
    assert got[0] == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    _tree_close(got[2], jax.tree.map(np.asarray, jgrads), 1e-5)


def test_remat_only_under_a_gradient_and_without_a_cache():
    """No gradient, or keyword arguments (the decode path's cache), run
    the block as it is; an unknown policy raises, listing the known."""
    calls = []

    class Block(torch.nn.Module):
        def forward(self, x, **kw):
            calls.append(kw)
            return x * x

    wrapped = remat_block(Block, "full")()
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        wrapped(x)
    wrapped(x, cache="c")
    assert calls == [{}, {"cache": "c"}]
    wrapped(x).sum().backward()
    assert len(calls) == 4  # forward, then its recompute in the backward
    assert remat_block(Block, "none") is Block
    assert sorted(REMAT_POLICIES) == ["dots", "full", "none"]
    with pytest.raises(ValueError, match=r"known: \['dots', 'full', 'none'\]"):
        remat_block(LlamaBlock, "everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        tiny_llama(vocab_size=VOCAB, device="cpu", remat="dot")


def test_bridged_remat_model_loads():
    """Remat adds no parameter: a JAX tree bridges into a `remat` model
    under the same names, and both give the same logits."""
    params = _jax_params(jax_tiny_llama(vocab_size=VOCAB, max_len=64,
                                        attention="flash"))
    plain, dots = _port(params), _port(params, remat="dots")
    assert plain.state_dict().keys() == dots.state_dict().keys()
    tokens = torch.tensor(_batch(1)[0])
    with torch.no_grad():
        torch.testing.assert_close(dots(tokens), plain(tokens), rtol=0,
                                   atol=0)


def test_training_length_may_exceed_max_len():
    """RoPE in training takes positions `arange(S)` with no table, so both
    packages train at S above `max_len` (Llama-1B: 8192 over 4096)."""
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=16, attention="flash")
    params = _jax_params(jm)
    tm = tiny_llama(vocab_size=VOCAB, max_len=16, attention="flash",
                    device="cpu")
    tm.load_state_dict(llama_params_from_jax(params))
    tokens = _batch(2, b=1, s=32)[0]
    ref = jm.apply({"params": params}, jnp.asarray(tokens), train=True)
    with torch.no_grad():
        got = tm(torch.tensor(tokens))
    assert got.shape == (1, 32, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# name -> (vocab, chunk, bias, leading dims, dtype)
CE_CASES = {
    "chunk_divides": (64, 16, False, (12,), np.float32),
    "ragged_vocab": (50, 16, False, (12,), np.float32),
    "bias": (50, 16, True, (12,), np.float32),
    "batched": (50, 16, True, (2, 3, 4), np.float32),
    "one_chunk": (50, 8192, True, (12,), np.float32),
    "bf16": (50, 16, True, (2, 6), "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_chunked_cross_entropy_matches_jax(case):
    v, chunk, with_bias, lead, dtype = CE_CASES[case]
    e = 24
    rng = np.random.RandomState(7)
    feats = rng.randn(*lead, e).astype(np.float32)
    kernel = (rng.randn(e, v) / np.sqrt(e)).astype(np.float32)
    bias = rng.randn(v).astype(np.float32) if with_bias else None
    labels = rng.randint(0, v, lead).astype(np.int32)
    bf16 = dtype == "bfloat16"
    jcast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if bf16 else jnp.asarray

    def jloss(f, k, b):
        return jax_chunked_ce(f, k, jnp.asarray(labels), b, chunk_size=chunk)

    jargs = (jcast(feats), jcast(kernel),
             None if bias is None else jnp.asarray(bias))
    argnums = (0, 1, 2) if with_bias else (0, 1)
    want, jgrads = jax.value_and_grad(jloss, argnums=argnums)(*jargs)

    tdt = torch.bfloat16 if bf16 else torch.float32
    leaves = [torch.tensor(feats).to(tdt).requires_grad_(),
              torch.tensor(kernel).to(tdt).requires_grad_()]
    if with_bias:
        leaves.append(torch.tensor(bias).requires_grad_())
    got = chunked_cross_entropy(leaves[0], leaves[1], torch.tensor(labels),
                                leaves[2] if with_bias else None,
                                chunk_size=chunk)
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    assert got.item() == pytest.approx(float(want), rel=1e-5 if bf16 else 1e-6)
    for leaf, g in zip(leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype
        assert leaf.grad.shape == leaf.shape
        gw = np.asarray(jnp.asarray(g, jnp.float32))
        atol = 1e-2 * float(np.abs(gw).max()) if bf16 else 1e-5
        np.testing.assert_allclose(leaf.grad.float().numpy(), gw, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("chunk_size", [None, 24])
def test_fused_lm_loss_matches_jax_and_the_materialized_loss(chunk_size):
    """On a bridged tiny Llama: the loss and every gradient as JAX's
    `fused_lm_loss` gives them, and as the port's loss over materialized
    logits; a chunk of 24 pads the 64-way head to 72 columns."""
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash")
    params = _jax_params(jm)
    tokens, targets = _batch(3)

    def jloss(p):
        return jax_fused_lm_loss(jm, {"params": p}, jnp.asarray(tokens),
                                 jnp.asarray(targets), chunk_size=chunk_size)

    want, jgrads = jax.value_and_grad(jloss)(params)
    tm = _port(params)
    fused = _port_loss_and_grads(
        tm, tokens, targets,
        lambda m, x, y: fused_lm_loss(m, x, y, chunk_size=chunk_size))
    ref = _port_loss_and_grads(tm, tokens, targets)
    assert fused[0] == pytest.approx(float(want), rel=1e-6)
    _tree_close(fused[2], jax.tree.map(np.asarray, jgrads), 1e-5)
    assert fused[0] == pytest.approx(ref[0], rel=1e-6)
    _tree_close(fused[2], ref[2], 1e-6)


@pytest.mark.parametrize("optimizer,lr,loss_rtol,param_atol", [
    ("sgd", 0.1, 1e-5, 1e-5),
    ("adamw", 1e-3, 1e-4, 2 * 1e-3 * 3),
])
def test_two_sweep_remat_trainer_matches_jax_trainer(
        optimizer, lr, loss_rtol, param_atol, monkeypatch):
    """The slice as a whole: `remat="dots"` with the backward's dispatch
    threshold at 0 in both packages, so JAX runs its two-sweep Pallas
    kernels (K3a/K3b, interpreted) and the port the plain version of
    K3a/K3b, step by step for 3 steps from the same weights."""
    monkeypatch.setattr(jatt, "_FUSED_BWD_DQ_BYTES", 0)
    monkeypatch.setattr(tatt, "_FUSED_BWD_DQ_BYTES", 0)
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                        remat="dots")
    jtr = JaxTrainer(jm, optimizer=optimizer, learning_rate=lr, seed=0,
                     input_key="tokens", target_key="targets")
    jtr.init_state(JaxLM(**LM).batch(0))
    tm = _port(jax.tree.map(np.asarray, jtr.state.params), remat="dots")
    tr = Trainer(tm, optimizer=optimizer, learning_rate=lr, seed=0,
                 input_key="tokens", target_key="targets", device="cpu")
    jh = jtr.fit(JaxLM(**LM), epochs=3, steps_per_epoch=1, verbose=0)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=3, steps_per_epoch=1,
                verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=loss_rtol)
    np.testing.assert_allclose(th.history["accuracy"],
                               jh.history["accuracy"], atol=1e-6)
    _tree_close(llama_params_to_jax(tm),
                jax.tree.map(np.asarray, jtr.state.params), param_atol)


@pytest.mark.parametrize("window,k_offset,with_dlse", [
    (None, 0, False), (40, 0, True), (48, -32, True)])
def test_two_sweep_wrappers_match_jax_kernels(window, k_offset, with_dlse,
                                              monkeypatch):
    """K3a's and K3b's wrappers on CPU tensors (their plain version)
    against the JAX package's two-sweep Pallas kernels in interpret mode
    (threshold 0, 32-row blocks), at GQA rep 2 with a window, offset keys
    and an LSE cotangent; within the 3e-4 `tests/test_torch_flash.py`
    holds gradients to. `flash_backward` on CPU tensors gives the same."""
    monkeypatch.setattr(jatt, "_FUSED_BWD_DQ_BYTES", 0)
    rng = np.random.RandomState(11)
    q = rng.randn(1, 4, 128, 16).astype(np.float32)
    k, v = (rng.randn(1, 2, 128, 16).astype(np.float32) for _ in range(2))
    g = rng.randn(1, 4, 128, 16).astype(np.float32)
    glse = (rng.randn(1, 4, 128).astype(np.float32) if with_dlse
            else np.zeros((1, 4, 128), np.float32))

    def jloss(q, k, v):
        o, lse = jatt.flash_attention_lse(q, k, v, causal=True,
                                          window=window, k_offset=k_offset,
                                          block_q=32, block_k=32)
        return (o * g).sum() + (lse * glse).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tg = map(torch.tensor, (q, k, v, g))
    kw = dict(causal=True, scale=0.25, window=window, k_offset=k_offset)
    o, lse = tatt.flash_forward_plain(tq, tk, tv, **kw)
    dlse = torch.tensor(glse) if with_dlse else None
    di = tatt._row_term(o, tg, dlse)
    before = dict(_kernels.launch_counts)
    got = (tatt.flash_backward_dq(tq, tk, tv, tg, lse, di, **kw),
           *tatt.flash_backward_dkv(tq, tk, tv, tg, lse, di, **kw))
    assert _kernels.launch_counts == before
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-4, err_msg=name)
    whole = tatt.flash_backward(tq, tk, tv, o, lse, tg, dlse, **kw)
    for a, b in zip(whole, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_backward_kernels(s):
    """The output shapes of each Pallas kernel in the JAX package's flash
    backward at Llama-1B's attention shape (B 1, H 32/8, D 64, bf16) and
    length s, from the traced gradient (nothing runs): K2 writes dq, dk
    and dv; K3a dq, then K3b dk and dv."""
    q = jax.ShapeDtypeStruct((1, 32, s, 64), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((1, 8, s, 64), jnp.bfloat16)

    def loss(q, k, v):
        return jatt.flash_attention(q, k, v, causal=True, block_q=512,
                                    block_k=512).astype(jnp.float32).sum()

    jaxpr = jax.make_jaxpr(jax.grad(loss, argnums=(0, 1, 2)))(q, kv, kv)
    outs = [[tuple(a.shape) for a in e.params["out_avals"]]
            for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    return outs[1:]  # the forward's comes first


@pytest.mark.parametrize("s,two_sweeps", [(2048, False), (8192, True)])
def test_backward_dispatch_at_llama_1b(s, two_sweeps):
    """rep 4 · S · D 64 · 4 bytes: 2 MiB at S 2048 takes the fused
    backward (K2), 8 MiB at S 8192 the two sweeps (K3a, K3b), in both
    packages."""
    assert tatt._FUSED_BWD_DQ_BYTES == jatt._FUSED_BWD_DQ_BYTES
    q = torch.empty(1, 32, s, 64, device="meta")
    k = torch.empty(1, 8, s, 64, device="meta")
    assert tatt.takes_two_sweeps(q, k) is two_sweeps
    dq, dkv = [(32, s, 64)], [(8, s, 64)] * 2
    want = [dq, dkv] if two_sweeps else [dq + dkv]
    assert _jax_backward_kernels(s) == want
