"""The port's GPT (`pddl_tpu_torch/models/gpt.py`, the blocks of
`models/vit.py`) against the JAX GPT on the CPU, through the weight
bridge. The JAX side runs `attention="reference"`, or `"flash"` with its
Pallas kernels in interpret mode; the port runs its kernels' plain
versions, the only thing it runs on CPU tensors. f32 throughout:

- logits within 1e-5 (rtol and atol) of JAX's, with a padded vocabulary,
  and the bridge round trip exact;
- the twins of `tests/test_gpt.py`: causality, flash against reference
  (2e-4), the next-token task learned through `Trainer.fit`, step-by-step
  decoding against the full forward (1e-4), greedy `generate` after
  training continuing the recurrence, and `fused_lm_loss` against the
  materialized loss (rtol 1e-6; gradients within 1e-5);
- greedy `generate` token-exact with the JAX `generate`;
- the port's `Trainer` and the JAX `Trainer` step by step for 3 adamw
  steps from the same weights (`attention="flash"`, remat `none` and
  `dots`): losses within rtol 1e-4, parameters within 2·lr·steps, as
  `tests/test_torch_train.py` holds the Llama;
- the per-row position lookup past `max_len` is clamped (JAX fills NaN);
- unported options raise, naming their ROADMAP.md item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.gpt import GPT as JaxGPT
from pddl_tpu.models.gpt import fused_lm_loss as jax_fused_lm_loss
from pddl_tpu.models.gpt import generate as jax_generate
from pddl_tpu.models.gpt import tiny_gpt as jax_tiny_gpt
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import gpt_params_from_jax, gpt_params_to_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.gpt import (
    GPT,
    decode_cache,
    fused_lm_loss,
    generate,
    tiny_gpt,
)
from pddl_tpu_torch.train.loop import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
LM = dict(batch_size=4, seq_len=32, vocab_size=64, seed=3)


def _pair(**kw):
    """(jax model, numpy params, port model) with bridged weights."""
    jm = jax_tiny_gpt(**kw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(1), jnp.ones((1, 8), jnp.int32), train=False)["params"])
    tm = tiny_gpt(device="cpu", **kw)
    tm.load_state_dict(gpt_params_from_jax(params))
    return jm, params, tm


def _tokens(b=2, s=32, vocab=64, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def test_logits_match_jax_and_the_bridge_round_trips():
    jm, params, tm = _pair(vocab_size=50, max_len=64, vocab_multiple=16)
    assert tm.head.lm_head.weight.shape == (64, 32)
    x = _tokens(vocab=50)
    ref = jm.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(x))
        feats = tm(torch.tensor(x), features_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    torch.testing.assert_close(tm.head_logits(feats), got, rtol=0, atol=0)
    back = gpt_params_to_jax(tm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert (tm.num_kv_heads, tm.head_dim) == (4, 8)


def test_causality_future_tokens_do_not_leak():
    tm = tiny_gpt(device="cpu")
    x = torch.tensor(_tokens())
    with torch.no_grad():
        base = tm(x)
        x2 = x.clone()
        x2[:, -8:] = (x2[:, -8:] + 7) % 64
        out = tm(x2)
    torch.testing.assert_close(out[:, :-8], base[:, :-8], **TOL)
    assert (out[:, -8:] - base[:, -8:]).abs().max() > 1e-3


def test_flash_matches_reference_through_model():
    _, params, ref_model = _pair()
    flash = tiny_gpt(attention="flash", device="cpu")
    flash.load_state_dict(gpt_params_from_jax(params))
    x = torch.tensor(_tokens(s=64))
    with torch.no_grad():
        torch.testing.assert_close(flash(x), ref_model(x), rtol=2e-4,
                                   atol=2e-4)


@pytest.fixture(scope="module")
def trained():
    """One tiny GPT trained 3 epochs x 6 steps on the next-token task:
    `test_gpt_learns_next_token_task`'s run and
    `test_generate_continues_learned_sequence`'s (0.977 accurate by
    then)."""
    ds = SyntheticLanguageModeling(batch_size=32, seq_len=32, vocab_size=16,
                                   seed=0)
    tr = Trainer(tiny_gpt(vocab_size=16, max_len=48, device="cpu"),
                 optimizer="adamw", learning_rate=3e-3, seed=0,
                 input_key="tokens", target_key="targets", device="cpu")
    return ds, tr, tr.fit(ds, epochs=3, steps_per_epoch=6, verbose=0)


def test_gpt_learns_next_token_task(trained):
    loss, acc = (trained[2].history[k][:3] for k in ("loss", "accuracy"))
    assert loss[-1] < loss[0] * 0.7
    assert acc[-1] > acc[0]


def test_decode_cache_matches_full_forward():
    """Step-by-step KV-cache decoding reproduces the full causal
    forward's logits at every position."""
    tm = tiny_gpt(vocab_size=16, max_len=32, device="cpu")
    x = torch.tensor(_tokens(s=16, vocab=16))
    with torch.no_grad():
        full = tm(x)
        cache = decode_cache(tm, 2)
        steps = [tm(x[:, i:i + 1], cache=cache, cache_index=i)[:, 0]
                 for i in range(16)]
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-4,
                               atol=1e-4)


def test_generate_continues_learned_sequence(trained):
    ds, tr, hist = trained
    assert hist.history["accuracy"][-1] > 0.95, hist.history["accuracy"]
    prompt = ds.batch(0)["tokens"][:4, :8]
    out = generate(tr.model, prompt, 8).numpy()
    assert out.shape == (4, 16)
    cur, expected = prompt[:, -1], []
    for _ in range(8):
        cur = (ds.a * cur + ds.b) % ds.vocab_size
        expected.append(cur)
    np.testing.assert_array_equal(out[:, 8:], np.stack(expected, 1))


@pytest.mark.parametrize("b,p,new", [(1, 5, 20), (3, 9, 14)])
def test_generate_greedy_is_token_exact_with_jax(b, p, new):
    jm, params, tm = _pair(vocab_size=32, max_len=64)
    prompt = _tokens(b, p, vocab=32, seed=b)
    want = jax_generate(jm, {"params": params}, jnp.asarray(prompt), new)
    np.testing.assert_array_equal(generate(tm, prompt, new).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("vm", [1, 32])
def test_fused_lm_loss_matches_jax_and_the_materialized_loss(vm):
    kw = dict(vocab_size=97, max_len=32, embed_dim=32, depth=2, num_heads=4,
              attention="reference", vocab_multiple=vm)
    jm = JaxGPT(**kw)
    tokens, targets = _tokens(2, 24, 97, 0), _tokens(2, 24, 97, 1)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(tokens), train=False)["params"])
    want = jax_fused_lm_loss(jm, {"params": params}, jnp.asarray(tokens),
                             jnp.asarray(targets), train=False)
    tm = GPT(device="cpu", **kw)
    tm.load_state_dict(gpt_params_from_jax(params))
    x, y = torch.tensor(tokens), torch.tensor(targets).long()
    grads = []
    for fn in (lambda: fused_lm_loss(tm, x, y, train=False),
               lambda: F.cross_entropy(tm(x, train=False).flatten(0, 1),
                                       y.flatten()),
               lambda: fused_lm_loss(tm, x, y, train=False, chunk_size=32)):
        tm.zero_grad()
        loss = fn()
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone()
                                    for n, p in tm.named_parameters()}))
    assert grads[0][0] == pytest.approx(float(want), rel=1e-6)
    for loss, g in grads[1:]:
        assert loss == pytest.approx(grads[0][0], rel=1e-6)
        for name, grad in g.items():
            torch.testing.assert_close(grad, grads[0][1][name], rtol=1e-5,
                                       atol=1e-5)
    assert tm.head.lm_head.bias.grad is not None


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_trainer_matches_jax_trainer(remat):
    lr = 1e-3
    jm = jax_tiny_gpt(vocab_size=64, max_len=64, attention="flash",
                      remat=remat)
    jtr = JaxTrainer(jm, optimizer="adamw", learning_rate=lr, seed=0,
                     input_key="tokens", target_key="targets")
    jtr.init_state(JaxLM(**LM).batch(0))
    tm = tiny_gpt(vocab_size=64, max_len=64, attention="flash", remat=remat,
                  device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(tm, optimizer="adamw", learning_rate=lr, seed=0,
                 input_key="tokens", target_key="targets", device="cpu")
    jh = jtr.fit(JaxLM(**LM), epochs=3, steps_per_epoch=1, verbose=0)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=3, steps_per_epoch=1,
                verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-4)
    want = jax.tree.map(np.asarray, jtr.state.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=2 * lr * 3), gpt_params_to_jax(tm), want)
    # The q/k/v biases are [H, D] in JAX, so adamw decays them there and
    # here: the decayed group holds them.
    decayed = {id(p) for p in tr.optimizer.param_groups[0]["params"]}
    assert id(tm.blocks[0].attn.query.bias) in decayed
    assert id(tm.blocks[0].ln1.bias) not in decayed


def test_per_row_positions_past_max_len_are_clamped():
    """A [B] index whose block runs past max_len reads the last position
    embedding there (the JAX lookup gives NaN); the positions before the
    edge are the full forward's."""
    tm = tiny_gpt(vocab_size=16, max_len=16, device="cpu")
    x = torch.tensor(_tokens(2, 16, 16))
    with torch.no_grad():
        full = tm(x)
        cache = decode_cache(tm, 2)
        tm(x[:, :13], cache=cache, cache_index=0)
        out = tm(x[:, 13:16].repeat(1, 2), cache=cache,
                 cache_index=torch.tensor([13, 13]), max_index=13)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:, :3], full[:, 13:], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="runs past max_len"):
        tm(x[:, :4], cache=decode_cache(tm, 2), cache_index=14)


@pytest.mark.parametrize("kw,item", [
    (dict(attention="ring"), "item 7"), (dict(mesh="one process"), "item 7"),
    (dict(moe_experts=4), "item 5")])
def test_unported_options_raise(kw, item):
    """Ring attention and ``mesh`` (item 7) and Switch-MoE blocks (item 5)
    are ported: each GPT gives the JAX model's logits. The ring runs over
    a one-process mesh against the JAX XLA ring over one device; a mesh
    whose seq axis is 1 leaves the attention as it is. Decoding a model
    built with a mesh still raises, naming item 7."""
    tokens = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(
        np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if "moe_experts" not in kw:
        from pddl_tpu.core.mesh import MeshConfig, build_mesh
        from pddl_tpu_torch.core.mesh import build_mesh as port_mesh

        jkw["mesh"] = build_mesh(MeshConfig(data=1),
                                 devices=jax.devices()[:1])
        tkw["mesh"] = port_mesh(device="cpu")
    jm = jax_tiny_gpt(vocab_size=64, max_len=64, **jkw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(tokens), train=False)["params"])
    tm = tiny_gpt(vocab_size=64, max_len=64, device="cpu", **tkw)
    tm.load_state_dict(gpt_params_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        {"params": params}, jnp.asarray(tokens), train=False)),
        rtol=0, atol=1e-5)
    if "mesh" in tkw:
        with pytest.raises(NotImplementedError, match=item):
            tm(torch.from_numpy(tokens[:, :4]), cache=decode_cache(tm, 2),
               cache_index=0)
