"""The port's causal-LM training path (`pddl_tpu_torch/train/`,
`data/synthetic.py`, the flash Llama) against the JAX package on the CPU.

- `SyntheticLanguageModeling` gives the JAX package's batches exactly;
- a bridged `tiny_llama(attention="flash")` gives JAX's logits within
  1e-5 (f32); with bf16 compute over f32 parameters it equals, bit for
  bit, the port's model that stores the same weights in bf16 (the cast
  happens at use), and is within 6e-2 of JAX's — a few bf16 ulps of
  logits near 2-4 (ulp 1.6e-2), since the two frameworks round bf16
  intermediates at different places;
- the port's `Trainer` and the JAX `Trainer`, from the same bridged
  weights on the same batches, agree step by step for 3 steps: with `sgd`
  the losses within rtol 1e-5 and the parameters within 1e-5; with
  `adamw` the losses within rtol 1e-4 and the parameters within
  2·lr·steps — Adam moves a parameter by about ±lr per step whatever the
  gradient's size, so a near-zero gradient whose sign differs between the
  two (their sums run in another order) puts them 2·lr apart per step;
- the `adamw` decay mask leaves 1-D parameters undecayed;
- unported options raise `NotImplementedError` naming ROADMAP.md, and
  `augment` and `callbacks`, once among them, now run;
- the trainer runs on `cuda` unless given `device="cpu"`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import llama_params_from_jax, llama_params_to_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.llama import Llama, tiny_llama
from pddl_tpu_torch.train.callbacks import Callback
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import (
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)

VOCAB, SEQ = 64, 32
LM = dict(batch_size=4, seq_len=SEQ, vocab_size=VOCAB, seed=3)


def _bridged(attention, dtypes=None):
    """(jax model, numpy params, port model) with the same weights;
    ``dtypes`` names (compute, param) types."""
    jkw, tkw = {}, {}
    if dtypes:
        jkw = dict(dtype=getattr(jnp, dtypes[0]),
                   param_dtype=getattr(jnp, dtypes[1]))
        tkw = dict(dtype=getattr(torch, dtypes[0]),
                   param_dtype=getattr(torch, dtypes[1]))
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention=attention,
                        **jkw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(1), jnp.ones((1, 8), jnp.int32), train=False)["params"])
    tm = tiny_llama(vocab_size=VOCAB, max_len=64, attention=attention,
                    device="cpu", **tkw)
    tm.load_state_dict(llama_params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("cfg", [
    dict(batch_size=3, seq_len=17, vocab_size=64, seed=0),
    dict(batch_size=2, seq_len=256, vocab_size=128256, seed=5),
    dict(batch_size=8, seq_len=9, vocab_size=50, seed=2, process_index=1,
         process_count=4, index_offset=7),
])
def test_synthetic_lm_batches_equal_jax(cfg):
    ours, theirs = SyntheticLanguageModeling(**cfg), JaxLM(**cfg)
    assert (ours.a, ours.b) == (theirs.a, theirs.b)
    for index in (0, 1, 11):
        a, b = ours.batch(index), theirs.batch(index)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    first = next(iter(ours.with_offset(4)))
    np.testing.assert_array_equal(first["tokens"], theirs.batch(4)["tokens"])


def test_flash_logits_match_jax():
    jm, params, tm = _bridged("flash")
    assert tm.attention == "flash" and tiny_llama(device="cpu").attention \
        == "reference"
    tokens = np.random.RandomState(1).randint(0, VOCAB, (2, SEQ)).astype(
        np.int32)
    ref = jm.apply({"params": params}, jnp.asarray(tokens), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_bf16_compute_over_f32_params_matches_jax():
    """``param_dtype`` f32 under ``dtype`` bf16: parameters stay f32, the
    products run in bf16, logits come back f32."""
    jm, params, tm = _bridged("reference", ("bfloat16", "float32"))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    stored_bf16 = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu",
                             dtype=torch.bfloat16)
    stored_bf16.load_state_dict(tm.state_dict())
    assert all(p.dtype == torch.bfloat16 for p in stored_bf16.parameters())
    tokens = torch.tensor(np.random.RandomState(2).randint(
        0, VOCAB, (2, SEQ)).astype(np.int32))
    ref = jm.apply({"params": params}, jnp.asarray(tokens.numpy()),
                   train=False)
    with torch.no_grad():
        got = tm(tokens)
        torch.testing.assert_close(got, stored_bf16(tokens), rtol=0, atol=0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=6e-2)


def test_linears_cast_only_when_parameter_and_compute_types_differ():
    """The serving configuration (``param_dtype == dtype``) gets plain
    ``nn.Linear``, with no cast on the decode tick; f32 parameters under
    bf16 compute get the linear that casts at use. Both keep one layout."""
    serve = tiny_llama(device="cpu", dtype=torch.bfloat16)
    train = tiny_llama(device="cpu", dtype=torch.bfloat16,
                       param_dtype=torch.float32)

    def linears(m):
        return [x for x in m.modules() if isinstance(x, torch.nn.Linear)]

    assert linears(serve) and all(type(x) is torch.nn.Linear
                                  for x in linears(serve))
    assert len(linears(train)) == len(linears(serve))
    assert not any(type(x) is torch.nn.Linear for x in linears(train))
    assert serve.state_dict().keys() == train.state_dict().keys()


@pytest.mark.parametrize("optimizer,lr,loss_rtol,param_atol", [
    ("sgd", 0.1, 1e-5, 1e-5),
    ("adamw", 1e-3, 1e-4, 2 * 1e-3 * 3),
])
def test_trainer_matches_jax_trainer(optimizer, lr, loss_rtol, param_atol):
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash")
    jtr = JaxTrainer(jm, optimizer=optimizer, learning_rate=lr, seed=0,
                     input_key="tokens", target_key="targets")
    jtr.init_state(JaxLM(**LM).batch(0))
    tm = tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                    device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(tm, optimizer=optimizer, learning_rate=lr, seed=0,
                 input_key="tokens", target_key="targets", device="cpu")
    jh = jtr.fit(JaxLM(**LM), epochs=3, steps_per_epoch=1, verbose=0)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=3, steps_per_epoch=1,
                verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=loss_rtol)
    np.testing.assert_allclose(th.history["accuracy"],
                               jh.history["accuracy"], atol=1e-6)
    want = jax.tree.map(np.asarray, jtr.state.params)
    got = llama_params_to_jax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=param_atol), got, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)


def test_fit_with_validation_and_evaluate():
    tm = tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                    device="cpu")
    tr = Trainer(tm, optimizer="adamw", learning_rate=3e-3,
                 input_key="tokens", target_key="targets", device="cpu")
    val = SyntheticLanguageModeling(**{**LM, "seed": 4})
    hist = tr.fit(SyntheticLanguageModeling(**LM), epochs=2,
                  steps_per_epoch=3, validation_data=val, validation_steps=2,
                  verbose=0)
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        assert len(hist.history[key]) == 2
        assert all(np.isfinite(hist.history[key]))
    logs = tr.evaluate(val, steps=2)
    assert logs["loss"] == pytest.approx(hist.history["val_loss"][-1])


def test_adamw_decays_matrices_only():
    tm = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    opt = make_optimizer(tm.parameters(), "adamw", 0.1, weight_decay=0.5)
    assert make_optimizer(tm.parameters(), "adamw").param_groups[0][
        "weight_decay"] == 1e-4
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    for name, p in tm.named_parameters():
        want = before[name] * (1 - 0.1 * 0.5) if p.ndim > 1 else before[name]
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)
    assert get_learning_rate(opt) == pytest.approx(0.1)
    set_learning_rate(opt, 0.25)
    assert {g["lr"] for g in opt.param_groups} == {0.25}


@pytest.mark.parametrize("where,kw", [
    ("trainer", {"strategy": object()}),
    ("trainer", {"ema_decay": 0.99}),
    ("trainer", {"gradient_accumulation_steps": 2}),
    ("trainer", {"lr_schedule": "cosine"}),
    ("trainer", {"param_update": "stochastic_round"}),
    ("trainer", {"fault_plan": object()}),
    ("trainer", {"lr_schedule_options": {"warmup_steps": 2}}),
    ("fit", {"prefetch": 4}),
    ("fit", {"resume": "ckpt_dir"}),
    ("optimizer", {"schedule": "cosine"}),
    ("optimizer", {"grad_clip_norm": 1.0}),
    ("optimizer", {"accumulate_steps": 4}),
    ("model", {"moe_experts": 4}),
    ("model", {"attention": "ring"}),
])
def test_unported_options_raise(where, kw):
    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    trainer_kw = dict(device="cpu", input_key="tokens", target_key="targets")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if where == "model":
            tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu", **kw)
        elif where == "optimizer":
            make_optimizer(model.parameters(), "adam", **kw)
        elif where == "trainer":
            Trainer(model, **trainer_kw, **kw)
        else:
            Trainer(model, **trainer_kw).fit(
                SyntheticLanguageModeling(**LM), steps_per_epoch=1,
                verbose=0, **kw)


def test_augment_and_callbacks_are_accepted():
    """Once refused above, both are ported: the augment runs on each
    train batch, a callback's hooks run."""
    seen, ends = [], []

    class Stop(Callback):
        def on_epoch_end(self, epoch, logs):
            ends.append(epoch)
            self.trainer.stop_training = True

    tr = Trainer(tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu"),
                 device="cpu", input_key="tokens", target_key="targets",
                 augment=lambda gen, x: seen.append(x.shape) or x)
    hist = tr.fit(SyntheticLanguageModeling(**LM), epochs=3,
                  steps_per_epoch=2, verbose=0, callbacks=[Stop()])
    assert seen == [(LM["batch_size"], SEQ)] * 2 and ends == [0]
    assert len(hist.history["loss"]) == 1


def test_jax_trainer_defaults_are_accepted():
    tr = Trainer(tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu"),
                 device="cpu", input_key="tokens", target_key="targets",
                 strategy=None, param_update="plain", ema_decay=None)
    hist = tr.fit(SyntheticLanguageModeling(**LM), steps_per_epoch=1,
                  verbose=0, callbacks=(), resume=None, initial_epoch=0)
    assert len(hist.history["loss"]) == 1
    with pytest.raises(TypeError, match="unexpected argument"):
        Trainer(tr.model, device="cpu", no_such_option=1)


def test_trainer_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    model = tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, input_key="tokens", target_key="targets")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(vocab_size=VOCAB, embed_dim=32, depth=1, num_heads=4)
    tr = Trainer(model, device="cpu", input_key="tokens",
                 target_key="targets")
    assert tr.device.type == "cpu"
    assert next(model.parameters()).device.type == "cpu"
