"""The optimizer registry (`pddl_tpu_torch/train/state.py`,
`train/optimizers.py`) against the JAX package on the CPU: every name of
the JAX registry builds, and `rmsprop`, `lamb`, `lars` and `adagrad` —
optax's update rules, not torch's namesakes — train a bridged tiny Llama
step by step as the JAX `Trainer` does for 3 steps, at the adamw
tolerances of `tests/test_torch_train.py` (losses within rtol 1e-4,
parameters within 2·lr·steps) and, since such a bound would pass a LARS
that never moved, each leaf's change within 1% of the JAX change's
largest element; the keywords the JAX function passes to
its optax factory reach the rule, `decay_mask` overrides the default
matrices-only decay, `schedule_options` without a schedule leaves the
rate constant (as in JAX), and `update_seed` seeds the stochastic
rounding (equal seeds round alike, another seed otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import _OPTIMIZERS as JAX_OPTIMIZERS
from pddl_tpu_torch.bridge import llama_params_from_jax, llama_params_to_jax
from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import make_optimizer

LM = dict(batch_size=4, seq_len=32, vocab_size=64, seed=3)


@pytest.mark.parametrize("name,lr", [("rmsprop", 1e-3), ("lamb", 1e-3),
                                     ("lars", 0.1), ("adagrad", 1e-2)])
def test_new_optimizers_match_jax_trainer(name, lr):
    jm = jax_tiny_llama(vocab_size=64, max_len=64, attention="flash")
    jtr = JaxTrainer(jm, optimizer=name, learning_rate=lr, seed=0,
                     input_key="tokens", target_key="targets")
    jtr.init_state(JaxLM(**LM).batch(0))
    tm = tiny_llama(vocab_size=64, max_len=64, attention="flash",
                    device="cpu")
    start = jax.tree.map(np.array, jtr.state.params)
    tm.load_state_dict(llama_params_from_jax(start))
    tr = Trainer(tm, optimizer=name, learning_rate=lr, seed=0,
                 input_key="tokens", target_key="targets", device="cpu")
    jh = jtr.fit(JaxLM(**LM), epochs=3, steps_per_epoch=1, verbose=0)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=3, steps_per_epoch=1,
                verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-4)
    assert th.history["loss"][-1] != th.history["loss"][0]
    want = jax.tree.map(np.asarray, jtr.state.params)
    got = llama_params_to_jax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=2 * lr * 3), got, want)
    # Each leaf moved as JAX moved it, within 1% of its largest move (a
    # LARS step is lr·0.001·|p|-sized, far inside 2·lr·steps).
    jax.tree.map(lambda a, b, s: np.testing.assert_allclose(
        a - s, b - s, rtol=0, atol=0.01 * np.abs(b - s).max()),
        got, want, start)


def _one_step(opt_fn, jax_tx, seed=0):
    """One update of a [5, 3] matrix and a [3] vector by the port's
    optimizer and by an optax transform, from the same values: within 1e-5
    relative, 2e-6 absolute (f32 rounding in another order)."""
    rng = np.random.RandomState(seed)
    w, b = rng.randn(5, 3).astype(np.float32), rng.randn(3).astype(np.float32)
    gw, gb = rng.randn(5, 3).astype(np.float32), rng.randn(3).astype(
        np.float32)
    params = [torch.nn.Parameter(torch.tensor(w)),
              torch.nn.Parameter(torch.tensor(b))]
    for p, g in zip(params, (gw, gb)):
        p.grad = torch.tensor(g)
    opt_fn(params).step()
    tree = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    upd, _ = jax_tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                           jax_tx.init(tree), tree)
    want = optax.apply_updates(tree, upd)
    for p, key in zip(params, ("w", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=2e-6)


def test_registry_keywords_and_masks():
    assert sorted(JAX_OPTIMIZERS) == sorted(
        ["adam", "adamw", "sgd", "momentum", "rmsprop", "lamb", "lars",
         "adagrad"])
    model = tiny_llama(vocab_size=64, max_len=64, device="cpu")
    for name in JAX_OPTIMIZERS:
        assert isinstance(make_optimizer(model, name), torch.optim.Optimizer)
    # Keywords reach the rule; the masks follow optax's.
    _one_step(lambda p: make_optimizer(p, "rmsprop", 0.1, decay=0.5,
                                       momentum=0.9, centered=True),
              optax.rmsprop(0.1, decay=0.5, momentum=0.9, centered=True))
    _one_step(lambda p: make_optimizer(p, "rmsprop", 0.1, eps_in_sqrt=False,
                                       bias_correction=True, nesterov=True,
                                       momentum=0.5),
              optax.rmsprop(0.1, eps_in_sqrt=False, bias_correction=True,
                            nesterov=True, momentum=0.5))
    _one_step(lambda p: make_optimizer(p, "lamb", 0.1, b1=0.5,
                                       weight_decay=0.3),
              optax.lamb(0.1, b1=0.5, weight_decay=0.3,
                         mask={"w": True, "b": False}))
    _one_step(lambda p: make_optimizer(p, "lamb", 0.1, weight_decay=0.3,
                                       decay_mask=None),
              optax.lamb(0.1, weight_decay=0.3))
    _one_step(lambda p: make_optimizer(p, "lars", 0.1, momentum=0.5,
                                       trust_ratio_mask=[True, False]),
              optax.lars(0.1, momentum=0.5,
                         trust_ratio_mask={"w": True, "b": False}))
    _one_step(lambda p: make_optimizer(p, "adagrad", 0.1, eps=1e-3),
              optax.adagrad(0.1, eps=1e-3))
    _one_step(lambda p: make_optimizer(p, "momentum", 0.1, nesterov=True),
              optax.sgd(0.1, momentum=0.9, nesterov=True))
    _one_step(lambda p: make_optimizer(p, "adamw", 0.1, b1=0.8,
                                       weight_decay=0.2,
                                       decay_mask=lambda q: q.ndim == 1),
              optax.adamw(0.1, b1=0.8, weight_decay=0.2,
                          mask={"w": False, "b": True}))
    with pytest.raises(ValueError, match="not supported for 'rmsprop'"):
        make_optimizer(model, "rmsprop", weight_decay=0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(model, "adafactor")
    # Ported since: as in JAX, schedule_options without a schedule leave
    # the rate constant, and update_seed seeds the stochastic rounding.
    opt = make_optimizer(model, "adam", schedule_options={"warmup_steps": 2})
    assert isinstance(opt, torch.optim.Adam)
    rounded = []
    for seed in (3, 3, 4):
        p = torch.nn.Parameter(torch.ones(256, dtype=torch.bfloat16))
        opt = make_optimizer([p], "sgd", 1e-3, param_update="stochastic_round",
                             update_seed=seed)
        p.grad = torch.ones_like(p)
        opt.step()
        rounded.append(p.detach().clone())
    assert torch.equal(rounded[0], rounded[1])
    assert not torch.equal(rounded[0], rounded[2])
