"""The trainer's optimizer options (`pddl_tpu_torch/train/state.py`,
`train/mixed_precision.py`, the EMA and `fit(prefetch=)` in
`train/loop.py`) against the JAX package on the CPU, from the same
bridged weights on the same numpy batches.

- `_sr_to_bf16` given the same bits equals the JAX rounding bit for bit
  (random values of every sign and scale, bf16 ties, infinities);
  `stochastic_round` lands on the two bf16 neighbours with a mean within
  4σ of the f32 value, and lets sub-ulp updates accumulate where `plain`
  loses them;
- `f32_master` over a bf16 and an f32 leaf: 3 adam steps give the JAX
  master within 1e-6 (torch's and optax's Adam round differently in the
  last f32 bits) and bf16 parameters that are exactly the cast of the
  port's master and within one bf16 ulp of JAX's; f32 leaves pass through
  and no master is kept without a bf16 leaf; every rule's moments are f32
  over bf16 storage;
- `make_schedule`: all six names with and without warmup give optax's
  value at every step within rtol 1e-6 (both in f32), and raise where
  the JAX function raises;
- a `Trainer` with `lr_schedule="warmup_cosine"`, with a clipped prebuilt
  optimizer, with `gradient_accumulation_steps=2`, with `ema_decay` and
  with `param_update="f32_master"` over bf16 storage gives the JAX
  `Trainer`'s losses (sgd rtol 1e-5; adam rtol 1e-4; adam over bf16
  storage 5e-3, where a step is the few weights whose rounding flips),
  learning rates (rtol 1e-6), parameters (sgd 1e-5; adam 2·lr·steps,
  Adam's ±lr sign flips), EMA shadows and masters (the bridge carries
  both to the JAX layout, same tolerances) and eval logs on the shadows;
  the stored bf16 parameters are exactly the cast of the port's master;
- a tiny ResNet under accumulation and EMA: BatchNorm buffers move every
  micro-step, parameters and shadows once a window, as in JAX (losses
  rtol 1e-5, parameters, buffers and shadows within 1e-5);
- accumulation of 2 × B 2 is one B 4 step (to f32 rounding, 1e-5);
- the optimizer's `state_dict` carries the SR generator, the masters, the
  accumulator and the schedule's count: a reloaded optimizer continues
  bitwise;
- `fit(prefetch=0/1/2)` and `donate_state` give the same numbers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pddl_tpu.models.resnet as jres
import pddl_tpu_torch.models.resnet as tres
from pddl_tpu.data.synthetic import SyntheticImageClassification as JaxImages
from pddl_tpu.data.synthetic import SyntheticLanguageModeling as JaxLM
from pddl_tpu.models.llama import tiny_llama as jax_tiny_llama
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.mixed_precision import _sr_to_bf16 as jax_sr_to_bf16
from pddl_tpu.train.state import get_learning_rate as jax_get_lr
from pddl_tpu.train.state import make_optimizer as jax_make_optimizer
from pddl_tpu.train.state import make_schedule as jax_make_schedule
from pddl_tpu_torch.bridge import (
    ema_to_jax,
    llama_params_from_jax,
    llama_params_to_jax,
    master_to_jax,
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from pddl_tpu_torch.data.synthetic import (
    SyntheticImageClassification,
    SyntheticLanguageModeling,
)
from pddl_tpu_torch.models.llama import tiny_llama
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.mixed_precision import _sr_to_bf16, stochastic_round
from pddl_tpu_torch.train.state import (
    get_learning_rate,
    make_optimizer,
    make_schedule,
)

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VOCAB = 64
LM = dict(batch_size=4, seq_len=32, vocab_size=VOCAB, seed=3)
KEYS = dict(input_key="tokens", target_key="targets")


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _close(got, want, atol, rtol=0.0):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=rtol, atol=atol), got, _np(want))


# ---------------------------------------------------------- the rounding
def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_sr_rounding_is_the_jax_rule_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32),
        (rng.standard_normal(2000) * 1e-30).astype(np.float32),
        (rng.standard_normal(2000) * 1e30).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf,
                  np.float32(1 + 2 ** -8), np.float32(-(1 + 2 ** -8)),
                  np.finfo(np.float32).max, -np.finfo(np.float32).max],
                 np.float32)])
    key = jax.random.key(7)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    want = np.asarray(jax_sr_to_bf16(jnp.asarray(x), key)).view(np.int16)
    got = _sr_to_bf16(torch.from_numpy(x),
                      torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(_bf16_bits(got), want)


def test_stochastic_round_is_unbiased_and_lands_on_neighbours():
    ulp = np.spacing(np.float32(1.0)) * 2 ** 16  # bf16's at 1.0
    frac = 0.3
    x = torch.full((4096,), float(np.float32(1.0 + frac * ulp)))
    gen = torch.Generator().manual_seed(0)
    r = stochastic_round(x, gen).float()
    assert set(r.unique().tolist()) <= {1.0, float(1.0 + ulp)}
    sigma = ulp * np.sqrt(frac * (1 - frac) / x.numel())
    assert abs(float(r.mean()) - float(x[0])) < 4 * sigma
    exact = torch.tensor([1.0, -2.5, 0.0, 3.0e5], dtype=torch.bfloat16)
    assert torch.equal(stochastic_round(exact.float(), gen), exact)


def test_sub_ulp_updates_accumulate_under_sr_not_plain():
    means = {}
    for mode in ("plain", "stochastic_round"):
        p = torch.nn.Parameter(torch.ones(4096, dtype=torch.bfloat16))
        opt = make_optimizer([p], "sgd", 1e-4, param_update=mode)
        for _ in range(50):
            p.grad = -torch.ones_like(p)  # +1e-4 a step, 1/78 of an ulp
            opt.step()
        means[mode] = float(p.detach().float().mean())
    assert means["plain"] == 1.0
    assert means["stochastic_round"] == pytest.approx(1.005, abs=1.5e-3)


# ------------------------------------------------------- update rules
def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    grads = [(rng.standard_normal((16, 8)).astype(np.float32) * 1e-2,
              rng.standard_normal((8,)).astype(np.float32) * 1e-2)
             for _ in range(3)]
    return w, b, grads


def _find(state, cls_name):
    if type(state).__name__ == cls_name:
        return state
    if isinstance(state, tuple):
        for sub in state:
            found = _find(sub, cls_name)
            if found is not None:
                return found
    return None


def test_f32_master_over_mixed_leaves_matches_jax():
    w, b, grads = _leaves()
    tree = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)}
    tx = jax_make_optimizer("adam", 1e-2, param_update="f32_master")
    st = tx.init(tree)
    pw = torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16))
    pb = torch.nn.Parameter(torch.tensor(b))
    opt = make_optimizer([pw, pb], "adam", 1e-2, param_update="f32_master")
    for gw, gb in grads:
        u, st = tx.update({"w": jnp.asarray(gw, jnp.bfloat16),
                           "b": jnp.asarray(gb)}, st, tree)
        tree = optax.apply_updates(tree, u)
        pw.grad = torch.tensor(gw).to(torch.bfloat16)
        pb.grad = torch.tensor(gb)
        opt.step()
    master = _find(st, "F32MasterState").master
    got = opt.masters()
    assert list(got) == [pw]  # the f32 leaf has no master of its own
    np.testing.assert_allclose(got[pw].numpy(), np.asarray(master["w"]),
                               rtol=0, atol=1e-6)
    assert torch.equal(pw.detach(), got[pw].to(torch.bfloat16))
    ulp = np.spacing(np.abs(w).astype(np.float32)) * 2 ** 16
    assert np.all(np.abs(pw.detach().float().numpy()
                         - np.asarray(tree["w"], np.float32)) <= ulp)
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(tree["b"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["plain", "stochastic_round", "f32_master"])
def test_moments_are_f32_over_bf16_storage(mode):
    p = torch.nn.Parameter(torch.ones(8, 4, dtype=torch.bfloat16))
    q = torch.nn.Parameter(torch.ones(4))
    for name in ("adam", "lamb"):
        opt = make_optimizer([p, q], name, 1e-3, param_update=mode)
        p.grad, q.grad = torch.ones_like(p), torch.ones_like(q)
        opt.step()
        dtypes = {t.dtype for s in opt.state.values() for t in s.values()
                  if isinstance(t, torch.Tensor) and t.ndim}
        assert dtypes == {torch.float32}
        assert p.dtype == torch.bfloat16


def test_f32_master_is_a_no_op_over_f32_parameters():
    w, b, grads = _leaves(1)
    runs = []
    for mode in ("plain", "f32_master"):
        ps = [torch.nn.Parameter(torch.tensor(w)),
              torch.nn.Parameter(torch.tensor(b))]
        opt = make_optimizer(ps, "adam", 1e-2, param_update=mode)
        for g in grads:
            for p, gi in zip(ps, g):
                p.grad = torch.tensor(gi)
            opt.step()
        runs.append(ps)
        if mode == "f32_master":
            assert opt.masters() == {}
    for p, q in zip(*runs):
        assert torch.equal(p, q)


def test_prebuilt_optimizer_composes_with_the_chain():
    w, b, grads = _leaves(2)
    tree = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tx = jax_make_optimizer(jax_make_optimizer("sgd", 0.5),
                            grad_clip_norm=0.01, accumulate_steps=2)
    st = tx.init(tree)
    ps = [torch.nn.Parameter(torch.tensor(w)),
          torch.nn.Parameter(torch.tensor(b))]
    opt = make_optimizer(ps, lambda params: make_optimizer(params, "sgd", 0.5),
                         grad_clip_norm=0.01, accumulate_steps=2)
    for gw, gb in grads + grads[:1]:
        u, st = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, st,
                          tree)
        tree = optax.apply_updates(tree, u)
        ps[0].grad, ps[1].grad = torch.tensor(gw), torch.tensor(gb)
        opt.step()
    for p, key in zip(ps, ("w", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree[key]),
                                   rtol=0, atol=1e-6)


def test_optimizer_state_dict_continues_bitwise():
    """The SR generator, the master, the accumulator and the schedule's
    count survive a ``state_dict`` round trip."""
    w, b, grads = _leaves(3)
    grads = grads * 3

    def build():
        ps = [torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16)),
              torch.nn.Parameter(torch.tensor(b))]
        return ps, [make_optimizer(ps, "adam", 1e-2, param_update=mode,
                                   update_seed=5, accumulate_steps=2,
                                   grad_clip_norm=0.05,
                                   schedule="cosine",
                                   schedule_options={"decay_steps": 4})
                    for mode in ("stochastic_round",)][0]

    def run(ps, opt, gs):
        for gw, gb in gs:
            ps[0].grad = torch.tensor(gw).to(torch.bfloat16)
            ps[1].grad = torch.tensor(gb)
            opt.step()

    ps, opt = build()
    run(ps, opt, grads)
    ps2, opt2 = build()
    run(ps2, opt2, grads[:5])  # mid-window: the accumulator is live
    saved = (opt2.state_dict(), [p.detach().clone() for p in ps2])
    ps3, opt3 = build()
    with torch.no_grad():
        for p, v in zip(ps3, saved[1]):
            p.copy_(v)
    opt3.load_state_dict(saved[0])
    assert get_learning_rate(opt3) == get_learning_rate(opt2)
    run(ps3, opt3, grads[5:])
    for p, q in zip(ps, ps3):
        assert torch.equal(p, q)
    # And a master survives too.
    for mode in ("f32_master",):
        pa = [torch.nn.Parameter(torch.tensor(w).to(torch.bfloat16))]
        oa = make_optimizer(pa, "adam", 1e-2, param_update=mode)
        pa[0].grad = torch.tensor(grads[0][0]).to(torch.bfloat16)
        oa.step()
        pb_ = [torch.nn.Parameter(pa[0].detach().clone())]
        ob = make_optimizer(pb_, "adam", 1e-2, param_update=mode)
        ob.load_state_dict(oa.state_dict())
        assert torch.equal(ob.masters()[pb_[0]], oa.masters()[pa[0]])


# ----------------------------------------------------------- schedules
SCHEDULES = [
    ("cosine", dict(decay_steps=10, alpha=0.1)),
    ("cosine", dict(decay_steps=10, warmup_steps=3, alpha=0.05)),
    ("warmup_cosine", dict(decay_steps=12, warmup_steps=4)),
    ("exponential", dict(decay_steps=3, decay_rate=0.5)),
    ("exponential", dict(decay_steps=3, decay_rate=0.7, warmup_steps=2)),
    ("linear", dict(decay_steps=10, end_value=0.01)),
    ("linear", dict(decay_steps=10, warmup_steps=4)),
    ("piecewise", dict(boundaries_and_scales={3: 0.5, 7: 0.1})),
    ("piecewise", dict(warmup_steps=2, boundaries_and_scales={4: 0.3})),
    ("constant", {}),
    ("constant", dict(warmup_steps=5)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedules_match_optax(name, kw):
    want = jax_make_schedule(name, 0.3, **kw)
    got = make_schedule(name, 0.3, **kw)
    for step in range(16):
        np.testing.assert_allclose(float(got(step)),
                                   float(want(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9, err_msg=str(step))


@pytest.mark.parametrize("name,kw", [
    ("cosine", {}), ("warmup_cosine", dict(decay_steps=10)),
    ("cosine", dict(decay_steps=4, warmup_steps=4)),
    ("linear", dict(decay_steps=3, warmup_steps=4)),
    ("exponential", {}), ("piecewise", {}),
    ("piecewise", dict(warmup_steps=4, boundaries_and_scales={3: 0.1})),
    ("nope", {})])
def test_schedule_errors_are_the_jax_ones(name, kw):
    errors = []
    for fn in (jax_make_schedule, make_schedule):
        with pytest.raises(ValueError) as info:
            fn(name, 1.0, **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------ trainer parity
def _lm_pair(optimizer="sgd", lr=0.1, jax_opt=None, port_opt=None,
             param_dtype=None, **kw):
    """A JAX and a port Trainer on one bridged tiny Llama."""
    mkw = {}
    if param_dtype is not None:  # f32 compute over the stored type
        mkw = dict(param_dtype=getattr(jnp, param_dtype))
    jm = jax_tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                        **mkw)
    jtr = JaxTrainer(jm, optimizer=jax_opt or optimizer, learning_rate=lr,
                     seed=0, **KEYS, **kw)
    jtr.init_state(JaxLM(**LM).batch(0))
    tkw = ({"param_dtype": getattr(torch, param_dtype)} if param_dtype
           else {})
    tm = tiny_llama(vocab_size=VOCAB, max_len=64, attention="flash",
                    device="cpu", **tkw)
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params)))
    tr = Trainer(tm, optimizer=port_opt or optimizer, learning_rate=lr,
                 seed=0, device="cpu", **KEYS, **kw)
    return jtr, tr


def _fit_pair(jtr, tr, epochs=4, steps=1, val=False):
    from pddl_tpu.train.callbacks import LambdaCallback as JaxLambda
    from pddl_tpu_torch.train.callbacks import LambdaCallback

    jl, tl = [], []
    jcb = JaxLambda(on_train_batch_end=lambda s, state, logs: jl.append(
        jax_get_lr(state)))
    tcb = LambdaCallback(on_train_batch_end=lambda s, logs: tl.append(
        get_learning_rate(tr.optimizer)))
    vkw = {}
    if val:
        vkw = dict(validation_steps=1)
    jh = jtr.fit(JaxLM(**LM), epochs=epochs, steps_per_epoch=steps,
                 verbose=0, callbacks=[jcb],
                 **({"validation_data": JaxLM(**{**LM, "seed": 8})}
                    if val else {}), **vkw)
    th = tr.fit(SyntheticLanguageModeling(**LM), epochs=epochs,
                steps_per_epoch=steps, verbose=0, callbacks=[tcb],
                **({"validation_data": SyntheticLanguageModeling(
                    **{**LM, "seed": 8})} if val else {}), **vkw)
    return jh.history, th.history, jl, tl


def test_trainer_schedule_matches_jax():
    jtr, tr = _lm_pair(lr_schedule="warmup_cosine", lr_schedule_options=dict(
        decay_steps=6, warmup_steps=2, alpha=0.1))
    jh, th, jl, tl = _fit_pair(jtr, tr, epochs=5)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    _close(llama_params_to_jax(tr.model), jtr.state.params, 1e-5)


def test_trainer_with_clipped_prebuilt_optimizer_matches_jax():
    jtr, tr = _lm_pair(
        jax_opt=jax_make_optimizer("sgd", 0.5, grad_clip_norm=0.5),
        port_opt=lambda p: make_optimizer(p, "sgd", 0.5, grad_clip_norm=0.5),
        lr=0.5)
    jh, th, _, _ = _fit_pair(jtr, tr, epochs=3)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    _close(llama_params_to_jax(tr.model), jtr.state.params, 1e-5)


def test_trainer_accumulation_and_ema_match_jax():
    jtr, tr = _lm_pair(gradient_accumulation_steps=2, ema_decay=0.9,
                       lr_schedule="linear",
                       lr_schedule_options=dict(decay_steps=4))
    jh, th, jl, tl = _fit_pair(jtr, tr, epochs=3, steps=2, val=True)
    for key in ("loss", "val_loss", "accuracy", "val_accuracy"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert int(jtr.state.step) == tr.step == 6
    _close(llama_params_to_jax(tr.model), jtr.state.params, 1e-5)
    _close(ema_to_jax(tr), jtr.state.ema_params, 1e-5)


def test_trainer_f32_master_over_bf16_matches_jax():
    lr, steps = 1e-3, 3
    jtr, tr = _lm_pair("adam", lr, param_dtype="bfloat16",
                       param_update="f32_master")
    jh, th, _, _ = _fit_pair(jtr, tr, epochs=steps)
    # bf16 storage: Adam moves a weight by ~lr, under a bf16 ulp (~2e-3
    # at 0.4), so a step's loss change is the few weights whose rounding
    # flips; torch's and optax's Adam differ in the last f32 bits, which
    # flips a handful more or fewer: the losses agree to 5e-3.
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=5e-3)
    master = _find(jtr.state.opt_state, "F32MasterState").master
    _close(master_to_jax(tr), master, 2 * lr * steps)
    got = master_to_jax(tr)
    stored = llama_params_to_jax(tr.model)
    jax.tree.map(lambda m, p: np.testing.assert_array_equal(
        np.asarray(torch.tensor(m).to(torch.bfloat16).float()), p),
        got, stored)


def test_ema_eval_uses_the_shadows_like_jax():
    jtr, tr = _lm_pair("adam", 5e-3, ema_decay=0.5)
    jh, th, _, _ = _fit_pair(jtr, tr, epochs=2, val=True)
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"], rtol=1e-4)
    _close(ema_to_jax(tr), jtr.state.ema_params, 2 * 5e-3 * 2)
    live = Trainer(tr.model, device="cpu", **KEYS, ema_decay=0.5,
                   eval_with_ema=False)
    val = SyntheticLanguageModeling(**{**LM, "seed": 8})
    assert live.evaluate(val, steps=1) != tr.evaluate(val, steps=1)


def test_resnet_accumulation_bn_cadence_and_ema_match_jax():
    cfg = dict(batch_size=4, image_size=32, num_classes=10, seed=1)
    kw = dict(gradient_accumulation_steps=2, ema_decay=0.8)
    jtr = JaxTrainer(jres.tiny_resnet(), optimizer="sgd", learning_rate=0.01,
                     seed=0, **kw)
    jtr.init_state(JaxImages(**cfg).batch(0))
    weights = resnet_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params),
        jax.tree.map(np.asarray, jtr.state.batch_stats))
    trainers = []
    for _ in range(2):
        tm = tres.tiny_resnet(device="cpu")
        tm.load_state_dict(weights)
        trainers.append(Trainer(tm, optimizer="sgd", learning_rate=0.01,
                                seed=0, device="cpu", **kw))
    probe, tr = trainers
    stats0 = {k: v.clone() for k, v in probe.model.state_dict().items()
              if "running" in k}
    params0 = [p.detach().clone() for p in probe.model.parameters()]
    probe.train_step(SyntheticImageClassification(**cfg).batch(0))
    # One micro-step: the buffers moved, the parameters did not.
    assert all(not torch.equal(v, probe.model.state_dict()[k])
               for k, v in stats0.items())
    assert all(torch.equal(a, b)
               for a, b in zip(params0, probe.model.parameters()))
    jh = jtr.fit(JaxImages(**cfg), epochs=2, steps_per_epoch=2, verbose=0)
    th = tr.fit(SyntheticImageClassification(**cfg), epochs=2,
                steps_per_epoch=2, verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-5)
    params, stats = resnet_params_to_jax(tr.model.state_dict())
    _close(params, jtr.state.params, 1e-5)
    _close(stats, jtr.state.batch_stats, 1e-5)
    ema_params, ema_stats = ema_to_jax(tr)
    _close(ema_params, jtr.state.ema_params, 1e-5)
    _close(ema_stats, jtr.state.ema_batch_stats, 1e-5)


def test_accumulated_micro_batches_are_one_big_step():
    data = SyntheticLanguageModeling(**LM)
    batch = data.batch(0)
    halves = [{k: v[:2] for k, v in batch.items()},
              {k: v[2:] for k, v in batch.items()}]
    runs = []
    for acc, batches in ((2, halves), (None, [batch])):
        tr = Trainer(tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu"),
                     optimizer="sgd", learning_rate=0.5, device="cpu",
                     gradient_accumulation_steps=acc, **KEYS)
        for b in batches:
            tr.train_step(b)
        runs.append([p.detach() for p in tr.model.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("prefetch", [1, 2])
def test_prefetch_and_donate_state_change_no_number(prefetch):
    runs = []
    for kw, fit_kw in (({}, {"prefetch": 0}),
                       ({"donate_state": False}, {"prefetch": prefetch})):
        tr = Trainer(tiny_llama(vocab_size=VOCAB, max_len=64, device="cpu"),
                     optimizer="adam", device="cpu", **KEYS, **kw)
        h = tr.fit(SyntheticLanguageModeling(**LM), epochs=2,
                   steps_per_epoch=3, verbose=0, **fit_kw)
        runs.append((h.history["loss"], list(tr.model.parameters())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
