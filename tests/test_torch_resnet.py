"""The port's ResNet path (`pddl_tpu_torch/models/resnet.py`, the ResNet
bridge, `SyntheticImageClassification` and the image-classification
`Trainer`) against the JAX package on the CPU, from the same weights
(carried over by the bridge) on the same numpy inputs.

- forward in f32: logits within 1e-5 of the JAX logits, relative to their
  max-abs, for both stems, both `stride_in_3x3` settings,
  `small_input_stem`, `num_classes=0`, `train=True` and `train=False`.
  Train-mode cases run the shallow `tiny_resnet` layouts: a BatchNorm net
  at init, normalized by each batch's statistics, amplifies f32 rounding
  with depth (the two frameworks' convs round differently by ~1e-7), so
  full-depth train-mode logits are not a 1e-5 observable; the deep nets
  are held in eval mode, and their train-mode losses and gradient norms
  on the card against the CPU by `chip_smoke.py`;
- bf16 compute over f32 parameters: logits within 2e-2;
- BatchNorm buffers after one train-mode forward within 1e-5 of the JAX
  `batch_stats`, with a case whose last stage is 1x1 at B 4 (an unbiased
  variance would be 4/3 of the biased one there); `"frozen"` leaves the
  buffers as they were and stays differentiable in scale and bias;
- `s2d_stem_kernel` and its inverse equal the JAX functions exactly, and
  the two stems compute the same function (within 1e-5 of the max-abs);
- the bridge round trip is exact;
- `_train_1step`'s observables (`__graft_entry__.py`: one SGD step at lr
  0.005 with `log_grad_norm`): loss within rtol 1e-5, `grad_norm` within
  rtol 1e-4, parameters within 1e-5 and buffers within 1e-5; 3 adam
  steps: losses within rtol 1e-4, parameters and buffers within
  2·lr·steps (Adam moves a parameter by about ±lr a step whatever its
  gradient's size);
- `fit` (sgd) with a deterministic augment, `eval_transform` and
  validation data gives the JAX `History` (losses within rtol 1e-5,
  accuracies within 1e-6), and `predict` the JAX `predict`'s logits
  within 1e-4;
- `SyntheticImageClassification` gives the JAX package's batches bitwise;
- the entry points run on `cuda` unless asked for the CPU, and
  `axis_name` takes `"data"` only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import pddl_tpu.models.resnet as jres
import pddl_tpu_torch.models.resnet as tres
from pddl_tpu.core.mesh import MeshConfig as JaxMeshConfig
from pddl_tpu.core.mesh import build_mesh as jax_build_mesh
from pddl_tpu.core.mesh import shard_map as jax_shard_map
from pddl_tpu.data.synthetic import SyntheticImageClassification as JaxImages
from pddl_tpu.ops.augment import standard_augment as jax_standard_augment
from pddl_tpu.ops.augment import (
    standard_eval_transform as jax_standard_eval_transform,
)
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu_torch.bridge import resnet_params_from_jax, resnet_params_to_jax
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.ops.augment import (
    standard_augment,
    standard_eval_transform,
)
from pddl_tpu_torch.train.loop import Trainer

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

NARROW = dict(width_multiplier=0.125, num_classes=10)


def _images(shape=(4, 32, 32, 3), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bridged(factory, x, **kw):
    """(jax model, numpy params, numpy batch_stats, port model) with the
    same weights; ``factory`` names the constructor in both packages."""
    jkw, tkw = dict(kw), dict(kw)
    if "dtype" in kw:
        jkw["dtype"] = getattr(jnp, kw["dtype"])
        tkw["dtype"] = getattr(torch, kw["dtype"])
    if "block_cls" in kw:
        jkw["block_cls"] = getattr(jres, kw["block_cls"])
        tkw["block_cls"] = getattr(tres, kw["block_cls"])
    jm = getattr(jres, factory)(**jkw)
    v = jm.init(jax.random.key(1), jnp.asarray(x[:1]), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    tm = getattr(tres, factory)(device="cpu", **tkw)
    tm.load_state_dict(resnet_params_from_jax(params, stats))
    return jm, params, stats, tm


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (factory, options): train-mode cases are the shallow layouts.
TRAIN_CASES = {
    "tiny_small_stem": ("tiny_resnet", {}),
    "tiny_keras_stem": ("tiny_resnet", dict(small_input_stem=False)),
    "tiny_s2d_stem": ("tiny_resnet", dict(small_input_stem=False,
                                          stem="space_to_depth")),
    "tiny_bottleneck_v1": ("tiny_resnet", dict(block_cls="BottleneckBlock")),
    "tiny_bottleneck_v1_5": ("tiny_resnet", dict(block_cls="BottleneckBlock",
                                                 stride_in_3x3=True)),
    "tiny_features": ("tiny_resnet", dict(num_classes=0)),
}
EVAL_CASES = {
    **TRAIN_CASES,
    "resnet50_keras_stem": ("ResNet50", NARROW),
    "resnet50_s2d_stem": ("ResNet50", dict(NARROW, stem="space_to_depth")),
    "resnet50_v1_5": ("ResNet50", dict(NARROW, stride_in_3x3=True)),
    "resnet50_small_stem": ("ResNet50", dict(NARROW, small_input_stem=True)),
    "resnet50_features": ("ResNet50", dict(NARROW, num_classes=0)),
    "resnet18": ("ResNet18", NARROW),
}
FORWARD = ([(name, True) for name in TRAIN_CASES]
           + [(name, False) for name in EVAL_CASES])


@pytest.mark.parametrize("case,train", FORWARD,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in FORWARD])
def test_forward_f32_matches_jax(case, train):
    factory, kw = EVAL_CASES[case]
    x = _images()
    jm, params, stats, tm = _bridged(factory, x, **kw)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(x), train=train)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("factory,kw,train", [
    ("tiny_resnet", {}, True),
    ("tiny_resnet", {}, False),
    ("tiny_resnet", dict(small_input_stem=False, stem="space_to_depth"),
     True),
])
def test_bf16_compute_over_f32_params_matches_jax(factory, kw, train):
    x = _images()
    jm, params, stats, tm = _bridged(factory, x, dtype="bfloat16", **kw)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.tensor(x), train=train)
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("factory,kw", [
    ("tiny_resnet", {}),
    # 32x32 input: the last stage is 1x1 spatial, so each of its
    # BatchNorms sees the batch's 4 values.
    ("ResNet18", NARROW),
])
def test_batchnorm_buffers_match_jax_batch_stats(factory, kw):
    x = _images() + 0.5
    jm, params, stats, tm = _bridged(factory, x, **kw)
    _, upd = jm.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = jax.tree.map(np.asarray, upd["batch_stats"])
    with torch.no_grad():
        tm(torch.tensor(x), train=True)
    _, got = resnet_params_to_jax(tm.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-5), got, want)
    if factory == "ResNet18":
        # The last BatchNorm's variance update: biased, as flax's. The
        # unbiased one (nn.BatchNorm2d's) would be 4/3 of it here.
        var = want["stage4_block2"]["bn2"]["var"]
        stat = (var - 0.99) / 0.01
        unbiased = 0.99 + 0.01 * stat * 4 / 3
        assert np.abs(unbiased - got["stage4_block2"]["bn2"]["var"]).max() \
            > 1e-3


def test_frozen_batchnorm_keeps_its_buffers_and_trains_scale_and_bias():
    x = _images()
    jm = jres.tiny_resnet(bn_mode="frozen")
    v = jm.init(jax.random.key(1), jnp.asarray(x[:1]), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.25, v["batch_stats"])
    tm = tres.tiny_resnet(bn_mode="frozen", device="cpu")
    tm.load_state_dict(resnet_params_from_jax(params, stats))
    before = {k: b.clone() for k, b in tm.named_buffers()}
    ref, _ = jm.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = tm(torch.tensor(x), train=True)
    assert _rel(got.detach(), ref) <= 1e-5
    got.square().sum().backward()
    for name, b in tm.named_buffers():
        torch.testing.assert_close(b, before[name], rtol=0, atol=0)
    assert tm.stem_bn.weight.grad.abs().max() > 0
    assert tm.stem_bn.bias.grad.abs().max() > 0


def test_s2d_stem_kernel_and_inverse_equal_jax():
    k7 = np.random.RandomState(3).randn(7, 7, 3, 16).astype(np.float32)
    want = np.asarray(jres.s2d_stem_kernel(jnp.asarray(k7)))
    got = tres.s2d_stem_kernel(torch.tensor(k7))
    np.testing.assert_array_equal(got.numpy(), want)
    k2 = np.random.RandomState(4).randn(4, 4, 12, 16).astype(np.float32)
    np.testing.assert_array_equal(
        tres.s2d_stem_kernel_inverse(torch.tensor(k2)).numpy(),
        np.asarray(jres.s2d_stem_kernel_inverse(jnp.asarray(k2))))
    np.testing.assert_array_equal(
        tres.s2d_stem_kernel_inverse(got).numpy(), k7)


def test_the_two_stems_compute_the_same_function():
    """The JAX twin is `tests/test_resnet.py`'s exact-equivalence test:
    the s2d stem with the transformed Keras kernel is the Keras stem."""
    kw = dict(stage_sizes=(2, 2), num_classes=10, width_multiplier=0.25,
              device="cpu")
    keras = tres.ResNet(**kw)
    s2d = tres.ResNet(**kw, stem="space_to_depth")
    sd = keras.state_dict()
    sd["stem_conv.weight"] = tres.s2d_stem_kernel(
        sd["stem_conv.weight"].permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
    s2d.load_state_dict(sd)
    x = torch.tensor(_images((2, 64, 64, 3)))
    with torch.no_grad():
        for train in (False, True):
            assert _rel(s2d(x, train=train), keras(x, train=train)) <= 1e-5
    with pytest.raises(ValueError, match="even padded"):
        s2d(torch.zeros(1, 65, 65, 3))


def test_bridge_round_trip_is_exact():
    x = _images()
    _, params, stats, tm = _bridged("ResNet50", x, stem="space_to_depth",
                                    **NARROW)
    got_params, got_stats = resnet_params_to_jax(tm.state_dict())
    for got, want in ((got_params, params), (got_stats, stats)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        jax.tree.map(np.testing.assert_array_equal, got, want)
    assert tm.stem_conv.weight.shape == (64 // 8, 12, 4, 4)
    assert tm.stem_conv.weight.is_contiguous(
        memory_format=torch.channels_last)


# ------------------------------------------------------------- the trainer
def _trainers(optimizer, lr, data, model_kw=None, **kw):
    """A JAX and a port Trainer on one bridged tiny ResNet."""
    model_kw = model_kw or {}
    jtr = JaxTrainer(jres.tiny_resnet(**model_kw), optimizer=optimizer,
                     learning_rate=lr, seed=0, **kw.pop("jax", {}), **kw)
    jtr.init_state(data.batch(0))
    tm = tres.tiny_resnet(device="cpu", **model_kw)
    tm.load_state_dict(resnet_params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params),
        jax.tree.map(np.asarray, jtr.state.batch_stats)))
    return jtr, tm


def _assert_state_close(jtr, tm, param_atol, stats_atol):
    want_params = jax.tree.map(np.asarray, jtr.state.params)
    want_stats = jax.tree.map(np.asarray, jtr.state.batch_stats)
    got_params, got_stats = resnet_params_to_jax(tm.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=param_atol), got_params, want_params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=stats_atol), got_stats, want_stats)


def test_train_1step_observables_match_jax():
    """`__graft_entry__._train_1step`: one SGD step at lr 0.005 on 32x32
    synthetic images over 100 classes, with the gradient norm logged."""
    cfg = dict(batch_size=8, image_size=32, num_classes=100, seed=0)
    jtr, tm = _trainers("sgd", 0.005, JaxImages(**cfg),
                        model_kw=dict(num_classes=100), log_grad_norm=True)
    tr = Trainer(tm, optimizer="sgd", learning_rate=0.005, seed=0,
                 log_grad_norm=True, device="cpu")
    jh = jtr.fit(JaxImages(**cfg), epochs=1, steps_per_epoch=1, verbose=0)
    th = tr.fit(SyntheticImageClassification(**cfg), epochs=1,
                steps_per_epoch=1, verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(th.history["grad_norm"],
                               jh.history["grad_norm"], rtol=1e-4)
    _assert_state_close(jtr, tm, 1e-5, 1e-5)


def test_three_adam_steps_match_jax():
    cfg = dict(batch_size=8, image_size=32, num_classes=10, seed=1)
    lr, steps = 1e-3, 3
    jtr, tm = _trainers("adam", lr, JaxImages(**cfg))
    tr = Trainer(tm, optimizer="adam", learning_rate=lr, device="cpu")
    jh = jtr.fit(JaxImages(**cfg), epochs=steps, steps_per_epoch=1,
                 verbose=0)
    th = tr.fit(SyntheticImageClassification(**cfg), epochs=steps,
                steps_per_epoch=1, verbose=0)
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(th.history["accuracy"],
                               jh.history["accuracy"], atol=1e-6)
    # The buffers follow the batch statistics of parameters that may be
    # 2·lr·steps apart (a conv bias before BatchNorm has a gradient of
    # rounding noise only, which Adam turns into ±lr steps).
    _assert_state_close(jtr, tm, 2 * lr * steps, 2 * lr * steps)


def test_fit_with_eval_transform_and_validation_matches_jax():
    """Rescale-only augment (deterministic, so both packages draw
    nothing), 36x36 validation images center-cropped to 32, and
    `predict` through the same transform; sgd, whose steps follow the
    gradients (Adam's sign sensitivity is the test above's)."""
    cfg = dict(batch_size=8, image_size=32, num_classes=10, seed=2)
    val_cfg = dict(cfg, image_size=36)
    jtr, tm = _trainers(
        "sgd", 0.05, JaxImages(**cfg),
        augment=jax_standard_augment(crop=None, flip=False),
        eval_transform=jax_standard_eval_transform(crop=32))
    tr = Trainer(tm, optimizer="sgd", learning_rate=0.05, device="cpu",
                 augment=standard_augment(crop=None, flip=False),
                 eval_transform=standard_eval_transform(crop=32))
    jh = jtr.fit(JaxImages(**cfg), epochs=2, steps_per_epoch=2,
                 validation_data=JaxImages(**val_cfg).with_offset(50),
                 validation_steps=2, verbose=0)
    th = tr.fit(SyntheticImageClassification(**cfg), epochs=2,
                steps_per_epoch=2,
                validation_data=SyntheticImageClassification(
                    **val_cfg).with_offset(50),
                validation_steps=2, verbose=0)
    assert set(th.history) == set(jh.history)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(th.history[key], jh.history[key],
                                   rtol=1e-5)
    for key in ("accuracy", "val_accuracy"):
        np.testing.assert_allclose(th.history[key], jh.history[key],
                                   atol=1e-6)
    images = JaxImages(**val_cfg).batch(7)["image"]
    np.testing.assert_allclose(tr.predict(images), jtr.predict(images),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("cfg", [
    dict(batch_size=3, image_size=17, num_classes=5, seed=0),
    dict(batch_size=8, image_size=32, channels=1, num_classes=1000, seed=4,
         signal_strength=2.5),
    dict(batch_size=8, image_size=9, num_classes=10, seed=2,
         process_index=1, process_count=4, index_offset=7,
         signal_strength=0.0),
])
def test_synthetic_images_equal_jax_bitwise(cfg):
    ours, theirs = SyntheticImageClassification(**cfg), JaxImages(**cfg)
    for index in (0, 1, 11):
        a, b = ours.batch(index), theirs.batch(index)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    first = next(iter(ours.with_offset(4)))
    np.testing.assert_array_equal(first["image"], theirs.batch(4)["image"])


def test_resnet_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    model = tres.tiny_resnet(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tres.ResNet50()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    assert Trainer(model, device="cpu").device.type == "cpu"


def test_axis_name_is_refused():
    """Every mesh axis is ported: BatchNorm reduces over the named axis's
    group of the strategy's mesh (``"data"``: the data group,
    ``tests/test_torch_strategies.py``; ``"seq"`` over two processes
    against the JAX ``shard_map`` twin,
    ``tests/test_torch_sequence_parallel.py``). Alone, any axis
    normalizes each batch as ``None`` does, as the JAX model over an axis
    of one device does; a name that is no mesh axis is refused."""
    x = _images((4, 16, 16, 3))
    jm = jres.tiny_resnet(axis_name="model")
    v = jm.init(jax.random.key(1), jnp.asarray(x[:1]), train=False)
    mesh = jax_build_mesh(JaxMeshConfig(data=1), devices=jax.devices()[:1])
    want, _ = jax_shard_map(
        lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))(
            v, jnp.asarray(x))
    models = [tres.tiny_resnet(device="cpu", axis_name=name, seed=1)
              for name in (None, "data", "model", "seq")]
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    for m in models:
        m.load_state_dict(resnet_params_from_jax(params, stats))
    out = [m(torch.tensor(x)) for m in models]
    for o in out[1:]:
        assert torch.equal(out[0], o)
    np.testing.assert_allclose(out[2].detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="names no mesh axis"):
        tres.tiny_resnet(device="cpu", axis_name="batch")
