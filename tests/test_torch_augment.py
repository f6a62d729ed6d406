"""The port's augmentation (`pddl_tpu_torch/ops/augment.py`), the
trainer's `augment` hook and its callbacks
(`pddl_tpu_torch/train/callbacks.py`) against the JAX package on the CPU.

- `rescale` and `center_crop_or_pad` equal the JAX functions exactly, at
  odd and even sizes, larger and smaller than the target;
- `random_crop`: each output image is `jax.lax.dynamic_slice` of its
  (padded) input at an in-range offset, offsets differ across the batch,
  and one seed gives one draw (`jax.random`'s bits are not reproduced);
- `random_flip_horizontal`: each output image is its input or the input's
  flip, and both appear over a batch;
- the trainer seeds each step's augment generator from
  `(seed + 1, step)`: a rerun with the same seed draws the same, another
  step or seed draws otherwise; a batch already on the trainer's device
  is used as it is;
- callbacks: the same `val_loss` sequence gives the same learning-rate
  changes and the same stop epoch from the JAX callbacks and the port's;
  `fit` runs the hooks in the JAX trainer's order, honours
  `stop_training` mid-epoch, sweeps `on_train_end` over every callback
  before re-raising the first error, and `restore_best_weights` restores
  the parameters and the BatchNorm buffers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pddl_tpu.ops.augment as jaug
import pddl_tpu.train.callbacks as jcb
import pddl_tpu_torch.ops.augment as taug
import pddl_tpu_torch.train.callbacks as tcb
from pddl_tpu.data.synthetic import SyntheticImageClassification as JaxImages
from pddl_tpu.models.resnet import tiny_resnet as jax_tiny_resnet
from pddl_tpu.train.loop import Trainer as JaxTrainer
from pddl_tpu.train.state import get_learning_rate as jax_get_lr
from pddl_tpu_torch.data.synthetic import SyntheticImageClassification
from pddl_tpu_torch.models.resnet import tiny_resnet
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.state import get_learning_rate

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

IMAGES = dict(batch_size=4, image_size=16, num_classes=10, seed=0)


def _batch(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------ deterministic
@pytest.mark.parametrize("shape,target", [
    ((2, 7, 10, 3), (5, 5)),     # crop odd and even
    ((2, 7, 10, 3), (9, 13)),    # pad: odd extra pixel bottom and right
    ((2, 8, 9, 1), (4, 12)),     # crop one dim, pad the other
    ((2, 8, 9, 1), (8, 9)),      # unchanged
    ((6, 5, 2), (3, 8)),         # one image, [H, W, C]
])
def test_center_crop_or_pad_equals_jax(shape, target):
    x = _batch(shape)
    want = np.asarray(jaug.center_crop_or_pad(jnp.asarray(x), *target))
    got = taug.center_crop_or_pad(torch.tensor(x), *target).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,offset", [(1.0 / 255, 0.0), (2.0, -1.0)])
def test_rescale_and_eval_transform_equal_jax(scale, offset):
    x = _batch((2, 9, 9, 3)) * 255
    np.testing.assert_array_equal(
        taug.rescale(torch.tensor(x), scale, offset).numpy(),
        np.asarray(jaug.rescale(jnp.asarray(x), scale, offset)))
    np.testing.assert_array_equal(
        taug.standard_eval_transform(crop=6, rescale_factor=scale)(
            torch.tensor(x)).numpy(),
        np.asarray(jaug.standard_eval_transform(
            crop=6, rescale_factor=scale)(jnp.asarray(x))))


# ------------------------------------------------------------------ random
def _offsets_of(img, src, height, width):
    """Every offset at which ``img`` is ``dynamic_slice`` of ``src``."""
    h, w = src.shape[0], src.shape[1]
    return [(t, l) for t in range(h - height + 1) for l in range(w - width + 1)
            if np.array_equal(img, np.asarray(jax.lax.dynamic_slice(
                jnp.asarray(src), (t, l, 0), (height, width, src.shape[2]))))]


@pytest.mark.parametrize("shape,crop", [((16, 12, 12, 3), 8),
                                        ((6, 5, 7, 2), 9)])
def test_random_crop_is_a_dynamic_slice_at_an_in_range_offset(shape, crop):
    x = _batch(shape)
    gen = torch.Generator().manual_seed(5)
    got = taug.random_crop(gen, torch.tensor(x), crop, crop).numpy()
    again = taug.random_crop(torch.Generator().manual_seed(5),
                             torch.tensor(x), crop, crop).numpy()
    np.testing.assert_array_equal(got, again)
    assert got.shape == (shape[0], crop, crop, shape[3])
    # An input smaller than the crop is padded first, as in JAX.
    src = np.asarray(jaug.center_crop_or_pad(
        jnp.asarray(x), max(crop, shape[1]), max(crop, shape[2])))
    offsets = set()
    for img, s in zip(got, src):
        found = _offsets_of(img, s, crop, crop)
        assert found, "an output image is no in-range crop of its input"
        offsets.update(found)
    if shape[1] > crop:
        assert len(offsets) > 1


def test_random_flip_gives_each_image_or_its_flip_and_both_appear():
    x = _batch((32, 5, 6, 2))
    got = taug.random_flip_horizontal(torch.Generator().manual_seed(0),
                                      torch.tensor(x)).numpy()
    flipped = np.asarray(jnp.flip(jnp.asarray(x), axis=-2))
    same = [np.array_equal(g, a) for g, a in zip(got, x)]
    flip = [np.array_equal(g, f) for g, f in zip(got, flipped)]
    assert all(s or f for s, f in zip(same, flip))
    assert any(same) and any(flip)


def test_standard_augment_rescales_crops_and_flips():
    x = _batch((8, 10, 10, 3)) * 255
    fn = taug.standard_augment(crop=8)
    got = fn(torch.Generator().manual_seed(1), torch.tensor(x)).numpy()
    assert got.shape == (8, 8, 8, 3)
    src = np.asarray(jaug.rescale(jnp.asarray(x)))
    for img, s in zip(got, src):
        assert _offsets_of(img, s, 8, 8) or _offsets_of(img[:, ::-1], s, 8, 8)


# ----------------------------------------------------------- the trainer
def _recording_augment(draws):
    def augment(generator, images):
        draws.append(torch.randint(0, 2**30, (4,), generator=generator,
                                   device=images.device).tolist())
        return images
    return augment


def test_trainer_seeds_the_augment_from_seed_and_step():
    runs = []
    for seed in (0, 0, 1):
        draws = []
        tr = Trainer(tiny_resnet(device="cpu"), seed=seed, device="cpu",
                     augment=_recording_augment(draws))
        tr.fit(SyntheticImageClassification(**IMAGES), epochs=1,
               steps_per_epoch=3, verbose=0)
        runs.append(draws)
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert len({tuple(d) for d in runs[0]}) == 3


def test_a_batch_on_the_device_is_used_as_it_is():
    tr = Trainer(tiny_resnet(device="cpu"), device="cpu",
                 augment=taug.standard_augment(crop=12))
    batch = SyntheticImageClassification(**IMAGES).batch(0)
    on_device = {k: torch.as_tensor(v) for k, v in batch.items()}
    assert tr._tensor(on_device["image"]) is on_device["image"]
    logs = tr.train_step(on_device)
    assert np.isfinite(float(logs["loss"]))
    assert tr.predict(on_device["image"]).shape == (4, 10)


# ---------------------------------------------------------------- callbacks
VAL_LOSSES = [1.0, 0.9, 0.95, 0.91, 0.905, 0.9, 0.92, 0.5, 0.51, 0.52,
              0.5005, 0.53, 0.6, 0.7]


def test_callbacks_follow_the_jax_callbacks_on_one_val_loss_sequence():
    data = JaxImages(**IMAGES)
    jtr = JaxTrainer(jax_tiny_resnet(), learning_rate=1e-2)
    jtr.init_state(data.batch(0))
    tr = Trainer(tiny_resnet(device="cpu"), learning_rate=1e-2,
                 device="cpu")
    kw_lr = dict(factor=0.5, patience=2, min_lr=2e-3)
    kw_stop = dict(patience=4)
    jax_cbs = [jcb.ReduceLROnPlateau(**kw_lr), jcb.EarlyStopping(**kw_stop)]
    port_cbs = [tcb.ReduceLROnPlateau(**kw_lr), tcb.EarlyStopping(**kw_stop)]
    for cb in jax_cbs:
        cb.set_trainer(jtr)
    for cb in port_cbs:
        cb.set_trainer(tr)
    jtr.stop_training = tr.stop_training = False
    jax_lrs, port_lrs = [], []
    state = jtr.state
    for epoch, v in enumerate(VAL_LOSSES):
        for cb in jax_cbs:
            state = cb.on_epoch_end(epoch, state, {"val_loss": v}) or state
        for cb in port_cbs:
            cb.on_epoch_end(epoch, {"val_loss": v})
        jax_lrs.append(jax_get_lr(state))
        port_lrs.append(get_learning_rate(tr.optimizer))
        assert tr.stop_training == jtr.stop_training
        if tr.stop_training:
            break
    np.testing.assert_allclose(port_lrs, jax_lrs, rtol=1e-6)
    assert len(set(port_lrs)) > 2
    assert port_cbs[1].stopped_epoch == jax_cbs[1].stopped_epoch is not None


class _Record(tcb.Callback):
    def __init__(self, events, fail_at_end=None, stop_at_step=None):
        self.events, self.fail_at_end = events, fail_at_end
        self.stop_at_step = stop_at_step

    def on_train_begin(self):
        self.events.append("train_begin")

    def on_epoch_begin(self, epoch):
        self.events.append(f"epoch_begin {epoch}")

    def on_train_batch_end(self, step, logs):
        self.events.append(f"batch_end {step}")
        if step == self.stop_at_step:
            self.trainer.stop_training = True

    def on_epoch_end(self, epoch, logs):
        self.events.append(f"epoch_end {epoch} {sorted(logs)}")

    def on_train_end(self, logs):
        self.events.append("train_end")
        if self.fail_at_end:
            raise self.fail_at_end


class _JaxRecord(jcb.Callback):
    def __init__(self, events):
        self.events = events

    def on_train_begin(self, state):
        self.events.append("train_begin")

    def on_epoch_begin(self, epoch, state):
        self.events.append(f"epoch_begin {epoch}")

    def on_train_batch_end(self, step, state, logs):
        self.events.append(f"batch_end {step}")

    def on_epoch_end(self, epoch, state, logs):
        self.events.append(f"epoch_end {epoch} {sorted(logs)}")

    def on_train_end(self, state, logs):
        self.events.append("train_end")


def test_fit_runs_the_hooks_in_the_jax_order():
    data = dict(IMAGES, image_size=8)
    jax_events, port_events = [], []
    JaxTrainer(jax_tiny_resnet()).fit(
        JaxImages(**data), epochs=2, steps_per_epoch=2,
        validation_data=JaxImages(**data), validation_steps=1, verbose=0,
        callbacks=[_JaxRecord(jax_events)])
    Trainer(tiny_resnet(device="cpu"), device="cpu").fit(
        SyntheticImageClassification(**data), epochs=2, steps_per_epoch=2,
        validation_data=SyntheticImageClassification(**data),
        validation_steps=1, verbose=0, callbacks=[_Record(port_events)])
    assert port_events == jax_events
    assert port_events[:4] == ["train_begin", "epoch_begin 0", "batch_end 0",
                               "batch_end 1"]


def test_stop_mid_epoch_and_the_on_train_end_sweep():
    events_a, events_b = [], []
    first, second = RuntimeError("first"), RuntimeError("second")
    tr = Trainer(tiny_resnet(device="cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="first"):
        tr.fit(SyntheticImageClassification(**dict(IMAGES, image_size=8)),
               epochs=3, steps_per_epoch=2, verbose=0,
               callbacks=[_Record(events_a, first, stop_at_step=2),
                          _Record(events_b, second)])
    # Steps 0-1 are epoch 0; step 2 stops epoch 1 mid-way: no epoch-end
    # hook for it, and every callback still gets on_train_end.
    assert events_a == events_b
    assert [e for e in events_a if not e.startswith("epoch_end")] == [
        "train_begin", "epoch_begin 0", "batch_end 0", "batch_end 1",
        "epoch_begin 1", "batch_end 2", "train_end"]
    assert tr.stop_training


def test_early_stopping_restores_parameters_and_batchnorm_buffers():
    data = SyntheticImageClassification(**dict(IMAGES, image_size=8))
    tr = Trainer(tiny_resnet(device="cpu"), learning_rate=1e-2,
                 device="cpu")
    snapshots = []

    class Snapshot(tcb.Callback):
        def on_epoch_end(self, epoch, logs):
            snapshots.append({k: v.clone() for k, v in
                              tr.model.state_dict().items()})

    val = iter([0.5, 0.7, 0.8])
    stop = tcb.EarlyStopping(monitor="score", patience=2,
                             restore_best_weights=True)

    class Score(tcb.Callback):
        def on_epoch_end(self, epoch, logs):
            logs["score"] = next(val)

    hist = tr.fit(data, epochs=5, steps_per_epoch=2, verbose=0,
                  callbacks=[Score(), Snapshot(), stop])
    assert stop.stopped_epoch == 2 and len(hist.history["loss"]) == 3
    best, last = snapshots[0], snapshots[2]
    state = tr.model.state_dict()
    for key, value in best.items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    moved = [k for k in best if not torch.equal(best[k], last[k])]
    assert any(k.endswith("running_mean") for k in moved)
    assert any(k.endswith("weight") for k in moved)
