"""Image preprocessing and augmentation on the device, for the train step
(the port of :mod:`pddl_tpu.ops.augment`).

Parity with the reference's preprocessing stack:

- ``Rescaling(1./255)`` → :func:`rescale`;
- ``RandomCrop`` → :func:`random_crop`, with the intended semantics (a
  crop no larger than the input, padding first if it is smaller) rather
  than the reference's 244-on-224 upscale, as the JAX package does;
- ``RandomFlip("horizontal")`` → :func:`random_flip_horizontal`;
- ``tf.image.resize_with_crop_or_pad`` → :func:`center_crop_or_pad`.

Images are ``[B, H, W, C]`` tensors (NHWC, the data's layout). Randomness
comes from an explicit ``torch.Generator`` on the images' device, so an
augment is ``fn(generator, images)``, the counterpart of the JAX
``fn(rng, images)``: the per-image crop offsets and flip mask are drawn
there, and the crop is one gather with no loop over the batch. The JAX
package's ``jax.random`` bits cannot be reproduced; the same seed gives
the same draws here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def rescale(x: torch.Tensor, scale: float = 1.0 / 255,
            offset: float = 0.0) -> torch.Tensor:
    return x * scale + offset


def _crop_or_pad_axis(x: torch.Tensor, axis: int, target: int
                      ) -> torch.Tensor:
    cur = x.shape[axis]
    if cur > target:
        return x.narrow(axis, (cur - target) // 2, target)
    if cur < target:
        before = (target - cur) // 2
        pad = [0, 0] * (x.ndim - axis)
        # F.pad lists (before, after) pairs from the last dim backwards.
        pad[-2:] = [before, target - cur - before]
        return F.pad(x, pad)
    return x


def center_crop_or_pad(x: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """``tf.image.resize_with_crop_or_pad`` on ``[..., H, W, C]``: a
    central crop where larger, zero padding where smaller, the odd extra
    pixel bottom and right, as TF puts it."""
    x = _crop_or_pad_axis(x, x.ndim - 3, height)
    return _crop_or_pad_axis(x, x.ndim - 2, width)


def random_crop(generator: torch.Generator, x: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Per-image random crop of a ``[B, H, W, C]`` batch (padded first if
    smaller): each image's top-left corner is drawn uniformly from the
    in-range offsets."""
    if x.shape[-3] < height or x.shape[-2] < width:
        x = center_crop_or_pad(x, max(height, x.shape[-3]),
                               max(width, x.shape[-2]))
    b, h, w, _ = x.shape
    top = torch.randint(0, h - height + 1, (b,), generator=generator,
                        device=x.device)
    left = torch.randint(0, w - width + 1, (b,), generator=generator,
                         device=x.device)
    rows = top[:, None] + torch.arange(height, device=x.device)
    cols = left[:, None] + torch.arange(width, device=x.device)
    batch = torch.arange(b, device=x.device)[:, None, None]
    return x[batch, rows[:, :, None], cols[:, None, :]]


def random_flip_horizontal(generator: torch.Generator,
                           x: torch.Tensor) -> torch.Tensor:
    """Per-image horizontal flip with p=0.5 on ``[B, H, W, C]``."""
    flip = torch.rand(x.shape[0], generator=generator,
                      device=x.device) < 0.5
    return torch.where(flip[:, None, None, None], x.flip(-2), x)


def standard_augment(crop: Optional[int] = 224, flip: bool = True,
                     rescale_factor: Optional[float] = 1.0 / 255
                     ) -> Callable[[torch.Generator, torch.Tensor],
                                   torch.Tensor]:
    """The reference's augmentation stack, Rescaling -> RandomCrop ->
    RandomFlip, as one ``fn(generator, images)``."""

    def _augment(generator: torch.Generator,
                 x: torch.Tensor) -> torch.Tensor:
        if rescale_factor is not None:
            x = rescale(x, rescale_factor)
        if crop is not None:
            x = random_crop(generator, x, crop, crop)
        if flip:
            x = random_flip_horizontal(generator, x)
        return x

    return _augment


def standard_eval_transform(crop: Optional[int] = 224,
                            rescale_factor: Optional[float] = 1.0 / 255
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic eval/predict counterpart of
    :func:`standard_augment`: rescale, then a center crop or pad."""

    def _transform(x: torch.Tensor) -> torch.Tensor:
        if rescale_factor is not None:
            x = rescale(x, rescale_factor)
        if crop is not None:
            x = center_crop_or_pad(x, crop, crop)
        return x

    return _transform
