"""ResNet family in PyTorch with ``tf.keras.applications`` architecture
parity (the port of :mod:`pddl_tpu.models.resnet`).

The model takes the data's own layout, NHWC f32 images ``[B, H, W, C]``,
and returns f32 logits (or, with ``num_classes=0``, the pooled features).
Inside, ``x.permute(0, 3, 1, 2)`` turns the NHWC batch into an NCHW view
whose memory is already ``channels_last``; the conv weights are stored
``channels_last`` too, so cuDNN runs NHWC kernels and the step never
copies to NCHW.

Flax semantics kept:

- ``Conv`` keeps its bias before BatchNorm (Keras ``use_bias=True``), and
  ``padding="SAME"`` is TF's rule: at stride 2 on an even input a 3x3
  conv pads 0 before and 1 after (``F.pad``), which torch's symmetric
  ``padding=1`` would get wrong;
- parameters live in ``param_dtype`` and are cast to the compute
  ``dtype`` at each call (bf16 compute over f32 parameters);
- :class:`BatchNorm` is flax's, not ``nn.BatchNorm2d``'s: statistics in
  f32 with the *biased* variance, running averages updated as
  ``ra = m·ra + (1 − m)·stat`` (Keras momentum 0.99, eps 1.001e-5), and
  ``bn_mode="frozen"`` normalizes with the running averages in training
  too and never updates them;
- initializers: conv kernels ``he_normal`` (flax's truncated normal of
  variance 2/fan_in), the head ``glorot_uniform``, biases 0, BatchNorm
  scale 1, bias 0, mean 0, var 1 — drawn from a ``torch.Generator``
  seeded with ``seed``.

Per-replica BatchNorm over a named axis (``axis_name``) belongs to the
distributed strategies (ROADMAP.md queue 1 item 7) and is refused.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from pddl_tpu_torch.device import resolve_device

# Keras BN hyper-parameters (keras.applications.resnet: epsilon 1.001e-5).
BN_EPSILON = 1.001e-5
BN_MOMENTUM = 0.99

# flax's truncated-normal initializers divide the stddev by the std of a
# unit normal truncated to [-2, 2], so the draws keep the asked variance.
_TRUNC_STD = 0.87962566103423978


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` (square kernel, with bias) over NCHW tensors in
    ``channels_last`` memory. ``padding`` is ``"SAME"`` or an int: zeros
    on every side, then a VALID conv (the Keras stem's explicit pad)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, *,
                 stride: int = 1, padding: Union[str, int] = "SAME", dtype,
                 param_dtype, device):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel, dtype=param_dtype,
            device=device, memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(out_channels, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        pad, stride = self.padding, self.stride
        if self.kernel == 1 and stride > 1 and x.device.type == "cpu":
            # The same function as a strided 1x1 conv, whose backward on
            # a channels_last CPU tensor corrupts the heap in torch's CPU
            # build; the card runs the strided conv.
            x, stride = x[:, :, ::stride, ::stride], 1
        if pad == "SAME":
            top, bottom = _same_pads(x.shape[2], self.kernel, stride)
            left, right = _same_pads(x.shape[3], self.kernel, stride)
            if top != bottom or left != right:
                x = F.pad(x, (left, right, top, bottom))
                pad = 0
            else:
                pad = (top, left)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride, pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW tensor.

    In training (``train=True`` and not ``frozen``) it normalizes with the
    batch's statistics, taken in f32 whatever the input's type
    (``torch.native_batch_norm``: ATen's batch-norm kernels, which keep
    for the backward only the bf16 activation and the per-channel f32
    mean and inverse std), and updates its f32 buffers
    by flax's rule with the biased variance. Otherwise it normalizes with
    the buffers and leaves them as they are; scale and bias stay
    differentiable either way. The output has the input's type: the
    affine runs in f32 and is rounded once, as flax computes it.
    """

    def __init__(self, features: int, *, momentum: float = BN_MOMENTUM,
                 frozen: bool = False, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.momentum, self.frozen = momentum, frozen
        self.weight = nn.Parameter(torch.ones(features, dtype=param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device))
        self.register_buffer("running_mean", torch.zeros(
            features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if not train or self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                BN_EPSILON)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, BN_EPSILON)
        with torch.no_grad():
            var = (invstd.double().pow(-2) - BN_EPSILON).clamp_min(0.0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.float(), alpha=1.0 - m)
        return y


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152).

    ``stride_in_3x3=False`` matches Keras v1 (downsample in the first
    1x1); ``True`` is the v1.5 placement (torchvision, MLPerf).
    """

    expansion = 4

    def __init__(self, in_channels: int, filters: int, *, stride: int = 1,
                 conv_shortcut: bool = False, stride_in_3x3: bool = False,
                 conv, norm):
        super().__init__()
        s1 = 1 if stride_in_3x3 else stride
        s3 = stride if stride_in_3x3 else 1
        out = 4 * filters
        if conv_shortcut:
            self.shortcut_conv = conv(in_channels, out, 1, stride=stride)
            self.shortcut_bn = norm(out)
        self.conv1 = conv(in_channels, filters, 1, stride=s1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride=s3)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, out, 1)
        self.bn3 = norm(out)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        shortcut = x
        if hasattr(self, "shortcut_conv"):
            shortcut = self.shortcut_bn(self.shortcut_conv(x), train)
        y = F.relu(self.bn1(self.conv1(x), train), inplace=True)
        y = F.relu(self.bn2(self.conv2(y), train), inplace=True)
        y = self.bn3(self.conv3(y), train)
        return F.relu(y + shortcut, inplace=True)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34); ``stride_in_3x3`` is
    accepted for a uniform block signature and unused."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, *, stride: int = 1,
                 conv_shortcut: bool = False, stride_in_3x3: bool = False,
                 conv, norm):
        super().__init__()
        if conv_shortcut:
            self.shortcut_conv = conv(in_channels, filters, 1, stride=stride)
            self.shortcut_bn = norm(filters)
        self.conv1 = conv(in_channels, filters, 3, stride=stride)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3)
        self.bn2 = norm(filters)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        shortcut = x
        if hasattr(self, "shortcut_conv"):
            shortcut = self.shortcut_bn(self.shortcut_conv(x), train)
        y = F.relu(self.bn1(self.conv1(x), train), inplace=True)
        y = self.bn2(self.conv2(y), train)
        return F.relu(y + shortcut, inplace=True)


class ResNet(nn.Module):
    """Configurable ResNet with Keras-v1 architecture parity.

    The options are the JAX package's: ``num_classes`` (0 returns the
    pooled features), ``width_multiplier`` (a stage of ``f`` filters gets
    ``max(8, int(f·m))``), ``stride_in_3x3``, ``small_input_stem`` (3x3/s1
    stem, no max-pool), ``stem`` (``"keras"``: pad 3, 7x7/s2 VALID, pad 1,
    3x3/s2 max-pool; ``"space_to_depth"``: the same function as a 4x4/s1
    conv over the block-2 space-to-depth view of the padded input),
    ``dtype`` (compute), ``param_dtype``, ``bn_mode`` (``"train"`` or
    ``"frozen"``) and ``bn_momentum``. The images are RGB (flax infers
    the channels at init; the reference's are 3). ``device=None`` means
    ``cuda``; a host without a card must pass ``device="cpu"``.
    """

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module] = BottleneckBlock,
                 num_classes: int = 1000, width_multiplier: float = 1.0,
                 stride_in_3x3: bool = False, small_input_stem: bool = False,
                 stem: str = "keras", dtype=torch.float32,
                 param_dtype=torch.float32, bn_mode: str = "train",
                 bn_momentum: float = BN_MOMENTUM,
                 axis_name: Optional[str] = None, device=None,
                 seed: int = 0):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                f"axis_name={axis_name!r} (per-replica BatchNorm) is not "
                "ported yet: ROADMAP.md queue 1 item 7 (distributed)")
        if bn_mode not in ("train", "frozen"):
            raise ValueError(f"unknown bn_mode {bn_mode!r}")
        if stem not in ("keras", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        if small_input_stem and stem != "keras":
            raise ValueError(
                f"small_input_stem=True conflicts with stem={stem!r}: "
                "the small 3x3/s1 stem would silently win; pick one")
        device = resolve_device(device)
        self.num_classes = num_classes
        self.small_input_stem = small_input_stem
        self.stem = stem
        self.dtype = dtype
        conv = functools.partial(Conv, dtype=dtype, param_dtype=param_dtype,
                                 device=device)
        norm = functools.partial(BatchNorm, momentum=bn_momentum,
                                 frozen=bn_mode == "frozen",
                                 param_dtype=param_dtype, device=device)

        def width(f):
            return max(8, int(f * width_multiplier))

        if small_input_stem:
            self.stem_conv = conv(3, width(64), 3)
        elif stem == "space_to_depth":
            self.stem_conv = conv(12, width(64), 4, padding=0)  # 2x2 x RGB
        else:  # Keras: ZeroPadding(3), then a 7x7/s2 VALID conv
            self.stem_conv = conv(3, width(64), 7, stride=2, padding=3)
        self.stem_bn = norm(width(64))
        self.blocks = nn.ModuleDict()
        channels = width(64)
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width(64 * 2 ** stage)
            for block in range(n_blocks):
                self.blocks[f"stage{stage + 1}_block{block + 1}"] = block_cls(
                    channels, filters,
                    stride=2 if (stage > 0 and block == 0) else 1,
                    conv_shortcut=block == 0, stride_in_3x3=stride_in_3x3,
                    conv=conv, norm=norm)
                channels = filters * block_cls.expansion
        if num_classes:
            self.head = nn.Linear(channels, num_classes, dtype=param_dtype,
                                  device=device)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.stem_conv.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw every weight from a generator seeded with ``seed`` and
        reset the BatchNorm buffers."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for module in self.modules():
            if isinstance(module, Conv):
                fan_in = module.weight[0].numel()
                std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        if self.num_classes:
            fan_out, fan_in = self.head.weight.shape
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            self.head.weight.uniform_(-limit, limit, generator=gen)
            self.head.bias.zero_()

    def _stem(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """NHWC images in the compute type -> the stem's NCHW
        (``channels_last``) output."""
        if self.stem == "space_to_depth":
            # With X the 3-padded input, the 7x7/s2 stem is a 4x4/s1 conv
            # over Y(r, c, (p, q, ch)) = X(2r + p, 2c + q, ch).
            x = F.pad(x, (0, 0, 3, 3, 3, 3))
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"space_to_depth stem needs even padded input dims, "
                    f"got {h}x{w} (input {h - 6}x{w - 6})")
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = F.relu(self.stem_bn(x, train), inplace=True)
        if self.small_input_stem:
            return x
        # Keras zero-pads by 1 and max-pools 3x3/s2 VALID. The input is
        # post-ReLU (>= 0), so the max-pool's own padding, which never
        # wins a window that holds a real value, gives the same output.
        return F.max_pool2d(x, 3, 2, padding=1)

    def forward(self, x: torch.Tensor, *, train: bool = True) -> torch.Tensor:
        """NHWC images ``[B, H, W, C]`` -> f32 logits ``[B, num_classes]``
        (pooled features ``[B, C]`` with ``num_classes=0``)."""
        x = self._stem(x.to(self.dtype), train)
        for block in self.blocks.values():
            x = block(x, train)
        x = x.mean(dim=(2, 3))  # global average pool ('avg' pooling)
        if self.num_classes:
            dt = self.dtype
            x = F.linear(x, self.head.weight.to(dt), self.head.bias.to(dt))
        return x.float()


def s2d_stem_kernel(k7: torch.Tensor) -> torch.Tensor:
    """Exact transform of a 7x7 stem kernel to the space-to-depth stem, in
    the flax layout ``[7, 7, C, F] -> [4, 4, 4C, F]``: zero-pad to 8x8 at
    the trailing edge, then regroup ``K8(2a+p, 2b+q, ch)`` into
    ``K2(a, b, (p, q, ch))`` — so the ``space_to_depth`` stem computes
    exactly the ``keras`` stem."""
    kh, kw, c, f = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {tuple(k7.shape)}")
    k8 = F.pad(k7, (0, 0, 0, 0, 0, 1, 0, 1))
    k2 = k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return k2.reshape(4, 4, 4 * c, f)


def s2d_stem_kernel_inverse(k2: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d_stem_kernel`: ``[4, 4, 4C, F] -> [7, 7, C,
    F]``. The 8th row and column are dropped: zero for a transformed
    kernel, and for a trained one the taps the 7x7 stem cannot see."""
    kh, kw, c4, f = k2.shape
    if (kh, kw) != (4, 4) or c4 % 4:
        raise ValueError(
            f"expected a 4x4x(4C) s2d stem kernel, got {tuple(k2.shape)}")
    c = c4 // 4
    k8 = k2.reshape(4, 4, 2, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return k8.reshape(8, 8, c, f)[:7, :7]


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3),
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=(3, 8, 36, 3),
                              block_cls=BottleneckBlock)


def tiny_resnet(num_classes: int = 10, **kwargs) -> ResNet:
    """A miniature ResNet for tests and dry runs."""
    kwargs.setdefault("stage_sizes", (1, 1))
    kwargs.setdefault("block_cls", BasicBlock)
    kwargs.setdefault("width_multiplier", 0.125)
    kwargs.setdefault("small_input_stem", True)
    return ResNet(num_classes=num_classes, **kwargs)
