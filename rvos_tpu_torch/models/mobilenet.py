"""MobileNetV2 backbone (PyTorch port of ``rvos_tpu/models/mobilenet.py``),
the reference's alternative to ResNet-101 (``MODEL_BACKBONE="mobilenet"``).

Inverted-residual tower at output stride 16: once the stride reaches 16,
a block's stride becomes dilation.  Returns the 320-channel features and
the 24-channel stride-4 stage as the low-level pair.  Module names are
the JAX package's (``stem``, ``block_{i}`` with ``expand``, ``depthwise``,
``project``, ``project_bn``), so ``weights.from_jax_params`` maps its
parameters with the generic rule; a flax depthwise kernel
``(3, 3, 1, hidden)`` becomes the ``(hidden, 1, 3, 3)`` weight of a conv
with ``groups=hidden``.  Batch norms are frozen, as in the ResNet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from .resnet import FrozenBatchNorm2d

# (expand ratio, output channels, blocks, first block's stride)
_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class _ConvBN(nn.Module):
    """Conv (no bias) + frozen BN + relu6."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=pad, dilation=dilation, groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    """1×1 expand (when ``expand`` > 1) → 3×3 depthwise → 1×1 linear
    projection, with the identity added when shapes allow."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 expand: int = 6, dilation: int = 1):
        super().__init__()
        hidden = in_ch * expand
        self.use_res = stride == 1 and in_ch == out_ch
        self.expand = _ConvBN(in_ch, hidden, 1) if expand != 1 else None
        self.depthwise = _ConvBN(hidden, hidden, 3, stride, dilation,
                                 groups=hidden)
        self.project = nn.Conv2d(hidden, out_ch, 1, bias=False)
        self.project_bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.project_bn(self.project(self.depthwise(y)))
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """[N, 3, H, W] → (features [N, 320, H/16, W/16], low-level
    [N, 24, H/4, W/4])."""

    def __init__(self, output_stride: int = 16):
        super().__init__()
        self.stem = _ConvBN(3, 32, 3, 2)
        stride, dilation, in_ch, idx = 2, 1, 32, 0
        self.low_level_block = None
        for t, c, n, s in _STAGES:
            for i in range(n):
                st = s if i == 0 else 1
                if stride >= output_stride and st > 1:
                    dilation *= st
                    st = 1
                else:
                    stride *= st
                setattr(self, f"block_{idx}",
                        InvertedResidual(in_ch, c, st, t, dilation))
                in_ch = c
                idx += 1
            if c == 24:
                self.low_level_block = idx - 1
        self.n_blocks = idx

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        low = None
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
            if i == self.low_level_block:
                low = x
        return x, low
