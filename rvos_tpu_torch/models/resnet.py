"""ResNet-101 backbone for DeepLabv3+ (PyTorch port of
``rvos_tpu/models/resnet.py``): bottleneck ResNet at output stride 16
(strides [1,2,2,1], dilations [1,1,1,2]), multi-grid (1, 2, 4) in
layer4, layer1's output exposed as the low-level feature.  The batch
norms are frozen: affine and running statistics are buffers."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class ResNetBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(planes * 4))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class ResNet101(nn.Module):
    """Returns (stride-16 features [N, 2048, ..], low-level stride-4
    features [N, 256, ..])."""

    def __init__(self, output_stride: int = 16):
        super().__init__()
        if output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        elif output_stride == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        else:
            raise NotImplementedError(output_stride)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        specs = ((64, 3, None), (128, 4, None), (256, 23, None),
                 (512, 3, (1, 2, 4)))
        for li, (planes, n, grid) in enumerate(specs):
            blocks = []
            for i in range(n):
                d = dilations[li] * (grid[i] if grid else 1)
                s = strides[li] if i == 0 else 1
                ds = i == 0 and (strides[li] != 1 or inplanes != planes * 4)
                blocks.append(ResNetBottleneck(inplanes, planes, s, d, ds))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        low = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(low)))
        return x, low
