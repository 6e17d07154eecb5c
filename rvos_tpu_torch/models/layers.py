"""Decoder-side building blocks (PyTorch port of
``rvos_tpu/models/layers.py``), NCHW with the object axis as the batch.

GN, GCT, GNBottleneck, IAGate, GNASPP, ConditioningLayer/Block (top-β
saliency) and DynamicPreHead.  The JAX package's ``ShiftConv3x3``,
``SpaceToDepthConv2`` and ``Conv1x1Stride2`` are TPU layout workarounds
with a plain conv's parameters; here they are ``nn.Conv2d``.  Gate
statistics accumulate in float32 and the gates are cast back to the
activation dtype.

In a bfloat16 tower GCT takes the JAX package's two-stage statistics:
bf16 squares, their bf16 partial sums over 8-wide column chunks (each
accumulated in float32 and rounded once), float32 sums of the partials.
GN stays ``nn.GroupNorm`` (float32 statistics, one rounding of the
output): JAX's folded bf16 form, mirrored, cost 16–20 ms of a 52–57 ms
eval frame and 2.2 GB of the bf16 training step's peak on an H100 and
moved no whole-step comparison (``PERF.md`` §6).
"""

from __future__ import annotations

import torch
from torch import nn


def GN(num_groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(num_groups, channels, eps=1e-5)


class GCT(nn.Module):
    """Gated channel transform, l2 mode."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            # JAX zero-pads the width to a multiple of 8: the last chunk
            # is the sum of the columns left over
            w8 = x.shape[-1] // 8 * 8
            sq = x.square()
            part = sq[..., :w8].unflatten(-1, (-1, 8)).sum(-1)
            sumsq = part.sum(dim=(2, 3), keepdim=True, dtype=torch.float32)
            if w8 < x.shape[-1]:
                tail = sq[..., w8:].sum(-1)
                sumsq = sumsq + tail.sum(-1, keepdim=True,
                                         dtype=torch.float32)[..., None]
        else:
            sumsq = x.float().square().sum(dim=(2, 3), keepdim=True)
        emb = torch.sqrt(sumsq + self.epsilon) * self.alpha.float()
        norm = self.gamma.float() / torch.sqrt(
            emb.square().mean(dim=1, keepdim=True) + self.epsilon)
        gate = 1.0 + torch.tanh(emb * norm + self.beta.float())
        return x * gate.to(x.dtype)


class GNBottleneck(nn.Module):
    """GCT-fronted GroupNorm bottleneck residual."""

    def __init__(self, inplanes: int, outplanes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        planes = outplanes // 4
        self.GCT1 = GCT(inplanes)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = GN(32, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn2 = GN(32, planes)
        self.conv3 = nn.Conv2d(planes, outplanes, 1, bias=False)
        self.bn3 = GN(32, outplanes)
        self.downsample = None
        if stride != 1 or inplanes != outplanes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, outplanes, 1, stride=stride, bias=False))
            self.downsample_gn = GN(32, outplanes)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(self.GCT1(x))))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x
        if self.downsample is not None:
            res = self.downsample_gn(self.downsample(x))
        return torch.relu(out + res)


class IAGate(nn.Module):
    """x · (1 + tanh(Linear(head))) per object channel."""

    def __init__(self, head_dim: int, out_dim: int):
        super().__init__()
        self.IA = nn.Linear(head_dim, out_dim)

    def forward(self, x, head):
        return x * (1.0 + torch.tanh(self.IA(head)))[:, :, None, None]


class _GNASPPModule(nn.Module):
    def __init__(self, inplanes: int, planes: int, kernel_size: int,
                 dilation: int):
        super().__init__()
        pad = 0 if kernel_size == 1 else dilation
        self.GCT = GCT(inplanes)
        self.atrous_conv = nn.Conv2d(inplanes, planes, kernel_size,
                                     padding=pad, dilation=dilation,
                                     bias=False)
        self.bn = GN(planes // 4, planes)

    def forward(self, x):
        return torch.relu(self.bn(self.atrous_conv(self.GCT(x))))


class GNASPP(nn.Module):
    """Calibration-decoder ASPP: 512-in, GN + GCT."""

    def __init__(self, inplanes: int = 512):
        super().__init__()
        self.aspp1 = _GNASPPModule(inplanes, 128, 1, 1)
        self.aspp2 = _GNASPPModule(inplanes, 128, 3, 6)
        self.aspp3 = _GNASPPModule(inplanes, 128, 3, 12)
        self.aspp4 = _GNASPPModule(inplanes, 128, 3, 18)
        self.global_conv = nn.Conv2d(inplanes, 128, 1, bias=False)
        self.GCT = GCT(640)
        self.conv1 = nn.Conv2d(640, 256, 1, bias=False)
        self.bn1 = GN(32, 256)

    def forward(self, x):
        outs = [self.aspp1(x), self.aspp2(x), self.aspp3(x), self.aspp4(x)]
        x5 = torch.relu(self.global_conv(x.mean(dim=(2, 3), keepdim=True)))
        outs.append(x5.expand(-1, -1, outs[0].shape[2], outs[0].shape[3]))
        x = self.GCT(torch.cat(outs, dim=1))
        return torch.relu(self.bn1(self.conv1(x)))


class ConditioningLayer(nn.Module):
    """Eq.(7): saliency top-β mask → GAP over the full support → MLP for
    a spatial input [O, C, H, W]; a vector input [O, C] is the singleton
    case, MLP only."""

    def __init__(self, z_dim: int, out_dim: int, beta_percentage: float = 0.3,
                 spatial: bool = True):
        super().__init__()
        self.beta_percentage = beta_percentage
        if spatial:
            self.phi_layer = nn.Conv2d(z_dim, 1, 1)
        self.mlp_layer = nn.Linear(z_dim, out_dim)

    def forward(self, z):
        if z.dim() == 2:
            return self.mlp_layer(z)
        o, c, h, w = z.shape
        mask = self.top_beta(self.saliency(z))
        pooled = (z.reshape(o, c, h * w) * mask[:, None]).sum(-1) / (h * w)
        return self.mlp_layer(pooled)

    def saliency(self, z):
        """φ of a spatial input [O, C, H, W] → [O, H·W]."""
        o, _, h, w = z.shape
        return self.phi_layer(z).reshape(o, h * w)

    def top_beta(self, phi):
        """The top-β mask of φ [O, N]: 1 where φ is above its β-th largest
        value (strictly, as the reference), per object."""
        beta_rank = max(1, int(self.beta_percentage * phi.shape[-1]))
        kth = torch.topk(phi, beta_rank, dim=-1).values[:, -1:]
        return (phi > kth).to(phi.dtype)


class ConditioningBlock(nn.Module):
    """Eq.(5): intra-object + inter-object + proxy codes → channel gate."""

    def __init__(self, in_dim: int, proxy_dim: int = 400,
                 beta_percentage: float = 0.3):
        super().__init__()
        self.CL_1 = ConditioningLayer(in_dim, in_dim, beta_percentage, True)
        self.CL_2 = ConditioningLayer(in_dim, in_dim, beta_percentage, False)
        self.CL_3 = ConditioningLayer(proxy_dim, proxy_dim, 1.0, False)
        self.mlp_layer = nn.Linear(2 * in_dim + proxy_dim, in_dim)

    def forward(self, x, proxy_head, obj_valid):
        px = x.mean(dim=(2, 3)) * obj_valid[:, None]
        delta = px.sum(0, keepdim=True) - px
        a = self.mlp_layer(torch.cat(
            [self.CL_1(x), self.CL_2(delta), self.CL_3(proxy_head)], dim=1))
        return x * (1.0 + torch.tanh(a))[:, :, None, None]


class DynamicPreHead(nn.Module):
    """1×1 conv + GN + ReLU over the stacked distance maps."""

    def __init__(self, in_dim: int, embed_dim: int = 64):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, embed_dim, 1)
        self.bn = GN(embed_dim // 4, embed_dim)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))
