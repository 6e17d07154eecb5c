"""DeepLabv3+ feature extractor (PyTorch port of
``rvos_tpu/models/deeplab.py``): ResNet-101 (OS 16) → ASPP (frozen BN,
2048→1280→256, then dropout) → decoder (low-level 256→48, concat 304 →
two 3×3 convs → 256) at stride 4.  The JAX package's ``ShiftConv3x3`` is
a TPU layout workaround with a plain conv's parameters; here it is
``nn.Conv2d``.

The ASPP dropout (``MODEL_ASPP_DROPOUT``) draws its mask from the
explicit ``torch.Generator`` passed to ``forward``; without one (every
inference call) it is the identity.  A caller that recomputes a forward
(``torch.utils.checkpoint``) passes a generator seeded the same way each
time, so the recomputed mask is the same one."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.resize import resize_nchw
from .resnet import FrozenBatchNorm2d, ResNet101


class DeepLabASPP(nn.Module):
    def __init__(self, inplanes: int = 2048, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        for name, k, d in (("aspp1", 1, 1), ("aspp2", 3, 6), ("aspp3", 3, 12),
                           ("aspp4", 3, 18)):
            pad = 0 if k == 1 else d
            setattr(self, f"{name}_conv", nn.Conv2d(
                inplanes, 256, k, padding=pad, dilation=d, bias=False))
            setattr(self, f"{name}_bn", FrozenBatchNorm2d(256))
        self.gap_conv = nn.Conv2d(inplanes, 256, 1, bias=False)
        self.gap_bn = FrozenBatchNorm2d(256)
        self.conv1 = nn.Conv2d(1280, 256, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(256)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        outs = [torch.relu(getattr(self, f"aspp{i}_bn")(
            getattr(self, f"aspp{i}_conv")(x))) for i in range(1, 5)]
        x5 = x.mean(dim=(2, 3), keepdim=True)
        x5 = torch.relu(self.gap_bn(self.gap_conv(x5)))
        outs.append(x5.expand(-1, -1, outs[0].shape[2], outs[0].shape[3]))
        x = torch.relu(self.bn1(self.conv1(torch.cat(outs, dim=1))))
        if generator is None or self.dropout_rate == 0.0:
            return x
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DeepLabDecoder(nn.Module):
    def __init__(self, low_level_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(low_level_dim, 48, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(48)
        self.last_conv0 = nn.Conv2d(304, 256, 3, padding=1, bias=False)
        self.last_bn0 = FrozenBatchNorm2d(256)
        self.last_conv1 = nn.Conv2d(256, 256, 3, padding=1, bias=False)
        self.last_bn1 = FrozenBatchNorm2d(256)

    def forward(self, x, low_level):
        ll = torch.relu(self.bn1(self.conv1(low_level)))
        x = resize_nchw(x, ll.shape[-2:], "bilinear")
        x = torch.cat([x, ll], dim=1)
        x = torch.relu(self.last_bn0(self.last_conv0(x)))
        return torch.relu(self.last_bn1(self.last_conv1(x)))


class DeepLab(nn.Module):
    """[N, 3, H, W] → (decoder features [N, 256, H/4, W/4], low-level
    [N, 256, H/4, W/4])."""

    def __init__(self, output_stride: int = 16, backbone: str = "resnet",
                 dropout_rate: float = 0.1):
        super().__init__()
        if backbone != "resnet":
            raise NotImplementedError(
                f"backbone {backbone!r}: the port has ResNet-101 only "
                "(MobileNet is ROADMAP Queue A item 6)")
        self.backbone = ResNet101(output_stride)
        self.aspp = DeepLabASPP(dropout_rate=dropout_rate)
        self.decoder = DeepLabDecoder()

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, low = self.backbone(x)
        return self.decoder(self.aspp(feats, generator), low), low
