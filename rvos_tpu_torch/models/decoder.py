"""CalibrationDecoding — the proxy-conditioned mask-calibration decoder
(PyTorch port of ``rvos_tpu/models/decoder.py``).

  IA1 gate → Bottleneck(in→256) → CLB2 → Bottleneck(256→256,d2) → CLB3
  → Bottleneck(256→512,s2) → CLB4 → Bottleneck(512→512,d2) → CLB5
  → Bottleneck(512→512,d4) → inter-object-delta IA9 → GN-ASPP
  → Modulator_1(memory slot 0) → Modulator_2(slot 1)
  → decoder_final (bicubic ↑ to low-level, GCT shortcut, 2×conv)
  → per-object dynamic 1×1 FG/BG logits → background augmentation.

Feature memory: two slots of post-ASPP-stage features per video, of a
fixed shape with a validity flag each (``DecoderMemory.empty``).  Slot 0
is refreshed every frame; slot 1 is sticky from its first assignment.
An invalid slot (the first decoded frame) reads the current features,
selected on the flags on the device, so a frame with memory and one
without run the same operations (one CUDA graph serves both).  Slots
are detached copies: in training no gradient flows through the memory,
as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..ops.resize import resize_nchw
from .layers import GCT, GN, ConditioningBlock, GNASPP, GNBottleneck, IAGate


class DecoderMemory(NamedTuple):
    """Two slots of post-ASPP features, the JAX package's form
    (``rvos_tpu/models/decoder.py:35-46``) in the port's layout."""
    slots: torch.Tensor     # [2, O, 256, h8, w8]
    valid: torch.Tensor     # [2] bool

    @staticmethod
    def empty(n_obj: int, h8: int, w8: int, channels: int = 256,
              dtype=torch.float32, device=None) -> "DecoderMemory":
        return DecoderMemory(
            torch.zeros((2, n_obj, channels, h8, w8), dtype=dtype,
                        device=device),
            torch.zeros((2,), dtype=torch.bool, device=device))


def _inter_object_delta(x, obj_valid):
    """GAP sum-minus-self over valid objects → [O, C]."""
    px = x.mean(dim=(2, 3)) * obj_valid[:, None]
    return px.sum(0, keepdim=True) - px


class CalibrationDecoding(nn.Module):
    def __init__(self, in_dim: int = 164, attention_dim: int = 400,
                 embed_dim: int = 256, refine_dim: int = 64,
                 low_level_dim: int = 256, beta_percentage: float = 0.3):
        super().__init__()
        E, A, R = embed_dim, attention_dim, refine_dim
        self.IA1 = IAGate(A, in_dim)
        self.layer1 = GNBottleneck(in_dim, E)
        self.CLB2 = ConditioningBlock(E, A, beta_percentage)
        self.layer2 = GNBottleneck(E, E, 1, 2)
        self.CLB3 = ConditioningBlock(E, A, beta_percentage)
        self.layer3 = GNBottleneck(E, E * 2, 2)
        self.CLB4 = ConditioningBlock(E * 2, A, beta_percentage)
        self.layer4 = GNBottleneck(E * 2, E * 2, 1, 2)
        self.CLB5 = ConditioningBlock(E * 2, A, beta_percentage)
        self.layer5 = GNBottleneck(E * 2, E * 2, 1, 4)
        self.IA9 = IAGate(A + E * 2, E * 2)
        self.ASPP = GNASPP(E * 2)
        for p in ("M1", "M2"):
            setattr(self, f"{p}_Reweight_Layer_1", IAGate(A, E * 2))
            setattr(self, f"{p}_Bottleneck_1", GNBottleneck(E * 2, E * 2))
            setattr(self, f"{p}_Reweight_Layer_2", IAGate(A, E * 2))
            setattr(self, f"{p}_Bottleneck_2", GNBottleneck(E * 2, E))
            setattr(self, f"{p}_Reweight_Layer_3", IAGate(A, E))
            setattr(self, f"{p}_Bottleneck_3", GNBottleneck(E, E))
        self.GCT_sc = GCT(low_level_dim)
        self.conv_sc = nn.Conv2d(low_level_dim, R, 1, bias=False)
        self.bn_sc = GN(R // 4, R)
        self.IA10 = IAGate(A + E + R, E + R)
        self.conv1 = nn.Conv2d(E + R, E // 2, 3, padding=1, bias=False)
        self.bn1 = GN(32, E // 2)
        self.IA11 = IAGate(A + E // 2, E // 2)
        self.conv2 = nn.Conv2d(E // 2, E // 2, 3, padding=1, bias=False)
        self.bn2 = GN(32, E // 2)
        self.IA_final_fg = nn.Linear(A, E // 2 + 1)
        self.IA_final_bg = nn.Linear(A, E // 2 + 1)

    def forward(self, x, head, memory: DecoderMemory, low_level, obj_valid
                ) -> Tuple[torch.Tensor, DecoderMemory]:
        """x [O, in_dim, h4, w4]; head [O, 400]; low_level [1, 256, h4, w4];
        obj_valid [O] → (logits [O, h4, w4], new memory)."""
        x = self.IA1(x, head)
        x = self.layer1(x)
        x = self.CLB2(x, head, obj_valid)
        x = self.layer2(x)
        x = self.CLB3(x, head, obj_valid)
        x = self.layer3(x)
        x = self.CLB4(x, head, obj_valid)
        x = self.layer4(x)
        x = self.CLB5(x, head, obj_valid)
        x = self.layer5(x)
        x = self.IA9(x, torch.cat([head, _inter_object_delta(x, obj_valid)],
                                  dim=1))
        x = self.ASPP(x)

        # the memory carries no gradient: a slot is a detached copy
        x_cur_1 = x.detach()
        mem0 = torch.where(memory.valid[0], memory.slots[0], x_cur_1)
        x = self._modulator(x, mem0, head, "M1")
        mem1 = torch.where(memory.valid[1], memory.slots[1], x.detach())
        x = self._modulator(x, mem1, head, "M2")
        new_memory = DecoderMemory(torch.stack([x_cur_1, mem1]),
                                   torch.ones_like(memory.valid))

        x = self._decoder_final(x, low_level, head, obj_valid)
        fg = self._ia_logit(x, head, self.IA_final_fg)
        bg = self._ia_logit(x, head, self.IA_final_bg)
        return self._augment_background_logit(fg, bg, obj_valid), new_memory

    def _modulator(self, x, x_memory, head, p):
        x = torch.cat([x, x_memory], dim=1)
        for i in (1, 2, 3):
            x = getattr(self, f"{p}_Reweight_Layer_{i}")(x, head)
            x = getattr(self, f"{p}_Bottleneck_{i}")(x)
        return x

    def _decoder_final(self, x, low_level, head, obj_valid):
        x = resize_nchw(x, low_level.shape[-2:], "bicubic")
        ll = torch.relu(self.bn_sc(self.conv_sc(self.GCT_sc(low_level))))
        ll = ll.expand(x.shape[0], -1, -1, -1)
        x = torch.cat([x, ll], dim=1)
        x = self.IA10(x, torch.cat([head, _inter_object_delta(x, obj_valid)],
                                   dim=1))
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.IA11(x, torch.cat([head, _inter_object_delta(x, obj_valid)],
                                   dim=1))
        return torch.relu(self.bn2(self.conv2(x)))

    @staticmethod
    def _ia_logit(x, head, dense):
        """Per-object dynamic 1×1 conv → [O, h, w]."""
        c = x.shape[1]
        out = dense(head)                                  # [O, C+1]
        return (torch.einsum("ochw,oc->ohw", x, out[:, :c])
                + out[:, -1][:, None, None])

    @staticmethod
    def _augment_background_logit(fg, bg, obj_valid):
        """Add the min of the valid foreground objects' relative-background
        logits to the absolute-background channel (none: the background
        alone is decoded, and nothing is added)."""
        if fg.shape[0] == 1:
            return fg
        valid = obj_valid[1:].bool()
        bg_masked = torch.where(valid[:, None, None], bg[1:],
                                torch.full_like(bg[1:], float("inf")))
        aug = bg_masked.min(dim=0).values
        aug = torch.where(valid.any(), aug, torch.zeros_like(aug))
        return torch.cat([(fg[0] + aug)[None], fg[1:]], dim=0)
