"""Random weights from the seed, made on the device in one draw.

Every tensor of the model's state dict gets a value by its role: a
convolution or linear weight N(0, 1/fan_in), a normalisation's weight,
GCT's alpha and a frozen batch norm's variance 1, every other entry 0
(biases, means, GCT's gamma and beta, the distance biases); the last
normalisation of every bottleneck (``bn3``: the ResNet's and the
decoder's) starts at ``RESIDUAL_SCALE``, so that each residual branch
starts small (the zero-γ practice of residual networks).  With every
``bn3`` at 1 the random network amplified rounding: in bf16 its masks
left the float32 reference's on 20–40 % of pixels, and no check could
tell bf16 from fp8.  The normal draws come from one ``torch.randn`` of a
``torch.Generator`` on the device, sliced in the state dict's order.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SEED_MIX = 0x5DEECE66D
RESIDUAL_SCALE = 0.1


def make_state(shapes: Dict[str, torch.Size], seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of ``shapes`` (a state dict's names
    and shapes, in its order)."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * SEED_MIX + 11) % (2 ** 63))
    normal = [(n, s) for n, s in shapes.items()
              if n.rsplit(".", 1)[-1] == "weight" and len(s) >= 2]
    total = sum(math.prod(s) for _, s in normal)
    draws = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in normal:
        n = math.prod(shape)
        out[name] = draws[at:at + n].view(shape) / math.sqrt(
            math.prod(shape[1:]))
        at += n
    for name, shape in shapes.items():
        if name in out:
            continue
        leaf = name.rsplit(".", 1)[-1]
        one = leaf in ("weight", "alpha", "running_var")
        if name.endswith(".bn3.weight"):
            value = RESIDUAL_SCALE
        else:
            value = 1.0 if one else 0.0
        out[name] = torch.full(tuple(shape), value, device=device)
    return out
