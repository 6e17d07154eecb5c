"""Weights: flax parameters → the port's state dict, and seeded random
initialisation.

``from_jax_params`` takes the JAX package's flax params flattened to
``/``-joined paths (numpy arrays) and returns a state dict under the
reference's torch key names and layouts — the inverse of
``rvos_tpu/engine/checkpoint.py::convert_torch_statedict`` — which the
port's ``AOCNet`` loads with ``strict=True``.  The same key names are
the reference's ``.pth`` names, so reference checkpoints can be loaded
the same way later.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch
from torch import nn


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """flax ``/``-paths → torch keys: HWIO→OIHW convs, transposed dense
    kernels, ``scale``→``weight``, GCT (1,1,1,C)→(1,C,1,1), backbone
    ``layerN_i``→``layerN.i``, ``downsample_conv/bn``→``downsample.0/1``."""
    sd = {}
    for key, val in flat.items():
        v = np.asarray(val, dtype=np.float32)
        parts = key.split("/")
        leaf = parts[-1]
        tparts = []
        for p in parts[:-1]:
            m = re.fullmatch(r"(layer\d+)_(\d+)", p)
            if m and "backbone" in parts:
                tparts += [m.group(1), m.group(2)]
            elif p == "downsample_conv":
                tparts += ["downsample", "0"]
            elif p == "downsample_bn":
                tparts += ["downsample", "1"]
            else:
                tparts.append(p)
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf in ("alpha", "gamma", "beta") and v.ndim == 4:
            v = v.transpose(0, 3, 1, 2)
        sd[".".join(tparts + [leaf])] = torch.from_numpy(
            np.array(v, copy=True, order="C"))
    return sd


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, in the spirit of the JAX package's flax
    initialisers: conv and dense weights ~ N(0, 1/fan_in), biases zero,
    norms and gates at identity, frozen batch norms identity."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
        elif leaf in ("weight", "alpha"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model
