"""Resizes with the reference's sampling grids.

``rvos_tpu/ops/resize.py`` reproduces torch's ``F.interpolate`` with
``align_corners=True`` (bilinear, bicubic with A=-0.75) and the legacy
``nearest`` rule ``src = floor(dst * in/out)``; the port calls
``F.interpolate`` for the first two.  Nearest is an index gather with the
index computed in float64 exactly as the JAX package computes it:
``F.interpolate(mode="nearest")`` does that arithmetic in float32 and
picks another source row for some size pairs (1168 of the 199² pairs up
to 199), which would move label maps by a pixel.  On a card the index
is kept on it, per (sizes, device) and never evicted: a resize inside a
frame's step copies nothing from the host, and a CUDA graph that reads
the index can rely on its memory.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _nearest_index_host(in_size: int, out_size: int) -> torch.Tensor:
    src = np.minimum((np.arange(out_size) * (in_size / out_size))
                     .astype(np.int64), in_size - 1)
    return torch.from_numpy(src)


_DEVICE_INDEX: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def _nearest_index(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return _nearest_index_host(in_size, out_size)
    key = (in_size, out_size, device)
    idx = _DEVICE_INDEX.get(key)
    if idx is None:
        idx = _DEVICE_INDEX[key] = _nearest_index_host(
            in_size, out_size).to(device)
    return idx


def resize_nchw(x: torch.Tensor, out_hw, mode: str = "bilinear"
                ) -> torch.Tensor:
    """Resize the last two axes of ``x`` ([..., H, W]); dtype preserved."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    if mode == "nearest":
        iy = _nearest_index(h, oh, x.device)
        ix = _nearest_index(w, ow, x.device)
        return x.index_select(-2, iy).index_select(-1, ix)
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resize mode: {mode}")
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((1, -1, h, w)), size=(oh, ow), mode=mode,
                      align_corners=True)
    return y.reshape(lead + (oh, ow))


def resize_hw(x: torch.Tensor, out_hw, mode: str = "bilinear"
              ) -> torch.Tensor:
    """Resize the leading two axes of ``x`` ([H, W, ...]) — the JAX
    package's layout at the ops boundary."""
    nd = x.dim()
    perm = tuple(range(2, nd)) + (0, 1)
    y = resize_nchw(x.permute(perm), out_hw, mode)
    inv = (nd - 2, nd - 1) + tuple(range(nd - 2))
    return y.permute(inv)
