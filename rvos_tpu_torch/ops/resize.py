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

bfloat16 bilinear and bicubic resizes take the JAX package's bf16 route:
each axis is a matmul with the ``[out, in]`` interpolation matrix rounded
to bf16, accumulated in float32 and rounded to bf16 (rows first, then
columns).  The matrices are kept on the card as the nearest index is.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _nearest_index_host(in_size: int, out_size: int) -> torch.Tensor:
    src = np.minimum((np.arange(out_size) * (in_size / out_size))
                     .astype(np.int64), in_size - 1)
    return torch.from_numpy(src)


_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _on_device(host_fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``host_fn(*args)`` on ``device``, copied there once and kept."""
    if device.type == "cpu":
        return host_fn(*args)
    key = (host_fn, args, device)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = host_fn(*args).to(device)
    return t


def _nearest_index(in_size: int, out_size: int,
                   device: torch.device) -> torch.Tensor:
    return _on_device(_nearest_index_host, (in_size, out_size), device)


@functools.lru_cache(maxsize=256)
def _resize_matrix_host(in_size: int, out_size: int, mode: str
                        ) -> torch.Tensor:
    """The dense [out, in] align-corners interpolation matrix of one axis
    (bicubic with A = -0.75), as the JAX package builds it, in bf16."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    src = (np.zeros(1) if out_size == 1 else
           np.arange(out_size) * (in_size - 1) / (out_size - 1))
    rows = np.arange(out_size)
    if mode == "bilinear":
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        hi = np.clip(lo + 1, 0, in_size - 1)
        frac = src - lo
        np.add.at(w, (rows, lo), 1.0 - frac)
        np.add.at(w, (rows, hi), frac)
    else:
        a = -0.75

        def cubic(t):
            t = np.abs(t)
            return np.where(
                t <= 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
                np.where(t < 2.0,
                         ((a * t - 5.0 * a) * t + 8.0 * a) * t - 4.0 * a,
                         0.0))

        lo = np.floor(src).astype(np.int64)
        frac = src - lo
        for tap in (-1, 0, 1, 2):
            np.add.at(w, (rows, np.clip(lo + tap, 0, in_size - 1)),
                      cubic(frac - tap))
    return torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)


def _resize_bf16(x: torch.Tensor, oh: int, ow: int, mode: str
                 ) -> torch.Tensor:
    """bf16 [..., H, W] → [..., oh, ow] through the two bf16 matmuls."""
    h, w = x.shape[-2:]
    mat_h = _on_device(_resize_matrix_host, (h, oh, mode), x.device)
    mat_w = _on_device(_resize_matrix_host, (w, ow, mode), x.device)
    # one GEMM per axis (a broadcast matmul would copy the matrix per
    # leading index)
    return torch.matmul(torch.einsum("oh,...hw->...ow", mat_h, x), mat_w.T)


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
    if x.dtype == torch.bfloat16:
        return _resize_bf16(x, oh, ow, mode)
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
