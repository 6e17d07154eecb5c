"""Kernel 2: windowed multi-radius local matching.

Replaces ``rvos_tpu/ops/pallas_local.py::_kernel`` (wrapper
``local_matching_pallas``).  For each offset of the ``K×K`` window
(``K = 2·a_max + 1``):

    d_o = ‖x‖² + ‖y′‖² − 2 x·y′ + (1 − onehot′_o)·5e4

where ``′`` is the shifted previous frame and out-of-frame offsets read
``‖y′‖² = 5e4`` and the 5e4 penalty.  The result is the running min per
(radius, object) from a start of 1e5, raw (unsquashed), channel order
``[full radius, radii[:-1]]``.  The JAX evaluator runs the XLA scan
``_local_matching_online_stacked`` instead; the port has no XLA and
plain PyTorch would build ``[S, h, w, K², O]`` cubes per frame, so the
local stream runs through this kernel.  Both previous embeddings of a
frame (pixel and proxy-reconstructed, ``S = 2``) go in one launch.

What bounds it on the H100, and what the design does about it: see
``csrc/local_match.cu``.  ``local_match`` launches that kernel for CUDA
tensors (or raises) and runs ``local_match_plain`` for CPU tensors;
``local_match.launches`` counts kernel launches.  The labels must be
one-hot (at most one object per pixel), as every caller's are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

_PEN = 5e4
_EMPTY_DIST = 1e5
_MAX_C = 128      # four channels per lane of a warp
_MAX_OBJ = 32     # one object per lane


def _window(radii: Sequence[int], atrous_rate: int
            ) -> Tuple[List[int], int, int]:
    """(output channel radii in window steps, a_max, pad_d)."""
    max_d = int(radii[-1])
    pad_d = max_d - max_d % atrous_rate
    a_max = pad_d // atrous_rate
    order = [max_d // atrous_rate] + [int(r) // atrous_rate
                                      for r in radii[:-1]]
    return order, a_max, pad_d


def local_match_plain(x: torch.Tensor, ys: torch.Tensor,
                      onehot: torch.Tensor, radii: Sequence[int],
                      atrous_rate: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one window offset at a
    time → ``[S, h, w, O, n_r]`` float32."""
    s_n, h, w, _ = ys.shape
    o = onehot.shape[-1]
    order, a_max, pad_d = _window(radii, atrous_rate)
    k = 2 * a_max + 1
    x32, y32 = x.float(), ys.float()
    x2 = x32.square().sum(-1)                                   # [h, w]
    y2 = y32.square().sum(-1)                                   # [S, h, w]
    pen = (1.0 - onehot.float()) * _PEN                         # [h, w, O]
    yp = F.pad(y32, (0, 0, pad_d, pad_d, pad_d, pad_d))
    y2p = F.pad(y2, (pad_d, pad_d, pad_d, pad_d), value=_PEN)
    penp = F.pad(pen, (0, 0, pad_d, pad_d, pad_d, pad_d), value=_PEN)
    out = torch.full((len(order), s_n, h, w, o), _EMPTY_DIST,
                     dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            oy, ox = dy * atrous_rate, dx * atrous_rate
            cross = (yp[:, oy:oy + h, ox:ox + w] * x32).sum(-1)
            d = x2 + y2p[:, oy:oy + h, ox:ox + w] - 2.0 * cross
            d_o = d[..., None] + penp[oy:oy + h, ox:ox + w]     # [S,h,w,O]
            cd = max(abs(dy - a_max), abs(dx - a_max))
            for ri, r in enumerate(order):
                if cd <= r:
                    out[ri] = torch.minimum(out[ri], d_o)
    return out.permute(1, 2, 3, 4, 0)


@functools.lru_cache(maxsize=64)
def _radii_tensors(order: Tuple[int, ...], device: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    asc = sorted(set(order))
    return (torch.tensor(asc, dtype=torch.int32, device=device),
            torch.tensor(order, dtype=torch.int32, device=device))


def local_match(x: torch.Tensor, ys: torch.Tensor, onehot: torch.Tensor,
                radii: Sequence[int], atrous_rate: int = 1) -> torch.Tensor:
    """x [h, w, C]; ys [S, h, w, C]; onehot [h, w, O] → raw multi-radius
    masked mins ``[S, h, w, O, n_r]`` float32."""
    s_n, h, w, c = ys.shape
    o = onehot.shape[-1]
    if x.shape != (h, w, c) or onehot.shape[:2] != (h, w):
        raise ValueError(f"shapes x{tuple(x.shape)} ys{tuple(ys.shape)} "
                         f"onehot{tuple(onehot.shape)} do not fit")
    if ys.device != x.device or onehot.device != x.device:
        raise ValueError(f"x on {x.device}, ys on {ys.device}, onehot on "
                         f"{onehot.device}: one device expected")
    if x.device.type == "cpu":
        return local_match_plain(x, ys, onehot, radii, atrous_rate)
    if x.device.type != "cuda":
        raise ValueError(f"local_match: unsupported device {x.device}")
    if c > _MAX_C or o > _MAX_OBJ:
        raise ValueError(f"kernel takes C <= {_MAX_C} and at most "
                         f"{_MAX_OBJ} objects (got {c}, {o})")
    order, _, _ = _window(radii, atrous_rate)
    x32 = x.float().contiguous()
    y32 = ys.float().contiguous()
    x2 = x32.square().sum(-1).contiguous()
    y2 = y32.square().sum(-1).contiguous()
    oh = onehot.float()
    lab = torch.where(oh.amax(-1) > 0.5, oh.argmax(-1),
                      torch.full_like(oh[..., 0], -1, dtype=torch.long))
    lab = lab.to(torch.int32).contiguous()
    asc_t, order_t = _radii_tensors(tuple(order), str(x.device))
    out = torch.empty((s_n, len(order), o, h, w), dtype=torch.float32,
                      device=x.device)
    lib = _cuda.load("local_match")
    fn = lib.local_match_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    err = fn(x32.data_ptr(), x2.data_ptr(), y32.data_ptr(), y2.data_ptr(),
             lab.data_ptr(), asc_t.data_ptr(), order_t.data_ptr(),
             out.data_ptr(), s_n, h, w, c, o, asc_t.numel(), len(order),
             atrous_rate, torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "local_match")
    local_match.launches += 1
    return out.permute(0, 3, 4, 2, 1)


local_match.launches = 0
