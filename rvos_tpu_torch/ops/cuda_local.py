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
``csrc/local_match.cu``.  ``local_match`` launches the operand
preparation and that kernel for CUDA tensors (or raises) and runs
``local_match_plain`` for CPU tensors; ``local_match.launches`` counts
the wrapper's calls on CUDA tensors: eager launches (a capture's warm-up
run among them) and the launches a CUDA graph captures, not the graph's
replays (a replay runs no Python).  The labels must be one-hot (at most
one object per pixel), as every caller's are.
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
_MAX_C = 128      # eight 16-deep tensor-core slices
_MAX_OBJ = 32     # one label id per lane of the preparation's warp
_MAX_PAD = 15     # window reach in pixels: a warp's band is <= 48 columns
_MAX_RADII = 8
# CTAs per query tile in bf16 mode, each over a part of the window rows;
# their results meet in an exact atomic min.  Two cut the tensor-core
# kernel's time by a quarter at the main path's shapes (more warps per
# SM); the float32 kernel is fastest with one (PERF.md §6).
_GROUPS_BF16 = 2


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
                      atrous_rate: int = 1,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one window offset at a
    time → ``[S, h, w, O, n_r]``, computed in ``dtype`` (float32 as the
    kernel; float64 gives a reference for its rounding)."""
    s_n, h, w, _ = ys.shape
    o = onehot.shape[-1]
    order, a_max, pad_d = _window(radii, atrous_rate)
    k = 2 * a_max + 1
    x32, y32 = x.to(dtype), ys.to(dtype)
    x2 = x32.square().sum(-1)                                   # [h, w]
    y2 = y32.square().sum(-1)                                   # [S, h, w]
    pen = (1.0 - onehot.to(dtype)) * _PEN                       # [h, w, O]
    yp = F.pad(y32, (0, 0, pad_d, pad_d, pad_d, pad_d))
    y2p = F.pad(y2, (pad_d, pad_d, pad_d, pad_d), value=_PEN)
    penp = F.pad(pen, (0, 0, pad_d, pad_d, pad_d, pad_d), value=_PEN)
    out = torch.full((len(order), s_n, h, w, o), _EMPTY_DIST,
                     dtype=dtype, device=x.device)
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
def _window_params(radii: Tuple[int, ...], atrous_rate: int):
    """The kernel's window parameters as a C int array: pad, atrous,
    a_max, n_asc, n_r, the band of each Chebyshev distance 0 ... _MAX_PAD
    (window steps; the index of the smallest radius in the ascending list
    that holds it) and the band of each output channel."""
    order, a_max, pad_d = _window(radii, atrous_rate)
    if pad_d > _MAX_PAD or len(order) > _MAX_RADII:
        raise ValueError(f"kernel takes a window reach <= {_MAX_PAD} pixels "
                         f"and <= {_MAX_RADII} radii (got {pad_d}, "
                         f"{len(order)})")
    asc = sorted(set(order))
    band = [next((b for b, r in enumerate(asc) if r >= cd), 0)
            for cd in range(_MAX_PAD + 1)]
    ch_band = [asc.index(r) for r in order]
    vals = ([pad_d, atrous_rate, a_max, len(asc), len(order)] + band
            + ch_band + [0] * (_MAX_RADII - len(order)))
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=1)
def _entry_points():
    """The library's two C entry points, typed once (the library is built
    at first use)."""
    lib = _cuda.load("local_match")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    prep = lib.local_prep_launch
    prep.restype = i32
    prep.argtypes = ([vp] * 3 + [i32] + [vp] * 3 + [i32] + [vp] * 4
                     + [ctypes.c_longlong] + [i32] * 6 + [vp])
    kernel = lib.local_match_launch
    kernel.restype = i32
    kernel.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    return prep, kernel


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * t.dim())(*t.stride())


def local_match(x: torch.Tensor, ys: torch.Tensor, onehot: torch.Tensor,
                radii: Sequence[int], atrous_rate: int = 1) -> torch.Tensor:
    """x [h, w, C]; ys [S, h, w, C]; onehot [h, w, O] → raw multi-radius
    masked mins ``[S, h, w, O, n_r]`` float32.

    On CUDA tensors: two launches, the operand preparation and the kernel
    (bf16 x and ys: tensor cores; float32: SIMT float32), reading x, ys
    and onehot through their strides; the kernel takes C <= 128, O <= 32,
    a window reach ``radii[-1] - radii[-1] % atrous_rate`` <= 15 pixels
    and <= 8 radii, and raises on anything else."""
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
    if x.dtype != ys.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16 x and ys of one "
                         f"type (got {x.dtype}, {ys.dtype})")
    if onehot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16 labels (got "
                         f"{onehot.dtype})")
    win = _window_params(tuple(int(r) for r in radii), int(atrous_rate))
    n_r = win[4]
    bf16 = x.dtype == torch.bfloat16
    cp = -(-c // 16) * 16 if bf16 else c
    n_rows = (1 + s_n) * h * w
    esize = 2 if bf16 else 4
    rows_bytes = -(-n_rows * cp * esize // 16) * 16
    scratch = torch.empty(rows_bytes + n_rows * 4 + h * w * 4,
                          dtype=torch.uint8, device=x.device)
    rows_ptr = scratch.data_ptr()
    norms_ptr = rows_ptr + rows_bytes
    lab_ptr = norms_ptr + n_rows * 4
    out = torch.empty((s_n, n_r, o, h, w), dtype=torch.float32,
                      device=x.device)
    groups = min(_GROUPS_BF16, 2 * win[2] + 1) if bf16 else 1
    prep, kernel = _entry_points()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = prep(x.data_ptr(), ys.data_ptr(), onehot.data_ptr(),
               int(onehot.dtype == torch.bfloat16), _strides(x),
               _strides(ys), _strides(onehot), int(bf16), rows_ptr,
               norms_ptr, lab_ptr, out.data_ptr() if groups > 1 else None,
               out.numel(), s_n, h, w, c, cp, o, stream)
    _cuda.check(err, "local_prep")
    err = kernel(rows_ptr, norms_ptr, lab_ptr, out.data_ptr(), win, s_n, h,
                 w, c, cp, o, int(bf16), groups, stream)
    _cuda.check(err, "local_match")
    local_match.launches += 1
    return out.permute(0, 3, 4, 2, 1)


local_match.launches = 0
