"""Kernel 1: global matching over an occupancy-segmented bank.

Replaces ``rvos_tpu/ops/pallas_matching.py::_kernel_seg_map`` (wrapper
``global_matching_pallas_segmented_mapped``): for query rows ``q [M, C]``
and a bank ``r [P, C]`` of ``n_tiles`` label-pure tiles owned by
``tile_obj [n_tiles]``, with a per-row ``bias [P]`` (5e4 on filler rows),

    out[m, o] = min over rows p of the tiles owned by o of
                (‖q_m‖² + ‖r_p‖² + bias_p − 2 q_m·r_p)

and ``_EMPTY_DIST = 1e5`` for a channel that owns no tile.  Mixed mode
takes the cross term from bf16-rounded operands with float32
accumulation; norms, bias and the min stay float32 (the Pallas kernel
also takes the min in bf16 — a float32 min is within the mixed
tolerance).

What bounds it on the H100, and what the design does about it: see
``csrc/global_seg_map.cu``.  ``global_seg_map`` launches that kernel for
CUDA tensors (or raises) and runs ``global_seg_map_plain`` for CPU
tensors; ``global_seg_map.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda

_EMPTY_DIST = 1e5
_BN = 64          # bank rows per kernel step: a tile must hold a multiple
_MAX_OBJ = 32     # per-row output block lives in shared memory


def _prepare(q: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
             mixed: bool) -> Tuple[torch.Tensor, ...]:
    """float32 cross-term operands (bf16-rounded in mixed mode) and the
    float32 row terms ‖q‖² and ‖r‖² + bias from the unrounded values."""
    q32, r32 = q.float(), r.float()
    q2 = q32.square().sum(-1)
    r2b = r32.square().sum(-1) + bias.float()
    if mixed:
        q32 = q32.bfloat16().float()
        r32 = r32.bfloat16().float()
    return q32, q2, r32, r2b


def global_seg_map_plain(q: torch.Tensor, r: torch.Tensor,
                         bias: torch.Tensor, tile_obj: torch.Tensor,
                         n_obj: int, mixed: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one bank tile at a time so
    that ``[M, P]`` never exists → ``[M, n_obj]`` float32."""
    q32, q2, r32, r2b = _prepare(q, r, bias, mixed)
    n_tiles = tile_obj.shape[0]
    tr = r.shape[0] // n_tiles
    out = torch.full((q.shape[0], n_obj), _EMPTY_DIST, dtype=torch.float32,
                     device=q.device)
    for t, o in enumerate(tile_obj.tolist()):
        if not 0 <= o < n_obj:
            continue
        rows = slice(t * tr, (t + 1) * tr)
        d = q2[:, None] + r2b[None, rows] - 2.0 * (q32 @ r32[rows].T)
        out[:, o] = torch.minimum(out[:, o], d.min(dim=1).values)
    return out


def global_seg_map(q: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
                   tile_obj: torch.Tensor, n_obj: int,
                   mixed: bool = True) -> torch.Tensor:
    """q [M, C]; r [P, C]; bias [P]; tile_obj [n_tiles] → [M, n_obj]."""
    m, c = q.shape
    p = r.shape[0]
    n_tiles = tile_obj.shape[0]
    if r.shape[1] != c or bias.shape != (p,) or tile_obj.dim() != 1:
        raise ValueError(f"shapes q{tuple(q.shape)} r{tuple(r.shape)} "
                         f"bias{tuple(bias.shape)} tile_obj"
                         f"{tuple(tile_obj.shape)} do not fit")
    if n_tiles == 0 or p % n_tiles:
        raise ValueError(f"bank rows {p} not tile-aligned for {n_tiles} tiles")
    if r.device != q.device or bias.device != q.device:
        raise ValueError(f"q on {q.device}, r on {r.device}, bias on "
                         f"{bias.device}: one device expected")
    if q.device.type == "cpu":
        return global_seg_map_plain(q, r, bias, tile_obj, n_obj, mixed)
    if q.device.type != "cuda":
        raise ValueError(f"global_seg_map: unsupported device {q.device}")
    tr = p // n_tiles
    if tr % _BN or n_obj > _MAX_OBJ:
        raise ValueError(f"kernel needs tile rows % {_BN} == 0 and at most "
                         f"{_MAX_OBJ} objects (got {tr}, {n_obj})")
    q32, q2, r32, r2b = _prepare(q, r, bias, mixed)
    qt = q32.t().contiguous()
    rt = r32.t().contiguous()
    q2, r2b = q2.contiguous(), r2b.contiguous()
    tobj = tile_obj.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((m, n_obj), dtype=torch.float32, device=q.device)
    lib = _cuda.load("global_seg_map")
    fn = lib.global_seg_map_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(qt.data_ptr(), q2.data_ptr(), rt.data_ptr(), r2b.data_ptr(),
             tobj.data_ptr(), out.data_ptr(), m, p, c, n_obj, n_tiles, tr,
             torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "global_seg_map")
    global_seg_map.launches += 1
    return out


global_seg_map.launches = 0
