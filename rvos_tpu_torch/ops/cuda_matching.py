"""Kernel 1: global matching over a label-segmented bank.

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

The same kernel also replaces ``_kernel_seg`` (wrapper
``global_matching_pallas_segmented``), the uniform-quota layout of
``compact_reference_bank_segmented``: object ``o`` owns rows
``[o·quota, (o+1)·quota)``, which is kernel 1 with ``tile_obj =
arange(O).repeat_interleave(quota // 1024)`` — the Pallas kernel's
routing ``obj = j // tiles_per_obj``.  ``global_seg`` is that entry
point, with its own launch counter.

What bounds it on the H100, and what the design does about it: see
``csrc/global_seg_map.cu``.  ``global_seg_map`` and ``global_seg``
launch that kernel for CUDA tensors (or raise) and run their plain
versions for CPU tensors; their ``.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda

_EMPTY_DIST = 1e5
_BN = 64          # bank rows per kernel step: a tile must hold a multiple
_MAX_OBJ = 32     # per-row output block lives in shared memory
_SEG_TILE = 1024  # uniform layout: quotas are multiples of this


def prepare_operands(q: torch.Tensor, r: torch.Tensor, mixed: bool
                     ) -> Tuple[torch.Tensor, ...]:
    """float32 cross-term operands (bf16-rounded in mixed mode) and the
    float32 row norms ‖q‖² and ‖r‖² from the unrounded values."""
    q32, r32 = q.float(), r.float()
    q2 = q32.square().sum(-1)
    r2 = r32.square().sum(-1)
    if mixed:
        q32 = q32.bfloat16().float()
        r32 = r32.bfloat16().float()
    return q32, q2, r32, r2


def _check(name: str, q: torch.Tensor, r: torch.Tensor,
           bias: torch.Tensor) -> None:
    p = r.shape[0]
    if q.dim() != 2 or r.shape[1:] != q.shape[1:] or bias.shape != (p,):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} r{tuple(r.shape)} "
                         f"bias{tuple(bias.shape)} do not fit")
    if r.device != q.device or bias.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, r on {r.device}, bias on "
                         f"{bias.device}: one device expected")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def global_seg_map_plain(q: torch.Tensor, r: torch.Tensor,
                         bias: torch.Tensor, tile_obj: torch.Tensor,
                         n_obj: int, mixed: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one bank tile at a time so
    that ``[M, P]`` never exists → ``[M, n_obj]`` float32."""
    q32, q2, r32, r2 = prepare_operands(q, r, mixed)
    r2b = r2 + bias.float()
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


def _launch(q: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
            tile_obj: torch.Tensor, n_obj: int, mixed: bool) -> torch.Tensor:
    """Launch ``csrc/global_seg_map.cu`` on CUDA operands."""
    m, c = q.shape
    p = r.shape[0]
    n_tiles = tile_obj.shape[0]
    tr = p // n_tiles
    if tr % _BN or n_obj > _MAX_OBJ:
        raise ValueError(f"kernel needs tile rows % {_BN} == 0 and at most "
                         f"{_MAX_OBJ} objects (got {tr}, {n_obj})")
    q32, q2, r32, r2 = prepare_operands(q, r, mixed)
    qt = q32.t().contiguous()
    rt = r32.t().contiguous()
    q2, r2b = q2.contiguous(), (r2 + bias.float()).contiguous()
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
    return out


def global_seg_map(q: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
                   tile_obj: torch.Tensor, n_obj: int,
                   mixed: bool = True) -> torch.Tensor:
    """q [M, C]; r [P, C]; bias [P]; tile_obj [n_tiles] → [M, n_obj]."""
    _check("global_seg_map", q, r, bias)
    n_tiles = tile_obj.shape[0] if tile_obj.dim() == 1 else 0
    if n_tiles == 0 or r.shape[0] % n_tiles:
        raise ValueError(f"bank rows {r.shape[0]} not tile-aligned for "
                         f"tile_obj{tuple(tile_obj.shape)}")
    if q.device.type == "cpu":
        return global_seg_map_plain(q, r, bias, tile_obj, n_obj, mixed)
    out = _launch(q, r, bias, tile_obj, n_obj, mixed)
    global_seg_map.launches += 1
    return out


global_seg_map.launches = 0


def uniform_tile_obj(p: int, n_obj: int, device=None) -> torch.Tensor:
    """The uniform-quota layout's tile→object map: ``quota = P / O`` rows
    per object in ``_SEG_TILE``-row tiles → ``[P / _SEG_TILE]`` int32."""
    quota = p // n_obj
    if quota * n_obj != p or quota % _SEG_TILE:
        raise ValueError(f"bank rows {p} not segment-aligned for O={n_obj}")
    return torch.arange(n_obj, dtype=torch.int32, device=device
                        ).repeat_interleave(quota // _SEG_TILE)


def global_seg_plain(q: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
                     n_obj: int, mixed: bool = True) -> torch.Tensor:
    """``global_seg``'s function in plain PyTorch → ``[M, n_obj]``."""
    return global_seg_map_plain(q, r, bias, uniform_tile_obj(r.shape[0], n_obj),
                                n_obj, mixed)


def global_seg(q: torch.Tensor, r: torch.Tensor, bias: torch.Tensor,
               n_obj: int, mixed: bool = True) -> torch.Tensor:
    """Uniform-quota segmented matching (B.2): q [M, C]; r [O·quota, C]
    with ``quota % 1024 == 0``; bias [O·quota] → [M, n_obj]."""
    _check("global_seg", q, r, bias)
    tile_obj = uniform_tile_obj(r.shape[0], n_obj, q.device)
    if q.device.type == "cpu":
        return global_seg_map_plain(q, r, bias, tile_obj, n_obj, mixed)
    out = _launch(q, r, bias, tile_obj, n_obj, mixed)
    global_seg.launches += 1
    return out


global_seg.launches = 0
