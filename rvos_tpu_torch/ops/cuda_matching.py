"""Kernel 1: global matching over a label-segmented bank.

Replaces ``rvos_tpu/ops/pallas_matching.py::_kernel_seg_map`` (wrapper
``global_matching_pallas_segmented_mapped``): for query rows ``q [M, C]``
and a bank ``r [P, C]`` of ``n_tiles`` label-pure tiles owned by
``tile_obj [n_tiles]``, with a per-row ``bias [P]`` (5e4 on filler rows),

    out[m, o] = min over rows p of the tiles owned by o of
                (‖q_m‖² + ‖r_p‖² + bias_p − 2 q_m·r_p)

and ``_EMPTY_DIST = 1e5`` for a channel that owns no tile.  Mixed mode
takes the cross term from bf16-rounded operands with float32
accumulation, on the tensor cores; norms, bias and the min stay float32
(the Pallas kernel also takes the min in bf16 — a float32 min is within
the mixed tolerance).  Float32 mode takes the cross term in float32 on
the FMA units (never TF32), the arithmetic of the JAX package's
``Precision.HIGHEST``.

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
import functools
from typing import Dict, Tuple

import torch

from . import _cuda

_EMPTY_DIST = 1e5
_BN = 64          # bank rows per kernel step: a tile must hold a multiple
_MAX_OBJ = 32     # per-row output block lives in shared memory
_SEG_TILE = 1024  # uniform layout: quotas are multiples of this
_TC_BM = 128      # query rows per CTA of the tensor-core (mixed) kernels
_TC_MAX_C = 128   # their depth, C rounded up to a multiple of 16
_F32_BM = 128     # query rows per CTA of the float32 (FMA) kernels
_F32_MAX_C = 128  # their depth, C rounded up to a multiple of 4


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


def tc_steps_per_split(m: int, n_steps: int, sms: int) -> int:
    """Bank steps per CTA of a tensor-core kernel.

    A CTA holds 128 query rows, so the main path's M = 25,773 fills only
    202 CTAs for 132 SMs.  The bank axis is cut into runs of steps, one
    CTA each per query tile, until the grid holds about 8 CTAs per SM
    (3 of them resident at a time), keeping at least 8 steps per CTA.
    With more than one run the CTAs combine by an atomic min."""
    tiles = -(-m // _TC_BM)
    split = max(1, min(-(-8 * sms // tiles), n_steps // 8))
    return -(-n_steps // split)


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=256)
def f32_steps_per_split(m: int, n_steps: int, slots: int) -> int:
    """Bank steps per CTA of a float32 (FMA) kernel.

    A CTA holds 128 query rows, so the main path's M = 25,773 fills 202
    CTAs for ``slots`` resident ones (132 SMs × 2 on an H100 at C =
    100).  The bank axis is cut into runs of steps, one CTA each per query
    tile, so that the waves of CTAs end as evenly as they can: the count of
    runs minimises waves × (steps a run + 1), the 1 standing for a CTA's
    query tile and epilogue, the fewest runs on a tie, at least 8 steps a
    run unless the bank is shorter.  With more than one run the CTAs
    combine by an atomic min."""
    tiles = -(-m // _F32_BM)
    best = None
    for k in range(1, max(1, n_steps // 8) + 1):
        per = -(-n_steps // k)
        runs = -(-n_steps // per)
        cost = -(-tiles * runs // slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, per)
    return best[1]


_f32_slots: Dict[tuple, int] = {}


def f32_slots(lib, kernel: str, cp: int, n_obj: int, device) -> int:
    """Resident CTAs of a float32 kernel on the card (CTAs per SM, from
    the CUDA occupancy query of ``<kernel>_f32_residency``, × SMs),
    cached per kernel, depth, object count and device."""
    key = (kernel, cp, n_obj, str(device))
    if key not in _f32_slots:
        fn = getattr(lib, f"{kernel}_f32_residency")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        n = fn(cp, n_obj)
        if n < 1:
            raise RuntimeError(f"{kernel}: no float32 CTA fits an SM at "
                               f"depth {cp}, {n_obj} objects (CUDA {-n})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _f32_slots[key] = n * sms
    return _f32_slots[key]


def f32_depth(c: int) -> int:
    """The float32 kernels' depth: C rounded up to a multiple of 4 (zero
    channels change no distance); raises past ``_F32_MAX_C``."""
    cp = -(-c // 4) * 4
    if cp > _F32_MAX_C:
        raise ValueError(f"float32 kernels take C <= {_F32_MAX_C} (got {c})")
    return cp


def _prep_f32(lib, src: torch.Tensor, rows: int, tile: int, stream: int,
              perm=None, bias=None, lab=None, out=None, n_obj: int = 0,
              scale: float = 1.0, pad_norm: float = 0.0):
    """One launch of ``dist_prep_f32``: ``src [R, C]`` (rows gathered by
    ``perm``) as k-major tiles ``[rows / tile, Cp, tile]`` scaled by
    ``scale``, norms ``[rows]`` (+ bias; ``pad_norm`` past R), labels in
    ``perm``'s order (with ``lab``), ``out`` to +inf (when given)."""
    n, c = src.shape
    cp = f32_depth(c)
    sf = src.float().contiguous()
    bf = None if bias is None else bias.float().contiguous()
    lf = None if lab is None else lab.float().contiguous()
    dst = torch.empty((rows // tile, cp, tile), dtype=torch.float32,
                      device=src.device)
    norms = torch.empty((rows,), dtype=torch.float32, device=src.device)
    labs = None if lab is None else torch.empty_like(lf)
    fn = lib.dist_prep_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    _cuda.check(fn(sf.data_ptr(), _ptr(perm), _ptr(bf), scale, dst.data_ptr(),
                   norms.data_ptr(), _ptr(lf), _ptr(labs), _ptr(out), n, rows,
                   c, cp, tile, n_obj if lab is None else lab.shape[1],
                   pad_norm, stream), "dist_prep_f32")
    return dst, norms, labs


def f32_query(lib, q: torch.Tensor, n_obj: int, split: bool, stream: int):
    """The query side of a float32 kernel, in one launch of
    ``dist_prep_f32``: k-major tiles ``[ceil(M / 128), Cp, 128]`` (zero
    past M and C), norms ``[ceil(M / 128) · 128]`` and the ``[M, n_obj]``
    output, filled with +inf when ``split`` (the bank split over several
    CTAs).  Returns ``(qt, q2, out)``."""
    m = q.shape[0]
    out = torch.empty((m, n_obj), dtype=torch.float32, device=q.device)
    qt, q2, _ = _prep_f32(lib, q, -(-m // _F32_BM) * _F32_BM, _F32_BM,
                          stream, out=out if split else None, n_obj=n_obj)
    return qt, q2, out


def f32_bank(lib, r: torch.Tensor, rows: int, stream: int, perm=None,
             bias=None, lab=None):
    """The bank side of a float32 kernel, in one launch of
    ``dist_prep_f32``: row ``n < R`` from source row ``perm[n]`` as ``-2 r``
    (exact) in k-major steps ``[rows / 64, Cp, 64]``, its norm ``‖r‖²
    (+ bias)`` and (with ``lab``) its labels; rows past R are zero with
    norm +inf, so they never win.  Returns ``(rb, r2, labs)``."""
    return _prep_f32(lib, r, rows, _BN, stream, perm=perm, bias=bias,
                     lab=lab, scale=-2.0, pad_norm=float("inf"))


def tc_query(lib, q: torch.Tensor, n_obj: int, n_steps: int, stream: int):
    """The query side of a tensor-core kernel, in one launch of
    ``dist_prep_query``: bf16 rows ``[M, Cp]`` (C rounded up to a multiple
    of 16, the MMA depth, with zeros: they change no distance), float32
    norms ``[M]`` of the unrounded rows, and the ``[M, n_obj]`` output,
    filled with +inf when the bank is split over several CTAs.  Returns
    ``(qb, q2, out, steps_per_split)``."""
    m, c = q.shape
    cp = -(-c // 16) * 16
    if cp > _TC_MAX_C:
        raise ValueError(f"tensor-core kernels take C <= {_TC_MAX_C} (got {c})")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per = tc_steps_per_split(m, n_steps, sms)
    qf = q.float().contiguous()
    qb = torch.empty((m, cp), dtype=torch.bfloat16, device=q.device)
    q2 = torch.empty((m,), dtype=torch.float32, device=q.device)
    out = torch.empty((m, n_obj), dtype=torch.float32, device=q.device)
    fn = lib.dist_prep_query
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    _cuda.check(fn(qf.data_ptr(), qb.data_ptr(), q2.data_ptr(),
                   out.data_ptr() if per < n_steps else None, m, c, cp, n_obj,
                   stream), "dist_prep_query")
    return qb, q2, out, per


def tc_bank(lib, r: torch.Tensor, rows: int, stream: int, perm=None,
            bias=None, lab=None):
    """The bank side of a tensor-core kernel, in one launch of
    ``dist_prep_bank``: row ``n < R`` from source row ``perm[n]`` (``n``
    without ``perm``) as bf16 ``-2 r`` ``[rows, Cp]``, its float32 norm
    ``‖r‖² (+ bias)`` and (with ``lab``) its labels; rows past R are zero
    with norm +inf, so they never win.  Returns ``(rb, r2, labs)``."""
    n, c = r.shape
    cp = -(-c // 16) * 16
    rf = r.float().contiguous()
    bf = None if bias is None else bias.float().contiguous()
    lf = None if lab is None else lab.float().contiguous()
    o = 0 if lab is None else lab.shape[1]
    rb = torch.empty((rows, cp), dtype=torch.bfloat16, device=r.device)
    r2 = torch.empty((rows,), dtype=torch.float32, device=r.device)
    labs = None if lab is None else torch.empty((n, o), dtype=torch.float32,
                                                device=r.device)
    fn = lib.dist_prep_bank
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    _cuda.check(fn(rf.data_ptr(), _ptr(perm), _ptr(bf), -2.0, rb.data_ptr(),
                   r2.data_ptr(), _ptr(lf), _ptr(labs), n, rows, c, cp, o,
                   float("inf"), stream), "dist_prep_bank")
    return rb, r2, labs


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
    tobj = tile_obj.to(device=q.device, dtype=torch.int32).contiguous()
    lib = _cuda.load("global_seg_map")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_steps = p // _BN
    if mixed:
        qb, q2, out, per = tc_query(lib, q, n_obj, n_steps, stream)
        rb, r2b, _ = tc_bank(lib, r, p, stream, bias=bias)
        fn = lib.global_seg_map_mma_launch
        args = (qb.data_ptr(), q2.data_ptr(), rb.data_ptr(), r2b.data_ptr(),
                tobj.data_ptr(), out.data_ptr(), m, n_steps, qb.shape[1],
                n_obj, tr // _BN, per, stream)
    else:
        cp = f32_depth(c)
        per = f32_steps_per_split(m, n_steps, f32_slots(
            lib, "global_seg_map", cp, n_obj, q.device))
        qt, q2, out = f32_query(lib, q, n_obj, per < n_steps, stream)
        rb, r2b, _ = f32_bank(lib, r, p, stream, bias=bias)
        fn = lib.global_seg_map_f32_launch
        args = (qt.data_ptr(), q2.data_ptr(), rb.data_ptr(), r2b.data_ptr(),
                tobj.data_ptr(), out.data_ptr(), m, cp, n_steps, n_obj,
                tr // _BN, per, stream)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _cuda.check(fn(*args), "global_seg_map")
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
