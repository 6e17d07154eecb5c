"""Kernel 3: global matching over any flat bank (B.3).

Replaces ``rvos_tpu/ops/pallas_matching.py::_kernel`` (wrapper
``global_matching_pallas``): for query rows ``q [M, C]``, a bank
``r [R, C]`` and labels ``lab [R, O]``,

    out[m, o] = min over r of ‖q_m − r‖² + (1 − lab[r, o])·5e4

with no assumption that the labels are one-hot.  The evaluator takes this
route whenever its bank is not label-segmented: no cap
(``MATCHING_MAX_REF_PIXELS=0``), the fg-union compaction
(``MATCHING_SEGMENTED_BANK=False``) and the bank ``segment_frame``
flattens inline.  Mixed mode takes the cross term from bf16-rounded
operands with float32 accumulation; norms, penalty and the min stay
float32, as in kernel 1.  The Pallas kernel also rounds each penalised
distance to bf16 and takes its min in bf16, so a penalised entry
(≈ 5e4, bf16 ulp 256) may differ from this one by a few hundred; both
squash to 1.0.  Its wrapper pads ``R`` with zero rows penalised for
every object; the kernel skips rows past ``R`` instead.

What bounds it on the H100, and what the design does about it: see
``csrc/global_flat_match.cu``.  ``global_flat_min`` launches that kernel
for CUDA tensors (or raises) and runs ``global_flat_min_plain`` for CPU
tensors; ``global_flat_min.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .cuda_matching import prepare_operands

_PEN = 5e4
_MAX_OBJ = 32     # running mins per (row, object) live in registers


def global_flat_min_plain(q: torch.Tensor, r: torch.Tensor, lab: torch.Tensor,
                          mixed: bool = True, tile_r: int = 4096
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, ``tile_r`` bank rows at a
    time so that ``[M, R]`` never exists → ``[M, O]`` float32."""
    q32, q2, r32, r2 = prepare_operands(q, r, mixed)
    m, o = q.shape[0], lab.shape[1]
    best = torch.full((m, o), float("inf"), dtype=torch.float32,
                      device=q.device)
    for s in range(0, r.shape[0], tile_r):
        rows = slice(s, s + tile_r)
        d = q2[:, None] + r2[None, rows] - 2.0 * (q32 @ r32[rows].T)
        pen = (1.0 - lab[rows].float()) * _PEN
        for oo in range(o):
            best[:, oo] = torch.minimum(
                best[:, oo], (d + pen[None, :, oo]).min(dim=1).values)
    return best


def global_flat_min(q: torch.Tensor, r: torch.Tensor, lab: torch.Tensor,
                    mixed: bool = True, tile_r: int = 4096) -> torch.Tensor:
    """q [M, C]; r [R, C]; lab [R, O] → per-object min distances [M, O].
    ``tile_r`` is the plain version's chunk of bank rows."""
    m, c = q.shape
    n_rows, o = lab.shape
    if r.shape != (n_rows, c) or m == 0 or n_rows == 0:
        raise ValueError(f"global_flat_min: shapes q{tuple(q.shape)} "
                         f"r{tuple(r.shape)} lab{tuple(lab.shape)} do not fit")
    if r.device != q.device or lab.device != q.device:
        raise ValueError(f"global_flat_min: q on {q.device}, r on {r.device}, "
                         f"lab on {lab.device}: one device expected")
    if q.device.type == "cpu":
        return global_flat_min_plain(q, r, lab, mixed, tile_r)
    if q.device.type != "cuda":
        raise ValueError(f"global_flat_min: unsupported device {q.device}")
    if o > _MAX_OBJ:
        raise ValueError(f"kernel takes at most {_MAX_OBJ} objects (got {o})")
    q32, q2, r32, r2 = prepare_operands(q, r, mixed)
    qt = q32.t().contiguous()
    rt = r32.t().contiguous()
    q2, r2 = q2.contiguous(), r2.contiguous()
    pen_t = ((1.0 - lab.float()) * _PEN).t().contiguous()
    out = torch.empty((m, o), dtype=torch.float32, device=q.device)
    lib = _cuda.load("global_flat_match")
    fn = lib.global_flat_match_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    err = fn(qt.data_ptr(), q2.data_ptr(), rt.data_ptr(), r2.data_ptr(),
             pen_t.data_ptr(), out.data_ptr(), m, n_rows, c, o,
             torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "global_flat_min")
    global_flat_min.launches += 1
    return out


global_flat_min.launches = 0
