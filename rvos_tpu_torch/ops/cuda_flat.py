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
operands with float32 accumulation, on the tensor cores; norms, penalty
and the min stay float32, as in kernel 1.  It walks the bank in the
order of ``flat_route``: sorted by label key, each 64-row step tagged
pure (one object, or all zero) or mixed, so that a pure step needs one
min per (query, row) pair instead of O.  Float32 mode walks the same
route with the cross term in float32 on the FMA units (never TF32).
The Pallas kernel also rounds each penalised distance to bf16 and takes
its min in bf16, so a penalised entry (≈ 5e4, bf16 ulp 256) may differ
from this one by a few hundred; both squash to 1.0.  Its wrapper pads
``R`` with zero rows penalised for every object; the kernel skips rows
past ``R`` instead.

What bounds it on the H100, and what the design does about it: see
``csrc/global_flat_match.cu``.  ``global_flat_min`` launches that kernel
for CUDA tensors (or raises) and runs ``global_flat_min_plain`` for CPU
tensors; ``global_flat_min.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda
from .cuda_matching import (_BN, f32_bank, f32_depth, f32_query, f32_slots,
                            f32_steps_per_split, prepare_operands, tc_bank,
                            tc_query)

_PEN = 5e4
_MAX_OBJ = 32     # a CTA's [128, O] block of mins lives in shared memory
MIXED = -2        # step tag: more than one key, or a general row


def flat_route(lab: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot route of the kernel (both modes) over a bank with labels
    ``lab [R, O]`` → ``(perm [R] int64, tags [ceil(R / 64)] int32)``.

    Each row gets a key: ``o`` when its labels are exactly one-hot at
    ``o``, -1 when they are all zero, ``O`` (general) when any entry is
    not 0 or 1 or more than one is 1.  ``perm`` sorts the rows by key,
    stably.  Step ``s`` holds sorted rows ``[64 s, 64 (s+1))``; its tag
    is its key when every row of it has that key and the key is not
    general (rows past R do not count), else ``MIXED``.  For a pure step
    the per-object min is min(B_o, A + 5e4) over its rows; a mixed step
    takes the general penalised min.

    Plain PyTorch for a CPU tensor.  For a CUDA tensor the same function
    runs as two small kernels around one ``torch.sort`` (keys, then
    tags), since the plain version's two dozen launches cost
    more host time per call than the fg-union bank's kernel costs the
    card; neither synchronises with the host."""
    n, o = lab.shape
    if lab.device.type == "cuda":
        return _flat_route_cuda(lab)
    lf = lab.float()
    one = lf == 1.0
    n_one = one.sum(1)
    clean = ((lf == 0.0) | one).all(1) & (n_one <= 1)
    obj = (one.long() * torch.arange(o, device=lab.device)).sum(1)
    key = torch.where(n_one == 1, obj, torch.full_like(obj, -1))
    key = torch.where(clean, key, torch.full_like(obj, o))
    perm = torch.sort(key, stable=True).indices
    n_steps = -(-n // _BN)
    ks = key[perm]
    ks = torch.cat([ks, ks[-1:].expand(n_steps * _BN - n)]).view(n_steps, _BN)
    first = ks[:, 0]
    pure = (ks == first[:, None]).all(1) & (first < o)
    tags = torch.where(pure, first, torch.full_like(first, MIXED))
    return perm, tags.to(torch.int32)


def _flat_route_cuda(lab: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, o = lab.shape
    lib = _cuda.load("global_flat_match")
    stream = torch.cuda.current_stream(lab.device).cuda_stream
    lf = lab.float().contiguous()
    key = torch.empty((n,), dtype=torch.int32, device=lab.device)
    fn = lib.global_flat_keys_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    _cuda.check(fn(lf.data_ptr(), n, o, key.data_ptr(), stream), "flat keys")
    skey, perm = torch.sort(key, stable=True)
    tags = torch.empty((-(-n // _BN),), dtype=torch.int32, device=lab.device)
    fn = lib.global_flat_tags_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    _cuda.check(fn(skey.data_ptr(), n, o, tags.data_ptr(), stream),
                "flat tags")
    return perm, tags


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


def _launch(lib, q: torch.Tensor, r: torch.Tensor, lab: torch.Tensor,
            mixed: bool, stream: int) -> torch.Tensor:
    """The kernel over the bank in ``flat_route``'s order: the rows, norms
    (+inf on padding rows) and labels gathered by ``perm``, on the tensor
    cores (mixed) or the FMA units (float32)."""
    m, n_rows, o = q.shape[0], r.shape[0], lab.shape[1]
    perm, tags = flat_route(lab)
    n_steps = tags.shape[0]
    if mixed:
        qb, q2, out, per = tc_query(lib, q, o, n_steps, stream)
        rb, r2s, labs = tc_bank(lib, r, n_steps * _BN, stream, perm=perm,
                                lab=lab)
        fn = lib.global_flat_match_mma_launch
        args = (qb.data_ptr(), q2.data_ptr(), rb.data_ptr(), r2s.data_ptr(),
                labs.data_ptr(), tags.data_ptr(), out.data_ptr(), m, n_rows,
                n_steps, qb.shape[1], o, per, stream)
    else:
        cp = f32_depth(q.shape[1])
        per = f32_steps_per_split(m, n_steps, f32_slots(
            lib, "global_flat_match", cp, o, q.device))
        qt, q2, out = f32_query(lib, q, o, per < n_steps, stream)
        rb, r2s, labs = f32_bank(lib, r, n_steps * _BN, stream, perm=perm,
                                 lab=lab)
        fn = lib.global_flat_match_f32_launch
        args = (qt.data_ptr(), q2.data_ptr(), rb.data_ptr(), r2s.data_ptr(),
                labs.data_ptr(), tags.data_ptr(), out.data_ptr(), m, n_rows,
                cp, n_steps, o, per, stream)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _cuda.check(fn(*args), "global_flat_min")
    return out


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
    lib = _cuda.load("global_flat_match")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = _launch(lib, q, r, lab, mixed, stream)
    global_flat_min.launches += 1
    return out


global_flat_min.launches = 0
