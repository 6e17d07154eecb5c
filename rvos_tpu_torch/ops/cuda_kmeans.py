"""The AOP stream's masked k-means as one hand-written kernel.

Replaces no TPU kernel: the JAX package runs its k-means
(``rvos_tpu/ops/kmeans.py``) as XLA ``dot``s, and the port's plain
``ops.kmeans._masked_kmeans`` as batched ``torch.matmul`` over all O
object channels, though a bank row carries at most one object's label.
The kernel does per row only the work of the object that the row
belongs to: the rows are bucketed by object once, and every Lloyd pass
runs over tiles that never cross an object's boundary.

What bounds it on the H100, and what the design does about it: see
``csrc/kmeans.cu``.  ``masked_kmeans`` takes CUDA tensors only (the
caller, ``ops.kmeans.cluster_objects``, runs the plain version on CPU
tensors); ``masked_kmeans.launches`` counts its calls: eager calls (a
capture's warm-up run among them) and captures, not the graph's replays
(a replay runs no Python).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

_MAX_C = 128
_MAX_K = 32
_MAX_OBJ = 32


@functools.lru_cache(maxsize=1)
def _entry_points():
    """The library's two C entry points, typed once (the library is built
    at first use)."""
    lib = _cuda.load("kmeans")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    size = lib.kmeans_scratch_bytes
    size.restype = i64
    size.argtypes = [i32] * 4
    run = lib.kmeans_launch
    run.restype = i32
    run.argtypes = ([vp, i32, i64, i64, vp, i32, i64, i64, vp, i64, vp]
                    + [i32] * 6 + [vp] * 5)
    return size, run


def masked_kmeans(points: torch.Tensor, weights: torch.Tensor,
                  scores: torch.Tensor, k: int, iters: int,
                  mixed: bool = False):
    """points [R, C]; weights, scores [O, R] → ``(centroids [O, K, C],
    cent_valid [O, K], means [O, K, C], mean_valid [O, K])``, the function
    of ``ops.kmeans._masked_kmeans`` on CUDA tensors.

    Contract: every row carries at most one object's weight (the first
    object whose weight is not 0 takes the row), as every caller's one-hot
    labels times ``obj_valid`` do.  The weights are used as given: a row's
    weight multiplies its contribution to the sums and the counts.  The
    initial centroids are the plain version's, the top ``k`` rows of
    ``scores * weights`` by a stable sort.  Points and weights are float32
    or bf16; C <= 128, k <= 32, O <= 32 and k <= R, else this raises.
    The result differs from the plain version only by the order of float32
    sums, and is the same bit for bit from run to run."""
    r, c = points.shape
    o = weights.shape[0]
    if weights.shape != (o, r) or scores.shape != (o, r):
        raise ValueError(f"shapes points{tuple(points.shape)} weights"
                         f"{tuple(weights.shape)} scores"
                         f"{tuple(scores.shape)} do not fit")
    if points.device.type != "cuda":
        raise ValueError(f"masked_kmeans: CUDA tensors only (got "
                         f"{points.device})")
    if weights.device != points.device or scores.device != points.device:
        raise ValueError(f"points on {points.device}, weights on "
                         f"{weights.device}, scores on {scores.device}: one "
                         f"device expected")
    if c > _MAX_C or k > _MAX_K or o > _MAX_OBJ:
        raise ValueError(f"kernel takes C <= {_MAX_C}, k <= {_MAX_K} and at "
                         f"most {_MAX_OBJ} objects (got {c}, {k}, {o})")
    if not 1 <= k <= r or iters < 0:
        raise ValueError(f"kernel takes 1 <= k <= R and iters >= 0 (got k "
                         f"{k}, R {r}, iters {iters})")
    for name, t in (("points", points), ("weights", weights)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"kernel takes float32 or bfloat16 {name} (got "
                             f"{t.dtype})")
    s = scores.float() * weights.float()
    top = torch.sort(s, dim=-1, descending=True, stable=True)
    top_idx = top.indices[:, :k]
    cent_valid = (top.values[:, :k] > 0.0).contiguous()
    dev = points.device
    size, run = _entry_points()
    scratch = torch.empty(size(r, c, o, k), dtype=torch.uint8, device=dev)
    cent = torch.empty((o, k, c), dtype=torch.float32, device=dev)
    means = torch.empty_like(cent)
    mean_valid = torch.empty((o, k), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = run(points.data_ptr(), int(points.dtype == torch.bfloat16),
                  *points.stride(), weights.data_ptr(),
                  int(weights.dtype == torch.bfloat16), *weights.stride(),
                  top_idx.data_ptr(), top_idx.stride(0),
                  cent_valid.data_ptr(), r, c, o, k, iters, int(mixed),
                  scratch.data_ptr(), cent.data_ptr(), means.data_ptr(),
                  mean_valid.data_ptr(), stream)
    _cuda.check(err, "masked_kmeans")
    masked_kmeans.launches += 1
    return cent, cent_valid, means, mean_valid


masked_kmeans.launches = 0
