"""The training route's matching, differentiable (PyTorch port of
``rvos_tpu/ops/matching.py``'s ``global_matching_min`` custom VJP and of
the XLA scan ``_local_matching_online_stacked`` as training
differentiates it).

The port's four CUDA kernels have no backward, so training never calls
them: these two ``torch.autograd.Function``s run plain PyTorch on any
device (``torch.matmul`` for the cross terms; TF32 stays off for
matmuls, ``device.configure_precision``), in the inputs' dtype (float32
in training, float64 for ``gradcheck``).  Each forward keeps the
winning bank row or window offset, and the backward touches only those
pairs:

    d = ‖x − y_a‖² (+ penalty)   ∂/∂x = 2g(x − y_a),   ∂/∂y_a = −2g(x − y_a)

* ``GlobalMatchingMin``: per object the min over the bank of
  ‖q − r‖² + (1 − lab)·5e4, ``4096`` bank rows a tile (``_VJP_TILE_R``),
  the first index winning within a tile and a strict ``<`` across tiles,
  so the lowest row wins a tie, as in JAX.  The last tile is padded with
  zero rows and zero labels and an index past the bank is clamped to its
  last row, as in JAX.  No gradient reaches the labels.
* ``LocalMatchingMin``: the windowed multi-radius min over ``S``
  previous frames: a candidate is ‖x‖² + ‖y′‖² − 2x·y′ where the
  shifted pixel carries the object's label, else exactly 5e4 (out of
  the frame the label is 0), with the running min per (radius, object)
  from +inf; one window row at a time, vectorised over the columns; the
  first offset in row-major window order wins a tie.  Output
  ``[S, h, w, O, n_r]``, channel order ``[full radius, radii[:-1]]``.
  A 5e4 winner gets no gradient, as in JAX (a constant there).

JAX's gradient of ``min`` splits a tie among the equal entries; these
give it all to the winner.  Exact float32 ties are rare away from the
5e4 sentinel, where the squash saturates and the gradient is ~0 either
way.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .cuda_local import _window

_PEN = 5e4
_VJP_TILE_R = 4096


def global_min_argmin(q: torch.Tensor, r: torch.Tensor, lab: torch.Tensor,
                      tile_r: int = _VJP_TILE_R):
    """q [M, C], r [R, C], lab [R, O] → (min [M, O], argmin [M, O] int64),
    in q's dtype, the JAX package's tiling and tie rule."""
    m = q.shape[0]
    n_rows, o = lab.shape
    dt = q.dtype
    n_tiles = max(1, -(-n_rows // tile_r))
    pad = n_tiles * tile_r - n_rows
    if pad:
        r = torch.cat([r, r.new_zeros((pad, r.shape[1]))])
        lab = torch.cat([lab, lab.new_zeros((pad, o))])
    q2 = q.square().sum(-1)
    best = torch.full((m, o), float("inf"), dtype=dt, device=q.device)
    best_i = torch.zeros((m, o), dtype=torch.int64, device=q.device)
    for t in range(n_tiles):
        re = r[t * tile_r:(t + 1) * tile_r].to(dt)
        rl = lab[t * tile_r:(t + 1) * tile_r].to(dt)
        d = q2[:, None] + re.square().sum(-1)[None] - 2.0 * (q @ re.T)
        pen = (1.0 - rl) * _PEN
        for oo in range(o):
            mn, am = (d + pen[None, :, oo]).min(dim=1)
            take = mn < best[:, oo]
            best[:, oo] = torch.where(take, mn, best[:, oo])
            best_i[:, oo] = torch.where(take, am + t * tile_r, best_i[:, oo])
    return best, best_i.clamp(max=n_rows - 1)


def global_min_backward(q: torch.Tensor, r: torch.Tensor, amin: torch.Tensor,
                        g: torch.Tensor):
    """The gradients of ``global_min_argmin``'s mins at the winners
    ``amin`` [M, O] for the output gradient ``g`` [M, O] → (dq, dr)."""
    m, c = q.shape
    o = amin.shape[1]
    diff = q[:, None, :] - r.to(q.dtype)[amin.reshape(-1)].reshape(m, o, c)
    gd = 2.0 * g[:, :, None].to(q.dtype) * diff                    # [M, O, C]
    dr = torch.zeros(r.shape, dtype=q.dtype, device=r.device)
    dr.index_add_(0, amin.reshape(-1), -gd.reshape(m * o, c))
    return gd.sum(1), dr.to(r.dtype)


class GlobalMatchingMin(torch.autograd.Function):
    """[M, O] per-object min distances over a flat bank; gradients to
    ``q`` and ``r`` through the argmin pairs only."""

    @staticmethod
    def forward(ctx, q, r, lab):
        dmin, amin = global_min_argmin(q, r.to(q.dtype), lab)
        ctx.save_for_backward(q, r, amin)
        return dmin

    @staticmethod
    def backward(ctx, g):
        dq, dr = global_min_backward(*ctx.saved_tensors, g)
        return dq, dr, None


def global_matching_min(q: torch.Tensor, r: torch.Tensor,
                        lab: torch.Tensor) -> torch.Tensor:
    """q [M, C], r [R, C], lab [R, O] → [M, O] (differentiable in q, r)."""
    return GlobalMatchingMin.apply(q, r, lab)


def local_min_argmin(x: torch.Tensor, ys: torch.Tensor, labels: torch.Tensor,
                     radii: Sequence[int], atrous_rate: int = 1):
    """x [h, w, C], ys [S, h, w, C], labels [h, w, O] → (mins
    [S, h, w, O, n_r], winning window offsets ``dy·K + dx`` of the same
    shape, int64), in x's dtype."""
    s_n, h, w, c = ys.shape
    o = labels.shape[-1]
    dt = x.dtype
    order, a_max, pad_d = _window(radii, atrous_rate)
    a = atrous_rate
    k = 2 * a_max + 1
    asc = sorted(set(order))
    x2 = x.square().sum(-1)                                       # [h, w]
    yp = F.pad(ys.to(dt), (0, 0, pad_d, pad_d, pad_d, pad_d))
    y2p = F.pad(ys.to(dt).square().sum(-1), (pad_d, pad_d, pad_d, pad_d),
                value=_PEN)
    labp = F.pad(labels.to(dt), (0, 0, pad_d, pad_d, pad_d, pad_d))
    best = torch.full((len(asc), s_n, h, w, o), float("inf"), dtype=dt,
                      device=x.device)
    best_i = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    pen = torch.tensor(_PEN, dtype=dt, device=x.device)
    for dy in range(k):
        oy = dy * a
        # the K column shifts of this window row: [S, h, K, C, w] views
        band = yp[:, oy:oy + h].unfold(2, w, a)
        cross = torch.einsum("shkcw,hwc->shwk", band, x)
        cols2 = y2p[:, oy:oy + h].unfold(2, w, a).permute(0, 1, 3, 2)
        d = x2[None, :, :, None] + cols2 - 2.0 * cross           # [S,h,w,K]
        lcols = labp[oy:oy + h].unfold(1, w, a).permute(0, 3, 1, 2)
        dm = torch.where(lcols[None] > 0.9, d[..., None], pen)   # [S,h,w,K,O]
        for ri, rad in enumerate(asc):
            if abs(dy - a_max) > rad:
                continue
            lo = a_max - rad
            mn, am = dm[:, :, :, lo:a_max + rad + 1].min(dim=3)
            take = mn < best[ri]
            best[ri] = torch.where(take, mn, best[ri])
            best_i[ri] = torch.where(take, am + (dy * k + lo), best_i[ri])
    sel = [asc.index(r) for r in order]
    return (best[sel].permute(1, 2, 3, 4, 0),
            best_i[sel].permute(1, 2, 3, 4, 0))


def local_min_backward(x: torch.Tensor, ys: torch.Tensor, labels: torch.Tensor,
                       idx: torch.Tensor, g: torch.Tensor, radii: Sequence[int],
                       atrous_rate: int = 1):
    """The gradients of ``local_min_argmin``'s mins at the winning
    offsets ``idx`` for the output gradient ``g`` → (dx, dys); a winner
    of 5e4 (no labelled pixel there) passes none."""
    _, a_max, pad_d = _window(radii, atrous_rate)
    a = atrous_rate
    k = 2 * a_max + 1
    s_n, h, w, c = ys.shape
    o = idx.shape[-2]
    dt = x.dtype
    hp, wp = h + 2 * pad_d, w + 2 * pad_d
    dev = x.device
    py = torch.arange(h, device=dev)[None, :, None, None, None]
    px = torch.arange(w, device=dev)[None, None, :, None, None]
    sy = py + (idx // k) * a                            # padded source row
    sx = px + (idx % k) * a
    oi = torch.arange(o, device=dev)[None, None, None, :, None]
    labp = F.pad(labels.to(dt), (0, 0, pad_d, pad_d, pad_d, pad_d))
    real = labp[sy, sx, oi.expand_as(sy)] > 0.9          # [S,h,w,O,n_r]
    si = torch.arange(s_n, device=dev)[:, None, None, None, None]
    flat = ((si * hp + sy) * wp + sx).reshape(-1)
    yp = F.pad(ys.to(dt), (0, 0, pad_d, pad_d, pad_d, pad_d))
    y_a = yp.reshape(-1, c)[flat].reshape(idx.shape + (c,))
    gg = torch.where(real, 2.0 * g.to(dt), torch.zeros((), dtype=dt,
                                                        device=dev))
    gd = gg[..., None] * (x[None, :, :, None, None, :] - y_a)
    dyp = torch.zeros((s_n * hp * wp, c), dtype=dt, device=dev)
    dyp.index_add_(0, flat, -gd.reshape(-1, c))
    dys = dyp.reshape(s_n, hp, wp, c)[:, pad_d:pad_d + h, pad_d:pad_d + w]
    return gd.sum((0, 3, 4)), dys.to(ys.dtype)


class LocalMatchingMin(torch.autograd.Function):
    """``[S, h, w, O, n_r]`` windowed multi-radius masked mins; gradients
    to ``x`` and ``ys`` through the winning offsets only."""

    @staticmethod
    def forward(ctx, x, ys, labels, radii, atrous_rate):
        out, idx = local_min_argmin(x, ys, labels, radii, atrous_rate)
        ctx.save_for_backward(x, ys, labels, idx)
        ctx.window = (radii, atrous_rate)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dys = local_min_backward(*ctx.saved_tensors, g, *ctx.window)
        return dx, dys, None, None, None


def local_matching_min(x: torch.Tensor, ys: torch.Tensor,
                       labels: torch.Tensor, radii: Sequence[int],
                       atrous_rate: int = 1) -> torch.Tensor:
    """x [h, w, C], ys [S, h, w, C], labels [h, w, O] → raw multi-radius
    masked mins [S, h, w, O, n_r] (differentiable in x and ys); the
    signature of ``cuda_local.local_match``."""
    return LocalMatchingMin.apply(x, ys, labels, tuple(int(r) for r in radii),
                                  int(atrous_rate))
