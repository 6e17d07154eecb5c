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

JAX's gradient of ``min`` splits a tie among the equal entries; the
float32 routes give it all to the winner.  Exact float32 ties are rare
away from the 5e4 sentinel, where the squash saturates and the gradient
is ~0 either way.

bfloat16 inputs (bf16 training, ``MATCHING_DTYPE="bfloat16"``):

* ``GlobalMatchingMin`` computes in float32 from the bf16 operands (the
  JAX VJP's ``preferred_element_type=float32``) and returns the
  gradients in the inputs' dtype.
* ``LocalMatchingMin`` takes JAX's bf16 route: the distance cube
  ``(‖x‖² + ‖y′‖²) − 2x·y′`` rounded to bf16 at each operation (norms
  and cross terms accumulated in float32, then rounded), mins in bf16.
  On a bf16 cube ties are common, so its backward reproduces JAX's
  split: the mins are recomputed from the saved cube with autograd in
  the JAX scan's own order (``_ROW_GROUP`` window rows a step, nested
  radius windows, the running min), where ``amin`` spreads a tie evenly
  and ``minimum`` halves it, as ``jnp.min`` and ``jnp.minimum`` do;
  the cube's gradient then goes back to ``x`` and ``ys`` a window row
  at a time.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .cuda_local import _window
from .matching import shard_rows

_PEN = 5e4
_VJP_TILE_R = 4096
# window rows per step of the JAX package's local-matching scan
# (``LOCAL_MATCH_ROW_GROUP``'s default); it fixes how a bf16 tie's
# gradient is split
_ROW_GROUP = 5


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


def _arith_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 for bf16 or float32 operands, float64 for float64."""
    return torch.promote_types(t.dtype, torch.float32)


class GlobalMatchingMin(torch.autograd.Function):
    """[M, O] per-object min distances over a flat bank; gradients to
    ``q`` and ``r`` through the argmin pairs only."""

    @staticmethod
    def forward(ctx, q, r, lab):
        dt = _arith_dtype(q)
        dmin, amin = global_min_argmin(q.to(dt), r.to(dt), lab)
        ctx.save_for_backward(q, r, amin)
        return dmin

    @staticmethod
    def backward(ctx, g):
        q, r, amin = ctx.saved_tensors
        dq, dr = global_min_backward(q.to(_arith_dtype(q)), r, amin, g)
        return dq.to(q.dtype), dr, None


def global_matching_min(q: torch.Tensor, r: torch.Tensor, lab: torch.Tensor,
                        devices: Optional[Sequence] = None) -> torch.Tensor:
    """q [M, C], r [R, C], lab [R, O] → [M, O] (differentiable in q, r).
    ``devices``: context parallelism, ``GlobalMatchingMin`` on each
    query-row shard (``ops.matching.shard_rows``) with the bank copied to
    each device; the bank's gradient is the sum of the shards', which
    autograd forms through the copies."""
    if devices is None:
        return GlobalMatchingMin.apply(q, r, lab)
    return shard_rows(GlobalMatchingMin.apply, q, devices, r, lab)


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


def _bf16_row(x: torch.Tensor, ys: torch.Tensor, dy: int, pad_d: int,
              a: int) -> torch.Tensor:
    """Window row ``dy`` of JAX's bf16 distance cube → [S, h, w, K] bf16:
    ``(‖x‖² + ‖y′‖²) − 2·x·y′`` rounded at each operation, the norms and
    the cross terms accumulated in float32 from the bf16 operands."""
    s_n, h, w, c = ys.shape
    bf = torch.bfloat16
    x2 = x.float().square().sum(-1).to(bf)                        # [h, w]
    oy = dy * a
    y2p = F.pad(ys.float().square().sum(-1), (pad_d,) * 4, value=_PEN)
    cols2 = y2p[:, oy:oy + h].unfold(2, w, a).permute(0, 1, 3, 2).to(bf)
    yp = F.pad(ys, (0, 0) + (pad_d,) * 4)
    band = yp[:, oy:oy + h].unfold(2, w, a)                   # [S,h,K,C,w]
    cross = torch.einsum("shkcw,hwc->shwk", band.float(), x.float()).to(bf)
    return (x2[None, :, :, None] + cols2) - 2.0 * cross


def _bf16_cube(x, ys, pad_d, a, k) -> torch.Tensor:
    """The whole bf16 distance cube [S, K (rows), h, w, K (columns)]."""
    return torch.stack([_bf16_row(x, ys, dy, pad_d, a) for dy in range(k)],
                       1)


def _bf16_tree_mins(cube: torch.Tensor, labels: torch.Tensor,
                    radii: Sequence[int], atrous_rate: int) -> torch.Tensor:
    """The multi-radius masked mins of a bf16 cube in the JAX scan's
    order of operations → [S, h, w, O, n_r] float32 (differentiable in
    ``cube``, with JAX's split of a tied gradient)."""
    order, a_max, pad_d = _window(radii, atrous_rate)
    a = atrous_rate
    s_n, k, h, w, _ = cube.shape
    o = labels.shape[-1]
    g_n = min(_ROW_GROUP, k)
    n_steps = -(-k // g_n)
    dev = cube.device
    labp = F.pad(labels.float(), (0, 0) + (pad_d,) * 4)
    # label of the shifted pixel, [K rows, h, w, K cols, O]; rows past
    # the window (the ragged last group) carry none
    lab = torch.stack([labp[dy * a:dy * a + h].unfold(1, w, a)
                       .permute(0, 3, 1, 2) > 0.9 for dy in range(k)])
    extra = n_steps * g_n - k
    if extra:
        cube = torch.cat([cube, cube.new_zeros(
            (s_n, extra) + cube.shape[2:])], 1)
        lab = torch.cat([lab, lab.new_zeros((extra,) + lab.shape[1:])])
    pen = torch.tensor(_PEN, dtype=cube.dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=cube.dtype, device=dev)
    asc = sorted(set(order))
    carry = [torch.full((s_n, h, w, o), float("inf"), dtype=cube.dtype,
                        device=dev) for _ in order]
    for step in range(n_steps):
        rows = slice(step * g_n, (step + 1) * g_n)
        dm = torch.where(lab[rows][None], cube[:, rows][..., None], pen)
        cands, cur, lo_p, hi_p = {}, None, None, None
        for r in asc:
            lo, hi = a_max - r, a_max + r + 1
            if cur is None:
                cur = dm[:, :, :, :, lo:hi].amin(4)              # [S,G,h,w,O]
            else:
                if lo < lo_p:
                    cur = torch.minimum(cur, dm[:, :, :, :, lo:lo_p].amin(4))
                if hi > hi_p:
                    cur = torch.minimum(cur, dm[:, :, :, :, hi_p:hi].amin(4))
            cands[r], lo_p, hi_p = cur, lo, hi
        dy_off = (torch.arange(step * g_n, (step + 1) * g_n, device=dev)
                  - a_max).abs()
        for i, r in enumerate(order):
            gate = (dy_off <= r)[None, :, None, None, None]
            carry[i] = torch.minimum(
                carry[i], torch.where(gate, cands[r], inf).amin(1))
    return torch.stack(carry, -1).float()


class LocalMatchingMin(torch.autograd.Function):
    """``[S, h, w, O, n_r]`` windowed multi-radius masked mins.  Float32
    (float64) inputs: gradients to ``x`` and ``ys`` through the winning
    offsets only.  bf16 inputs: JAX's bf16 cube and its tie split."""

    @staticmethod
    def forward(ctx, x, ys, labels, radii, atrous_rate):
        ctx.window = (radii, atrous_rate)
        if x.dtype == torch.bfloat16:
            _, a_max, pad_d = _window(radii, atrous_rate)
            cube = _bf16_cube(x, ys.to(x.dtype), pad_d, atrous_rate,
                              2 * a_max + 1)
            ctx.save_for_backward(x, ys, labels, cube)
            return _bf16_tree_mins(cube, labels, radii, atrous_rate)
        out, idx = local_min_argmin(x, ys, labels, radii, atrous_rate)
        ctx.save_for_backward(x, ys, labels, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if saved[0].dtype != torch.bfloat16:
            dx, dys = local_min_backward(*saved, g, *ctx.window)
            return dx, dys, None, None, None
        x, ys, labels, cube = saved
        radii, a = ctx.window
        _, a_max, pad_d = _window(radii, a)
        k = 2 * a_max + 1
        with torch.enable_grad():
            leaf = cube.detach().requires_grad_()
            g_cube, = torch.autograd.grad(
                _bf16_tree_mins(leaf, labels, radii, a), leaf, g)
            # the cube's gradient back to the operands one window row at
            # a time (each row's graph is freed before the next)
            xl = x.detach().float().requires_grad_()
            yl = ys.detach().float().requires_grad_()
            for dy in range(k):
                row = _bf16_row(xl.to(x.dtype), yl.to(x.dtype), dy, pad_d, a)
                torch.autograd.backward(row, g_cube[:, dy])
        return xl.grad.to(x.dtype), yl.grad.to(ys.dtype), None, None, None


def local_matching_min(x: torch.Tensor, ys: torch.Tensor,
                       labels: torch.Tensor, radii: Sequence[int],
                       atrous_rate: int = 1) -> torch.Tensor:
    """x [h, w, C], ys [S, h, w, C], labels [h, w, O] → raw multi-radius
    masked mins [S, h, w, O, n_r] (differentiable in x and ys); the
    signature of ``cuda_local.local_match``."""
    return LocalMatchingMin.apply(x, ys, labels, tuple(int(r) for r in radii),
                                  int(atrous_rate))
