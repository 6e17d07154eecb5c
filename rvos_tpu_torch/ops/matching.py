"""Pixel-wise global / local / proxy matching (PyTorch port of
``rvos_tpu/ops/matching.py``).

Layouts follow the JAX package at every function boundary: embeddings
``[H, W, C]`` / ``[S, H, W, C]``, one-hot labels ``[..., O]`` with object
channel 0 = background, distance maps ``[H, W, O, k]``.

* The global stream runs through one of three kernels, by bank layout:
  the occupancy-segmented bank through kernel 1
  (``cuda_matching.global_seg_map``), the uniform-quota segmented bank
  through kernel 1's ``global_seg`` entry, and any other flat bank
  through kernel 3 (``cuda_flat.global_flat_min``).
* The local stream runs through kernel 2 (``cuda_local.local_match``),
  both previous embeddings of a frame in one launch.
* Bank compaction ranks rows by float32 scores whose hash tie-breaks
  collide over large banks; ``lax.top_k`` puts the lower index first on
  ties, so every top-k and argsort here is a stable sort — the same rows
  land in the same tiles as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .cuda_flat import global_flat_min
from .cuda_local import local_match
from .cuda_matching import global_seg, global_seg_map, uniform_tile_obj
from .resize import resize_nchw

WRONG_LABEL_PADDING_DISTANCE = 5e4


def squash_distance(d: torch.Tensor, dis_bias: torch.Tensor) -> torch.Tensor:
    """(sigmoid(d + bias) - 0.5) * 2 — ``d``: [..., O, k]; ``dis_bias``
    [O] broadcast over the trailing k."""
    return (torch.sigmoid(d + dis_bias[..., :, None]) - 0.5) * 2.0


def _hash_tie(r: int, device) -> torch.Tensor:
    """Knuth-hash tie-break in [0, 1): ``idx·2654435761 mod 2³² mod
    (2³¹−1)`` in float32, the JAX package's uint32 arithmetic.  Its
    divisor ``float32(2³¹−1)`` rounds to 2³¹, so dividing by the Python
    scalar is the same exact division, with no tensor copied from the
    host (which would wait for the card's queued work)."""
    idx = torch.arange(r, dtype=torch.int64, device=device)
    h = (idx * 2654435761) & 0xFFFFFFFF
    h = h % 0x7FFFFFFF
    return h.to(torch.float32) / float(0x7FFFFFFF)


def _top_idx(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, lower index
    first among equals (``lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def compact_reference_bank(r_emb: torch.Tensor, r_lab: torch.Tensor,
                           max_pixels: int):
    """Gather up to ``max_pixels`` foreground-union reference pixels
    (object pixels first, then background, hash-ordered within each)."""
    r = r_emb.shape[0]
    if max_pixels >= r:
        return r_emb, r_lab
    valid = (r_lab.sum(-1) > 0.9).float()
    obj = (r_lab[..., 1:].sum(-1) > 0.9).float()
    score = valid * 2.0 + obj * 2.0 + _hash_tie(r, r_emb.device)
    top = _top_idx(score, max_pixels)
    return r_emb[top], r_lab[top] * valid[top][:, None]


def segmented_quota(max_pixels: int, n_obj: int, tile: int = 1024) -> int:
    """Per-object row quota of the uniform-quota segmented bank."""
    return max(tile, (max_pixels // (n_obj * tile)) * tile)


def compact_reference_bank_segmented(r_emb: torch.Tensor, r_lab: torch.Tensor,
                                     max_pixels: int, tile: int = 1024):
    """Uniform-quota label-segmented compaction: object ``o`` owns rows
    ``[o·quota, (o+1)·quota)``, a hash-tied top-k of its own pixels, then
    filler rows with zero labels.  Returns ``(emb [O·quota, C],
    lab [O·quota, O])``."""
    r, o = r_lab.shape
    quota = segmented_quota(max_pixels, o, tile)
    if r < quota:
        r_emb = torch.cat([r_emb, r_emb.new_zeros((quota - r,) + r_emb.shape[1:])])
        r_lab = torch.cat([r_lab, r_lab.new_zeros((quota - r, o))])
        r = quota
    score = r_lab.float().T * 2.0 + _hash_tie(r, r_emb.device)[None]  # [O, R]
    tops = _top_idx(score, quota)                                   # [O, quota]
    sels = r_lab.T.gather(1, tops)                                  # [O, quota]
    seg_obj = torch.arange(o, device=r_emb.device).repeat_interleave(quota)
    lab = (torch.nn.functional.one_hot(seg_obj, o).to(r_lab.dtype)
           * sels.reshape(-1)[:, None])
    return r_emb[tops.reshape(-1)], lab


def compact_reference_bank_occupancy(r_emb: torch.Tensor,
                                     r_lab: torch.Tensor, max_pixels: int,
                                     tile: int = 1024):
    """Occupancy-aware label-segmented compaction: the bank's
    ``max(O, max_pixels // tile)`` tiles go to objects by pixel share
    (one reserved tile per live object, the rest by largest remainder);
    every tile is label-pure.  Returns ``(emb [n_tiles·tile, C],
    lab [n_tiles·tile, O], tile_obj [n_tiles] int32)``."""
    r, o = r_lab.shape
    dev = r_emb.device
    n_tiles = max(o, max_pixels // tile)
    q_max = n_tiles * tile
    if r < q_max:
        r_emb = torch.cat([r_emb, r_emb.new_zeros((q_max - r,) + r_emb.shape[1:])])
        r_lab = torch.cat([r_lab, r_lab.new_zeros((q_max - r, o))])
        r = q_max

    counts = r_lab.float().sum(0)                              # [O]
    live = (counts > 0.5).to(torch.int64)
    n_live = live.sum()
    rem_tiles = torch.clamp(n_tiles - n_live, min=0)
    total = torch.clamp(counts.sum(), min=1.0)
    frac = counts / total * rem_tiles.to(torch.float32)
    extra = torch.floor(frac).to(torch.int64) * live
    leftover = rem_tiles - extra.sum()
    remainder = torch.where(live > 0, frac - torch.floor(frac),
                            torch.full_like(frac, -1.0))
    rank = torch.argsort(torch.argsort(-remainder, stable=True), stable=True)
    extra = extra + ((rank < leftover) & (live > 0)).to(torch.int64)
    tiles_per_obj = live + extra
    overflow = torch.clamp(tiles_per_obj.sum() - n_tiles, min=0)
    crank = torch.argsort(torch.argsort(counts, stable=True), stable=True)
    tiles_per_obj = torch.clamp(
        tiles_per_obj - (crank < overflow).to(torch.int64), min=0)

    bounds = torch.cumsum(tiles_per_obj, 0)                    # [O]
    t_idx = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    tile_obj = torch.searchsorted(bounds, t_idx, right=True)
    tile_obj = torch.clamp(tile_obj, max=o - 1)
    starts = bounds - tiles_per_obj
    tile_rank = t_idx - starts[tile_obj]
    tile_rank = torch.where(t_idx < bounds[-1], tile_rank,
                            torch.full_like(tile_rank, n_tiles - 1))

    # per-object full ranking of its pixels, hash-tied
    score = r_lab.float().T * 2.0 + _hash_tie(r, dev)[None]    # [O, R]
    ranks = _top_idx(score, min(q_max, r))                     # [O, q_max]
    start = torch.clamp(tile_rank * tile, max=ranks.shape[1] - tile)
    cols = start[:, None] + torch.arange(tile, device=dev)[None]
    gidx = ranks[tile_obj[:, None], cols].reshape(-1)          # [q_max]
    row_obj = tile_obj.repeat_interleave(tile)
    sel = r_lab[gidx, row_obj]
    emb = r_emb[gidx]
    lab = (torch.nn.functional.one_hot(row_obj, o).to(r_lab.dtype)
           * sel[:, None].to(r_lab.dtype))
    return emb, lab, tile_obj.to(torch.int32)


def shard_rows(fn: Callable, q: torch.Tensor, devices: Sequence,
               *shared: torch.Tensor) -> torch.Tensor:
    """Context parallelism over query rows (the JAX package's
    ``_cp_rows``/``_cp_release`` around a matching op): ``fn(q_shard,
    *shared)`` on contiguous row shards of ``q`` [M, ...], shard ``i`` on
    ``devices[i]`` with ``shared`` copied there once per device, the
    result rows gathered on ``devices[0]`` in order.  ``M`` is padded
    with zero rows to a multiple of the device count, so that no shard
    is empty, and the padding is dropped.  A shard is a slice of the
    contiguous ``q``, itself contiguous: a copy only when its device
    differs.  Differentiable (the copies and the concatenation are)."""
    devices = [torch.device(d) for d in devices]
    n, m = len(devices), q.shape[0]
    pad = (-m) % n
    if pad:
        q = torch.cat([q, q.new_zeros((pad,) + q.shape[1:])])
    size = q.shape[0] // n
    copies = {}
    outs = []
    for i, dev in enumerate(devices):
        if dev not in copies:
            copies[dev] = [t.to(dev) for t in shared]
        out = fn(q[i * size:(i + 1) * size].to(dev), *copies[dev])
        outs.append(out.to(devices[0]))
    return torch.cat(outs)[:m]


def global_matching_flat_segmented(
    query_emb: torch.Tensor,     # [H, W, C]
    r_emb: torch.Tensor,         # [P, C] label-segmented bank
    r_lab: torch.Tensor,         # [P, O]
    dis_bias: torch.Tensor,      # [O]
    tile_obj: Optional[torch.Tensor] = None,   # [n_tiles]
    *,
    dtype=torch.float32,
    mixed: bool = False,
) -> torch.Tensor:
    """Global matching over a label-segmented bank through kernel 1 →
    [H, W, O, 1]: ``tile_obj`` (from ``compact_reference_bank_occupancy``)
    selects the occupancy layout (``global_seg_map``, B.1), None the
    uniform-quota layout of ``compact_reference_bank_segmented``
    (``global_seg``, B.2).  The per-row bias folds the filler-row penalty
    and obj_valid masking (callers zero invalid objects' label columns)."""
    h, w, c = query_emb.shape
    o = r_lab.shape[-1]
    p = r_emb.shape[0]
    q = query_emb.reshape(h * w, c).to(dtype)
    r = r_emb.to(dtype)
    uniform = tile_obj is None
    if uniform:
        tile_obj = uniform_tile_obj(p, o, r_lab.device)
    row_obj = tile_obj.to(torch.int64).repeat_interleave(p // tile_obj.shape[0])
    own = r_lab.float().gather(1, row_obj[:, None])[:, 0]
    bias = (1.0 - own) * WRONG_LABEL_PADDING_DISTANCE
    d_min = (global_seg(q, r, bias, n_obj=o, mixed=mixed) if uniform else
             global_seg_map(q, r, bias, tile_obj, n_obj=o, mixed=mixed))
    return squash_distance(d_min.reshape(h, w, o)[..., None], dis_bias)


def global_matching_flat(
    query_emb: torch.Tensor,     # [H, W, C]
    r_emb: torch.Tensor,         # [R, C] flat reference bank
    r_lab: torch.Tensor,         # [R, O] (padding rows all-zero)
    dis_bias: torch.Tensor,      # [O]
    *,
    tile_r: int = 4096,
    dtype=torch.float32,
    mixed: bool = False,
    devices: Optional[Sequence] = None,
) -> torch.Tensor:
    """Per-object NN distance maps over any flat bank → [H, W, O, 1].

    On CUDA tensors this launches kernel 3 (``global_flat_min``, B.3); on
    CPU tensors it runs that kernel's plain version, ``tile_r`` bank rows
    at a time.  ``mixed`` rounds the cross term's operands to bf16, as
    the TPU kernel does (the JAX package's CPU path ignores it).
    ``devices``: context parallelism, one launch per query-row shard
    (``shard_rows``), the bank copied to each device."""
    h, w, c = query_emb.shape
    o = r_lab.shape[-1]
    q = query_emb.reshape(h * w, c).to(dtype)

    def run(q, r, lab):
        return global_flat_min(q, r, lab, mixed, tile_r=tile_r)

    args = (r_emb.to(dtype), r_lab.to(dtype))
    d_min = run(q, *args) if devices is None else shard_rows(run, q, devices,
                                                             *args)
    return squash_distance(d_min.reshape(h, w, o)[..., None], dis_bias)


def proxy_matching(query_emb: torch.Tensor, proxies: torch.Tensor,
                   dis_bias: torch.Tensor, *, dtype=torch.float32,
                   devices: Optional[Sequence] = None) -> torch.Tensor:
    """Distance of every query pixel to each object's proxy → [H, W, O, 1];
    ``devices``: the query rows split over them (``shard_rows``)."""
    h, w, c = query_emb.shape
    q = query_emb.reshape(h * w, c).to(dtype).float()
    p = proxies.to(dtype).float()

    def run(q, p):
        return (q.square().sum(-1)[:, None] + p.square().sum(-1)[None]
                - 2.0 * (q @ p.T))

    d = run(q, p) if devices is None else shard_rows(run, q, devices, p)
    return squash_distance(d.reshape(h, w, -1)[..., None], dis_bias)


def foreground2background(dis: torch.Tensor, obj_valid: torch.Tensor
                          ) -> torch.Tensor:
    """Per object, the min over the OTHER valid objects' maps; a single
    valid object passes through.  ``dis``: [H, W, O, k]; ``obj_valid``: [O]."""
    o = dis.shape[-2]
    eye = torch.eye(o, dtype=torch.bool, device=dis.device)
    valid = obj_valid.bool()[None, :] & ~eye                    # [i, j]
    d = torch.where(valid[:, :, None], dis[:, :, None, :, :],
                    torch.ones((), dtype=dis.dtype, device=dis.device))
    out = d.min(dim=3).values
    return torch.where(obj_valid.bool().sum() <= 1, dis, out)


def local_matching_bank_stacked(
    query_emb: torch.Tensor,     # [H, W, C]
    prev_embs: torch.Tensor,     # [S, H, W, C]
    prev_onehot: torch.Tensor,   # [H, W, O]
    dis_bias: torch.Tensor,      # [O]
    multi_local_distance: Sequence[int] = (2, 4, 6, 8, 10, 12),
    *,
    atrous_rate: int = 1,
    allow_downsample: bool = True,
    dtype=torch.float32,
    match=None,
) -> torch.Tensor:
    """Local matching of one query against S previous-frame embeddings
    sharing one label map → [S, H, W, O, n] squashed, channel order
    [full radius, radii[:-1]].  2× bilinear downsample to
    ``(H//2+1, W//2+1)`` with nearest-resized labels, kernel 2 on the
    small grid (or ``match``, a function of ``local_match``'s signature:
    the training route's ``train_matching.local_matching_min``), squash,
    then bilinear upsample back."""
    ori_h, ori_w, _ = query_emb.shape
    x = query_emb.to(dtype)
    ys = prev_embs.to(dtype)
    if allow_downsample:
        down = (ori_h // 2 + 1, ori_w // 2 + 1)
        x = resize_nchw(x.permute(2, 0, 1), down).permute(1, 2, 0)
        ys = resize_nchw(ys.permute(0, 3, 1, 2), down).permute(0, 2, 3, 1)
    h, w = x.shape[:2]
    labels = prev_onehot
    if (h, w) != (ori_h, ori_w):
        labels = resize_nchw(prev_onehot.permute(2, 0, 1), (h, w),
                             "nearest").permute(1, 2, 0)
    multi = (match or local_match)(x, ys, labels, tuple(multi_local_distance),
                                   atrous_rate)              # [S,h,w,O,n]
    multi = squash_distance(multi.float(), dis_bias)
    if (h, w) != (ori_h, ori_w):
        multi = resize_nchw(multi.permute(0, 3, 4, 1, 2),
                            (ori_h, ori_w)).permute(0, 3, 4, 1, 2)
    return multi


def flat_bank(ref_emb: torch.Tensor, ref_onehot: torch.Tensor,
              slot_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S,H,W,C]/[S,H,W,O]/[S] → flat [R,C], [R,O] with invalid slots'
    labels zeroed."""
    c, o = ref_emb.shape[-1], ref_onehot.shape[-1]
    lab = ref_onehot * slot_valid[:, None, None, None].to(ref_onehot.dtype)
    return ref_emb.reshape(-1, c), lab.reshape(-1, o)
