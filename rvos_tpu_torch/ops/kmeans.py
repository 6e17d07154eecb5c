"""Masked k-means for the adaptive-object-proxy (AOP) stream (PyTorch
port of ``rvos_tpu/ops/kmeans.py``).

Fixed k and iteration count, batched over objects: per object, the k
pixels with the highest init scores among its foreground seed the
centroids (objects with fewer than k pixels get invalid trailing
centroids), then Lloyd iterations as matmuls.  Two result banks: the
final centroids and the final-assignment cluster means.

The init scores are an argument, ``[O, R]`` uniform draws in
[0.5, 1.0) before the foreground mask; the evaluator draws the JAX
package's own (``ops.prng``).  Assignment and update products are plain
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .matching import (WRONG_LABEL_PADDING_DISTANCE, shard_rows,
                       squash_distance)


class ClusterBanks(NamedTuple):
    centroids: torch.Tensor    # [O, K, C]
    cent_valid: torch.Tensor   # [O, K] bool
    means: torch.Tensor        # [O, K, C]
    mean_valid: torch.Tensor   # [O, K] bool


def _masked_kmeans(points: torch.Tensor, weights: torch.Tensor,
                   scores: torch.Tensor, k: int, iters: int,
                   mixed: bool = False):
    """points [R, C]; weights, scores [O, R] → per-object banks."""
    pts32 = points.float()
    pts_d = pts32.bfloat16().float() if mixed else pts32
    p2 = pts32.square().sum(-1)                                # [R]
    w = weights.float()                                        # [O, R]
    s = scores.float() * w
    top = torch.sort(s, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :k], top.indices[:, :k]
    init_valid = top_scores > 0.0                              # [O, K]
    cent = pts32[top_idx]                                      # [O, K, C]

    def assign(c):
        c_d = c.bfloat16().float() if mixed else c
        d = (p2[None, :, None] + c.square().sum(-1)[:, None, :]
             - 2.0 * torch.matmul(pts_d[None], c_d.transpose(1, 2)))
        d = torch.where(init_valid[:, None, :], d,
                        torch.full_like(d, float("inf")))      # [O, R, K]
        lab = d.argmin(dim=-1)                                 # [O, R]
        return torch.nn.functional.one_hot(lab, k).float() * w[..., None]

    def update(c):
        onehot = assign(c)
        counts = onehot.sum(1)                                 # [O, K]
        sums = torch.matmul(onehot.transpose(1, 2), pts32)     # [O, K, C]
        new = torch.where(counts[..., None] > 0,
                          sums / counts.clamp(min=1.0)[..., None], c)
        return new, counts

    for _ in range(iters):
        cent, _ = update(cent)
    means, counts = update(cent)
    mean_valid = (counts > 0) & init_valid
    return cent, init_valid, means, mean_valid


def cluster_objects(ref_emb_flat: torch.Tensor, ref_onehot_flat: torch.Tensor,
                    init_scores: torch.Tensor, k: int = 16, iters: int = 20,
                    mixed: bool = False) -> ClusterBanks:
    """Per-object k-means over foreground reference pixels.
    ``ref_emb_flat`` [R, C]; ``ref_onehot_flat`` [R, O]; ``init_scores``
    [O, R]."""
    cent, cv, means, mv = _masked_kmeans(ref_emb_flat, ref_onehot_flat.T,
                                         init_scores, k, iters, mixed)
    return ClusterBanks(cent, cv, means, mv)


def cluster_matching(query_emb: torch.Tensor, banks: ClusterBanks,
                     dis_bias: torch.Tensor, *, dtype=torch.float32,
                     devices: Optional[Sequence] = None) -> torch.Tensor:
    """Query ↔ proxy-bank min distances → [H, W, O, 2] (centroid bank,
    cluster-mean bank); ``devices``: the query rows split over them, the
    banks copied to each (``ops.matching.shard_rows``)."""
    h, w, c = query_emb.shape
    q = query_emb.reshape(h * w, c).to(dtype).float()

    def run(q, *banks):
        q2 = q.square().sum(-1)

        def bank_min(bank, valid):
            o, k, _ = bank.shape
            b = bank.reshape(o * k, c).to(dtype).float()
            d = q2[:, None] + b.square().sum(-1)[None] - 2.0 * (q @ b.T)
            pen = (1.0 - valid.float()) * WRONG_LABEL_PADDING_DISTANCE
            return (d.reshape(-1, o, k) + pen[None]).min(dim=-1).values

        cent, cv, means, mv = banks
        return torch.stack([bank_min(cent, cv), bank_min(means, mv)], dim=-1)

    d = run(q, *banks) if devices is None else shard_rows(run, q, devices,
                                                          *banks)
    return squash_distance(d.reshape(h, w, -1, 2), dis_bias)
