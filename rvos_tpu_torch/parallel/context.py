"""Context-parallel global matching (PyTorch port of
``rvos_tpu/parallel/context.py``).

Global matching is embarrassingly parallel over query pixels: each
device takes a contiguous tile of query rows against the whole bank,
copied to it, and the rows come back to the first device in order
(``global_matching_context_parallel``).  When a bank outgrows one
device, it is split instead: each device holds a tile of bank rows
against every query, and an elementwise min on the first device stands
in for the JAX package's ``pmin`` (``global_matching_bank_sharded``;
the min is associative and exact, so the result is the unsharded one).

On CUDA tensors every shard launches kernel 3 (``global_flat_min``,
B.3); on CPU tensors its plain version runs.  No shard is ever empty:
the rows split are padded to a multiple of the device count, with zero
query rows (dropped from the result) or zero bank rows with all-zero
labels, as in the JAX package — penalised for every object, such a row
can only win an object's min above 5e4, where both squash to 1.0.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.cuda_flat import global_flat_min
from ..ops.matching import global_matching_flat, shard_rows, squash_distance

__all__ = ["global_matching_bank_sharded", "global_matching_context_parallel",
           "shard_rows"]


def global_matching_context_parallel(
    query_emb: torch.Tensor,    # [H, W, C]
    r_emb: torch.Tensor,        # [R, C] flat reference bank
    r_lab: torch.Tensor,        # [R, O]
    dis_bias: torch.Tensor,     # [O]
    devices: Sequence,
    *,
    mixed: bool = False,
    tile_r: int = 4096,
) -> torch.Tensor:
    """[H, W, O, 1] squashed NN distance maps, the query rows split over
    ``devices`` (``M`` padded to a multiple of their number)."""
    return global_matching_flat(query_emb, r_emb, r_lab, dis_bias,
                                tile_r=tile_r, dtype=query_emb.dtype,
                                mixed=mixed, devices=devices)


def global_matching_bank_sharded(
    query_emb: torch.Tensor,    # [H, W, C]
    r_emb: torch.Tensor,        # [R, C] flat reference bank
    r_lab: torch.Tensor,        # [R, O]
    dis_bias: torch.Tensor,     # [O]
    devices: Sequence,
    *,
    mixed: bool = False,
    tile_r: int = 4096,
) -> torch.Tensor:
    """[H, W, O, 1]: the bank rows split over ``devices`` (``R`` padded
    with zero-label rows to a multiple of their number), the queries
    copied to each, each shard's per-object min brought to the first
    device and reduced there by an elementwise min."""
    h, w, c = query_emb.shape
    o = r_lab.shape[-1]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    pad = (-r_emb.shape[0]) % n
    if pad:
        r_emb = torch.cat([r_emb, r_emb.new_zeros((pad, c))])
        r_lab = torch.cat([r_lab, r_lab.new_zeros((pad, o))])
    size = r_emb.shape[0] // n
    q = query_emb.reshape(h * w, c)
    queries = {}
    best = None
    for i, dev in enumerate(devices):
        if dev not in queries:
            queries[dev] = q.to(dev)
        rows = slice(i * size, (i + 1) * size)
        local = global_flat_min(queries[dev], r_emb[rows].to(dev),
                                r_lab[rows].to(dev), mixed,
                                tile_r=min(tile_r, size)).to(devices[0])
        best = local if best is None else torch.minimum(best, local)
    return squash_distance(best.reshape(h, w, o)[..., None], dis_bias)
