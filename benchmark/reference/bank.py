"""The evaluator's memory bank, worked out from its definition.

A video's bank holds ``TEST_BANK_CAPACITY`` slots of (embedding, label
map): slot 0 is frame 0 with its ground truth; every ``MEM_EVERY``-th
frame and every frame that brings a new object's mask joins the ring of
slots 1.., oldest first out.  Its label is the frame's mask with the
pixels whose Shannon entropy passes ``UNC_RATIO`` marked uncertain (125,
which matches no object).

The global and cluster streams read the bank compacted to
``MATCHING_MAX_REF_PIXELS`` rows in label-pure tiles of 1,024 rows
(``compact_occupancy``): every object with pixels gets one tile, the
remaining tiles go by pixel share (largest remainder), and each object's
tiles take its pixels in the order of a fixed hash of the row index.
"""

from __future__ import annotations

import torch

UNCERTAIN = 125
TILE = 1024


def hash_tie(r: int, device) -> torch.Tensor:
    """Knuth's multiplicative hash of each row index, in [0, 1)."""
    idx = torch.arange(r, dtype=torch.int64, device=device)
    h = ((idx * 2654435761) & 0xFFFFFFFF) % 0x7FFFFFFF
    return h.to(torch.float32) / float(0x7FFFFFFF)


def _rank(v: torch.Tensor) -> torch.Tensor:
    """Each entry's place in the ascending stable order."""
    return torch.argsort(torch.argsort(v, stable=True), stable=True)


def compact_occupancy(emb: torch.Tensor, lab: torch.Tensor, max_pixels: int):
    """emb [R, C], lab [R, O] (one-hot, zero rows match nothing) →
    (emb [P, C], lab [P, O]) with P = max(O, max_pixels // TILE) tiles."""
    r, o = lab.shape
    dev = emb.device
    n_tiles = max(o, max_pixels // TILE)
    q_max = n_tiles * TILE
    if r < q_max:
        emb = torch.cat([emb, emb.new_zeros((q_max - r, emb.shape[1]))])
        lab = torch.cat([lab, lab.new_zeros((q_max - r, o))])
        r = q_max
    counts = lab.sum(0)
    live = (counts > 0.5).long()
    rem = max(n_tiles - int(live.sum()), 0)
    frac = counts / torch.clamp(counts.sum(), min=1.0) * float(rem)
    extra = torch.floor(frac).long() * live
    leftover = rem - int(extra.sum())
    remainder = torch.where(live > 0, frac - torch.floor(frac),
                            torch.full_like(frac, -1.0))
    extra = extra + ((_rank(-remainder) < leftover) & (live > 0)).long()
    tiles = live + extra
    overflow = max(int(tiles.sum()) - n_tiles, 0)
    tiles = torch.clamp(tiles - (_rank(counts) < overflow).long(), min=0)

    score = lab.t() * 2.0 + hash_tie(r, dev)[None]              # [O, R]
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    order = order[:, :min(q_max, r)]
    rows, row_obj = [], []
    t = 0
    for obj in range(o):
        for j in range(int(tiles[obj])):
            start = min(j * TILE, order.shape[1] - TILE)
            rows.append(order[obj, start:start + TILE])
            row_obj.append(obj)
            t += 1
    while t < n_tiles:                 # tiles past every object's share
        start = min((n_tiles - 1) * TILE, order.shape[1] - TILE)
        rows.append(order[o - 1, start:start + TILE])
        row_obj.append(o - 1)
        t += 1
    gidx = torch.cat(rows)
    robj = torch.tensor(row_obj, device=dev).repeat_interleave(TILE)
    sel = lab[gidx, robj]
    out_lab = torch.nn.functional.one_hot(robj, o).float() * sel[:, None]
    return emb[gidx], out_lab


def entropy(probs: torch.Tensor, em: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of [O, H, W] probabilities over the existing
    objects (``em`` [O]); a zero probability adds nothing."""
    p = probs * em[:, None, None]
    return -(p * torch.log(p + 1e-6)).sum(dim=0)
