"""The k-means init draws of the evaluator, worked out from their
definition: JAX's threefry-2x32 generator.

Frame ``f`` of a video seeds object ``o``'s k-means with
``uniform(split(fold_in(PRNGKey(42), f), O)[o], (R,), 0.5, 1.0)``.  A key
is two uint32 words; ``fold_in(key, d)`` hashes the counter (0, d),
``split(key, n)`` hashes (0, i) for i < n, and ``uniform`` hashes
(0, i) for row i, keeps the top 23 bits of the xor of the two words as
a float32 mantissa in [1, 2), subtracts 1, scales and shifts.  The words
are int64 tensors here, so the hash is exact on any device.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
KMEANS_SEED = 42


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of threefry-2x32 on uint32 words held in int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def kmeans_scores(frame: int, n_obj: int, n_rows: int, device) -> torch.Tensor:
    """Frame ``frame``'s draws → float32 [n_obj, n_rows] in [0.5, 1)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    k0, k1 = threefry2x32(zero, zero + KMEANS_SEED, zero,
                          zero + (frame & _MASK))               # fold_in
    i = torch.arange(n_obj, dtype=torch.int64, device=device)
    s0, s1 = threefry2x32(k0, k1, torch.zeros_like(i), i)       # split
    r = torch.arange(n_rows, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(s0[:, None], s1[:, None],
                          torch.zeros_like(r)[None], r[None])   # uniform
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min((floats.double() * 0.5 + 0.5).float(), 0.5)

