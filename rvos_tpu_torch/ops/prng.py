"""The JAX package's random draws, reproduced bit for bit in torch.

The evaluator seeds k-means with ``jax.random``: frame ``f`` draws
``uniform(split(fold_in(PRNGKey(42), f), O)[o], (R,), 0.5, 1.0)`` for
object ``o`` (``rvos_tpu/engine/eval.py`` and ``rvos_tpu/ops/kmeans.py``).
JAX's default generator is threefry-2x32, a fixed integer hash, run
with ``jax_threefry_partitionable=True`` (the default of the JAX the
package is held to): a key is two uint32 words; ``fold_in(key, d)``
hashes the counter pair (0, d) into a new key; ``split(key, n)`` hashes
(0, i) for i < n into n keys; ``uniform(key, (R,))`` hashes (0, i) for
i < R, takes the xor of the two output words, keeps its top 23 bits as
a float32 mantissa in [1, 2), subtracts 1, scales and shifts.  So the
draw of row i does not depend on R: a smaller bank's draws are a prefix
of a larger one's.

Here the words are ``int64`` tensors holding uint32 values, so the hash
runs on any device with exact integer arithmetic and the float steps
are exact too: the CPU and the card draw the same bits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
KMEANS_SEED = 42


def threefry2x32(k0, k1, x0: int, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``: int64 tensors of uint32 values that broadcast
    against the counters ``x1`` (``x0`` is a constant word).  The state
    is updated in place, and sums are masked lazily: ``x0`` may carry
    bits above 32 between rounds (at most 38 of them); each mix masks
    ``x1``."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x1 = (x1 + k1).bitwise_and_(_MASK)
    x0 = (torch.zeros_like(x1) + k0).add_(x0)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
            x1.bitwise_and_(_MASK)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0.bitwise_and_(_MASK), x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32: [0, seed]."""
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2], data (int or int64 tensor of
    values below 2**32, broadcasting against ``keys[..., 0]``) → [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack((y0, y1), dim=-1)


def split(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)`` for each key of [..., 2] → [..., n, 2]."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., None, 0], keys[..., None, 1], 0, i)
    return torch.stack((y0, y1), dim=-1)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=minval, maxval=maxval)`` in
    float32 for each key of [..., 2] → [..., n].  The scale and shift
    round once, as the fused multiply-add XLA emits does (float64, then
    float32); for the k-means range [0.5, 1.0) every step is exact."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., None, 0], keys[..., None, 1], 0, i)
    bits = y0.bitwise_xor_(y1).bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = (torch.tensor(v, dtype=torch.float32) for v in (minval, maxval))
    out = floats.double() * (hi - lo).item() + lo.item()
    return torch.clamp_min(out.float(), lo.item())


def kmeans_keys(frames: Sequence[int], n_obj: int) -> torch.Tensor:
    """The k-means keys of the evaluator's frames: ``split(fold_in(
    PRNGKey(42), f), n_obj)`` for each frame → int64 [len(frames),
    n_obj, 2], on the CPU."""
    f = torch.tensor(list(frames), dtype=torch.int64) & _MASK
    return split(fold_in(prng_key(KMEANS_SEED), f), n_obj)


def kmeans_init_scores(frames: Sequence[int], n_obj: int, n_rows: int,
                       device=None) -> torch.Tensor:
    """The JAX evaluator's k-means init scores for ``frames`` →
    float32 [len(frames), n_obj, n_rows] in [0.5, 1.0), drawn on
    ``device``."""
    keys = kmeans_keys(frames, n_obj)
    if device is not None and torch.device(device).type == "cuda":
        keys = keys.pin_memory().to(device, non_blocking=True)
    return uniform(keys, n_rows, 0.5, 1.0)
