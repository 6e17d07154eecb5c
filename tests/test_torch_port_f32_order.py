"""The float32 (parity) route of the global kernels, its arithmetic order
emulated in plain PyTorch on the CPU.

The CUDA kernels (``csrc/dist_tile.cuh``'s ``ffma::``) do not compute the
plain versions' ``q2 + r2 - 2 q·r``.  Each pair's accumulator starts at
``‖r‖²`` (+ bias for kernel 1), takes one FMA per channel in order with
the bank passed as ``-2 r`` (exact), and ends as ``d' = ‖r‖² − 2 q·r``.
``‖q‖²`` is added once per row, when a run of steps is folded.  Kernel 3
walks the bank in ``flat_route``'s order: a pure step folds a running
min, a mixed step takes the general penalised min.  The norms are the
preparation kernel's: lane-strided FMA sums, then a 32-lane butterfly.

These tests replay that order here and hold it within 1e-4 of
max(|d|, 1), the kernels' own tolerance on the card, to the function
taken in float64, and to the plain versions where those are themselves
within 1e-4 of it.  Inputs include query rows equal to bank rows (d ≈ 0
under ‖q‖² + ‖r‖² ≫ d, where the cancellation is largest).  With
mixed-sign rows of unit variance at C = 100 the plain version is 1.1e-4
from the float64 distances there and the emulated order 4.6e-5, so the
order is held to float64 alone; with non-negative rows (the embeddings
of ``chip_smoke.py``'s banks) to both.  Each FMA is
emulated as a float64 product and sum rounded once to float32, which may
differ from the card's fused operation by an ulp in rare cases.  The
kernels themselves run only on the card (``test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

from rvos_tpu_torch import ops as tops
from rvos_tpu_torch.ops.cuda_flat import MIXED, flat_route
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

_PEN = 5e4
_BN = 64


def _rel_err(got, want):
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


def _norms(x):
    """‖x‖² per row in the preparation kernel's order: lane l of a warp
    sums channels l, l + 32, ... with FMAs, then a butterfly over the
    32 lanes (xor 16, 8, 4, 2, 1)."""
    n, c = x.shape
    xp = torch.zeros((n, -(-c // 32) * 32), dtype=torch.float64)
    xp[:, :c] = x.double()
    lanes = torch.zeros((n, 32), dtype=torch.float32)
    for k in range(xp.shape[1] // 32):
        v = xp[:, 32 * k:32 * (k + 1)]
        lanes = (lanes.double() + v * v).float()
    for k in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ k]
    return lanes[:, 0]


def _fma_chain(q, r, seed):
    """d'[m, n] = seed[n], then + q[m, c] · (−2 r[n, c]) for c in order,
    one rounding per channel."""
    b = -2.0 * r.double()
    qd = q.double()
    acc = seed.float()[None, :].expand(q.shape[0], -1).contiguous()
    for c in range(q.shape[1]):
        acc = (acc.double() + qd[:, c, None] * b[None, :, c]).float()
    return acc


def _exact(q, r, seed):
    """‖q − r‖² + seed[r] in float64, as q2 + r2 + seed − 2 q·r."""
    qd, rd = q.double(), r.double()
    return ((qd * qd).sum(1)[:, None] + (rd * rd).sum(1)[None, :]
            + seed.double()[None, :] - 2.0 * qd @ rd.T)


def _check(got, want, exact, signed):
    """Within 1e-4 of max(|d|, 1) of the float64 function and, for
    non-negative rows, of the plain version (itself within 1e-4 of the
    float64 function there)."""
    assert _rel_err(got.double(), exact) <= 1e-4
    if not signed:
        assert _rel_err(want.double(), exact) <= 1e-4
        assert _rel_err(got, want) <= 1e-4


def _splits(n_steps, per):
    return [range(s, min(n_steps, s + per)) for s in range(0, n_steps, per)]


def _seg_map_emulated(q, r, bias, tile_obj, n_obj, per):
    """Kernel 1's float32 route: per CTA of the bank split (``per`` steps)
    a running min of d' while the steps' object stays the same, folded
    into B at a change; min(1e5, ‖q‖² + B) per CTA, the CTAs combined by
    a min."""
    q2 = _norms(q)
    d = _fma_chain(q, r, _norms(r) + bias.float())
    n_steps = r.shape[0] // _BN
    spt = n_steps // tile_obj.shape[0]
    out = torch.full((q.shape[0], n_obj), float("inf"))
    for steps in _splits(n_steps, per):
        b = torch.full((q.shape[0], n_obj), float("inf"))
        run, cur = torch.full((q.shape[0],), float("inf")), -1
        for s in list(steps) + [None]:
            k = None if s is None else int(tile_obj[s // spt])
            if k != cur:
                if 0 <= cur < n_obj:
                    b[:, cur] = torch.minimum(b[:, cur], run)
                run, cur = torch.full_like(run, float("inf")), k
            if s is not None:
                run = torch.minimum(run, d[:, s * _BN:(s + 1) * _BN].amin(1))
        out = torch.minimum(out, torch.clamp(q2[:, None] + b, max=1e5))
    return out


def _flat_emulated(q, r, lab, per):
    """Kernel 3's float32 route: the bank in ``flat_route``'s order; per
    CTA of the bank split a pure run of steps folds ‖q‖² + its running min
    of d' into A and B_o, a mixed step takes (‖q‖² + d') + (1 − lab)·5e4
    into B; min(B_o, A + 5e4) per CTA, combined by a min."""
    perm, tags = flat_route(lab)
    q2 = _norms(q)
    rs = r[perm]
    d = _fma_chain(q, rs, _norms(rs))
    ls = lab[perm].float()
    m, o = q.shape[0], lab.shape[1]
    out = torch.full((m, o), float("inf"))
    for steps in _splits(tags.shape[0], per):
        a = torch.full((m,), float("inf"))
        b = torch.full((m, o), float("inf"))
        run, cur = torch.full((m,), float("inf")), None
        for s in list(steps) + [None]:
            tag = None if s is None else int(tags[s])
            pure = tag is not None and tag != MIXED
            if tag != cur:
                if cur is not None and cur != MIXED:
                    v = q2 + run
                    a = torch.minimum(a, v)
                    if cur >= 0:
                        b[:, cur] = torch.minimum(b[:, cur], v)
                run, cur = torch.full_like(run, float("inf")), tag
            if s is None:
                continue
            cols = slice(s * _BN, (s + 1) * _BN)
            if pure:
                run = torch.minimum(run, d[:, cols].amin(1))
            else:
                pen = (1.0 - ls[cols]) * _PEN
                v = (q2[:, None] + d[:, cols])[:, :, None] + pen[None]
                b = torch.minimum(b, v.amin(1))
        out = torch.minimum(out, torch.minimum(b, a[:, None] + _PEN))
    return out


def _rows(rng, shape, signed):
    x = rng.standard_normal(shape).astype(np.float32)
    return x if signed else np.maximum(x, 0.0)


def _queries(rng, bank, m, c, signed):
    """``m`` query rows: random ones and, every third, a bank row."""
    q = _rows(rng, (m, c), signed)
    q[::3] = bank[rng.integers(0, bank.shape[0], len(q[::3]))]
    return torch.from_numpy(q)


def _seg_map_exact(q, r, bias, tile_obj, n_obj):
    d = _exact(q, r, bias)
    spt = r.shape[0] // tile_obj.shape[0]
    out = torch.full((q.shape[0], n_obj), 1e5, dtype=torch.float64)
    for t, o in enumerate(tile_obj.tolist()):
        if 0 <= o < n_obj:
            v = d[:, t * spt:(t + 1) * spt].amin(1)
            out[:, o] = torch.minimum(out[:, o], v)
    return out


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("per", [10**6, 3])
@pytest.mark.parametrize("c", [12, 100])
def test_seg_map_f32_order_matches_plain(c, per, signed, rng):
    """Kernel 1 (occupancy tiles of 128 rows, a tile of no object, an
    object with no tile, filler rows biased by 5e4), one CTA or a bank
    split in runs of 3 steps."""
    tile_obj = torch.tensor([0, 2, 2, -1, 1, 2, 0, 1], dtype=torch.int32)
    o, p = 4, 8 * 2 * _BN
    r = _rows(rng, (p, c), signed)
    r[5] = 0.0
    bias = torch.from_numpy((rng.random(p) < 0.1).astype(np.float32) * 5e4)
    q = _queries(rng, r, 300, c, signed)
    r = torch.from_numpy(r)
    got = _seg_map_emulated(q, r, bias, tile_obj, o, per)
    want = tops.global_seg_map_plain(q, r, bias, tile_obj, o, mixed=False)
    _check(got, want, _seg_map_exact(q, r, bias, tile_obj, o), signed)
    assert (got[:, 3] == 1e5).all()
    near = (want[::3] < 1e-2).any(1)
    assert near.float().mean() > 0.5      # the d ≈ 0 rows are in play


@pytest.mark.parametrize("signed", [True, False])
def test_seg_map_f32_order_uniform_matches_plain(signed, rng):
    """B.2 (kernel 1 routed by uniform quotas of 1024 rows) in the same
    order, against ``global_seg_plain``."""
    o, c = 2, 100
    r = _rows(rng, (2048, c), signed)
    bias = torch.zeros(2048)
    bias[1000:1024] = 5e4
    q = _queries(rng, r, 200, c, signed)
    r = torch.from_numpy(r)
    tile_obj = tops.cuda_matching.uniform_tile_obj(2048, o)
    got = _seg_map_emulated(q, r, bias, tile_obj, o, 5)
    want = tops.global_seg_plain(q, r, bias, o, mixed=False)
    _check(got, want, _seg_map_exact(q, r, bias, tile_obj, o), signed)


def _flat_bank(rng, kind, r, c, o, signed=True):
    """A flat bank for B.3's route: one-hot rows (object o-1 has none)
    and all-zero rows; ``general`` adds fractional, two-hot and
    out-of-range label rows."""
    emb = _rows(rng, (r, c), signed)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, o - 1, r)]
    lab[rng.random(r) < 0.2] = 0.0
    if kind == "general":
        lab[3] = 0.5
        lab[10, :2] = 1.0
        lab[rng.random(r) < 0.03, :2] = 1.0
        lab[20, 1] = 2.0
    return emb, lab


def _flat_exact(q, r, lab):
    d = _exact(q, r, torch.zeros(r.shape[0]))
    pen = (1.0 - lab.double()) * _PEN
    return (d[:, :, None] + pen[None]).amin(1)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("per", [10**6, 2])
@pytest.mark.parametrize("kind", ["onehot", "general"])
def test_flat_f32_order_matches_plain(kind, per, signed, rng):
    """Kernel 3's float32 route over a 700-row bank (not a multiple of
    64), one CTA or a bank split in runs of 2 steps, against
    ``global_flat_min_plain``."""
    emb, lab = _flat_bank(rng, kind, 700, 100, 5, signed)
    q = _queries(rng, emb, 300, 100, signed)
    emb, lab = torch.from_numpy(emb), torch.from_numpy(lab)
    got = _flat_emulated(q, emb, lab, per)
    want = tops.global_flat_min_plain(q, emb, lab, mixed=False)
    assert got.shape == want.shape == (300, 5)
    _check(got, want, _flat_exact(q, emb, lab), signed)
    assert (want[::3].amin(1) < 1e-2).float().mean() > 0.5  # d ≈ 0 in play


@pytest.mark.parametrize("kind", ["onehot", "general"])
def test_flat_f32_order_ignores_row_order_and_split(kind, rng):
    """In that order each pair's value does not depend on where its row
    lands: a row-permuted bank, and a bank split in runs of 1 or 3
    steps, give the one-CTA result bit for bit (the card's row shards,
    bank shards and splits rely on it)."""
    emb, lab = _flat_bank(rng, kind, 500, 12, 4)
    q = _queries(rng, emb, 200, 12, True)
    emb, lab = torch.from_numpy(emb), torch.from_numpy(lab)
    want = _flat_emulated(q, emb, lab, 10**6)
    perm = torch.from_numpy(rng.permutation(500))
    assert torch.equal(_flat_emulated(q, emb[perm], lab[perm], 10**6), want)
    for per in (1, 3):
        assert torch.equal(_flat_emulated(q, emb, lab, per), want)


@pytest.mark.parametrize("m,n_steps,slots", [
    (25773, 256, 264), (25773, 3222, 264), (25773, 176, 264),
    (38889, 256, 264), (12887, 3222, 264), (64, 5, 264), (3001, 40, 132)])
def test_f32_steps_per_split(m, n_steps, slots):
    """The float32 kernels' bank split (``slots`` resident CTAs): the
    runs cover every step, none is empty, each holds at least 8 steps
    unless the bank is shorter, and the waves of CTAs take, in steps,
    within 10 % and one run of an even share of the work over the slots
    (or one CTA's walk of the whole bank, when there is less work than
    slots)."""
    from rvos_tpu_torch.ops.cuda_matching import f32_steps_per_split
    per = f32_steps_per_split(m, n_steps, slots)
    runs = -(-n_steps // per)
    assert (runs - 1) * per < n_steps <= runs * per
    assert per >= min(8, n_steps)
    tiles = -(-m // 128)
    waves = -(-tiles * runs // slots)
    assert waves * per <= max(1.1 * tiles * n_steps / slots + per, n_steps)
