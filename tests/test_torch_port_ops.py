"""The port's ops (``rvos_tpu_torch.ops``) against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides; the port
runs on the CPU, where each kernel wrapper runs its plain PyTorch
version.  Where the JAX function reaches a Pallas kernel it runs in
interpret mode.  Parity mode (float32) unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvos_tpu.ops import kmeans as jk
from rvos_tpu.ops import matching as jm
from rvos_tpu.ops import proxies as jp
from rvos_tpu.ops.entropy import shannon_entropy as j_entropy
from rvos_tpu.ops.pallas_local import local_matching_pallas
from rvos_tpu.ops.pallas_matching import (global_matching_pallas,
                                          global_matching_pallas_segmented,
                                          global_matching_pallas_segmented_mapped)
from rvos_tpu.ops.resize import resize_hw as j_resize_hw

from rvos_tpu_torch import ops as tops
from rvos_tpu_torch.ops import matching as tm
from torch_port_threads import torch_threads  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("hw,out", [((9, 13), (17, 25)), ((33, 33), (9, 9)),
                                    ((61, 107), (31, 54)), ((31, 54), (61, 107))])
def test_resize_matches_resize_hw(mode, hw, out, rng):
    x = rng.standard_normal(hw + (3,)).astype(np.float32)
    if mode == "nearest":
        x = np.round(x * 3)
    want = np.asarray(j_resize_hw(jnp.asarray(x), out, mode))
    got = tops.resize_hw(_t(x), out, mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


# 20,000 reference rows for an 8,192-row (8-tile) occupancy bank:
# "equal" — three objects of 6,000 pixels on an empty background channel;
#   their equal counts tie the largest-remainder tile split, so the
#   allocation depends on the stable lower-index-first order of the sorts;
# "dominant" — one object of 15,000 pixels far over its 4 tiles, a
#   200-pixel object whose one tile is mostly filler rows, and a live
#   background channel.
_BANKS = {"equal": ((0, 6000, 6000, 6000), [0, 3, 3, 2]),
          "dominant": ((1800, 15000, 3000, 200), [1, 4, 2, 1])}


def _skewed_bank(rng, kind, c=12):
    counts, _ = _BANKS[kind]
    r = 20000
    emb = rng.standard_normal((r, c)).astype(np.float32)
    lab = np.zeros((r, len(counts)), np.float32)
    start = 0
    for o in (1, 2, 3, 0):
        lab[start:start + counts[o], o] = 1.0
        start += counts[o]
    return emb, lab


@pytest.mark.parametrize("kind", sorted(_BANKS))
def test_occupancy_compaction_selects_identical_rows(kind, rng):
    emb, lab = _skewed_bank(rng, kind)
    je, jl, jt = jm.compact_reference_bank_occupancy(
        jnp.asarray(emb), jnp.asarray(lab), 8192, tile=1024)
    te, tl, tt = tm.compact_reference_bank_occupancy(_t(emb), _t(lab), 8192,
                                                     tile=1024)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    counts, tiles = _BANKS[kind]
    assert np.bincount(np.asarray(jt), minlength=4).tolist() == tiles
    # every object over its quota is subsampled by the hash ranking
    kept = np.asarray(jl).sum(0)
    for o, n in enumerate(counts):
        assert kept[o] == min(n, 1024 * tiles[o])


def test_top_idx_breaks_ties_like_lax_top_k(rng):
    """Many equal scores: the port's stable sort keeps the lower index
    first among equals, as ``lax.top_k`` does."""
    score = rng.integers(0, 4, (3, 500)).astype(np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(score), 300)[1])
    np.testing.assert_array_equal(tm._top_idx(_t(score), 300).numpy(), want)


def test_compact_reference_bank_identical(rng):
    emb, lab = _skewed_bank(rng, "equal")
    je, jl = jm.compact_reference_bank(jnp.asarray(emb), jnp.asarray(lab), 8192)
    te, tl = tm.compact_reference_bank(_t(emb), _t(lab), 8192)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kind", sorted(_BANKS))
def test_global_seg_map_plain_matches_pallas(kind, mixed, rng):
    """Raw live-channel mins and squashed maps against the Pallas kernel
    in interpret mode.  Mixed mode: both sides multiply bf16-rounded
    operands exactly and accumulate in float32, but the Pallas kernel
    rounds each distance to bf16 before its min (relative error up to
    2**-8 ≈ 3.9e-3); the port keeps the float32 min.  Hence
    max |Δ|/max(|d|, 1) ≤ 4e-3 raw and, as d times the squash's slope
    is at most 0.45, atol 2e-3 squashed."""
    emb, lab = _skewed_bank(rng, kind)
    o = lab.shape[1]
    oe, ol, tobj = jm.compact_reference_bank_occupancy(
        jnp.asarray(emb), jnp.asarray(lab), 8192, tile=1024)
    p = oe.shape[0]
    row_obj = np.repeat(np.asarray(tobj), p // tobj.shape[0])
    bias = ((1.0 - np.asarray(ol)[np.arange(p), row_obj]) * 5e4
            ).astype(np.float32)
    q = rng.standard_normal((50, emb.shape[1])).astype(np.float32)
    want = np.asarray(global_matching_pallas_segmented_mapped(
        jnp.asarray(q), oe, jnp.asarray(bias), tobj, n_obj=o,
        interpret=True, mixed=mixed))
    got = tops.global_seg_map(_t(q), _t(np.asarray(oe)), _t(bias),
                              _t(np.asarray(tobj)), n_obj=o, mixed=mixed
                              ).numpy()
    live = np.asarray(ol).sum(0) > 0
    assert live.tolist() == [n > 0 for n in _BANKS[kind][0]]
    if mixed:
        rel = np.abs(got[:, live] - want[:, live]) / np.maximum(
            np.abs(want[:, live]), 1.0)
        assert rel.max() <= 4e-3, rel.max()
    else:
        np.testing.assert_allclose(got[:, live], want[:, live], atol=1e-3)
    np.testing.assert_allclose(got[:, ~live], 1e5)
    # squashed through the segmented entry point vs the JAX one
    dis_bias = rng.standard_normal(o).astype(np.float32) * 0.1
    want_sq = np.asarray(jm.global_matching_flat_segmented(
        jnp.asarray(q).reshape(5, 10, -1), oe, ol, jnp.asarray(dis_bias),
        mixed=mixed, interpret=True, tile_obj=tobj))
    got_sq = tm.global_matching_flat_segmented(
        _t(q).reshape(5, 10, -1), _t(np.asarray(oe)), _t(np.asarray(ol)),
        _t(dis_bias), _t(np.asarray(tobj)), mixed=mixed).numpy()
    np.testing.assert_allclose(got_sq, want_sq, atol=2e-3 if mixed else 5e-4)


@pytest.mark.parametrize("kind", sorted(_BANKS))
def test_segmented_compaction_selects_identical_rows(kind, rng):
    """The uniform-quota layout: the same rows land in the same segments,
    with the same filler rows, as in the JAX package."""
    emb, lab = _skewed_bank(rng, kind)
    je, jl = jm.compact_reference_bank_segmented(
        jnp.asarray(emb), jnp.asarray(lab), 8192, tile=1024)
    te, tl = tm.compact_reference_bank_segmented(_t(emb), _t(lab), 8192,
                                                 tile=1024)
    assert tm.segmented_quota(8192, 4) == jm.segmented_quota(8192, 4) == 2048
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    counts, _ = _BANKS[kind]
    assert tl.numpy().sum(0).tolist() == [min(n, 2048) for n in counts]
    # a bank smaller than one quota is padded with zero rows first
    je, jl = jm.compact_reference_bank_segmented(
        jnp.asarray(emb[:700]), jnp.asarray(lab[:700]), 8192)
    te, tl = tm.compact_reference_bank_segmented(_t(emb[:700]),
                                                 _t(lab[:700]), 8192)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _flat_bank_with_gaps(rng, r=2500, c=12, o=4):
    """A flat bank of ``r`` rows (not a multiple of the Pallas wrapper's
    1024) with padding rows (all-zero labels), object 3 with no rows, and
    object 2's column zeroed as an invalid object's is."""
    emb = rng.standard_normal((r, c)).astype(np.float32)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, 3, r)]
    lab[rng.random(r) < 0.2] = 0.0            # padding rows
    lab[:, 2] = 0.0                           # obj_valid zeroes object 2
    return emb, lab


@pytest.mark.parametrize("mixed", [False, True])
def test_global_flat_min_plain_matches_pallas(mixed, rng):
    """B.3's plain version against the Pallas ``_kernel`` in interpret
    mode.  Live entries (< 2.5e4, a channel with rows): atol 1e-3 in
    float32; in mixed mode max |Δ|/max(|d|, 1) ≤ 4e-3, since the Pallas
    kernel rounds each distance to bf16 before its bf16 min and the port
    keeps float32.  Penalised entries (objects 2 and 3): the Pallas
    kernel rounds bf16(d) + bf16(5e4) = … + 49,920 to bf16 (ulp 256) in
    mixed mode, and its zero padding rows (d = ‖q‖²) may win there in
    both modes, where the port skips them: |Δ| ≤ 300, and both squash to
    exactly 1.0.  Squashed maps: atol 2e-3 (mixed; the squash's slope is
    at most 0.5) and 5e-4 (float32)."""
    emb, lab = _flat_bank_with_gaps(rng)
    q = rng.standard_normal((50, emb.shape[1])).astype(np.float32)
    want = np.asarray(global_matching_pallas(
        jnp.asarray(q), jnp.asarray(emb), jnp.asarray(lab), interpret=True,
        mixed=mixed))
    got = tops.global_flat_min(_t(q), _t(emb), _t(lab), mixed=mixed,
                               tile_r=1000).numpy()
    assert got.shape == want.shape == (50, 4)
    live = want < 2.5e4
    assert live[:, :2].all() and not live[:, 2:].any()
    if mixed:
        rel = np.abs(got[live] - want[live]) / np.maximum(np.abs(want[live]), 1.0)
        assert rel.max() <= 4e-3, rel.max()
    else:
        np.testing.assert_allclose(got[live], want[live], atol=1e-3)
    assert np.abs(got[~live] - want[~live]).max() <= 300
    bias = rng.standard_normal(4).astype(np.float32) * 0.1
    want_sq = np.asarray(jm.squash_distance(
        jnp.asarray(want).reshape(5, 10, 4, 1), jnp.asarray(bias)))
    got_sq = tm.global_matching_flat(_t(q).reshape(5, 10, -1), _t(emb),
                                     _t(lab), _t(bias), mixed=mixed).numpy()
    np.testing.assert_allclose(got_sq, want_sq, atol=2e-3 if mixed else 5e-4)
    assert (got_sq[:, :, 2:] == 1.0).all() and (want_sq[:, :, 2:] == 1.0).all()


@pytest.mark.parametrize("mixed", [False, True])
def test_global_seg_matches_pallas(mixed, rng):
    """B.2: the uniform-quota bank through ``global_seg`` against the
    Pallas ``_kernel_seg`` in interpret mode, raw and through
    ``global_matching_flat_segmented(tile_obj=None)`` squashed.  The
    bank of ``_skewed_bank("dominant")`` holds every object, with fewer
    background pixels than a quota (filler rows in segment 0).  Same
    tolerances as kernel 1's check."""
    emb, lab = _skewed_bank(rng, "dominant")
    o = lab.shape[1]
    se, sl = jm.compact_reference_bank_segmented(jnp.asarray(emb),
                                                 jnp.asarray(lab), 8192)
    p = se.shape[0]
    bias = ((1.0 - np.asarray(sl)[np.arange(p), np.arange(p) // (p // o)])
            * 5e4).astype(np.float32)
    assert bias.max() == 5e4 and bias.min() == 0.0
    q = rng.standard_normal((50, emb.shape[1])).astype(np.float32)
    want = np.asarray(global_matching_pallas_segmented(
        jnp.asarray(q), se, jnp.asarray(bias), n_obj=o, interpret=True,
        mixed=mixed))
    got = tops.global_seg(_t(q), _t(np.asarray(se)), _t(bias), n_obj=o,
                          mixed=mixed).numpy()
    if mixed:
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert rel.max() <= 4e-3, rel.max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-3)
    dis_bias = rng.standard_normal(o).astype(np.float32) * 0.1
    want_sq = np.asarray(jm.global_matching_flat_segmented(
        jnp.asarray(q).reshape(5, 10, -1), se, sl, jnp.asarray(dis_bias),
        mixed=mixed, interpret=True))
    got_sq = tm.global_matching_flat_segmented(
        _t(q).reshape(5, 10, -1), _t(np.asarray(se)), _t(np.asarray(sl)),
        _t(dis_bias), mixed=mixed).numpy()
    np.testing.assert_allclose(got_sq, want_sq, atol=2e-3 if mixed else 5e-4)
    with pytest.raises(ValueError, match="segment-aligned"):
        tops.global_seg(_t(q), torch.zeros((4 * 1000, 12)), torch.zeros(4000),
                        n_obj=4)


def test_global_matching_flat_matches_jax(rng):
    r, c, o = 700, 10, 3
    emb = rng.standard_normal((r, c)).astype(np.float32)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, o, r)]
    lab[rng.random(r) < 0.2] = 0.0            # padding rows
    q = rng.standard_normal((6, 7, c)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32) * 0.1
    want = np.asarray(jm.global_matching_flat(
        jnp.asarray(q), jnp.asarray(emb), jnp.asarray(lab), jnp.asarray(bias)))
    got = tm.global_matching_flat(_t(q), _t(emb), _t(lab), _t(bias),
                                  tile_r=256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("atrous", [1, 2])
def test_local_match_plain_matches_pallas(atrous, rng):
    h, w, c, o = 13, 15, 20, 3
    radii = (1, 2, 3)
    x = rng.standard_normal((h, w, c)).astype(np.float32)
    ys = rng.standard_normal((2, h, w, c)).astype(np.float32)
    onehot = np.eye(o, dtype=np.float32)[rng.integers(0, o, (h, w))]
    onehot[rng.random((h, w)) < 0.1] = 0.0    # unlabelled pixels
    got = tops.local_match(_t(x), _t(ys), _t(onehot), radii, atrous).numpy()
    assert got.shape == (2, h, w, o, len(radii))
    for s in range(2):
        want = np.asarray(local_matching_pallas(
            jnp.asarray(x), jnp.asarray(ys[s]), jnp.asarray(onehot), radii,
            atrous, interpret=True))
        # live distances to 1e-3; penalised ones (≥ 5e4) also differ by
        # float32 rounding at their magnitude, hence the 1e-6 rtol
        np.testing.assert_allclose(got[s], want, atol=1e-3, rtol=1e-6)


def test_local_match_window_tables():
    """Kernel 2's window parameters: each Chebyshev distance (window
    steps) maps to the smallest radius of the ascending list that holds
    it, each output channel (full radius first) to its radius' band, and
    a window past the kernel's reach is refused."""
    from rvos_tpu_torch.ops import cuda_local
    win = list(cuda_local._window_params((2, 4, 6, 8, 10, 12), 1))
    pad, atrous, a_max, n_asc, n_r = win[:5]
    band, ch_band = win[5:21], win[21:21 + n_r]
    assert (pad, atrous, a_max, n_asc, n_r) == (12, 1, 12, 6, 6)
    assert band[:13] == [0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5]
    assert ch_band == [5, 0, 1, 2, 3, 4]
    win = list(cuda_local._window_params((1, 2, 3), 2))
    assert win[:5] == [2, 2, 1, 2, 3] and win[5:7] == [0, 1]
    assert win[21:24] == [1, 0, 1]
    with pytest.raises(ValueError, match="window reach"):
        cuda_local._window_params((2, 16), 1)


def _window_max(v, a_max):
    """max over the (2 a_max + 1)² in-frame window offsets of v(offset):
    ``v`` maps (dy, dx) to an [S, h, w] array (-inf where out of frame)."""
    return np.max([v(dy, dx) for dy in range(-a_max, a_max + 1)
                   for dx in range(-a_max, a_max + 1)], axis=0)


def test_local_match_mixed_semantics_against_both_tpu_routes(rng):
    """Mixed mode of kernel 2 is "bf16 cross, f32 norms" (the config's
    definition): with bf16 x and ys the port computes every distance in
    float32 from the bf16 values, products exact.  Neither TPU route of
    the JAX package does quite that, and each is held here within its own
    rounding, live entries only (penalised ones squash to 1 on every
    route):

    * the Pallas kernel (interpret mode) rounds each product x_c·y_c and
      ‖y‖² (its side-band lane) to bf16, whose unit roundoff is 2⁻⁸ (8
      significant bits): per offset |Δd| ≤ 2⁻⁸ (‖y′‖² + 2 x·y′) (inputs
      ≥ 0), so a min differs by at most the window's largest such term;
    * the XLA scan in bf16 rounds ‖x‖², ‖y′‖², the cross term, their sum
      and the difference to bf16: |Δd| ≤ 2⁻⁸ (3 (‖x‖² + ‖y′‖²) + 2 x·y′).

    Both bounds get 1 % slack for second-order terms.  The port equals
    the Pallas kernel fed float32 copies of the same bf16 values (1e-3)."""
    h, w, c, o = 13, 15, 100, 3
    radii, a_max = (1, 2, 3), 3
    x = torch.from_numpy(np.maximum(rng.standard_normal((h, w, c)), 0)
                         .astype(np.float32)).bfloat16()
    ys = torch.from_numpy(np.maximum(rng.standard_normal((2, h, w, c)), 0)
                          .astype(np.float32)).bfloat16()
    onehot = np.eye(o, dtype=np.float32)[rng.integers(0, o, (h, w))]
    onehot[rng.random((h, w)) < 0.1] = 0.0
    xf, yf = x.float().numpy(), ys.float().numpy()
    got = tops.local_match(x, ys, _t(onehot), radii).numpy()

    def pallas(dtype):
        return np.stack([np.asarray(local_matching_pallas(
            jnp.asarray(xf, dtype), jnp.asarray(yf[s], dtype),
            jnp.asarray(onehot), radii, 1, interpret=True)) for s in range(2)])

    pal, pal32 = pallas(jnp.bfloat16), pallas(jnp.float32)
    scan = np.asarray(jm._local_matching_online_stacked(
        jnp.asarray(xf, jnp.bfloat16), jnp.asarray(yf, jnp.bfloat16),
        jnp.asarray(onehot), radii, a_max, 2 * a_max + 1, 1, a_max))
    live = got < 2.5e4
    for ref in (pal, pal32, scan):
        np.testing.assert_array_equal(ref < 2.5e4, live)
    np.testing.assert_allclose(got[live], pal32[live], atol=1e-3)

    x2 = (xf ** 2).sum(-1)
    yp = np.pad(yf, ((0, 0), (a_max, a_max), (a_max, a_max), (0, 0)))
    y2p = np.pad((yf ** 2).sum(-1), ((0, 0), (a_max, a_max), (a_max, a_max)),
                 constant_values=-np.inf)

    def term(wy, wx):
        def v(dy, dx):
            sl = (slice(None), slice(a_max + dy, a_max + dy + h),
                  slice(a_max + dx, a_max + dx + w))
            xy = (yp[sl] * xf).sum(-1)
            return wy * y2p[sl] + wx * x2 + 2.0 * xy
        # [S, h, w] → broadcast over objects and radii
        return _window_max(v, a_max)[..., None, None] * 2.0 ** -8 * 1.01

    bounds = {"pallas": (pal, term(1.0, 0.0)), "scan": (scan, term(3.0, 3.0))}
    for name, (ref, bound) in bounds.items():
        err = np.abs(got - ref)
        bound = np.broadcast_to(bound, got.shape)
        assert (err[live] <= bound[live] + 1e-3).all(), (
            name, err[live].max(), (err - bound)[live].max())
        # the difference is real: the routes do not compute the port's values
        assert err[live].max() > 1e-2, name


def test_local_matching_bank_stacked_matches_jax(rng):
    hh, ww, c, o = 17, 21, 16, 3
    radii = (2, 4)
    q = rng.standard_normal((hh, ww, c)).astype(np.float32)
    prev = rng.standard_normal((2, hh, ww, c)).astype(np.float32)
    onehot = np.eye(o, dtype=np.float32)[rng.integers(0, o, (hh, ww))]
    bias = rng.standard_normal(o).astype(np.float32) * 0.1
    want = np.asarray(jm.local_matching_bank_stacked(
        jnp.asarray(q), jnp.asarray(prev), jnp.asarray(onehot),
        jnp.asarray(bias), radii))
    got = tm.local_matching_bank_stacked(_t(q), _t(prev), _t(onehot),
                                         _t(bias), radii).numpy()
    assert got.shape == want.shape == (2, hh, ww, o, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_kmeans_cluster_matching_with_injected_scores(rng):
    r, c, o, k = 300, 8, 3, 4
    emb = rng.standard_normal((r, c)).astype(np.float32)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, o, r)]
    lab[:, 2] = 0.0
    lab[:3, 2] = 1.0                      # fewer pixels than clusters
    key = jax.random.PRNGKey(5)
    banks_j = jk.cluster_objects(jnp.asarray(emb), jnp.asarray(lab), key,
                                 k=k, iters=4)
    scores = np.stack([np.asarray(jax.random.uniform(kk, (r,), minval=0.5,
                                                     maxval=1.0))
                       for kk in jax.random.split(key, o)])
    banks_t = tops.cluster_objects(_t(emb), _t(lab), _t(scores), k=k, iters=4)
    np.testing.assert_array_equal(banks_t.cent_valid.numpy(),
                                  np.asarray(banks_j.cent_valid))
    np.testing.assert_array_equal(banks_t.mean_valid.numpy(),
                                  np.asarray(banks_j.mean_valid))
    cv = np.asarray(banks_j.cent_valid)
    np.testing.assert_allclose(banks_t.centroids.numpy()[cv],
                               np.asarray(banks_j.centroids)[cv], atol=1e-4)
    q = rng.standard_normal((5, 6, c)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32) * 0.1
    want = np.asarray(jk.cluster_matching(jnp.asarray(q), banks_j,
                                          jnp.asarray(bias)))
    got = tops.cluster_matching(_t(q), banks_t, _t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_heads_proxies_fg2bg_entropy(rng):
    s, h, w, c, o = 2, 5, 6, 8, 3
    ref = rng.standard_normal((s, h, w, c)).astype(np.float32)
    ref_oh = np.eye(o, dtype=np.float32)[rng.integers(0, o, (s, h, w))]
    slot_valid = np.array([1.0, 0.0], np.float32)
    prev = rng.standard_normal((h, w, c)).astype(np.float32)
    prev_oh = np.eye(o, dtype=np.float32)[rng.integers(0, o, (h, w))]
    hj = jp.attention_heads(jnp.asarray(ref), jnp.asarray(ref_oh),
                            jnp.asarray(slot_valid), jnp.asarray(prev),
                            jnp.asarray(prev_oh), 1e-5)
    ht = tops.attention_heads(_t(ref), _t(ref_oh), _t(slot_valid), _t(prev),
                              _t(prev_oh), 1e-5)
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(
        tops.proxy_reconstructed_embedding(_t(prev_oh), ht.prev_pos).numpy(),
        np.asarray(jp.proxy_reconstructed_embedding(jnp.asarray(prev_oh),
                                                    hj.prev_pos)), atol=1e-4)
    bias = rng.standard_normal(o).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tops.proxy_matching(_t(prev), ht.ref_pos, _t(bias)).numpy(),
        np.asarray(jm.proxy_matching(jnp.asarray(prev), hj.ref_pos,
                                     jnp.asarray(bias))), atol=1e-4)
    dis = rng.uniform(0, 1, (h, w, o, 2)).astype(np.float32)
    for valid in ([1, 1, 1], [1, 1, 0], [1, 0, 0]):
        v = np.asarray(valid, np.float32)
        np.testing.assert_allclose(
            tops.foreground2background(_t(dis), _t(v)).numpy(),
            np.asarray(jm.foreground2background(jnp.asarray(dis),
                                                jnp.asarray(v))), atol=1e-6)
    probs = rng.dirichlet(np.ones(o), (h, w)).transpose(2, 0, 1)
    probs = probs.astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(
        tops.shannon_entropy(_t(probs), _t(mask)).numpy(),
        np.asarray(j_entropy(jnp.asarray(probs), jnp.asarray(mask))),
        atol=1e-5)


def test_wrappers_take_plain_path_only_on_cpu(rng):
    """CPU tensors run the plain version without counting a launch; any
    other non-CUDA device is refused rather than computed elsewhere."""
    n1, n2 = tops.global_seg_map.launches, tops.local_match.launches
    q = torch.zeros((4, 8))
    r = torch.zeros((128, 8))
    tops.global_seg_map(q, r, torch.zeros(128), torch.zeros(2, dtype=torch.int32),
                        n_obj=2)
    tops.local_match(torch.zeros((3, 4, 8)), torch.zeros((2, 3, 4, 8)),
                     torch.zeros((3, 4, 2)), (1,))
    assert (tops.global_seg_map.launches, tops.local_match.launches) == (n1, n2)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.global_seg_map(torch.empty((4, 8), **meta),
                            torch.empty((128, 8), **meta),
                            torch.empty(128, **meta),
                            torch.empty(2, dtype=torch.int32, **meta), n_obj=2)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.local_match(torch.empty((3, 4, 8), **meta),
                         torch.empty((2, 3, 4, 8), **meta),
                         torch.empty((3, 4, 2), **meta), (1,))
    # operands split across devices are refused before any launch
    with pytest.raises(ValueError, match="one device expected"):
        tops.global_seg_map(q, torch.empty((128, 8), **meta), torch.zeros(128),
                            torch.zeros(2, dtype=torch.int32), n_obj=2)
    with pytest.raises(ValueError, match="one device expected"):
        tops.local_match(torch.zeros((3, 4, 8)), torch.empty((2, 3, 4, 8), **meta),
                         torch.zeros((3, 4, 2)), (1,))


def test_flat_and_uniform_wrappers_take_plain_path_only_on_cpu():
    """B.3's and B.2's wrappers, as kernel 1's and 2's above."""
    n1, n2 = tops.global_flat_min.launches, tops.global_seg.launches
    tops.global_flat_min(torch.zeros((4, 8)), torch.zeros((100, 8)),
                         torch.zeros((100, 3)))
    tops.global_seg(torch.zeros((4, 8)), torch.zeros((2048, 8)),
                    torch.zeros(2048), n_obj=2)
    assert (tops.global_flat_min.launches, tops.global_seg.launches) == (n1, n2)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.global_flat_min(torch.empty((4, 8), **meta),
                             torch.empty((100, 8), **meta),
                             torch.empty((100, 3), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        tops.global_seg(torch.empty((4, 8), **meta),
                        torch.empty((2048, 8), **meta),
                        torch.empty(2048, **meta), n_obj=2)
    with pytest.raises(ValueError, match="one device expected"):
        tops.global_flat_min(torch.zeros((4, 8)), torch.empty((100, 8), **meta),
                             torch.zeros((100, 3)))
    with pytest.raises(ValueError, match="one device expected"):
        tops.global_seg(torch.zeros((4, 8)), torch.zeros((2048, 8)),
                        torch.empty(2048, **meta), n_obj=2)


def _route_bank(rng, kind, r=700, c=12, o=5):
    """A flat bank of ``r`` rows (not a multiple of 64) for B.3's one-hot
    route: one-hot rows of objects 0-3 (object 4 has none) and all-zero
    rows; ``general`` adds fractional, two-hot and out-of-range rows."""
    emb = rng.standard_normal((r, c)).astype(np.float32)
    lab = np.eye(o, dtype=np.float32)[rng.integers(0, o - 1, r)]
    lab[rng.random(r) < 0.2] = 0.0
    if kind == "general":
        lab[3] = 0.5
        lab[10, :2] = 1.0
        lab[rng.random(r) < 0.03] = [0.0, 1.0, 1.0, 0.0, 0.0]
        lab[20, 1] = 2.0
    return emb, lab


def _routed_min(q, emb, lab, mixed):
    """B.3's mixed-mode kernel routing in plain PyTorch: the bank in
    ``flat_route``'s order, 64-row steps; a pure step folds its min of d
    into A and into B of its object, a mixed step takes the penalised min
    of its rows into B; the result is min(B_o, A + 5e4)."""
    from rvos_tpu_torch.ops.cuda_flat import MIXED, flat_route
    from rvos_tpu_torch.ops.cuda_matching import prepare_operands
    q32, q2, r32, r2 = prepare_operands(q, emb, mixed)
    d = q2[:, None] + r2[None, :] - 2.0 * (q32 @ r32.T)
    perm, tags = flat_route(lab)
    ds, ls = d[:, perm], lab[perm]
    a = torch.full((q.shape[0],), float("inf"))
    b = torch.full((q.shape[0], lab.shape[1]), float("inf"))
    for s, tag in enumerate(tags.tolist()):
        cols = slice(s * 64, (s + 1) * 64)
        if tag == MIXED:
            pen = (1.0 - ls[cols].float()) * 5e4
            b = torch.minimum(b, (ds[:, cols, None] + pen[None]).amin(1))
        else:
            v = ds[:, cols].amin(1)
            a = torch.minimum(a, v)
            if tag >= 0:
                b[:, tag] = torch.minimum(b[:, tag], v)
    return torch.minimum(b, a[:, None] + 5e4)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kind", ["onehot", "general"])
def test_flat_route_min_equals_plain(kind, mixed, rng):
    """The per-object min over the label-sorted bank, taken step by step
    as the mixed-mode kernel routes it (pure steps: min(B_o, A + 5e4);
    mixed steps: the penalised min), equals ``global_flat_min_plain`` on
    the unsorted bank exactly, for one-hot, zero, fractional, two-hot and
    out-of-range label rows."""
    emb, lab = _route_bank(rng, kind)
    q = _t(rng.standard_normal((30, emb.shape[1])).astype(np.float32))
    got = _routed_min(q, _t(emb), _t(lab), mixed)
    want = tops.global_flat_min_plain(q, _t(emb), _t(lab), mixed)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["onehot", "general"])
def test_flat_route_sorts_stably_and_tags_mixed_steps(kind, rng):
    """``flat_route``: a stable sort by key (object, -1 for all-zero rows,
    O for general rows); a step is tagged by its key only when all its
    real rows share that key and it is not general, else MIXED — so
    with one-hot-or-zero labels at most O + 1 steps (one per key
    boundary) are mixed."""
    from rvos_tpu_torch.ops.cuda_flat import MIXED, flat_route
    emb, lab = _route_bank(rng, kind)
    r, o = lab.shape
    one = lab == 1.0
    clean = ((lab == 0.0) | one).all(1) & (one.sum(1) <= 1)
    key = np.where(clean, np.where(one.any(1), one.argmax(1), -1), o)
    perm, tags = flat_route(_t(lab))
    perm = perm.numpy()
    np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
    ks = key[perm]
    assert tags.dtype == torch.int32 and tags.shape == (-(-r // 64),)
    for s, tag in enumerate(tags.tolist()):
        step = set(ks[s * 64:(s + 1) * 64].tolist())
        if len(step) > 1 or o in step:
            assert tag == MIXED, (s, step)
        else:
            assert tag == step.pop(), s
    if kind == "onehot":
        assert (tags == MIXED).sum() <= o + 1
    else:
        assert (tags == MIXED).sum() >= 2      # the general rows' steps


@pytest.mark.parametrize("m,n_steps", [(25773, 3222), (25773, 256),
                                       (25773, 176), (64, 5), (3001, 40)])
def test_tc_steps_per_split(m, n_steps):
    """The bank split of the tensor-core kernels on a 132-SM card: the
    runs cover every step, none is empty, each holds at least 8 steps
    unless the bank is shorter, and the grid stays near 8 CTAs per SM."""
    from rvos_tpu_torch.ops.cuda_matching import tc_steps_per_split
    per = tc_steps_per_split(m, n_steps, 132)
    runs = -(-n_steps // per)
    assert (runs - 1) * per < n_steps <= runs * per
    assert per >= min(8, n_steps)
    assert runs * -(-m // 128) <= 8 * 132 + -(-m // 128)
