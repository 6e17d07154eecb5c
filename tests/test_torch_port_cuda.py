"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

Tolerance: max |kernel − plain| / max(|plain|, 1) ≤ 1e-4 in float32
(summation order only) and ≤ 4e-3 in mixed mode (the tensor-core path:
the same bf16 operands, float32 accumulation in another order).
"""

import numpy as np
import pytest
import torch

from rvos_tpu_torch import ops
from rvos_tpu_torch.data import SyntheticEval
from rvos_tpu_torch.engine import Evaluator
from rvos_tpu_torch.engine.lockstep import (WHOLE_VIDEO_LAYOUTS,
                                            gate_failures, lockstep_chunks,
                                            lockstep_masks, parity_config,
                                            parity_scores,
                                            whole_video_agreement)
from rvos_tpu_torch.models import AOCNet
from rvos_tpu_torch.ops.matching import (compact_reference_bank_occupancy,
                                         compact_reference_bank_segmented)
from rvos_tpu_torch.weights import init_random_

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("m,c,o", [(3001, 100, 5), (70, 12, 3), (64, 128, 11)])
def test_global_seg_map_matches_plain(dev, mixed, m, c, o):
    g = torch.Generator(device=dev).manual_seed(m)
    emb = torch.randn((9000, c), generator=g, device=dev)
    lab = torch.nn.functional.one_hot(
        torch.randint(1, o, (9000,), generator=g, device=dev), o).float()
    r, rl, tile_obj = compact_reference_bank_occupancy(emb, lab, 4096)
    p = r.shape[0]
    row_obj = tile_obj.long().repeat_interleave(p // tile_obj.shape[0])
    bias = (1.0 - rl.gather(1, row_obj[:, None])[:, 0]) * 5e4
    q = torch.randn((m, c), generator=g, device=dev)
    n0 = ops.global_seg_map.launches
    got = ops.global_seg_map(q, r, bias, tile_obj, o, mixed)
    torch.cuda.synchronize()
    assert ops.global_seg_map.launches == n0 + 1
    want = ops.global_seg_map_plain(q, r, bias, tile_obj, o, mixed)
    assert _rel_err(got, want) <= (4e-3 if mixed else 1e-4)
    empty = torch.bincount(tile_obj.long(), minlength=o) == 0
    assert (got[:, empty] == 1e5).all()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("m,r,c,o", [(3001, 2500, 100, 11), (70, 999, 12, 1),
                                     (64, 4096, 128, 3), (129, 1000, 100, 32),
                                     (5, 63, 12, 16), (200, 700, 128, 17)])
def test_global_flat_min_matches_plain(dev, mixed, m, r, c, o):
    """B.3 with general labels: one-hot rows, padding rows, a fractional
    label row and an object with no rows; M and R not multiples of 64."""
    g = torch.Generator(device=dev).manual_seed(m + r)
    q = torch.randn((m, c), generator=g, device=dev)
    emb = torch.randn((r, c), generator=g, device=dev)
    lab = torch.nn.functional.one_hot(
        torch.randint(0, max(o - 1, 1), (r,), generator=g, device=dev),
        o).float()
    lab[torch.rand((r,), generator=g, device=dev) < 0.2] = 0.0
    lab[0] = 0.5
    n0 = ops.global_flat_min.launches
    got = ops.global_flat_min(q, emb, lab, mixed)
    torch.cuda.synchronize()
    assert ops.global_flat_min.launches == n0 + 1
    want = ops.global_flat_min_plain(q, emb, lab, mixed)
    assert got.shape == want.shape == (m, o)
    assert _rel_err(got, want) <= (4e-3 if mixed else 1e-4)


def _flat_labels(kind, r, o, g, dev):
    """Label matrices for B.3's one-hot route: one object only, all zero,
    one-hot runs of uneven lengths in bank order (so sorted runs begin
    mid-step) with object o-1 empty, or general rows (fractional,
    two-hot, out of range) among one-hot and zero ones."""
    lab = torch.zeros((r, o), device=dev)
    if kind == "one_object":
        lab[:, o // 2] = 1.0
    elif kind == "runs":
        ends = torch.randint(0, r, (max(o - 2, 1),), generator=g,
                             device=dev).sort().values.tolist() + [r]
        start = 0
        for obj, end in enumerate(ends):
            lab[start:end, obj % max(o - 1, 1)] = 1.0
            start = end
        lab[torch.rand((r,), generator=g, device=dev) < 0.1] = 0.0
    elif kind == "general":
        lab = torch.nn.functional.one_hot(
            torch.randint(0, o, (r,), generator=g, device=dev), o).float()
        lab[torch.rand((r,), generator=g, device=dev) < 0.2] = 0.0
        lab[1] = 0.5
        lab[2, : min(2, o)] = 1.0
        lab[torch.rand((r,), generator=g, device=dev) < 0.02, 0] = 1.0
        lab[3, 0] = 2.0
    return lab


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kind", ["one_object", "zero", "runs", "general"])
@pytest.mark.parametrize("m,r,c,o", [(3001, 2500, 100, 11), (77, 1001, 12, 3),
                                     (130, 700, 128, 17)])
def test_global_flat_min_label_routes(dev, mixed, kind, m, r, c, o):
    """B.3 with banks that exercise the mixed-mode route: a bank of one
    object, of zero rows only, runs beginning mid-step with an empty
    object, and general rows that force mixed steps."""
    g = torch.Generator(device=dev).manual_seed(m + o)
    q = torch.randn((m, c), generator=g, device=dev)
    emb = torch.randn((r, c), generator=g, device=dev)
    lab = _flat_labels(kind, r, o, g, dev)
    got = ops.global_flat_min(q, emb, lab, mixed)
    torch.cuda.synchronize()
    want = ops.global_flat_min_plain(q, emb, lab, mixed)
    assert _rel_err(got, want) <= (4e-3 if mixed else 1e-4)


@pytest.mark.parametrize("kind", ["one_object", "zero", "runs", "general"])
def test_flat_route_on_card_matches_cpu(dev, kind):
    """``flat_route``'s kernels (keys, stable sort, tags) give the plain
    version's permutation and step tags, R not a multiple of 64."""
    g = torch.Generator(device=dev).manual_seed(9)
    lab = _flat_labels(kind, 3001, 11, g, dev)
    perm, tags = ops.cuda_flat.flat_route(lab)
    want_perm, want_tags = ops.cuda_flat.flat_route(lab.cpu())
    assert torch.equal(perm.cpu(), want_perm)
    assert torch.equal(tags.cpu(), want_tags)


@pytest.mark.parametrize("kind", ["runs", "general"])
def test_global_flat_min_mixed_ignores_row_order(dev, kind):
    """B.3's mixed result on a row-permuted bank equals the unpermuted
    one exactly: a min does not depend on row order, and no pair's
    distance depends on where its row lies."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1000, 100), generator=g, device=dev)
    emb = torch.randn((5000, 100), generator=g, device=dev)
    lab = _flat_labels(kind, 5000, 11, g, dev)
    perm = torch.randperm(5000, generator=g, device=dev)
    got = ops.global_flat_min(q, emb[perm], lab[perm], True)
    want = ops.global_flat_min(q, emb, lab, True)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 16])
def test_global_seg_map_tile_rows(dev, mixed, k):
    """Kernel 1 at tile sizes 64·k, with tiles of no object (-1), one
    object owning no tile, filler rows biased by 5e4, and M not a
    multiple of 128."""
    g = torch.Generator(device=dev).manual_seed(k)
    m, c, o, n_tiles = 1000, 100, 6, 40
    tile_obj = torch.randint(-1, o - 1, (n_tiles,), generator=g,
                             device=dev).int()
    p = n_tiles * 64 * k
    r = torch.randn((p, c), generator=g, device=dev)
    bias = (torch.rand((p,), generator=g, device=dev) < 0.1).float() * 5e4
    q = torch.randn((m, c), generator=g, device=dev)
    got = ops.global_seg_map(q, r, bias, tile_obj, o, mixed)
    torch.cuda.synchronize()
    want = ops.global_seg_map_plain(q, r, bias, tile_obj, o, mixed)
    assert _rel_err(got, want) <= (4e-3 if mixed else 1e-4)
    assert (got[:, o - 1] == 1e5).all()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("m,c,o", [(3001, 100, 11), (70, 12, 3), (64, 128, 1),
                                   (129, 100, 32)])
def test_global_seg_matches_plain(dev, mixed, m, c, o):
    """B.2: kernel 1 routed by the uniform quotas, against its plain
    version, with filler rows in every short segment."""
    g = torch.Generator(device=dev).manual_seed(m + o)
    emb = torch.randn((9000, c), generator=g, device=dev)
    lab = torch.nn.functional.one_hot(
        torch.randint(0, o, (9000,), generator=g, device=dev), o).float()
    r, rl = compact_reference_bank_segmented(emb, lab, 4096)
    p = r.shape[0]
    own = rl.gather(1, torch.arange(o, device=dev).repeat_interleave(
        p // o)[:, None])[:, 0]
    bias = (1.0 - own) * 5e4
    q = torch.randn((m, c), generator=g, device=dev)
    n0, n1 = ops.global_seg.launches, ops.global_seg_map.launches
    got = ops.global_seg(q, r, bias, o, mixed)
    torch.cuda.synchronize()
    assert (ops.global_seg.launches, ops.global_seg_map.launches) == (n0 + 1, n1)
    want = ops.global_seg_plain(q, r, bias, o, mixed)
    assert got.shape == want.shape == (m, o)
    assert _rel_err(got, want) <= (4e-3 if mixed else 1e-4)


# ---- the float32 (parity) routes of kernels 1 and 3 (dist_tile.cuh ffma::)

def _f32_rows(g, dev, shape, signed):
    x = torch.randn(shape, generator=g, device=dev)
    return x if signed else torch.relu(x)


def _with_copies(g, q, bank):
    """q with every third row a copy of a bank row (d ≈ 0 there, under
    ‖q‖² + ‖r‖² ≫ d)."""
    q = q.clone()
    idx = torch.randint(0, bank.shape[0], (q[::3].shape[0],), generator=g,
                        device=q.device)
    q[::3] = bank[idx]
    return q


def _f64(q, r, seed):
    """‖q − r‖² + seed[r] in float64, as q2 + r2 + seed − 2 q·r."""
    qd, rd = q.double(), r.double()
    return ((qd * qd).sum(1)[:, None] + (rd * rd).sum(1)[None, :]
            + seed.double()[None, :] - 2.0 * qd @ rd.T)


def _f32_check(got, want, exact, signed):
    """Within 1e-4 of max(|d|, 1) of the float64 function and, for
    non-negative rows, of the plain version: with mixed-sign rows the
    plain version's own rounding at d ≈ 0 nears 1e-4
    (``test_torch_port_f32_order.py``)."""
    assert _rel_err(got.double(), exact) <= 1e-4
    if not signed:
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("m,n_tiles,c,o", [(3001, 40, 100, 11),
                                           (130, 9, 32, 1),
                                           (257, 21, 128, 32),
                                           (77, 13, 100, 7)])
def test_global_seg_map_f32_ragged(dev, m, n_tiles, c, o, signed):
    """Kernel 1's float32 route at ragged shapes (M not a multiple of
    128; C of 32, 100 and 128; O from 1 to 32; 64-row tiles, tiles of no
    object, an object without tiles, filler rows biased by 5e4), a third
    of the query rows copies of bank rows; B.2 through its uniform
    quotas at the same M, C and O."""
    g = torch.Generator(device=dev).manual_seed(m + c)
    tile_obj = torch.randint(-1, max(o - 1, 1), (n_tiles,), generator=g,
                             device=dev).int()
    p = n_tiles * 64
    r = _f32_rows(g, dev, (p, c), signed)
    bias = (torch.rand((p,), generator=g, device=dev) < 0.1).float() * 5e4
    q = _with_copies(g, _f32_rows(g, dev, (m, c), signed), r)
    got = ops.global_seg_map(q, r, bias, tile_obj, o, False)
    want = ops.global_seg_map_plain(q, r, bias, tile_obj, o, False)
    d = _f64(q, r, bias)
    exact = torch.full((m, o), 1e5, dtype=torch.float64, device=dev)
    for t, k in enumerate(tile_obj.tolist()):
        if 0 <= k < o:
            exact[:, k] = torch.minimum(exact[:, k],
                                        d[:, t * 64:(t + 1) * 64].amin(1))
    _f32_check(got, want, exact, signed)
    if o > 1:
        assert (got[:, o - 1] == 1e5).all()

    ru = _f32_rows(g, dev, (o * 1024, c), signed)
    bu = (torch.rand((o * 1024,), generator=g, device=dev) < 0.1).float() * 5e4
    got = ops.global_seg(q, ru, bu, o, False)
    want = ops.global_seg_plain(q, ru, bu, o, False)
    exact = _f64(q, ru, bu).view(m, o, 1024).amin(2)
    _f32_check(got, want, exact, signed)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("kind", ["runs", "general"])
@pytest.mark.parametrize("m,r,c,o", [(3001, 2500, 100, 11), (130, 999, 32, 1),
                                     (257, 4097, 128, 32), (77, 700, 100, 17)])
def test_global_flat_min_f32_ragged(dev, m, r, c, o, kind, signed):
    """Kernel 3's float32 route at ragged shapes with one-hot runs that
    begin mid-step and an empty object, or general labels (fractional,
    two-hot, out-of-range and all-zero rows), a third of the query rows
    copies of bank rows."""
    g = torch.Generator(device=dev).manual_seed(m + r + c)
    emb = _f32_rows(g, dev, (r, c), signed)
    lab = _flat_labels(kind, r, o, g, dev)
    q = _with_copies(g, _f32_rows(g, dev, (m, c), signed), emb)
    n0 = ops.global_flat_min.launches
    got = ops.global_flat_min(q, emb, lab, False)
    assert ops.global_flat_min.launches == n0 + 1
    want = ops.global_flat_min_plain(q, emb, lab, False)
    pen = (1.0 - lab.double()) * 5e4
    exact = (_f64(q, emb, torch.zeros(r, device=dev))[:, :, None]
             + pen[None]).amin(1)
    assert got.shape == want.shape == (m, o)
    _f32_check(got, want, exact, signed)


@pytest.mark.parametrize("kind", ["runs", "general"])
def test_global_flat_min_f32_ignores_row_order(dev, kind):
    """B.3's float32 result on a row-permuted bank equals the unpermuted
    one bit for bit: no pair's distance depends on where its row lies."""
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((1000, 100), generator=g, device=dev)
    emb = torch.randn((5000, 100), generator=g, device=dev)
    lab = _flat_labels(kind, 5000, 11, g, dev)
    perm = torch.randperm(5000, generator=g, device=dev)
    got = ops.global_flat_min(q, emb[perm], lab[perm], False)
    want = ops.global_flat_min(q, emb, lab, False)
    assert torch.equal(got, want), (got - want).abs().max().item()


def _f32_cases(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.relu(torch.randn((3001, 100), generator=g, device=dev))
    emb = torch.relu(torch.randn((6000, 100), generator=g, device=dev))
    lab = _flat_labels("general", 6000, 11, g, dev)
    r, rl, tile_obj = compact_reference_bank_occupancy(
        emb, _flat_labels("runs", 6000, 11, g, dev), 4096)
    row_obj = tile_obj.long().repeat_interleave(r.shape[0] // tile_obj.shape[0])
    bias = (1.0 - rl.gather(1, row_obj[:, None])[:, 0]) * 5e4
    return {"seg_map": lambda: ops.global_seg_map(q, r, bias, tile_obj, 11,
                                                  False),
            "flat": lambda: ops.global_flat_min(q, emb, lab, False)}


def test_global_f32_launches_are_deterministic(dev):
    """Two launches of each float32 route give the same result bit for
    bit: the bank splits combine by an order-independent atomic min."""
    for name, run in _f32_cases(dev).items():
        a, b = run(), run()
        assert torch.equal(a, b), name


@pytest.mark.parametrize("per", ["one_run", "one_step"])
def test_global_f32_split_equals_one_launch(dev, per, monkeypatch):
    """The float32 routes with the bank in one run per query tile, or in
    runs of one step each, equal the default split bit for bit."""
    from rvos_tpu_torch.ops import cuda_flat, cuda_matching
    cases = _f32_cases(dev)
    want = {name: run() for name, run in cases.items()}
    split = (lambda m, n, s: n) if per == "one_run" else (lambda m, n, s: 1)
    monkeypatch.setattr(cuda_matching, "f32_steps_per_split", split)
    monkeypatch.setattr(cuda_flat, "f32_steps_per_split", split)
    for name, run in cases.items():
        assert torch.equal(run(), want[name]), name


_RADII = (2, 4, 6, 8, 10, 12)


def _local_inputs(dev, dtype, hw, c, o, labels="random"):
    """x, ys (S = 2) and a one-hot map with unlabelled pixels ("random"),
    none labelled ("none") or one object everywhere ("one")."""
    g = torch.Generator(device=dev).manual_seed(hw[0] + c)
    h, w = hw
    x = torch.randn((h, w, c), generator=g, device=dev).to(dtype)
    ys = torch.randn((2, h, w, c), generator=g, device=dev).to(dtype)
    lab = torch.randint(-1, o, (h, w), generator=g, device=dev)
    if labels == "none":
        lab[:] = -1
    elif labels == "one":
        lab[:] = o - 1
    onehot = (lab[..., None] == torch.arange(o, device=dev)).float()
    return x, ys, onehot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,radii,atrous,c,o", [
    ((31, 54), (2, 4, 6), 1, 100, 11), ((13, 15), (1, 2, 3), 2, 100, 11),
    ((61, 107), _RADII, 1, 100, 11), ((61, 107), _RADII, 1, 20, 1),
    ((13, 15), (1, 2, 3), 2, 128, 32), ((61, 15), _RADII, 1, 128, 32),
    ((20, 130), (3, 5, 7), 2, 20, 11)])
def test_local_match_matches_plain(dev, dtype, hw, radii, atrous, c, o):
    """Kernel 2 against its plain version: widths that are not a multiple
    of the 64-pixel query tile (107, 130) or narrower than one (15), a
    frame narrower than the window (61×15 at reach 12), atrous 2, C ∈
    {20, 100, 128}, O ∈ {1, 11, 32}; the counter counts one launch."""
    x, ys, onehot = _local_inputs(dev, dtype, hw, c, o)
    n0 = ops.local_match.launches
    got = ops.local_match(x, ys, onehot, radii, atrous)
    torch.cuda.synchronize()
    assert ops.local_match.launches == n0 + 1
    want = ops.local_match_plain(x, ys, onehot, radii, atrous)
    assert got.shape == want.shape == (2,) + hw + (o, len(radii))
    assert _rel_err(got, want) <= (4e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels", ["none", "one"])
def test_local_match_label_maps(dev, dtype, labels):
    """A label map with no labelled pixel (every channel reads A + 5e4
    or 1e5) and one with a single object everywhere."""
    x, ys, onehot = _local_inputs(dev, dtype, (29, 70), 100, 11, labels)
    got = ops.local_match(x, ys, onehot, _RADII)
    torch.cuda.synchronize()
    want = ops.local_match_plain(x, ys, onehot, _RADII)
    assert _rel_err(got, want) <= (4e-3 if dtype == torch.bfloat16 else 1e-4)
    live = (want < 2.5e4).any(-1).any(0).any(0).any(0)
    assert live.tolist() == [labels == "one" and k == 10 for k in range(11)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_match_is_deterministic(dev, dtype):
    """The same call twice gives the same bits: the shared-memory mins do
    not depend on the order of their updates."""
    x, ys, onehot = _local_inputs(dev, dtype, (61, 107), 100, 11)
    a = ops.local_match(x, ys, onehot, _RADII)
    b = ops.local_match(x, ys, onehot, _RADII)
    torch.cuda.synchronize()
    assert torch.equal(a, b), (a - b).abs().max().item()


def test_local_match_strided_bf16_labels(dev):
    """The main path's operands: a query that is a permuted view (the
    resize's NCHW output) and a bf16 label map, read through their strides
    without a copy, against the plain version on contiguous float32
    copies."""
    x, ys, onehot = _local_inputs(dev, torch.bfloat16, (61, 107), 100, 11)
    xv = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert not xv.is_contiguous()
    got = ops.local_match(xv, ys, onehot.bfloat16(), _RADII)
    torch.cuda.synchronize()
    want = ops.local_match_plain(x, ys, onehot, _RADII)
    assert _rel_err(got, want) <= 4e-3


# the kernel each bank layout's global stream launches
_GLOBAL_KERNEL = {"occupancy": "global_seg_map", "cap0": "global_flat_min",
                  "unsegmented": "global_flat_min", "uniform": "global_seg"}


def _make_model(cfg):
    return lambda: init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))


def _make_seq():
    return SyntheticEval(size=(65, 65), n_seqs=1, n_frames=6)[0]


@pytest.mark.parametrize("layout", WHOLE_VIDEO_LAYOUTS)
def test_evaluator_on_card_matches_cpu(dev, layout):
    """The whole slice in parity mode: kernels on the card vs the plain
    versions on the CPU, same random weights and k-means draws, two
    independent runs of the whole video — the bank compactions and the
    state updates between frames included.  Masks agree on ≥ 99.9 % of
    pixels per frame, and the layout's global kernel launches on every
    frame after the first.  (At no cap a pixel flipped by rounding enters
    the bank; that layout is held by the lock-step test below.)"""
    cfg = parity_config(layout)
    kernel = getattr(ops, _GLOBAL_KERNEL[layout])
    n0 = kernel.launches
    agree = whole_video_agreement(cfg, _make_model(cfg), _make_seq,
                                  parity_scores)
    assert kernel.launches - n0 == 5
    assert len(agree) == 5 and min(agree) >= 0.999, agree


@pytest.mark.parametrize("layout", sorted(_GLOBAL_KERNEL))
def test_evaluator_lockstep_on_card_matches_cpu(dev, layout):
    """The whole slice in parity mode under each bank layout, each frame
    and each bank compaction repeated on the CPU (plain versions) from
    the card's state (``lockstep_masks``): the gate holds (masks agree on
    ≥ 99.9 % of pixels per frame, logits within 1e-2, every parted pixel
    a near tie), embeddings within 1e-3, the compacted banks (rows,
    labels, tile map) are identical, and the layout's global kernel
    launches on every frame after the first."""
    cfg = parity_config(layout)
    kernel = getattr(ops, _GLOBAL_KERNEL[layout])
    n0 = kernel.launches
    res = lockstep_masks(cfg, _make_model(cfg), _make_seq(), parity_scores)
    assert kernel.launches - n0 == 5
    assert len(res.agree) == 5 and not gate_failures(res), res
    assert res.max_demb < 1e-3
    assert len(res.banks_equal) == 3 and all(res.banks_equal)


@pytest.mark.parametrize("layout", sorted(_GLOBAL_KERNEL))
def test_evaluator_lockstep_mixed_on_card_matches_cpu(dev, layout):
    """As the lock-step test above, with mixed matching: the global
    kernels' tensor-core paths on the card against the plain mixed
    versions on the CPU, in float32 compute with TF32 off for
    convolutions too."""
    cfg = parity_config(layout, matching="mixed")
    kernel = getattr(ops, _GLOBAL_KERNEL[layout])
    n0 = kernel.launches
    res = lockstep_masks(cfg, _make_model(cfg), _make_seq(), parity_scores)
    assert kernel.launches - n0 == 5
    assert len(res.agree) == 5 and not gate_failures(res), res
    assert res.max_demb < 1e-3
    assert len(res.banks_equal) == 3 and all(res.banks_equal)


def _chunk_config(layout, matching="mixed"):
    """The parity setting in chunks of 3 with the bank appending after
    each (frames 1-3 and 4-6 of a 7-frame video are full chunks)."""
    return parity_config(layout, matching).replace(TEST_FRAME_CHUNK=3,
                                                   MEM_EVERY=3)


@pytest.mark.parametrize("matching", ["float32", "mixed"])
@pytest.mark.parametrize("layout", sorted(_GLOBAL_KERNEL))
def test_chunk_graph_replay_equals_eager_run(dev, layout, matching):
    """Each full chunk as a CUDA graph replay against the same chunk
    function run eagerly on the card from copies of the same state: the
    masks are identical (max |Δlogit| printed; expected 0).  The second
    chunk reads the bank as refreshed after frame 3."""
    cfg = _chunk_config(layout, matching)
    res = lockstep_chunks(cfg, _make_model(cfg),
                          SyntheticEval(size=(65, 65), n_seqs=1,
                                        n_frames=7)[0],
                          parity_scores, device="cuda", ref_device="cuda")
    print(f"{layout}/{matching}: replay vs eager max |dlogit| "
          f"{res.max_dlogit:.3e}, max |demb| {res.max_demb:.3e}")
    assert res.steps == [3, 3] and res.replays == 2
    assert res.agree == [1.0] * 6


def test_bank_refresh_reaches_the_graph(dev):
    """A graph captured on a state reads what ``add_ref`` and the bank
    compaction later write into that state's tensors: after a refresh,
    the replayed chunk equals the eager chunk from the same state, and
    differs from the eager chunk over the old bank."""
    cfg = _chunk_config("occupancy")
    ev = Evaluator(cfg, _make_model(cfg)(), device="cuda",
                   kmeans_scores=parity_scores)
    ev.evaluate_sequence(SyntheticEval(size=(65, 65), n_seqs=1,
                                       n_frames=4)[0])
    assert ev.captures == 1 and ev.replays == 1
    st = ev._last_states[0]
    (graph,) = st.graphs.values()
    io, hw = graph.io, (65, 65)

    def eager(state):
        io2 = io.copy_to(dev)
        ev.chunk_step(io2, [state.copy_to(dev)], hw)
        return io2.preds

    old = eager(st)
    lab = torch.zeros_like(st.conf)
    lab[:, : lab.shape[1] // 2] = 2
    st.add_ref(st.prev_emb, lab)
    ev._ensure_flat(st, np.array([1, 1, 1, 0], np.float32))
    want = eager(st)
    ev.run_chunk([st], io, hw)
    assert ev.replays == 2
    assert torch.equal(io.preds, want)
    assert not torch.equal(want, old)


def test_failed_capture_raises(dev):
    """A chunk step that cannot be captured (here it synchronises the
    card) raises; nothing falls back to an eager run."""
    cfg = _chunk_config("occupancy")
    model = _make_model(cfg)()
    ev = Evaluator(cfg, model, device="cuda", kmeans_scores=parity_scores)
    segment = ev.model.segment_frame

    def syncing(*args):
        torch.cuda.synchronize()
        return segment(*args)

    ev.model.segment_frame = syncing
    with pytest.raises(RuntimeError):
        ev.evaluate_sequence(SyntheticEval(size=(65, 65), n_seqs=1,
                                           n_frames=4)[0])
    assert ev.replays == 0


def _mf_config(matching="float32", chunk=1):
    """The parity setting with the ensemble: scales 1.0 and 1.3 with
    flip (65×65 and 81×81 frames, four variants)."""
    return parity_config("occupancy", matching).replace(
        TEST_FLIP=True, TEST_MULTISCALE=(1.0, 1.3), TEST_FRAME_CHUNK=chunk,
        MEM_EVERY=3 if chunk > 1 else 2)


@pytest.mark.parametrize("matching", ["float32", "mixed"])
def test_ensemble_lockstep_on_card_matches_cpu(dev, matching):
    """The ensemble frame by frame, every variant's ``segment_frame`` and
    every bank compaction repeated on the CPU from the card's state: the
    gate holds on each of the 4 × 5 calls, the banks are identical, and
    kernel 1 launches once per variant and frame.  The CPU goes on with
    the card's decoder masks, each parted entry a near tie."""
    cfg = _mf_config(matching)
    n0 = ops.global_seg_map.launches
    res = lockstep_masks(cfg, _make_model(cfg), _make_seq(), parity_scores,
                         share_masks=True)
    assert ops.global_seg_map.launches - n0 == 20
    assert len(res.agree) == 20 and not gate_failures(res), res
    assert res.max_demb < 1e-3
    assert len(res.banks_equal) == 12 and all(res.banks_equal)


@pytest.mark.parametrize("ref", ["cpu", "cuda"])
@pytest.mark.parametrize("matching", ["float32", "mixed"])
def test_ensemble_chunk_lockstep(dev, matching, ref):
    """The ensemble in chunks of 3: each chunk a graph replay on the card,
    repeated eagerly from copies of the same four states on the CPU (the
    gate holds; the CPU goes on with the card's decoder masks) or on the
    card (the masks are identical, each side with its own decoder
    masks)."""
    cfg = _mf_config(matching, chunk=3)
    res = lockstep_chunks(cfg, _make_model(cfg),
                          SyntheticEval(size=(65, 65), n_seqs=1,
                                        n_frames=7)[0],
                          parity_scores, device="cuda", ref_device=ref,
                          share_masks=ref == "cpu")
    assert res.steps == [3, 3] and res.replays == 2
    if ref == "cuda":
        assert res.agree == [1.0] * 6 and res.max_dlogit == 0.0, res
    else:
        assert len(res.agree) == 6 and not gate_failures(res), res


def test_default_draws_on_card_equal_cpu(dev):
    """The evaluator's default k-means draws (``ops.prng``) on the card
    equal the CPU's bit for bit, and those of a step are the same
    whichever block of frames they were drawn in."""
    from rvos_tpu_torch.ops.prng import kmeans_init_scores

    cfg = _chunk_config("occupancy")
    ev = Evaluator(cfg, _make_model(cfg)(), device="cuda")
    for frames in ([1, 2, 3], [4], [40, 41, 42, 43, 44]):
        got = ev.init_scores(frames, 16384)
        want = kmeans_init_scores(frames, cfg.MODEL_MAX_OBJ_NUM, 16384)
        assert got.is_cuda
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# ---- training (phase 5 of chip_smoke.py at small shapes) ----------------

def _train_config():
    from rvos_tpu_torch.configs import tiny_test
    return tiny_test(DATA_RANDOMCROP=(33, 33), DATA_CURR_SEQ_LEN=2,
                     MODEL_MULTI_LOCAL_DISTANCE=(1, 2), MODEL_MAX_OBJ_NUM=3,
                     MODEL_ASPP_DROPOUT=0.0, TRAIN_REMAT=False,
                     TRAIN_START_SEQ_TRAINING_STEPS=10 ** 6,
                     TRAIN_HARD_MINING_STEP=4, MATCHING_DTYPE="float32",
                     EVAL_COMPUTE_DTYPE="float32", TRAIN_AUTO_RESUME=False)


def _train_batch():
    from rvos_tpu_torch.cli.train import train_transform
    from rvos_tpu_torch.data import SyntheticTrain, TrainBatcher
    data = SyntheticTrain(size=(33, 33), curr_len=2, obj_num=2, length=1)
    return next(iter(TrainBatcher(data, 1, train_transform(_train_config(),
                                                           True),
                                  num_workers=1).epoch(0)))


@pytest.mark.parametrize("which", ["global", "local"])
def test_train_functions_on_card_match_cpu(dev, which):
    """The training route's Functions on the card against the CPU:
    forward within 1e-4 of max(|d|, 1), argmins equal but for float64
    near ties, the backward from the card's argmins within 1e-4."""
    from rvos_tpu_torch.ops import train_matching as tm
    rng = np.random.default_rng(3)
    o = 4
    if which == "global":
        q = torch.from_numpy(rng.standard_normal((900, 32)).astype(np.float32))
        r = torch.from_numpy(rng.standard_normal((5000, 32)).astype(np.float32))
        lab = torch.from_numpy(np.eye(o, dtype=np.float32)[
            rng.integers(0, o, 5000)])
        g = torch.from_numpy(rng.standard_normal((900, o)).astype(np.float32))
        d, a = tm.global_min_argmin(q.to(dev), r.to(dev), lab.to(dev))
        grads = tm.global_min_backward(q.to(dev), r.to(dev), a, g.to(dev))
        dc, ac = tm.global_min_argmin(q, r, lab)
        want = tm.global_min_backward(q, r, a.cpu(), g)
    else:
        radii = (2, 4, 6)
        x = torch.from_numpy(rng.standard_normal((21, 19, 32)).astype(np.float32))
        ys = torch.from_numpy(rng.standard_normal((2, 21, 19, 32))
                              .astype(np.float32))
        lab = torch.from_numpy(np.eye(o, dtype=np.float32)[
            rng.integers(0, o, (21, 19))])
        g = torch.from_numpy(rng.standard_normal((2, 21, 19, o, 3))
                             .astype(np.float32))
        d, a = tm.local_min_argmin(x.to(dev), ys.to(dev), lab.to(dev), radii)
        grads = tm.local_min_backward(x.to(dev), ys.to(dev), lab.to(dev), a,
                                      g.to(dev), radii)
        dc, ac = tm.local_min_argmin(x, ys, lab, radii)
        want = tm.local_min_backward(x, ys, lab, a.cpu(), g, radii)
    assert ((d.cpu() - dc).abs() / dc.abs().clamp(min=1.0)).max() <= 1e-4
    assert (a.cpu() != ac).float().mean() <= 1e-3
    for got, w in zip(grads, want):
        assert (got.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.fixture
def no_tf32():
    from rvos_tpu_torch.device import tf32_off
    with tf32_off():
        yield


def test_train_loss_fn_on_card_matches_cpu(dev, no_tf32):
    """One ``loss_fn`` with gradients on the card and on the CPU from the
    same weights, batch and draws, the decoder masks shared: per-frame
    losses within 1e-4, every gradient within 1e-3 of its tensor's
    largest |g| or three times the CPU's ten-ulp floor, all gradients
    together within 2e-2 relative L2; no kernel launched."""
    from rvos_tpu_torch.engine.grad_check import (floors, gradient_failures,
                                                  perturbed_state)
    from rvos_tpu_torch.engine.lockstep import _MaskWatch
    from rvos_tpu_torch.engine.train import Trainer, batch_to_device
    from rvos_tpu_torch.ops import prng

    cfg = _train_config()
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", init_state=cpu.model.state_dict())
    watch = _MaskWatch(gpu.model, cpu.model, True)
    batch = _train_batch()
    key = prng.next_step_key(prng.prng_key(prng.TRAIN_SEED))[1]

    def grads(tr):
        tr.optimizer.zero_grad()
        loss, (losses, _, _) = tr._step_fn.loss_fn(
            batch_to_device(batch, tr.device), 3, key.to(tr.device))
        loss.backward()
        return losses.detach().cpu(), {
            n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()
            if p.grad is not None}

    counters = [ops.global_seg_map, ops.global_seg, ops.global_flat_min,
                ops.local_match]
    for fn in counters:
        fn.launches = 0
    watch.begin(10 ** 9)
    gl, gg = grads(gpu)
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]
    cl, cg = grads(cpu)
    names = [n for n, _ in cpu.model.named_parameters()]
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    runs = []
    for seed in range(3):
        cpu.model.load_state_dict(perturbed_state(state, names, seed))
        watch.begin(10 ** 9)
        runs.append(grads(cpu)[1])
    assert ((gl - cl).abs() / cl.abs()).max() <= 1e-4, (gl, cl)
    bad, summary = gradient_failures(gg, cg, floors(cg, runs), 1e-3)
    assert not bad and not watch.unexplained, (bad[:10], summary)
    assert summary["all_l2_rel"] <= 2e-2, summary


def test_train_update_on_card_matches_cpu(dev, no_tf32):
    """One optimizer update on the card and on the CPU from the same
    state (momentum buffers, update count) and the same seeded
    gradients: every parameter within 1e-6 of its scale, and the two
    controls (no update, 1.01 times the learning rate) caught."""
    from rvos_tpu_torch.engine.grad_check import update_check
    from rvos_tpu_torch.engine.train import Trainer

    cfg = _train_config()
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", seed=1)
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        for p in cpu.model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        cpu.optimizer.step()
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in cpu.model.named_parameters()}
    r = update_check(gpu, cpu, grads)
    assert not r["failures"], r
    assert r["no_update"] and r["lr_1.01"], r


@pytest.mark.parametrize("route", ["compute", "matching"])
def test_bf16_train_loss_fn_on_card_matches_cpu(dev, route):
    """One ``loss_fn`` with gradients of a bf16 route
    (``TRAIN_COMPUTE_DTYPE="bfloat16"``; bfloat16 matching) on the card
    and on the CPU from the same weights, batch and draws, TF32 off and
    the decoder masks shared: losses, all gradients and each tensor
    (against three times the CPU's floor) within the route's bars
    (``engine.grad_check.BF16_BARS``); no kernel launched."""
    from rvos_tpu_torch.device import tf32_off
    from rvos_tpu_torch.engine.grad_check import (BF16_BARS, floors,
                                                  gradient_failures,
                                                  perturbed_state)
    from rvos_tpu_torch.engine.lockstep import _MaskWatch
    from rvos_tpu_torch.engine.train import Trainer, batch_to_device
    from rvos_tpu_torch.ops import prng

    kw = (dict(TRAIN_COMPUTE_DTYPE="bfloat16", MATCHING_DTYPE="mixed")
          if route == "compute" else dict(MATCHING_DTYPE="bfloat16"))
    cfg = _train_config().replace(**kw)
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", init_state=cpu.model.state_dict())
    watch = _MaskWatch(gpu.model, cpu.model, True)
    batch = _train_batch()
    key = prng.next_step_key(prng.prng_key(prng.TRAIN_SEED))[1]

    def grads(tr):
        tr.optimizer.zero_grad()
        watch.begin(10 ** 9)
        loss, (losses, _, _) = tr._step_fn.loss_fn(
            batch_to_device(batch, tr.device), 3, key.to(tr.device))
        loss.backward()
        return losses.detach().cpu(), {
            n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()
            if p.grad is not None}

    counters = [ops.global_seg_map, ops.global_seg, ops.global_flat_min,
                ops.local_match]
    for fn in counters:
        fn.launches = 0
    with tf32_off():
        gl, gg = grads(gpu)
        assert [fn.launches for fn in counters] == [0, 0, 0, 0]
        cl, cg = grads(cpu)
        names = [n for n, _ in cpu.model.named_parameters()]
        state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
        runs = []
        for seed in range(3):
            cpu.model.load_state_dict(perturbed_state(state, names, seed))
            runs.append(grads(cpu)[1])
    loss_bar, l2_bar, rel_tol = BF16_BARS[route]
    assert ((gl - cl).abs() / cl.abs()).max() <= loss_bar, (gl, cl)
    bad, summary = gradient_failures(gg, cg, floors(cg, runs), rel_tol)
    assert not bad and not watch.unexplained, (bad[:10], summary)
    assert summary["all_l2_rel"] <= l2_bar, summary


def test_bf16_stages_on_card_match_cpu(dev):
    """Every stage of the bf16 training route alone
    (``engine.stage_check``), card against CPU from the same bf16
    inputs and output gradient, TF32 off: output, input and parameter
    gradients within ``stage_check.CARD_BARS``, each bar below the gap
    of the card's float32 run of the stage."""
    from rvos_tpu_torch.device import tf32_off
    from rvos_tpu_torch.engine.stage_check import stage_gaps
    from rvos_tpu_torch.engine.train import Trainer

    cfg = _train_config().replace(MATCHING_DTYPE="mixed")
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", init_state=cpu.model.state_dict())
    with tf32_off():
        r = stage_gaps(cpu.model, gpu.model, seed=1)
    assert not r["failures"], {k: r["stages"][k] for k in r["failures"]}


@pytest.mark.parametrize("matching", ["float32", "mixed"])
def test_mobilenet_evaluator_lockstep_on_card_matches_cpu(dev, matching):
    """The MobileNetV2 model through the evaluator, each frame repeated on
    the CPU from the card's state: the gate holds and B.1 and B.4 launch
    on every frame after the first."""
    cfg = parity_config("occupancy", matching).replace(
        MODEL_BACKBONE="mobilenet")
    n0, l0 = ops.global_seg_map.launches, ops.local_match.launches
    res = lockstep_masks(cfg, _make_model(cfg), _make_seq(), parity_scores)
    assert ops.global_seg_map.launches - n0 == 5
    assert ops.local_match.launches - l0 == 5
    assert len(res.agree) == 5 and not gate_failures(res), res
    assert res.max_demb < 1e-3


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_flat_min_equals_one_launch(dev, mixed, n):
    """B.3 on query-row shards and on bank shards (M = 3001 and R = 2500
    padded to multiples of n; one object without bank rows) against one
    launch over everything: equal bit for bit after the squash (each
    pair's distance is computed alike; a min is exact); one launch per
    shard."""
    from rvos_tpu_torch.parallel import (global_matching_bank_sharded,
                                         global_matching_context_parallel)
    g = torch.Generator(device=dev).manual_seed(n)
    q = torch.relu(torch.randn((3001, 100), generator=g, device=dev))
    r = torch.relu(torch.randn((2500, 100), generator=g, device=dev))
    lab = torch.nn.functional.one_hot(
        torch.randint(0, 3, (2500,), generator=g, device=dev), 4).float()
    bias = torch.zeros(4, device=dev)
    qe = q.reshape(3001, 1, 100)
    want = ops.global_matching_flat(qe, r, lab, bias, mixed=mixed)
    for fn in (global_matching_context_parallel, global_matching_bank_sharded):
        n0 = ops.global_flat_min.launches
        got = fn(qe, r, lab, bias, [dev] * n, mixed=mixed)
        assert ops.global_flat_min.launches == n0 + n
        assert torch.equal(got, want), fn.__name__


def test_nccl_step_of_one_rank(dev):
    """One training step at world size 1 over NCCL: the reduce runs (an
    identity: the gradients the optimizer reads equal the backward's bit
    for bit) and the loss is the plain step's, within 1e-5 relative (the
    card's backward is not run-to-run deterministic: atomics in
    ``index_add_`` and cuDNN's weight gradients)."""
    from rvos_tpu_torch.configs import tiny_test
    from rvos_tpu_torch.engine.dp_check import data_parallel_steps
    from rvos_tpu_torch.engine.train import Trainer
    from rvos_tpu_torch.parallel.launch import launch

    cfg = tiny_test(DATA_RANDOMCROP=(33, 33), DATA_CURR_SEQ_LEN=2,
                    MODEL_MULTI_LOCAL_DISTANCE=(1, 2), MODEL_MAX_OBJ_NUM=3)
    init = Trainer(cfg, device="cpu", seed=0).model.state_dict()
    rng = np.random.default_rng(0)
    lab = np.zeros((1, 33, 33), np.int32)
    lab[:, 4:20, 5:25] = 1
    batch = {"ref_img": rng.standard_normal((1, 33, 33, 3), np.float32),
             "prev_img": rng.standard_normal((1, 33, 33, 3), np.float32),
             "curr_img": rng.standard_normal((2, 1, 33, 33, 3), np.float32),
             "ref_label": lab, "prev_label": lab,
             "curr_label": np.stack([lab, lab]),
             "obj_num": np.array([1], np.int32)}
    nccl = launch(data_parallel_steps, 1, "nccl", [dev],
                  (cfg, init, [batch]))[0]["steps"][0]
    plain = data_parallel_steps(0, 1, dev, cfg, init, [batch])["steps"][0]
    assert nccl["reduce_bytes"] > 0 and plain["reduce_bytes"] == 0
    for name, grad in nccl["local_grads"].items():
        assert torch.equal(nccl["grads"][name], grad), name
    assert abs(float(nccl["loss"]) - float(plain["loss"])) <= 1e-5 * abs(
        float(plain["loss"]))
