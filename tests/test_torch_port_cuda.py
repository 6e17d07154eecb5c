"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

Tolerance: max |kernel − plain| / max(|plain|, 1) ≤ 1e-4 in float32
(summation order only) and ≤ 4e-3 in mixed mode.
"""

import pytest
import torch

from rvos_tpu_torch import ops
from rvos_tpu_torch.data import SyntheticEval
from rvos_tpu_torch.engine.lockstep import (WHOLE_VIDEO_LAYOUTS, lockstep_masks,
                                            parity_config, parity_scores,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,radii,atrous", [((31, 54), (2, 4, 6), 1),
                                             ((13, 15), (1, 2, 3), 2),
                                             ((61, 107), (2, 4, 6, 8, 10, 12), 1)])
def test_local_match_matches_plain(dev, dtype, hw, radii, atrous):
    g = torch.Generator(device=dev).manual_seed(hw[0])
    h, w = hw
    x = torch.randn((h, w, 100), generator=g, device=dev).to(dtype)
    ys = torch.randn((2, h, w, 100), generator=g, device=dev).to(dtype)
    lab = torch.randint(-1, 11, (h, w), generator=g, device=dev)
    onehot = (lab[..., None] == torch.arange(11, device=dev)).float()
    n0 = ops.local_match.launches
    got = ops.local_match(x, ys, onehot, radii, atrous)
    torch.cuda.synchronize()
    assert ops.local_match.launches == n0 + 1
    want = ops.local_match_plain(x, ys, onehot, radii, atrous)
    assert got.shape == want.shape == (2, h, w, 11, len(radii))
    assert _rel_err(got, want) <= (4e-3 if dtype == torch.bfloat16 else 1e-4)


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
    the card's state (``lockstep_masks``): masks agree on ≥ 99.9 % of
    pixels per frame, logits within 1e-2, embeddings within 1e-3, the
    compacted banks (rows, labels, tile map) are identical, and the
    layout's global kernel launches on every frame after the first."""
    cfg = parity_config(layout)
    kernel = getattr(ops, _GLOBAL_KERNEL[layout])
    n0 = kernel.launches
    res = lockstep_masks(cfg, _make_model(cfg), _make_seq(), parity_scores)
    assert kernel.launches - n0 == 5
    assert len(res.agree) == 5 and min(res.agree) >= 0.999, res.agree
    assert res.max_dlogit < 1e-2 and res.max_demb < 1e-3
    assert len(res.banks_equal) == 3 and all(res.banks_equal)
