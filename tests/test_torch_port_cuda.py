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
from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.data import SyntheticEval
from rvos_tpu_torch.engine import Evaluator
from rvos_tpu_torch.models import AOCNet
from rvos_tpu_torch.ops.matching import compact_reference_bank_occupancy
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


def _scores(frame_idx, n_obj, n_rows):
    g = torch.Generator().manual_seed(frame_idx)
    return 0.5 + 0.5 * torch.rand((n_obj, n_rows), generator=g)


def test_evaluator_on_card_matches_cpu(dev):
    """The whole slice in parity mode: kernels on the card vs the plain
    versions on the CPU, same random weights and k-means draws."""
    cfg = tiny_test(DATA_RANDOMCROP=(65, 65), MODEL_MULTI_LOCAL_DISTANCE=(2, 4),
                    MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None,
                    TEST_BANK_CAPACITY=3, MEM_EVERY=2,
                    EVAL_COMPUTE_DTYPE="float32")
    out = {}
    for d in ("cpu", "cuda"):
        model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
        ev = Evaluator(cfg, model, device=d, kmeans_scores=_scores)
        seq = SyntheticEval(size=(65, 65), n_seqs=1, n_frames=6)[0]
        out[d] = ev.evaluate_sequence(seq)["results"]
    assert sorted(out["cpu"]) == sorted(out["cuda"])
    for name, mask in out["cpu"].items():
        assert (out["cuda"][name] == mask).mean() >= 0.999, name
