"""The kernels' bounds, pinned to the bring-up smoke's phase 2 table
(PERF.md: B.1 0.0854 ms at M = 25,773, P = 16,384, C = 100; MF's 0.1288
ms at M = 38,889; B.4 0.00228 ms by bytes on the 61×107 grid)."""

import pytest
import torch

from benchmark.counts import kernels
from benchmark.counts.flops import dense_flops, matching_flops


def test_seg_map_bound():
    s, by = kernels.seg_map(25_773, 16_384, 100, 11)
    assert by == "operations"
    assert s * 1e3 == pytest.approx(0.0854, abs=5e-5)


def test_seg_map_bound_multiscale():
    s, _ = kernels.seg_map(38_889, 16_384, 100, 11)
    assert s * 1e3 == pytest.approx(0.1288, abs=5e-5)


def test_local_match_bound_by_bytes():
    s, by = kernels.local_match(61, 107, 100, 11, (2, 4, 6, 8, 10, 12))
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(0.00228, abs=5e-6)


def test_window_pairs_counts_in_frame_offsets():
    assert kernels.window_pairs(1, 1, 2) == 1
    assert kernels.window_pairs(3, 3, 1) == 9 + 2 * 6 + 2 * 6 + 4 * 4


def test_model_flops_scale_with_pixels():
    from rvos_tpu_torch.configs import get_config
    from rvos_tpu_torch.models import AOCNet
    cfg = get_config("resnet101_aocnet")
    shapes = {n: t.shape for n, t in AOCNet(cfg).state_dict().items()}
    conf = {"MODEL_MAX_OBJ_NUM": 11, "MODEL_BETA_PERCENTAGE": 0.3}
    small = dense_flops(shapes, conf, "resnet", (241, 425))
    big = dense_flops(shapes, conf, "resnet", (481, 849))
    assert big["grid"] == (121, 213)
    assert 3.5 < big["extract"] / small["extract"] < 4.5
    # ResNet-101 DeepLabv3+ at 481×849: some hundred GFLOP a frame
    assert 1e11 < big["extract"] < 6e11
    conf.update(MODEL_CLUSTER_NUM=16, MODEL_KMEANS_ITERS=20,
                MODEL_MULTI_LOCAL_DISTANCE=[2, 4, 6, 8, 10, 12])
    m = matching_flops(conf, (121, 213), 100, 16_384)
    assert m > 2.0 * 25_773 * 16_384 * 100
