"""A tiny eval cell for the CPU tests: the port's ``tiny_test`` preset
(float32, 4 object channels, a 3-slot bank) on 64×96 videos, with the
limits of a cell of ``BENCHMARK.json``."""

from __future__ import annotations

from types import SimpleNamespace

REF_KEYS = ("MODEL_MAX_OBJ_NUM", "TEST_BANK_CAPACITY", "MODEL_CLUSTER_NUM",
            "MODEL_KMEANS_ITERS", "MODEL_EPSILON",
            "MODEL_MULTI_LOCAL_DISTANCE", "MODEL_MATCHING_BACKGROUND",
            "MODEL_PRE_HEAD_EMBEDDING_DIM", "MODEL_BETA_PERCENTAGE",
            "UNC_RATIO", "MEM_EVERY")

VIDEOS = [[12, 2, [0, 0]], [9, 3, [0, 4, 0]], [7, 1, [0]]]


def tiny_cell(backbone: str = "resnet", limits_of: str = "r101.davis",
              videos=VIDEOS, check_videos: int = 2):
    from rvos_tpu_torch.configs import get_config

    from benchmark.harness.manifest import Cell
    fields = {"MATCHING_MAX_REF_PIXELS": 2048, "EVAL_COMPUTE_DTYPE": "float32",
              "TEST_MAX_SIZE": 1040.0, "MODEL_BACKBONE": backbone}
    cfg = get_config("tiny_test", **fields)
    for k in REF_KEYS:
        v = getattr(cfg, k)
        fields[k] = list(v) if isinstance(v, tuple) else v
    return SimpleNamespace(
        name="tiny", chips=1,
        config={"preset": "tiny_test", "config": fields},
        mix={"driver": "eval_videos", "frame_hw": [64, 96],
             "videos": videos, "check_videos": check_videos},
        limits=Cell(limits_of).limits)


def passes(check: dict, limits: dict) -> bool:
    return all(check[k] <= lim for k, lim in limits.items())
