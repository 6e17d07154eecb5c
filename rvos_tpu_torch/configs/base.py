"""Experiment configuration (the PyTorch port's own copy).

Field for field the same dataclass as ``rvos_tpu/configs/base.py``, so
one command line drives both packages; the port keeps a copy instead of
importing the JAX package.  The USE_PALLAS* fields are read only by the
JAX package.

A pure dataclass replacement for the reference's import-time mutable
singleton (``configs/resnet101_aocnet.py:11-152``): no side effects, no
CUDA assertions, no mkdir at import.  Field names mirror the reference's
UPPERCASE attributes so a user of the reference finds every knob; TPU-
specific additions are grouped at the bottom.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class Config:
    EXP_NAME: str = "aoc_stage_1"

    # ---- evaluator / RPA memory (reference configs/resnet101_aocnet.py:15-21)
    EVAL_AUTO_RESUME: bool = False  # schema-parity only: dead in the
    #   reference too (declared configs/resnet101_aocnet.py, never read)
    UNC_RATIO: float = 1.0          # Shannon-entropy gate for confident masks
    MEM_EVERY: int = 5              # append to memory bank every N frames (-1: off)
    PAST_FRAME_NUM: int = 4
    BLOCK_NUM: int = 2              # decoder feature-memory slots

    # ---- directories (reference :23-40); all overridable, no import side effects
    DIR_ROOT: str = "./workdir"
    DIR_DATA: str = "./datasets"
    DIR_DAVIS: str = ""
    DIR_YTB: str = ""
    DIR_YTB_EVAL: str = ""
    DIR_YTB_EVAL18: str = ""
    DIR_YTB_EVAL19: str = ""
    DIR_RESULT: str = ""

    # ---- data (reference :42-54)
    DATASETS: Sequence[str] = ("youtubevos",)
    DATA_WORKERS: int = 4
    DATA_RANDOMCROP: Tuple[int, int] = (465, 465)
    DATA_RANDOMFLIP: float = 0.5
    DATA_MAX_CROP_STEPS: int = 5
    DATA_MIN_SCALE_FACTOR: float = 1.0
    DATA_MAX_SCALE_FACTOR: float = 1.3
    DATA_SHORT_EDGE_LEN: int = 480
    DATA_RANDOM_REVERSE_SEQ: bool = True
    DATA_DAVIS_REPEAT: int = 30
    DATA_CURR_SEQ_LEN: int = 5
    DATA_RANDOM_GAP_DAVIS: int = 3
    DATA_RANDOM_GAP_YTB: int = 3
    DATA_MAX_OBJ_NUM: int = 5       # BalancedRandomCrop cap (custom_transforms.py:67)
    DATA_MIN_OBJ_PIXEL_NUM: int = 100

    # ---- pretrain / model (reference :57-80)
    PRETRAIN: bool = False
    PRETRAIN_FULL: bool = False
    PRETRAIN_MODEL: str = ""
    MODEL_BACKBONE: str = "resnet"
    MODEL_OUTPUT_STRIDE: int = 16
    MODEL_ASPP_OUTDIM: int = 256
    MODEL_SHORTCUT_DIM: int = 48
    MODEL_SEMANTIC_EMBEDDING_DIM: int = 100
    MODEL_HEAD_EMBEDDING_DIM: int = 256
    MODEL_PRE_HEAD_EMBEDDING_DIM: int = 64
    MODEL_GN_GROUPS: int = 32
    MODEL_GN_EMB_GROUPS: int = 25
    MODEL_MULTI_LOCAL_DISTANCE: Sequence[int] = (2, 4, 6, 8, 10, 12)
    MODEL_LOCAL_DOWNSAMPLE: bool = True
    MODEL_REFINE_CHANNELS: int = 64
    MODEL_LOW_LEVEL_INPLANES: int = 256
    MODEL_EPSILON: float = 1e-5
    MODEL_ASPP_DROPOUT: float = 0.1        # backbone-ASPP dropout (aspp.py:58)
    MODEL_MATCHING_BACKGROUND: bool = True
    MODEL_GCT_BETA_WD: bool = True
    MODEL_FLOAT16_MATCHING: bool = False   # live alias: True forces bfloat16
    #   matching (see Config.matching_dtype; TPU analogue of the
    #   reference's fp16 matching switch)
    MODEL_FREEZE_BN: bool = True
    MODEL_FREEZE_BACKBONE: bool = False
    MODEL_CLUSTER_NUM: int = 16            # AOP k-means k (matching.py:232)
    MODEL_KMEANS_ITERS: int = 20           # kmeans2 iter=20 (matching.py:276)
    MODEL_BETA_PERCENTAGE: float = 0.3     # conditioning saliency top-beta

    # ---- training (reference :82-110)
    TRAIN_TOTAL_STEPS: int = 50_000
    TRAIN_START_STEP: int = 0
    TRAIN_LR: float = 0.01
    TRAIN_MOMENTUM: float = 0.9
    TRAIN_COSINE_DECAY: bool = False
    TRAIN_WARM_UP_STEPS: int = 1000
    TRAIN_WEIGHT_DECAY: float = 15e-5
    TRAIN_POWER: float = 0.9
    TRAIN_GPUS: int = 8                    # kept for CLI parity; see TPU mesh below
    TRAIN_BATCH_SIZE: int = 8
    TRAIN_START_SEQ_TRAINING_STEPS: int = 25_000
    TRAIN_TBLOG: bool = False
    TRAIN_LOG_STEP: int = 20
    TRAIN_IMG_LOG: bool = False
    TRAIN_TOP_K_PERCENT_PIXELS: float = 0.15
    TRAIN_HARD_MINING_STEP: int = 25_000
    TRAIN_CLIP_GRAD_NORM: float = 5.0
    TRAIN_SKIP_NONFINITE: bool = True  # skip optimizer updates on inf/nan
    #   grads (GradScaler-skip analogue; clip-by-norm alone propagates a
    #   nonfinite norm into every param)
    TRAIN_SAVE_STEP: int = 2000
    TRAIN_MAX_KEEP_CKPT: int = 8
    TRAIN_RESUME: bool = False
    TRAIN_RESUME_CKPT: Optional[str] = None
    TRAIN_RESUME_STEP: int = 0
    TRAIN_AUTO_RESUME: bool = True
    TRAIN_GLOBAL_ATROUS_RATE: int = 1
    TRAIN_LOCAL_ATROUS_RATE: int = 1
    TRAIN_GLOBAL_CHUNKS: int = 1           # kept for parity; TPU kernels tile internally
    TRAIN_DATASET_FULL_RESOLUTION: bool = True

    # ---- test (reference :113-127)
    TEST_DATASET: str = "youtubevos"
    TEST_DATASET_FULL_RESOLUTION: bool = False
    TEST_DATASET_SPLIT: Sequence[str] = ("val",)
    TEST_CKPT_PATH: Optional[str] = None
    TEST_CKPT_STEP: Optional[int] = None
    TEST_FLIP: bool = False
    TEST_MULTISCALE: Sequence[float] = (1.0,)
    TEST_MIN_SIZE: Optional[int] = None
    TEST_MAX_SIZE: float = 800 * 1.3
    TEST_WORKERS: int = 2                  # eval prefetch threads (JAX package only)
    TEST_GLOBAL_CHUNKS: int = 4            # parity only
    TEST_GLOBAL_ATROUS_RATE: int = 1
    TEST_LOCAL_ATROUS_RATE: int = 1

    # ---- TPU-native additions -------------------------------------------
    MODEL_MAX_OBJ_NUM: int = 11            # static object axis (incl. background)
    TRAIN_SEQ_GRADIENT: str = "carry"      # "carry" | "detach" prev-embedding grad
    TRAIN_REMAT: bool = True               # remat the rollout body (trade FLOPs for HBM)
    TRAIN_COMPUTE_DTYPE: str = "float32"   # "bfloat16": mixed-precision forward (f32 params/grads)
    TEST_BANK_CAPACITY: int = 8            # fixed-capacity RPA bank (first frame pinned)
    MATCHING_DTYPE: str = "mixed"          # "float32" (exact) | "mixed" (bf16 cross, f32 norms) | "bfloat16"
    MATCHING_MAX_REF_PIXELS: int = 16384   # fg-union bank compaction cap (0 = off)
    USE_PALLAS: bool = True                # fused Pallas kernels on TPU backends
    USE_PALLAS_LOCAL: bool = False         # local-matching kernel (XLA scan is on par)
    MATCHING_SEGMENTED_BANK: bool = True   # label-segmented eval bank layout
    #   (per-object tile-aligned quotas -> label-pure reference tiles; the
    #   segmented Pallas kernel then needs one min per tile instead of O)
    MATCHING_OCCUPANCY_BANK: bool = True   # occupancy-proportional segment
    #   sizes (tile->object map as data): a dominant object keeps up to the
    #   whole bank instead of the uniform layout's max_pixels/O cap
    EVAL_COMPUTE_DTYPE: str = "bfloat16"   # eval-time model compute ("float32" for parity)
    TEST_FUSED_POSTPROCESS: bool = True    # on-device argmax/entropy fast path (False: host path)
    # The next four are read only by the JAX package's pipelined and
    # ensemble evaluator; the port runs frame by frame, single scale.
    TEST_H2D_GROUP: int = 1                # frames per eval H2D upload
    TEST_FRAME_CHUNK: int = 5              # frames per dispatch (lax.scan chunk)
    TEST_D2H_GROUP: int = 8                # predicted masks per D2H download
    TEST_ENSEMBLE_SHARD: bool = True       # multi-scale/flip ensemble across devices
    MESH_MODEL_AXIS: int = 1               # context-parallel matching shards (query rows)
    MESH_DATA_AXIS: int = 8                # data-parallel mesh size for training
    CHECKPOINT_DIR: str = ""

    # derived ------------------------------------------------------------
    @property
    def prehead_in_dim(self) -> int:
        """Matching-map channel count fed to DynamicPreHead.

        Reference arithmetic at ``networks/aoc/aocnet.py:43-46``:
        2*(2+len(local)) - 1 + 2  (+1+len(local) with background matching).
        """
        n_local = len(self.MODEL_MULTI_LOCAL_DISTANCE)
        dim = 2 * (2 + n_local) - 1 + 2
        if self.MODEL_MATCHING_BACKGROUND:
            dim += 1 + n_local
        return dim

    @property
    def attention_head_dim(self) -> int:
        return self.MODEL_SEMANTIC_EMBEDDING_DIM * 4

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def matching_dtype(self) -> str:
        """Resolved matching precision. ``MODEL_FLOAT16_MATCHING`` (the
        reference's fp16-matching switch, matching.py:2331) is a live
        alias: its TPU analogue is full-bfloat16 matching, overriding
        ``MATCHING_DTYPE``."""
        if self.MODEL_FLOAT16_MATCHING:
            return "bfloat16"
        return self.MATCHING_DTYPE

    def result_dirs(self) -> dict:
        root = self.DIR_RESULT or os.path.join(self.DIR_ROOT, "result", self.EXP_NAME)
        return {
            "result": root,
            "ckpt": self.CHECKPOINT_DIR or os.path.join(root, "ckpt"),
            "log": os.path.join(root, "log"),
            "eval": os.path.join(root, "eval"),
        }
