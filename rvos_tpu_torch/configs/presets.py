"""Config presets mirroring the reference's two released configs plus
CPU-runnable test presets.

Reference: ``configs/resnet101_aocnet.py`` (stage 1, 50k steps) and
``configs/resnet101_aocnet_2.py`` (stage 2, 400k steps, backbone-partial
pretrain, 480p test).
"""

from .base import Config


def resnet101_aocnet() -> Config:
    # stage 1 warm-starts from a full CFBI VOS checkpoint when one is
    # provided (reference configs/resnet101_aocnet.py:57-59; the path is
    # machine-specific there, so it is supplied via --pretrained_path)
    return Config(EXP_NAME="aoc_stage_1", PRETRAIN=True, PRETRAIN_FULL=True)


def resnet101_aocnet_2() -> Config:
    # PRETRAIN_FULL=False: a torch PRETRAIN_MODEL is interpreted as
    # backbone-only (resnet101-deeplabv3p, ref _2.py:56-58); an orbax
    # path (stage-1 chaining, scripts/train.sh) restores the full model
    return Config(
        EXP_NAME="aoc_stage_2",
        TRAIN_TOTAL_STEPS=400_000,
        TRAIN_START_SEQ_TRAINING_STEPS=200_000,
        TRAIN_HARD_MINING_STEP=200_000,
        PRETRAIN=True,
        PRETRAIN_FULL=False,
        TEST_DATASET_FULL_RESOLUTION=False,
    )


def tiny_test(**kw) -> Config:
    """A CPU-runnable config with small shapes for tests/smoke runs."""
    base = dict(
        EXP_NAME="tiny",
        DATA_RANDOMCROP=(65, 65),
        DATA_CURR_SEQ_LEN=2,
        MODEL_SEMANTIC_EMBEDDING_DIM=100,
        MODEL_MAX_OBJ_NUM=4,
        MODEL_CLUSTER_NUM=4,
        MODEL_KMEANS_ITERS=4,
        TEST_BANK_CAPACITY=3,
        TRAIN_TOTAL_STEPS=4,
        TRAIN_WARM_UP_STEPS=1,
        TRAIN_BATCH_SIZE=1,
        MESH_DATA_AXIS=1,
        USE_PALLAS=False,
        MATCHING_DTYPE="float32",
    )
    base.update(kw)
    return Config(**base)


PRESETS = {
    "resnet101_aocnet": resnet101_aocnet,
    "resnet101_aocnet_2": resnet101_aocnet_2,
    "tiny_test": tiny_test,
}


def get_config(name: str, **kw) -> Config:
    cfg = PRESETS[name]()
    if kw:
        cfg = cfg.replace(**kw)
    return cfg
