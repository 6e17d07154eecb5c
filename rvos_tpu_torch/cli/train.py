"""Training CLI of the PyTorch port — the flags of
``rvos_tpu/cli/train.py``, plus ``--device`` and ``--seed``.

    python -m rvos_tpu_torch.cli.train --config tiny_test --synthetic \
        --total_step 2 --device cpu
    python -m rvos_tpu_torch.cli.train --datasets davis2017 \
        --davis_root DAVIS --pretrained_path cfbi.pth --batch_size 2

Runs on one CUDA card unless ``--device cpu``.  Results go to
``DIR_ROOT/result/<exp_name>`` (``workdir/`` by default): the metrics
log and ``ckpt/save_step_<N>.pth``; a run resumes from the newest
checkpoint there, so a finished run starts over only under a new
``--exp_name``.  Without ``--pretrained_path`` the weights are random,
made from ``--seed``.  ``--global_chunks`` is accepted and does nothing,
as in the JAX CLI.  Not ported, and refused: ``--gpu_num`` above 1
(ROADMAP Queue A item 8) and ``--float16`` (bfloat16 training, item 7e).
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Train AOC-Net (PyTorch port)")
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--config", type=str, default="resnet101_aocnet")
    p.add_argument("--gpu_num", type=int, default=-1,
                   help="devices (only 1 is ported)")
    p.add_argument("--batch_size", type=int, default=-1)
    p.add_argument("--pretrained_path", type=str, default="")
    p.add_argument("--datasets", nargs="+", type=str, default=["youtubevos"])
    p.add_argument("--lr", type=float, default=-1.0)
    p.add_argument("--total_step", type=int, default=-1)
    p.add_argument("--start_step", type=int, default=-1)
    p.add_argument("--float16", action="store_true",
                   help="bfloat16 matching (not ported: raises)")
    p.add_argument("--global_atrous_rate", type=int, default=1)
    p.add_argument("--global_chunks", type=int, default=20,
                   help="accepted for reference-CLI parity; a no-op")
    p.add_argument("--davis_root", type=str, default="")
    p.add_argument("--ytb_root", type=str, default="")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic smoke dataset")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and the dropout")
    return p


def apply_args(cfg, args):
    """The JAX CLI's config overrides, field for field."""
    if args.exp_name:
        cfg = cfg.replace(EXP_NAME=args.exp_name)
    if args.gpu_num > 0:
        cfg = cfg.replace(TRAIN_GPUS=args.gpu_num, MESH_DATA_AXIS=args.gpu_num)
    if args.batch_size > 0:
        cfg = cfg.replace(TRAIN_BATCH_SIZE=args.batch_size)
    if args.pretrained_path:
        cfg = cfg.replace(PRETRAIN_MODEL=args.pretrained_path, PRETRAIN=True)
    if args.lr > 0:
        cfg = cfg.replace(TRAIN_LR=args.lr)
    if args.total_step > 0:
        cfg = cfg.replace(
            TRAIN_TOTAL_STEPS=args.total_step,
            TRAIN_START_SEQ_TRAINING_STEPS=args.total_step // 2,
            TRAIN_HARD_MINING_STEP=args.total_step // 2)
    if args.start_step > 0:
        cfg = cfg.replace(TRAIN_START_STEP=args.start_step)
    cfg = cfg.replace(
        MATCHING_DTYPE="bfloat16" if args.float16 else "float32",
        TRAIN_GLOBAL_ATROUS_RATE=args.global_atrous_rate,
        TRAIN_GLOBAL_CHUNKS=args.global_chunks,
        DATASETS=tuple(args.datasets),
    )
    if args.davis_root:
        cfg = cfg.replace(DIR_DAVIS=args.davis_root)
    if args.ytb_root:
        cfg = cfg.replace(DIR_YTB=args.ytb_root)
    return cfg


def train_transform(cfg, synthetic: bool):
    """The per-item transform ``(sample, rng)``: synthetic float frames
    are normalised on the host; real uint8 frames are scaled, cropped
    and flipped and stay uint8 (the step normalises them)."""
    from ..data.transforms import (balanced_random_crop, normalize,
                                   random_hflip, random_scale)

    def transform(sample, rng):
        if synthetic:
            out = dict(sample)
            out["ref_img"] = normalize(sample["ref_img"])
            out["prev_img"] = normalize(sample["prev_img"])
            out["curr_img"] = [normalize(x) for x in sample["curr_img"]]
            return out
        sample = random_scale(sample, cfg.DATA_SHORT_EDGE_LEN,
                              cfg.DATA_MIN_SCALE_FACTOR,
                              cfg.DATA_MAX_SCALE_FACTOR, rng)
        sample = balanced_random_crop(
            sample, cfg.DATA_RANDOMCROP, rng, cfg.DATA_MAX_CROP_STEPS,
            cfg.DATA_MAX_OBJ_NUM, cfg.DATA_MIN_OBJ_PIXEL_NUM)
        return dict(random_hflip(sample, cfg.DATA_RANDOMFLIP, rng))

    return transform


class _Concat:
    def __init__(self, parts):
        self.parts = parts
        self.lens = [len(p) for p in parts]

    def __len__(self):
        return sum(self.lens)

    def __getitem__(self, i):
        for p, n in zip(self.parts, self.lens):
            if i < n:
                return p[i]
            i -= n
        raise IndexError(i)


def build_dataset(cfg, synthetic: bool):
    import numpy as np

    from ..data.datasets import DAVISTrain, SyntheticTrain, YTBVOSTrain
    if synthetic:
        return _Concat([SyntheticTrain(size=cfg.DATA_RANDOMCROP,
                                       curr_len=cfg.DATA_CURR_SEQ_LEN)])
    parts = []
    for name in cfg.DATASETS:
        if name == "davis2017":
            parts.append(DAVISTrain(
                cfg.DIR_DAVIS, image_dtype=np.uint8,
                full_resolution=cfg.TRAIN_DATASET_FULL_RESOLUTION,
                repeat_time=cfg.DATA_DAVIS_REPEAT,
                rand_gap=cfg.DATA_RANDOM_GAP_DAVIS,
                curr_len=cfg.DATA_CURR_SEQ_LEN,
                rand_reverse=cfg.DATA_RANDOM_REVERSE_SEQ))
        elif name == "youtubevos":
            parts.append(YTBVOSTrain(
                cfg.DIR_YTB, image_dtype=np.uint8,
                rand_gap=cfg.DATA_RANDOM_GAP_YTB,
                curr_len=cfg.DATA_CURR_SEQ_LEN,
                rand_reverse=cfg.DATA_RANDOM_REVERSE_SEQ))
        else:
            raise ValueError(f"unknown dataset {name}")
    return _Concat(parts)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.gpu_num > 1:
        raise NotImplementedError(
            f"--gpu_num {args.gpu_num}: multi-GPU training is ROADMAP "
            "Queue A item 8")

    from ..configs import get_config
    from ..data.loader import TrainBatcher
    from ..engine.train import Trainer

    cfg = apply_args(get_config(args.config), args)
    trainer = Trainer(cfg, device=args.device, seed=args.seed)
    batcher = TrainBatcher(build_dataset(cfg, args.synthetic),
                           cfg.TRAIN_BATCH_SIZE,
                           train_transform(cfg, args.synthetic),
                           num_workers=cfg.DATA_WORKERS)
    trainer.fit(batcher, log_every=cfg.TRAIN_LOG_STEP,
                save_every=cfg.TRAIN_SAVE_STEP,
                ckpt_dir=cfg.result_dirs()["ckpt"])


if __name__ == "__main__":
    main()
