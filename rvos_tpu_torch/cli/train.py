"""Training CLI of the PyTorch port — the flags of
``rvos_tpu/cli/train.py``, plus ``--device`` and ``--seed``.

    python -m rvos_tpu_torch.cli.train --config tiny_test --synthetic \
        --total_step 2 --device cpu
    python -m rvos_tpu_torch.cli.train --datasets davis2017 \
        --davis_root DAVIS --pretrained_path cfbi.pth --batch_size 2

Runs on one CUDA card unless ``--device cpu``.  ``--gpu_num N`` (N > 1)
trains data-parallel: ``min(N, visible cards)`` processes, one per card,
spawned over a local TCP rendezvous (``parallel.launch``, NCCL), or N
gloo processes under ``--device cpu``; with ``MESH_MODEL_AXIS = m > 1``
and at least m cards, each process takes m cards and splits its
matching rows over them (``min(N, cards // m)`` processes).
``--batch_size`` is the global batch, divided evenly among them.  Under
``RVOS_MULTIHOST=1`` the process joins a run launched outside instead
(``parallel.distributed.maybe_initialize``: ``RVOS_COORDINATOR``,
``RVOS_NUM_PROCESSES``, ``RVOS_PROCESS_ID``, ``RVOS_LOCAL_DEVICE_IDS``).
Rank 0 alone prints and writes.  Results go to
``DIR_ROOT/result/<exp_name>`` (``workdir/`` by default): the metrics
log and ``ckpt/save_step_<N>.pth``; a run resumes from the newest
checkpoint there, so a finished run starts over only under a new
``--exp_name``.  Without ``--pretrained_path`` the weights are random,
made from ``--seed``.  ``--float16`` trains with bfloat16 matching
operands, as the JAX CLI (``MATCHING_DTYPE="bfloat16"``); a preset with
``TRAIN_COMPUTE_DTYPE="bfloat16"`` runs the forward in bf16.
``--global_chunks`` is accepted and does nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Train AOC-Net (PyTorch port)")
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--config", type=str, default="resnet101_aocnet")
    p.add_argument("--gpu_num", type=int, default=-1,
                   help="data-parallel processes (one per card)")
    p.add_argument("--batch_size", type=int, default=-1)
    p.add_argument("--pretrained_path", type=str, default="")
    p.add_argument("--datasets", nargs="+", type=str, default=["youtubevos"])
    p.add_argument("--lr", type=float, default=-1.0)
    p.add_argument("--total_step", type=int, default=-1)
    p.add_argument("--start_step", type=int, default=-1)
    p.add_argument("--float16", action="store_true",
                   help="bfloat16 matching")
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


def train(args, device, devices=None) -> None:
    """One process's run: the trainer on ``device`` (context-parallel
    over ``devices``), its slices of the global batches."""
    from ..configs import get_config
    from ..data.loader import TrainBatcher
    from ..engine.train import Trainer
    from ..parallel import distributed

    cfg = apply_args(get_config(args.config), args)
    trainer = Trainer(cfg, device=device, seed=args.seed, devices=devices)
    batcher = TrainBatcher(build_dataset(cfg, args.synthetic),
                           cfg.TRAIN_BATCH_SIZE,
                           train_transform(cfg, args.synthetic),
                           num_workers=cfg.DATA_WORKERS,
                           process_index=distributed.rank(),
                           process_count=distributed.world_size())
    trainer.fit(batcher, log_every=cfg.TRAIN_LOG_STEP,
                save_every=cfg.TRAIN_SAVE_STEP,
                ckpt_dir=cfg.result_dirs()["ckpt"])


def _rank_main(rank: int, world: int, device, argv, rows) -> None:
    """A spawned rank of ``--gpu_num``."""
    train(build_parser().parse_args(argv), device, rows[rank])


def process_rows(cfg, gpu_num: int, device: str):
    """The devices of each process of a ``--gpu_num`` run: one card each,
    or ``MESH_MODEL_AXIS`` cards each when there are that many."""
    import torch

    from ..parallel.mesh import cp_mesh, local_devices
    if torch.device(device).type == "cpu":
        return [["cpu"]] * gpu_num
    cards = local_devices(device)
    mesh = cp_mesh(cfg.replace(MESH_DATA_AXIS=gpu_num), cards)
    if mesh is None:
        mesh = [[d] for d in cards[:gpu_num]]
    return [[str(d) for d in row] for row in mesh]


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    from ..configs import get_config
    from ..parallel import distributed
    from ..parallel.launch import launch

    if distributed.maybe_initialize(device=args.device):
        devices = distributed.process_devices(device=args.device)
        train(args, devices[0], devices)
        return
    if args.gpu_num > 1:
        from ..device import resolve_device
        resolve_device(args.device)
        cfg = apply_args(get_config(args.config), args)
        rows = process_rows(cfg, args.gpu_num, args.device)
        cpu = rows[0][0] == "cpu"
        launch(_rank_main, len(rows), "gloo" if cpu else "nccl",
               [row[0] for row in rows], args=(argv, rows),
               timeout=None, threads=2 if cpu else 8)
        return
    train(args, args.device)


if __name__ == "__main__":
    main()
