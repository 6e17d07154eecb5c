"""Evaluation CLI of the PyTorch port — the flags of
``rvos_tpu/cli/eval.py``, plus ``--device``, ``--seed``,
``--frame_chunk`` and ``--d2h_group``.

    python -m rvos_tpu_torch.cli.eval --dataset davis2017 \
        --davis_root DAVIS --ckpt_path aoc.pth --perturb 3 --jf
    python -m rvos_tpu_torch.cli.eval --dataset youtubevos \
        --ytb_root YTB/valid --ckpt_path aoc.pth --all_labels
    python -m rvos_tpu_torch.cli.eval --synthetic --device cpu
    python -m rvos_tpu_torch.cli.eval --synthetic --ckpt_path aoc.pth \
        --min_matching_pixels 0 --shard_id 1 --shard_num 2

Runs on CUDA unless ``--device cpu``.  ``--global_chunks`` is accepted
and does nothing, as in the JAX CLI.  ``--ckpt_path`` loads a reference
``.pth``; without it the weights are random, made from ``--seed``.
``--dataset davis2016|davis2017`` reads a DAVIS tree (``--davis_root``),
any other name a YouTube-VOS one (``--ytb_root``; its first annotations
are copied into the result tree); ``--perturb 1-9`` applies a
Robust-VOS perturbation to every frame (random draws from ``--seed``);
``--all_labels`` masks channels by every frame's ground truth;
``--jf`` scores the written masks against the annotations (DAVIS J&F,
with the per-sequence and global CSVs).  The masks are zipped for the
benchmark servers.  ``--shard_id/--shard_num`` evaluate a round-robin
share of the sequences; under ``RVOS_MULTIHOST=1`` each process joins
the run (``parallel.distributed.maybe_initialize``) and, when they are
left at their defaults, takes its rank and the world size as them, on
its own cards (``RVOS_LOCAL_DEVICE_IDS``, else card ``rank % count``).
On a host with several cards the ensemble shards its variants over them
(``TEST_ENSEMBLE_SHARD``), and ``MESH_MODEL_AXIS > 1`` splits the
matching rows over that many cards.  ``--flip`` and ``--ms`` run the multi-scale +
flip ensemble (``--ms 1.0 1.15 1.3 --flip`` is the reference's MF
setting; the long edge is then capped at 800 before scaling).
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="Eval AOC-Net (PyTorch port, RPA) "
                                "or AOT (--config aotl_mobilenetv2)")
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--config", type=str, default="resnet101_aocnet")
    p.add_argument("--ckpt_path", type=str, default="",
                   help="reference .pth/.pth.tar checkpoint (random weights "
                        "from --seed when empty)")
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--flip", action="store_true")
    p.add_argument("--ms", nargs="+", type=float, default=[1.0])
    p.add_argument("--mem_every", type=int, default=-1)
    p.add_argument("--ucr", type=float, default=1.0)
    p.add_argument("--float16", action="store_true",
                   help="alias for --matching_dtype bfloat16")
    p.add_argument("--matching_dtype", type=str, default="",
                   choices=["", "mixed", "float32", "bfloat16"])
    p.add_argument("--eval_dtype", type=str, default="",
                   choices=["", "bfloat16", "float32"])
    p.add_argument("--parity", action="store_true",
                   help="full-f32 numerics (matching + compute)")
    p.add_argument("--all_labels", action="store_true",
                   help="label-aware eval: per-frame ground truth masks "
                        "channels, never spliced")
    p.add_argument("--jf", action="store_true",
                   help="compute DAVIS J&F against the annotations")
    p.add_argument("--global_atrous_rate", type=int, default=1)
    p.add_argument("--global_chunks", type=int, default=4,
                   help="accepted for reference-CLI parity; a no-op")
    p.add_argument("--min_matching_pixels", type=int, default=-1,
                   help="sets MATCHING_MAX_REF_PIXELS (0 disables the cap, "
                        "-1 keeps the preset)")
    p.add_argument("--max_long_edge", type=int, default=-1)
    p.add_argument("--perturb", type=int, default=0,
                   help="Robust-VOS-Benchmark image_type (0-9)")
    p.add_argument("--davis_root", type=str, default="")
    p.add_argument("--ytb_root", type=str, default="")
    p.add_argument("--frame_chunk", type=int, default=-1,
                   help="sets TEST_FRAME_CHUNK (frames per CUDA graph "
                        "replay; -1 keeps the preset)")
    p.add_argument("--d2h_group", type=int, default=-1,
                   help="sets TEST_D2H_GROUP (-1 keeps the preset)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and the perturbation")
    p.add_argument("--shard_id", type=int, default=0,
                   help="evaluate sequences i with i %% shard_num == "
                        "shard_id (all shards share --out)")
    p.add_argument("--shard_num", type=int, default=1)
    return p


def apply_args(cfg, args):
    if args.exp_name:
        cfg = cfg.replace(EXP_NAME=args.exp_name)
    if args.dataset:
        cfg = cfg.replace(TEST_DATASET=args.dataset)
    if args.mem_every != -1:
        cfg = cfg.replace(MEM_EVERY=args.mem_every)
    cfg = cfg.replace(UNC_RATIO=args.ucr, TEST_FLIP=args.flip,
                      TEST_MULTISCALE=tuple(args.ms),
                      TEST_GLOBAL_ATROUS_RATE=args.global_atrous_rate,
                      TEST_GLOBAL_CHUNKS=args.global_chunks)
    if args.parity:
        cfg = cfg.replace(MATCHING_DTYPE="float32", EVAL_COMPUTE_DTYPE="float32")
    if args.float16:
        cfg = cfg.replace(MATCHING_DTYPE="bfloat16")
    if args.matching_dtype:
        cfg = cfg.replace(MATCHING_DTYPE=args.matching_dtype)
    if args.eval_dtype:
        cfg = cfg.replace(EVAL_COMPUTE_DTYPE=args.eval_dtype)
    if args.min_matching_pixels >= 0:
        cfg = cfg.replace(MATCHING_MAX_REF_PIXELS=args.min_matching_pixels)
    if args.max_long_edge > 0:
        cfg = cfg.replace(TEST_MAX_SIZE=float(args.max_long_edge))
    else:
        cfg = cfg.replace(TEST_MAX_SIZE=800 * 1.3
                          if tuple(args.ms) == (1.0,) else 800.0)
    if args.frame_chunk > 0:
        cfg = cfg.replace(TEST_FRAME_CHUNK=args.frame_chunk)
    if args.d2h_group > 0:
        cfg = cfg.replace(TEST_D2H_GROUP=args.d2h_group)
    return cfg


class _ShardView:
    """Round-robin sequence shard of an eval dataset."""

    def __init__(self, ds, shard_id: int, shard_num: int):
        self.ds = ds
        self.idx = list(range(shard_id, len(ds), shard_num))

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]


def _dataset(cfg, args, out_root):
    """The eval dataset the flags name, and its annotation root."""
    import numpy as np

    from ..data import DAVISTest, SyntheticEval, YTBVOSTest, get_perturbation
    transform = None
    if args.perturb:
        transform = get_perturbation(args.perturb,
                                     np.random.default_rng(args.seed))
    if args.synthetic:
        return SyntheticEval(size=(129, 129), frame_transform=transform), None
    if cfg.TEST_DATASET.startswith("davis"):
        year = 2016 if cfg.TEST_DATASET == "davis2016" else 2017
        ds = DAVISTest(args.davis_root or cfg.DIR_DAVIS,
                       split=cfg.TEST_DATASET_SPLIT, year=year,
                       full_resolution=cfg.TEST_DATASET_FULL_RESOLUTION,
                       frame_transform=transform, all_labels=args.all_labels)
    else:
        ds = YTBVOSTest(args.ytb_root or cfg.DIR_YTB_EVAL,
                        use_all=cfg.TEST_DATASET == "youtubevos",
                        frame_transform=transform, result_root=out_root,
                        all_labels=args.all_labels)
    return ds, ds.label_root


def _write_jf(out_root: str, label_root: str) -> None:
    """J&F of the written masks, printed and written as the DAVIS
    toolkit's per-sequence and global CSVs beside ``out_root``."""
    import csv

    from ..utils.davis_metrics import evaluate_dataset_jf
    jf = evaluate_dataset_jf(out_root, label_root)
    print(f"J: {jf['J']:.4f}  F: {jf['F']:.4f}  J&F: {jf['J&F']:.4f}")
    base = out_root.rstrip("/")
    with open(base + "_per-sequence_results.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Sequence", "J-Mean", "F-Mean"])
        for seq in sorted(jf["per_seq"]):
            s = jf["per_seq"][seq]
            w.writerow([seq, f"{s['J']:.6f}", f"{s['F']:.6f}"])
    with open(base + "_global_results.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["J&F-Mean", "J-Mean", "F-Mean"])
        w.writerow([f"{jf['J&F']:.6f}", f"{jf['J']:.6f}", f"{jf['F']:.6f}"])
    print(f"Wrote {base}_per-sequence_results.csv")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not (args.synthetic or args.dataset):
        raise SystemExit("name a --dataset (davis2016, davis2017, "
                         "youtubevos, ...) or pass --synthetic")

    import torch

    from ..configs import get_config
    from ..engine import Evaluator
    from ..models import build_model
    from ..utils.eval_zip import zip_folder
    from ..weights import init_random_, load_reference_checkpoint

    from ..parallel import distributed
    device, devices = args.device, None
    if distributed.maybe_initialize(device=args.device):
        devices = distributed.process_devices(device=args.device)
        device = devices[0]
        if args.shard_num == 1:
            args.shard_id = distributed.rank()
            args.shard_num = distributed.world_size()

    cfg = apply_args(get_config(args.config), args)
    if args.synthetic:
        cfg = cfg.replace(MODEL_MAX_OBJ_NUM=4, TEST_BANK_CAPACITY=3)
    name = "synthetic" if args.synthetic else cfg.TEST_DATASET
    eval_name = (f"{name}_{cfg.EXP_NAME}_m_{cfg.MEM_EVERY}_u_{cfg.UNC_RATIO}"
                 f"_r_{cfg.TEST_MAX_SIZE}_RPA")
    if args.perturb:
        eval_name += f"_p{args.perturb}"
    out_root = args.out or os.path.join(cfg.result_dirs()["eval"],
                                        eval_name + "_torch", "Annotations")
    os.makedirs(out_root, exist_ok=True)
    dataset, label_root = _dataset(cfg, args, out_root)
    model = init_random_(build_model(cfg),
                         torch.Generator().manual_seed(args.seed))
    if args.ckpt_path:
        load_reference_checkpoint(args.ckpt_path, model)
        print(f"Loaded checkpoint {args.ckpt_path}")
    if args.shard_num > 1:
        if not 0 <= args.shard_id < args.shard_num:
            raise SystemExit(f"--shard_id {args.shard_id} out of range "
                             f"for --shard_num {args.shard_num}")
        dataset = _ShardView(dataset, args.shard_id, args.shard_num)
        print(f"Shard {args.shard_id}/{args.shard_num}: "
              f"{len(dataset)} sequences")
    ev = Evaluator(cfg, model, device=device, devices=devices)
    summary = ev.evaluating(dataset, save_root=out_root)
    print(f"Total FPS: {summary['total_fps']:.2f} ({ev.device})")
    zip_folder(out_root, out_root.rstrip("/") + ".zip")
    print(f"Saved results to {out_root}")
    if args.jf:
        if label_root is None or not os.path.isdir(label_root):
            raise SystemExit("--jf needs the dataset's annotations")
        _write_jf(out_root, label_root)


if __name__ == "__main__":
    main()
