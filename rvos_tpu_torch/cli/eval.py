"""Evaluation CLI of the PyTorch port — the flag names of
``rvos_tpu/cli/eval.py`` for what the port supports, plus ``--device``
and ``--seed``.

    python -m rvos_tpu_torch.cli.eval --synthetic --out /tmp/port_eval
    python -m rvos_tpu_torch.cli.eval --synthetic --device cpu

Runs on CUDA unless ``--device cpu``.  The port has no checkpoint
loader and no DAVIS/YouTube-VOS loaders yet: it evaluates the synthetic
fixture with random weights made from ``--seed``.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="Eval AOC-Net (PyTorch port, RPA)")
    p.add_argument("--exp_name", type=str, default="")
    p.add_argument("--config", type=str, default="resnet101_aocnet")
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
    p.add_argument("--global_atrous_rate", type=int, default=1)
    p.add_argument("--min_matching_pixels", type=int, default=-1,
                   help="sets MATCHING_MAX_REF_PIXELS (0 disables the cap, "
                        "-1 keeps the preset)")
    p.add_argument("--max_long_edge", type=int, default=-1)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    return p


def apply_args(cfg, args):
    if args.exp_name:
        cfg = cfg.replace(EXP_NAME=args.exp_name)
    if args.mem_every != -1:
        cfg = cfg.replace(MEM_EVERY=args.mem_every)
    cfg = cfg.replace(UNC_RATIO=args.ucr,
                      TEST_GLOBAL_ATROUS_RATE=args.global_atrous_rate)
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
        cfg = cfg.replace(TEST_MAX_SIZE=800 * 1.3)
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("the port evaluates --synthetic only; the DAVIS and "
                         "YouTube-VOS loaders are not ported yet")

    import torch

    from ..configs import get_config
    from ..data import SyntheticEval
    from ..engine import Evaluator
    from ..models import AOCNet
    from ..weights import init_random_

    cfg = apply_args(get_config(args.config), args)
    cfg = cfg.replace(MODEL_MAX_OBJ_NUM=4, TEST_BANK_CAPACITY=3)
    dataset = SyntheticEval(size=(129, 129))
    model = init_random_(AOCNet(cfg),
                         torch.Generator().manual_seed(args.seed))
    out_root = args.out or os.path.join(
        cfg.result_dirs()["eval"],
        f"synthetic_{cfg.EXP_NAME}_m_{cfg.MEM_EVERY}_u_{cfg.UNC_RATIO}_torch",
        "Annotations")
    ev = Evaluator(cfg, model, device=args.device)
    summary = ev.evaluating(dataset, save_root=out_root)
    print(f"Total FPS: {summary['total_fps']:.2f} ({ev.device})")
    print(f"Saved results to {out_root}")


if __name__ == "__main__":
    main()
