"""Where a steady frame of the streaming evaluator spends its time on the
card (``torch.profiler``).

    python -m rvos_tpu_torch.cli.profile_eval [--frames 24] [--warmup 4]
        [--size 481 849] [--layout cap0] [--trace profile_eval_trace.json]

Runs the main path of ``chip_smoke.py`` (the ``resnet101_aocnet``
preset, random weights from a seed, a 3-object synthetic video), under
another bank layout with ``--layout`` (``configs.BANK_LAYOUTS``).  First
it streams ``--frames`` frames without the profiler and prints the
median and 90th percentile of the frame-to-frame times from frame 3 on
(frames 1–2 warm cuDNN) and the peak device memory; then it streams
them again and profiles the frames after ``--warmup``.  Each model
stage is wrapped in CUDA events by this script only — the package
carries no profiling code.  Prints, per profiled frame: wall time (the profiler's overhead
included), device busy time (the sum of kernel times on the one stream)
and idle share, the device time between each stage's start and end
events, and the kernels with the most device time; the card and its
power limit head the output.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import time


def _stage(name, fn, log):
    import torch

    @functools.wraps(fn)
    def run(*a, **kw):
        if log is None:
            return fn(*a, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*a, **kw)
        end.record()
        log.append((name, start, end))
        return out
    return run


def _instrument(ev, log):
    """Wrap the evaluator's stages in CUDA-event pairs appended to
    ``log`` (a list, or None while not recording)."""
    from ..models import aocnet
    from ..engine import eval as eval_mod
    m = ev.model
    for name in ("feature_extracter", "semantic_embedding",
                 "dynamic_prehead", "dynamic_seghead"):
        mod = getattr(m, name)
        mod.forward = _stage(name, mod.forward, log)
    for name in ("global_matching_flat_segmented", "global_matching_flat",
                 "cluster_objects",
                 "cluster_matching", "attention_heads", "proxy_matching",
                 "local_matching_bank_stacked", "foreground2background"):
        setattr(aocnet, name, _stage(name, getattr(aocnet, name), log))
    eval_mod.precompact_bank = _stage("precompact_bank",
                                      eval_mod.precompact_bank, log)
    ev._step = _stage("frame", ev._step, log)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="resnet101_aocnet")
    p.add_argument("--layout", default="occupancy",
                   help="bank layout: occupancy, uniform, unsegmented, cap0")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--warmup", type=int, default=4)
    p.add_argument("--size", type=int, nargs=2, default=(481, 849))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default="")
    p.add_argument("--device", default="cuda",
                   help="cpu only rehearses the control flow")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..configs import BANK_LAYOUTS, get_config
    from ..data import SyntheticEval
    from ..engine import Evaluator
    from ..models import AOCNet
    from ..weights import init_random_

    cfg = get_config(args.config, **BANK_LAYOUTS[args.layout])
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(args.seed))
    ev = Evaluator(cfg, model, device=args.device)
    card = "cpu rehearsal, no device numbers"
    if ev.device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card} | layout {args.layout}")
    on_card = ev.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    stamps = []

    def stamp(f):
        sync()
        stamps.append(time.time())

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ev.evaluate_sequence(SyntheticEval(
        size=tuple(args.size), n_seqs=1, n_frames=args.frames,
        obj_num=3)[0], frame_callback=stamp)
    steady = sorted(b - a for a, b in zip(stamps[2:], stamps[3:]))
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    print(f"unprofiled {len(steady)} steady frames: median "
          f"{1e3 * steady[len(steady) // 2]:.2f} ms, p90 "
          f"{1e3 * steady[int(0.9 * (len(steady) - 1))]:.2f} ms, min "
          f"{1e3 * steady[0]:.2f} ms, peak memory {peak:.3f} GB [{card}]",
          flush=True)

    log = [] if on_card else None
    _instrument(ev, log)
    seq = SyntheticEval(size=tuple(args.size), n_seqs=1,
                        n_frames=args.frames, obj_num=3)[0]
    acts = [ProfilerActivity.CPU]
    if ev.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    start = {}

    def on_frame(f):
        if f == args.warmup:
            sync()
            if log is not None:
                log.clear()
            prof.__enter__()
            start["t"] = time.time()

    ev.evaluate_sequence(seq, frame_callback=on_frame)
    sync()
    wall = time.time() - start["t"]
    prof.__exit__(None, None, None)
    n = args.frames - 1 - args.warmup
    if args.trace:
        prof.export_chrome_trace(args.trace)

    def on_device(e):
        return str(e.device_type).endswith("CUDA")

    busy = sum(e.device_time_total for e in prof.events() if on_device(e))
    n_kernels = sum(1 for e in prof.events() if on_device(e))
    print(f"profiled {n} frames: wall {1e3 * wall / n:.2f} ms/frame, device "
          f"busy {busy / 1e3 / n:.2f} ms/frame, idle share "
          f"{1 - busy / 1e6 / wall:.3f}, {n_kernels / n:.0f} kernels/frame "
          f"[{card}]")
    stages = {}
    for name, a, b in log or ():
        t, k = stages.get(name, (0.0, 0))
        stages[name] = (t + a.elapsed_time(b), k + 1)
    for name, (t, k) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        print(f"  stage {name:32s} {t / n:8.3f} ms/frame (calls/frame "
              f"{k / n:.1f})")
    kernels = sorted((e for e in prof.key_averages() if on_device(e)),
                     key=lambda e: e.device_time_total, reverse=True)
    for e in kernels[:20]:
        print(f"  kernel {e.key[:70]:70s} {e.device_time_total / 1e3 / n:8.3f}"
              f" ms/frame x{e.count / n:.1f}")


if __name__ == "__main__":
    main()
