"""Where a steady frame of the streaming evaluator spends its time on the
card (``torch.profiler``), chunked (CUDA graph replays) or frame by frame.

    python -m rvos_tpu_torch.cli.profile_eval [--frames 26] [--layout cap0]
        [--frame_chunk 5] [--size 481 849] [--ms 1.0 1.15 1.3 --flip]
        [--backbone mobilenet] [--matching_dtype float32] [--trace trace.json]
        [--config aotl_mobilenetv2]

Runs the main path of ``chip_smoke.py`` (the ``resnet101_aocnet``
preset, or ``--config``'s, e.g. ``aotl_mobilenetv2`` for AOT-L, random
weights from a seed, a 3-object synthetic video; with
``--backbone mobilenet`` the MobileNetV2 backbone; with
``--matching_dtype float32`` parity matching, the float32 routes of the
global kernels) under
bank layout ``--layout`` (``configs.BANK_LAYOUTS``) with
``TEST_FRAME_CHUNK`` set to ``--frame_chunk`` (default: the preset's;
1 runs frame by frame), and with ``--ms``/``--flip`` the multi-scale
+ flip ensemble (the long edge capped at 800 before scaling, the eval
CLI's rule).  The steady frames are those after the first
bank update and the first full chunk, the same frames in both modes
(from frame 6 at the preset's ``MEM_EVERY`` and chunk of 5).  First it streams the video without the profiler,
with a CUDA event recorded as each frame's step is issued and no host
synchronisation, and prints the median and 90th percentile of the
steady frames' times (a chunked frame counts its chunk's time over K;
the events mark the card reaching each step's end, so host stalls are
included), their mean, the peak device memory, the graph captures and
replays and the evaluator's ``timing`` split.  Then it streams the video
again under the profiler from the first steady frame on and prints, per
profiled frame: wall time (the profiler's overhead included), device
busy time (the sum of the device events) and idle share, kernels and
graph replays per frame, the device time of each stage of the frame,
the device's idle time by the host span it fell in, and the kernels with
the most device time.  The stages come from the evaluator's device stage
marks (``utils.trace``), switched on before the evaluator captures its
graphs, so chunked runs show them too: each device record belongs to the
stage of the last mark before it on its stream; the marks' own kernels
run in both passes.  The idle gaps (between merged busy intervals) go
under the innermost span of the evaluator's thread open at each gap's
middle (``data.wait``, ``pipeline.flat``, ``pipeline.step.ragged``, ...;
the trace's span log), or under ``graph`` where both neighbouring
records belong to one graph launch (a bubble inside a replay).  ``--trace`` writes
the profiled pass as a Chrome trace, marks included.  The card and its
power limit head the output.
"""

from __future__ import annotations

import argparse
import subprocess
import time

FILLER = "spin_kernel"


def device_records(prof) -> list:
    """The device's records of a stopped ``torch.profiler`` run →
    ``(name, start_ns, duration_us, stream, correlation id)`` in start
    order, the filler's included.  Read straight from the kineto result: the
    profiler's own operator tree (``events()``, ``key_averages()``) took
    tens of seconds of host time on a training step's records."""
    from torch._C import _demangle
    from torch.autograd import DeviceType
    names = {}
    rows = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        raw = e.name()
        if raw not in names:
            names[raw] = _demangle(raw)
        rows.append((names[raw], e.start_ns(), e.duration_ns() / 1e3,
                     e.device_resource_id(), e.correlation_id()))
    rows.sort(key=lambda r: r[1])
    return rows


def graph_launch_ids(prof) -> set:
    """The correlation ids of a stopped profiler run's graph launches
    (``cudaGraphLaunch`` host records): a replay's device records carry
    its launch's."""
    return {e.correlation_id() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("cudaGraphLaunch")}


def pad_profile(torch, n: int = 50_000) -> None:
    """Queue ``n`` tiny filler kernels (``torch.cuda._sleep``, named
    ``spin_kernel``) and wait for them, just before a profiler stops.
    The profiler can drop its last, partly filled buffer of device
    records when it stops (on the H100, up to ~38,500 kernel records a
    buffer; a 22-frame video is about 40,000): the filler fills that
    buffer, so the profiled work's records are all in delivered ones.
    Callers leave the filler out, and check that some of it shows."""
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def video_steps(ev, n_frames: int):
    """The steps ``ev`` streams a video of ``n_frames`` frames in when
    nothing cuts its chunks but the chunk size and MEM_EVERY (no joins,
    no context change), as lists of frame indices: a full chunk is one
    step, each frame of a shorter cut another."""
    import numpy as np

    from ..engine.eval_pipeline import Chunker
    steps = []
    chunker = Chunker(ev.chunk_n, lambda buf, ctx: steps.append(
        [f for f, _, _ in buf]), lambda buf, ctx: steps.extend(
        [f] for f, _, _ in buf), ev._mem_boundary)
    one = np.ones(1, np.float32)
    for f in range(1, n_frames):
        chunker.push(f, "", None, None, one, one, None)
    chunker.flush()
    return steps


def steady_frame_ms(ends, steps, first: int):
    """Per steady frame (index ``first`` on), ms: ``ends[f]`` is a CUDA
    event recorded when frame f's step was issued; a frame gets its
    step's time (from the previous step's end to its own) over the step's
    frame count."""
    out = []
    for step in steps:
        if step[0] >= first:
            ms = ends[step[0] - 1].elapsed_time(ends[step[-1]])
            out += [ms / len(step)] * len(step)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="resnet101_aocnet")
    p.add_argument("--layout", default="occupancy",
                   help="bank layout: occupancy, uniform, unsegmented, cap0")
    p.add_argument("--frames", type=int, default=26)
    p.add_argument("--frame_chunk", type=int, default=-1,
                   help="TEST_FRAME_CHUNK (-1: the preset's)")
    p.add_argument("--size", type=int, nargs=2, default=(481, 849))
    p.add_argument("--ms", nargs="+", type=float, default=[1.0])
    p.add_argument("--flip", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default="")
    p.add_argument("--backbone", default="",
                   choices=["", "resnet", "mobilenet"],
                   help="MODEL_BACKBONE (default: the preset's)")
    p.add_argument("--matching_dtype", default="",
                   choices=["", "float32", "mixed", "bfloat16"],
                   help="MATCHING_DTYPE (default: the preset's)")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..configs import BANK_LAYOUTS, get_config
    from ..data import SyntheticEval
    from ..engine import Evaluator
    from ..models import build_model
    from ..utils import trace
    from ..weights import init_random_

    cfg = get_config(args.config, **BANK_LAYOUTS[args.layout])
    if args.backbone:
        cfg = cfg.replace(MODEL_BACKBONE=args.backbone)
    if args.frame_chunk > 0:
        cfg = cfg.replace(TEST_FRAME_CHUNK=args.frame_chunk)
    if args.matching_dtype:
        cfg = cfg.replace(MATCHING_DTYPE=args.matching_dtype)
    if args.flip or tuple(args.ms) != (1.0,):
        cfg = cfg.replace(TEST_FLIP=args.flip, TEST_MULTISCALE=tuple(args.ms),
                          TEST_MAX_SIZE=800.0)
    model = init_random_(build_model(cfg),
                         torch.Generator().manual_seed(args.seed))
    trace.enable()      # marks in every graph the evaluator captures; spans
    ev = Evaluator(cfg, model, device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    first = max(ev.chunk_n, cfg.MEM_EVERY, 1) + 1    # first steady frame
    print(f"card: {card} | {args.config} {cfg.MODEL_BACKBONE} | layout "
          f"{args.layout} | "
          f"matching {cfg.MATCHING_DTYPE} | "
          f"frame chunk {ev.chunk_n} "
          f"| variants {len(ev.variants.flips)} (scales {cfg.TEST_MULTISCALE}, "
          f"flip {cfg.TEST_FLIP}) | steady frames {first}-{args.frames - 1}")

    def video():
        return SyntheticEval(size=tuple(args.size), n_seqs=1,
                             n_frames=args.frames, obj_num=3)[0]

    ends = []

    def mark(f):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ends.append(e)

    torch.cuda.reset_peak_memory_stats()
    out = ev.evaluate_sequence(video(), frame_callback=mark)
    torch.cuda.synchronize()
    steady = sorted(steady_frame_ms(ends, video_steps(ev, args.frames),
                                    first))
    mean = ends[first - 1].elapsed_time(ends[-1]) / (len(ends) - first)
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = " ".join(f"{k}={1e3 * v / out['frames']:.2f}"
                     for k, v in out["timing"].items())
    print(f"unprofiled {len(steady)} steady frames: median "
          f"{steady[len(steady) // 2]:.2f} ms, p90 "
          f"{steady[int(0.9 * (len(steady) - 1))]:.2f} ms, mean {mean:.2f} "
          f"ms, min {steady[0]:.2f} ms, peak memory {peak:.3f} GB, "
          f"{ev.captures} captures, {ev.replays} replays, wall fps "
          f"{out['fps']:.2f}, timing ms/frame {split} [{card}]", flush=True)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = {}

    def on_frame(f):
        if f == first - 1:
            torch.cuda.synchronize()
            start["replays"] = ev.replays
            trace.take()            # the spans before the profiled frames
            prof.__enter__()
            start["t"] = time.time()

    ev.evaluate_sequence(video(), frame_callback=on_frame)
    torch.cuda.synchronize()
    wall = time.time() - start["t"]
    log = trace.take()
    pad_profile(torch)
    prof.__exit__(None, None, None)
    n = args.frames - first
    if args.trace:
        prof.export_chrome_trace(args.trace)

    def on_device(e):
        return str(e.device_type).endswith("CUDA") and FILLER not in e.key

    busy = sum(e.device_time_total for e in prof.events() if on_device(e))
    n_kernels = sum(1 for e in prof.events() if on_device(e))
    print(f"profiled {n} frames: wall {1e3 * wall / n:.2f} ms/frame, device "
          f"busy {busy / 1e3 / n:.2f} ms/frame, idle share "
          f"{1 - busy / 1e6 / wall:.3f}, {n_kernels / n:.0f} kernels/frame, "
          f"{(ev.replays - start['replays']) / n:.2f} replays/frame "
          f"[{card}]")
    if not any(FILLER in e.key for e in prof.events()):
        raise RuntimeError("the profiler lost the end of its record")
    records = [r for r in device_records(prof) if FILLER not in r[0]]
    stages = trace.stage_times(records)
    for name in (*trace.STAGES, None):
        us = stages.get(name, 0.0)
        print(f"  stage {name or 'unmarked':16s} {us / 1e3 / n:8.3f} "
              f"ms/frame ({100 * us / max(busy, 1e-9):5.1f} % of busy)")
    idle = trace.idle_by_span(records, log, graph_launch_ids(prof))
    for name, ns in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  idle  {name or 'no span':20s} {ns / 1e6 / n:8.3f} "
              f"ms/frame ({100 * ns / 1e9 / wall:5.2f} % of wall)")
    kernels = sorted((e for e in prof.key_averages() if on_device(e)),
                     key=lambda e: e.device_time_total, reverse=True)
    for e in kernels[:20]:
        print(f"  kernel {e.key[:70]:70s} {e.device_time_total / 1e3 / n:8.3f}"
              f" ms/frame x{e.count / n:.1f}")


if __name__ == "__main__":
    main()
