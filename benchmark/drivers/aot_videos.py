"""AOT eval cells: videos streamed back to back through the port's
``Evaluator.evaluate_sequence`` with the configuration's AOT model, one
after another in a closed loop.

The window is ``eval_videos``' (its ``_Seq``, ``_Marks``,
``video_steps``, ``frame_times`` and ``build_kernels``): set-up builds the
model (``models.build_model``) with the benchmark's weights
(``make_aot_state``), makes the mix's videos, and runs a short warm-up
video that compiles and captures every kind of step; the window streams
the videos in the seed's order until ``seconds`` have passed, finishing
the video under way; its ctx is ``eval_videos``'.  Traced, the program's
spans and stage marks are switched on before the evaluator captures its
graphs and read by ``harness/spans.py`` (``stage_ns``, ``idle_ns``), and the
FLOPs of each finished video come from ``counts/aot_flops.py`` (each
frame at its own memory's length), keyed by the video for ``mfu.eval``.

After the window the program's state is freed and the reference
(``reference/aot.py``) scores the masks of a sample of the finished
videos drawn from the seed, the longest among them.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from ..counts import aot_flops
from ..harness import spans
from ..harness import trace as tr
from ..harness.videos import Video, make_videos, render, warmup_spec
from ..harness.weights import make_state
from ..reference import aot as reference
from ..reference.video import Scores, eval_size
from .eval_videos import (_Marks, _Seq, _sample, _sync, build_kernels,
                          frame_times, port_config, video_steps)


def make_aot_state(shapes: Dict[str, torch.Size], seed: int, device,
                   cfg: Dict, warm: Video) -> Dict[str, torch.Tensor]:
    """``harness.weights.make_state``'s random weights with the decoder's
    last bias (``conv_out.bias``) set so that each channel's logits
    average 0 on the warm-up video ``warm`` (``reference.aot.
    centre_logits``).  With the plain draws the positive means of the
    ReLU features, carried through attention that is soft at random
    weights, put a constant offset between the channels that varied by
    seed: on some seeds one label took 99 % of the pixels whatever the
    memory held, a dropped memory frame moved 0.1 % of them, and the fp8
    control left the check's numbers within the program's."""
    sd = make_state(shapes, seed, device)
    reference.centre_logits(sd, cfg, warm.frames, warm.labels[0], device)
    return sd


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        setup_t0: Optional[float] = None, control_cast=None,
        videos_limit: Optional[int] = None,
        max_videos: Optional[int] = None) -> Dict:
    """One run of an AOT eval cell; ``eval_videos.run``'s arguments and
    result."""
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.models import build_model
    from rvos_tpu_torch.utils import trace as program

    setup_t0 = time.time() if setup_t0 is None else setup_t0
    mix, config = cell.mix, cell.config
    cfg = port_config(config)
    if trace:
        program.enable()            # marks in every graph captured below
    try:
        warm = render(warmup_spec(mix), mix["frame_hw"], seed, 10 ** 6,
                      device, "warmup")
        model = build_model(cfg)
        shapes = {n: t.shape for n, t in model.state_dict().items()}
        sd = make_aot_state(shapes, seed, device, config["config"], warm)
        if torch.device(device).type == "cuda":
            # the peak reported is the program's, not the reference's
            # pass over the warm-up video
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model.load_state_dict(sd, strict=True)
        ev = Evaluator(cfg, model, device=device)
        build_s = (build_kernels() if torch.device(device).type == "cuda"
                   else 0.0)
        videos = make_videos(mix, seed, device, videos_limit)
        ev.evaluate_sequence(_Seq(warm))
        _sync(device)
        setup_s = time.time() - setup_t0

        marks = _Marks(device)

        def on_frame(f):
            if f > 0:
                marks.mark()

        prof = tr.start() if trace else None
        program.take()              # set-up's spans
        base = ev.replays
        done: List = []
        timing: Dict[str, float] = {}
        t0 = time.time()
        marks.mark()
        k = 0
        while True:
            i = k % len(videos)
            out = ev.evaluate_sequence(_Seq(videos[i]),
                                       frame_callback=on_frame)
            done.append((i, out["frames"], out["results"]))
            for key, v in out["timing"].items():
                timing[key] = timing.get(key, 0.0) + v
            k += 1
            if time.time() - t0 >= seconds or k == max_videos:
                break
        _sync(device)
        window_s = time.time() - t0
        frames = sum(n for _, n, _ in done)
        steps = [s for i, _, _ in done for s in video_steps(ev, videos[i])]
        ctx = {"kind": "eval", "window_s": window_s, "frames": frames,
               "videos": len(done), "timing": timing,
               "replays": ev.replays - base, "chunk_n": ev.chunk_n,
               "steps": steps, "frame_ms": frame_times(marks, steps),
               "video_channels": [(n, i) for i, n, _ in done]}
        if prof is not None:
            dev_rec, host_rec = tr.stop(prof)
            lo = dev_rec[0][1] if dev_rec else 0
            hi = max((e for _, _, e in dev_rec), default=0)
            ctx.update(dev=dev_rec, busy_s=tr.busy_ns(dev_rec, lo, hi) / 1e9,
                       breakdown={"device_ops": tr.top_ops(dev_rec),
                                  "idle_gaps": tr.idle_gaps(
                                      dev_rec, host_rec, lo, hi)})
            ctx.update(spans.window(prof, program.take()))
            hw = eval_size(*mix["frame_hw"], cfg.TEST_MAX_SIZE)
            parts = aot_flops.part_flops(shapes, config["config"], hw)
            per_video = {i: aot_flops.video_flops(
                parts, len(videos[i]), cfg.MEM_EVERY,
                [f for f in videos[i].labels if f > 0])
                for i in {i for i, _, _ in done}}
            ctx["flops"] = {"frame0": parts["encode"] + parts["reference"],
                            "frame": {i: f["frame"]
                                      for i, f in per_video.items()}}
    finally:
        if trace:
            program.disable()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)

    # the program's state goes before the reference runs (``sd``, the
    # weights as float32, stays: the reference reads them)
    del ev, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    scores = Scores()
    control = Scores() if control_cast is not None else None
    for i, _, results in _sample(done, mix, seed):
        v = videos[i]
        masks = {int(name.split(".")[0]): m for name, m in results.items()}
        reference.check_video(sd, config["config"], v.frames, v.labels,
                              masks, device, scores, control_cast, control)
    return {"ctx": ctx, "setup_s": setup_s, "build_s": build_s,
            "attempted": frames, "failed": 0, "peak": peak,
            "check": scores.summary(),
            "control": None if control is None else control.summary()}
