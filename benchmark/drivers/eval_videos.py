"""Eval cells: videos streamed back to back through the port's
``Evaluator.evaluate_sequence``, one after another in a closed loop.

Set-up builds the configuration's model with the benchmark's weights
(``harness.weights``), makes the mix's videos (``harness.videos``) and
runs one short video of the same frame size, which compiles and captures
every kind of step the window runs.  The window then streams the videos
in the seed's order (from the first again if it runs past the last)
until ``seconds`` have passed, finishing the video under way: every
video's first frame, its ragged and join frames, bank compaction and
loader waits fall inside it.  A CUDA event is recorded as each frame's
step is issued (host stalls count).  The steps are the program's own: a
replay of its ``Chunker`` over each video, each join frame a step of its
own (``video_steps``).  A step's time runs from the last event of the
step before to its own last, and each of its frames gets that time over
its frame count.

After the window the program's state is freed and the reference
(``reference.video``) scores the masks of a sample of the finished
videos drawn from the seed, the longest among them.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..counts import flops as flop_counts
from ..harness import trace as tr
from ..harness.videos import Video, make_videos, render, warmup_spec
from ..harness.weights import make_state
from ..reference.video import Scores, check_video, eval_size


def port_config(config: Dict):
    """The port's ``Config``: the preset, with every field the
    configuration's file states set to its value."""
    from rvos_tpu_torch.configs import get_config
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["config"].items()}
    return get_config(config["preset"], **fields)


class _Seq:
    """A video as the evaluator reads it (the samples of ``DAVISTest``)."""

    def __init__(self, video: Video):
        self.video = video
        self.seq_name = video.name
        self.names = [f"{i:05d}.jpg" for i in range(len(video))]

    def __len__(self):
        return len(self.video)

    def __getitem__(self, i):
        v = self.video
        h, w = v.frames.shape[1:3]
        sample = {"current_img": v.frames[i],
                  "meta": {"seq_name": v.name, "frame_num": len(v),
                           "obj_num": v.obj_num,
                           "obj_list": list(range(1, v.obj_num + 1)),
                           "current_name": self.names[i],
                           "height": h, "width": w}}
        if i in v.labels:
            sample["current_label"] = v.labels[i]
        return sample


class _Marks:
    """A time mark as each frame's step is issued: CUDA events on a
    card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def elapsed_ms(self, a: int, b: int) -> float:
        a, b = self.marks[a], self.marks[b]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def video_steps(ev, video: Video) -> List[List[int]]:
    """The steps in which ``ev`` streams ``video``, as lists of frame
    indices: the program's ``Chunker`` replayed over the frames after
    frame 0 (a full chunk one step, each frame of a shorter cut
    another), each join frame a step of its own after the frames
    buffered before it, as ``Evaluator.evaluate_sequence`` runs them."""
    from rvos_tpu_torch.engine.eval_pipeline import Chunker
    steps: List[List[int]] = []
    chunker = Chunker(ev.chunk_n,
                      lambda buf, ctx: steps.append([f for f, _, _ in buf]),
                      lambda buf, ctx: steps.extend([f] for f, _, _ in buf),
                      ev._mem_boundary)
    same = np.ones(1, np.float32)
    for f in range(1, len(video)):
        if f in video.labels:
            chunker.flush()
            steps.append([f])
        else:
            chunker.push(f, "", None, None, same, same, None)
    chunker.flush()
    return steps


def frame_times(marks: _Marks, steps: List[List[int]]) -> List[float]:
    """Per frame ms: ``marks.marks[0]`` opens the window, then one mark
    per masked frame in order; ``steps`` are the window's steps in that
    order.  A frame gets its step's time over the step's frame count."""
    out, at = [], 0
    for step in steps:
        end = at + len(step)
        ms = marks.elapsed_ms(at, end)
        out += [ms / len(step)] * len(step)
        at = end
    if at != len(marks.marks) - 1:
        raise RuntimeError(f"{len(marks.marks) - 1} frames marked, the "
                           f"steps hold {at}")
    return out


def build_kernels() -> float:
    """Seconds spent building the program's CUDA kernels that are not
    built yet (all of them on a checkout's first run, none after), timed
    apart so that the compiling run's build shows beside ``setup_s``."""
    from rvos_tpu_torch.ops import _cuda
    t0 = time.time()
    _cuda.build(sorted(p.stem for p in _cuda.CSRC_DIR.glob("*.cu")))
    return time.time() - t0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        setup_t0: Optional[float] = None, control_cast=None,
        videos_limit: Optional[int] = None,
        max_videos: Optional[int] = None) -> Dict:
    """One run of an eval cell → {"ctx" (what the metrics read),
    "setup_s", "build_s" (the part of set-up that built kernels),
    "attempted", "failed", "peak", "check", "control"}; see
    ``run.py`` for the line.  ``videos_limit`` makes only the first
    videos of the seed's order, ``max_videos`` ends the window after
    that many (tests on the CPU)."""
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.models import AOCNet

    setup_t0 = time.time() if setup_t0 is None else setup_t0
    mix, config = cell.mix, cell.config
    cfg = port_config(config)
    model = AOCNet(cfg)
    shapes = {n: t.shape for n, t in model.state_dict().items()}
    sd = make_state(shapes, seed, device)
    model.load_state_dict(sd, strict=True)
    del sd
    ev = Evaluator(cfg, model, device=device)
    build_s = build_kernels() if torch.device(device).type == "cuda" else 0.0
    videos = make_videos(mix, seed, device, videos_limit)
    warm = render(warmup_spec(mix), mix["frame_hw"], seed, 10 ** 6, device,
                  "warmup")
    ev.evaluate_sequence(_Seq(warm))
    _sync(device)
    setup_s = time.time() - setup_t0

    marks = _Marks(device)

    def on_frame(f):
        if f > 0:
            marks.mark()

    prof = tr.start() if trace else None
    replays0 = ev.replays
    done: List = []
    timing: Dict[str, float] = {}
    t0 = time.time()
    marks.mark()
    k = 0
    while True:
        i = k % len(videos)
        out = ev.evaluate_sequence(_Seq(videos[i]), frame_callback=on_frame)
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
    channels = [(n, videos[i].obj_num + 1) for i, n, _ in done]
    ctx = {"kind": "eval", "window_s": window_s, "frames": frames,
           "videos": len(done), "timing": timing,
           "replays": ev.replays - replays0, "chunk_n": ev.chunk_n,
           "steps": steps, "frame_ms": frame_times(marks, steps),
           "video_channels": channels}
    if prof is not None:
        dev_rec, host_rec = tr.stop(prof)
        lo = dev_rec[0][1] if dev_rec else 0
        hi = max((e for _, _, e in dev_rec), default=0)
        ctx.update(dev=dev_rec, busy_s=tr.busy_ns(dev_rec, lo, hi) / 1e9,
                   breakdown={"device_ops": tr.top_ops(dev_rec),
                              "idle_gaps": tr.idle_gaps(dev_rec, host_rec,
                                                        lo, hi)})
        hw = eval_size(*mix["frame_hw"], cfg.TEST_MAX_SIZE)
        counts = flop_counts.eval_frame_flops(
            shapes, config["config"], cfg.MODEL_BACKBONE, hw,
            [n for _, n in channels])
        grid = (-(-hw[0] // 4), -(-hw[1] // 4))
        ctx.update(flops=counts, mixed=cfg.matching_dtype != "float32",
                   shapes={"m": grid[0] * grid[1],
                           "p": cfg.MATCHING_MAX_REF_PIXELS,
                           "c": cfg.MODEL_SEMANTIC_EMBEDDING_DIM,
                           "o": cfg.MODEL_MAX_OBJ_NUM,
                           "lh": grid[0] // 2 + 1, "lw": grid[1] // 2 + 1,
                           "radii": list(cfg.MODEL_MULTI_LOCAL_DISTANCE)})
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)

    # the program's state goes before the reference runs
    del ev, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    scores = Scores()
    control = Scores() if control_cast is not None else None
    sd = make_state(shapes, seed, device)
    for i, n_done, results in _sample(done, mix, seed):
        v = videos[i]
        masks = {int(name.split(".")[0]): m for name, m in results.items()}
        check_video(sd, config["config"], cfg.MODEL_BACKBONE, v.frames,
                    v.labels, v.obj_num, masks, device, scores,
                    control_cast, control)
    return {"ctx": ctx, "setup_s": setup_s, "build_s": build_s,
            "attempted": frames,
            "failed": 0, "peak": peak, "check": scores.summary(),
            "control": None if control is None else control.summary()}


def _sample(done: List, mix: Dict, seed: int) -> List:
    """The finished videos the reference scores: the longest, then others
    drawn from the seed, ``mix["check_videos"]`` in all (each video once)."""
    uniq = {}
    for i, n, res in done:
        uniq[i] = (i, n, res)
    items = sorted(uniq.values(), key=lambda r: (-r[1], r[0]))
    rng = np.random.default_rng([seed % (2 ** 63), 2])
    rest = [items[j] for j in rng.permutation(len(items)) if j != 0]
    return ([items[0]] + rest)[:int(mix["check_videos"])]
