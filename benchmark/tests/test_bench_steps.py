"""The frame times' steps are the program's own: the replayed steps of a
window equal the frames of each step the evaluator ran, join frames
alone; each frame gets its step's time over the step's frame count; and
``mfu.eval`` counts each video over its live object channels."""

import importlib.util

import pytest
import torch

from benchmark.drivers import eval_videos
from benchmark.harness.manifest import HERE
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 34 + 5
VIDEOS = [[13, 2, [0, 0]], [11, 3, [0, 4, 0]], [9, 1, [0]]]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_replayed_steps_are_the_evaluators(monkeypatch):
    from rvos_tpu_torch.engine import Evaluator
    seen = []
    step = Evaluator._step

    def spy(self, states, buf, *args, **kw):
        seen.append([f for f, _, _ in buf])
        return step(self, states, buf, *args, **kw)

    monkeypatch.setattr(Evaluator, "_step", spy)
    cell = tiny_cell(videos=VIDEOS, check_videos=1)
    res = eval_videos.run(cell, SEED, 1e9, False, device="cpu",
                          videos_limit=3, max_videos=3)
    ctx = res["ctx"]
    steps = ctx["steps"]
    assert seen[-len(steps):] == steps
    assert [4] in steps and any(len(s) > 1 for s in steps)
    assert len(ctx["frame_ms"]) == ctx["frames"] == sum(map(len, steps))
    assert sorted(ctx["video_channels"]) == [(8, 2), (10, 4), (12, 3)]
    assert _reader("frame_ms_p95")(dict(ctx, frame_ms=ctx["frame_ms"] * 2))


class _Clock:
    cuda = False

    def __init__(self, marks):
        self.marks = marks

    elapsed_ms = eval_videos._Marks.elapsed_ms


def test_a_frame_gets_its_steps_time_over_its_frames():
    # window start, a 3-frame step of 30 ms, a ragged frame of 7 ms
    clock = _Clock([0.0, 0.030, 0.030001, 0.030002, 0.037002])
    ms = eval_videos.frame_times(clock, [[1, 2, 3], [4]])
    assert ms == pytest.approx([10.000667, 10.000667, 10.000667, 7.0])
    with pytest.raises(RuntimeError):
        eval_videos.frame_times(clock, [[1, 2, 3]])


def test_mfu_counts_live_channels_only():
    read = _reader("mfu.eval")
    flops = {"frame0": 1.0e11, "frame": {2: 3.0e11, 6: 5.0e11}}
    ctx = {"kind": "eval", "window_s": 1.0, "flops": flops,
           "video_channels": [(10, 2), (10, 6)]}
    total = 10 * 3.0e11 + 10 * 5.0e11 + 2 * 1.0e11
    assert read(ctx) == pytest.approx(100.0 * total / 989e12)
