"""The port's tracing (``rvos_tpu_torch.utils.trace``) on the CPU: spans
on the profiler's host clock, nothing logged while switched off, the
evaluator's step spans against its steps and its ``timing`` against its
spans, the stage marks' places; and the benchmark's readers of spans and
marks (``benchmark/harness/spans.py``) on hand-made records."""

import pytest
import torch

from benchmark.drivers import eval_videos
from benchmark.harness import spans as readers
from benchmark.harness.trace import busy_ns
from benchmark.harness.videos import render
from benchmark.tests.tiny import tiny_cell
from rvos_tpu_torch.engine import Evaluator
from rvos_tpu_torch.models import AOCNet
from rvos_tpu_torch.utils import trace
from rvos_tpu_torch.weights import init_random_
from torch_port_threads import torch_threads  # noqa: F401 (autouse)

SEED = 2 ** 33 + 17
TIMING = {"data.wait": "loader_wait", "pipeline.flat": "flat",
          "pipeline.step.full": "step_dispatch",
          "pipeline.step.ragged": "step_dispatch",
          "pipeline.step.join": "step_dispatch",
          "pipeline.flush": "flush", "pipeline.drain": "drain"}


@pytest.fixture(autouse=True)
def _switched_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def tiny():
    """A tiny evaluator on the CPU and a 13-frame video whose second
    object joins at frame 8: a full chunk (1-5), ragged frames and a
    join frame."""
    cell = tiny_cell()
    cfg = eval_videos.port_config(cell.config)
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
    ev = Evaluator(cfg, model, device="cpu")
    video = render([13, 2, [0, 8]], cell.mix["frame_hw"], SEED, 0, "cpu", "v")
    return ev, video


def test_span_brackets_the_profilers_record_of_its_work():
    """Spans read the clock the profiler stamps its host records with."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.randn(96, 96), torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("x") as sp:
            torch.mm(a, b)
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert sp.t0 <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= sp.t1


def test_switched_off_logs_nothing(tiny):
    ev, video = tiny
    out = ev.evaluate_sequence(eval_videos._Seq(video))
    assert trace.take() == []
    assert set(out["timing"]) == {"loader_wait", "flat", "step_dispatch",
                                  "flush", "drain"}
    assert out["frames"] == 12 and out["fps"] > 0
    with pytest.raises(KeyError):
        trace.stage("model.unknown", torch.device("cpu"))


@pytest.mark.parametrize("marks,log", [(True, False), (False, True)])
def test_marks_and_log_switch_apart(marks, log):
    """``enable(marks=..., log=...)``: a caller that wants only marks gets
    no log to drain."""
    trace.enable(marks=marks, log=log)
    with trace.span("pipeline.video"):
        with trace.span("data.wait"):
            pass
    assert [s.name for s in trace.take()] == (
        ["data.wait", "pipeline.video"] if log else [])
    assert trace._marks is marks


def test_step_spans_are_the_evaluators_steps(tiny, monkeypatch):
    """Switched on: the step spans, in order, are the steps the benchmark
    replays (``video_steps``: a full chunk, each ragged frame, the join
    frame alone); ``timing`` is the totals of its spans; every span lies
    on one thread under ``pipeline.video``; and the stage marks come in
    each frame's order (the calls recorded: the CPU launches none)."""
    ev, video = tiny
    stages = []
    stage = trace.stage
    monkeypatch.setattr(trace, "stage",
                        lambda name, device: (stages.append(name),
                                              stage(name, device)))
    trace.enable()
    out = ev.evaluate_sequence(eval_videos._Seq(video))
    log = trace.take()
    by_start = sorted(log, key=lambda s: s.start_ns)
    kinds = [s.name for s in by_start if s.name.startswith("pipeline.step")]
    want = ["pipeline.step.join" if step[0] in video.labels
            else "pipeline.step.full" if len(step) > 1
            else "pipeline.step.ragged"
            for step in eval_videos.video_steps(ev, video)]
    assert kinds == want
    assert {"pipeline.step.full", "pipeline.step.ragged",
            "pipeline.step.join"} <= set(kinds)

    totals = dict.fromkeys(out["timing"], 0.0)
    for s in log:
        if s.name in TIMING:
            totals[TIMING[s.name]] += (s.end_ns - s.start_ns) / 1e9
    assert totals == pytest.approx(out["timing"], rel=1e-9, abs=1e-12)

    (video_span,) = [s for s in log if s.name == "pipeline.video"]
    assert out["time"] == (video_span.end_ns - video_span.start_ns) / 1e9
    assert video_span.parent == -1 and len({s.thread for s in log}) == 1
    by_id = {s.id: s for s in log}
    for s in log:
        anc = s
        while anc.parent != -1:
            parent = by_id[anc.parent]
            assert parent.start_ns <= anc.start_ns <= anc.end_ns <= \
                parent.end_ns
            anc = parent
        assert anc is video_span
    assert sum(s.name == "pipeline.start" for s in log) == 1

    assert set(stages) == set(trace.STAGES) - {"model.lstt"}    # AOT's
    for i, name in enumerate(stages):
        if name == "model.kmeans":
            assert stages[i - 1:i + 4] == [
                "model.match", "model.kmeans", "model.match", "model.decode",
                "pipeline.post"]


# hand-made records for the benchmark's readers: (name, start, end,
# correlation id, stream); graph launch 50; stream 8 has no mark
DEV = [("rvos_mark_extract", 0, 10, 50, 7),
       ("conv", 10, 40, 50, 7),
       ("rvos_mark_kmeans", 45, 47, 50, 7),       # gap 40-45: in the graph
       ("gemm", 47, 100, 50, 7),
       ("copy", 90, 95, 60, 8),                   # overlaps, unmarked
       ("rvos_mark_bank", 210, 215, 61, 7),       # gap 100-210: data.wait
       ("cat", 215, 330, 61, 7),
       ("rvos_mark_post", 350, 352, 62, 7),       # gap 330-350: flat
       ("memcpy", 352, 700, 62, 7),
       ("rvos_mark_match", 1100, 1101, 63, 7)]    # gap 700-1100: no span
LAUNCHES = [50]
# (name, start, end, id, parent, thread): the dispatch thread 1; thread 2
# (a loader thread) is not read
SPANS = [("pipeline.video", 0, 800, 0, -1, 1),
         ("data.wait", 100, 220, 1, 0, 1),
         ("pipeline.step.full", 300, 600, 2, 0, 1),
         ("pipeline.flat", 320, 380, 3, 2, 1),
         ("data.decode", 0, 2000, 9, -1, 2)]


def test_readers_attribute_stages_and_gaps():
    stages = readers.stage_ns(DEV)
    assert stages == {"extract": 40, "kmeans": 55, None: 5, "bank": 120,
                      "post": 350, "match": 1}
    assert sum(stages.values()) == sum(e - s for _, s, e, _, _ in DEV)
    idle = readers.idle_ns(DEV, LAUNCHES, SPANS)
    assert idle == {"graph": 5, "data": 110, "pipeline": 20, "unnamed": 400}
    lo, hi = DEV[0][1], max(e for _, _, e, _, _ in DEV)
    assert sum(idle.values()) == (hi - lo) - busy_ns(
        [(n, s, e) for n, s, e, _, _ in DEV], lo, hi)


def _program_idle_by_span():
    # as ``cli/profile_eval.py`` reads them: durations in us, the
    # correlation id last; spans as the program logs them
    records = [(n, s, (e - s) / 1e3, st, c) for n, s, e, c, st in DEV]
    return trace.idle_by_span(records, [trace.SpanRecord(*sp)
                                        for sp in SPANS], LAUNCHES)


@pytest.mark.parametrize("side", ["program", "benchmark"])
def test_idle_by_innermost_span(side):
    """The program's helper (``profile_eval``'s idle table) and the
    benchmark's reader (``span_run``'s) put each gap under the innermost
    span of the dispatch thread at its middle, or in its graph launch."""
    got = (_program_idle_by_span() if side == "program"
           else readers.idle_by_span(DEV, LAUNCHES, SPANS))
    assert got == {"graph": 5, "data.wait": 110, "pipeline.flat": 20,
                   None: 400}


def test_readers_on_a_window():
    ctx = {"kind": "eval", "window_s": 1.2e-6, "frames": 4,
           **readers.summary(DEV, LAUNCHES, SPANS)}
    got = {m: readers.reading(ctx, m) for m in readers.METRICS}
    assert got == pytest.approx({
        "model.extract_share": 100 * 40 / 1200,
        "model.match_share": 100 * 1 / 1200,
        "model.kmeans_share": 100 * 55 / 1200,
        "model.decode_share": 0.0,
        "pipeline.bank_ms_per_frame": 120 / 1e6 / 4,
        "device.graph_gap_share": 100 * 5 / 1200,
        "data.device_idle_share": 100 * 110 / 1200,
        "pipeline.device_idle_share": 100 * 20 / 1200,
        "device.idle_unnamed_share": 100 * 400 / 1200})
    # a program without spans or marks: every reading None
    plain = [(n if not n.startswith("rvos_mark") else "k", s, e, c, st)
             for n, s, e, c, st in DEV]
    bare = {"kind": "eval", "window_s": 1.2e-6, "frames": 4,
            **readers.summary(plain, LAUNCHES, [])}
    assert all(readers.reading(bare, m) is None for m in readers.METRICS)
    assert all(readers.reading({"kind": "eval", "window_s": 1.0}, m) is None
               for m in readers.METRICS)
