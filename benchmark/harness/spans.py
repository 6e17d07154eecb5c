"""The program's spans and device stage marks, read with the window's
profiler records.

The program (``rvos_tpu_torch.utils.trace``), once ``enable()``d before
its evaluator is built, logs host spans named by layer (``data.wait``,
``pipeline.flat``, ``pipeline.step.full``, ... inside ``pipeline.video``,
which marks the dispatch thread) on ``time.time_ns()``, the profiler's
host clock, and launches an empty kernel named ``rvos_mark_<stage>``
where each stage of its device work starts, in graph replays too.  The
attribution below is the benchmark's own, so that no change to the
program can move it:

* ``window(prof, spans)``, after ``harness.trace.stop(prof)``: the
  summary an eval window's ``ctx`` takes.  It reads the kineto result again
  (``device_records``) for what ``stop`` leaves out (each device record's
  correlation id and stream, and the correlation ids of
  ``cudaGraphLaunch`` host records).
* ``stage_ns``: device time by stage; a record belongs to the stage of
  the last mark before it on its stream, a mark's own time to its stage,
  records before any mark to None.
* ``idle_ns``: the gaps between merged busy intervals (as
  ``harness.trace.busy_ns`` merges them, from the first record's start
  to the last end) by cause: ``graph`` when the records on both sides of
  the gap carry one ``cudaGraphLaunch``'s correlation id (a bubble
  inside a replay); else the layer of the innermost span of the dispatch
  thread at the gap's middle, ``data`` or ``pipeline``; else
  ``unnamed`` (between videos, or code no span covers).
* ``idle_by_span``: the same gaps by the name of that innermost span
  (``graph`` for a bubble inside a replay, None under no span).
* ``reading(ctx, metric)``: one metric's value; None where the program
  logged no span or launched no mark (a program without them).

``drivers/eval_videos.py`` does not call ``window`` yet;
``benchmark/span_run.py`` runs a traced window of an eval cell with the
program's spans and marks on and prints what these readers make of it.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence

FILLER = "spin_kernel"
MARK = re.compile(r"\brvos_mark_([a-z]+)\b")
CAUSES = ("graph", "data", "pipeline", "unnamed")

# metric -> the stage mark whose device time it reads, as % of the window
STAGE_SHARES = {"model.extract_share": "extract",
                "model.match_share": "match",
                "model.kmeans_share": "kmeans",
                "model.decode_share": "decode"}
# metric -> the cause of the idle gaps it reads, as % of the window
IDLE_SHARES = {"device.graph_gap_share": "graph",
               "data.device_idle_share": "data",
               "pipeline.device_idle_share": "pipeline",
               "device.idle_unnamed_share": "unnamed"}
BANK_MS = "pipeline.bank_ms_per_frame"
METRICS = (*STAGE_SHARES, BANK_MS, *IDLE_SHARES)


def window(prof, spans: Sequence) -> Dict:
    """``{"stage_ns", "idle_ns"}`` of a stopped profiler run and the
    program's span log (``(name, start_ns, end_ns, id, parent, thread)``
    each); either is None where the run has no mark or no span."""
    return summary(*device_records(prof), spans)


def device_records(prof):
    """A stopped profiler run → (device records ``(name, start_ns,
    end_ns, correlation id, stream)`` in start order, filler left out;
    the correlation ids of its graph launches)."""
    from torch._C import _demangle
    from torch.autograd import DeviceType
    names: Dict[str, str] = {}
    dev, launches = [], []
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        if e.device_type() == DeviceType.CUDA:
            if raw not in names:
                names[raw] = _demangle(raw)
            if FILLER in names[raw]:
                continue
            s = e.start_ns()
            dev.append((names[raw], s, s + e.duration_ns(),
                        e.correlation_id(), e.device_resource_id()))
        elif raw.startswith("cudaGraphLaunch"):
            launches.append(e.correlation_id())
    dev.sort(key=lambda r: r[1])
    return dev, launches


def summary(dev: List, launches: Sequence[int], spans: Sequence) -> Dict:
    """``window``'s result from device records ``(name, start_ns, end_ns,
    correlation id, stream)`` in start order, the correlation ids of the
    graph launches and the span log."""
    stages = stage_ns(dev)
    return {"stage_ns": stages if set(stages) - {None} else None,
            "idle_ns": idle_ns(dev, launches, spans) if spans else None}


def stage_ns(dev: List) -> Dict[Optional[str], int]:
    """Device ns by stage (the mark's name after ``rvos_mark_``); records
    in start order."""
    last: Dict = {}
    out: Dict[Optional[str], int] = {}
    for name, s, e, _, stream in dev:
        m = MARK.search(name)
        if m:
            last[stream] = m.group(1)
        k = last.get(stream)
        out[k] = out.get(k, 0) + (e - s)
    return out


class _Innermost:
    """The innermost span of the dispatch thread open at a time."""

    def __init__(self, spans: Sequence):
        threads = {sp[5] for sp in spans if sp[0] == "pipeline.video"}
        self.spans = sorted((sp for sp in spans if sp[5] in threads),
                            key=lambda sp: sp[1])
        self.starts = [sp[1] for sp in self.spans]
        self.by_id = {sp[3]: sp for sp in self.spans}

    def at(self, t: int):
        # the last span to start by t, else the nearest of its ancestors
        # still open (spans of one thread nest)
        i = bisect.bisect_right(self.starts, t) - 1
        sp = self.spans[i] if i >= 0 else None
        while sp is not None and sp[2] < t:
            sp = self.by_id.get(sp[4])
        return sp


def _gaps(dev: List, launches: Sequence[int], spans: Sequence):
    """Each gap between the merged busy intervals of ``dev`` (in start
    order) → (ns, ``"graph"`` for a gap inside one graph launch, else the
    innermost span of the dispatch thread at its middle or None)."""
    graphs = set(launches)
    inner = _Innermost(spans)
    if not dev:
        return
    last = dev[0]            # the record that reaches furthest so far
    for rec in dev[1:]:
        if rec[1] > last[2]:
            if last[3] == rec[3] and last[3] in graphs:
                yield rec[1] - last[2], "graph"
            else:
                yield rec[1] - last[2], inner.at((last[2] + rec[1]) // 2)
        if rec[2] > last[2]:
            last = rec


def idle_ns(dev: List, launches: Sequence[int], spans: Sequence
            ) -> Dict[str, int]:
    """Idle ns between the first record's start and the last end, by
    cause (``CAUSES``); records in start order."""
    out = dict.fromkeys(CAUSES, 0)
    for ns, sp in _gaps(dev, launches, spans):
        if sp == "graph":
            out["graph"] += ns
            continue
        layer = sp[0].split(".", 1)[0] if sp is not None else ""
        out[layer if layer in ("data", "pipeline") else "unnamed"] += ns
    return out


def idle_by_span(dev: List, launches: Sequence[int], spans: Sequence
                 ) -> Dict[Optional[str], int]:
    """``idle_ns``'s gaps by the innermost span's name."""
    out: Dict[Optional[str], int] = {}
    for ns, sp in _gaps(dev, launches, spans):
        key = sp if sp == "graph" or sp is None else sp[0]
        out[key] = out.get(key, 0) + ns
    return out


def reading(ctx: Dict, metric: str) -> Optional[float]:
    """``metric`` (one of ``METRICS``) from a traced eval window's ctx."""
    if ctx.get("kind") != "eval":
        return None
    window_ns = ctx["window_s"] * 1e9
    if metric in IDLE_SHARES:
        idle = ctx.get("idle_ns")
        return None if idle is None else (
            100.0 * idle[IDLE_SHARES[metric]] / window_ns)
    stages = ctx.get("stage_ns")
    if stages is None:
        return None
    if metric == BANK_MS:
        return stages.get("bank", 0) / 1e6 / ctx["frames"]
    return 100.0 * stages.get(STAGE_SHARES[metric], 0) / window_ns
