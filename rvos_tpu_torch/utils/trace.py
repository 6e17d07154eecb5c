"""The evaluator's tracing: host spans and device stage marks.

**Spans** time the evaluator's layers on the host.  A span's name starts
with its layer (``data.wait``, ``pipeline.flat``, ...); its start and end
are ``time.time_ns()``, the clock ``torch.profiler`` stamps its host
records with, so spans and the profiler's records share one timeline.
Switched off (the default) a span costs two clock reads and, given a
``totals`` dict, one add to it: the evaluator's ``timing`` is the
video's totals of its spans.  ``enable()`` (unless ``log=False``) also
appends every span to an in-memory log, with its parent (the span open
around it on its thread) and its thread, which ``take()`` returns and
clears; ``idle_by_span`` puts the device's idle gaps under the innermost
span open at each (``cli/profile_eval.py`` prints it).

**Stage marks** name the device's work.  ``stage(name, device)``
launches the stage's empty kernel (``csrc/stage_mark.cu``, named
``rvos_mark_<stage>``) on the device's current stream, when marks are on
and the device is a card; otherwise it does nothing.  A mark launched
while a CUDA graph is captured becomes a node of the graph, so a replay
shows its stages too.  Every device record belongs to the stage of the
last mark before it on its stream (``stage_times``).  ``enable()``
(unless ``marks=False``) switches marks on; it has to come before the
graphs are captured: a graph keeps the marks it was captured with.

No ``torch.profiler.record_function`` on this path: the profiler turns a
range that launches work into a device-typed annotation record, which a
reader of device records would count as device work.
"""

from __future__ import annotations

import bisect
import ctypes
import itertools
import re
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch

from ..ops import _cuda

STAGES = ("pipeline.upload", "pipeline.bank", "model.extract", "model.match",
          "model.kmeans", "model.decode", "pipeline.post", "model.lstt")
_INDEX = {s: i for i, s in enumerate(STAGES)}
MARK = re.compile(r"\brvos_mark_([a-z]+)\b")
_BY_MARK = {s.split(".", 1)[1]: s for s in STAGES}


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int       # the enclosing span's id on the same thread, or -1
    thread: int       # the OS thread id (``threading.get_native_id``)


_marks = False
_logging = False
_log: List[SpanRecord] = []
_ids = itertools.count()
_local = threading.local()
_mark_fn = None        # the library's launcher, loaded at the first mark


def enable(marks: bool = True, log: bool = True) -> None:
    """From now on launch stage marks (``marks``) and log spans
    (``log``): a caller that never calls ``take()`` asks for no log."""
    global _marks, _logging
    _marks, _logging = marks, log


def disable() -> None:
    """Back to the default: no log, no marks (graphs captured meanwhile
    keep theirs)."""
    enable(False, False)


def take() -> List[SpanRecord]:
    """The spans logged since the last call, in the order they ended."""
    global _log
    out, _log = _log, []
    return out


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """``with span(name[, totals, key]):`` — see the module docstring.
    ``seconds`` is the span's duration once it has closed."""

    __slots__ = ("name", "totals", "key", "t0", "t1", "id", "parent")

    def __init__(self, name: str, totals: Optional[Dict[str, float]] = None,
                 key: Optional[str] = None):
        self.name, self.totals, self.key = name, totals, key
        self.id = None

    def __enter__(self) -> "span":
        if _logging:
            stack = _stack()
            self.parent = stack[-1] if stack else -1
            self.id = next(_ids)
            stack.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.time_ns()
        if self.totals is not None:
            self.totals[self.key] += (self.t1 - self.t0) / 1e9
        if self.id is not None:
            _stack().pop()
            _log.append(SpanRecord(self.name, self.t0, self.t1, self.id,
                                   self.parent, threading.get_native_id()))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def stage(name: str, device) -> None:
    """Mark the start of stage ``name`` (one of ``STAGES``) on
    ``device``'s current stream, when marks are on and ``device`` is a
    card."""
    i = _INDEX[name]
    if _marks and device.type == "cuda":
        _launch(i, device)


def _launch(i: int, device) -> None:
    global _mark_fn
    if _mark_fn is None:
        fn = _cuda.load("stage_mark").rvos_mark_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        _mark_fn = fn
    _cuda.check(_mark_fn(i, torch.cuda.current_stream(device).cuda_stream),
                "stage mark")


def stage_of(kernel: str) -> Optional[str]:
    """The stage a device record named ``kernel`` marks, or None."""
    m = MARK.search(kernel)
    return _BY_MARK.get(m.group(1)) if m else None


def stage_times(records: Iterable) -> Dict[Optional[str], float]:
    """Device time by stage: ``records`` are ``(name, start, duration,
    stream, ...)`` device records; each belongs to the stage of the last mark
    before it on its stream, a mark's own time to its stage.  Records
    before any mark fall under None.  Durations are summed in their
    unit."""
    last: Dict = {}
    out: Dict[Optional[str], float] = {}
    for name, _, dur, stream, *_ in sorted(records, key=lambda r: r[1]):
        mark = stage_of(name)
        if mark is not None:
            last[stream] = mark
        st = last.get(stream)
        out[st] = out.get(st, 0) + dur
    return out


def idle_by_span(records: Sequence, spans: Sequence[SpanRecord],
                 graph_ids: Iterable[int] = ()) -> Dict[Optional[str], int]:
    """Device idle ns by the innermost span of the dispatch thread (the
    one that ran ``pipeline.video``) open at each gap's middle: ``records``
    are ``(name, start_ns, duration_us, stream, correlation id)`` device
    records in start order, gaps are taken between their merged busy
    intervals, and a gap whose two neighbouring records carry one of
    ``graph_ids`` (the correlation ids of graph launches) falls under
    ``"graph"``, a gap under no span under None."""
    threads = {sp.thread for sp in spans if sp.name == "pipeline.video"}
    mine = sorted((sp for sp in spans if sp.thread in threads),
                  key=lambda sp: sp.start_ns)
    starts = [sp.start_ns for sp in mine]
    by_id = {sp.id: sp for sp in mine}
    graphs = set(graph_ids)
    out: Dict[Optional[str], int] = {}
    last_end, last_corr = None, None
    for _, start, dur, _, corr in records:
        end = start + round(dur * 1e3)
        if last_end is not None and start > last_end:
            if corr == last_corr and corr in graphs:
                key = "graph"
            else:
                # the last span to start by the middle, else the nearest
                # of its ancestors still open (a thread's spans nest)
                t = (last_end + start) // 2
                i = bisect.bisect_right(starts, t) - 1
                sp = mine[i] if i >= 0 else None
                while sp is not None and sp.end_ns < t:
                    sp = by_id.get(sp.parent)
                key = sp.name if sp is not None else None
            out[key] = out.get(key, 0) + start - last_end
        if last_end is None or end > last_end:
            last_end, last_corr = end, corr
    return out
