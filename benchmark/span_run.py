"""One window of an eval cell with the program's spans and stage marks
switched on; traced, read by ``harness/spans.py``.

    python3 -m benchmark.span_run --workload <cell> --seed <n>
        --seconds <s> [--trace 0|1]

From the root of a checkout, on a card.  The cell runs as ``run.py``
runs it (the mix's ``drivers/`` module; with ``--trace 1``, the default,
under the profiler), with ``rvos_tpu_torch.utils.trace`` enabled before the
evaluator is built.  ``--trace 0`` measures what tracing switched on
costs: the line holds the cell's end-to-end metrics, to set beside
``run.py --trace 0`` (tracing off) on the same seed.  Traced, the spans
logged before the profiler starts (set-up's) are dropped; when it stops,
the span log and the profiler's records go to the readers.
``drivers/eval_videos.py`` does not call them itself, so this tool wraps
``harness.trace.start``/``stop`` for the run.  The last line of standard
output is one JSON object; traced, it holds:

* ``readings``: the nine readings of ``spans.METRICS``;
* ``metrics``: the cell's per-layer metrics, as ``run.py`` reads them;
* ``window_s``, ``busy_s``, ``frames``, ``records_ns`` (the device
  records' summed time), ``stage_ns`` (by stage, ``None`` unmarked; it
  sums to ``records_ns``), ``idle_ns`` (by cause; with the window's ends
  it is ``device.idle_share.eval``), ``idle_by_span`` (ns by the
  innermost span at each gap's middle), ``marks`` and ``marks_ns`` (the
  marks' own count and device time);
* ``correct`` and ``check``, the cell's check as ``run.py`` makes it
  (untraced, the line holds these and ``metrics``, the end-to-end ones).

Exits 2 with no line when no CUDA device is visible or the program has
no ``utils.trace``.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    from .harness import spans
    from .harness import trace as tr
    from .harness.manifest import ROOT, Cell, read_metrics
    from .run import check_lines, set_caches
    set_caches(str(ROOT))
    cell = Cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    try:
        from rvos_tpu_torch.utils import trace as program
    except ImportError:
        print("the program has no utils.trace", file=sys.stderr)
        return 2
    driver = importlib.import_module(f".drivers.{cell.mix['driver']}",
                                     __package__)
    got = {}
    start, stop = tr.start, tr.stop

    def start_spans():
        program.take()                  # set-up's spans
        return start()

    def stop_spans(prof):
        out = stop(prof)
        got["dev"], got["launches"] = spans.device_records(prof)
        got["spans"] = program.take()
        return out

    program.enable()
    if args.trace:
        tr.start, tr.stop = start_spans, stop_spans
    try:
        res = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", setup_t0=T0)
    finally:
        tr.start, tr.stop = start, stop
        program.disable()

    ctx = res["ctx"]
    check = check_lines(res["check"], cell.limits)
    correct = all(c["value"] <= c["limit"] for c in check.values())
    if not args.trace:
        ctx["setup_s"] = res["setup_s"]
        print(json.dumps({"metrics": read_metrics(cell.end_to_end, ctx),
                          "correct": correct, "check": check}), flush=True)
        return 0
    dev, launches, log = got["dev"], got["launches"], got["spans"]
    ctx.update(spans.summary(dev, launches, log))
    marks = [e - s for n, s, e, _, _ in dev if spans.MARK.search(n)]
    line = {
        "readings": {m: spans.reading(ctx, m) for m in spans.METRICS},
        "metrics": read_metrics(cell.per_layer, ctx),
        "window_s": ctx["window_s"], "busy_s": ctx["busy_s"],
        "frames": ctx["frames"],
        "records_ns": sum(e - s for _, s, e, _, _ in dev),
        "stage_ns": {str(k): v for k, v in (ctx["stage_ns"] or {}).items()},
        "idle_ns": ctx["idle_ns"],
        "idle_by_span": {str(k): v for k, v in
                         spans.idle_by_span(dev, launches, log).items()},
        "marks": len(marks), "marks_ns": sum(marks),
        "correct": correct, "check": check}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
