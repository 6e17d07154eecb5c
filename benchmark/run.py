"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The cell's traffic mix names its driver
(``drivers/<driver>.py``), which sets up, measures for ``--seconds`` and
checks the window's output against the plain reference.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` (a run of its own,
under ``torch.profiler``) its per-layer metrics, each read by
``metrics/<name>.py``, with ``device.busy_s``/``window_s`` and a
``breakdown``.  The last line of standard output is one JSON object;
``build_s``, in it and on standard error, is the part of ``setup_s``
spent building the program's kernels (all of them on a checkout's first
run, nothing after); the numbers the check compared, each beside its
limit, are the last lines of standard error and the line's last key.

Exits non-zero with no result line when no CUDA device is visible, when
fewer devices are visible than the cell asks for, and when JAX, flax or
the JAX package (``rvos_tpu``) is loaded in this process.  Build and
kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "rvos_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def set_caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def check_lines(check: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for every limited number."""
    return {k: {"value": check[k], "limit": lim} for k, lim in limits.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from .harness.manifest import ROOT, Cell, read_metrics
    set_caches(str(ROOT))
    cell = Cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell.chips}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    driver = importlib.import_module(f".drivers.{cell.mix['driver']}",
                                     __package__)
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda", setup_t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3

    ctx = res["ctx"]
    if args.trace:
        metrics = read_metrics(cell.per_layer, ctx)
    else:
        ctx["setup_s"] = res["setup_s"]
        metrics = read_metrics(cell.end_to_end, ctx)
    check = check_lines(res["check"], cell.limits)
    correct = all(c["value"] <= c["limit"] for c in check.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(res["peak"])}
    if args.trace:
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace and ctx.get("breakdown"):
        line["breakdown"] = ctx["breakdown"]
    line["build_s"] = res["build_s"]
    line["check"] = check
    if ctx.get("frame_ms"):
        ms = sorted(ctx["frame_ms"])
        q = statistics.quantiles(ms, n=100)
        print(f"frames {len(ms)} ms p50 {q[49]:.2f} p90 {q[89]:.2f} p95 "
              f"{q[94]:.2f} p98 {q[97]:.2f} max {ms[-1]:.2f}; over 150 ms "
              f"{sum(m > 150 for m in ms)}", file=sys.stderr)
    print(f"setup_s {res['setup_s']!r} of it build_s {res['build_s']!r}",
          file=sys.stderr)
    print("reference " + json.dumps(res["check"]), file=sys.stderr)
    for k, c in check.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
