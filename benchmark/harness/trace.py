"""The device trace of a window: ``torch.profiler`` records read raw.

Copied from the port's ``cli/profile_eval.py`` (``device_records``,
``pad_profile``): records are read straight from the kineto result, and
a filler of tiny kernels queued just before the profiler stops keeps
it from dropping its last, partly filled buffer of device records.  The
filler is left out of every sum, and a trace in which none of it shows
is refused.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

FILLER = "spin_kernel"


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.__enter__()
    return prof


def pad_profile(torch, n: int = 50_000) -> None:
    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def stop(prof) -> Tuple[List, List]:
    """Stop ``prof`` (after the filler) → (device records, host records),
    each ``(name, start_ns, end_ns)`` in start order, the filler left
    out."""
    import torch
    from torch._C import _demangle
    from torch.autograd import DeviceType
    pad_profile(torch)
    prof.__exit__(None, None, None)
    names: Dict[str, str] = {}
    dev, host = [], []
    filler = 0
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        if raw not in names:
            names[raw] = _demangle(raw)
        row = (names[raw], e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if FILLER in row[0]:
                filler += 1
                continue
            dev.append(row)
        else:
            host.append(row)
    if not filler:
        raise RuntimeError("the profiler lost the end of its record")
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return dev, host


def busy_ns(dev: List, lo: int, hi: int) -> int:
    """The time within [lo, hi) in which some device record ran."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def top_ops(dev: List, n: int = 10) -> List:
    """The device operations with the most time: [[name, seconds]]."""
    acc: Dict[str, int] = {}
    for name, s, e in dev:
        acc[name] = acc.get(name, 0) + (e - s)
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(dev: List, host: List, lo: int, hi: int, n: int = 10) -> List:
    """The longest gaps between device records within [lo, hi), each
    named by the innermost host operation running at its middle (or
    ``host idle``): [[name, seconds]]."""
    gaps, last = [], lo
    for _, s, e in dev:
        if s > last:
            gaps.append((s - last, last, s))
        last = max(last, e)
    if hi > last:
        gaps.append((hi - last, last, hi))
    gaps.sort(reverse=True)
    starts = [r[1] for r in host]
    out = []
    for length, s, e in gaps[:n]:
        mid = (s + e) // 2
        best = None
        i = bisect.bisect_right(starts, mid)
        for name, hs, he in host[max(0, i - 5000):i]:
            if he >= mid and (best is None or he - hs < best[1]):
                best = (name, he - hs)
        out.append([(best[0] if best else "host idle")[:120], length / 1e9])
    return out
