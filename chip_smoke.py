#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rvos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit), the build of the
   three CUDA sources in ``rvos_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and the count of tensor-core instructions
   (``HMMA``/``HGMMA`` in ``cuobjdump -sass``) in each library: every
   library must have some;
2. each kernel against its plain PyTorch version at the shapes of the
   path that runs it, in float32 (max |Δ|/max(|d|, 1) ≤ 1e-4) and mixed
   precision (≤ 4e-3), with its time beside the plain version's, its
   bound and a library yardstick (the cross term as ``torch.matmul``:
   ``q @ rᵀ`` for the global kernels, each pixel's K×K window for
   kernel 2): kernel 1 (B.1) at the occupancy bank, kernel 1's uniform
   entry (B.2) at the uniform-quota bank, kernel 3 (B.3) at no cap and
   at the fg-union bank, kernel 2 (B.4); B.1 and B.4 again at the
   ensemble's largest scale (a 593×1041 frame: 38,889 query rows, a
   75×131 local grid);
3. the main path, the streaming evaluator's default pipeline with the
   full ``resnet101_aocnet`` preset (ResNet-101, 11 object channels,
   8-slot bank, 16,384-row occupancy bank, bf16 compute, mixed
   matching) and random weights from a seeded generator, on a 22-frame
   3-object synthetic video at 481×849: chunks of 5 frames replayed as
   CUDA graphs, with no host synchronisation per frame; then the same
   video frame by frame (``TEST_FRAME_CHUNK=1``).  For each: the steady
   wall time per frame over the full chunks after the first (CUDA events
   as each step is issued), the peak device memory, the graph captures
   and replays, the launch counters (set to 0 just before the run; a
   wrapper counts where it issues a launch, so a graph's kernels count
   at its warm-up and capture) and, from ``torch.profiler`` over a second
   run of the video, each kernel's count on every frame (a frame ends at
   its kernel-2 launch): the layout's global kernel and kernel 2 must run
   on every frame after the first.  A line before it gives the time of the
   default k-means draws (``ops.prng``) per frame;
3b. the graph path under each other bank layout — no cap
   (``MATCHING_MAX_REF_PIXELS=0``) and the fg-union bank
   (``MATCHING_SEGMENTED_BANK=False``) through kernel 3, the
   uniform-quota bank (``MATCHING_OCCUPANCY_BANK=False``) through B.2 —
   with the same checks, and kernel 1's occupancy entry never launched;
3c. the multi-scale + flip ensemble ("MF", the reference's headline
   setting: scales 1.0, 1.15 and 1.3 with flip, the long edge capped at
   800 before scaling) on the occupancy bank at full width, a 16-frame
   481×849 video in chunks of 5 (three graph replays, one capture), with
   the same checks and counts; the profiler must see kernel 1 and kernel
   2 once per variant (six times) on every frame after the first;
4. the slice at a small size in parity mode under each bank layout, on
   the card (kernels) against the CPU (plain versions), each frame and
   each bank compaction of the CPU computed from the card's state
   (``engine.lockstep``): the masks must agree on every frame and the
   compacted banks be identical; under the layouts of
   ``WHOLE_VIDEO_LAYOUTS`` two whole-video runs must agree as well.
   Then one more lock-step run per layout with mixed matching (float32
   compute, TF32 off for convolutions too), which holds the global
   kernels' tensor-core paths to the CPU's plain mixed versions; and the
   ensemble (scales 1.0 and 1.3 with flip, the occupancy bank) in
   lock-step, every variant's step repeated on the CPU, in both
   matching modes;
4b. the chunk step in lock-step at the same size, under each bank layout
   in float32 and mixed matching: a 7-frame video in chunks of 3 with
   the bank appending after each (``MEM_EVERY=3``), each chunk a graph
   replay on the card repeated eagerly on the CPU from copies of the
   same state (``engine.lockstep.lockstep_chunks``; the second chunk
   reads a refreshed bank); then the ensemble's chunks the same way, and
   its graph replays against eager runs on the card, which must be equal.

5. training (the port's own training route, which no kernel is on):
   5a. ``Trainer.fit`` at full ``resnet101_aocnet`` width on
   ``SyntheticTrain`` 465×465 clips with five objects (O = 6) through
   ``TrainBatcher`` (two loader threads), T = 5, batch 2, remat, float32
   (TF32 for convolutions only), burn-in from step 3, hard mining over 4
   steps, 5 steps: per step the loss, IoU, grad norm and learning rate,
   then the steady ms/step (median of steps 2–5, CUDA events), clips/s,
   the peak memory, and from ``torch.profiler`` over one more step the
   device busy ms, idle share and kernels per step; every loss and norm
   finite, the parameters moved, and the four kernels' launch counters
   (set to 0 before the run) still 0 after it;
   5b. card against CPU at 65×65, T = 2, batch 1, float32 with TF32 off
   (and as it was again afterwards), dropout 0, the same weights and
   draws, the burn-in off: one ``loss_fn`` with its gradients (per-frame
   losses within 1e-4 relative; each parameter tensor's gradient within
   1e-3 of its largest |g| or three times the CPU's own floor,
   ``engine.grad_check``, and all of them within 2e-2 relative L2; the
   decoder's top-β masks shared, each parted entry a near tie), then
   three optimizer steps from the same state (every parameter tensor
   within 1e-4 of its largest |p|, or three times the CPU's spread over
   four runs from weights ten ulps apart, own masks; the three updates
   themselves part by about half their size between those CPU runs, so
   this check has little power and the update's relative L2 is printed
   beside the CPU's), then the optimizer without that chaos: one more
   update on both sides from the CPU's state and the same gradients,
   every parameter tensor within 1e-6 of its largest |p|, and the same
   bar must catch the card applying no update and applying it at 1.01
   times the learning rate (``engine.grad_check.update_check``);
   5c. ``GlobalMatchingMin`` at M = R = 13,689, O = 6, C = 100 and
   ``LocalMatchingMin`` on the 59×59 grid with S = 2: card against CPU,
   forward within 1e-4 of max(|d|, 1), argmins equal wherever the two
   winners' float64 distances differ by more than 1e-4 relative, the
   backward from the card's argmins within 1e-4 of each gradient's
   largest magnitude; forward and backward ms.

``python3 chip_smoke.py --only 5`` runs phase 5 alone.

Every lock-step comparison with the CPU passes the gate of
``engine.lockstep.gate_failures``: masks agree on ≥ 99.9 % of every
frame, max |Δlogit| < 1e-2, and every pixel where they part is a near
tie (its CPU top-two margin below the frame's max |Δ|).  The ensemble's
CPU side goes on with the card's decoder top-β masks, each parted entry
a near tie (``share_masks``), and is run once more on its own masks for
the record (``/own_masks``, not gated); every other check keeps each
side's own masks.

The lines before the last are a JSON object of the kernels' numbers and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

F32_TOL, MIXED_TOL = 1e-4, 4e-3
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def _mma_count(lib) -> int:
    """Tensor-core instructions (HMMA, HGMMA) in a built library's SASS."""
    from rvos_tpu_torch.ops import _cuda
    tool = str(Path(_cuda._nvcc()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    return len(re.findall(r"\bH(?:G)?MMA\b", out))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _errs(got, want):
    d = (got - want).abs()
    return d.max().item(), (d / want.abs().clamp(min=1.0)).max().item()


def _bound_ms(n_bytes: float, flops: float, kind: str, f32_ops: float = 0.0):
    """max(bytes / HBM rate, flops at ``kind``'s peak + ``f32_ops`` at
    the float32 peak)."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[kind] + f32_ops / PEAK_FLOPS["f32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _bank(torch, shapes, seed):
    """Reference rows of 8 slots of one frame's grid with labels 0..3
    one-hot over the 11 object channels, and the query rows of a frame."""
    m, c, o, slots = shapes["m"], shapes["c"], shapes["o"], shapes["slots"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = torch.relu(torch.randn((slots * m, c), generator=g, device="cuda"))
    lab_id = torch.randint(0, 4, (slots * m,), generator=g, device="cuda")
    lab = torch.nn.functional.one_hot(lab_id, o).float()
    q = torch.relu(torch.randn((m, c), generator=g, device="cuda"))
    return emb, lab, q


def _measure(torch, name, mixed, kernel, plain, library, n_bytes, flops,
             shape, f32_ops=0.0, plain_reps=3, reps=10, live=None):
    """Hold ``kernel()`` to ``plain()`` (max |Δ|/max(|d|, 1) within the
    mode's tolerance; with ``live = (n, limit)``, exactly n object
    channels below ``limit``), then time the kernel, its plain version
    and ``library`` (None: no library call computes the function)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if live is not None and int((want < live[1]).all(0).sum()) != live[0]:
        raise AssertionError(f"{name}: not {live[0]} live channels")
    abs_err, rel_err = _errs(got, want)
    tol = MIXED_TOL if mixed else F32_TOL
    if not rel_err <= tol:
        raise AssertionError(f"{name} mixed={mixed}: rel err {rel_err:.3e} "
                             f"> {tol}")
    bound, by = _bound_ms(n_bytes, flops, "bf16" if mixed else "f32", f32_ops)
    return dict(max_abs_err=abs_err, rel_err=rel_err,
                ms=_time_ms(kernel, reps), plain_ms=_time_ms(plain, plain_reps),
                bound_ms=bound, bound_by=by,
                library_ms=_time_ms(library, reps) if library else None,
                shape=shape)


def _cross(torch, q, r, mixed, chunk):
    """The cross term ``q @ rᵀ`` in the operands' type, ``chunk`` bank rows
    per ``torch.matmul``: the library call beside the global kernels."""
    qd, rd = (q.bfloat16(), r.bfloat16()) if mixed else (q, r)

    def run():
        for s in range(0, rd.shape[0], chunk):
            torch.matmul(qd, rd[s:s + chunk].T)
    return run


def check_global(torch, ops, shapes, mixed: bool):
    """Kernel 1 at the main path's shapes: query rows of one frame and an
    occupancy bank compacted from 8 slots of 3-object labels."""
    from rvos_tpu_torch.ops.matching import compact_reference_bank_occupancy
    m, c, o = shapes["m"], shapes["c"], shapes["o"]
    emb, lab, q = _bank(torch, shapes, 1)
    r, rl, tile_obj = compact_reference_bank_occupancy(emb, lab, shapes["p"])
    p = r.shape[0]
    row_obj = tile_obj.long().repeat_interleave(p // tile_obj.shape[0])
    bias = (1.0 - rl.gather(1, row_obj[:, None])[:, 0]) * 5e4
    if mixed:
        q, r = q.bfloat16().float(), r.bfloat16().float()
    live = int(torch.bincount(tile_obj.long()).gt(0).sum())
    return _measure(
        torch, "global_seg_map", mixed,
        lambda: ops.global_seg_map(q, r, bias, tile_obj, o, mixed),
        lambda: ops.global_seg_map_plain(q, r, bias, tile_obj, o, mixed),
        _cross(torch, q, r, mixed, p),
        (m * c + p * c + p + m * o) * 4 + tile_obj.numel() * 4,
        2.0 * m * p * c, [m, p, c, o], live=(live, 5e4))


def check_uniform(torch, ops, shapes, mixed: bool):
    """B.2 (kernel 1 routed by equal quotas) at the uniform-quota bank
    compacted from 8 slots: quota 1024 per object, P = 11,264."""
    from rvos_tpu_torch.ops.matching import compact_reference_bank_segmented
    m, c, o = shapes["m"], shapes["c"], shapes["o"]
    emb, lab, q = _bank(torch, shapes, 3)
    r, rl = compact_reference_bank_segmented(emb, lab, shapes["p"])
    p = r.shape[0]
    own = rl.gather(1, torch.arange(o, device="cuda").repeat_interleave(
        p // o)[:, None])[:, 0]
    bias = (1.0 - own) * 5e4
    if mixed:
        q, r = q.bfloat16().float(), r.bfloat16().float()
    return _measure(
        torch, "global_seg", mixed,
        lambda: ops.global_seg(q, r, bias, o, mixed),
        lambda: ops.global_seg_plain(q, r, bias, o, mixed),
        _cross(torch, q, r, mixed, p), (m * c + p * c + p + m * o) * 4,
        2.0 * m * p * c, [m, p, c, o], live=(4, 5e4))


def check_flat(torch, ops, shapes, mixed: bool, fg_union: bool):
    """B.3 over a flat bank of 8 slots: every row (no cap, R = 206,184)
    or the fg-union compaction to 16,384 rows.  Its bound counts the
    cross term at the operands' rate and the penalised min at the float32
    rate: for one-hot-or-zero labels, as here, a min into A and one into
    the row's object per (query, bank row) pair (2·M·R); for general
    labels the O adds and mins of the general formula (2·M·R·O)."""
    from rvos_tpu_torch.ops.matching import compact_reference_bank
    m, c, o = shapes["m"], shapes["c"], shapes["o"]
    r, lab, q = _bank(torch, shapes, 4)
    if fg_union:
        r, lab = compact_reference_bank(r, lab, shapes["p"])
    n = r.shape[0]
    if mixed:
        q, r = q.bfloat16().float(), r.bfloat16().float()
    # the fg-union compaction keeps object rows first: background drops out
    live = int(lab.sum(0).gt(0).sum())
    one = lab == 1
    onehot = bool((((lab == 0) | one).all(1) & (one.sum(1) <= 1)).all())
    return _measure(
        torch, "global_flat_min", mixed,
        lambda: ops.global_flat_min(q, r, lab, mixed),
        lambda: ops.global_flat_min_plain(q, r, lab, mixed),
        _cross(torch, q, r, mixed, 16384), (m * c + n * c + n * o + m * o) * 4,
        2.0 * m * n * c, [m, n, c, o],
        f32_ops=2.0 * m * n * (1 if onehot else o),
        plain_reps=1, reps=10 if fg_union else 3, live=(live, 2.5e4))


def _band_cross(torch, x, ys, a_max, atrous):
    """The window's cross terms as one ``torch.matmul`` in the operands'
    type: each pixel's own K×K window [K, K, C], read from the zero-padded
    previous frames through a strided view [S, h, w, K, K, C], against its
    query row (the products the window needs, no more; the pad and the
    copy the product makes of the view included): the library call beside
    kernel 2."""
    s_n, h, w, c = ys.shape
    pad, k = a_max * atrous, 2 * a_max + 1

    def run():
        yp = torch.nn.functional.pad(ys, (0, 0, pad, pad, pad, pad))
        st = yp.stride()
        win = yp.as_strided((s_n, h, w, k, k, c),
                            (st[0], st[1], st[2], st[1] * atrous,
                             st[2] * atrous, st[3]))
        return torch.matmul(win, x[:, :, None, :, None])
    return run


def check_local(torch, ops, shapes, mixed: bool):
    """Kernel 2 at the main path's shapes: the 2×-downsampled grid, both
    previous embeddings in one launch, 11 object channels.  Its bound
    counts the cross term at the operands' rate and, at the float32
    rate, the epilogue's min into A and into B_o per in-frame (offset,
    pixel) pair of each previous frame (2·S·pairs)."""
    h, w, c, o = shapes["lh"], shapes["lw"], shapes["c"], shapes["o"]
    radii, atrous = shapes["radii"], shapes["atrous"]
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    dtype = torch.bfloat16 if mixed else torch.float32
    x = torch.relu(torch.randn((h, w, c), generator=g, device=dev)).to(dtype)
    ys = torch.relu(torch.randn((2, h, w, c), generator=g, device=dev)).to(dtype)
    lab = torch.randint(0, 4, (h, w), generator=g, device=dev)
    onehot = torch.nn.functional.one_hot(lab, o).float()
    a_max = radii[-1] // atrous
    pairs = sum(max(h - abs(dy) * atrous, 0) * max(w - abs(dx) * atrous, 0)
                for dy in range(-a_max, a_max + 1)
                for dx in range(-a_max, a_max + 1))      # in-frame only
    elt = x.element_size()
    return _measure(
        torch, "local_match", mixed,
        lambda: ops.local_match(x, ys, onehot, radii, atrous),
        lambda: ops.local_match_plain(x, ys, onehot, radii, atrous),
        _band_cross(torch, x, ys, a_max, atrous),
        3 * h * w * c * elt + h * w * o * 4 + 2 * h * w * o * len(radii) * 4,
        2.0 * 2 * c * pairs, [2, h, w, c, o, len(radii)],
        f32_ops=2.0 * 2 * pairs, plain_reps=1)


# the kernel wrapper that each bank layout's global stream launches
GLOBAL_KERNEL = {"occupancy": "global_seg_map", "uniform": "global_seg",
                 "unsegmented": "global_flat_min", "cap0": "global_flat_min"}
COUNTED = ("global_seg_map", "global_seg", "global_flat_min", "local_match")
# the kernels of the path as the profiler names them (kernel 1 serves
# B.1 and B.2; float32 and tensor-core variants alike)
PROFILED = {"global_seg_map": r"\bseg_map_(?:mma_)?kernel\b",
            "global_flat_min": r"\bflat_match_(?:mma_)?kernel\b",
            "local_match": r"\blocal_(?:mma|f32)_kernel\b",
            "dist_prep": r"\bprep::(?:query|bank)_kernel\b",
            "local_prep": r"\bprep_kernel\b",
            "flat_route": r"\bflat_(?:keys|tags)_kernel\b"}
PROFILED_GLOBAL = {"global_seg_map": "global_seg_map",
                   "global_seg": "global_seg_map",
                   "global_flat_min": "global_flat_min"}


def kernels_per_frame(torch, ev, seq):
    """Stream ``seq`` under ``torch.profiler`` → each profiled kernel's
    count on every frame after the first, in start order, a frame ending
    at its last kernel-2 launch (one per variant).  Filler kernels close
    the record (``profile_eval.pad_profile``) and must show in it."""
    from torch.profiler import ProfilerActivity, profile

    from rvos_tpu_torch.cli.profile_eval import FILLER, pad_profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev.evaluate_sequence(seq)
        torch.cuda.synchronize()
        pad_profile(torch)
    names = [e.name for e in sorted(
        (e for e in prof.events() if str(e.device_type).endswith("CUDA")),
        key=lambda e: e.time_range.start)]
    if not any(FILLER in n for n in names):
        raise AssertionError("the profiler lost the end of its record")
    n_var = len(ev.variants.flips)
    counts = {k: [0] for k in PROFILED}
    for name in names:
        for k, pat in PROFILED.items():
            if re.search(pat, name):
                counts[k][-1] += 1
        if counts["local_match"][-1] == n_var:
            for c in counts.values():
                c.append(0)
    return {k: c[:-1] for k, c in counts.items() if sum(c)}


def run_video(torch, ops, ev, seq, global_kernel, window):
    """Stream ``seq`` with every launch counter set to 0 just before and a
    CUDA event recorded as each frame's step is issued (no host
    synchronisation); then stream it again under the profiler.  The
    layout's global kernel and kernel 2 must have launched, and the
    profiler must see them on every frame after the first.  Returns the
    output and the numbers phase 3 prints."""
    from rvos_tpu_torch.cli.profile_eval import steady_frame_ms, video_steps
    ends = []

    def mark(f):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ends.append(e)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in COUNTED:
        getattr(ops, k).launches = 0
    replays0, captures0 = ev.replays, ev.captures
    out = ev.evaluate_sequence(seq, frame_callback=mark)
    launches = {k: getattr(ops, k).launches for k in COUNTED}
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replays, captures = ev.replays - replays0, ev.captures - captures0
    for k in (global_kernel, "local_match"):
        if launches[k] < 1:
            raise AssertionError(f"{k} never launched: {launches}")
    for k in ("global_seg_map", "global_seg", "global_flat_min"):
        if k != global_kernel and launches[k]:
            raise AssertionError(f"{k} launched off its layout: {launches}")
    results = out["results"]
    if len(results) != len(seq) - 1:
        raise AssertionError(f"{len(results)} masks for {len(seq) - 1} frames")
    for name, mask in results.items():
        if mask.shape != seq.size or mask.dtype.name != "uint8":
            raise AssertionError(f"{name}: mask {mask.shape} {mask.dtype}")
        if not set(mask.ravel().tolist()) <= {0, 1, 2, 3}:
            raise AssertionError(f"{name}: labels outside the 3 objects")
    for st in ev._last_states:
        for t in (st.prev_emb, st.memory.slots, st.ref_emb):
            if not torch.isfinite(t).all():
                raise AssertionError("non-finite values in the streaming state")
    lo, hi = window
    per_frame = steady_frame_ms(ends[:hi + 1], video_steps(ev, hi + 1), lo)
    steady_ms = ends[lo - 1].elapsed_time(ends[hi]) / (hi - lo + 1)
    profiled = kernels_per_frame(torch, ev, seq)
    n_var = len(ev.variants.flips)
    for k in (PROFILED_GLOBAL[global_kernel], "local_match"):
        got = profiled.get(k, [])
        if len(got) != len(seq) - 1 or min(got) < n_var:
            raise AssertionError(f"profiler: {k} per frame {got}")
    return dict(out=out, launches=launches, steady_ms=steady_ms,
                median_ms=sorted(per_frame)[len(per_frame) // 2],
                peak_gb=peak_gb, replays=replays, captures=captures,
                per_frame=profiled)


def _video_line(r) -> str:
    t = r["out"]["timing"]
    return (f"steady_ms_per_frame={r['steady_ms']:.2f} (median "
            f"{r['median_ms']:.2f}) peak_mem_gb={r['peak_gb']:.3f} "
            f"captures={r['captures']} replays={r['replays']} "
            f"wall_fps={r['out']['fps']:.2f} launch_counters={r['launches']} "
            f"timing_s={ {k: round(v, 4) for k, v in t.items()} } "
            f"profiler_kernels_per_frame={r['per_frame']}")


def _own_masks(lock, gate_failures) -> dict:
    """A lock-step run whose reference kept its own decoder masks, for the
    record beside the gated run that shares them."""
    return dict(lockstep=min(lock.agree), dlogit=lock.max_dlogit,
                masks_parted=lock.masks_parted,
                gate_failures=gate_failures(lock))


def _kernel_counters(ops):
    return {name: getattr(ops, name) for name in
            ("global_seg_map", "global_seg", "global_flat_min", "local_match")}


def train_full_width(torch, ops, card) -> dict:
    """Phase 5a: ``Trainer.fit`` at full width, counters from 0."""
    import tempfile

    from rvos_tpu_torch.cli.profile_train import profile_training, train_config
    counters = _kernel_counters(ops)
    with tempfile.TemporaryDirectory() as root:
        cfg = train_config(2, 5, root, DATA_MAX_OBJ_NUM=5)
        for fn in counters.values():
            fn.launches = 0
        r = profile_training(torch, cfg, 5)
        launches = {n: fn.launches for n, fn in counters.items()}
    for row in r["rows"]:
        print(f"phase 5a step {row['step']}: loss {row['loss']:.5f} IoU "
              f"{row['iou']:.4f} grad_norm {row['grad_norm']:.4f} lr "
              f"{row['lr']:.7f} applied {row['applied']} [{card}]",
              flush=True)
    bad = [row for row in r["rows"]
           if not all(map(lambda v: v == v and abs(v) != float("inf"),
                          (row["loss"], row["grad_norm"])))]
    if bad or r["moved"] == 0.0 or any(launches.values()):
        raise AssertionError(f"training: non-finite steps {bad}, parameters "
                             f"moved {r['moved']}, kernel launches "
                             f"{launches}")
    r["launches"] = launches
    return r


def train_card_vs_cpu(torch) -> dict:
    """Phase 5b: one loss_fn with gradients, then three steps, then one
    update from given gradients, card against CPU from the same weights,
    batch and draws, with TF32 off (as it was again afterwards)."""
    from rvos_tpu_torch.device import tf32_off

    with tf32_off():
        return _train_card_vs_cpu(torch)


def _train_card_vs_cpu(torch) -> dict:
    from rvos_tpu_torch.cli.train import train_transform
    from rvos_tpu_torch.configs import tiny_test
    from rvos_tpu_torch.data import SyntheticTrain, TrainBatcher
    from rvos_tpu_torch.engine.grad_check import (floors, gradient_failures,
                                                  perturbed_state,
                                                  update_check)
    from rvos_tpu_torch.engine.lockstep import _MaskWatch
    from rvos_tpu_torch.engine.train import Trainer, batch_to_device
    from rvos_tpu_torch.ops import prng

    cfg = tiny_test(DATA_RANDOMCROP=(65, 65), DATA_CURR_SEQ_LEN=2,
                    TRAIN_BATCH_SIZE=1, MODEL_ASPP_DROPOUT=0.0,
                    TRAIN_REMAT=False, TRAIN_START_SEQ_TRAINING_STEPS=10 ** 6,
                    TRAIN_HARD_MINING_STEP=4, TRAIN_TOTAL_STEPS=8,
                    MATCHING_DTYPE="float32", EVAL_COMPUTE_DTYPE="float32",
                    TRAIN_AUTO_RESUME=False)
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", init_state=cpu.model.state_dict())
    watch = _MaskWatch(gpu.model, cpu.model, True)
    data = SyntheticTrain(size=(65, 65), curr_len=2, obj_num=3, length=4)
    batches = list(TrainBatcher(data, 1, train_transform(cfg, True),
                                num_workers=1).epoch(0))
    run_key = prng.prng_key(prng.TRAIN_SEED)
    keys = []
    for _ in batches:
        run_key, k = prng.next_step_key(run_key)
        keys.append(k)

    def grads(tr, batch, key):
        tr.optimizer.zero_grad()
        loss, (losses, _, _) = tr._step_fn.loss_fn(
            batch_to_device(batch, tr.device), 3, key.to(tr.device))
        loss.backward()
        return (losses.detach().cpu(),
                {n: p.grad.detach().cpu() for n, p in
                 tr.model.named_parameters() if p.grad is not None})

    watch.begin(10 ** 9)
    g_losses, g_grads = grads(gpu, batches[0], keys[0])
    c_losses, c_grads = grads(cpu, batches[0], keys[0])
    names = [n for n, _ in cpu.model.named_parameters()]
    state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    runs = []
    for seed in range(3):
        cpu.model.load_state_dict(perturbed_state(state, names, seed))
        watch.begin(10 ** 9)
        runs.append(grads(cpu, batches[0], keys[0])[1])
    cpu.model.load_state_dict(state)
    rel = ((g_losses - c_losses).abs() / c_losses.abs()).max().item()
    bad, summary = gradient_failures(g_grads, c_grads,
                                     floors(c_grads, runs), 1e-3)
    out = {"loss_rel": rel, "losses": c_losses.tolist(), **summary,
           "masks_parted": watch.parted, "unexplained": watch.unexplained}
    if (rel > 1e-4 or bad or summary["all_l2_rel"] > 2e-2
            or watch.unexplained or set(g_grads) != set(c_grads)):
        raise AssertionError(f"training card vs CPU: {out} {bad[:10]}")

    def params(tr):
        return {n: p.detach().cpu().clone()
                for n, p in tr.model.named_parameters()}

    for batch, key in zip(batches[:3], keys[:3]):
        watch.begin(10 ** 9)
        gpu.train_step(batch, key)
        cpu.train_step(batch, key)
    runs = []
    for seed in range(4):
        tr = Trainer(cfg, device="cpu",
                     init_state=perturbed_state(state, names, 10 + seed))
        for batch, key in zip(batches[:3], keys[:3]):
            tr.train_step(batch, key)
        runs.append(params(tr))
    want, got = params(cpu), params(gpu)
    bad, summary = gradient_failures(got, want, floors(want, runs), 1e-4)
    moved = sum(float((want[n] - state[n]).square().sum()) for n in want)
    apart = sum(float((got[n] - want[n]).square().sum()) for n in want)
    spread = max(sum(float((r[n] - want[n]).square().sum()) for n in want)
                 for r in runs)
    out.update(steps={k: summary[k] for k in ("worst_rel", "held_by_floor")},
               update_l2_rel=(apart / moved) ** 0.5,
               floor_update_l2_rel=(spread / moved) ** 0.5,
               count=[gpu.optimizer.count, cpu.optimizer.count])
    if bad or gpu.optimizer.count != cpu.optimizer.count:
        raise AssertionError(f"training card vs CPU after 3 steps: {out} "
                             f"{bad[:10]}")
    # the optimizer alone, without the chaos: one more update from the
    # CPU's state and the first step's CPU gradients on both sides
    upd = update_check(gpu, cpu, c_grads)
    out["update"] = {k: upd[k] for k in ("worst_rel", "tensors",
                                         "no_update", "lr_1.01")}
    if upd["failures"] or not upd["no_update"] or not upd["lr_1.01"]:
        raise AssertionError(f"training card vs CPU, one update from the "
                             f"same gradients: {out} {upd['failures'][:10]}")
    return out


def train_functions(torch, card) -> dict:
    """Phase 5c: the training route's matching Functions at the full-width
    step's shapes, card against CPU."""
    import numpy as np

    from rvos_tpu_torch.ops import train_matching as tm

    rng = np.random.default_rng(5)
    out = {}

    def labels(shape, o):
        lab = rng.integers(0, o, (shape[0] // 8 + 1, shape[1] // 8 + 1))
        lab = np.kron(lab, np.ones((8, 8), np.int64))[:shape[0], :shape[1]]
        return torch.from_numpy((lab[..., None] == np.arange(o))
                                .astype(np.float32))

    # global: a 117x117 query grid against the 117x117 reference frame
    m = r = 117 * 117
    c, o = 100, 6
    q = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32))
    bank = torch.from_numpy(rng.standard_normal((r, c)).astype(np.float32))
    lab = labels((117, 117), o).reshape(r, o)
    g = torch.from_numpy(rng.standard_normal((m, o)).astype(np.float32))
    qd, bd, ld, gd = (t.cuda() for t in (q, bank, lab, g))
    d_card, a_card = tm.global_min_argmin(qd, bd, ld)
    dq, dr = tm.global_min_backward(qd, bd, a_card, gd)
    d_cpu, a_cpu = tm.global_min_argmin(q, bank, lab)
    dq_cpu, dr_cpu = tm.global_min_backward(q, bank, a_card.cpu(), g)
    fwd_ms = _time_ms(lambda: tm.global_min_argmin(qd, bd, ld), 5)
    bwd_ms = _time_ms(lambda: tm.global_min_backward(qd, bd, a_card, gd), 5)

    def d64(idx):
        rr = bank.double()[idx.reshape(-1)].reshape(m, o, c)
        pen = (1.0 - lab.double()[idx.reshape(-1), torch.arange(o).repeat(m)]
               ).reshape(m, o) * 5e4
        return (q.double()[:, None] - rr).square().sum(-1) + pen

    out["global"] = _function_check(torch, d_card, d_cpu, a_card.cpu(), a_cpu,
                                    d64, (dq, dr), (dq_cpu, dr_cpu), fwd_ms,
                                    bwd_ms)

    # local: the 117x117 grid downsampled to 59x59, both previous frames
    h = w = 59
    radii = (2, 4, 6, 8, 10, 12)
    x = torch.from_numpy(rng.standard_normal((h, w, c)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32))
    labl = labels((h, w), o)
    gl = torch.from_numpy(rng.standard_normal((2, h, w, o, len(radii)))
                          .astype(np.float32))
    xd, ysd, lbd, gld = (t.cuda() for t in (x, ys, labl, gl))
    l_card, i_card = tm.local_min_argmin(xd, ysd, lbd, radii)
    dx, dys = tm.local_min_backward(xd, ysd, lbd, i_card, gld, radii)
    l_cpu, i_cpu = tm.local_min_argmin(x, ys, labl, radii)
    dx_cpu, dys_cpu = tm.local_min_backward(x, ys, labl, i_card.cpu(), gl,
                                            radii)
    lfwd = _time_ms(lambda: tm.local_min_argmin(xd, ysd, lbd, radii), 5)
    lbwd = _time_ms(lambda: tm.local_min_backward(xd, ysd, lbd, i_card, gld,
                                                  radii), 5)
    pad, k = 12, 25
    yp = torch.nn.functional.pad(ys.double(), (0, 0, pad, pad, pad, pad))
    lp = torch.nn.functional.pad(labl.double(), (0, 0, pad, pad, pad, pad))

    def l64(idx):
        py = torch.arange(h)[None, :, None, None, None] + idx // k
        px = torch.arange(w)[None, None, :, None, None] + idx % k
        si = torch.arange(2)[:, None, None, None, None].expand_as(py)
        oi = torch.arange(o)[None, None, None, :, None].expand_as(py)
        dd = (x.double()[None, :, :, None, None] - yp[si, py, px]
              ).square().sum(-1)
        return torch.where(lp[py, px, oi] > 0.9, dd,
                           torch.full_like(dd, 5e4))

    out["local"] = _function_check(torch, l_card, l_cpu, i_card.cpu(), i_cpu,
                                   l64, (dx, dys), (dx_cpu, dys_cpu), lfwd,
                                   lbwd)
    return out


def _function_check(torch, d_card, d_cpu, a_card, a_cpu, d64, grads_card,
                    grads_cpu, fwd_ms, bwd_ms) -> dict:
    """Forward within 1e-4 of max(|d|, 1); argmins equal except where the
    two winners' float64 distances lie within 1e-4 relative; backward
    from the card's argmins within 1e-4 of each gradient's scale."""
    fwd = (d_card.cpu() - d_cpu).abs().div(d_cpu.abs().clamp(min=1.0)).max()
    parted = a_card != a_cpu
    far = 0
    if parted.any():
        da, db = d64(a_card), d64(a_cpu)
        far = int((parted & ((da - db).abs() > 1e-4 * db.abs().clamp(min=1.0))
                   ).sum())
    bwd = max(((gc.cpu() - gr).abs().max() / gr.abs().max()).item()
              for gc, gr in zip(grads_card, grads_cpu))
    out = {"fwd_rel": fwd.item(), "argmins_parted": int(parted.sum()),
           "parted_not_near_tie": far, "bwd_rel": bwd, "fwd_ms": fwd_ms,
           "bwd_ms": bwd_ms}
    if out["fwd_rel"] > 1e-4 or far or bwd > 1e-4:
        raise AssertionError(f"training Function card vs CPU: {out}")
    return out


def phase5(torch, ops, card):
    """Phase 5: training, at full width (5a), card against CPU (5b), the
    matching Functions at the step's shapes (5c)."""
    t0 = time.time()
    a = train_full_width(torch, ops, card)
    print(f"phase 5a training resnet101_aocnet 465x465 T=5 batch 2 O=6 remat "
          f"float32: steady {a['steady_ms']:.1f} ms/step (median of steps "
          f"2-5; steps {[round(t, 1) for t in a['step_ms']]}), "
          f"{a['clips_s']:.3f} clips/s, peak {a['peak_gb']:.3f} GB above "
          f"the {a['held_gb']:.3f} GB held before it, profiled "
          f"step: wall {a['profiled_wall_ms']:.1f} ms, device busy "
          f"{a['busy_ms']:.1f} ms, idle share {a['idle_share']:.3f}, "
          f"{a['kernels']} kernels; kernel launches while training "
          f"{a['launches']}; top kernels {a['top'][:8]}; took "
          f"{time.time() - t0:.1f} s [{card}]", flush=True)
    t0 = time.time()
    b = train_card_vs_cpu(torch)
    print(f"phase 5b training card vs cpu 65x65 T=2 batch 1 float32: {b}, "
          f"took {time.time() - t0:.1f} s [{card}]", flush=True)
    t0 = time.time()
    c = train_functions(torch, card)
    print(f"phase 5c GlobalMatchingMin M=R=13689 O=6 C=100, LocalMatchingMin "
          f"59x59 S=2 card vs cpu: {c}, took {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    p.add_argument("--only", choices=["5"], default=None,
                   help="run phase 5 (training) alone")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from rvos_tpu_torch import ops
    from rvos_tpu_torch.cli.profile_eval import video_steps
    from rvos_tpu_torch.configs import BANK_LAYOUTS, get_config
    from rvos_tpu_torch.data import SyntheticEval
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.engine.lockstep import (WHOLE_VIDEO_LAYOUTS,
                                                gate_failures,
                                                lockstep_chunks,
                                                lockstep_masks, parity_config,
                                                parity_scores,
                                                whole_video_agreement)
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.ops import _cuda
    from rvos_tpu_torch.ops.prng import kmeans_init_scores
    from rvos_tpu_torch.weights import init_random_

    # ---- phase 1: the card and the build
    card = _card()
    if args.only == "5":
        phase5(torch, ops, card)
        print(card)
        print(json.dumps({"phase5_only": True}))
        return 0
    t0 = time.time()
    paths = _cuda.build(["global_seg_map", "local_match", "global_flat_match"])
    built_s = time.time() - t0
    ptxas = []
    for name in paths:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
    mma = {name: _mma_count(path) for name, path in paths.items()}
    print(f"phase 1 card: {card} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | built "
          f"{len(paths)} kernels in {built_s:.1f} s | HMMA/HGMMA in SASS "
          f"{mma} | " + " ; ".join(ptxas), flush=True)
    for name in paths:
        if not mma[name]:
            raise AssertionError(f"{name}: no tensor-core instruction in SASS")

    # ---- phase 2: kernels vs plain versions at their paths' shapes
    t0 = time.time()
    cfg = get_config("resnet101_aocnet")
    frame_hw = (481, 849)
    h4, w4 = 121, 213                 # ResNet stride-4 grid of 481×849
    shapes = dict(m=h4 * w4, c=cfg.MODEL_SEMANTIC_EMBEDDING_DIM,
                  o=cfg.MODEL_MAX_OBJ_NUM, slots=cfg.TEST_BANK_CAPACITY,
                  p=cfg.MATCHING_MAX_REF_PIXELS, lh=h4 // 2 + 1,
                  lw=w4 // 2 + 1, radii=tuple(cfg.MODEL_MULTI_LOCAL_DISTANCE),
                  atrous=cfg.TEST_LOCAL_ATROUS_RATE)
    # the ensemble's largest scale: 481×849 capped at 800 and scaled by
    # 1.3 is a 593×1041 frame, a 149×261 grid
    mf_shapes = dict(shapes, m=149 * 261, lh=149 // 2 + 1, lw=261 // 2 + 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for mixed in (False, True):
        res[("global", mixed)] = check_global(torch, ops, shapes, mixed)
        res[("uniform", mixed)] = check_uniform(torch, ops, shapes, mixed)
        res[("flat", mixed)] = check_flat(torch, ops, shapes, mixed, False)
        res[("flat_fg", mixed)] = check_flat(torch, ops, shapes, mixed, True)
        res[("local", mixed)] = check_local(torch, ops, shapes, mixed)
        res[("global_mf", mixed)] = check_global(torch, ops, mf_shapes, mixed)
        res[("local_mf", mixed)] = check_local(torch, ops, mf_shapes, mixed)
    for (k, mixed), r in res.items():
        print(f"phase 2 {k} {'mixed' if mixed else 'f32'} shape={r['shape']}: "
              f"max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']} [{card}]", flush=True)
    print(f"phase 2 took {time.time() - t0:.1f} s", flush=True)

    # ---- phase 3: the main path, graph replays then frame by frame; the
    # default k-means draws first, one block as the evaluator draws it
    rows, n_obj = cfg.MATCHING_MAX_REF_PIXELS, cfg.MODEL_MAX_OBJ_NUM
    block = max(1, min(32, (1 << 21) // (n_obj * rows)))
    draw_ms = _time_ms(lambda: kmeans_init_scores(range(block), n_obj, rows,
                                                  "cuda"), 10)
    t0 = time.time()
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
    seq = SyntheticEval(size=frame_hw, n_seqs=1, n_frames=22, obj_num=3)[0]
    ev = Evaluator(cfg, model, device="cuda")
    steps = [s for s in video_steps(ev, len(seq)) if len(s) == ev.chunk_n]
    window = (steps[1][0], steps[-1][-1])   # the full chunks after the first
    main = run_video(torch, ops, ev, seq, "global_seg_map", window)
    out = main["out"]
    labels = sorted({int(v) for m in out["results"].values()
                     for v in set(m.ravel())})
    print(f"phase 3 k-means draws (threefry, the JAX evaluator's): "
          f"{draw_ms:.4f} ms per block of {block} frames x {n_obj} objects "
          f"x {rows} rows, {draw_ms / block:.4f} ms a frame = "
          f"{draw_ms / block / main['steady_ms']:.4%} of the steady frame "
          f"[{card}]", flush=True)
    print(f"phase 3 main path resnet101_aocnet {frame_hw[0]}x{frame_hw[1]} "
          f"22 frames, chunks of {ev.chunk_n} as CUDA graphs, steady frames "
          f"{window[0]}-{window[1]}: {_video_line(main)} labels={labels} "
          f"took {time.time() - t0:.1f} s [{card}]", flush=True)
    if main["replays"] != len(steps) or main["captures"] != 1:
        raise AssertionError(f"{main['replays']} replays and "
                             f"{main['captures']} captures for {len(steps)} "
                             f"full chunks")
    del ev
    t0 = time.time()
    pcfg = cfg.replace(TEST_FRAME_CHUNK=1)
    pmodel = AOCNet(pcfg)
    pmodel.load_state_dict(model.state_dict())
    pev = Evaluator(pcfg, pmodel, device="cuda")
    per = run_video(torch, ops, pev, seq, "global_seg_map", window)
    agree = [round(float((per["out"]["results"][k] == m).mean()), 4)
             for k, m in sorted(out["results"].items())]
    print(f"phase 3 frame by frame (TEST_FRAME_CHUNK=1), same video: "
          f"{_video_line(per)} per-frame mask agreement with the graph path "
          f"(batch-5 and batch-1 bf16 convolutions round differently) "
          f"{agree} took {time.time() - t0:.1f} s [{card}]", flush=True)
    del pev, pmodel

    # ---- phase 3b: the other bank layouts, graph path, counters from 0
    layout_launches = {}
    for name, kw in BANK_LAYOUTS.items():
        if not kw:
            continue
        t0 = time.time()
        lcfg = cfg.replace(**kw)
        lmodel = AOCNet(lcfg)
        lmodel.load_state_dict(model.state_dict())
        lev = Evaluator(lcfg, lmodel, device="cuda")
        r = run_video(torch, ops, lev, seq, GLOBAL_KERNEL[name], window)
        layout_launches[name] = r["launches"]
        print(f"phase 3b layout {name} ({kw}) resnet101_aocnet "
              f"{frame_hw[0]}x{frame_hw[1]} 22 frames, graph path: "
              f"{_video_line(r)} took {time.time() - t0:.1f} s [{card}]",
              flush=True)
        del lev, lmodel

    # ---- phase 3c: the multi-scale + flip ensemble, graph path
    t0 = time.time()
    mcfg = cfg.replace(TEST_MULTISCALE=(1.0, 1.15, 1.3), TEST_FLIP=True,
                       TEST_MAX_SIZE=800.0)
    mmodel = AOCNet(mcfg)
    mmodel.load_state_dict(model.state_dict())
    mev = Evaluator(mcfg, mmodel, device="cuda")
    mseq = SyntheticEval(size=frame_hw, n_seqs=1, n_frames=16, obj_num=3)[0]
    msteps = [s for s in video_steps(mev, len(mseq)) if len(s) == mev.chunk_n]
    mwindow = (msteps[1][0], msteps[-1][-1])
    mf = run_video(torch, ops, mev, mseq, "global_seg_map", mwindow)
    shapes_mf = sorted({tuple(st.prev_lab.shape) for st in mev._last_states})
    print(f"phase 3c ensemble (scales {mcfg.TEST_MULTISCALE}, flip, long edge "
          f"800) resnet101_aocnet {frame_hw[0]}x{frame_hw[1]} 16 frames, "
          f"{len(mev.variants.flips)} variants on grids {shapes_mf}, chunks "
          f"of {mev.chunk_n} as CUDA graphs, steady frames {mwindow[0]}-"
          f"{mwindow[1]}: {_video_line(mf)} took {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)
    if mf["replays"] != len(msteps) or mf["captures"] != 1:
        raise AssertionError(f"{mf['replays']} replays and {mf['captures']} "
                             f"captures for {len(msteps)} full chunks")
    del mev, mmodel

    # ---- phase 4: small-size reference check, card vs CPU, parity
    # setting; float32 matching, then mixed matching (tensor-core paths);
    # then the ensemble (scales 1.0 and 1.3 with flip: 65×65 and 81×81)
    def mf_config(matching, chunk=1):
        return parity_config("occupancy", matching).replace(
            TEST_FLIP=True, TEST_MULTISCALE=(1.0, 1.3), TEST_FRAME_CHUNK=chunk,
            MEM_EVERY=3 if chunk > 1 else 2)

    def seeded(c):
        return lambda: init_random_(AOCNet(c), torch.Generator().manual_seed(0))

    def make_seq(n=6):
        return SyntheticEval(size=(65, 65), n_seqs=1, n_frames=n)[0]

    t0 = time.time()
    agree = {}
    cases = [(name, matching, parity_config(name, matching))
             for name in BANK_LAYOUTS for matching in ("float32", "mixed")]
    cases += [("ensemble", m, mf_config(m)) for m in ("float32", "mixed")]
    for name, matching, small in cases:
        lock = lockstep_masks(small, seeded(small), make_seq(), parity_scores,
                              share_masks=name == "ensemble")
        whole = None
        if name in WHOLE_VIDEO_LAYOUTS and matching == "float32":
            whole = whole_video_agreement(small, seeded(small), make_seq,
                                          parity_scores)
        key = f"{name}/{matching}"
        n_var = 4 if name == "ensemble" else 1
        agree[key] = dict(lockstep=min(lock.agree), dlogit=lock.max_dlogit,
                          demb=lock.max_demb, unexplained=lock.unexplained,
                          masks_parted=lock.masks_parted,
                          banks=lock.banks_equal,
                          whole_video=min(whole) if whole else None)
        failed = gate_failures(lock)
        if (failed or len(lock.agree) != 5 * n_var or lock.max_demb >= 1e-3
                or not lock.banks_equal or not all(lock.banks_equal)
                or (whole is not None and (len(whole) != 5
                                           or min(whole) < 0.999))):
            raise AssertionError(f"{key}: card vs CPU: {agree[key]} {failed}, "
                                 f"lock-step frames {lock.agree}, whole "
                                 f"video {whole}")
        if name == "ensemble":
            # the same run with the CPU on its own decoder masks: reported,
            # not gated (a parted top-beta entry moves the logits)
            own = lockstep_masks(small, seeded(small), make_seq(),
                                 parity_scores)
            agree[key + "/own_masks"] = _own_masks(own, gate_failures)
    print(f"phase 4 small parity setting card vs cpu, float32 and mixed "
          f"matching, then the ensemble (every variant's step), each through "
          f"the gate (min per-frame agreement in lock-step and whole-video "
          f"runs, max |dlogit|, max |demb|, parted pixels and decoder mask "
          f"entries that are no near tie, decoder mask entries parted "
          f"(shared with the CPU in the ensemble's gated runs only), bank "
          f"compactions identical; '/own_masks': the ensemble with the CPU "
          f"on its own masks, not gated): {agree}, took "
          f"{time.time() - t0:.1f} s", flush=True)

    # ---- phase 4b: the chunk step, card graph replays vs CPU eager runs;
    # the ensemble's also against eager runs on the card (bit for bit)
    t0 = time.time()
    chunked = {}
    cases = [(name, matching, "cpu",
              parity_config(name, matching).replace(TEST_FRAME_CHUNK=3,
                                                    MEM_EVERY=3))
             for name in BANK_LAYOUTS for matching in ("float32", "mixed")]
    cases += [("ensemble", m, ref, mf_config(m, chunk=3))
              for m in ("float32", "mixed") for ref in ("cpu", "cuda")]
    for name, matching, ref, small in cases:
        shared = name == "ensemble" and ref == "cpu"
        lock = lockstep_chunks(small, seeded(small), make_seq(7),
                               parity_scores, ref_device=ref,
                               share_masks=shared)
        key = f"{name}/{matching}" + ("/card_eager" if ref == "cuda" else "")
        chunked[key] = dict(lockstep=min(lock.agree),
                            dlogit=lock.max_dlogit, demb=lock.max_demb,
                            unexplained=lock.unexplained,
                            masks_parted=lock.masks_parted, steps=lock.steps,
                            replays=lock.replays)
        failed = gate_failures(lock)
        if ref == "cuda" and not (lock.agree == [1.0] * 6
                                  and lock.max_dlogit == 0.0):
            failed.append("graph replay differs from the eager chunk")
        if (failed or len(lock.agree) != 6 or lock.steps != [3, 3]
                or lock.replays != 2 or lock.max_demb >= 1e-3):
            raise AssertionError(f"{key}: chunk lock-step {chunked[key]} "
                                 f"{failed}, frames {lock.agree}")
        if shared:
            own = lockstep_chunks(small, seeded(small), make_seq(7),
                                  parity_scores, ref_device=ref)
            chunked[key + "/own_masks"] = _own_masks(own, gate_failures)
    print(f"phase 4b chunk step in lock-step, card graph replays vs cpu eager "
          f"(and, for the ensemble, vs eager on the card), 7 frames in chunks "
          f"of 3, through the gate (min per-frame agreement, max |dlogit|, "
          f"max |demb|, parted pixels and mask entries that are no near tie, "
          f"mask entries parted (shared with the CPU in the ensemble's gated "
          f"runs only), steps, replays; '/own_masks' as in phase 4, not "
          f"gated): "
          f"{chunked}, took {time.time() - t0:.1f} s", flush=True)

    phase5(torch, ops, card)

    kernels = []
    for key, name, src, rep, n in (
            ("global", "global_seg_map", "rvos_tpu_torch/csrc/global_seg_map.cu",
             "rvos_tpu/ops/pallas_matching.py:136",
             main["launches"]["global_seg_map"]),
            ("uniform", "global_seg", "rvos_tpu_torch/csrc/global_seg_map.cu",
             "rvos_tpu/ops/pallas_matching.py:87",
             layout_launches["uniform"]["global_seg"]),
            ("flat", "global_flat_min",
             "rvos_tpu_torch/csrc/global_flat_match.cu",
             "rvos_tpu/ops/pallas_matching.py:47",
             layout_launches["cap0"]["global_flat_min"]),
            ("local", "local_match", "rvos_tpu_torch/csrc/local_match.cu",
             "rvos_tpu/ops/pallas_local.py:39", main["launches"]["local_match"])):
        r, rp = res[(key, True)], res[(key, False)]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "mode": "mixed", "shape": r["shape"],
            "f32_max_abs_err": rp["max_abs_err"], "f32_ms": rp["ms"],
            "f32_plain_ms": rp["plain_ms"], "f32_bound_ms": rp["bound_ms"],
            "f32_library_ms": rp["library_ms"]}
        if key in ("global", "local"):
            rm, rmp = res[(key + "_mf", True)], res[(key + "_mf", False)]
            entry.update({
                "ensemble_launches": mf["launches"][name],
                "ensemble_shape": rm["shape"],
                "ensemble_max_abs_err": rm["max_abs_err"],
                "ensemble_ms": rm["ms"], "ensemble_plain_ms": rm["plain_ms"],
                "ensemble_bound_ms": rm["bound_ms"],
                "ensemble_library_ms": rm["library_ms"],
                "ensemble_f32_ms": rmp["ms"],
                "ensemble_f32_plain_ms": rmp["plain_ms"],
                "ensemble_f32_bound_ms": rmp["bound_ms"],
                "ensemble_f32_library_ms": rmp["library_ms"]})
        if key == "flat":
            rf, rfp = res[("flat_fg", True)], res[("flat_fg", False)]
            entry.update({
                "fg_union_launches":
                    layout_launches["unsegmented"]["global_flat_min"],
                "fg_union_shape": rf["shape"],
                "fg_union_max_abs_err": rf["max_abs_err"],
                "fg_union_ms": rf["ms"], "fg_union_plain_ms": rf["plain_ms"],
                "fg_union_bound_ms": rf["bound_ms"],
                "fg_union_library_ms": rf["library_ms"],
                "fg_union_f32_ms": rfp["ms"],
                "fg_union_f32_plain_ms": rfp["plain_ms"],
                "fg_union_f32_bound_ms": rfp["bound_ms"],
                "fg_union_f32_library_ms": rfp["library_ms"]})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
