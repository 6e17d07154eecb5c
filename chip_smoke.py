#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rvos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit), the build of the
   four CUDA sources in ``rvos_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together) and the count of tensor-core instructions
   (``HMMA``/``HGMMA`` in ``cuobjdump -sass``) in each matching library:
   every one must have some; and the registers, spill bytes (ptxas) and
   ``FFMA`` count (SASS) of the float32 kernels of kernels 1 and 3
   (``seg_map_kernel``, ``flat_match_kernel``) and of the k-means
   kernel's mixed K = 16 pass (``assign_kernel<4, true>``), which must
   have FFMAs;
2. each kernel against its plain PyTorch version at the shapes of the
   path that runs it, in float32 (max |Δ|/max(|d|, 1) ≤ 1e-4) and mixed
   precision (≤ 4e-3), with its time beside the plain version's, its
   bound (float32 rows also as TFLOP/s and share of bound) and a library
   yardstick (the cross term as ``torch.matmul``:
   ``q @ rᵀ`` for the global kernels, each pixel's K×K window for
   kernel 2): kernel 1 (B.1) at the occupancy bank, kernel 1's uniform
   entry (B.2) at the uniform-quota bank, kernel 3 (B.3) at no cap and
   at the fg-union bank, kernel 2 (B.4); B.1 and B.4 again at the
   ensemble's largest scale (a 593×1041 frame: 38,889 query rows, a
   75×131 local grid); the AOP k-means kernel (``ops.masked_kmeans``)
   at the main path's bank (16,384 rows, 11 object channels, K = 16,
   20 + 1 passes), its library yardstick the plain version itself (the
   ``torch.matmul`` route over all object channels), and the plain
   route's initial ``torch.sort`` timed alone;
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
   its kernel-2 launch): the layout's global kernel, kernel 2 and the
   k-means kernel must run on every frame after the first.  A line
   before it gives the time of the default k-means draws (``ops.prng``)
   per frame;
3b. the graph path, on the video's first 12 frames (one steady chunk),
   under each other bank layout — no cap
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
3d. parity matching (``MATCHING_DTYPE="float32"``, the preset's bf16
   compute) at full width, the graph path on the video's first 12 frames
   under the occupancy bank (B.1) and at no cap (B.3): the steady time
   per frame, the float32 global kernel once on every frame after the
   first and no tensor-core one (the profiler), device busy ms and idle
   share of the profiled run;
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
   steps, 3 steps: per step the loss, IoU, grad norm and learning rate,
   then the steady ms/step (median of steps 2–3, CUDA events), clips/s,
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

6. bfloat16 training and the MobileNetV2 backbone:
   6a. phase 5a's run with ``TRAIN_COMPUTE_DTYPE="bfloat16"`` (the
   forward on bf16 copies of the parameters), printed beside phase 5a's
   float32 numbers (with ``--only 6`` that float32 run is made here
   first): every extractor output bf16 (a forward hook), parameters,
   gradients and momentum float32, counters 0;
   6b. card against CPU: first each stage of the bf16 route alone
   (``engine.stage_check``: a backbone block of each kind, the ASPPs,
   the DeepLab decoder, the embedding, the pre-head, a gate, a decoder
   bottleneck and the matching maps of ``segment_frame(train=True)``),
   from the same bf16 inputs and output gradient, output, input and
   parameter gradients within ``stage_check.CARD_BARS``, each bar below
   the gap of the card's float32 run of the stage (power); then at
   65×65 as 5b's first check, one ``loss_fn`` each of
   ``TRAIN_COMPUTE_DTYPE="bfloat16"`` and of bfloat16 matching
   (``--float16``), held to the CPU tests' whole-step bars
   (``engine.grad_check.BF16_BARS``; those of bf16 compute only bound
   the step's size), with the worst tensors;
   6c. phase 3's main path with ``MODEL_BACKBONE="mobilenet"`` (the same
   video, chunks of 5 as graph replays; B.1 and B.4 on every frame after
   the first), its steady median and p90 ms/frame, peak and each
   object's foreground share on the last frame; then card against CPU
   at 65×65 in lock-step, float32 and mixed matching, through the gate;
   6d. batch-2 float32 MobileNet steps at 465×465 (``fit`` of 3 steps,
   the median of steps 2–3), ms/step and peak.

7. several GPUs, driven on the one card (a device list may repeat a
   device; NCCL refuses two ranks on one card, so two ranks run over
   gloo):
   7a. data-parallel training at phase 5a's width in parity precision
   (float32 matching, TF32 off): two ranks spawned by
   ``parallel.launch`` on the card over gloo, a global batch of two (one
   item each), two steps: the reduced gradient must be the mean of the
   ranks' own bit for bit, both ranks' parameters equal and each the
   optimizer's update of that gradient (within ``UPDATE_TOL``); against
   the per-item average made here from the same weights, batch, key and
   dropout seeds (``engine.dp_check.per_item_steps``; the card's
   backward is not run-to-run deterministic) the loss within 1e-4 and
   the gradients within 5b's bars with the ``grad_check`` floor; against
   one process at batch 2 the same bars, all gradients within the larger
   of 2e-2 and three times the floor runs' own L2 spread; then one NCCL
   step at world size 1 in this process: its reduce an identity, its
   loss the plain step's.  Per-rank ms/step (the second step; two ranks
   sharing one card: not a data-parallel speed), the reduce's ms and
   bytes, peaks, kernel counters 0;
   7b. phase 3's path with ``MESH_MODEL_AXIS=2`` over ``[cuda:0] * 2``:
   the graph path timed beside phase 3's, the profiler seeing B.3 twice a
   frame (once per query-row shard) and B.1 never; frame by frame in
   lock-step with the unsharded evaluator (float32 compute) through the
   gate; then at phase 2's shapes B.3 on 2 and 3 query-row shards and on
   2 and 3 bank shards, over the occupancy bank and the full bank,
   float32 and mixed, each equal to one launch bit for bit, with the
   two-shard split timed beside one B.3 launch and B.1;
   7c. phase 3c's ensemble sharded over ``[cuda:0] * 2`` (a scale group
   per device) and ``[cuda:0] * 6`` (a variant per device), frame by
   frame, timed beside phase 3c and profiled (B.1 and B.4 six times a
   frame), then in lock-step with the one-device ensemble, the reference
   embedding its own frames (``lockstep_chunks(own_features=True)``),
   through the gate (a variant per device in parity precision).

``python3 chip_smoke.py --only 5`` (or ``--only 3d``, ``--only 6``,
``--only 7``) runs that phase alone (phase 7 with its own unsharded runs
of phases 3 and 3c); ``--only 2`` runs phases 1 and 2.  Every phase
reads the package that Python finds first, the one beside the script:
a copy of the script in another tree measures that tree's package.

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

import copy
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


def _sass(lib) -> str:
    """A built library's SASS (``cuobjdump -sass``)."""
    from rvos_tpu_torch.ops import _cuda
    tool = str(Path(_cuda._nvcc()).with_name("cuobjdump"))
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def _mma_count(sass: str) -> int:
    """Tensor-core instructions (HMMA, HGMMA) in a library's SASS."""
    return len(re.findall(r"\bH(?:G)?MMA\b", sass))


# the float32 (FMA) kernels of the global matching libraries, by their
# mangled names (not the tensor-core ``*_mma_kernel``s)
F32_KERNELS = {"global_seg_map": ("seg_map_kernel", r"\d+seg_map_kernelE"),
               "global_flat_match": ("flat_match_kernel",
                                     r"\d+flat_match_kernelE"),
               "kmeans": ("assign_kernel<4, true>",
                          r"\d+assign_kernelILi4ELb1EE")}
# the libraries whose SASS must hold tensor-core instructions
MMA_LIBS = ("global_seg_map", "local_match", "global_flat_match")


def f32_kernel_stats(name: str, sass: str, log: str) -> dict:
    """Registers and spill bytes (the ptxas report ``log``) and FFMA
    count (``sass``) of library ``name``'s float32 kernel."""
    kernel, pat = F32_KERNELS[name]
    out = dict(kernel=kernel, ffma=None, registers=None, spill_stores=None,
               spill_loads=None)
    for fn in sass.split("Function : ")[1:]:
        if re.search(pat, fn.split()[0]):
            out["ffma"] = len(re.findall(r"\bFFMA\b", fn))
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            continue
        if cur is None or not re.search(pat, cur):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out["registers"] = int(m.group(1))
    return out


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
    return dict(max_abs_err=abs_err, rel_err=rel_err, ops=flops + f32_ops,
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


def kmeans_blobs(torch, r, c, counts, k, seed, device="cuda"):
    """A k-means problem without near-ties: points [r, c], weights and
    init scores [O, r] (O = len(counts)).  Object q owns ``counts[q]``
    rows spread over the bank (the remaining rows at its end are zero
    padding of no object), in min(k, counts[q]) blobs far apart (centres
    ×10, spread 0.5), with weights in [0.25, 1]; the top-k scores name one
    row of each blob (weight 1), so every Lloyd pass assigns each row to
    its blob's centroid by a margin far above float32 rounding."""
    g = torch.Generator().manual_seed(seed)
    o, n = len(counts), sum(counts)
    owner = torch.cat([torch.full((m,), q) for q, m in enumerate(counts)])
    perm = torch.randperm(n, generator=g)
    pts = torch.zeros(r, c)
    w = torch.zeros(o, r)
    s = 0.5 + 0.4 * torch.rand(o, r, generator=g)
    for q, m in enumerate(counts):
        rows = perm[owner == q]
        nb = min(k, m)
        blob = torch.arange(m) % nb
        cen = 10.0 * torch.randn(nb, c, generator=g)
        pts[rows] = cen[blob] + 0.5 * torch.randn(m, c, generator=g)
        w[q, rows] = 0.25 + 0.75 * torch.rand(m, generator=g)
        w[q, rows[:nb]] = 1.0
        s[q, rows[:nb]] = 0.99 - 0.001 * torch.arange(nb)
    return pts.to(device), w.to(device), s.to(device)


# the main path's bank: 16,384 rows over 11 object channels, 6 of them live
KMEANS_COUNTS = (9000, 3000, 2000, 1200, 500, 300, 0, 0, 0, 0, 0)


def check_kmeans(torch, ops, shapes, mixed: bool):
    """The AOP k-means kernel at the main path's shapes (``kmeans_blobs``:
    a 16,384-row bank, 11 object channels, K = 16, 20 + 1 passes) against
    the plain version on the card; the plain version is also the library
    yardstick (the ``torch.matmul`` route over all object channels), and
    its initial stable sort is timed alone.  The bound counts what one
    object a row needs: per pass 2·R·K·C of distances and 2·R·C of sums at
    the float32 rate, and the points, weights and scores read once."""
    from rvos_tpu_torch.ops.kmeans import _masked_kmeans
    r, c, k, iters = shapes["p"], shapes["c"], 16, 20
    counts = KMEANS_COUNTS[:shapes["o"]]
    pts, w, s = kmeans_blobs(torch, r, c, counts, k, 5)

    def flat(banks):
        return torch.cat([t.float().reshape(-1) for t in banks])

    res = _measure(
        torch, "masked_kmeans", mixed,
        lambda: flat(ops.masked_kmeans(pts, w, s, k, iters, mixed)),
        lambda: flat(_masked_kmeans(pts, w, s, k, iters, mixed)),
        lambda: _masked_kmeans(pts, w, s, k, iters, mixed),
        r * c * 4 + 2 * len(counts) * r * 4, 0.0,
        [r, c, len(counts), k, iters],
        f32_ops=(iters + 1) * (2.0 * r * k * c + 2.0 * r * c))
    sw = s * w
    res["sort_ms"] = _time_ms(lambda: torch.sort(sw, dim=-1, descending=True,
                                                 stable=True), 10)
    return res


# the kernel wrapper that each bank layout's global stream launches
GLOBAL_KERNEL = {"occupancy": "global_seg_map", "uniform": "global_seg",
                 "unsegmented": "global_flat_min", "cap0": "global_flat_min"}
COUNTED = ("global_seg_map", "global_seg", "global_flat_min", "local_match",
           "masked_kmeans")
# the kernels of the path as the profiler names them (kernel 1 serves
# B.1 and B.2; float32 and tensor-core variants alike)
PROFILED = {"global_seg_map": r"\bseg_map_(?:mma_)?kernel\b",
            "global_flat_min": r"\bflat_match_(?:mma_)?kernel\b",
            "local_match": r"\blocal_(?:mma|f32)_kernel\b",
            "kmeans": r"\bassign_kernel\b",
            "dist_prep": r"\bprep::(?:query|bank|f32)_kernel\b",
            "local_prep": r"\bprep_kernel\b",
            "flat_route": r"\bflat_(?:keys|tags)_kernel\b",
            "f32_global": r"\b(?:seg_map|flat_match)_kernel\b",
            "mma_global": r"\b(?:seg_map|flat_match)_mma_kernel\b"}
PROFILED_GLOBAL = {"global_seg_map": "global_seg_map",
                   "global_seg": "global_seg_map",
                   "global_flat_min": "global_flat_min"}


def kernels_per_frame(torch, ev, seq):
    """Stream ``seq`` under ``torch.profiler`` → each profiled kernel's
    count on every frame after the first, in start order, a frame ending
    at its last kernel-2 launch (one per variant), and the run's device
    numbers: busy ms (the device records' durations), the wall ms of the
    run (the profiler's overhead included) and each profiled kernel's
    device ms.  Filler kernels close the record
    (``profile_eval.pad_profile``) and must show in it."""
    from torch.profiler import ProfilerActivity, profile

    from rvos_tpu_torch.cli.profile_eval import (FILLER, device_records,
                                                 pad_profile)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        ev.evaluate_sequence(seq)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
        pad_profile(torch)
    records = device_records(prof)
    if not any(FILLER in name for name, *_ in records):
        raise AssertionError("the profiler lost the end of its record")
    n_var = len(ev.variants.flips)
    counts = {k: [0] for k in PROFILED}
    device_ms = {k: 0.0 for k in PROFILED}
    busy_us = 0.0
    matches = {}                # kernel name -> the PROFILED keys it matches
    for name, _, us, *_ in records:
        if FILLER in name:
            continue
        busy_us += us
        if name not in matches:
            matches[name] = [k for k, pat in PROFILED.items()
                             if re.search(pat, name)]
        for k in matches[name]:
            counts[k][-1] += 1
            device_ms[k] += us / 1e3
        if counts["local_match"][-1] == n_var:
            for c in counts.values():
                c.append(0)
    return ({k: c[:-1] for k, c in counts.items() if sum(c)},
            dict(busy_ms=busy_us / 1e3, wall_ms=wall_ms,
                 device_ms={k: v for k, v in device_ms.items() if v}))


class _Head:
    """The first ``n`` frames of a video."""

    def __init__(self, seq, n: int):
        self.seq, self.n = seq, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return self.seq[i]

    def __getattr__(self, name):
        return getattr(self.seq, name)


def run_video(torch, ops, ev, seq, global_kernel, window,
              profile_frames=None):
    """Stream ``seq`` with every launch counter set to 0 just before and a
    CUDA event recorded as each frame's step is issued (no host
    synchronisation); then stream it again under the profiler (its first
    ``profile_frames`` frames, default all).  The layout's global kernel
    and kernel 2 must have launched, and the profiler must see them on
    every frame after the first.  Returns the output and the numbers
    phase 3 prints."""
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
    for k in (global_kernel, "local_match", "masked_kmeans"):
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
    prof_seq = seq if profile_frames is None else _Head(seq, profile_frames)
    profiled, dev = kernels_per_frame(torch, ev, prof_seq)
    n_var = len(ev.variants.flips)
    for k in (PROFILED_GLOBAL[global_kernel], "local_match", "kmeans"):
        got = profiled.get(k, [])
        if len(got) != len(prof_seq) - 1 or min(got) < n_var:
            raise AssertionError(f"profiler: {k} per frame {got}")
    ranked = sorted(per_frame)
    return dict(out=out, launches=launches, steady_ms=steady_ms,
                median_ms=ranked[len(ranked) // 2],
                p90_ms=ranked[min(len(ranked) - 1, int(0.9 * len(ranked)))],
                peak_gb=peak_gb, replays=replays, captures=captures,
                per_frame=profiled,
                busy_ms=dev["busy_ms"] / len(prof_seq),
                idle=1.0 - dev["busy_ms"] / dev["wall_ms"],
                device_ms={k: v / len(prof_seq)
                           for k, v in dev["device_ms"].items()})


def _video_line(r) -> str:
    t = r["out"]["timing"]
    return (f"steady_ms_per_frame={r['steady_ms']:.2f} (median "
            f"{r['median_ms']:.2f}) peak_mem_gb={r['peak_gb']:.3f} "
            f"captures={r['captures']} replays={r['replays']} "
            f"wall_fps={r['out']['fps']:.2f} launch_counters={r['launches']} "
            f"timing_s={ {k: round(v, 4) for k, v in t.items()} } "
            f"profiler_kernels_per_frame={r['per_frame']} profiled: device "
            f"busy {r['busy_ms']:.2f} ms a frame, idle share {r['idle']:.3f}, "
            f"device ms a frame { {k: round(v, 3) for k, v in r['device_ms'].items()} }")


# phase 3d: the layouts it runs and the video's frames it streams
PARITY_LAYOUTS = ("occupancy", "cap0")
PARITY_FRAMES = 12


def phase3d(torch, ops, card, base=None) -> dict:
    """Phase 3d: the graph path at full ``resnet101_aocnet`` width with
    float32 (parity) matching and the preset's bf16 compute, on the
    occupancy bank (B.1) and at no cap (B.3), the video's first 12 frames
    each: steady ms a frame (one steady chunk), the float32 global kernel
    once on every frame after the first and no tensor-core one (the
    profiler), device busy ms and idle share of the profiled run, and the
    kernels' device ms a frame.  ``base``: phase 3's weights and video;
    without them (``--only 3d``) they are made here."""
    from rvos_tpu_torch.cli.profile_eval import video_steps
    from rvos_tpu_torch.configs import BANK_LAYOUTS, get_config
    from rvos_tpu_torch.data import SyntheticEval
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.weights import init_random_

    t_all = time.time()
    cfg = get_config("resnet101_aocnet")
    if base is None:
        model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
        seq = SyntheticEval(size=(481, 849), n_seqs=1, n_frames=22,
                            obj_num=3)[0]
    else:
        model, seq = base
    seq = _Head(seq, PARITY_FRAMES)
    out = {}
    for name in PARITY_LAYOUTS:
        t0 = time.time()
        lcfg = cfg.replace(MATCHING_DTYPE="float32", **BANK_LAYOUTS[name])
        lmodel = AOCNet(lcfg)
        lmodel.load_state_dict(model.state_dict())
        lev = Evaluator(lcfg, lmodel, device="cuda")
        steps = [st for st in video_steps(lev, len(seq))
                 if len(st) == lev.chunk_n]
        window = (steps[1][0], steps[-1][-1])
        r = run_video(torch, ops, lev, seq, GLOBAL_KERNEL[name], window)
        f32 = r["per_frame"].get("f32_global", [])
        if f32 != [1] * (len(seq) - 1) or "mma_global" in r["per_frame"]:
            raise AssertionError(f"phase 3d {name}: float32 global kernel per "
                                 f"frame {f32}, profiled {r['per_frame']}")
        out[name] = r
        print(f"phase 3d parity matching (MATCHING_DTYPE=float32, bf16 "
              f"compute) layout {name} resnet101_aocnet 481x849 {len(seq)} "
              f"frames, graph path, steady frames {window[0]}-{window[1]}: "
              f"{_video_line(r)} float32 global kernel per frame {f32} took "
              f"{time.time() - t0:.1f} s [{card}]", flush=True)
        del lev, lmodel
    print(f"phase 3d took {time.time() - t_all:.1f} s", flush=True)
    return out


def _own_masks(lock, gate_failures) -> dict:
    """A lock-step run whose reference kept its own decoder masks, for the
    record beside the gated run that shares them."""
    return dict(lockstep=min(lock.agree), dlogit=lock.max_dlogit,
                masks_parted=lock.masks_parted,
                gate_failures=gate_failures(lock))


def _kernel_counters(ops):
    return {name: getattr(ops, name) for name in
            ("global_seg_map", "global_seg", "global_flat_min", "local_match")}


def train_full_width(torch, ops, card, phase="5a", steps=3, inspect=None,
                     **kw) -> dict:
    """Phase 5a (and 6a, 6d with ``kw`` set): ``Trainer.fit`` at full
    width, batch 2, counters from 0."""
    import tempfile

    from rvos_tpu_torch.cli.profile_train import profile_training, train_config
    counters = _kernel_counters(ops)
    with tempfile.TemporaryDirectory() as root:
        cfg = train_config(2, steps, root, DATA_MAX_OBJ_NUM=5, **kw)
        for fn in counters.values():
            fn.launches = 0
        r = profile_training(torch, cfg, steps, inspect=inspect)
        launches = {n: fn.launches for n, fn in counters.items()}
    for row in r["rows"]:
        print(f"phase {phase} step {row['step']}: loss {row['loss']:.5f} IoU "
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


def _train_line(a) -> str:
    return (f"steady {a['steady_ms']:.1f} ms/step (median of steps "
            f"2-{len(a['step_ms'])}; steps "
            f"{[round(t, 1) for t in a['step_ms']]}), {a['clips_s']:.3f} "
            f"clips/s, peak {a['peak_gb']:.3f} GB above the "
            f"{a['held_gb']:.3f} GB held before it, profiled step: wall "
            f"{a['profiled_wall_ms']:.1f} ms, device busy "
            f"{a['busy_ms']:.1f} ms, idle share {a['idle_share']:.3f}, "
            f"{a['kernels']} kernels; kernel launches while training "
            f"{a['launches']}")


def phase5(torch, ops, card) -> dict:
    """Phase 5: training, at full width (5a), card against CPU (5b), the
    matching Functions at the step's shapes (5c).  Returns 5a's numbers."""
    t0 = time.time()
    a = train_full_width(torch, ops, card)
    print(f"phase 5a training resnet101_aocnet 465x465 T=5 batch 2 O=6 remat "
          f"float32: {_train_line(a)}; top kernels {a['top'][:8]}; took "
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
    return a


def _bf16_probe(trainer):
    """Phase 6a's watch on a trainer: the dtypes of every output of the
    feature extractor, forward after forward."""
    seen = set()
    hook = trainer.model.feature_extracter.register_forward_hook(
        lambda m, a, out: seen.update(t.dtype for t in out))
    return trainer, seen, hook


def train_bf16_full_width(torch, ops, card) -> dict:
    """Phase 6a: the bf16 step at full width; parameters, gradients and
    momentum float32, the extractor's outputs bf16, counters 0."""
    r = train_full_width(torch, ops, card, "6a", inspect=_bf16_probe,
                         TRAIN_COMPUTE_DTYPE="bfloat16")
    trainer, seen, hook = r.pop("inspected")
    hook.remove()
    params = {p.dtype for p in trainer.model.parameters()}
    grads = {p.grad.dtype for p in trainer.model.parameters()
             if p.grad is not None}
    moments = {s["momentum_buffer"].dtype for s in
               trainer.optimizer.sgd.state_dict()["state"].values()}
    r["dtypes"] = dict(extractor_out=sorted(map(str, seen)),
                       params=sorted(map(str, params)),
                       grads=sorted(map(str, grads)),
                       momentum=sorted(map(str, moments)))
    del trainer
    f32 = {torch.float32}
    if (seen != {torch.bfloat16} or params != f32 or grads != f32
            or moments != f32):
        raise AssertionError(f"bf16 training dtypes: {r['dtypes']}")
    return r


def _worst(got, want, n=4):
    """The ``n`` tensors farthest from the reference, over its scale."""
    rel = {k: float((got[k].float() - w.float()).abs().max()
                    / w.float().abs().max().clamp(min=1e-30))
           for k, w in want.items()}
    return sorted(rel.items(), key=lambda kv: -kv[1])[:n]


def train_bf16_card_vs_cpu(torch, name: str, kw: dict) -> dict:
    """Phase 6b: one ``loss_fn`` with its gradients of a bf16 route, card
    against CPU at 65×65 from the same weights, batch and draws (TF32
    off, the decoder's top-β masks shared): losses, all gradients and
    each tensor (against three times the CPU's floor) within the route's
    bars (``engine.grad_check.BF16_BARS``, the CPU tests')."""
    from rvos_tpu_torch.cli.train import train_transform
    from rvos_tpu_torch.configs import tiny_test
    from rvos_tpu_torch.data import SyntheticTrain, TrainBatcher
    from rvos_tpu_torch.device import tf32_off
    from rvos_tpu_torch.engine.grad_check import (BF16_BARS, floors,
                                                  gradient_failures,
                                                  perturbed_state)
    from rvos_tpu_torch.engine.lockstep import _MaskWatch
    from rvos_tpu_torch.engine.train import Trainer, batch_to_device
    from rvos_tpu_torch.ops import prng

    cfg = tiny_test(
        DATA_RANDOMCROP=(65, 65), DATA_CURR_SEQ_LEN=2, TRAIN_BATCH_SIZE=1,
        MODEL_ASPP_DROPOUT=0.0, TRAIN_REMAT=False,
        TRAIN_START_SEQ_TRAINING_STEPS=10 ** 6, TRAIN_HARD_MINING_STEP=4,
        TRAIN_AUTO_RESUME=False, MATCHING_DTYPE="mixed").replace(**kw)
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", init_state=cpu.model.state_dict())
    watch = _MaskWatch(gpu.model, cpu.model, True)
    data = SyntheticTrain(size=(65, 65), curr_len=2, obj_num=3, length=1)
    batch = next(iter(TrainBatcher(data, 1, train_transform(cfg, True),
                                   num_workers=1).epoch(0)))
    key = prng.next_step_key(prng.prng_key(prng.TRAIN_SEED))[1]

    def grads(tr):
        tr.optimizer.zero_grad()
        watch.begin(10 ** 9)
        loss, (losses, _, _) = tr._step_fn.loss_fn(
            batch_to_device(batch, tr.device), 3, key.to(tr.device))
        loss.backward()
        return (losses.detach().cpu(),
                {n: p.grad.detach().cpu() for n, p in
                 tr.model.named_parameters() if p.grad is not None})

    with tf32_off():
        g_losses, g_grads = grads(gpu)
        c_losses, c_grads = grads(cpu)
        names = [n for n, _ in cpu.model.named_parameters()]
        state = {k: v.clone() for k, v in cpu.model.state_dict().items()}
        runs = []
        for seed in range(3):
            cpu.model.load_state_dict(perturbed_state(state, names, seed))
            runs.append(grads(cpu)[1])
    loss_bar, l2_bar, rel_tol = BF16_BARS[name]
    rel = ((g_losses - c_losses).abs() / c_losses.abs()).max().item()
    bad, summary = gradient_failures(g_grads, c_grads, floors(c_grads, runs),
                                     rel_tol)
    out = {"loss_rel": rel, "losses": c_losses.tolist(), **summary,
           "worst": _worst(g_grads, c_grads), "masks_parted": watch.parted,
           "unexplained": watch.unexplained,
           "bars": {"loss": loss_bar, "all_l2": l2_bar}}
    if (rel > loss_bar or bad or summary["all_l2_rel"] > l2_bar
            or watch.unexplained or set(g_grads) != set(c_grads)):
        raise AssertionError(f"bf16 training ({name}) card vs CPU: {out} "
                             f"{bad[:10]}")
    return out


def bf16_stages_card_vs_cpu(torch) -> dict:
    """Phase 6b's first check: every stage of the bf16 route alone, card
    against CPU (``engine.stage_check.stage_gaps``, TF32 off)."""
    from rvos_tpu_torch.configs import tiny_test
    from rvos_tpu_torch.device import tf32_off
    from rvos_tpu_torch.engine.stage_check import CARD_BARS, stage_gaps
    from rvos_tpu_torch.engine.train import Trainer

    cfg = tiny_test(MODEL_MULTI_LOCAL_DISTANCE=(1, 2), MODEL_MAX_OBJ_NUM=3,
                    MATCHING_DTYPE="mixed", TRAIN_AUTO_RESUME=False)
    cpu = Trainer(cfg, device="cpu", seed=0)
    gpu = Trainer(cfg, device="cuda", init_state=cpu.model.state_dict())
    with tf32_off():
        r = stage_gaps(cpu.model, gpu.model)
    if r["failures"]:
        raise AssertionError(f"bf16 stages card vs CPU past "
                             f"{ {k: CARD_BARS.get(k) for k in r['failures']} }"
                             f": { {k: r['stages'][k] for k in r['failures']} }")
    return r["stages"]


def mobilenet_eval(torch, ops, card) -> dict:
    """Phase 6c: the default pipeline with the MobileNetV2 backbone at
    full width (``run_video``'s checks: B.1 and B.4 on every frame after
    the first), then card against CPU at 65×65 in lock-step, float32 and
    mixed matching, through the gate."""
    from rvos_tpu_torch.cli.profile_eval import video_steps
    from rvos_tpu_torch.configs import get_config
    from rvos_tpu_torch.data import SyntheticEval
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.engine.lockstep import (gate_failures, lockstep_masks,
                                                parity_config, parity_scores)
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.weights import init_random_

    cfg = get_config("resnet101_aocnet", MODEL_BACKBONE="mobilenet")
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
    seq = SyntheticEval(size=(481, 849), n_seqs=1, n_frames=22, obj_num=3)[0]
    ev = Evaluator(cfg, model, device="cuda")
    steps = [s for s in video_steps(ev, len(seq)) if len(s) == ev.chunk_n]
    window = (steps[1][0], steps[-1][-1])
    r = run_video(torch, ops, ev, seq, "global_seg_map", window)
    if r["replays"] != len(steps) or r["captures"] != 1:
        raise AssertionError(f"{r['replays']} replays and {r['captures']} "
                             f"captures for {len(steps)} full chunks")
    last = r["out"]["results"][max(r["out"]["results"])]
    r["fg_share_last"] = {k: round(float((last == k).mean()), 4)
                          for k in (1, 2, 3)}
    r["window"] = window
    del ev, model
    lock = {}
    for matching in ("float32", "mixed"):
        small = parity_config("occupancy", matching).replace(
            MODEL_BACKBONE="mobilenet")
        res = lockstep_masks(
            small,
            lambda c=small: init_random_(AOCNet(c),
                                         torch.Generator().manual_seed(0)),
            SyntheticEval(size=(65, 65), n_seqs=1, n_frames=6)[0],
            parity_scores)
        lock[matching] = dict(lockstep=min(res.agree), dlogit=res.max_dlogit,
                              demb=res.max_demb, unexplained=res.unexplained,
                              masks_parted=res.masks_parted,
                              banks=all(res.banks_equal))
        failed = gate_failures(res)
        if (failed or len(res.agree) != 5 or res.max_demb >= 1e-3
                or not res.banks_equal or not all(res.banks_equal)):
            raise AssertionError(f"mobilenet/{matching}: card vs CPU: "
                                 f"{lock[matching]} {failed}")
    r["lockstep"] = lock
    return r


def phase6(torch, ops, card, f32=None) -> dict:
    """Phase 6: bf16 training at full width (6a, beside phase 5a's float32
    step, run here when phase 5 was not), the bf16 routes card against
    CPU (6b), MobileNet eval (6c) and MobileNet training (6d).  Returns
    6c's numbers."""
    t_all = time.time()
    if f32 is None:
        f32 = train_full_width(torch, ops, card)
    t0 = time.time()
    a = train_bf16_full_width(torch, ops, card)
    print(f"phase 6a training resnet101_aocnet 465x465 T=5 batch 2 O=6 remat "
          f"TRAIN_COMPUTE_DTYPE=bfloat16: {_train_line(a)}; dtypes "
          f"{a['dtypes']}; top kernels {a['top'][:8]}; took "
          f"{time.time() - t0:.1f} s | float32 (phase 5a): "
          f"{_train_line(f32)} [{card}]", flush=True)
    t0 = time.time()
    stages = bf16_stages_card_vs_cpu(torch)
    print("phase 6b bf16 stages card vs cpu (output, input grads, param "
          "grads; relative L2; bf16 | the card's float32 control): "
          + "; ".join(f"{k} " + " ".join(f"{v:.2e}" for v in r["bf16"])
                      + " | " + " ".join(f"{v:.2e}" for v in r["float32"])
                      for k, r in stages.items())
          + f"; took {time.time() - t0:.1f} s [{card}]", flush=True)
    for name, kw in (("compute", dict(TRAIN_COMPUTE_DTYPE="bfloat16")),
                     ("matching", dict(MATCHING_DTYPE="bfloat16"))):
        t0 = time.time()
        b = train_bf16_card_vs_cpu(torch, name, kw)
        print(f"phase 6b training card vs cpu 65x65 T=2 batch 1 {kw}: {b}, "
              f"took {time.time() - t0:.1f} s [{card}]", flush=True)
    t0 = time.time()
    c = mobilenet_eval(torch, ops, card)
    print(f"phase 6c mobilenet eval 481x849 22 frames, chunks of 5 as CUDA "
          f"graphs, steady frames {c['window'][0]}-{c['window'][1]}: "
          f"{_video_line(c)} p90_ms={c['p90_ms']:.2f} "
          f"fg_share_last_frame={c['fg_share_last']}; card vs cpu 65x65 "
          f"lock-step {c['lockstep']}; took {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)
    t0 = time.time()
    d = train_full_width(torch, ops, card, "6d", MODEL_BACKBONE="mobilenet")
    print(f"phase 6d training mobilenet 465x465 T=5 batch 2 O=6 remat "
          f"float32: {_train_line(d)}; took {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)
    print(f"phase 6 took {time.time() - t_all:.1f} s", flush=True)
    return c


def _global_batches(cfg, n: int):
    """The first ``n`` global batches of ``SyntheticTrain`` at ``cfg``'s
    crop, objects and batch, as phase 5a's loader makes them."""
    from rvos_tpu_torch.cli.train import train_transform
    from rvos_tpu_torch.data import SyntheticTrain, TrainBatcher
    data = SyntheticTrain(size=cfg.DATA_RANDOMCROP,
                          curr_len=cfg.DATA_CURR_SEQ_LEN,
                          obj_num=cfg.DATA_MAX_OBJ_NUM,
                          length=cfg.TRAIN_BATCH_SIZE * n)
    return list(TrainBatcher(data, cfg.TRAIN_BATCH_SIZE,
                             train_transform(cfg, True),
                             num_workers=2).epoch(0))[:n]


def _tensor_rel(got, want):
    """Per tensor max |Δ| over max |want|, the worst of them."""
    return max(float((got[n].float().cpu() - w.float().cpu()).abs().max())
               / max(float(w.abs().max()), 1e-30) for n, w in want.items())


def dp_training(torch, ops, card) -> dict:
    """Phase 7a: two ranks on the one card over gloo, a global batch of
    two (one item each), phase 5a's width, two steps (the second timed);
    then one NCCL step at world size 1.  A rank that fails to launch or
    join raises (``parallel.launch``)."""
    import tempfile

    import torch.distributed as dist

    from rvos_tpu_torch.cli.profile_train import train_config
    from rvos_tpu_torch.engine.dp_check import (batch_slice,
                                                data_parallel_steps,
                                                per_item_steps)
    from rvos_tpu_torch.engine.grad_check import (UPDATE_TOL, floors,
                                                  gradient_failures,
                                                  perturbed_state)
    from rvos_tpu_torch.engine.train import Trainer, batch_to_device
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.ops import prng
    from rvos_tpu_torch.parallel.launch import launch
    from rvos_tpu_torch.weights import init_random_

    with tempfile.TemporaryDirectory() as root:
        # parity precision (float32 matching, TF32 off in every process,
        # as phase 5b runs): the comparisons below have power only
        # without TF32's rounding, which batch-1 and batch-2 convolutions
        # take apart
        cfg = train_config(2, 2, root, DATA_MAX_OBJ_NUM=5,
                           MATCHING_DTYPE="float32",
                           EVAL_COMPUTE_DTYPE="float32")
        batches = _global_batches(cfg, 2)
        t0 = time.time()
        ranks = launch(data_parallel_steps, 2, "gloo", ["cuda:0"] * 2,
                       (cfg, None, batches, 0, 1), timeout=900)
        ranks_s = time.time() - t0
        for fn in _kernel_counters(ops).values():
            fn.launches = 0
        # the weights every rank makes from seed 0, made once here
        init = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0)
                            ).state_dict()
        ref = per_item_steps(cfg, init, batches[:1], 0, "cuda")
        # the single process at batch 2, and its ten-ulp floor
        tr = Trainer(cfg, device="cuda", init_state=init, seed=0)
        key = prng.next_step_key(tr.run_key)[1].cuda()
        seeds = tr.draw_seeds()
        batch = batch_to_device(batches[0], tr.device)
        state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        names = [n for n, _ in tr.model.named_parameters()]

        def grads_at(st):
            tr.model.load_state_dict(st)
            tr.optimizer.zero_grad()
            loss, _ = tr._step_fn.loss_fn(batch, 0, key, seeds)
            loss.backward()
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().cpu()
                     for n, p in tr.model.named_parameters()}
            return float(loss.detach()), grads

        b2_loss, b2 = grads_at(state)
        runs = [grads_at(perturbed_state(state, names, s))[1]
                for s in range(3)]
        floor = floors(b2, runs)
        norm = sum(float(g.square().sum()) for g in b2.values()) ** 0.5
        spread = max(sum(float((r[n] - g).square().sum())
                         for n, g in b2.items()) ** 0.5 / norm for r in runs)
        # the optimizer's update of rank 0's reduced gradient, here
        tr.model.load_state_dict(state)
        for n, p in tr.model.named_parameters():
            p.grad = ranks[0]["steps"][0]["grads"][n].to(p.device)
        tr.optimizer.step()
        updated = {n: p.detach().cpu()
                   for n, p in tr.model.named_parameters()}
        del tr, batch, state
        parent_launches = {k: fn.launches
                           for k, fn in _kernel_counters(ops).items()}
        # NCCL at world size 1, in this process: item 0 alone, against
        # the plain step (no group)
        one = [batch_slice(batches[0], 0, 1)]
        cuda = torch.device("cuda", 0)
        t0 = time.time()
        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              wait_for_workers=False)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            nccl = data_parallel_steps(0, 1, cuda, cfg, init, one)
        finally:
            dist.destroy_process_group()
        nccl_s = time.time() - t0
        plain = data_parallel_steps(0, 1, cuda, cfg, init, one)
    s0, s1 = (r["steps"][0] for r in ranks)
    reduced_exact = all(
        torch.equal(s0["grads"][n], (s0["local_grads"][n]
                                     + s1["local_grads"][n]) / 2)
        and torch.equal(s1["grads"][n], s0["grads"][n]) for n in s0["grads"])
    params_equal = all(torch.equal(s0["params"][n], s1["params"][n])
                       for n in s0["params"])
    want = ref["steps"][0]
    loss_rel = abs(float(s0["loss"]) - float(want["loss"])) / abs(
        float(want["loss"]))
    bitwise = sum(torch.equal(s0["grads"][n], want["grads"][n].cpu())
                  for n in want["grads"])
    bad_i, sum_i = gradient_failures(
        s0["grads"], {n: g.cpu() for n, g in want["grads"].items()}, floor,
        1e-3)
    param_rel = _tensor_rel(s0["params"], {n: p.cpu() for n, p in
                                           ref["params"].items()})
    update_rel = _tensor_rel(s0["params"], updated)
    b2_rel = abs(float(s0["loss"]) - b2_loss) / abs(b2_loss)
    bad_b2, sum_b2 = gradient_failures(s0["grads"], b2, floor, 1e-3)
    n0, p0 = nccl["steps"][0], plain["steps"][0]
    nccl_identity = all(torch.equal(n0["grads"][n], n0["local_grads"][n])
                        for n in n0["grads"])
    nccl_loss_rel = abs(float(n0["loss"]) - float(p0["loss"])) / abs(
        float(p0["loss"]))
    out = dict(
        reduce_exact=reduced_exact, ranks_params_equal=params_equal,
        per_item=dict(loss_rel=loss_rel, bitwise_tensors=int(bitwise),
                      **sum_i,
                      params_worst_rel=param_rel),
        batch2=dict(loss_rel=b2_rel, **sum_b2, floor_l2_rel=spread),
        update_worst_rel=update_rel,
        rank_ms=[r["steps"][1]["step_ms"] for r in ranks],
        reduce_ms=[r["steps"][1]["reduce_ms"] for r in ranks],
        reduce_bytes=s0["reduce_bytes"],
        peak_gb=[r["peak_gb"] for r in ranks],
        launches=[r["launches"] for r in ranks] + [parent_launches],
        nccl=dict(identity=nccl_identity, loss_rel=nccl_loss_rel,
                  loss_bitwise=torch.equal(n0["loss"].cpu(),
                                           p0["loss"].cpu()),
                  grads_worst_rel=_tensor_rel(n0["grads"], {
                      n: g.cpu() for n, g in p0["local_grads"].items()}),
                  reduce_bytes=n0["reduce_bytes"], step_ms=n0["step_ms"],
                  plain_step_ms=p0["step_ms"], run_s=nccl_s),
        launch_s=ranks_s)
    if (not reduced_exact or not params_equal or loss_rel > 1e-4 or bad_i
            or sum_i["all_l2_rel"] > 2e-2 or update_rel > UPDATE_TOL
            or b2_rel > 1e-4 or bad_b2
            or sum_b2["all_l2_rel"] > max(2e-2, 3 * spread)
            or any(any(v.values()) for v in out["launches"])
            or not nccl_identity or nccl_loss_rel > 1e-5
            or not n0["reduce_bytes"]):
        raise AssertionError(f"phase 7a: {out} per-item {bad_i[:8]} "
                             f"batch-2 {bad_b2[:8]}")
    return out


def cp_eval(torch, ops, cfg, model, seq, window) -> dict:
    """Phase 7b: context-parallel eval, ``MESH_MODEL_AXIS=2`` over
    ``[cuda:0] * 2``, the graph path timed and profiled (B.3 once per row
    shard a frame, B.1 never), then frame by frame in lock-step with the
    unsharded evaluator on the card (B.1), in float32 compute: in bf16
    compute the two routes' maps round apart and the bf16 decoder parts
    them far (PERF.md §6), so no gate has power there."""
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.engine.lockstep import gate_failures, lockstep_masks
    from rvos_tpu_torch.models import AOCNet

    devs = [torch.device("cuda", 0)] * 2
    ccfg = cfg.replace(MESH_MODEL_AXIS=2)

    def make(c):
        def fn():
            m = AOCNet(c)
            m.load_state_dict(model.state_dict())
            return m
        return fn

    ev = Evaluator(ccfg, make(ccfg)(), device="cuda", devices=devs)
    if ev.cp_devices != devs or ev.ens_devices is not None:
        raise AssertionError(f"context parallelism not resolved: "
                             f"{ev.cp_devices}")
    r = run_video(torch, ops, ev, seq, "global_flat_min", window)
    per = r["per_frame"]
    if (per.get("global_flat_min") != [2] * (len(seq) - 1)
            or per.get("global_seg_map")):
        raise AssertionError(f"7b: B.3 not twice a frame or B.1 run: {per}")
    del ev
    locks = {}
    t0 = time.time()
    for name, kw in (("float32", dict(EVAL_COMPUTE_DTYPE="float32")),):
        lcfg = ccfg.replace(TEST_FRAME_CHUNK=1, **kw)
        lock = lockstep_masks(lcfg, make(lcfg), seq, None, device="cuda",
                              ref_device="cuda", devices=devs)
        locks[name] = dict(lockstep=min(lock.agree), dlogit=lock.max_dlogit,
                           demb=lock.max_demb, unexplained=lock.unexplained,
                           masks_parted=lock.masks_parted,
                           banks=all(lock.banks_equal), frames=len(lock.agree),
                           gate_failures=gate_failures(lock))
    f32 = locks["float32"]
    if (f32["gate_failures"] or not f32["banks"]
            or f32["frames"] != len(seq) - 1):
        raise AssertionError(f"7b lock-step against the unsharded "
                             f"evaluator: {locks}")
    r["locks"] = locks
    r["lock_s"] = time.time() - t0
    return r


def cp_kernels(torch, ops, shapes) -> dict:
    """Phase 7b at phase 2's shapes: B.3 on query-row shards and on bank
    shards (n = 2, 3) against one launch, bit for bit after the squash,
    over the occupancy bank the context-parallel path matches against
    and the full bank of no cap; mixed and float32.  Times the two-shard
    row split on the occupancy bank beside one B.3 launch and B.1."""
    from rvos_tpu_torch.ops.matching import compact_reference_bank_occupancy
    from rvos_tpu_torch.parallel import (global_matching_bank_sharded,
                                         global_matching_context_parallel)
    h4, w4 = 121, 213
    emb, lab, q = _bank(torch, shapes, 4)
    occ_r, occ_l, tile_obj = compact_reference_bank_occupancy(
        emb, lab, shapes["p"])
    qe = q.reshape(h4, w4, shapes["c"])
    bias = torch.zeros(shapes["o"], device="cuda")
    dev = torch.device("cuda", 0)
    out = {}
    for bank, (rr, ll) in (("occupancy", (occ_r, occ_l)),
                           ("cap0", (emb, lab))):
        for mixed in (False, True):
            want = ops.global_matching_flat(qe, rr, ll, bias, mixed=mixed)
            for n in (2, 3):
                for kind, fn in (("rows", global_matching_context_parallel),
                                 ("bank", global_matching_bank_sharded)):
                    n0 = ops.global_flat_min.launches
                    got = fn(qe, rr, ll, bias, [dev] * n, mixed=mixed)
                    torch.cuda.synchronize()
                    key = f"{bank}/{'mixed' if mixed else 'f32'}/{kind}{n}"
                    out[key] = bool(torch.equal(got, want))
                    if (not out[key]
                            or ops.global_flat_min.launches != n0 + n):
                        raise AssertionError(f"7b {key}: not equal to one "
                                             f"B.3 launch, or not {n} "
                                             f"launches")
    mixed = True
    out["ms_rows2"] = _time_ms(lambda: global_matching_context_parallel(
        qe, occ_r, occ_l, bias, [dev] * 2, mixed=mixed), 10)
    out["ms_b3"] = _time_ms(lambda: ops.global_matching_flat(
        qe, occ_r, occ_l, bias, mixed=mixed), 10)
    out["ms_b1"] = _time_ms(lambda: ops.global_matching_flat_segmented(
        qe, occ_r, occ_l, bias, tile_obj, mixed=mixed), 10)
    return out


# frames of phase 7c's profiled run (eager, six variants a frame: the
# profiler's record of the whole video took longer than the video), and
# of its lock-step runs (the first 8 of 16: frame by frame against the
# one-device ensemble, the variant-per-device run took 66 s for all 16)
PROFILED_FRAMES = 6
LOCK_FRAMES = 8


def sharded_ensemble(torch, ops, card, mcfg, model, mseq, mwindow) -> dict:
    """Phase 7c: the ensemble sharded over ``[cuda:0] * 2`` (a scale
    group per device) and ``[cuda:0] * 6`` (a variant per device), each
    timed and profiled (B.1 and B.4 six times a frame on the first
    ``PROFILED_FRAMES`` frames), then, on the first ``LOCK_FRAMES``
    frames, in lock-step with the one-device ensemble from copies of the same states, the
    reference embedding its own frames (where a flip twin embeds alone on
    its device, the one-device step batches it with its scale), through
    the gate: a group per device as run (the same features on both
    sides: only the order of the partitions' sums parts them), a variant
    per device in parity precision (float32 matching and compute: as run,
    the twins' embeddings rounding apart reach the bf16 matching operands,
    ROADMAP C.10, and the bf16 decoder, so no gate has power there)."""
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.engine.lockstep import gate_failures, lockstep_chunks
    from rvos_tpu_torch.models import AOCNet

    def make(c):
        def fn():
            m = AOCNet(c)
            m.load_state_dict(model.state_dict())
            return m
        return fn

    out = {}
    for n in (2, 6):
        devs = [torch.device("cuda", 0)] * n
        ev = Evaluator(mcfg, make(mcfg)(), device="cuda", devices=devs)
        parts = ev._ens_partitions()
        if ev.ens_devices != devs or len(parts) != (3 if n == 2 else 6):
            raise AssertionError(f"7c: partitions {parts}")
        r = run_video(torch, ops, ev, mseq, "global_seg_map", mwindow,
                      profile_frames=PROFILED_FRAMES)
        per = r["per_frame"]
        for k in ("global_seg_map", "local_match"):
            if per.get(k) != [6] * (PROFILED_FRAMES - 1):
                raise AssertionError(f"7c [{n}]: {k} per frame {per}")
        del ev
        locks = {}
        t0 = time.time()
        parity = dict(EVAL_COMPUTE_DTYPE="float32", MATCHING_DTYPE="float32")
        for name, kw in ((("as_run", {}),) if n == 2
                         else (("parity", parity),)):
            lcfg = mcfg.replace(**kw)
            lock = lockstep_chunks(lcfg, make(lcfg), _Head(mseq, LOCK_FRAMES),
                                   None, device="cuda", ref_device="cuda",
                                   share_masks=True, devices=devs,
                                   own_features=True)
            locks[name] = dict(lockstep=min(lock.agree),
                               dlogit=lock.max_dlogit,
                               unexplained=lock.unexplained,
                               masks_parted=lock.masks_parted,
                               frames=len(lock.agree),
                               gate_failures=gate_failures(lock))
        gated = next(iter(locks.values()))
        if gated["gate_failures"] or gated["frames"] != LOCK_FRAMES - 1:
            raise AssertionError(f"7c [{n}] lock-step against the "
                                 f"one-device ensemble: {locks}")
        r["locks"] = locks
        r["partitions"] = [list(m) for m, _, _ in parts]
        print(f"phase 7c sharded ensemble over [cuda:0] * {n} (partitions "
              f"{r['partitions']}) resnet101_aocnet 481x849 16 frames, "
              f"frame by frame: {_video_line(r)}; lock-step against the "
              f"one-device ensemble, frames 1-{LOCK_FRAMES - 1} {locks} "
              f"({time.time() - t0:.1f} s) "
              f"[{card}]", flush=True)
        out[n] = r
    return out


def phase7(torch, ops, card, base=None) -> dict:
    """Phase 7: several GPUs, driven on the one card (7a data-parallel
    training, 7b context-parallel eval and B.3's shards, 7c the sharded
    ensemble).  ``base``: phase 3's weights and its and 3c's runs of the
    full script; without them (``--only 7``) they are made here."""
    from rvos_tpu_torch.cli.profile_eval import video_steps
    from rvos_tpu_torch.configs import get_config
    from rvos_tpu_torch.data import SyntheticEval
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.weights import init_random_

    t_all = time.time()
    t0 = time.time()
    a = dp_training(torch, ops, card)
    print(f"phase 7a data-parallel training resnet101_aocnet 465x465 T=5 O=6 "
          f"remat float32 (TF32 off), global batch 2 on two gloo ranks "
          f"sharing one card (one "
          f"item each; two ranks on one card: not a data-parallel speed): "
          f"ms/step per rank {[round(v, 1) for v in a['rank_ms']]}, reduce "
          f"ms {[round(v, 1) for v in a['reduce_ms']]} of "
          f"{a['reduce_bytes']} bytes per step, peak GB per rank "
          f"{[round(v, 3) for v in a['peak_gb']]}, kernel counters (ranks, "
          f"then this process) {a['launches']}; reduce exact (the mean of "
          f"the ranks' gradients bit for bit) {a['reduce_exact']}, ranks' "
          f"parameters equal {a['ranks_params_equal']}; against the "
          f"per-item average (the card's backward is not run to run "
          f"deterministic, so the grad_check floor holds it) {a['per_item']}"
          f"; parameters against the optimizer's update of the reduced "
          f"gradient (worst rel) {a['update_worst_rel']:.3e}; against "
          f"batch 2 in one process {a['batch2']}; NCCL at world "
          f"size 1 {a['nccl']}; rank launch {a['launch_s']:.1f} s; took "
          f"{time.time() - t0:.1f} s [{card}]", flush=True)

    cfg = get_config("resnet101_aocnet")
    seq = SyntheticEval(size=(481, 849), n_seqs=1, n_frames=22, obj_num=3)[0]
    mcfg = cfg.replace(TEST_MULTISCALE=(1.0, 1.15, 1.3), TEST_FLIP=True,
                       TEST_MAX_SIZE=800.0)
    mseq = SyntheticEval(size=(481, 849), n_seqs=1, n_frames=16,
                         obj_num=3)[0]
    if base is None:
        model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
        ev = Evaluator(cfg, model, device="cuda")
        steps = [s for s in video_steps(ev, len(seq)) if len(s) == ev.chunk_n]
        window = (steps[1][0], steps[-1][-1])
        main = run_video(torch, ops, ev, seq, "global_seg_map", window)
        del ev
        mmodel = AOCNet(mcfg)
        mmodel.load_state_dict(model.state_dict())
        mev = Evaluator(mcfg, mmodel, device="cuda")
        msteps = [s for s in video_steps(mev, len(mseq))
                  if len(s) == mev.chunk_n]
        mwindow = (msteps[1][0], msteps[-1][-1])
        mf = run_video(torch, ops, mev, mseq, "global_seg_map", mwindow)
        del mev, mmodel
    else:
        model, main, window, mf, mwindow = base
    t0 = time.time()
    b = cp_eval(torch, ops, cfg, model, seq, window)
    shapes = dict(m=121 * 213, c=cfg.MODEL_SEMANTIC_EMBEDDING_DIM,
                  o=cfg.MODEL_MAX_OBJ_NUM, slots=cfg.TEST_BANK_CAPACITY,
                  p=cfg.MATCHING_MAX_REF_PIXELS)
    bk = cp_kernels(torch, ops, shapes)
    print(f"phase 7b context-parallel eval MESH_MODEL_AXIS=2 over [cuda:0, "
          f"cuda:0] resnet101_aocnet 481x849 22 frames occupancy bank "
          f"mixed, graph path: {_video_line(b)} | unsharded (phase 3): "
          f"steady_ms_per_frame={main['steady_ms']:.2f} (median "
          f"{main['median_ms']:.2f}); lock-step against the unsharded "
          f"evaluator (float32 compute, through the gate) {b['locks']} "
          f"({b['lock_s']:.1f} s); "
          f"B.3 shards at phase 2's shapes (equal "
          f"to one launch) {bk}; took {time.time() - t0:.1f} s [{card}]",
          flush=True)
    t0 = time.time()
    c = sharded_ensemble(torch, ops, card, mcfg, model, mseq, mwindow)
    print(f"phase 7c frame ms, one device (phase 3c, graph chunks): "
          f"steady_ms_per_frame={mf['steady_ms']:.2f} (median "
          f"{mf['median_ms']:.2f}); sharded over [cuda:0] * n, frame by "
          f"frame: " + ", ".join(f"n={n} {r['steady_ms']:.2f} (median "
                                 f"{r['median_ms']:.2f})"
                                 for n, r in c.items())
          + f"; phase 7c took {time.time() - t0:.1f} s; phase 7 took "
          f"{time.time() - t_all:.1f} s [{card}]", flush=True)
    return dict(a=a, b=b, bk=bk, c=c)


def phase1(torch, card) -> dict:
    """Phase 1: the build of the four CUDA sources (one ``nvcc`` each,
    started together), the ptxas report, the tensor-core instructions of
    each matching library (it must have some) and the registers, spill
    bytes and FFMA count of the float32 kernels of kernels 1 and 3 and of
    the k-means kernel (they must have FFMAs)."""
    from rvos_tpu_torch.ops import _cuda
    t0 = time.time()
    paths = _cuda.build(list(MMA_LIBS) + ["kmeans"])
    built_s = time.time() - t0
    ptxas, logs = [], {}
    for name in paths:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        logs[name] = log.read_text() if log.exists() else ""
        ptxas += [ln.strip() for ln in logs[name].splitlines()
                  if "registers" in ln or "spill" in ln
                  or "Compiling entry" in ln]
    sass = {name: _sass(path) for name, path in paths.items()}
    mma = {name: _mma_count(sass[name]) for name in paths}
    f32 = {name: f32_kernel_stats(name, sass[name], logs[name])
           for name in F32_KERNELS}
    print(f"phase 1 card: {card} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | built "
          f"{len(paths)} kernels in {built_s:.1f} s | HMMA/HGMMA in SASS "
          f"{mma} | " + " ; ".join(ptxas), flush=True)
    print(f"phase 1 float32 kernels (registers, spill bytes from ptxas, FFMA "
          f"in cuobjdump -sass): {f32}", flush=True)
    for name in MMA_LIBS:
        if not mma[name]:
            raise AssertionError(f"{name}: no tensor-core instruction in SASS")
    for name, st in f32.items():
        if not st["ffma"]:
            raise AssertionError(f"{name}: no FFMA in {st['kernel']}: {st}")
    return f32


def phase2(torch, ops, card, cfg) -> dict:
    """Phase 2: every kernel against its plain version at its path's
    shapes, timed beside its bound, the plain version and the library
    call; float32 rows also as TFLOP/s and share of bound."""
    t0 = time.time()
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
        res[("kmeans", mixed)] = check_kmeans(torch, ops, shapes, mixed)
    for (k, mixed), r in res.items():
        rate = (f" TFLOP/s={r['ops'] / r['ms'] / 1e9:.2f} "
                f"share_of_bound={r['bound_ms'] / r['ms']:.3f}"
                if not mixed else "")
        print(f"phase 2 {k} {'mixed' if mixed else 'f32'} shape={r['shape']}: "
              f"max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){rate} "
              f"library_ms={r['library_ms']}"
              + (f" sort_ms={r['sort_ms']:.4f}" if "sort_ms" in r else "")
              + f" [{card}]", flush=True)
    print(f"phase 2 took {time.time() - t0:.1f} s", flush=True)
    return res


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="smoke run of the port on a GPU")
    p.add_argument("--only", choices=["2", "3d", "5", "6", "7"], default=None,
                   help="run phases 1-2 (the build and the kernels), phase "
                        "3d (float32 matching at full width), phase 5 "
                        "(training), phase 6 (bf16 training, MobileNet) or "
                        "phase 7 (several GPUs) alone")
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
    from rvos_tpu_torch.ops.prng import kmeans_init_scores
    from rvos_tpu_torch.weights import init_random_

    # ---- phase 1: the card and the build
    card = _card()
    if args.only == "2":
        phase1(torch, card)
        phase2(torch, ops, card, get_config("resnet101_aocnet"))
    elif args.only:
        {"3d": phase3d, "5": phase5, "6": phase6,
         "7": phase7}[args.only](torch, ops, card)
    if args.only:
        print(card)
        print(json.dumps({f"phase{args.only}_only": True}))
        return 0
    phase1(torch, card)
    cfg = get_config("resnet101_aocnet")
    frame_hw = (481, 849)
    res = phase2(torch, ops, card, cfg)

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

    # ---- phase 3b: the other bank layouts, graph path, counters from 0,
    # on the video's first 12 frames (one steady chunk)
    layout_launches = {}
    bseq = _Head(seq, 12)
    for name, kw in BANK_LAYOUTS.items():
        if not kw:
            continue
        t0 = time.time()
        lcfg = cfg.replace(**kw)
        lmodel = AOCNet(lcfg)
        lmodel.load_state_dict(model.state_dict())
        lev = Evaluator(lcfg, lmodel, device="cuda")
        bsteps = [s for s in video_steps(lev, len(bseq))
                  if len(s) == lev.chunk_n]
        bwindow = (bsteps[1][0], bsteps[-1][-1])
        r = run_video(torch, ops, lev, bseq, GLOBAL_KERNEL[name], bwindow)
        layout_launches[name] = r["launches"]
        print(f"phase 3b layout {name} ({kw}) resnet101_aocnet "
              f"{frame_hw[0]}x{frame_hw[1]} {len(bseq)} frames, graph path, "
              f"steady frames {bwindow[0]}-{bwindow[1]}: "
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

    # ---- phase 3d: float32 (parity) matching at full width
    parity = phase3d(torch, ops, card, (model, seq))

    # ---- phase 4: small-size reference check, card vs CPU, parity
    # setting; float32 matching, then mixed matching (tensor-core paths);
    # then the ensemble (scales 1.0 and 1.3 with flip: 65×65 and 81×81)
    def mf_config(matching, chunk=1):
        return parity_config("occupancy", matching).replace(
            TEST_FLIP=True, TEST_MULTISCALE=(1.0, 1.3), TEST_FRAME_CHUNK=chunk,
            MEM_EVERY=3 if chunk > 1 else 2)

    seeded_models = {}

    def seeded(c):
        """Seed 0's weights under ``c``: built once for each model shape
        (the ``MODEL_`` fields decide it), then a copy that carries ``c``
        (building and seeding a full-width model took about a second, and
        these checks make about sixty)."""
        key = repr(sorted((k, v) for k, v in vars(c).items()
                          if k.startswith("MODEL_")))

        def make():
            if key not in seeded_models:
                seeded_models[key] = init_random_(
                    AOCNet(c), torch.Generator().manual_seed(0))
            m = copy.deepcopy(seeded_models[key])
            m.cfg = c
            return m
        return make

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

    seeded_models.clear()
    f32_train = phase5(torch, ops, card)
    mobile = phase6(torch, ops, card, f32_train)
    multi = phase7(torch, ops, card, (model, main, window, mf, mwindow))

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
        layout = {"global": "occupancy", "flat": "cap0"}.get(key)
        if layout:
            entry["f32_parity_frame_ms"] = parity[layout]["steady_ms"]
            entry["f32_parity_per_frame"] = parity[layout]["per_frame"][
                "f32_global"]
        if key in ("global", "local"):
            rm, rmp = res[(key + "_mf", True)], res[(key + "_mf", False)]
            entry.update({
                "mobilenet_launches": mobile["launches"][name],
                "mobilenet_per_frame": mobile["per_frame"][
                    "global_seg_map" if key == "global" else name],
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
        if key in ("global", "local"):
            entry["sharded_ensemble_launches"] = {
                n: r7["launches"][name] for n, r7 in multi["c"].items()}
            entry["sharded_ensemble_per_frame"] = {
                n: r7["per_frame"][PROFILED_GLOBAL.get(name, name)]
                for n, r7 in multi["c"].items()}
        if key == "flat":
            entry.update({
                "cp_row_shard_launches":
                    multi["b"]["launches"]["global_flat_min"],
                "cp_row_shard_per_frame":
                    multi["b"]["per_frame"]["global_flat_min"],
                "cp_row_shards_ms": multi["bk"]["ms_rows2"],
                "cp_one_launch_ms": multi["bk"]["ms_b3"],
                "cp_unsharded_b1_ms": multi["bk"]["ms_b1"]})
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
