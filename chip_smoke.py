#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rvos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of the
   three CUDA sources in ``rvos_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together);
2. each kernel against its plain PyTorch version at the shapes of the
   path that runs it, in float32 (max |Δ|/max(|d|, 1) ≤ 1e-4) and mixed
   precision (≤ 4e-3), with its time beside the plain version's, its
   bound and, for the global kernels, the cross-term ``torch.matmul`` as
   a floor: kernel 1 (B.1) at the occupancy bank, kernel 1's uniform
   entry (B.2) at the uniform-quota bank, kernel 3 (B.3) at no cap and
   at the fg-union bank, kernel 2 (B.4);
3. the main path: the streaming evaluator with the full
   ``resnet101_aocnet`` preset (ResNet-101, 11 object channels, 8-slot
   bank, 16,384-row occupancy bank, bf16 compute, mixed matching) and
   random weights from a seeded generator, on a 12-frame 3-object
   synthetic video at 481×849; every launch counter is set to 0 just
   before and read after, and each kernel must have launched on every
   frame after the first;
3b. the same run under each other bank layout — no cap
   (``MATCHING_MAX_REF_PIXELS=0``) and the fg-union bank
   (``MATCHING_SEGMENTED_BANK=False``) through kernel 3, the
   uniform-quota bank (``MATCHING_OCCUPANCY_BANK=False``) through B.2 —
   with the counters set to 0 before each: the layout's global kernel
   and kernel 2 launch on every frame after the first, kernel 1's
   occupancy entry never;
4. the slice at a small size in parity mode under each bank layout, on
   the card (kernels) against the CPU (plain versions), each frame and
   each bank compaction of the CPU computed from the card's state
   (``engine.lockstep``): the masks must agree on every frame and the
   compacted banks be identical; under the layouts of
   ``WHOLE_VIDEO_LAYOUTS`` two whole-video runs must agree as well.

The lines before the last are a JSON object of the kernels' numbers and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

F32_TOL, MIXED_TOL = 1e-4, 4e-3
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


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
    cross term at the operands' rate and the O adds and mins per
    (query, bank row) pair of the penalised min at the float32 rate."""
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
    return _measure(
        torch, "global_flat_min", mixed,
        lambda: ops.global_flat_min(q, r, lab, mixed),
        lambda: ops.global_flat_min_plain(q, r, lab, mixed),
        _cross(torch, q, r, mixed, 16384), (m * c + n * c + n * o + m * o) * 4,
        2.0 * m * n * c, [m, n, c, o], f32_ops=2.0 * m * n * o,
        plain_reps=1, reps=10 if fg_union else 3, live=(live, 2.5e4))


def check_local(torch, ops, shapes, mixed: bool):
    """Kernel 2 at the main path's shapes: the 2×-downsampled grid, both
    previous embeddings in one launch, 11 object channels."""
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
        lambda: ops.local_match_plain(x, ys, onehot, radii, atrous), None,
        3 * h * w * c * elt + h * w * o * 4 + 2 * h * w * o * len(radii) * 4,
        2.0 * 2 * c * pairs, [2, h, w, c, o, len(radii)], plain_reps=1)


# the kernel wrapper that each bank layout's global stream launches
GLOBAL_KERNEL = {"occupancy": "global_seg_map", "uniform": "global_seg",
                 "unsegmented": "global_flat_min", "cap0": "global_flat_min"}
COUNTED = ("global_seg_map", "global_seg", "global_flat_min", "local_match")


def run_video(torch, ops, ev, seq, global_kernel):
    """Stream ``seq`` with every launch counter set to 0 just before;
    the layout's global kernel and kernel 2 must launch on every frame
    after the first.  Returns (output, launches, steady ms, peak GB)."""
    counts, stamps = [], []

    def on_frame(f):
        torch.cuda.synchronize()
        stamps.append(time.time())
        counts.append([getattr(ops, k).launches for k in COUNTED])

    torch.cuda.reset_peak_memory_stats()
    for k in COUNTED:
        getattr(ops, k).launches = 0
    out = ev.evaluate_sequence(seq, frame_callback=on_frame)
    launches = {k: getattr(ops, k).launches for k in COUNTED}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for f in range(1, len(counts)):
        for i, k in enumerate(COUNTED):
            if k in (global_kernel, "local_match") and \
                    counts[f][i] - counts[f - 1][i] < 1:
                raise AssertionError(f"{k} not launched on frame {f}")
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
    st = ev._last_state
    for t in (st.prev_emb, st.memory.slot0, st.memory.slot1, st.ref_emb):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite values in the streaming state")
    steady = [b - a for a, b in zip(stamps[2:], stamps[3:])]
    steady_ms = 1e3 * sorted(steady)[len(steady) // 2]
    return out, launches, steady_ms, peak_gb


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from rvos_tpu_torch import ops
    from rvos_tpu_torch.configs import BANK_LAYOUTS, get_config
    from rvos_tpu_torch.data import SyntheticEval
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.engine.lockstep import (WHOLE_VIDEO_LAYOUTS,
                                                lockstep_masks, parity_config,
                                                parity_scores,
                                                whole_video_agreement)
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.ops import _cuda
    from rvos_tpu_torch.weights import init_random_

    # ---- phase 1: the card and the build
    card = _card()
    t0 = time.time()
    paths = _cuda.build(["global_seg_map", "local_match", "global_flat_match"])
    ptxas = []
    for name in paths:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    print(f"phase 1 card: {card} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | built "
          f"{len(paths)} kernels in {time.time() - t0:.1f} s | "
          + " ; ".join(ptxas), flush=True)

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
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for mixed in (False, True):
        res[("global", mixed)] = check_global(torch, ops, shapes, mixed)
        res[("uniform", mixed)] = check_uniform(torch, ops, shapes, mixed)
        res[("flat", mixed)] = check_flat(torch, ops, shapes, mixed, False)
        res[("flat_fg", mixed)] = check_flat(torch, ops, shapes, mixed, True)
        res[("local", mixed)] = check_local(torch, ops, shapes, mixed)
    for (k, mixed), r in res.items():
        print(f"phase 2 {k} {'mixed' if mixed else 'f32'} shape={r['shape']}: "
              f"max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']} [{card}]", flush=True)
    print(f"phase 2 took {time.time() - t0:.1f} s", flush=True)

    # ---- phase 3: the main path, counters from 0
    t0 = time.time()
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
    ev = Evaluator(cfg, model, device="cuda")
    seq = SyntheticEval(size=frame_hw, n_seqs=1, n_frames=12, obj_num=3)[0]
    out, main_launches, steady_ms, peak_gb = run_video(
        torch, ops, ev, seq, "global_seg_map")
    labels = sorted({int(v) for m in out["results"].values()
                     for v in set(m.ravel())})
    print(f"phase 3 main path resnet101_aocnet {frame_hw[0]}x{frame_hw[1]} "
          f"12 frames: launches global={main_launches['global_seg_map']} "
          f"local={main_launches['local_match']} "
          f"fps={out['fps']:.3f} (all frames, first ones included) "
          f"steady_ms_per_frame={steady_ms:.2f} peak_mem_gb={peak_gb:.3f} "
          f"labels={labels} took {time.time() - t0:.1f} s [{card}]", flush=True)

    # ---- phase 3b: the other bank layouts, counters from 0 for each
    layout_launches = {}
    for name, kw in BANK_LAYOUTS.items():
        if not kw:
            continue
        t0 = time.time()
        lcfg = cfg.replace(**kw)
        lmodel = AOCNet(lcfg)
        lmodel.load_state_dict(model.state_dict())
        lev = Evaluator(lcfg, lmodel, device="cuda")
        out, launches, steady_ms, peak_gb = run_video(torch, ops, lev, seq,
                                                      GLOBAL_KERNEL[name])
        layout_launches[name] = launches
        print(f"phase 3b layout {name} ({kw}) resnet101_aocnet "
              f"{frame_hw[0]}x{frame_hw[1]} 12 frames: launches {launches} "
              f"fps={out['fps']:.3f} steady_ms_per_frame={steady_ms:.2f} "
              f"peak_mem_gb={peak_gb:.3f} took {time.time() - t0:.1f} s "
              f"[{card}]", flush=True)
        del lev, lmodel

    # ---- phase 4: small-size reference check, card vs CPU, parity mode
    t0 = time.time()
    agree = {}
    for name in BANK_LAYOUTS:
        small = parity_config(name)

        def make_model():
            return init_random_(AOCNet(small), torch.Generator().manual_seed(0))

        def make_seq():
            return SyntheticEval(size=(65, 65), n_seqs=1, n_frames=6)[0]

        lock = lockstep_masks(small, make_model, make_seq(), parity_scores)
        whole = None
        if name in WHOLE_VIDEO_LAYOUTS:
            whole = whole_video_agreement(small, make_model, make_seq,
                                          parity_scores)
        agree[name] = dict(lockstep=min(lock.agree), dlogit=lock.max_dlogit,
                           demb=lock.max_demb, banks=lock.banks_equal,
                           whole_video=min(whole) if whole else None)
        if not (len(lock.agree) == 5 and min(lock.agree) >= 0.999
                and lock.max_dlogit < 1e-2 and lock.max_demb < 1e-3
                and lock.banks_equal and all(lock.banks_equal)
                and (whole is None or (len(whole) == 5
                                       and min(whole) >= 0.999))):
            raise AssertionError(f"{name}: card vs CPU: {agree[name]}, "
                                 f"lock-step frames {lock.agree}, whole "
                                 f"video {whole}")
    print(f"phase 4 small parity card vs cpu (min per-frame agreement in "
          f"lock-step and whole-video runs, max |dlogit|, max |demb|, bank "
          f"compactions identical): {agree}, took {time.time() - t0:.1f} s",
          flush=True)

    kernels = []
    for key, name, src, rep, n in (
            ("global", "global_seg_map", "rvos_tpu_torch/csrc/global_seg_map.cu",
             "rvos_tpu/ops/pallas_matching.py:136",
             main_launches["global_seg_map"]),
            ("uniform", "global_seg", "rvos_tpu_torch/csrc/global_seg_map.cu",
             "rvos_tpu/ops/pallas_matching.py:87",
             layout_launches["uniform"]["global_seg"]),
            ("flat", "global_flat_min",
             "rvos_tpu_torch/csrc/global_flat_match.cu",
             "rvos_tpu/ops/pallas_matching.py:47",
             layout_launches["cap0"]["global_flat_min"]),
            ("local", "local_match", "rvos_tpu_torch/csrc/local_match.cu",
             "rvos_tpu/ops/pallas_local.py:39", main_launches["local_match"])):
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
