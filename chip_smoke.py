#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rvos_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of both
   CUDA kernels from ``rvos_tpu_torch/csrc`` (one ``nvcc`` per source,
   started together);
2. each kernel against its plain PyTorch version at the main path's
   shapes, in float32 (max |Δ|/max(|d|, 1) ≤ 1e-4) and mixed precision
   (≤ 4e-3), with its time beside the plain version's, its bound and,
   for kernel 1, the cross-term ``torch.matmul`` as a floor;
3. the main path: the streaming evaluator with the full
   ``resnet101_aocnet`` preset (ResNet-101, 11 object channels, 8-slot
   bank, 16,384-row occupancy bank, bf16 compute, mixed matching) and
   random weights from a seeded generator, on a 12-frame 3-object
   synthetic video at 481×849; every launch counter is set to 0 just
   before and read after, and each kernel must have launched on every
   frame after the first;
4. the slice at a small size in parity mode, on the card (kernels)
   against the CPU (plain versions): the masks must agree.

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


def _bound_ms(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def check_global(torch, ops, shapes, mixed: bool, reps: int = 10):
    """Kernel 1 at the main path's shapes: query rows of one frame and an
    occupancy bank compacted from 8 slots of 3-object labels."""
    from rvos_tpu_torch.ops.matching import compact_reference_bank_occupancy
    m, c, o, slots = shapes["m"], shapes["c"], shapes["o"], shapes["slots"]
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    emb = torch.relu(torch.randn((slots * m, c), generator=g, device=dev))
    lab_id = torch.randint(0, 4, (slots * m,), generator=g, device=dev)
    lab = torch.nn.functional.one_hot(lab_id, o).float()
    r, rl, tile_obj = compact_reference_bank_occupancy(emb, lab, shapes["p"])
    p = r.shape[0]
    row_obj = tile_obj.long().repeat_interleave(p // tile_obj.shape[0])
    bias = (1.0 - rl.gather(1, row_obj[:, None])[:, 0]) * 5e4
    q = torch.relu(torch.randn((m, c), generator=g, device=dev))
    if mixed:
        q, r = q.bfloat16().float(), r.bfloat16().float()
    got = ops.global_seg_map(q, r, bias, tile_obj, o, mixed)
    want = ops.global_seg_map_plain(q, r, bias, tile_obj, o, mixed)
    torch.cuda.synchronize()
    live = int((want < 5e4).all(0).sum())
    if live != int(torch.bincount(tile_obj.long()).gt(0).sum()):
        raise AssertionError(f"global_seg_map: {live} live channels")
    abs_err, rel_err = _errs(got, want)
    tol = MIXED_TOL if mixed else F32_TOL
    if not rel_err <= tol:
        raise AssertionError(f"global_seg_map mixed={mixed}: rel err "
                             f"{rel_err:.3e} > {tol}")
    ms = _time_ms(lambda: ops.global_seg_map(q, r, bias, tile_obj, o, mixed),
                  reps)
    plain_ms = _time_ms(
        lambda: ops.global_seg_map_plain(q, r, bias, tile_obj, o, mixed), 3)
    qd, rd = (q.bfloat16(), r.bfloat16()) if mixed else (q, r)
    lib_ms = _time_ms(lambda: torch.matmul(qd, rd.T), reps)
    n_bytes = (m * c + p * c + p + m * o) * 4 + tile_obj.numel() * 4
    bound, by = _bound_ms(n_bytes, 2.0 * m * p * c, "bf16" if mixed else "f32")
    return dict(max_abs_err=abs_err, rel_err=rel_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, shape=[m, p, c, o])


def check_local(torch, ops, shapes, mixed: bool, reps: int = 10):
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
    got = ops.local_match(x, ys, onehot, radii, atrous)
    want = ops.local_match_plain(x, ys, onehot, radii, atrous)
    torch.cuda.synchronize()
    abs_err, rel_err = _errs(got, want)
    tol = MIXED_TOL if mixed else F32_TOL
    if not rel_err <= tol:
        raise AssertionError(f"local_match mixed={mixed}: rel err "
                             f"{rel_err:.3e} > {tol}")
    ms = _time_ms(lambda: ops.local_match(x, ys, onehot, radii, atrous), reps)
    plain_ms = _time_ms(
        lambda: ops.local_match_plain(x, ys, onehot, radii, atrous), 1)
    a_max = radii[-1] // atrous
    pairs = sum(max(h - abs(dy) * atrous, 0) * max(w - abs(dx) * atrous, 0)
                for dy in range(-a_max, a_max + 1)
                for dx in range(-a_max, a_max + 1))      # in-frame only
    elt = x.element_size()
    n_bytes = (3 * h * w * c * elt + h * w * o * 4
               + 2 * h * w * o * len(radii) * 4)
    bound, by = _bound_ms(n_bytes, 2.0 * 2 * c * pairs,
                          "bf16" if mixed else "f32")
    return dict(max_abs_err=abs_err, rel_err=rel_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, shape=[2, h, w, c, o, len(radii)])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from rvos_tpu_torch import ops
    from rvos_tpu_torch.configs import get_config, tiny_test
    from rvos_tpu_torch.data import SyntheticEval
    from rvos_tpu_torch.engine import Evaluator
    from rvos_tpu_torch.models import AOCNet
    from rvos_tpu_torch.ops import _cuda
    from rvos_tpu_torch.weights import init_random_

    # ---- phase 1: the card and the build
    card = _card()
    t0 = time.time()
    paths = _cuda.build(["global_seg_map", "local_match"])
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

    # ---- phase 2: kernels vs plain versions at the main path's shapes
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
        res[("local", mixed)] = check_local(torch, ops, shapes, mixed)
    for (k, mixed), r in res.items():
        print(f"phase 2 {k} {'mixed' if mixed else 'f32'} shape={r['shape']}: "
              f"max_abs_err={r['max_abs_err']:.3e} rel={r['rel_err']:.3e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']} [{card}]", flush=True)

    # ---- phase 3: the main path, counters from 0
    model = init_random_(AOCNet(cfg), torch.Generator().manual_seed(0))
    ev = Evaluator(cfg, model, device="cuda")
    seq = SyntheticEval(size=frame_hw, n_seqs=1, n_frames=12, obj_num=3)[0]
    counts, stamps = [], []

    def on_frame(f):
        torch.cuda.synchronize()
        stamps.append(time.time())
        counts.append((ops.global_seg_map.launches, ops.local_match.launches))

    torch.cuda.reset_peak_memory_stats()
    ops.global_seg_map.launches = 0
    ops.local_match.launches = 0
    out = ev.evaluate_sequence(seq, frame_callback=on_frame)
    launches = (ops.global_seg_map.launches, ops.local_match.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for f in range(1, len(counts)):
        for k, name in enumerate(("global_seg_map", "local_match")):
            if counts[f][k] - counts[f - 1][k] < 1:
                raise AssertionError(f"{name} not launched on frame {f}")
    results = out["results"]
    if len(results) != 11:
        raise AssertionError(f"{len(results)} masks for 11 frames")
    for name, mask in results.items():
        if mask.shape != frame_hw or mask.dtype.name != "uint8":
            raise AssertionError(f"{name}: mask {mask.shape} {mask.dtype}")
        if not set(mask.ravel().tolist()) <= {0, 1, 2, 3}:
            raise AssertionError(f"{name}: labels outside the 3 objects")
    st = ev._last_state
    for t in (st.prev_emb, st.memory.slot0, st.memory.slot1, st.ref_emb):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite values in the streaming state")
    steady = [b - a for a, b in zip(stamps[2:], stamps[3:])]
    steady_ms = 1e3 * sorted(steady)[len(steady) // 2]
    labels = sorted({int(v) for m in results.values() for v in set(m.ravel())})
    print(f"phase 3 main path resnet101_aocnet {frame_hw[0]}x{frame_hw[1]} "
          f"12 frames: launches global={launches[0]} local={launches[1]} "
          f"fps={out['fps']:.3f} (all frames, first ones included) "
          f"steady_ms_per_frame={steady_ms:.2f} peak_mem_gb={peak_gb:.3f} "
          f"labels={labels} [{card}]", flush=True)

    # ---- phase 4: small-size reference check, card vs CPU, parity mode
    small = tiny_test(DATA_RANDOMCROP=(65, 65), MODEL_MULTI_LOCAL_DISTANCE=(2, 4),
                      MODEL_MAX_OBJ_NUM=4, TEST_MAX_SIZE=None,
                      TEST_BANK_CAPACITY=3, MEM_EVERY=2,
                      EVAL_COMPUTE_DTYPE="float32")

    def scores(f, n_obj, n_rows):
        g = torch.Generator().manual_seed(f)
        return 0.5 + 0.5 * torch.rand((n_obj, n_rows), generator=g)

    masks = {}
    for d in ("cpu", "cuda"):
        m = init_random_(AOCNet(small), torch.Generator().manual_seed(0))
        e = Evaluator(small, m, device=d, kmeans_scores=scores)
        s = SyntheticEval(size=(65, 65), n_seqs=1, n_frames=6)[0]
        masks[d] = e.evaluate_sequence(s)["results"]
    agree = min((masks["cuda"][k] == v).mean() for k, v in masks["cpu"].items())
    if not agree >= 0.999:
        raise AssertionError(f"card vs CPU masks agree on {agree:.4f}")
    print(f"phase 4 small parity card vs cpu: min per-frame agreement "
          f"{agree:.5f} over {len(masks['cpu'])} frames", flush=True)

    kernels = []
    for key, name, src, rep, n in (
            ("global", "global_seg_map", "rvos_tpu_torch/csrc/global_seg_map.cu",
             "rvos_tpu/ops/pallas_matching.py:136", launches[0]),
            ("local", "local_match", "rvos_tpu_torch/csrc/local_match.cu",
             "rvos_tpu/ops/pallas_local.py:39", launches[1])):
        r, rp = res[(key, True)], res[(key, False)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "mode": "mixed", "f32_max_abs_err": rp["max_abs_err"],
            "f32_ms": rp["ms"], "f32_plain_ms": rp["plain_ms"],
            "f32_bound_ms": rp["bound_ms"], "f32_library_ms": rp["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
