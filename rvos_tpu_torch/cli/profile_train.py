"""Training step time on the card: ``Trainer.fit`` at full
``resnet101_aocnet`` width on 465×465 synthetic clips (``SyntheticTrain``
with five objects, O = 6; T = 5; float32 with TF32 for convolutions
only; remat), random weights from a seed.

    python -m rvos_tpu_torch.cli.profile_train --batch 1 2 4
    python -m rvos_tpu_torch.cli.profile_train --batch 2 \
        --compute_dtype bfloat16 [--backbone mobilenet]

For each batch size: ``--steps`` steps of ``fit`` timed by CUDA events
recorded after each step (the steady ms/step is the median of steps 2 on),
clips/s, the peak device memory (``torch.cuda.max_memory_allocated``
less what was allocated before the run),
then one more step under ``torch.profiler``: device busy ms (the sum of
the device events), idle share and kernels per step, and the kernels
with the most device time.  A batch that does not fit prints the
out-of-memory message and the next one runs.  Needs a CUDA card.

``--by_stage``: one more step under ``torch.profiler``, its kernels and
device time by stage of the step (``STAGES``: the innermost named
operation or range above each kernel's launching operation, with
ranges opened around the bf16 casts, the resizes and GCT for that step
only; a backward operation takes the stage of the forward operation
that made its node, by sequence number), forward and backward apart.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time


def train_config(batch: int, steps: int, root: str, **kw):
    """The preset as ``chip_smoke.py`` phase 5a and this script train it:
    burn-in from step 3, hard mining annealed over 4 steps, no resume."""
    from ..configs import get_config
    return get_config("resnet101_aocnet").replace(
        TRAIN_BATCH_SIZE=batch, TRAIN_TOTAL_STEPS=steps,
        TRAIN_START_SEQ_TRAINING_STEPS=2, TRAIN_HARD_MINING_STEP=4,
        TRAIN_AUTO_RESUME=False, TRAIN_REMAT=True, DATA_WORKERS=2,
        DIR_ROOT=root, **kw)


def profile_training(torch, cfg, steps: int, seed: int = 0,
                     inspect=None, by_stage: bool = False) -> dict:
    """Run ``steps`` steps of ``fit`` (then one profiled step) →
    per-step metrics, step times, peak memory, device busy, idle share,
    kernels per step and the top kernels.  The peak is the training's
    own (model, optimizer state, activations): the device memory the
    caller already held (``held_gb``) is taken off it.  ``inspect``, when
    given, is called with the trainer before its first step (a caller
    hooks its model there) and its result returned as ``inspected``.
    ``by_stage``: then one more step by stage (``profile_by_stage``)."""
    from ..data import SyntheticTrain, TrainBatcher
    from ..engine.train import Trainer
    from .profile_eval import FILLER, device_records, pad_profile
    from .train import train_transform

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, device="cuda", seed=seed)
    inspected = inspect(trainer) if inspect is not None else None
    data = SyntheticTrain(size=cfg.DATA_RANDOMCROP,
                          curr_len=cfg.DATA_CURR_SEQ_LEN,
                          obj_num=cfg.DATA_MAX_OBJ_NUM,
                          length=cfg.TRAIN_BATCH_SIZE * (steps + 2))
    batcher = TrainBatcher(data, cfg.TRAIN_BATCH_SIZE,
                           train_transform(cfg, True),
                           num_workers=cfg.DATA_WORKERS)
    before = {n: p.detach().cpu()
              for n, p in trainer.model.named_parameters()}
    rows, ends = [], []

    def on_step(step, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        rows.append({"step": step, "loss": float(m["loss"]),
                     "iou": float(m["iou"]),
                     "grad_norm": float(m["grad_norm"]),
                     "lr": trainer.lr_fn(trainer.optimizer.count - 1),
                     "applied": m["applied"]})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.fit(batcher, log_every=1, max_steps=steps, callback=on_step)
    torch.cuda.synchronize()
    marks = [start] + ends
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    moved = max(float((p.detach().cpu() - before[n]).abs().max())
                for n, p in trainer.model.named_parameters())
    out = {"rows": rows, "step_ms": step_ms, "inspected": inspected,
           "steady_ms": statistics.median(step_ms[1:]),
           "peak_gb": peak, "held_gb": held / 1e9, "moved": moved}
    out["clips_s"] = cfg.TRAIN_BATCH_SIZE / out["steady_ms"] * 1e3

    # the device's activity alone: every number below reads kernels, and
    # recording the host's operations too slowed the profiled step and
    # took tens of seconds to process
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.__enter__()
    t0 = time.time()
    trainer.fit(batcher, log_every=1, max_steps=steps + 1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    pad_profile(torch)
    prof.__exit__(None, None, None)
    records = device_records(prof)
    if not any(FILLER in name for name, _, _ in records):
        raise RuntimeError("the profiler lost the end of its record")
    by_name = {}
    for name, _, us in records:
        if FILLER not in name:
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + us, n + 1)
    busy = sum(t for t, _ in by_name.values())
    out.update(profiled_wall_ms=wall * 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / 1e6 / wall,
               kernels=sum(n for _, n in by_name.values()))
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    out["top"] = [(name[:60], t / 1e3, n) for name, (t, n) in top]
    if by_stage:
        out["by_stage"] = profile_by_stage(torch, trainer, batcher,
                                           steps + 2)
    return out


# stage of an operation: the first of these found on its profiler parent
# chain, innermost first (names of operations and of the ranges that
# ``_spans`` opens); a backward operation takes the stage of the forward
# operation that made its autograd node
STAGES = (("bf16 casts", ("bf16 casts",)),
          ("local matching", ("LocalMatchingMin",)),
          ("global matching", ("GlobalMatchingMin",)),
          ("GCT", ("GCT",)),
          ("resize", ("resize",)),
          ("group norm", ("aten::group_norm",)),
          ("convolution", ("aten::conv2d", "aten::convolution")),
          ("dense", ("aten::linear",)))
_BWD = "autograd::engine::evaluate_function: "
# the ranges opened for one profiled step: label → (module, function or
# Class.method), looked up where the port's modules bind it
SPANS = {"bf16 casts": ("rvos_tpu_torch.engine.train", "cast_state"),
         "resize": ("rvos_tpu_torch.ops.resize", "resize_nchw"),
         "GCT": ("rvos_tpu_torch.models.layers", "GCT.forward")}


@contextlib.contextmanager
def _spans():
    """``record_function`` ranges around the functions of ``SPANS``
    while the block runs: every binding of one in the port's loaded
    modules (or the class attribute of a method) is replaced by a
    wrapper, and restored after."""
    from torch.profiler import record_function

    def wrap(fn, label):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    undo = []
    for label, (mod_name, name) in SPANS.items():
        mod = sys.modules[mod_name]
        if "." in name:
            cls_name, meth = name.split(".")
            cls = getattr(mod, cls_name)
            real = getattr(cls, meth)
            setattr(cls, meth, wrap(real, label))
            undo.append((cls, meth, real))
            continue
        real = getattr(mod, name)
        for m in list(sys.modules.values()):
            if (getattr(m, "__name__", "").startswith("rvos_tpu_torch")
                    and getattr(m, name, None) is real):
                setattr(m, name, wrap(real, label))
                undo.append((m, name, real))
    try:
        yield
    finally:
        for obj, name, real in undo:
            setattr(obj, name, real)


def _stage_of(e, forward_of, depth: int = 0) -> str:
    """The stage of profiler event ``e`` (``bwd `` prefixed for the
    backward, nested backwards included)."""
    a = e
    while a is not None:
        if a.name.startswith(_BWD):
            f = forward_of.get((a.fwd_thread or a.thread, a.sequence_nr))
            if f is None or depth > 3:
                return "bwd unattributed"
            return "bwd " + _stage_of(f, forward_of, depth + 1
                                      ).removeprefix("bwd ")
        for stage, names in STAGES:
            if a.name in names:
                return stage
        a = a.cpu_parent
    return "other"


def stage_breakdown(prof, device: bool = True) -> dict:
    """Kernels and their device ms (``device``) or operations and their
    self CPU ms (the CPU) of a profiled step, by stage; ``device``
    kernels are taken from the device events and their launching
    operations (``_kernels``: how many of them, of the device events)."""
    events = prof.events()
    # the operation that made a node is the last forward operation of
    # its thread that recorded its sequence number (those before it
    # record it too; each thread counts its own: a recomputation under
    # remat runs on the backward's thread)
    forward_of = {(e.thread, e.sequence_nr): e for e in events
                  if e.sequence_nr >= 0 and not e.name.startswith("autograd::")
                  and "Backward" not in e.name}
    rows = []
    if device:
        on_dev = [e for e in events if str(e.device_type).endswith("CUDA")]
        for e in on_dev:
            if e.cpu_parent is not None:
                rows.append((e.cpu_parent, 1, e.device_time_total / 1e3))
        if len(rows) < 0.9 * len(on_dev):
            rows = [(e, len(e.kernels),
                     sum(k.duration for k in e.kernels) / 1e3)
                    for e in events if e.kernels]
    else:
        rows = [(e, 1, e.self_cpu_time_total / 1e3) for e in events
                if not e.cpu_children and e.name.startswith("aten::")]
    out = {}
    for e, n, ms in rows:
        row = out.setdefault(_stage_of(e, forward_of), [0, 0.0])
        row[0] += n
        row[1] += ms
    out = dict(sorted(out.items(), key=lambda kv: -kv[1][1]))
    if device:
        out["_kernels"] = [sum(r[1] for r in rows), len(on_dev)]
    return out


def profile_by_stage(torch, trainer, batcher, steps: int) -> dict:
    """One more step of ``trainer`` (``fit`` to ``steps``) under
    ``torch.profiler`` and ``_spans`` → ``stage_breakdown``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = trainer.device.type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with _spans(), profile(activities=acts) as prof:
        trainer.fit(batcher, log_every=1, max_steps=steps)
        if cuda:
            torch.cuda.synchronize()
    return stage_breakdown(prof, cuda)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", nargs="+", type=int, default=[1, 2, 4])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="TRAIN_COMPUTE_DTYPE")
    p.add_argument("--backbone", default="resnet",
                   choices=["resnet", "mobilenet"], help="MODEL_BACKBONE")
    p.add_argument("--by_stage", action="store_true",
                   help="one more profiled step, kernels by stage")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for b in args.batch:
        with tempfile.TemporaryDirectory() as root:
            cfg = train_config(b, args.steps, root,
                               TRAIN_COMPUTE_DTYPE=args.compute_dtype,
                               MODEL_BACKBONE=args.backbone)
            try:
                r = profile_training(torch, cfg, args.steps, args.seed,
                                     by_stage=args.by_stage)
            except torch.cuda.OutOfMemoryError as e:
                print(f"batch {b}: out of memory: {str(e).splitlines()[0]} "
                      f"[{card}]", flush=True)
                torch.cuda.empty_cache()
                continue
        print(f"batch {b} ({args.backbone}, {args.compute_dtype}): steady "
              f"{r['steady_ms']:.1f} ms/step (median of "
              f"steps 2-{args.steps}; steps "
              f"{[round(t, 1) for t in r['step_ms']]}), "
              f"{r['clips_s']:.3f} clips/s, peak {r['peak_gb']:.3f} GB "
              f"(above {r['held_gb']:.3f} GB held before), "
              f"profiled step: wall {r['profiled_wall_ms']:.1f} ms, device "
              f"busy {r['busy_ms']:.1f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['kernels']} kernels [{card}]",
              flush=True)
        for name, ms, n in r["top"]:
            print(f"  kernel {name:60s} {ms:9.3f} ms x{n}")
        for stage, (n, ms) in r.get("by_stage", {}).items():
            if not stage.startswith("_"):
                print(f"  stage {stage:30s} {ms:9.3f} ms {n:7d} kernels")
        if "by_stage" in r:
            print("  stages " + json.dumps(r["by_stage"]), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
