"""Training step time on the card: ``Trainer.fit`` at full
``resnet101_aocnet`` width on 465×465 synthetic clips (``SyntheticTrain``
with five objects, O = 6; T = 5; float32 with TF32 for convolutions
only; remat), random weights from a seed.

    python -m rvos_tpu_torch.cli.profile_train --batch 1 2 4

For each batch size: ``--steps`` steps of ``fit`` timed by CUDA events
recorded after each step (the steady ms/step is the median of steps 2 on),
clips/s, the peak device memory (``torch.cuda.max_memory_allocated``
less what was allocated before the run),
then one more step under ``torch.profiler``: device busy ms (the sum of
the device events), idle share and kernels per step, and the kernels
with the most device time.  A batch that does not fit prints the
out-of-memory message and the next one runs.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
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


def profile_training(torch, cfg, steps: int, seed: int = 0) -> dict:
    """Run ``steps`` steps of ``fit`` (then one profiled step) →
    per-step metrics, step times, peak memory, device busy, idle share,
    kernels per step and the top kernels.  The peak is the training's
    own (model, optimizer state, activations): the device memory the
    caller already held (``held_gb``) is taken off it."""
    from ..data import SyntheticTrain, TrainBatcher
    from ..engine.train import Trainer
    from .profile_eval import FILLER, pad_profile
    from .train import train_transform

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, device="cuda", seed=seed)
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
    out = {"rows": rows, "step_ms": step_ms,
           "steady_ms": statistics.median(step_ms[1:]),
           "peak_gb": peak, "held_gb": held / 1e9, "moved": moved}
    out["clips_s"] = cfg.TRAIN_BATCH_SIZE / out["steady_ms"] * 1e3

    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.__enter__()
    t0 = time.time()
    trainer.fit(batcher, log_every=1, max_steps=steps + 1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    pad_profile(torch)
    prof.__exit__(None, None, None)
    if not any(FILLER in e.key for e in prof.events()):
        raise RuntimeError("the profiler lost the end of its record")

    def on_device(e):
        return str(e.device_type).endswith("CUDA") and FILLER not in e.key

    busy = sum(e.device_time_total for e in prof.events() if on_device(e))
    out.update(profiled_wall_ms=wall * 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / 1e6 / wall,
               kernels=sum(1 for e in prof.events() if on_device(e)))
    top = sorted((e for e in prof.key_averages() if on_device(e)),
                 key=lambda e: e.device_time_total, reverse=True)[:12]
    out["top"] = [(e.key[:60], e.device_time_total / 1e3, e.count)
                  for e in top]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", nargs="+", type=int, default=[1, 2, 4])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    for b in args.batch:
        with tempfile.TemporaryDirectory() as root:
            cfg = train_config(b, args.steps, root)
            try:
                r = profile_training(torch, cfg, args.steps, args.seed)
            except torch.cuda.OutOfMemoryError as e:
                print(f"batch {b}: out of memory: {str(e).splitlines()[0]} "
                      f"[{card}]", flush=True)
                torch.cuda.empty_cache()
                continue
        print(f"batch {b}: steady {r['steady_ms']:.1f} ms/step (median of "
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
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
