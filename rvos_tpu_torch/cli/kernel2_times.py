"""Device time of kernel 2 (``ops.local_match``) at the main path's shapes.

    python -m rvos_tpu_torch.cli.kernel2_times [--calls 20]

For each mode (float32 and bf16 operands), runs the wrapper ``--calls``
times under ``torch.profiler`` and prints the device µs per call of each
of its two kernels (operand preparation, matching) beside the wrapper's
time over CUDA events.  The shapes are ``chip_smoke.py`` phase 2's: a
61×107 grid, C = 100, O = 11, S = 2, radii 2…12, ReLU'd normal inputs
from a seed.  The card's name and power limit head the output.  Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=20)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import local_match

    if not torch.cuda.is_available():
        print("kernel2_times: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    h, w, c, o, radii = 61, 107, 100, 11, (2, 4, 6, 8, 10, 12)
    g = torch.Generator(device="cuda").manual_seed(2)
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, 4, (h, w), generator=g, device="cuda"), o).float()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.relu(torch.randn((h, w, c), generator=g, device="cuda"))
        ys = torch.relu(torch.randn((2, h, w, c), generator=g, device="cuda"))
        x, ys = x.to(dtype), ys.to(dtype)

        def call():
            local_match(x, ys, onehot, radii)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.calls):
            call()
        end.record()
        torch.cuda.synchronize()
        wrapper_ms = start.elapsed_time(end) / args.calls
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                call()
            torch.cuda.synchronize()
        kernels = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t > 0:
                name = e.key.replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("(")[0]
                kernels.append(f"{name} {t / e.count:.2f} µs x{e.count}")
        print(f"{'bf16' if dtype == torch.bfloat16 else 'float32'}: "
              f"wrapper {wrapper_ms:.4f} ms | " + " | ".join(kernels)
              + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
