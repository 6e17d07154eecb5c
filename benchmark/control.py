"""Readings for a cell's output-check limits: the program's and the
control's, seed after seed, in one process.

    python3 -m benchmark.control --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

The control is the cell's (``cells/<cell>.json``): ``{"cast": "fp8"}``
runs a second copy of the reference with every product's operands
rounded to fp8 (``reference.aocnet.fp8_cast``, the nearest precision
below the eval's bf16) along the program's masks.  For each seed: a run
of the cell with a window of ``--seconds``, then one JSON line with the
program's and the control's readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from .reference.aocnet import fp8_cast
from .run import set_caches

CASTS = {"fp8": fp8_cast}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from .harness.manifest import ROOT, Cell
    set_caches(str(ROOT))
    cell = Cell(args.workload)
    sys.path.insert(0, str(ROOT))
    driver = importlib.import_module(f".drivers.{cell.mix['driver']}",
                                     __package__)
    cast = CASTS[cell.control["cast"]]
    for seed in args.seeds:
        res = driver.run(cell, seed, args.seconds, False, control_cast=cast)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": res["check"],
                          "control": res["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
