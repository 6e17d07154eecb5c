"""kernel.seg_map_roofline: global matching's kernel over the occupancy
bank (B.1, ``csrc/global_seg_map.cu``) against its least time at the
cell's shapes (``counts.kernels.seg_map``: 2·M·P·C at the bf16 peak in
mixed matching, the float32 peak otherwise), summed over its launches
in the trace.  Operand preparation (``prep::*``) is not counted."""

import re

from benchmark.counts.kernels import seg_map

PATTERN = re.compile(r"\bseg_map_(?:mma_)?kernel\b")


def read(ctx):
    dev = ctx.get("dev")
    if ctx.get("kind") != "eval" or not dev:
        return None
    spent = [e - s for name, s, e in dev if PATTERN.search(name)]
    if not spent:
        return None
    sh = ctx["shapes"]
    least, _ = seg_map(sh["m"], sh["p"], sh["c"], sh["o"], ctx["mixed"])
    return 100.0 * least * len(spent) / (sum(spent) / 1e9)
