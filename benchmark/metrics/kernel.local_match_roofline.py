"""kernel.local_match_roofline: local matching's kernel (B.4,
``csrc/local_match.cu``, both previous embeddings in one launch) against
its least time at the cell's shapes (``counts.kernels.local_match``, bound
by bytes at these shapes), summed over its launches in the trace."""

import re

from benchmark.counts.kernels import local_match

PATTERN = re.compile(r"\blocal_(?:mma|f32)_kernel\b")


def read(ctx):
    dev = ctx.get("dev")
    if ctx.get("kind") != "eval" or not dev:
        return None
    spent = [e - s for name, s, e in dev if PATTERN.search(name)]
    if not spent:
        return None
    sh = ctx["shapes"]
    least, _ = local_match(sh["lh"], sh["lw"], sh["c"], sh["o"], sh["radii"],
                           mixed=ctx["mixed"])
    return 100.0 * least * len(spent) / (sum(spent) / 1e9)
