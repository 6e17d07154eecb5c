"""device.idle_share.eval: the share of the traced window in which no
operation ran on the device (``torch.profiler`` records, filler left
out)."""


def read(ctx):
    if ctx.get("kind") != "eval" or "busy_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
