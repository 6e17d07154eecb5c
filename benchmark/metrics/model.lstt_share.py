"""model.lstt_share: device time after the program's ``rvos_mark_lstt``
stage mark (AOT's long/short-term transformer blocks, until the decoder's
mark; graph replays included), from ``harness/spans.py``'s ``stage_ns``,
as a share of the traced window."""


def read(ctx):
    stages = ctx.get("stage_ns")
    if ctx.get("kind") != "eval" or not stages or "lstt" not in stages:
        return None
    return 100.0 * stages["lstt"] / (ctx["window_s"] * 1e9)
