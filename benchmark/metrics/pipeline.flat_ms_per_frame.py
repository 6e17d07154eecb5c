"""pipeline.flat_ms_per_frame: the evaluator's ``timing["flat"]`` (bank
compaction between chunks, eager), summed over the window, per masked
frame."""


def read(ctx):
    if ctx.get("kind") != "eval" or not ctx["frames"]:
        return None
    return 1e3 * ctx["timing"]["flat"] / ctx["frames"]
