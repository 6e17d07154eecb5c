"""frames_per_s: masks produced in the window over its seconds (every
video's first frame, ragged and join frames, bank compaction and loader
waits inside it)."""


def read(ctx):
    if ctx.get("kind") != "eval" or not ctx["frames"]:
        return None
    return ctx["frames"] / ctx["window_s"]
