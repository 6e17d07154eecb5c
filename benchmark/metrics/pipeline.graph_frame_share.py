"""pipeline.graph_frame_share: frames run as CUDA graph replays (the
evaluator's ``replays`` counter times the chunk's frames) as a share of
the masked frames; the rest ran eagerly (ragged cuts, joins)."""


def read(ctx):
    if ctx.get("kind") != "eval" or not ctx["frames"]:
        return None
    return 100.0 * ctx["replays"] * ctx["chunk_n"] / ctx["frames"]
