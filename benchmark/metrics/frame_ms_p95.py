"""frame_ms_p95: the 95th percentile of every frame the window masked.
A frame's time is its step's (from the end of the step before to the end
of its own, by CUDA events recorded as each step is issued, so host
stalls count) over the step's frame count; the steps are the program's
own (``drivers.eval_videos.video_steps``)."""

import statistics


def read(ctx):
    ms = ctx.get("frame_ms")
    if ctx.get("kind") != "eval" or not ms or len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
