"""mfu.eval: the model's FLOPs over the traced window's videos
(``counts.flops``: the dense layers counted on the plain reference, the
matching streams by formula, each video over its objects and the
background and not over the padded channels; each video's first frame
its extraction alone) over the window's seconds by the host clock and
the H100's 989 TFLOP/s (bf16 dense, the eval's compute type)."""

PEAK = 989e12


def read(ctx):
    if ctx.get("kind") != "eval" or "flops" not in ctx:
        return None
    f = ctx["flops"]
    total = sum(f["frame"][n] * frames + f["frame0"]
                for frames, n in ctx["video_channels"])
    return 100.0 * total / (ctx["window_s"] * PEAK)
