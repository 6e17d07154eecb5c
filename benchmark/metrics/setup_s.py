"""setup_s: seconds from the process's start to the window's start
(imports, weights, inputs, kernel builds, warm-up)."""


def read(ctx):
    return ctx.get("setup_s")
