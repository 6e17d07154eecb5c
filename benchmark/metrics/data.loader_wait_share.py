"""data.loader_wait_share: the evaluator's ``timing["loader_wait"]``
(waiting on the prefetch threads' decode and eval resize), summed over the
window's videos, as a share of the window."""


def read(ctx):
    if ctx.get("kind") != "eval":
        return None
    return 100.0 * ctx["timing"]["loader_wait"] / ctx["window_s"]
