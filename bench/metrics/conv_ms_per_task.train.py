"""Device milliseconds of the "convolutions (cuDNN)" category (the
backbone's convolutions, their gradients and cuDNN's layout transforms) in
the traced slice, per task trained in it."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or t is None or not ctx.get("trace_tasks"):
        return None
    conv = t["by_category"].get("convolutions (cuDNN)")
    return None if conv is None else 1e3 * conv / ctx["trace_tasks"]
