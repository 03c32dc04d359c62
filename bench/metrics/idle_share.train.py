"""Share of the traced slice of a training window in which no operation ran
on the device (100 % - busy / window, from the profiler's kernel
intervals)."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
