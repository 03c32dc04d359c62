"""The bound time of the class sums, second moments and head that the
traced slice's tasks need (``harness.work.episodic_kernels_bound_s``, from
their shapes) over the device time of the B1-B3 kernels in the slice."""
from harness.trace import EPISODIC_KERNELS


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "train" or t is None:
        return None
    dev = sum(t["by_category"].get(k, 0.0) for k in EPISODIC_KERNELS)
    if dev <= 0 or not ctx.get("kernels_bound_s"):
        return None
    return 100.0 * ctx["kernels_bound_s"] / dev
