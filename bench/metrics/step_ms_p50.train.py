"""The median of the loop's ``TrainResult.step_times`` over the window (a
span's wall time spread over its steps), in milliseconds."""
import statistics


def read(ctx):
    if ctx["kind"] != "train" or not ctx["step_times"]:
        return None
    return 1e3 * statistics.median(ctx["step_times"])
