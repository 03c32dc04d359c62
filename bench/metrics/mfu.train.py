"""Model FLOPs of the window's steps (``harness.work.train_task_flops`` from
the tasks' shapes) over the window's seconds, as a share of the H100's
dense TF32 peak (495 TFLOP/s), whatever precision the program sets."""
from harness.work import TF32_FLOPS


def read(ctx):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / TF32_FLOPS
