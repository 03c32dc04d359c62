"""The benchmark's frozen FLOP and byte arithmetic against hand counts."""
import math

from harness import work
from harness.common import load_cell

# a backbone of widths (2, 4) over 3 channels at 8 px, 5 features, 2 classes
CFG = dict(image_size=8, backbone=dict(in_channels=3, widths=[2, 4], feature_dim=5),
           learner=dict(kind="protonets", way=2))
BB_CONV = [2 * 9 * 3 * 2 * 64, 2 * 9 * 2 * 4 * 16]      # 8x8, then 4x4 after a pool
BB_HEAD = 2 * 4 * 5
F, C = 5, 2


def test_conv_layers_pool_while_the_map_is_2x2():
    assert work.conv_layers(3, [2, 4, 8], 2) == [(3, 2, 2, 2), (2, 4, 1, 1), (4, 8, 1, 1)]
    assert work.conv_layers(3, [2, 2], 8) == [(3, 2, 8, 8), (2, 2, 4, 4)]


def test_protonets_train_task():
    n, m, h = 7, 3, 2
    fwd = (n + m) * (sum(BB_CONV) + BB_HEAD)
    bwd = (h + m) * ((BB_CONV[1] + BB_HEAD) + (sum(BB_CONV) + BB_HEAD))
    assert math.isclose(work.train_task_flops(CFG, n, m, h), fwd + bwd)


def test_the_conv4_step_at_224_px():
    """Conv-4 at 224 px: 173 + 925 + 231 + 58 MFLOP a forward (the
    convolutions at 224, 112, 56 and 28 px) and the 64 x 64 head."""
    cell = load_cell("protonets224.train_large")
    cfg = dict(cell.config, learner=dict(cell.config["learner"], way=cell.traffic["way"]))
    per = [2 * 9 * 3 * 64 * 224 ** 2, 2 * 9 * 64 * 64 * 112 ** 2, 2 * 9 * 64 * 64 * 56 ** 2,
           2 * 9 * 64 * 64 * 28 ** 2]
    assert math.isclose(work.forward_flops(work.backbone_flops(cfg)), sum(per) + 2 * 64 * 64)
    tr = cell.traffic
    n, m = tr["way"] * tr["shot"], tr["way"] * tr["query_per_class"]
    step = tr["tasks_per_step"] * work.train_task_flops(cfg, n, m, tr["lite_h"])
    assert 2.38e12 < step < 2.40e12


def test_kernel_bounds():
    n = 6
    b1 = 4.0 * (n * F + n * C + C * F) / work.HBM_BYTES_PER_S
    assert math.isclose(work.episodic_kernels_bound_s(CFG, n), b1)
