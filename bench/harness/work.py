"""The benchmark's own frozen arithmetic: model FLOPs and the episodic
kernels' bound time, from the tasks' shapes and the configuration alone,
never from which kernels ran.

Peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W), as ``repro_torch.roofline.constants`` has them.

Model FLOPs count a multiply-add as two operations, over the backbone's
convolutions (3x3 SAME, a 2x2 pool after each block while H, W >= 2) and
its linear head.  A layer's data gradient and its weight gradient each cost
what its forward costs.  The backward counts only the products the trained
parameters need, over the H support images and the M queries; no layer
below the first trained input needs a data gradient, so the first
convolution's is never counted; recompute is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

TF32_FLOPS = 495e12          # dense TF32 tensor-core FLOP/s: the yardstick of every mfu
FP32_FLOPS = 67e12           # fp32 FLOP/s outside the tensor cores (the B1-B3 kernels)
HBM_BYTES_PER_S = 3.35e12    # HBM3 bytes/s


def conv_layers(c_in: int, widths, size: int) -> List[Tuple[int, int, int, int]]:
    """(c_in, c_out, h, w) of each 3x3 convolution, at the resolution it
    runs at."""
    out, h = [], size
    for w in widths:
        out.append((c_in, w, h, h))
        c_in = w
        if h >= 2:
            h //= 2
    return out


def conv_flops(layer) -> float:
    c_in, c_out, h, w = layer
    return 2.0 * 9 * c_in * c_out * h * w


def backbone_flops(cfg: Dict) -> Dict:
    """Per image: the forward FLOPs of each conv layer and of the head."""
    bb = cfg["backbone"]
    return dict(convs=[conv_flops(l) for l in conv_layers(bb["in_channels"], bb["widths"],
                                                          cfg["image_size"])],
                head=2.0 * bb["widths"][-1] * bb["feature_dim"])


def forward_flops(stack: Dict) -> float:
    return sum(stack["convs"]) + stack["head"]


def backward_flops(stack: Dict) -> float:
    """Data gradients of every layer but the first convolution, and the
    weight gradient of every layer."""
    return sum(stack["convs"][1:]) + stack["head"] + forward_flops(stack)


def train_task_flops(cfg: Dict, n: int, m: int, h: int) -> float:
    """Model FLOPs of one task of a LITE training step of ProtoNets: N
    support and M query images forward, the backward over H + M."""
    s = backbone_flops(cfg)
    return (n + m) * forward_flops(s) + (h + m) * backward_flops(s)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: bytes over HBM's rate or fp32
    operations over the CUDA cores' peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def episodic_kernels_bound_s(cfg: Dict, n: int) -> float:
    """Bound seconds of the episodic kernels' work a task needs: B1's class
    sums over its n support rows (read the features and the one-hot weights
    once, write the sums once), fp32."""
    f, c = cfg["backbone"]["feature_dim"], cfg["learner"]["way"]
    return bound_s(4.0 * (n * f + n * c + c * f), 2.0 * n * c * f)
