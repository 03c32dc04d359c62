"""The kernel entry point for LM-side kernels and direct use, with the names
and 2-D signatures of the JAX package's ``kernels/ops.py``:

* :func:`flash_attention`, :func:`flash_attention_gqa` (``csrc/flash_attention.cu``);
* :func:`gmm`, the per-expert matmul (``csrc/gmm.cu``);
* :func:`ssd_chunk`, the Mamba-2 intra-chunk SSD (``csrc/ssd_scan.cu``);
* :func:`mahalanobis`, :func:`segment_pool`, :func:`segment_pool_weighted`
  and :func:`class_second_moment`, the episodic class-statistics kernels
  with one task lane (the serving path reaches them, batched over lanes,
  through :mod:`repro_torch.kernels.dispatch`).

On a CUDA tensor every function launches its kernel or raises; on a CPU
tensor it runs the kernel's plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import mahalanobis as _md
from repro_torch.kernels import segment_pool as _sp
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_gqa
from repro_torch.kernels.gmm import gmm
from repro_torch.kernels.ref import one_hot
from repro_torch.kernels.ssd_scan import ssd_chunk

__all__ = ["flash_attention", "flash_attention_gqa", "mahalanobis", "segment_pool",
           "segment_pool_weighted", "class_second_moment", "gmm", "ssd_chunk"]


def mahalanobis(q, mu, sinv) -> torch.Tensor:
    """q: (B, F); mu: (C, F); sinv: (C, F, F), fp32 -> (B, C)."""
    return _md.mahalanobis(q[None], mu[None], sinv[None])[0]


def segment_pool(x, labels, num_classes: int):
    """x: (B, F); labels: (B,) -> (sums (C, F), counts (C,)).  A label
    outside [0, C) (such as a -1 padding label) weighs its row 0."""
    onehot = one_hot(labels, num_classes)
    return segment_pool_weighted(x, onehot), onehot.sum(dim=0)


def segment_pool_weighted(x, weights) -> torch.Tensor:
    """x: (B, F); weights: (B, C) fp32 mask-folded one-hot -> sums (C, F)
    fp32.  Padded rows are zero-weight rows."""
    return _sp.segment_pool_weighted(x[None], weights[None])[0]


def class_second_moment(x, weights) -> torch.Tensor:
    """x: (B, F); weights: (B, C) fp32 -> (C, F, F) fp32 per-class raw second
    moments sum_b w[b, c] x_b x_b^T, without a (B, F, F) tensor."""
    return _sp.class_second_moment(x[None], weights[None])[0]
