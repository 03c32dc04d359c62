"""Per-class aggregation kernels of the episodic path: segment sums and the
Simple CNAPs raw second moment, each over a leading task-lane axis.

    segment_pool_weighted: out[t, c, f]    = sum_b w[t, b, c] x[t, b, f]
    class_second_moment:   out[t, c, i, j] = sum_b w[t, b, c] x[t, b, i] x[t, b, j]

``w`` is a mask-folded one-hot (zero rows for padding).  On a CUDA tensor
each wrapper launches its hand-written kernel (``csrc/segment_pool.cu``) or
raises; on a CPU tensor it runs the plain PyTorch version beside it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_tensor, ptr, require,
                                          require_no_grad, stream)

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # codes 0, 1, 2


def segment_pool_weighted_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, B, F) float; w: (T, B, C) -> (T, C, F) float32."""
    return torch.einsum("tbc,tbf->tcf", w.float(), x.float())


def class_second_moment_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, B, F) float; w: (T, B, C) -> (T, C, F, F) float32, the class
    weight folded into the left operand (no (B, F, F) tensor)."""
    xf = x.float()
    left = w.float()[..., :, None] * xf[..., None, :]          # (T, B, C, F)
    return torch.einsum("tbci,tbj->tcij", left, xf)


def _check_args(x: torch.Tensor, w: torch.Tensor, dev: torch.device):
    """The kernels' argument checks; returns (T, B, F, C)."""
    check_tensor("x", x, 3, _X_DTYPES, dev)
    check_tensor("w", w, 3, (torch.float32,), dev)
    t, b, f = x.shape
    tw, bw, c = w.shape
    require(tw == t and bw == b,
            lambda: f"w {tuple(w.shape)} does not match x {tuple(x.shape)} on (T, B)")
    return t, b, f, c


def segment_pool_weighted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, B, F) fp32/bf16/fp16; w: (T, B, C) fp32 -> (T, C, F) fp32."""
    if x.is_cpu:
        return segment_pool_weighted_plain(x, w)
    require_no_grad("segment_pool_weighted", x, w)
    dev = x.device
    t, b, f, c = _check_args(x, w, dev)
    out = torch.empty(t, c, f, dtype=torch.float32, device=dev)  # sizes as varargs: parsed faster
    _build.launch("rt_segment_sum", "segment_sum", ptr(x),
                  _X_DTYPES.index(x.dtype), ptr(w), ptr(out), t, b, f, c,
                  stream(dev))
    return out


def class_second_moment(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (T, B, F) fp32/bf16/fp16; w: (T, B, C) fp32 -> (T, C, F, F) fp32."""
    if x.is_cpu:
        return class_second_moment_plain(x, w)
    require_no_grad("class_second_moment", x, w)
    dev = x.device
    t, b, f, c = _check_args(x, w, dev)
    out = torch.empty(t, c, f, f, dtype=torch.float32, device=dev)
    _build.launch("rt_class_second_moment", "class_second_moment", ptr(x),
                  _X_DTYPES.index(x.dtype), ptr(w), ptr(out), t, b, f, c,
                  stream(dev))
    return out
