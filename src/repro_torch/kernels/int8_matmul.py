"""Blockwise-int8 weight x float activation matmul (serving, forward only):

    out[m, n] = sum_k x[m, k] * q[k, n] * scale[k, n // BLOCK]

``q``/``scale`` are the ``{q, scale, n}`` form of
:mod:`repro_torch.optim.quant`.  On a CUDA tensor the wrapper launches the
hand-written kernel (``csrc/int8_matmul.cu``) or raises; on a CPU tensor it
runs the plain PyTorch version beside it (dequantize, then one GEMM).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_tensor, ptr, require, stream
from repro_torch.optim.quant import BLOCK, dequantize


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float; q: (K, N) int8; scale: (K, ceil(N/BLOCK)) -> (M, N) f32."""
    w = dequantize(dict(q=q, scale=scale, n=q.shape[-1]))
    return x.float() @ w


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) fp32; q: (K, N) int8; scale: (K, ceil(N/BLOCK)) fp32 ->
    (M, N) fp32."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    check_tensor("x", x, 2, (torch.float32,), x.device)
    check_tensor("q", q, 2, (torch.int8,), x.device)
    check_tensor("scale", scale, 2, (torch.float32,), x.device)
    m, k = x.shape
    kq, n = q.shape
    nb = -(-n // BLOCK)
    require(kq == k, lambda: f"contraction mismatch: x K={k} vs q K={kq}")
    require(scale.shape == (k, nb), lambda: f"scale {tuple(scale.shape)}, expected {(k, nb)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.launch("rt_int8_matmul", "int8_matmul", ptr(x), ptr(q), ptr(scale),
                  ptr(out), m, k, n, nb, stream(x.device))
    return out
