"""Grouped (per-expert) matmul of the MoE layer:

    out[e] = x[e] @ w[e]        x (E, C, D), w (E, D, F) -> (E, C, F)

accumulated in fp32 over D, the output in x's dtype.  On a CUDA tensor the
wrapper launches the hand-written kernel (``csrc/gmm.cu``) or raises; on a
CPU tensor it runs the plain PyTorch version beside it.

x and w may each be contiguous or the transpose of a contiguous tensor in
their last two axes (``w.transpose(1, 2)`` of a stored (E, F, D) weight):
the kernel reads either stored layout in place, so the backward's
dx = g w^T and dw = x^T g copy nothing (``dispatch._GMM``).

The kernel has two routes, and :func:`gmm_route` picks one before the launch
from dtype and layout alone: ``"wgmma"`` (tensor cores fed by TMA) for bf16
and fp16 operands that TMA can read, ``"simt"`` (fp32 on the CUDA cores)
otherwise.  This is a dispatch by dtype and layout, not a fallback: a launch
that fails raises, and nothing retries it on the other route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_tensor, ptr, require,
                                          require_no_grad, stored_transposed,
                                          stream, tma_ready)
from repro_torch.kernels.ref import gmm_ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # codes 0, 1, 2


# the plain version: one fp32 einsum, cast to x's dtype
gmm_plain = gmm_ref


def _stored(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it lies in memory: a transposed view's transpose."""
    return t.transpose(1, 2) if stored_transposed(t) else t


def gmm_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 or fp16 x and w of one dtype, D > 0, whose
    stored layouts TMA can read (:func:`~repro_torch.kernels._checks.tma_ready`
    on a transposed view's transpose: for contiguous operands, D and F
    multiples of 8; for x^T, C; for w^T, D) and an output row of a multiple
    of 16 bytes (F), else ``"simt"``.  A plain function of dtypes, shapes,
    strides and addresses."""
    tc = (x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype
          and x.shape[-1] > 0 and w.shape[-1] * w.element_size() % 16 == 0)
    return "wgmma" if tc and tma_ready(_stored(x), _stored(w)) else "simt"


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F), one dtype of fp32/bf16/fp16, each
    contiguous or a transposed view of a contiguous tensor -> (E, C, F) in
    that dtype."""
    if x.device.type == "cpu":
        return gmm_plain(x, w)
    require_no_grad("gmm", x, w, missing="dispatch._GMM")
    check_tensor("x", x, 3, _DTYPES, x.device, transposed_ok=True)
    check_tensor("w", w, 3, (x.dtype,), x.device, transposed_ok=True)
    e, c, d = x.shape
    require(w.shape[:2] == (e, d), lambda: f"w {tuple(w.shape)} vs x {tuple(x.shape)}")
    f = w.shape[2]
    route = gmm_route(x, w)
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    _build.launch("rt_gmm", "gmm", ptr(x), ptr(w), ptr(out),
                  _DTYPES.index(x.dtype), e, c, d, f, int(stored_transposed(x)),
                  int(stored_transposed(w)), _build.ROUTES.index(route),
                  stream(x.device), route=route)
    return out
