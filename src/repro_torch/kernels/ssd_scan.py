"""Mamba-2 SSD intra-chunk computation, per chunk g (batch * heads *
chunks flattened):

    y_diag = (C B^T o L) diag(dt) x,  L = exp(segsum(dt * A)) (lower)
    states = (B^T diag(exp(dA_cum[-1] - dA_cum) * dt) x)^T
    chunk_decay = exp(dA_cum[-1]),  state_decay = exp(dA_cum)

all in fp32.  The inter-chunk recurrence over the tiny (P, N) states stays
in plain code.  On a CUDA tensor the wrapper launches the hand-written
kernel (``csrc/ssd_scan.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.

The kernel has two routes, and :func:`ssd_route` picks one before the
launch from dtypes, shapes and layout alone: ``"wgmma"`` (the products on
the tensor cores, fp32 and fp16 operands split into three bf16 terms) for
fp32, bf16 and fp16 inputs of one dtype with P and N multiples of 16 (P up
to 64, N up to 128) and chunks of up to 512 steps that 16-byte loads can
read, ``"simt"`` (fp32 on the
CUDA cores) otherwise.  This is a dispatch by dtype and layout, not a
fallback: a launch that fails raises, and nothing retries it on the other
route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_tensor, ptr, require,
                                          require_no_grad, stream, tma_ready)
from repro_torch.kernels.ref import ssd_chunk_ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # codes 0, 1, 2
WGMMA_MAX_P, WGMMA_MAX_N = 64, 128   # the tensor-core kernel's tile widths
WGMMA_MAX_Q = 512                     # its shared memory holds dt and dA of a chunk


def ssd_chunk_plain(x, dt, A, B, C):
    """x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N) -> (y_diag
    (G, Q, P), states (G, P, N), chunk_decay (G,), state_decay (G, Q)), all
    fp32: the one-chunk oracle with the G chunks as its heads."""
    y, st, cd, sd = ssd_chunk_ref(x.transpose(0, 1), dt.transpose(0, 1), A,
                                  B.transpose(0, 1), C.transpose(0, 1))
    return y.transpose(0, 1), st, cd, sd.transpose(0, 1)


def ssd_route(x, dt, A, B, C) -> str:
    """``"wgmma"`` for x, dt, A, B, C of one dtype of fp32/bf16/fp16, P and
    N multiples of 16 with P <= 64 and N <= 128, chunks of at most 512
    steps, and x, B, C that TMA could
    read (:func:`~repro_torch.kernels._checks.tma_ready`: 16-byte-aligned
    bases and rows; the kernel reads them by 16-byte loads), else
    ``"simt"``.  A plain function of dtypes, shapes, strides and
    addresses."""
    q, p, n = x.shape[-2], x.shape[-1], B.shape[-1]
    tc = (x.dtype in _DTYPES and 0 < q <= WGMMA_MAX_Q and all(t.dtype == x.dtype for t in (dt, A, B, C))
          and 0 < p <= WGMMA_MAX_P and p % 16 == 0 and 0 < n <= WGMMA_MAX_N
          and n % 16 == 0)
    return "wgmma" if tc and tma_ready(x, B, C) else "simt"


def ssd_chunk(x, dt, A, B, C):
    """x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), one dtype of
    fp32/bf16/fp16 -> (y_diag (G, Q, P), states (G, P, N), chunk_decay (G,),
    state_decay (G, Q)), all fp32."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B, C)
    require_no_grad("ssd_chunk", x, dt, A, B, C, missing="dispatch._SSDChunk")
    check_tensor("x", x, 3, _DTYPES, x.device)
    for name, t, nd in (("dt", dt, 2), ("A", A, 1), ("B", B, 3), ("C", C, 3)):
        check_tensor(name, t, nd, (x.dtype,), x.device)
    g, q, p = x.shape
    n = B.shape[2]
    require(dt.shape == (g, q) and A.shape == (g,) and B.shape == (g, q, n)
            and C.shape == (g, q, n),
            lambda: f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    require(q > 0, "empty chunk")
    route = ssd_route(x, dt, A, B, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((g, q, p), **f32)
    st = torch.empty((g, p, n), **f32)
    cd = torch.empty((g,), **f32)
    sd = torch.empty((g, q), **f32)
    _build.launch("rt_ssd_chunk", "ssd_chunk", ptr(x), ptr(dt), ptr(A), ptr(B),
                  ptr(C), ptr(y), ptr(st), ptr(cd), ptr(sd),
                  _DTYPES.index(x.dtype), g, q, p, n, _build.ROUTES.index(route),
                  stream(x.device), route=route)
    return y, st, cd, sd
