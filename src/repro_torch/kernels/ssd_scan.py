"""Mamba-2 SSD intra-chunk computation, per chunk g (batch * heads *
chunks flattened):

    y_diag = (C B^T o L) diag(dt) x,  L = exp(segsum(dt * A)) (lower)
    states = (B^T diag(exp(dA_cum[-1] - dA_cum) * dt) x)^T
    chunk_decay = exp(dA_cum[-1]),  state_decay = exp(dA_cum)

all in fp32.  The inter-chunk recurrence over the tiny (P, N) states stays
in plain code.  On a CUDA tensor the wrapper launches the hand-written
kernel (``csrc/ssd_scan.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_tensor, ptr, require, stream
from repro_torch.kernels.ref import ssd_chunk_ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # codes 0, 1, 2


def ssd_chunk_plain(x, dt, A, B, C):
    """x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N) -> (y_diag
    (G, Q, P), states (G, P, N), chunk_decay (G,), state_decay (G, Q)), all
    fp32: the one-chunk oracle with the G chunks as its heads."""
    y, st, cd, sd = ssd_chunk_ref(x.transpose(0, 1), dt.transpose(0, 1), A,
                                  B.transpose(0, 1), C.transpose(0, 1))
    return y.transpose(0, 1), st, cd, sd.transpose(0, 1)


def ssd_chunk(x, dt, A, B, C):
    """x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), one dtype of
    fp32/bf16/fp16 -> (y_diag (G, Q, P), states (G, P, N), chunk_decay (G,),
    state_decay (G, Q)), all fp32."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B, C)
    check_tensor("x", x, 3, _DTYPES, x.device)
    for name, t, nd in (("dt", dt, 2), ("A", A, 1), ("B", B, 3), ("C", C, 3)):
        check_tensor(name, t, nd, (x.dtype,), x.device)
    g, q, p = x.shape
    n = B.shape[2]
    require(dt.shape == (g, q) and A.shape == (g,) and B.shape == (g, q, n)
            and C.shape == (g, q, n),
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    require(q > 0, "empty chunk")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((g, q, p), **f32)
    st = torch.empty((g, p, n), **f32)
    cd = torch.empty((g,), **f32)
    sd = torch.empty((g, q), **f32)
    _build.launch("rt_ssd_chunk", "ssd_chunk", ptr(x), ptr(dt), ptr(A), ptr(B),
                  ptr(C), ptr(y), ptr(st), ptr(cd), ptr(sd),
                  _DTYPES.index(x.dtype), g, q, p, n, stream(x.device))
    return y, st, cd, sd
