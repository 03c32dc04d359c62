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

The backward (``csrc/ssd_scan_bwd.cu``, :func:`ssd_chunk_bwd`) has the
same two routes, picked by :func:`ssd_bwd_route`: ``"wgmma"`` (warpgroup
products on three-way bf16 splits, as the forward's) where the forward
takes ``"wgmma"``, ``"simt"`` otherwise.  Its plain version is the closed form
:func:`ssd_chunk_bwd_plain`.
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


def ssd_chunk_bwd_plain(x, dt, A, B, C, gy=None, gst=None, gcd=None, gsd=None):
    """The closed form of the backward: the cotangents gy (G, Q, P), gst (G,
    P, N), gcd (G,), gsd (G, Q) of :func:`ssd_chunk`'s four outputs, each
    None when missing -> (gx, gdt, gA, gB, gC) shaped as the inputs, in fp32
    (fp64 for fp64 inputs).  Per chunk, with c = cumsum(dt A), L[l, s] =
    exp(c_l - c_s) for l >= s, CB = C B^T, u = dt x, w = exp(c_last - c) dt:

        G2 = (gy u^T) o L;  gu = (CB o L)^T gy
        gC = G2 B;  gB = G2^T C + diag(w) x gst;  gx = dt gu + diag(w) B gst^T
        gw = rowsum(x o B gst^T)
        gc = rowsum(G2 o CB) - colsum(G2 o CB) - gw w + gsd exp(c),
             plus sum(gw w) + gcd exp(c_last) at the last step
        ga = reverse cumsum(gc);  gdt = rowsum(x o gu) + gw exp(c_last - c) + A ga
        gA = sum(ga dt)"""
    f = torch.promote_types(x.dtype, torch.float32)
    x, dt, A, B, C = (t.to(f) for t in (x, dt, A, B, C))
    q = x.shape[1]
    c = torch.cumsum(dt * A[:, None], dim=1)                    # (G, Q)
    last = c[:, -1:]
    w = torch.exp(last - c) * dt
    gx, gB, gC = torch.zeros_like(x), torch.zeros_like(B), torch.zeros_like(C)
    gc, gdt = torch.zeros_like(dt), torch.zeros_like(dt)
    if gy is not None:
        gy = gy.to(f)
        pos = torch.arange(q, device=x.device)
        mask = pos[:, None] >= pos[None, :]
        # exp only where l >= s: above the diagonal c_l - c_s > 0 may overflow
        L = torch.where(mask, torch.exp(torch.where(mask, c[:, :, None] - c[:, None, :], 0.0)),
                        0.0)
        CB = C @ B.transpose(1, 2)
        G2 = (gy @ (dt[..., None] * x).transpose(1, 2)) * L
        gu = (CB * L).transpose(1, 2) @ gy
        gC = G2 @ B
        gB = G2.transpose(1, 2) @ C
        E = G2 * CB
        gc = E.sum(2) - E.sum(1)
        gx = dt[..., None] * gu
        gdt = (x * gu).sum(2)
    if gst is not None:
        gst = gst.to(f)
        bg = B @ gst.transpose(1, 2)                            # (G, Q, P)
        gx = gx + w[..., None] * bg
        gB = gB + w[..., None] * (x @ gst)
        gw = (x * bg).sum(2)
        gc = gc - gw * w
        gc[:, -1] += (gw * w).sum(1)
        gdt = gdt + gw * torch.exp(last - c)
    if gcd is not None:
        gc[:, -1] += gcd.to(f) * torch.exp(last[:, 0])
    if gsd is not None:
        gc = gc + gsd.to(f) * torch.exp(c)
    ga = torch.flip(torch.cumsum(torch.flip(gc, (1,)), dim=1), (1,))
    gdt = gdt + A[:, None] * ga
    return gx, gdt, (ga * dt).sum(1), gB, gC


def _wgmma_shapes(x, dt, A, B, C) -> bool:
    """The tensor-core routes' dtypes and widths (both directions)."""
    q, p, n = x.shape[-2], x.shape[-1], B.shape[-1]
    return (x.dtype in _DTYPES and 0 < q <= WGMMA_MAX_Q
            and all(t.dtype == x.dtype for t in (dt, A, B, C))
            and 0 < p <= WGMMA_MAX_P and p % 16 == 0 and 0 < n <= WGMMA_MAX_N and n % 16 == 0)


def ssd_route(x, dt, A, B, C) -> str:
    """``"wgmma"`` for x, dt, A, B, C of one dtype of fp32/bf16/fp16, P and
    N multiples of 16 with P <= 64 and N <= 128, chunks of at most 512
    steps, and x, B, C that TMA could
    read (:func:`~repro_torch.kernels._checks.tma_ready`: 16-byte-aligned
    bases and rows; the kernel reads them by 16-byte loads), else
    ``"simt"``.  A plain function of dtypes, shapes, strides and
    addresses."""
    return "wgmma" if _wgmma_shapes(x, dt, A, B, C) and tma_ready(x, B, C) else "simt"


def ssd_bwd_route(x, dt, A, B, C) -> str:
    """The backward's route: the forward's (:func:`ssd_route`: the same
    dtypes, widths and alignment)."""
    return ssd_route(x, dt, A, B, C)


def _checked(x, dt, A, B, C):
    """The kernels' argument checks on x, dt, A, B, C -> (G, Q, P, N)."""
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
    return g, q, p, n


def ssd_chunk(x, dt, A, B, C):
    """x: (G, Q, P); dt: (G, Q); A: (G,); B, C: (G, Q, N), one dtype of
    fp32/bf16/fp16 -> (y_diag (G, Q, P), states (G, P, N), chunk_decay (G,),
    state_decay (G, Q)), all fp32."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B, C)
    require_no_grad("ssd_chunk", x, dt, A, B, C, missing="dispatch._SSDChunk")
    g, q, p, n = _checked(x, dt, A, B, C)
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


def ssd_chunk_bwd(x, dt, A, B, C, gy=None, gst=None, gcd=None, gsd=None):
    """The backward of :func:`ssd_chunk`: x, dt, A, B, C as there and the
    fp32 cotangents of its outputs, gy (G, Q, P), gst (G, P, N), gcd (G,),
    gsd (G, Q), each None when missing (no zeros are made for it) -> (gx,
    gdt, gA, gB, gC) fp32, shaped as the inputs.  On a CUDA tensor one
    launch of the backward kernel, counted under ``ssd_chunk_bwd`` (and its
    route)."""
    if x.device.type == "cpu":
        return ssd_chunk_bwd_plain(x, dt, A, B, C, gy, gst, gcd, gsd)
    require_no_grad("ssd_chunk_bwd", x, dt, A, B, C, gy, gst, gcd, gsd)
    g, q, p, n = _checked(x, dt, A, B, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    cots = []
    for name, t, shape in (("gy", gy, (g, q, p)), ("gst", gst, (g, p, n)), ("gcd", gcd, (g,)),
                           ("gsd", gsd, (g, q))):
        if t is not None:
            t = t.float().contiguous()
            if t.data_ptr() % 16:   # the 16-byte loads of the "wgmma" route
                t = t.clone()
            check_tensor(name, t, len(shape), (torch.float32,), x.device)
            require(t.shape == shape, lambda: f"{name} {tuple(t.shape)}, want {shape}")
        cots.append(t)
    gy, gst, gcd, gsd = cots
    route = ssd_bwd_route(x, dt, A, B, C)
    # the kernel takes fp32 (its math is fp32 either way): 16-bit inputs,
    # which no model path gives it, are widened here
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    # what the kernel leaves unwritten (no cotangent reaches it) is zero
    gs = gy is not None or gst is not None
    gx = (torch.empty if gs else torch.zeros)((g, q, p), **f32)
    gB = (torch.empty if gs else torch.zeros)((g, q, n), **f32)
    gC = (torch.empty if gy is not None else torch.zeros)((g, q, n), **f32)
    gdt = torch.empty((g, q), **f32)
    gA = torch.empty((g,), **f32)
    scratch = torch.empty((4, g, q), **f32)
    _build.launch("rt_ssd_chunk_bwd", "ssd_chunk_bwd", ptr(x), ptr(dt), ptr(A), ptr(B), ptr(C),
                  ptr(gy), ptr(gst), ptr(gcd), ptr(gsd), ptr(gx), ptr(gdt), ptr(gA), ptr(gB),
                  ptr(gC), ptr(scratch), g, q, p, n, _build.ROUTES.index(route),
                  stream(x.device), route=route)
    return gx, gdt, gA, gB, gC
