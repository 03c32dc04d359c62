"""Kernel dispatch for the episodic hot path: one policy, four backends.

Every support-set aggregation the meta-learners run (per-class feature
sums, the Simple CNAPs raw second moment, the Mahalanobis head), the
quantized head matmul, the LM trunks' self-attention (causal, or
bidirectional in whisper's encoder), the MoE layer's grouped expert
matmuls and the Mamba-2 SSD's intra-chunk terms go through the ops here.
Each op picks an implementation per *backend*:

  ``naive``  the literal composite (per-example expansion, then a reduce);
             for the second moment it forms the per-example (B, F, F)
             outer products.  Kept as the oracle.
  ``ref``    plain PyTorch; the second moment is reassociated through a
             (B, C, F) hop so no (B, F, F) tensor forms; the Mahalanobis
             head is the ``cholesky_solve`` composite.
  ``cuda``   the hand-written kernels (:mod:`repro_torch.kernels`).  On a
             CUDA tensor a wrapper launches its kernel or raises; on a CPU
             tensor it runs its plain version, so the CPU tests exercise the
             kernel path's arithmetic (explicit inverse for the head) and
             the backward formulas below.
  ``auto``   ``cuda`` for a CUDA tensor, ``ref`` for a CPU tensor.

The default is a ContextVar (``use_backend`` scopes it).  Weights are
mask-folded one-hots: zero rows (padding) contribute nothing.  Every op
takes a leading task-lane axis T on its operands: the engine batches its
lanes where the JAX package vmaps.

On ``cuda`` the six differentiable ops (``segment_sum``,
``class_second_moment``, ``mahalanobis_head``, ``flash_attention``,
``gmm``, ``ssd_chunk``) reach their kernels inside a
``torch.autograd.Function``: the forward launches the kernel.  For B1-B3 the backward is the JAX package's
own ``custom_vjp`` backwards (``repro/kernels/dispatch.py``) written over
the task-lane axis T, in plain einsums; for flash attention and ssd_chunk
it is a backward kernel of its own (the VJP of the transcription the JAX
trunk differentiates, ``models/layers.py::attention_scores``, and of the
kernel's plain version), from the saved operands; for gmm both backward
products are grouped matmuls, and run on the gmm kernel itself.  A kernel
wrapper refuses a tensor that requires grad
anywhere else (:func:`repro_torch.kernels._checks.require_no_grad`), so a
path that forgets its Function fails instead of training a frozen model.
``int8_matmul`` is forward only by contract.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm as _gm
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import mahalanobis as _md
from repro_torch.kernels import segment_pool as _sp
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.optim import quant as _quant

BACKENDS = ("naive", "ref", "cuda", "auto")

_default_backend: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_backend", default="auto")


def _check(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"choose from {BACKENDS}")
    return backend


@contextlib.contextmanager
def use_backend(backend: Optional[str]):
    """Scoped default backend (None = leave the current default)."""
    token = None
    if backend is not None:
        token = _default_backend.set(_check(backend))
    try:
        yield
    finally:
        if token is not None:
            _default_backend.reset(token)


def resolve_backend(backend: Optional[str] = None,
                    device: Optional[torch.device] = None) -> str:
    """None -> context default; ``auto`` -> ``cuda`` on a CUDA device, else
    ``ref``."""
    b = _check(_default_backend.get() if backend is None else backend)
    if b == "auto":
        return "cuda" if device is not None and torch.device(device).type == "cuda" \
            else "ref"
    return b


# ===========================================================================
# segment_sum: S[t, c, ...] = sum_b w[t, b, c] e[t, b, ...]
# ===========================================================================


def _segment_sum_expand(e: torch.Tensor, weights: torch.Tensor,
                        accum_dtype) -> torch.Tensor:
    """Expand to (T, B, C, ...) and reduce the example axis (shared by
    ``naive`` and ``ref``: with C = way the hop is small)."""
    w = weights.to(e.dtype).reshape(weights.shape + (1,) * (e.dim() - 2))
    expanded = e.unsqueeze(2) * w
    return torch.sum(expanded, dim=1, dtype=accum_dtype)


class _SegmentSum(torch.autograd.Function):
    """x (T, B, K), w (T, B, C) fp32 -> (T, C, K) fp32 through the kernel.
    Backward (``_segment_sum_pallas_bwd``): dx = w g, dw = x . g."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _sp.segment_pool_weighted(x.contiguous(), w.contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("tbc,tck->tbk", w.float(), g).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("tbk,tck->tbc", x.float(), g)
        return dx, dw


def segment_sum(e: torch.Tensor, weights: torch.Tensor, accum_dtype=None,
                backend: Optional[str] = None) -> torch.Tensor:
    """``out[t, c, ...] = sum_b weights[t, b, c] * e[t, b, ...]``.

    e: (T, B, ...); weights: (T, B, C) mask-folded one-hot -> (T, C, ...).
    ``accum_dtype`` upcasts the reduction (the fp32 accumulator of a
    low-precision chunk)."""
    b = resolve_backend(backend, e.device)
    if b in ("naive", "ref"):
        return _segment_sum_expand(e, weights, accum_dtype)
    t, n = e.shape[:2]
    out = _SegmentSum.apply(e.reshape(t, n, -1), weights.float())
    out = out.to(accum_dtype or e.dtype)
    return out.reshape((t, weights.shape[2]) + e.shape[2:])


# ===========================================================================
# class_second_moment: S[t, c, i, j] = sum_b w[t, b, c] f[t, b, i] f[t, b, j]
# ===========================================================================


def _second_moment_naive(f, weights, accum_dtype):
    outer = torch.einsum("tbi,tbj->tbij", f, f)
    return _segment_sum_expand(outer, weights, accum_dtype)


def _second_moment_ref(f, weights, accum_dtype):
    """Hop through (T, B, C, F), then contract the example axis."""
    dt = accum_dtype or f.dtype
    hop = weights.to(f.dtype)[..., :, None] * f[..., None, :]
    return torch.einsum("tbci,tbj->tcij", hop.to(dt), f.to(dt))


class _SecondMoment(torch.autograd.Function):
    """f (T, B, F), w (T, B, C) fp32 -> (T, C, F, F) fp32 through the kernel.
    Backward (``_second_moment_pallas_bwd``): the output is symmetric in
    (i, j), so df takes g + g^T; dw contracts g with f f^T."""

    @staticmethod
    def forward(ctx, f, w):
        ctx.save_for_backward(f, w)
        return _sp.class_second_moment(f.contiguous(), w.contiguous())

    @staticmethod
    def backward(ctx, g):
        f, w = ctx.saved_tensors
        f32, w, g = f.float(), w.float(), g.float()
        df = dw = None
        if ctx.needs_input_grad[0]:
            gs = g + g.transpose(-1, -2)
            # df[t, b, i] = sum_{c, j} w[t, b, c] gs[t, c, i, j] f[t, b, j]
            gf = torch.einsum("tcij,tbj->tbci", gs, f32)
            df = torch.einsum("tbc,tbci->tbi", w, gf).to(f.dtype)
        if ctx.needs_input_grad[1]:
            # dw[t, b, c] = sum_{i, j} g[t, c, i, j] f[t, b, i] f[t, b, j]
            gf = torch.einsum("tcij,tbj->tbci", g, f32)
            dw = torch.einsum("tbi,tbci->tbc", f32, gf)
        return df, dw


def class_second_moment(f: torch.Tensor, weights: torch.Tensor,
                        accum_dtype=None, backend: Optional[str] = None
                        ) -> torch.Tensor:
    """Per-class raw second moment without the per-example (B, F, F) tensor
    (except on ``naive``).  f: (T, B, F); weights: (T, B, C) -> (T, C, F, F)."""
    b = resolve_backend(backend, f.device)
    if b == "naive":
        return _second_moment_naive(f, weights, accum_dtype)
    if b == "ref":
        return _second_moment_ref(f, weights, accum_dtype)
    out = _SecondMoment.apply(f, weights.float())
    return out.to(accum_dtype or f.dtype)


# ===========================================================================
# mahalanobis head: d2[t, m, c] = (q - mu_c)^T Sigma_c^{-1} (q - mu_c)
# ===========================================================================


def _mahalanobis_cho(qf, mu, chol):
    """Per-class triangular solves against the Cholesky factors."""
    diff = qf[:, :, None, :] - mu[:, None, :, :]             # (T, M, C, F)
    rhs = diff.permute(0, 2, 3, 1)                            # (T, C, F, M)
    sol = torch.cholesky_solve(rhs, chol, upper=False)
    return torch.sum(diff * sol.permute(0, 3, 1, 2), dim=-1)


def chol_inverse(chol: torch.Tensor) -> torch.Tensor:
    """(..., F, F) lower Cholesky factors -> Sigma^{-1}.  Adaptation computes
    it once per task state (``state["sinv"]``) so query dispatches skip the
    O(C F^3) solves."""
    return torch.cholesky_inverse(chol, upper=False)


class _Mahalanobis(torch.autograd.Function):
    """q (T, M, F), mu (T, C, F), sinv (T, C, F, F), fp32 -> (T, M, C)
    through the kernel.  Backward (``_mahalanobis_pallas_bwd``), with
    diff = q - mu and u = (Sinv + Sinv^T) diff: dq = g u, dmu = -g u,
    dsinv = g diff diff^T.  Simple CNAPs carries dsinv on to its Cholesky
    factor through ``chol_inverse``'s own autograd."""

    @staticmethod
    def forward(ctx, q, mu, sinv):
        ctx.save_for_backward(q, mu, sinv)
        return _md.mahalanobis(q.contiguous(), mu.contiguous(), sinv.contiguous())

    @staticmethod
    def backward(ctx, g):
        q, mu, sinv = ctx.saved_tensors
        g = g.float()
        diff = q[:, :, None, :] - mu[:, None, :, :]            # (T, M, C, F)
        dq = dmu = dsinv = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            u = torch.einsum("tcij,tmcj->tmci", sinv + sinv.transpose(-1, -2), diff)
            gu = g[..., None] * u
            dq = gu.sum(dim=2) if ctx.needs_input_grad[0] else None
            dmu = -gu.sum(dim=1) if ctx.needs_input_grad[1] else None
        if ctx.needs_input_grad[2]:
            dsinv = torch.einsum("tmc,tmci,tmcj->tcij", g, diff, diff)
        return dq, dmu, dsinv


def mahalanobis_head(qf: torch.Tensor, mu: torch.Tensor, chol: torch.Tensor,
                     backend: Optional[str] = None,
                     sinv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qf: (T, M, F); mu: (T, C, F); chol: (T, C, F, F) -> (T, M, C).

    ``naive``/``ref``: ``cholesky_solve``.  ``cuda``: the kernel on the
    explicit inverse ``sinv`` (computed here when not carried in)."""
    b = resolve_backend(backend, qf.device)
    if b in ("naive", "ref"):
        return _mahalanobis_cho(qf, mu, chol)
    if sinv is None:
        sinv = chol_inverse(chol)
    return _Mahalanobis.apply(qf.float(), mu.float(), sinv.float())


# ===========================================================================
# int8_matmul: out[m, n] = sum_k x[m, k] q[k, n] scale[k, n // BLOCK]
# ===========================================================================


def int8_matmul(x: torch.Tensor, qs, backend: Optional[str] = None
                ) -> torch.Tensor:
    """``x @ W`` with W in the blockwise int8 ``{q, scale, n}`` form.
    x: (..., K) float -> (..., N) float32.  Forward only by contract.

    ``naive``/``ref``: dequantize to f32, one GEMM.  ``cuda``: the kernel,
    which folds each quantisation block's scale into x.  Leading dims are flattened
    around the 2-D kernel."""
    b = resolve_backend(backend, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    if b in ("naive", "ref"):
        out = x2 @ _quant.dequantize(qs)
    else:
        out = _im.int8_matmul(x2.contiguous(), qs["q"].contiguous(),
                              qs["scale"].float().contiguous())
    n = _quant.resolve_n(qs)
    return out.reshape(lead + (n,))


# ===========================================================================
# flash_attention: full-sequence self-attention, causal (the LM trunks, a
# decoder) or bidirectional (whisper's encoder)
# ===========================================================================


def _attention_transcription():
    """``models.layers.attention_scores``, the JAX package's attention
    arithmetic (imported at the call: ``models.layers`` imports this
    module)."""
    from repro_torch.models.layers import attention_scores
    return attention_scores


class _FlashAttention(torch.autograd.Function):
    """q (B, S, Hq, D), k, v (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype,
    causal or not, through the kernel (``ops.flash_attention_gqa``), which
    also writes the rows' log-sum-exp for the backward.

    Backward: the backward kernel (``flash_attention_gqa_bwd``, on a CPU
    tensor its closed form) from the saved q, k, v, output and lse, with
    the same mask (``causal``, ``window``) and softcap; dq only where
    ``needs_input_grad`` asks for q, dk and dv where it asks for k or v.
    It computes the VJP of the transcription ``attention_scores``, which is
    what the JAX models differentiate: their layers never call the Pallas
    kernel, which has no ``custom_vjp``, so the reference owes no backward
    kernel, and the port's is its own.  The two sides round P differently
    in 16-bit dtypes: the forward rounds the un-normalised P in registers
    before P V, the backward recomputes P normalised from the lse in fp32
    and rounds it to v's dtype for dv (the transcription's rounding), and
    rounds dS to q's dtype for dq and dk (the kernel's own).  In fp32 the
    backward is the transcription's VJP to summation order."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fa.flash_attention_gqa(q, k, v, causal=causal, window=window,
                                         softcap=softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        ctx.set_materialize_grads(False)
        return o

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        if g is None or not any(need):
            return (None,) * 6
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_gqa_bwd(
            q, k, v, o, lse, g.contiguous(), causal=ctx.causal, window=ctx.window,
            softcap=ctx.softcap, need_dq=need[0], need_dkv=need[1] or need[2])
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Full-sequence self-attention: q (B, S, Hq, D), k, v (B, S, Hkv, D),
    Hq a multiple of Hkv -> (B, S, Hq, D) in q's dtype.  ``causal``: keys
    at or before each query's position only (bidirectional otherwise);
    keys with ``q_pos - k_pos < window`` are seen; ``softcap`` caps the
    logits.

    ``naive``/``ref``: the transcription ``attention_scores``.  ``cuda``:
    the kernel inside :class:`_FlashAttention` (a window at least S long
    masks nothing, so the kernel is given none)."""
    b = resolve_backend(backend, q.device)
    if b in ("naive", "ref"):
        return _attention_transcription()(q, k, v, causal=causal, window=window,
                                          cap=softcap)
    if window is not None and window >= q.shape[1]:
        window = None
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


# ===========================================================================
# gmm: the MoE layer's grouped expert matmul, out[e] = x[e] @ w[e]
# ===========================================================================

class _GMM(torch.autograd.Function):
    """x (E, C, D), w (E, D, F), one dtype -> (E, C, F) through the gmm
    kernel (B7).

    Backward, with g = d out (E, C, F): dx = g w^T, (E, C, F) @ (E, F, D),
    and dw = x^T g, (E, D, C) @ (E, C, F); each only where
    ``needs_input_grad`` asks for it, so a frozen weight (the CNAPs
    family's trunk) launches no dw.  Both are grouped matmuls, B7's own
    contract, so both run on B7, which takes w^T and x^T as the transposed
    views they are and reads the stored w and x in place: no transposed
    copy is made (one of w^T would be one expert projection's weight, 2.52
    GB at deepseek-v2).  dw's K is the capacity C, a multiple of 8
    (``moe.capacity``), so x's stored rows are 16-byte aligned and TMA can
    read x^T; a K that is not a multiple of B7's 64-deep slab is zero
    filled by the TMA box."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return _gm.gmm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gm.gmm(g, w.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = _gm.gmm(x.transpose(1, 2), g)
        return dx, dw


def gmm(x: torch.Tensor, w: torch.Tensor, backend: Optional[str] = None) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype.

    ``naive``/``ref``: the reference's einsum in the activations' dtype
    (``w`` cast to it).  ``cuda``: the gmm kernel (B7; on a CPU tensor its
    plain version) inside :class:`_GMM`, forward and backward; nothing
    falls back to the einsum."""
    b = resolve_backend(backend, x.device)
    if b in ("naive", "ref"):
        return torch.einsum("ecd,edf->ecf", x, w.to(x.dtype))
    return _GMM.apply(x, w.to(x.dtype))


# ===========================================================================
# ssd_chunk: the Mamba-2 SSD's intra-chunk terms, G chunks at once
# ===========================================================================

class _SSDChunk(torch.autograd.Function):
    """x (G, Q, P), dt (G, Q), A (G,), B, C (G, Q, N), one dtype ->
    (y_diag (G, Q, P), states (G, P, N), chunk_decay (G,), state_decay
    (G, Q)), all fp32, through the ssd_chunk kernel (B6).

    Backward: the backward kernel (``ssd_scan.ssd_chunk_bwd``, on a CPU
    tensor its closed form) from the saved x, dt, A, B and C; an output
    whose cotangent is None (no path reaches it) is left out, and no zeros
    are made for it.  It computes the VJP of ``ssd_chunk_plain``, the
    function the JAX model differentiates through its own einsums
    (``models/mamba2.py::ssd_chunked``): the Pallas kernel has no
    ``custom_vjp``, so the reference owes no backward kernel, and the
    port's is its own."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ins = tuple(t.contiguous() for t in (x, dt, A, B, C))
        ctx.save_for_backward(*ins)
        ctx.set_materialize_grads(False)
        return _ssd.ssd_chunk(*ins)

    @staticmethod
    def backward(ctx, *gs):
        need = ctx.needs_input_grad[:5]
        if not any(need) or all(g is None for g in gs):
            return (None,) * 5
        ins = ctx.saved_tensors
        grads = _ssd.ssd_chunk_bwd(*ins, *gs)
        return tuple(g.to(t.dtype) if n else None for g, t, n in zip(grads, ins, need))


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, backend: Optional[str] = None):
    """The SSD's intra-chunk terms of G chunks: x (G, Q, P), dt (G, Q), A
    (G,), B, C (G, Q, N) -> (y_diag (G, Q, P), states (G, P, N), chunk_decay
    (G,), state_decay (G, Q)), fp32.

    ``naive``/``ref``: the plain version ``ssd_chunk_plain``.  ``cuda``: the
    ssd_chunk kernel (B6; on a CPU tensor its plain version) inside
    :class:`_SSDChunk`; nothing falls back to the plain version."""
    b = resolve_backend(backend, x.device)
    if b in ("naive", "ref"):
        return _ssd.ssd_chunk_plain(x, dt, A, B, C)
    return _SSDChunk.apply(x, dt, A, B, C)
