"""Flash attention (block-tiled online softmax) with the attention variants
of the model pool: causal, sliding window (gemma2 local layers) and logit
softcap, scale ``D^-1/2``, output in q's dtype.

Two layouts reach the one kernel (``csrc/flash_attention.cu``):

* :func:`flash_attention` on (BH, S, D), batch and heads flattened;
* :func:`flash_attention_gqa` on q (B, S, Hq, D) and k, v (B, S, Hkv, D):
  query head h reads kv head ``h // (Hq // Hkv)`` inside the kernel, so the
  kv heads are neither repeated nor transposed.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it.

The kernel has two routes, and :func:`flash_route` picks one before the
launch from dtype, head dim and layout alone: ``"wgmma"`` (tensor cores fed
by TMA) for bf16 and fp16 at head dims 64, 96, 112, 128 and 256 that TMA
can read (96 and 112, phi-3-vision's and zamba2's, on the 128-wide kernel
with the columns past the head dim zero filled), ``"simt"`` (fp32 on the
CUDA cores) otherwise.  This is a dispatch by dtype and layout, not a
fallback: a launch that fails raises, and nothing retries it on the other
route.

The backward (``csrc/flash_attention_bwd.cu``,
:func:`flash_attention_gqa_bwd`) takes the forward's row log-sum-exp,
which :func:`flash_attention_gqa` writes only when asked (``with_lse``).
:func:`flash_bwd_route` picks its route: ``"wgmma"`` (warpgroup products
fed by TMA, as the forward's) for bf16 and fp16 at the head dims above that
TMA can read, ``"simt"`` otherwise.  Its plain version is the closed form
:func:`flash_attention_gqa_bwd_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_tensor, ptr, require,
                                          require_no_grad, stream, tma_ready)
from repro_torch.kernels.ref import attention_ref

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # codes 0, 1, 2
MAX_HEAD_DIM = 256
# the tensor-core kernel's head dims: 96 and 112 run the 128 template on
# zero-filled columns
WGMMA_HEAD_DIMS = (64, 96, 112, 128, 256)


# the plain version on (BH, S, D): the dense-softmax oracle
flash_attention_plain = attention_ref


def flash_attention_gqa_plain(q, k, v, *, with_lse: bool = False, **kw):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D): kv heads
    repeated to Hq, heads folded into the batch, dense softmax.  With
    ``with_lse``, also the rows' log-sum-exp (B, Hq, S) fp32
    (:func:`attention_lse_plain`)."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(b * hq, s, d)
    o = flash_attention_plain(fold(q), fold(kr), fold(vr), **kw).reshape(b, hq, s, d)
    o = o.transpose(1, 2)
    return (o, attention_lse_plain(q, k, **kw)) if with_lse else o


def _logits(q, k, causal: bool, window: Optional[int], softcap: Optional[float]):
    """The scaled, softcapped logits (B, Hkv, Hq / Hkv, S, S) of q (B, S,
    Hq, D) against k (B, S, Hkv, D) in fp32 (fp64 for fp64 inputs), their
    mask (S, S) and, with a softcap, tanh of the capped argument."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    f = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(f).reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(f)) * (d ** -0.5)
    th = None
    if softcap is not None:
        th = torch.tanh(logits / softcap)
        logits = softcap * th
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return logits, mask, th


def attention_lse_plain(q, k, *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """The rows' natural log-sum-exp of the masked logits, (B, Hq, S) fp32
    (fp64 for fp64 inputs), +inf for a row that sees no key, as the kernel
    writes it for the backward."""
    b, s, hq, _ = q.shape
    logits, mask, _ = _logits(q, k, causal, window, softcap)
    lse = torch.logsumexp(logits.masked_fill(~mask, -torch.inf), dim=-1)
    lse = torch.where(torch.isfinite(lse), lse, torch.inf)
    return lse.reshape(b, hq, s)


def flash_attention_gqa_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None):
    """The closed form of the backward, (dq, dk, dv) in q's dtype from q (B,
    S, Hq, D), k, v (B, S, Hkv, D), the output o and its cotangent do (B, S,
    Hq, D) and the rows' lse (B, Hq, S), in fp32 (fp64 for fp64 inputs):

        Delta = rowsum(do o o);  P = exp(t - lse) on the mask, else 0
        dv = P^T do (P rounded to v's dtype);  dP = do v^T
        dS = P o (dP - Delta) o scale (1 - tanh^2 where softcapped)
        dq = dS k;  dk = dS^T q

    (the kv heads' gradients summed over their query heads)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    f = torch.promote_types(q.dtype, torch.float32)
    logits, mask, th = _logits(q, k, causal, window, softcap)
    grp = lambda t: t.to(f).reshape(b, s, hkv, hq // hkv, d)  # noqa: E731
    lse = lse.to(f).reshape(b, hkv, hq // hkv, s)[..., None]
    p = torch.where(mask, torch.exp(logits - lse), 0.0)
    dog = grp(do)
    delta = (dog * grp(o)).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, Hkv, G, S, 1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(v.dtype).to(f), dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.to(f))
    ds = p * (dp - delta) * (d ** -0.5)
    if th is not None:
        ds = ds * (1 - th * th)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(f)).reshape(b, s, hq, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, grp(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 or fp16 q, k, v of one dtype, a head dim (the
    last axis) in :data:`WGMMA_HEAD_DIMS`, that TMA can read
    (:func:`~repro_torch.kernels._checks.tma_ready`), else ``"simt"``.  A plain
    function of dtypes, shapes, strides and addresses."""
    tc = (q.dtype in (torch.bfloat16, torch.float16) and k.dtype == q.dtype
          and v.dtype == q.dtype and q.shape[-1] in WGMMA_HEAD_DIMS)
    return "wgmma" if tc and tma_ready(q, k, v) else "simt"


def flash_bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor) -> str:
    """The backward's route: ``"wgmma"`` for bf16 or fp16 q, k, v and do of
    one dtype, a head dim in :data:`WGMMA_HEAD_DIMS`, that TMA can read
    (:func:`~repro_torch.kernels._checks.tma_ready`), else
    ``"simt"``.  A plain function of dtypes, shapes, strides and
    addresses."""
    tc = (q.dtype in (torch.bfloat16, torch.float16)
          and all(t.dtype == q.dtype for t in (k, v, do)) and q.shape[-1] in WGMMA_HEAD_DIMS)
    return "wgmma" if tc and tma_ready(q, k, v, do) else "simt"


def _launch(q, k, v, b, hq, hkv, s, d, q_strides, kv_strides, causal,
            window, softcap, lse=None) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, q.dim(), _DTYPES, q.device)
    require(k.dtype == q.dtype and v.dtype == q.dtype,
            lambda: f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    require(k.shape == v.shape, lambda: f"k {tuple(k.shape)} vs v {tuple(v.shape)}")
    require(0 < d <= MAX_HEAD_DIM, lambda: f"head dim {d} not in 1..{MAX_HEAD_DIM}")
    require(hkv > 0 and hq % hkv == 0, lambda: f"{hq} query heads over {hkv} kv heads")
    require(window is None or window >= 0, lambda: f"window {window} < 0")
    require(softcap is None or softcap != 0, "softcap 0")
    route = flash_route(q, k, v)
    o = torch.empty_like(q)
    _build.launch("rt_flash_attention", "flash_attention", ptr(q), ptr(k),
                  ptr(v), ptr(o), ptr(lse), _DTYPES.index(q.dtype), b, hq, hkv, s, d,
                  *q_strides, *kv_strides, int(causal),
                  -1 if window is None else int(window), int(softcap is not None),
                  float(softcap or 0.0), float(d ** -0.5), _build.ROUTES.index(route),
                  stream(q.device), route=route)
    return o


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (BH, S, D) fp32/bf16/fp16, one dtype -> (BH, S, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    require_no_grad("flash_attention", q, k, v)
    require(q.dim() == 3 and q.shape == k.shape,
            lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}: expected one (BH, S, D)")
    bh, s, d = q.shape
    strides = (s * d, 0, d)                     # (batch, head, sequence)
    return _launch(q, k, v, bh, 1, 1, s, d, strides, strides, causal, window,
                   softcap)


def flash_attention_gqa(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, with_lse: bool = False):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D), Hq a multiple of Hkv ->
    (B, S, Hq, D) in q's dtype; with ``with_lse`` also the rows'
    log-sum-exp (B, Hq, S) fp32 that the backward reads (serving asks for
    none)."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, with_lse=with_lse, **kw)
    require_no_grad("flash_attention", q, k, v)
    require(q.dim() == 4 and k.dim() == 4 and q.shape[:2] == k.shape[:2]
            and q.shape[3] == k.shape[3],
            lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}: expected (B, S, H, D)")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if with_lse else None
    o = _launch(q, k, v, b, hq, hkv, s, d, (s * hq * d, d, hq * d),
                (s * hkv * d, d, hkv * d), lse=lse, **kw)
    return (o, lse) if with_lse else o


def flash_attention_gqa_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None, softcap: Optional[float] = None,
                            need_dq: bool = True, need_dkv: bool = True):
    """The backward of :func:`flash_attention_gqa`: q, o, do (B, S, Hq, D),
    k, v (B, S, Hkv, D) contiguous, of one dtype, and the forward's lse (B,
    Hq, S) fp32 -> (dq, dk, dv) in q's dtype, each None where not asked
    (``need_dq``; ``need_dkv``: dk and dv).  On a CUDA tensor one launch of
    the backward kernel, counted under ``flash_attention_bwd`` (and its
    route), its products under ``flash_attention_bwd/dq`` and
    ``flash_attention_bwd/dkv``."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_gqa_bwd_plain(q, k, v, o, lse, do, **kw)
        return (dq if need_dq else None, dk if need_dkv else None, dv if need_dkv else None)
    require_no_grad("flash_attention_bwd", q, k, v, o, do)
    require(q.dim() == 4 and k.dim() == 4 and q.shape[:2] == k.shape[:2]
            and q.shape[3] == k.shape[3] and k.shape == v.shape and o.shape == q.shape
            and do.shape == q.shape,
            lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"o {tuple(o.shape)}, do {tuple(do.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        check_tensor(name, t, 4, (q.dtype,) if name != "q" else _DTYPES, q.device)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    check_tensor("lse", lse, 3, (torch.float32,), q.device)
    require(lse.shape == (b, hq, s), lambda: f"lse {tuple(lse.shape)}, want {(b, hq, s)}")
    require(0 < d <= MAX_HEAD_DIM, lambda: f"head dim {d} not in 1..{MAX_HEAD_DIM}")
    require(hq % hkv == 0, lambda: f"{hq} query heads over {hkv} kv heads")
    require(window is None or window >= 0, lambda: f"window {window} < 0")
    require(softcap is None or softcap != 0, "softcap 0")
    route = flash_bwd_route(q, k, v, do)
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dkv else None
    dv = torch.empty_like(v) if need_dkv else None
    if not (need_dq or need_dkv):
        return dq, dk, dv
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _build.launch("rt_flash_attention_bwd", "flash_attention_bwd", ptr(q), ptr(k), ptr(v),
                  ptr(o), ptr(lse), ptr(do), ptr(dq), ptr(dk), ptr(dv), ptr(delta),
                  _DTYPES.index(q.dtype), b, hq, hkv, s, d, s * hq * d, d, hq * d,
                  s * hkv * d, d, hkv * d, int(causal), -1 if window is None else int(window),
                  int(softcap is not None), float(softcap or 0.0), float(d ** -0.5),
                  int(need_dq), int(need_dkv), _build.ROUTES.index(route), stream(q.device),
                  route=route)
    for part, on in (("dq", need_dq), ("dkv", need_dkv)):
        if on:
            _build.launches.bump(f"flash_attention_bwd/{part}")
    return dq, dk, dv
