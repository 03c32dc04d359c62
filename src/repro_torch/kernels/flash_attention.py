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


def flash_attention_gqa_plain(q, k, v, **kw) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D): kv heads
    repeated to Hq, heads folded into the batch, dense softmax."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    fold = lambda t: t.transpose(1, 2).reshape(b * hq, s, d)
    o = flash_attention_plain(fold(q), fold(k), fold(v), **kw)
    return o.reshape(b, hq, s, d).transpose(1, 2)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 or fp16 q, k, v of one dtype, a head dim (the
    last axis) in :data:`WGMMA_HEAD_DIMS`, that TMA can read
    (:func:`~repro_torch.kernels._checks.tma_ready`), else ``"simt"``.  A plain
    function of dtypes, shapes, strides and addresses."""
    tc = (q.dtype in (torch.bfloat16, torch.float16) and k.dtype == q.dtype
          and v.dtype == q.dtype and q.shape[-1] in WGMMA_HEAD_DIMS)
    return "wgmma" if tc and tma_ready(q, k, v) else "simt"


def _launch(q, k, v, b, hq, hkv, s, d, q_strides, kv_strides, causal,
            window, softcap) -> torch.Tensor:
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
                  ptr(v), ptr(o), _DTYPES.index(q.dtype), b, hq, hkv, s, d,
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
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D), Hq a multiple of Hkv ->
    (B, S, Hq, D) in q's dtype."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, **kw)
    require_no_grad("flash_attention", q, k, v)
    require(q.dim() == 4 and k.dim() == 4 and q.shape[:2] == k.shape[:2]
            and q.shape[3] == k.shape[3],
            lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)}: expected (B, S, H, D)")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    return _launch(q, k, v, b, hq, hkv, s, d, (s * hq * d, d, hq * d),
                   (s * hkv * d, d, hkv * d), **kw)
