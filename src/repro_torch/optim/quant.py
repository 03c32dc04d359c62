"""Blockwise int8 quantization, bit-exact with ``repro.optim.quant``.

A quantized tensor is ``{q: int8 same shape, scale: f32 with the last dim
reduced by BLOCK, n: original trailing dim}``.  The scale of a block is its
absmax / 127, floored at 1e-12; values round half to even (``torch.round``,
as ``jnp.round``) and clip to [-127, 127].
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BLOCK = 128


def _pad_to_block(x: torch.Tensor):
    n = x.shape[-1]
    pad = (-n) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x, n


def resolve_n(qs: Dict, n=None) -> int:
    """Original trailing dim: explicit ``n`` beats the stored one, which is
    trusted only while it is a plain int; otherwise ``q.shape[-1]``."""
    if n is None:
        n = qs.get("n")
    if not (isinstance(n, int) and not isinstance(n, bool)):
        n = qs["q"].shape[-1]
    return int(n)


def quantize(x: torch.Tensor) -> Dict:
    """x: float (..., N) -> {q int8 (..., N), scale f32 (..., ceil(N/B)), n: N}."""
    xp, n = _pad_to_block(x.to(torch.float32))
    blocks = xp.reshape(xp.shape[:-1] + (-1, BLOCK))
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127).to(torch.int8)
    q = q.reshape(xp.shape)[..., :n].contiguous()
    return dict(q=q, scale=scale, n=n)


def dequantize(qs: Dict, n: int = None) -> torch.Tensor:
    q, scale = qs["q"], qs["scale"]
    n = resolve_n(qs, n)
    qp, _ = _pad_to_block(q.to(torch.float32))
    blocks = qp.reshape(qp.shape[:-1] + (-1, BLOCK))
    x = blocks * scale[..., None]
    return x.reshape(qp.shape)[..., :n]
