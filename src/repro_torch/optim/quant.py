"""Blockwise int8 quantization, bit-exact with ``repro.optim.quant``.

A quantized tensor is ``{q: int8 same shape, scale: f32 with the last dim
reduced by BLOCK, n: original trailing dim}``.  The scale of a block is its
absmax / 127, floored at 1e-12; values round half to even (``torch.round``,
as ``jnp.round``) and clip to [-127, 127].

The log-domain half (``quantize_log`` / ``dequantize_log``, for AdamW's
second moment) is the linear one applied to ``log(max(x, 1e-12))`` and
undone by ``exp``.  Those two are each framework's own: XLA's CPU log
and exp are not correctly rounded (about 2.5 % and 9.5 % of fp32 inputs
read one ulp off the correctly rounded value), torch's nearly are, so
the log half agrees with the JAX package's to an ulp of the log, not bit
for bit; on the same log values it is bit-exact.
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


def is_quantized(x) -> bool:
    """A ``{q, scale, n}`` dict: one leaf of a tree, not a subtree."""
    return isinstance(x, dict) and {"q", "scale"} <= set(x)


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


def zeros_quantized(shape, device=None) -> Dict:
    """The quantized form of zeros of ``shape``: int8 zeros, every block's
    scale at the 1e-12 floor."""
    shape = tuple(shape)
    n = shape[-1]
    nb = (n + BLOCK - 1) // BLOCK
    return dict(q=torch.zeros(shape, dtype=torch.int8, device=device),
                scale=torch.full(shape[:-1] + (nb,), 1e-12, dtype=torch.float32,
                                 device=device),
                n=n)


# -- the log-domain form, for strictly positive state of a wide dynamic range
# (AdamW's second moment): a linear absmax block would round its small
# entries to 0 and blow up 1/sqrt(v); quantizing log(v) bounds the error
# multiplicatively.

_LOG_FLOOR = 1e-12


def quantize_log(x: torch.Tensor) -> Dict:
    return quantize(torch.log(torch.clamp(x.to(torch.float32), min=_LOG_FLOOR)))


def dequantize_log(qs: Dict, n: int = None) -> torch.Tensor:
    v = torch.exp(dequantize(qs, n))
    return torch.where(v <= _LOG_FLOOR * 1.5, torch.zeros_like(v), v)


def zeros_quantized_log(shape, device=None) -> Dict:
    return quantize_log(torch.zeros(tuple(shape), dtype=torch.float32, device=device))
