"""The product of an input with a weight, whatever form the weight is
served in: every site that multiplies by a 2-D weight the serving layouts
may split calls :func:`matmul` (the backbone's head, the set encoder's
dense layers, the FiLM generator, the learners' heads), so that no site
branches on the layout.

A weight is one of

* a tensor (K, N): ``x @ w``;
* a blockwise int8 ``{q, scale, n}`` leaf: the ``int8_matmul`` kernel
  (B4) through :func:`repro_torch.kernels.dispatch.int8_matmul`;
* a :class:`KSlice`: this rank's rows ``lo:hi`` of a (K, N) weight whose
  other rows lie on the other ranks of its serving group (the
  ``weight_stationary`` layout, :mod:`repro_torch.serve.quant_params`).
  The product multiplies the matching columns of ``x``, made contiguous,
  by the slice (a tensor, or an int8 leaf whose ``q`` and ``scale`` hold
  the same rows) and sums the partial products over the group with one
  all-reduce: the JAX package's contracting-dim sharding, in another
  order of summation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels import dispatch
from repro_torch.optim.quant import is_quantized


@dataclasses.dataclass(frozen=True)
class KSlice:
    """Rows ``lo:hi`` of a weight of ``k`` rows; ``reduce(partial)`` sums a
    partial product over the group in place and returns it."""

    local: Any
    lo: int
    hi: int
    k: int
    reduce: Callable[[torch.Tensor], torch.Tensor]


def _dense(x: torch.Tensor, w) -> torch.Tensor:
    if is_quantized(w):
        return dispatch.int8_matmul(x, w)
    return x @ w


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` for ``w`` a tensor, an int8 leaf or a
    :class:`KSlice`."""
    if isinstance(w, KSlice):
        local = w.local
        if isinstance(local, torch.Tensor) and local.dtype != x.dtype:
            local = local.to(x.dtype)     # a LITE compute dtype casts the input
        return w.reduce(_dense(x[..., w.lo:w.hi].contiguous(), local))
    return _dense(x, w)
