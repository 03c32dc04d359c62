"""LITE's forward-only serve estimators (Bronskill et al., NeurIPS 2021).

At serve time adaptation is a pure forward pass, so what LITE contributes is
the memory discipline of its no-grad complement pass: the support set is
encoded in ``chunk_size``-bounded chunks, so a large support set adapts in
O(chunk) activation memory, optionally in low precision
(``LiteSpec.compute_dtype``) with fp32 accumulation.  The values are exact:
every support example contributes.

Every function here takes task-batched inputs: leaves (T, N, ...) with an
(T, N) validity mask (1 real, 0 padding); the JAX package vmaps the same
per-task functions over T.  The class-statistics sites run their chunk
bodies through :mod:`repro_torch.kernels.dispatch`.

The H-subset sampling and the straight-through training estimator
(``lite_sum``) belong to the training path and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.tree import tree_cast, tree_leaves, tree_map
from repro_torch.kernels import dispatch

Tree = Any
EncodeFn = Callable[[Tree, Tree], Tree]   # (params, (T*B, ...) inputs) -> (T*B, ...)


@dataclasses.dataclass(frozen=True)
class LiteSpec:
    """Static configuration for one LITE aggregation site.

    h, exact: the training estimator's subset size and exact switch (carried
      for signature compatibility; serving ignores them).
    chunk_size: rows per no-grad chunk (``None`` -> one chunk).
    compute_dtype: optional dtype name (e.g. ``"bfloat16"``): params and
      inputs are cast down for the chunk compute, sums accumulate in fp32.
    """

    h: int = 8
    chunk_size: int | None = None
    exact: bool = False
    compute_dtype: str | None = None


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad axis 1 (the example axis) of (T, n, ...) to ``rows``."""
    pad = rows - a.shape[1]
    if pad == 0:
        return a
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


def _chunked_nograd_reduce(reduce_fn: Callable, frozen_params: Tree, xs: Tree,
                           w: torch.Tensor, chunk_size: int | None,
                           accum_dtype=None) -> Tree:
    """Weighted reduction of per-example encodings over the example axis of
    ``xs`` (leaves (T, N, ...)), in sequential chunks so that only one
    chunk's activations are ever live.  ``reduce_fn(params, (xs_chunk,
    w_chunk), accum_dtype)`` collapses one chunk's example axis; the padded
    tail of the last chunk carries zero weight."""
    n = tree_leaves(xs)[0].shape[1]
    if n == 0:
        raise ValueError("empty support set")
    if chunk_size is None or chunk_size >= n:
        return reduce_fn(frozen_params, (xs, w), accum_dtype)
    total = None
    for s in range(0, n, chunk_size):
        xc = tree_map(lambda a: _pad_rows(a[:, s:s + chunk_size], chunk_size), xs)
        wc = _pad_rows(w[:, s:s + chunk_size], chunk_size)
        part = reduce_fn(frozen_params, (xc, wc), accum_dtype)
        total = part if total is None else tree_map(torch.add, total, part)
    return total


def _flat_encode(encode_fn: EncodeFn, params: Tree, xs: torch.Tensor) -> Tree:
    """Run ``encode_fn`` over the (T*B, ...) rows of a (T, B, ...) batch
    and give its leaves back their (T, B) lead."""
    t, b = xs.shape[:2]
    enc = encode_fn(params, xs.flatten(0, 1))
    return tree_map(lambda e: e.unflatten(0, (t, b)), enc)


def _weighted_reduce(encode_fn: EncodeFn) -> Callable:
    """Default reduction: encode, zero-weight masked rows, sum the example
    axis."""
    def reduce_fn(params, xm, accum_dtype=None):
        xs, m = xm
        enc = _flat_encode(encode_fn, params, xs)
        return tree_map(
            lambda e: torch.sum(
                e * m.reshape(m.shape + (1,) * (e.dim() - 2)).to(e.dtype),
                dim=1, dtype=accum_dtype), enc)
    return reduce_fn


def serve_sum(encode_fn: EncodeFn, params: Tree, xs: Tree, spec: LiteSpec,
              mask: torch.Tensor, reduce_fn: Callable | None = None) -> Tree:
    """Exact masked sum over the example axis, forward-only, in
    ``spec.chunk_size`` chunks, optionally in ``spec.compute_dtype`` with
    fp32 accumulation.  ``reduce_fn`` replaces the default
    encode-weight-sum (the class-statistics sites pass a dispatch
    reduction)."""
    if reduce_fn is None:
        reduce_fn = _weighted_reduce(encode_fn)
    accum = None
    if spec.compute_dtype is not None:
        cd = getattr(torch, spec.compute_dtype)
        params = tree_cast(params, cd)
        xs = tree_cast(xs, cd)
        accum = torch.float32
    with torch.inference_mode():
        return _chunked_nograd_reduce(reduce_fn, params, xs, mask,
                                      spec.chunk_size, accum_dtype=accum)


def _masked_onehot(ys: torch.Tensor, num_classes: int,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """(T, N) labels (padding -1) -> (T, N, C) float32 one-hot, times mask."""
    onehot = (ys[..., None] == torch.arange(num_classes, device=ys.device)
              ).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask[..., None]
    return onehot


def serve_segment_sum(encode_fn: EncodeFn, params: Tree, xs: torch.Tensor,
                      ys: torch.Tensor, num_classes: int, spec: LiteSpec,
                      mask: torch.Tensor, backend: str | None = None
                      ) -> Tuple[Tree, torch.Tensor]:
    """Exact per-class sums ``S[t, c] = sum_n 1(y = c) e(x_n)`` through
    ``dispatch.segment_sum``; returns (sums (T, C, ...), counts (T, C))."""
    onehot_all = _masked_onehot(ys, num_classes, mask)
    counts = onehot_all.sum(dim=1)

    def seg_reduce(p, xm, accum_dtype=None):
        (inputs, onehot), w = xm
        oh = onehot * w.to(onehot.dtype)[..., None]
        enc = _flat_encode(encode_fn, p, inputs)
        return tree_map(lambda e: dispatch.segment_sum(
            e, oh, accum_dtype=accum_dtype, backend=backend), enc)

    sums = serve_sum(None, params, (xs, onehot_all), spec, mask,
                     reduce_fn=seg_reduce)
    return sums, counts


def serve_class_stats(features_fn: Callable, params: Tree, xs: torch.Tensor,
                      ys: torch.Tensor, num_classes: int, spec: LiteSpec,
                      mask: torch.Tensor, second_moment: bool = False,
                      backend: str | None = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Fused per-class feature statistics: ``stats["feat"]`` (T, C, F) class
    sums and, with ``second_moment``, ``stats["outer"]`` (T, C, F, F) raw
    second moments through ``dispatch.class_second_moment`` (no per-example
    (B, F, F) tensor).  ``features_fn(params, (T*B, ...)) -> (T*B, F)``.
    Returns (stats, counts (T, C))."""
    onehot_all = _masked_onehot(ys, num_classes, mask)
    counts = onehot_all.sum(dim=1)

    def stats_reduce(p, xm, accum_dtype=None):
        (inputs, onehot), w = xm
        oh = onehot * w.to(onehot.dtype)[..., None]
        feat = _flat_encode(features_fn, p, inputs)             # (T, B, F)
        out = dict(feat=dispatch.segment_sum(feat, oh, accum_dtype=accum_dtype,
                                             backend=backend))
        if second_moment:
            out["outer"] = dispatch.class_second_moment(
                feat, oh, accum_dtype=accum_dtype, backend=backend)
        return out

    stats = serve_sum(None, params, (xs, onehot_all), spec, mask,
                      reduce_fn=stats_reduce)
    return stats, counts
