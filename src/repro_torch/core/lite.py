"""LITE (Bronskill et al., NeurIPS 2021): the training estimators and their
forward-only serve twins.

When a loss sees the support set only through a sum of per-example
encodings, ``e(D_S) = sum_n e(x_n)``, LITE's estimator (paper Eq. 8) keeps
the forward value exact (all N examples contribute) and back-propagates
through a random subset H of them, scaled by N/H.  The complement is
forwarded under ``torch.no_grad`` on detached parameters in
``chunk_size``-bounded chunks, so only |H| examples' activations are kept
for the backward and one chunk's are live at a time: that is what makes
LITE a memory saving.  ``straight_through`` joins the two:

    combined = full.detach() + scale * (value_H - value_H.detach())

At serve time adaptation is a pure forward pass, so the serve twins
(``serve_sum`` and friends) are the complement's chunked exact sum over
every example, under ``torch.inference_mode``.

Every function here takes task-batched inputs: leaves (T, N, ...) with a
(T, N) validity mask (1 real, 0 padding); the JAX package vmaps the same
per-task functions over T.  Inputs may be images or integer token ids:
padding fills zeros and a ``compute_dtype`` cast touches floating leaves
only, so ids stay ids.  The class-statistics sites run their chunk
bodies through :mod:`repro_torch.kernels.dispatch`.

The H subsets are a function of per-index scores, a (T, N) tensor: torch
cannot reproduce ``jax.random``, so the scores are an input (the parity
tests pass the JAX package's own ``_index_scores``), and
:func:`index_scores` derives them from (seed, step, task, example) with a
counter-based hash where none are given.  A score depends on its example's
index and not on N, so a task padded to a larger size draws the same
subset.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.tree import tree_cast, tree_detach, tree_leaves, tree_map
from repro_torch.kernels import dispatch

Tree = Any
EncodeFn = Callable[[Tree, Tree], Tree]   # (params, (T*B, ...) inputs) -> (T*B, ...)


@dataclasses.dataclass(frozen=True)
class LiteSpec:
    """Static configuration for one LITE aggregation site.

    h: support examples to back-propagate (|H| in the paper); ``h >= n``
      gives the exact gradient.
    chunk_size: rows per no-grad chunk (``None`` -> one chunk).
    exact: force exact gradients (baseline / eval mode).
    compute_dtype: optional dtype name (e.g. ``"bfloat16"``) for the no-grad
      complement only: params and inputs are cast down for the chunk
      compute, sums accumulate in fp32; gradients are untouched.
    """

    h: int = 8
    chunk_size: int | None = None
    exact: bool = False
    compute_dtype: str | None = None

    def resolved_h(self, n: int) -> int:
        return n if self.exact else min(self.h, n)


# ===========================================================================
# the H subsets
# ===========================================================================

_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 arrays (wrapping arithmetic)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def index_scores(seed: int, step: int, task_ids, n: int,
                 device=None) -> torch.Tensor:
    """(T, N) float32 scores in [0, 1), the score of example i of task t a
    function of (seed, step, task_ids[t], i) alone: a counter-based hash, so
    every device and every padding of a task gives the same draw."""
    g = np.uint64(_GOLDEN)
    with np.errstate(over="ignore"):
        h = _mix64(np.array([seed], np.uint64) * g + np.uint64(step))
        h = _mix64((h * g)[:, None] ^ np.asarray(task_ids, np.uint64)[:, None])
        h = _mix64(h * g ^ np.arange(n, dtype=np.uint64)[None, :])
    u = (h >> np.uint64(40)).astype(np.float32) / np.float32(1 << 24)
    return torch.from_numpy(u).to(device)


def sample_h_indices(scores: torch.Tensor, h: int,
                     mask: torch.Tensor | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h_idx (T, h), comp_idx (T, N - h)): the examples ranked by score;
    with ``mask`` padded slots rank after every real one, so H fills with
    real examples first and matches the unpadded task's draw."""
    if mask is not None:
        scores = scores + 2.0 * (1.0 - mask)
    order = torch.argsort(scores, dim=1, stable=True)
    return order[:, :h], order[:, h:]


def sample_stratified_indices(scores: torch.Tensor, ys: torch.Tensor,
                              num_classes: int, h: int,
                              mask: torch.Tensor | None = None) -> torch.Tensor:
    """(T, h) indices with at least one example a class when h >= the
    classes present (the paper's sub-sampled-task baseline, App. D.4): each
    example's rank within its class, in score order, plus half its score;
    padded rows count in no class and rank last."""
    n = ys.shape[1]
    order = torch.argsort(scores, dim=1, stable=True)
    onehot = _masked_onehot(ys.gather(1, order), num_classes,
                            None if mask is None else mask.gather(1, order))
    rank = torch.sum(torch.cumsum(onehot, dim=1) * onehot, dim=-1) - 1.0
    ranked = torch.zeros_like(scores).scatter(
        1, order, rank + 0.5 * scores.gather(1, order))
    if mask is not None:
        ranked = ranked + 2.0 * n * (1.0 - mask)
    return torch.argsort(ranked, dim=1, stable=True)[:, :h]


def straight_through(full: Tree, grad_value: Tree, scale: torch.Tensor) -> Tree:
    """Forward ``full``; backward ``scale * d(grad_value)``, leaf-wise, with
    a per-task ``scale`` (T,)."""
    def one(f, g):
        s = scale.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
        return f.detach() + s * (g - g.detach())
    return tree_map(one, full, grad_value)


# ===========================================================================
# shared pieces
# ===========================================================================

def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad axis 1 (the example axis) of (T, n, ...) to ``rows``."""
    pad = rows - a.shape[1]
    if pad == 0:
        return a
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


def _take_rows(tree: Tree, idx: torch.Tensor) -> Tree:
    """Rows ``idx`` (T, k) of every (T, N, ...) leaf -> (T, k, ...)."""
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda a: a[lanes, idx], tree)


def _chunked_nograd_reduce(reduce_fn: Callable, frozen_params: Tree, xs: Tree,
                           w: torch.Tensor, chunk_size: int | None,
                           accum_dtype=None) -> Tree:
    """Weighted reduction of per-example encodings over the example axis of
    ``xs`` (leaves (T, N, ...)), in sequential chunks so that only one
    chunk's activations are ever live; the caller sets the grad mode.
    ``reduce_fn(params, (xs_chunk, w_chunk), accum_dtype)`` collapses one
    chunk's example axis; the padded tail of the last chunk carries zero
    weight.  Only the running sum outlives a chunk."""
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


def _masked_encode(encode_fn: EncodeFn) -> Callable:
    """``encode_fn`` over ((T, B, ...) inputs, (T, B) weights), masked rows
    zeroed."""
    def enc(params, xm):
        xs, m = xm
        return tree_map(
            lambda e: e * m.reshape(m.shape + (1,) * (e.dim() - 2)).to(e.dtype),
            _flat_encode(encode_fn, params, xs))
    return enc


def _weighted_reduce(encode_fn: EncodeFn) -> Callable:
    """Default reduction: encode, zero-weight masked rows, sum the example
    axis."""
    enc_w = _masked_encode(encode_fn)

    def reduce_fn(params, xm, accum_dtype=None):
        return tree_map(lambda e: torch.sum(e, dim=1, dtype=accum_dtype),
                        enc_w(params, xm))
    return reduce_fn


def _masked_scale(mask: torch.Tensor, h: int) -> torch.Tensor:
    """(T,) N/H rescale over REAL examples only: a task with fewer than H
    real examples puts all of them in H (scale 1)."""
    n_real = mask.sum(dim=1)
    return n_real / torch.clamp(n_real, min=1.0).clamp(max=float(h))


def _complement_inputs(params: Tree, xs: Tree, spec: LiteSpec):
    """Detached params and inputs for a no-grad pass, cast down to
    ``spec.compute_dtype`` if set, and the accumulation dtype."""
    frozen = tree_detach(params)
    if spec.compute_dtype is None:
        return frozen, xs, None
    cd = getattr(torch, spec.compute_dtype)
    return tree_cast(frozen, cd), tree_cast(xs, cd), torch.float32


# ===========================================================================
# the estimators
# ===========================================================================

def lite_sum(encode_fn: EncodeFn, params: Tree, xs: Tree, spec: LiteSpec,
             mask: torch.Tensor, scores: torch.Tensor | None,
             reduce_fn: Callable | None = None) -> Tree:
    """LITE estimator of the masked sum over the example axis (paper Eq. 8):
    the exact sum forward, (N/H) times the H subset's gradient backward.
    ``scores`` (T, N) choose H (:func:`sample_h_indices`); the H pass and
    the complement share that one draw.  ``reduce_fn`` replaces the default
    encode-weight-sum (the class-statistics sites pass a dispatch
    reduction).  Exact mode (or h >= N) is one differentiable pass."""
    n = tree_leaves(xs)[0].shape[1]
    h = spec.resolved_h(n)
    if reduce_fn is None:
        reduce_fn = _weighted_reduce(encode_fn)
    if spec.exact or h >= n:
        return reduce_fn(params, (xs, mask), None)
    h_idx, comp_idx = sample_h_indices(scores, h, mask)
    sum_h = reduce_fn(params, (_take_rows(xs, h_idx), mask.gather(1, h_idx)), None)
    frozen, xs_c, accum = _complement_inputs(params, _take_rows(xs, comp_idx), spec)
    with torch.no_grad():
        sum_c = _chunked_nograd_reduce(reduce_fn, frozen, xs_c,
                                       mask.gather(1, comp_idx), spec.chunk_size,
                                       accum_dtype=accum)
        full = tree_map(lambda a, b: a.detach() + b.to(a.dtype), sum_h, sum_c)
    return straight_through(full, sum_h, _masked_scale(mask, h))


def serve_sum(encode_fn: EncodeFn, params: Tree, xs: Tree, spec: LiteSpec,
              mask: torch.Tensor, reduce_fn: Callable | None = None) -> Tree:
    """Exact masked sum over the example axis, forward-only, in
    ``spec.chunk_size`` chunks, optionally in ``spec.compute_dtype`` with
    fp32 accumulation: :func:`lite_sum`'s complement over every example."""
    if reduce_fn is None:
        reduce_fn = _weighted_reduce(encode_fn)
    frozen, xs, accum = _complement_inputs(params, xs, spec)
    with torch.inference_mode():
        return _chunked_nograd_reduce(reduce_fn, frozen, xs, mask,
                                      spec.chunk_size, accum_dtype=accum)


def subsampled_task_sum(encode_fn: EncodeFn, params: Tree, xs: Tree,
                        spec: LiteSpec, mask: torch.Tensor,
                        scores: torch.Tensor | None) -> Tree:
    """The paper's naive baseline (Fig. 4): forward AND backward over the H
    subset only, scaled by N/H so the expected value is the full sum."""
    n = tree_leaves(xs)[0].shape[1]
    h = spec.resolved_h(n)
    enc_w = _masked_encode(encode_fn)
    if spec.exact or h >= n:
        return tree_map(lambda e: torch.sum(e, dim=1), enc_w(params, (xs, mask)))
    h_idx, _ = sample_h_indices(scores, h, mask)
    enc = enc_w(params, (_take_rows(xs, h_idx), mask.gather(1, h_idx)))
    scale = _masked_scale(mask, h)
    return tree_map(lambda e: scale.reshape((-1,) + (1,) * (e.dim() - 2))
                    * torch.sum(e, dim=1), enc)


def _masked_onehot(ys: torch.Tensor, num_classes: int,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """(T, N) labels (padding -1) -> (T, N, C) float32 one-hot, times mask."""
    onehot = (ys[..., None] == torch.arange(num_classes, device=ys.device)
              ).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask[..., None]
    return onehot


def lite_segment_sum(encode_fn: EncodeFn, params: Tree, xs: torch.Tensor,
                     ys: torch.Tensor, num_classes: int, spec: LiteSpec,
                     mask: torch.Tensor, scores: torch.Tensor | None,
                     backend: str | None = None, sum_fn: Callable | None = None
                     ) -> Tuple[Tree, torch.Tensor]:
    """LITE estimator of the per-class sums ``S[t, c] = sum_n 1(y = c)
    e(x_n)`` through ``dispatch.segment_sum``: one global N/H rescale keeps
    every class sum unbiased, since H is drawn over all the support.
    ``sum_fn`` swaps the set-sum estimator (:func:`serve_segment_sum` passes
    :func:`serve_sum`).  Returns (sums (T, C, ...), exact counts (T, C))."""
    onehot_all = _masked_onehot(ys, num_classes, mask)

    def seg_reduce(p, xm, accum_dtype=None):
        (inputs, onehot), w = xm
        oh = onehot * w.to(onehot.dtype)[..., None]
        enc = _flat_encode(encode_fn, p, inputs)
        return tree_map(lambda e: dispatch.segment_sum(
            e, oh, accum_dtype=accum_dtype, backend=backend), enc)

    sum_fn = sum_fn or functools.partial(lite_sum, scores=scores)
    sums = sum_fn(None, params, (xs, onehot_all), spec, mask, reduce_fn=seg_reduce)
    return sums, onehot_all.sum(dim=1)


def serve_segment_sum(encode_fn: EncodeFn, params: Tree, xs: torch.Tensor,
                      ys: torch.Tensor, num_classes: int, spec: LiteSpec,
                      mask: torch.Tensor, backend: str | None = None
                      ) -> Tuple[Tree, torch.Tensor]:
    """Exact per-class sums, forward-only (:func:`serve_sum`)."""
    return lite_segment_sum(encode_fn, params, xs, ys, num_classes, spec, mask,
                            None, backend=backend, sum_fn=serve_sum)


def lite_class_stats(features_fn: Callable, params: Tree, xs: torch.Tensor,
                     ys: torch.Tensor, num_classes: int, spec: LiteSpec,
                     mask: torch.Tensor, scores: torch.Tensor | None,
                     second_moment: bool = False, backend: str | None = None,
                     sum_fn: Callable | None = None
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Fused per-class feature statistics under the LITE estimator:
    ``stats["feat"]`` (T, C, F) class sums and, with ``second_moment``,
    ``stats["outer"]`` (T, C, F, F) raw second moments through
    ``dispatch.class_second_moment`` (no per-example (B, F, F) tensor).
    ``features_fn(params, (T*B, ...)) -> (T*B, F)``.  Returns (stats,
    counts (T, C))."""
    onehot_all = _masked_onehot(ys, num_classes, mask)

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

    sum_fn = sum_fn or functools.partial(lite_sum, scores=scores)
    stats = sum_fn(None, params, (xs, onehot_all), spec, mask, reduce_fn=stats_reduce)
    return stats, onehot_all.sum(dim=1)


def serve_class_stats(features_fn: Callable, params: Tree, xs: torch.Tensor,
                      ys: torch.Tensor, num_classes: int, spec: LiteSpec,
                      mask: torch.Tensor, second_moment: bool = False,
                      backend: str | None = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Exact fused class statistics, forward-only (:func:`serve_sum`)."""
    return lite_class_stats(features_fn, params, xs, ys, num_classes, spec, mask,
                            None, second_moment=second_moment, backend=backend,
                            sum_fn=serve_sum)
