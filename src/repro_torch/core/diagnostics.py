"""Gradient-estimator diagnostics: the paper's Sec. 5.3 / Fig. 4 harness
(the JAX package's ``repro/core/diagnostics.py``).

For fixed params and a fixed task:

* the exact gradient ``g*``: ``meta_loss`` under ``LiteSpec(exact=True)``;
* the LITE gradient with |H| = h (paper Eq. 8);
* the subsampled gradient: forward and backward on h examples only
  (Fig. 4's small-task baseline, ``estimator="subsampled"``).

Over ``n_draws`` H draws per h it reports the bias MSE,
``||mean_draws(g) - g*||^2 / dim`` (Table D.7), and the RMSE,
``mean_draws ||g - g*|| / sqrt(dim)`` (Fig. 4, Table D.8).

The draws are score rows, not PRNG keys: ``draw_scores(d)`` gives draw
d's (T, N) scores, the same for every h and both estimators, as the JAX
package reuses one key sequence; by default a hash of (seed, d, task,
example) (:func:`repro_torch.core.lite.index_scores`).  The parity tests
pass the JAX package's own draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_rebuild
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.lite import LiteSpec, index_scores


def _flat(tree) -> np.ndarray:
    return np.concatenate([x.detach().double().cpu().reshape(-1).numpy()
                           for x in tree_leaves(tree)])


def _grads(meta_loss: Callable, params, batch: TaskBatch, scores, spec: LiteSpec,
           estimator: Optional[str]):
    """Gradient of the task-mean loss; zero for a leaf the loss misses."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        losses, _ = meta_loss(live, batch, scores, spec, estimator=estimator)
        grads = torch.autograd.grad(losses.mean(), leaves, allow_unused=True)
    return tree_rebuild(params, [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(leaves, grads)])


def gradient_experiment(meta_loss: Callable, params, batch: TaskBatch,
                        h_values: Sequence[int], n_draws: int,
                        draw_scores: Optional[Callable[[int], torch.Tensor]] = None,
                        seed: int = 0, subsampled: bool = False,
                        param_filter: Optional[Callable] = None) -> Dict:
    """``meta_loss(params, batch, scores, lite, estimator=None) -> (losses,
    aux)``, a learner's.  ``param_filter`` picks the subtree to measure
    (Fig. 4: Simple CNAPs' first set-encoder conv, ``lambda p:
    p["enc"]["blocks"][0]["w"]``).  ``subsampled`` adds the subsampled
    estimator.

    Returns ``{"exact_norm": float, "lite": {h: {bias_mse, rmse}},
    "subsampled": {h: {...}}}``."""
    param_filter = param_filter or (lambda t: t)
    if draw_scores is None:
        t, n = batch.support_y.shape
        draw_scores = lambda d: index_scores(seed, d, range(t), n,  # noqa: E731
                                             batch.support_y.device)
    scores = [draw_scores(d) for d in range(n_draws)]
    exact = _flat(param_filter(_grads(meta_loss, params, batch, scores[0],
                                      LiteSpec(h=0, exact=True), None)))
    out = {"exact_norm": float(np.linalg.norm(exact)), "lite": {}, "subsampled": {}}
    for mode in ("lite", "subsampled") if subsampled else ("lite",):
        for h in h_values:
            draws = np.stack([_flat(param_filter(_grads(
                meta_loss, params, batch, s, LiteSpec(h=h),
                "subsampled" if mode == "subsampled" else None))) for s in scores])
            out[mode][h] = dict(
                bias_mse=float(np.mean((draws.mean(0) - exact) ** 2)),
                rmse=float(np.mean(np.sqrt(np.mean((draws - exact) ** 2, axis=1)))))
    return out
