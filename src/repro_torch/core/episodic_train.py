"""Meta-training steps on one device (the JAX package's
``repro/core/episodic_train.py``, its ``mesh is None`` branch).

The task-batched step: T tasks, one H draw each, the task-MEAN loss
differentiated by one backward, one clipped AdamW step.

    step = make_batched_meta_train_step(learner, lite)
    params, opt_state, metrics = step(params, opt_state, batch, scores)

Paper Algorithm 1's per-task step, with its query micro-batches: one task,
one H draw (``scores`` (N,)) shared by every micro-batch, the gradients of
the micro-batches summed by their real query counts, one AdamW step; and
the looped baseline that takes that step once per task.

    step = make_meta_train_step(learner, lite, query_batch=8)
    params, opt_state, metrics = step(params, opt_state, task, scores)

``batch`` is a :class:`repro_torch.core.episodic.TaskBatch` of tensors and
``scores`` (T, N) choose each task's H subset
(:func:`repro_torch.core.lite.index_scores`, or the JAX package's own in
the parity tests).  The step reads nothing back to the host: the metrics
are 0-dim tensors, and a non-finite gradient turns the update into a
``torch.where`` select of the old params and optimizer state.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_rebuild
from repro_torch.core.episodic import Task, TaskBatch, query_batches
from repro_torch.core.lite import LiteSpec, index_scores
from repro_torch.core.meta_learners import MetaLearner
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.clip import clip_by_global_norm

Tree = Any


def make_reached_meta_grads(learner: MetaLearner, lite: LiteSpec) -> Callable:
    """(params, batch, scores) -> (loss, accuracy, grads): the task-mean
    loss and accuracy and the gradient of that mean, taken by one backward
    through the shared parameters (peak gradient memory O(P)), as a list
    in ``tree_leaves`` order with None for a leaf the loss does not reach
    (the CNAPs backbone), which gets no gradient buffer."""

    def grads_fn(params: Tree, batch: TaskBatch, scores: torch.Tensor):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            losses, aux = learner.meta_loss(live, batch, scores, lite)
            loss = losses.mean()
            grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
        return loss.detach(), aux["accuracy"].mean().detach(), list(grads)

    return grads_fn


def make_batched_meta_grads(learner: MetaLearner, lite: LiteSpec) -> Callable:
    """(params, batch, scores) -> (loss, accuracy, grads) as
    :func:`make_reached_meta_grads`, the gradient a tree of ``params``'
    structure in which a leaf the loss does not reach gets zeros (the
    optimizer steps every leaf, as the JAX package's does)."""
    reached = make_reached_meta_grads(learner, lite)

    def grads_fn(params: Tree, batch: TaskBatch, scores: torch.Tensor):
        loss, acc, grads = reached(params, batch, scores)
        return loss, acc, tree_rebuild(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(tree_leaves(params), grads)])

    return grads_fn


def _tree_all_finite(tree: Tree) -> torch.Tensor:
    """0-dim bool tensor: every element of every leaf is finite (no host
    sync)."""
    return torch.stack([torch.isfinite(leaf).all() for leaf in tree_leaves(tree)]).all()


def _take_tasks(batch: TaskBatch, lo: int, hi: int) -> TaskBatch:
    return TaskBatch(*(getattr(batch, k)[lo:hi] for k in (
        "support_x", "support_y", "query_x", "query_y", "support_mask",
        "query_mask")), way=batch.way)


def _accumulated_grads(grads_fn: Callable, params: Tree, batch: TaskBatch,
                       scores: torch.Tensor, accum: int):
    """Mean loss, accuracy and grads over ``batch`` as ``accum`` sequential
    chunks of tasks, so peak activation memory is that of T/accum tasks.
    Each task keeps its own row of ``scores``, so the result does not
    depend on the chunking; ``accum=1`` calls ``grads_fn`` directly."""
    if accum <= 1:
        return grads_fn(params, batch, scores)
    per = batch.num_tasks // accum
    loss = acc = torch.zeros((), device=scores.device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(accum):
        lo, hi = i * per, (i + 1) * per
        l, a, g = grads_fn(params, _take_tasks(batch, lo, hi), scores[lo:hi])
        loss, acc = loss + l, acc + a
        grads = tree_map(torch.add, grads, g)
    scale = 1.0 / accum       # equal chunk sizes: mean of chunk means
    return loss * scale, acc * scale, tree_map(lambda g: g * scale, grads)


def make_batched_meta_train_step(learner: MetaLearner, lite: LiteSpec,
                                 adamw: AdamWConfig = AdamWConfig(weight_decay=0.0),
                                 lr: float = 1e-3,
                                 max_grad_norm: float = 10.0,
                                 schedule: Optional[Callable] = None,
                                 accum_steps: int = 1,
                                 skip_nonfinite: bool = True) -> Callable:
    """Task-batched meta-training step: T tasks -> ONE AdamW step.

        step(params, opt_state, batch, scores) -> (params, opt_state, metrics)

    ``schedule`` (update count -> lr) overrides the constant ``lr``; the
    metrics report the lr applied.  With ``skip_nonfinite`` a NaN/inf
    gradient element suppresses the update: params and optimizer state
    (``count`` included) come out bit-identical to the inputs and
    ``metrics['nonfinite']`` is 1.  Metrics are 0-dim device tensors."""
    grads_fn = make_batched_meta_grads(learner, lite)

    def step(params: Tree, opt_state: Dict, batch: TaskBatch,
             scores: torch.Tensor) -> Tuple[Tree, Dict, Dict]:
        if batch.num_tasks % accum_steps:
            raise ValueError(f"tasks_per_step={batch.num_tasks} not "
                             f"divisible by accum_steps={accum_steps}")
        loss, acc, grads = _accumulated_grads(grads_fn, params, batch, scores,
                                              accum_steps)
        ok = _tree_all_finite(grads) if skip_nonfinite else None
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr_t = lr if schedule is None else schedule(opt_state["count"])
        new_params, new_opt = adamw_update(params, grads, opt_state, lr_t, adamw)
        metrics = dict(loss=loss, accuracy=acc, grad_norm=gnorm,
                       lr=torch.as_tensor(lr_t, dtype=torch.float32))
        if ok is not None:
            # a quantized state's trailing dim ``n`` is a python int
            pick = lambda n, o: torch.where(ok, n, o) if torch.is_tensor(n) else n  # noqa: E731
            new_params = tree_map(pick, new_params, params)
            new_opt = tree_map(pick, new_opt, opt_state)
            metrics["nonfinite"] = (~ok).to(torch.float32)
        return new_params, new_opt, metrics

    return step


def _as_batch(task: Task, query_x, query_y, query_mask) -> TaskBatch:
    """``task``'s support set and the given queries as a batch of one."""
    sm = task.support_mask
    if sm is None:
        sm = torch.ones(task.support_y.shape, device=task.support_y.device)
    return TaskBatch(task.support_x[None], task.support_y[None], query_x[None],
                     query_y[None], sm[None], query_mask[None], way=task.way)


def make_meta_train_step(learner: MetaLearner, lite: LiteSpec,
                         query_batch: int = 0,
                         adamw: AdamWConfig = AdamWConfig(weight_decay=0.0),
                         lr: float = 1e-3,
                         max_grad_norm: float = 10.0) -> Callable:
    """Paper Algorithm 1's per-task step on a :class:`Task` of tensors:

        step(params, opt_state, task, scores) -> (params, opt_state, metrics)

    ``scores`` (N,) choose the task's H subset.  ``query_batch=0`` is one
    query pass; ``> 0`` splits the queries into padded, masked micro-batches
    (:func:`repro_torch.core.episodic.query_batches`), each a ``meta_loss``
    over the whole support set with the same scores, its loss and gradients
    weighted by its real query count, so the result equals the single
    pass and only one micro-batch's query activations are live."""
    grads_fn = make_batched_meta_grads(learner, lite)

    def step(params: Tree, opt_state: Dict, task: Task, scores: torch.Tensor
             ) -> Tuple[Tree, Dict, Dict]:
        scores = scores.reshape(1, -1)
        if query_batch > 0:
            qx, qy, qw = query_batches(task, query_batch)
            loss, grads = torch.zeros((), device=scores.device), None
            for b in range(qx.shape[0]):
                l, _, g = grads_fn(params, _as_batch(task, qx[b], qy[b], qw[b]), scores)
                wb = qw[b].sum()
                loss = loss + l * wb
                grads = tree_map(lambda x: x * wb, g) if grads is None else \
                    tree_map(lambda a, x: a + x * wb, grads, g)
            w_tot = torch.clamp(qw.sum(), min=1.0)
            loss, grads = loss / w_tot, tree_map(lambda a: a / w_tot, grads)
        else:
            qm = task.query_mask
            if qm is None:
                qm = torch.ones(task.query_y.shape, device=task.query_y.device)
            loss, _, grads = grads_fn(params, _as_batch(task, task.query_x, task.query_y,
                                                        qm), scores)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = adamw_update(params, grads, opt_state, lr, adamw)
        return params, opt_state, dict(loss=loss, grad_norm=gnorm)

    return step


def run_looped_baseline(learner: MetaLearner, lite: LiteSpec, params: Tree,
                        opt_state: Dict, tasks, key: Tuple[int, int],
                        adamw: AdamWConfig = AdamWConfig(weight_decay=0.0),
                        lr: float = 1e-3, max_grad_norm: float = 10.0,
                        scores=None):
    """Paper Algorithm 1 as written: one AdamW step per task, in a loop
    over ``tasks`` (:class:`Task` s of tensors); the baseline the batched
    step is measured against.  Task i draws its H subset from
    ``index_scores(*key, [i], N_i)``, the batched step's convention for
    task i of the step ``key``; ``scores`` (one (N_i,) row per task)
    replaces those draws.  Returns (params, opt_state, the last metrics)."""
    step = make_meta_train_step(learner, lite, adamw=adamw, lr=lr,
                                max_grad_norm=max_grad_norm)
    metrics = None
    for i, task in enumerate(tasks):
        s = scores[i] if scores is not None else index_scores(
            key[0], key[1], [i], task.support_y.shape[0], task.support_y.device)[0]
        params, opt_state, metrics = step(params, opt_state, task, s)
    return params, opt_state, metrics
