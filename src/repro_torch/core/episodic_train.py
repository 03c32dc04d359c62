"""Meta-training steps (the JAX package's ``repro/core/episodic_train.py``).

The task-batched step: T tasks, one H draw each, the task-MEAN loss
differentiated by one backward, one clipped AdamW step; with a ``mesh``
(:mod:`repro_torch.launch.mesh`) the task axis is sharded over the ranks of
a 1-D ``data`` or a two-level ``(dcn, data)`` mesh, one process a rank.

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


def take_tasks(batch: TaskBatch, lo: int, hi: int) -> TaskBatch:
    """Tasks ``lo:hi`` of ``batch`` (views)."""
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
        l, a, g = grads_fn(params, take_tasks(batch, lo, hi), scores[lo:hi])
        loss, acc = loss + l, acc + a
        grads = tree_map(torch.add, grads, g)
    scale = 1.0 / accum       # equal chunk sizes: mean of chunk means
    return loss * scale, acc * scale, tree_map(lambda g: g * scale, grads)


def init_ef_state(params: Tree, dcn_shards: int) -> Tree:
    """Zero error-feedback residuals for ``grad_reduce='compressed'``: one
    fp32 residual a ``dcn`` row, leading axis ``dcn_shards`` (the JAX
    package's ``P('dcn')`` leaf, the layout a checkpoint holds).  It lives in
    ``opt_state['ef']``; each rank's step reads and returns only its own
    row."""
    return tree_map(lambda p: torch.zeros((dcn_shards,) + tuple(p.shape),
                                          dtype=torch.float32, device=p.device), params)


def _flat(loss, acc, leaves) -> torch.Tensor:
    """One fp32 buffer: loss, accuracy, then every gradient leaf."""
    return torch.cat([loss.reshape(1).float(), acc.reshape(1).float()]
                     + [g.reshape(-1).float() for g in leaves])


def _unflat(buf: torch.Tensor, template: Tree) -> Tree:
    out, at = [], 2
    for p in tree_leaves(template):
        out.append(buf[at:at + p.numel()].reshape(p.shape).to(p.dtype))
        at += p.numel()
    return tree_rebuild(template, out)


def make_batched_meta_train_step(learner: MetaLearner, lite: LiteSpec,
                                 adamw: AdamWConfig = AdamWConfig(weight_decay=0.0),
                                 lr: float = 1e-3,
                                 max_grad_norm: float = 10.0,
                                 schedule: Optional[Callable] = None,
                                 mesh=None, dp_axis: str = "data",
                                 dcn_axis: str = "dcn",
                                 grad_reduce: str = "pmean",
                                 accum_steps: int = 1,
                                 skip_nonfinite: bool = True) -> Callable:
    """Task-batched meta-training step: T tasks -> ONE AdamW step.

        step(params, opt_state, batch, scores) -> (params, opt_state, metrics)

    ``schedule`` (update count -> lr) overrides the constant ``lr``; the
    metrics report the lr applied.  With ``skip_nonfinite`` a NaN/inf
    gradient element suppresses the update: params and optimizer state
    (``count`` included) come out bit-identical to the inputs and
    ``metrics['nonfinite']`` is 1.  Metrics are 0-dim device tensors.

    With ``mesh`` (a :class:`repro_torch.launch.mesh.DPMesh`) every rank
    calls the step on the GLOBAL batch and (T, N) scores and keeps its
    T/(dp*dcn) tasks and their score rows (block ``mesh.rank`` of the task
    axis, so each task keeps the H subset it draws on one device).  Each
    rank sums its ``accum_steps`` chunks, then:

    1. loss, accuracy and the gradient, bucketed into one fp32 buffer, are
       summed over ``dp_axis`` and divided by its size (one collective);
    2. the finite verdict is read on that exact gradient, before any
       compression, and its MIN taken over ``dcn_axis`` as an int32, so
       every rank skips or applies together;
    3. over ``dcn_axis`` the buffer is summed and divided again
       (``grad_reduce='pmean'``), or loss and accuracy are and the gradient
       goes through :func:`repro_torch.optim.compress.compressed_all_reduce`
       and is divided by ``dcn`` (``'compressed'``; the residual is this
       rank's row of ``opt_state['ef']``, frozen on a skipped step);
    4. every rank applies the same clipped AdamW update.

    Every rank then holds bit-identical params, optimizer state and
    metrics; ``opt_state['ef']`` comes back as this rank's row, leading
    axis 1 (given the whole ``(dcn, ...)`` leaf of :func:`init_ef_state`
    or a checkpoint, the step takes its row).  At ``dcn`` 1 the two-level
    step is bit-identical to the 1-D one."""
    grads_fn = make_batched_meta_grads(learner, lite)

    def apply_update(params, opt_state, loss, acc, grads, ok):
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

    if grad_reduce not in ("pmean", "compressed"):
        raise ValueError(f"grad_reduce={grad_reduce!r} (want 'pmean' or "
                         f"'compressed')")
    sizes = {} if mesh is None else dict(mesh.shape)
    if mesh is not None and dp_axis not in sizes:
        raise ValueError(f"mesh axes {tuple(sizes)} lack dp_axis={dp_axis!r}")
    dp = sizes.get(dp_axis, 1)
    two_level = dcn_axis in sizes
    dcn = sizes.get(dcn_axis, 1)
    if grad_reduce == "compressed" and not two_level:
        raise ValueError(
            "grad_reduce='compressed' compresses the cross-node DCN "
            "reduction: it needs a two-level mesh "
            "(repro_torch.launch.mesh.make_two_level_dp_mesh) with a "
            f"{dcn_axis!r} axis")
    shards = dp * dcn
    compressed = grad_reduce == "compressed"

    if mesh is None:
        def step(params: Tree, opt_state: Dict, batch: TaskBatch,
                 scores: torch.Tensor) -> Tuple[Tree, Dict, Dict]:
            if batch.num_tasks % accum_steps:
                raise ValueError(f"tasks_per_step={batch.num_tasks} not "
                                 f"divisible by accum_steps={accum_steps}")
            loss, acc, grads = _accumulated_grads(grads_fn, params, batch, scores,
                                                  accum_steps)
            ok = _tree_all_finite(grads) if skip_nonfinite else None
            return apply_update(params, opt_state, loss, acc, grads, ok)

        return step

    from repro_torch.optim.compress import compressed_all_reduce

    def own_row(e: torch.Tensor) -> torch.Tensor:
        return e[mesh.coords[dcn_axis] if e.shape[0] == dcn else 0]

    def step(params: Tree, opt_state: Dict, batch: TaskBatch,
             scores: torch.Tensor) -> Tuple[Tree, Dict, Dict]:
        t = batch.num_tasks
        if t % (shards * accum_steps):
            raise ValueError(
                f"tasks_per_step={t} not divisible by dp_shards*dcn_shards*"
                f"accum_steps = {dp}*{dcn}*{accum_steps}")
        if compressed and "ef" not in opt_state:
            raise ValueError("grad_reduce='compressed' needs opt_state['ef'] — "
                             "initialize it with init_ef_state(params, dcn_shards)")
        per = t // shards
        # rank = dcn index * dp + data index: the JAX package's
        # P((dcn, data)) blocks of the task axis
        lo = mesh.rank * per
        loss, acc, grads = _accumulated_grads(
            grads_fn, params, take_tasks(batch, lo, lo + per), scores[lo:lo + per],
            accum_steps)
        buf = mesh.all_reduce(_flat(loss, acc, tree_leaves(grads)), dp_axis) / dp
        # the verdict on the exact fp32 gradient BEFORE any dcn compression
        # (int8-quantized NaN decodes to finite garbage); its MIN over dcn
        # makes every rank take the same branch
        ok = torch.isfinite(buf[2:]).all() if skip_nonfinite else None
        if two_level and ok is not None:
            ok = mesh.all_reduce(ok.to(torch.int32).reshape(1), dcn_axis, "min")[0] > 0
        if two_level and not compressed:
            buf = mesh.all_reduce(buf, dcn_axis) / dcn
        if not compressed:
            return apply_update(params, opt_state, buf[0], buf[1], _unflat(buf, params), ok)
        scalars = mesh.all_reduce(buf[:2].clone(), dcn_axis) / dcn
        ef = tree_map(own_row, opt_state["ef"])
        summed, new_ef = compressed_all_reduce(_unflat(buf, params), mesh, dcn_axis, ef)
        if ok is not None:
            new_ef = tree_map(lambda n, o: torch.where(ok, n, o), new_ef, ef)
        new_params, new_opt, metrics = apply_update(
            params, {k: v for k, v in opt_state.items() if k != "ef"}, scalars[0],
            scalars[1], tree_map(lambda g: g / dcn, summed), ok)
        return new_params, dict(new_opt, ef=tree_map(lambda e: e[None], new_ef)), metrics

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
