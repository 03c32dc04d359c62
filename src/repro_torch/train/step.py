"""Training steps in the loop's ``(state, batch) -> (state, metrics)``
form (the JAX package's ``repro/train/step.py``): LM training of the model
zoo (``make_init_state``, ``make_train_step``, ``make_eval_step``), and
the episodic meta-training adapters, so both inherit checkpoint, resume
and straggler handling.

The LM step's ``batch`` is ``dict(tokens=(B, S) int64)`` on the params'
device (:func:`repro_torch.data.tokens.batch_to_device`).  The LM step
updates the state it is given in place (:func:`repro_torch.optim.adamw.
adamw_update_`), as the JAX loop's jitted step updates its donated
buffers: a caller that needs the old state copies it first.

The episodic step's ``batch`` is ``dict(tasks=TaskBatch, key=(seed,
step))``, with an optional ``scores`` (T, N) tensor; without it the step
derives each task's H scores from ``key``, the task's index and the
example's index (:func:`repro_torch.core.lite.index_scores`), so a batch
is a pure function of its step.  It returns a new state.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_rebuild
from repro_torch.configs.base import ModelConfig
from repro_torch.core.episodic_train import _tree_all_finite
from repro_torch.core.lite import index_scores
from repro_torch.kernels import dispatch
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update_
from repro_torch.optim.clip import clip_scale
from repro_torch.optim.schedules import cosine_schedule, schedule_for

State = Dict[str, Any]


def make_init_state(cfg: ModelConfig, adamw_cfg: AdamWConfig) -> Callable:
    """``init_state(gen: torch.Generator, device) -> dict(params, opt)``:
    the model's params drawn on ``gen`` (see ``api.init``), floating leaves
    in ``cfg.param_dtype`` (each cast as it is drawn), and a zero AdamW
    state."""
    api = get_api(cfg)

    def init_state(gen: torch.Generator, device=None) -> State:
        params = api.init(gen, cfg, device, at_param_dtype=True)
        return dict(params=params, opt=adamw_init(params, adamw_cfg))

    return init_state


def make_train_step(cfg: ModelConfig, adamw_cfg: AdamWConfig,
                    schedule: Callable | None = None,
                    max_grad_norm: float = 1.0,
                    skip_nonfinite: bool = True) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient (attention on the current kernel backend,
    :func:`repro_torch.kernels.dispatch.use_backend`; ``auto`` by default),
    the global-norm clip at ``max_grad_norm``, the lr of ``schedule`` at
    the update count (default: cosine, peak 3e-4, warmup 2000, total
    100000) and AdamW.

    The step consumes ``state``: params and optimizer state are updated in
    place and the same dict is returned, each gradient freed once its leaf
    is updated, so the peak is params, grads and state once each.
    ``skip_nonfinite`` (default on): a NaN/inf gradient leaves params and
    state bit-identical and ``metrics['nonfinite']`` is 1.  Metrics
    (``loss``, ``grad_norm``, ``lr``, ``nll``, ``aux``, ``nonfinite``) are
    0-dim device tensors."""
    api = get_api(cfg)
    if schedule is None:
        schedule = functools.partial(cosine_schedule, peak=3e-4, warmup_steps=2000,
                                     total_steps=100000)

    def train_step(state: State, batch: Dict) -> Tuple[State, Dict]:
        leaves = tree_leaves(state["params"])
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = api.loss(tree_rebuild(state["params"], live), batch, cfg,
                                     backend=None)
            grads = list(torch.autograd.grad(loss, live))
        del live
        ok = _tree_all_finite(grads) if skip_nonfinite else None
        scale, gnorm = clip_scale(grads, max_grad_norm)
        lr = schedule(state["opt"]["count"])
        adamw_update_(state["params"], grads, state["opt"], lr, adamw_cfg, grad_scale=scale,
                      ok=ok)
        out = dict(loss=loss.detach(), grad_norm=gnorm, lr=lr,
                   **{k: v.detach() for k, v in metrics.items()})
        if ok is not None:
            out["nonfinite"] = (~ok).to(torch.float32)
        return state, out

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``eval_step(params, batch) -> dict(loss, nll, aux)``, without grad."""
    api = get_api(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = api.loss(params, batch, cfg, backend=None)
        return dict(loss=loss, **metrics)

    return eval_step


def make_episodic_init_state(learner, adamw_cfg: AdamWConfig, meta_cfg=None) -> Callable:
    """``init_state(gen: torch.Generator, device) -> dict(params, opt)``.
    A ``meta_cfg`` with ``grad_reduce='compressed'`` adds the error-feedback
    residual of every ``dcn`` row to the optimizer state (``opt['ef']``,
    :func:`repro_torch.core.episodic_train.init_ef_state`), so checkpoints
    carry it and compressed restarts stay exact."""
    from repro_torch.core.episodic_train import init_ef_state

    def init_state(gen: torch.Generator, device) -> State:
        params = learner.init(gen, device)
        opt = adamw_init(params, adamw_cfg)
        if meta_cfg is not None and meta_cfg.grad_reduce == "compressed":
            opt["ef"] = init_ef_state(params, meta_cfg.dcn_shards)
        return dict(params=params, opt=opt)

    return init_state


def batch_scores(batch: Dict) -> torch.Tensor:
    """The batch's (T, N) H scores: given, or derived from its key."""
    if batch.get("scores") is not None:
        return batch["scores"]
    tasks = batch["tasks"]
    seed, step = batch["key"]
    t, n = tasks.support_y.shape
    return index_scores(seed, step, range(t), n, tasks.support_y.device)


def make_episodic_train_step(learner, lite, meta_cfg,
                             adamw_cfg: AdamWConfig = None, mesh=None,
                             dp_axis: str = "data", dcn_axis: str = "dcn") -> Callable:
    """``meta_cfg``: :class:`repro_torch.configs.base.MetaTrainConfig`
    (``tasks_per_step`` is the data side's concern; ``dp_shards > 1``,
    ``dcn_shards > 1`` or ``compressed`` need ``mesh``, a 1-D
    :func:`repro_torch.launch.mesh.make_dp_mesh` or a two-level
    ``make_two_level_dp_mesh``, and every rank passes the global batch).  A
    configured ``meta_cfg.schedule`` replaces the constant lr with one
    keyed on the optimizer's update count."""
    from repro_torch.core.episodic_train import make_batched_meta_train_step

    adamw_cfg = adamw_cfg or AdamWConfig(weight_decay=0.0)
    needs_mesh = meta_cfg.dp_shards > 1 or meta_cfg.dcn_shards > 1 \
        or meta_cfg.grad_reduce == "compressed"
    if needs_mesh and mesh is None:
        raise ValueError(f"dp_shards={meta_cfg.dp_shards} / "
                         f"dcn_shards={meta_cfg.dcn_shards} / "
                         f"grad_reduce={meta_cfg.grad_reduce!r} requires a "
                         f"mesh (repro_torch.launch.mesh.make_dp_mesh or "
                         f"make_two_level_dp_mesh)")
    inner = make_batched_meta_train_step(
        learner, lite, adamw=adamw_cfg, lr=meta_cfg.lr,
        max_grad_norm=meta_cfg.max_grad_norm,
        schedule=schedule_for(meta_cfg.schedule, meta_cfg.lr,
                              meta_cfg.warmup_steps, meta_cfg.total_steps),
        mesh=mesh, dp_axis=dp_axis, dcn_axis=dcn_axis,
        grad_reduce=meta_cfg.grad_reduce, accum_steps=meta_cfg.accum_steps,
        skip_nonfinite=meta_cfg.skip_nonfinite)

    def train_step(state: State, batch: Dict) -> Tuple[State, Dict]:
        # the configured kernel backend is bound here, for the whole step
        with dispatch.use_backend(meta_cfg.kernel_backend):
            params, opt, metrics = inner(state["params"], state["opt"],
                                         batch["tasks"], batch_scores(batch))
        return dict(params=params, opt=opt), metrics

    return train_step


def adamw_for(cfg: ModelConfig) -> AdamWConfig:
    return AdamWConfig(state_dtype=cfg.opt_state_dtype)
