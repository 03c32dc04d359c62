"""The episodic meta-training step in the loop's ``(state, batch) ->
(state, metrics)`` form (the JAX package's ``repro/train/step.py``
episodic adapters), so meta-training inherits checkpoint, resume and
straggler handling.

``batch`` is ``dict(tasks=TaskBatch, key=(seed, step))``, with an optional
``scores`` (T, N) tensor; without it the step derives each task's H scores
from ``key``, the task's index and the example's index
(:func:`repro_torch.core.lite.index_scores`), so a batch is a pure function
of its step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.lite import index_scores
from repro_torch.kernels import dispatch
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedules import schedule_for

State = Dict[str, Any]


def make_episodic_init_state(learner, adamw_cfg: AdamWConfig) -> Callable:
    """``init_state(gen: torch.Generator, device) -> dict(params, opt)``."""
    def init_state(gen: torch.Generator, device) -> State:
        params = learner.init(gen, device)
        return dict(params=params, opt=adamw_init(params, adamw_cfg))

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
                             adamw_cfg: AdamWConfig = None) -> Callable:
    """``meta_cfg``: :class:`repro_torch.configs.base.MetaTrainConfig`
    (one device; it refuses the multi-device knobs).  A configured
    ``meta_cfg.schedule`` replaces the constant lr with one keyed on the
    optimizer's update count."""
    from repro_torch.core.episodic_train import make_batched_meta_train_step

    adamw_cfg = adamw_cfg or AdamWConfig(weight_decay=0.0)
    inner = make_batched_meta_train_step(
        learner, lite, adamw=adamw_cfg, lr=meta_cfg.lr,
        max_grad_norm=meta_cfg.max_grad_norm,
        schedule=schedule_for(meta_cfg.schedule, meta_cfg.lr,
                              meta_cfg.warmup_steps, meta_cfg.total_steps),
        accum_steps=meta_cfg.accum_steps,
        skip_nonfinite=meta_cfg.skip_nonfinite)

    def train_step(state: State, batch: Dict) -> Tuple[State, Dict]:
        # the configured kernel backend is bound here, for the whole step
        with dispatch.use_backend(meta_cfg.kernel_backend):
            params, opt, metrics = inner(state["params"], state["opt"],
                                         batch["tasks"], batch_scores(batch))
        return dict(params=params, opt=opt), metrics

    return train_step
