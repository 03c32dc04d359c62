"""Paper Algorithm 1's per-task step, the looped baseline and the Fig. 4
gradient experiment of the port against the JAX package's, on the same
tasks, parameters (repro_torch.bridge) and H draws (the JAX package's own
``_index_scores`` passed in as the port's scores).

* ``make_meta_train_step`` for ProtoNets at ``query_batch`` 0, 5 and 8 on
  one task of 20 queries (the setup of tests/test_meta_learners.py's
  ``test_algorithm1_query_microbatching``): loss and the params after the
  step within TOL = 1e-4 of the JAX step's (each leaf over its
  max|reference|), and every query batching within TOL of the port's
  single pass.
* Batched gradients equal the mean of per-task gradients with the same
  draws (tests/test_task_batch.py's ``test_batched_grads_equal_mean_of_looped``),
  and ``run_looped_baseline`` over three tasks lands within TOL of the
  JAX package's.
* ``gradient_experiment`` with the JAX package's draws, lite and
  subsampled: ``exact_norm`` within 1e-4 relative for ProtoNets (at h 5
  and 20) and 5e-2 for Simple CNAPs, ``rmse`` and ``bias_mse`` within
  1e-3 and 5e-2 (the C1 tolerance of test_torch_train_learners.py).
  Simple CNAPs is measured on the first set-encoder conv (Fig. 4), on both
  port backends, with 8 features and h 20 and 30.  With 32 features and
  10 shots a class its class covariances are rank-deficient and the
  numbers move under fp32 rounding alone: perturbing the port's own
  inputs by 1e-7 relative moved its ``exact_norm`` by 4e-3 to 7e-3, its
  ``rmse`` by up to 4 % and its ``bias_mse`` by up to 23 %, and the JAX
  package's moved as much with XLA's thread count (``rmse`` 1.6e-2 from
  the port on several threads, 3.9e-2 on one).  At 8 features the same
  perturbation moves them by at most 1.6e-2, and the port reads at most
  5.3e-3 from the JAX package.  At h 5 the subsampled estimator keeps one
  example a class and its statistics move by up to 90 % under the
  perturbation, so Simple CNAPs is not held there.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.diagnostics import gradient_experiment as j_gradient_experiment
from repro.core.episodic import Task as JTask
from repro.core.episodic_train import make_meta_train_step as j_step
from repro.core.episodic_train import run_looped_baseline as j_looped
from repro.core.episodic_train import task_key
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import _index_scores
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.data.episodic import EpisodicImageConfig as JImgCfg
from repro.data.episodic import sample_image_task as j_sample
from repro.kernels import dispatch as jd
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro_torch.bridge import params_from_numpy
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.core.diagnostics import gradient_experiment
from repro_torch.core.episodic import Task, TaskBatch
from repro_torch.core.episodic_train import (make_batched_meta_grads,
                                             make_meta_train_step,
                                             run_looped_baseline)
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.kernels import dispatch as td
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim.adamw import AdamWConfig, adamw_init

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-4
TOL_FIG4 = {"protonets": 1e-3, "simple_cnaps": 5e-2}
H_FIG4 = {"protonets": (5, 20), "simple_cnaps": (20, 30)}
FDIM_FIG4 = {"protonets": 32, "simple_cnaps": 8}
WIDTHS, FDIM = (8, 16), 32
SET_KW = dict(conv_blocks=2, conv_width=8, task_dim=16)
TASK_CFG = JImgCfg(way=5, shot=10, query_per_class=4, image_size=16)
ADAMW = dict(weight_decay=0.0)


def _learners(kind, fdim=FDIM):
    jl = j_make(JCfg(kind=kind, way=5), j_bb(JBBCfg(widths=WIDTHS, feature_dim=fdim)),
                JSetCfg(**SET_KW))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=5),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=fdim)),
                      SetEncoderConfig(**SET_KW))
    jp = jl.init(jax.random.key(0))
    return jl, tl, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _task(jt):
    """A JAX task as the port's Task of CPU tensors."""
    return Task(_t(jt.support_x), _t(jt.support_y, torch.int64), _t(jt.query_x),
                _t(jt.query_y, torch.int64), way=jt.way)


def _scores(key, n):
    return torch.from_numpy(np.array(_index_scores(key, n)))


def _tree_err(t_tree, j_tree):
    jt = tree_paths(params_from_numpy(jax.tree.map(np.asarray, j_tree), device="cpu"))
    tt = tree_paths(t_tree)
    assert set(tt) == set(jt)
    return max(float((tt[k] - jt[k]).abs().max() / jt[k].abs().max().clamp_min(1e-30))
               for k in tt)


def _port_step(tl, tp, task, scores, qb):
    cfg = AdamWConfig(**ADAMW)
    return make_meta_train_step(tl, LiteSpec(h=10), query_batch=qb, adamw=cfg)(
        tp, adamw_init(tp, cfg), task, scores)


@pytest.mark.parametrize("query_batch", [0, 5, 8])
def test_per_task_step_matches_jax(query_batch):
    jl, tl, jp, tp = _learners("protonets")
    jt = j_sample(jax.random.key(4), TASK_CFG)             # 20 queries
    k = jax.random.key(9)
    jcfg = JAdamW(**ADAMW)
    jp1, _, jm = jax.jit(j_step(jl, JLite(h=10), query_batch=query_batch, adamw=jcfg))(
        jp, j_adamw_init(jp, jcfg), jt, k)
    task, scores = _task(jt), _scores(k, 50)
    tp1, topt, tm = _port_step(tl, tp, task, scores, query_batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert _tree_err(tp1, jp1) <= TOL
    assert int(topt["count"]) == 1
    if query_batch:      # Algorithm 1's micro-batches give the single pass
        tp0, _, tm0 = _port_step(tl, tp, task, scores, 0)
        assert abs(float(tm["loss"]) - float(tm0["loss"])) <= TOL * abs(float(tm0["loss"]))
        errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(tree_leaves(tp1), tree_leaves(tp0))]
        assert max(errs) <= TOL


def _tasks(n):
    return [j_sample(jax.random.fold_in(jax.random.key(11), i), TASK_CFG) for i in range(n)]


def test_batched_grads_equal_mean_of_looped():
    _, tl, _, tp = _learners("protonets")
    tasks = [_task(jt) for jt in _tasks(4)]
    spec = LiteSpec(h=10)
    scores = torch.stack([_scores(task_key(jax.random.key(9), i), 50) for i in range(4)])
    batch = TaskBatch(*(torch.stack([getattr(t, f) for t in tasks]) for f in (
        "support_x", "support_y", "query_x", "query_y")),
        support_mask=torch.ones(4, 50), query_mask=torch.ones(4, 20), way=5)
    grads_fn = make_batched_meta_grads(tl, spec)
    loss_b, _, g_b = grads_fn(tp, batch, scores)
    solo = [grads_fn(tp, TaskBatch(*(a[i:i + 1] for a in (
        batch.support_x, batch.support_y, batch.query_x, batch.query_y,
        batch.support_mask, batch.query_mask)), way=5), scores[i:i + 1])
        for i in range(4)]
    assert abs(float(loss_b) - np.mean([float(s[0]) for s in solo])) <= 1e-5 * abs(float(loss_b))
    g_mean = tree_map(lambda *gs: torch.stack(gs).mean(0), *[s[2] for s in solo])
    for a, b in zip(tree_leaves(g_b), tree_leaves(g_mean)):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max())
    # the same tasks as one batch, one task at a time
    assert batch.task(2).support_x.shape == tasks[2].support_x.shape


def test_looped_baseline_matches_jax():
    jl, tl, jp, tp = _learners("protonets")
    jts = _tasks(3)
    k = jax.random.key(9)
    jcfg, tcfg = JAdamW(**ADAMW), AdamWConfig(**ADAMW)
    jp3, _, jm = j_looped(jl, JLite(h=10), jp, j_adamw_init(jp, jcfg), jts, k, adamw=jcfg)
    scores = [_scores(task_key(k, i), 50) for i in range(3)]
    tp3, topt, tm = run_looped_baseline(tl, LiteSpec(h=10), tp, adamw_init(tp, tcfg),
                                        [_task(t) for t in jts], (0, 0), adamw=tcfg,
                                        scores=scores)
    assert int(topt["count"]) == 3
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert _tree_err(tp3, jp3) <= TOL
    # its own draws: the batched step's (seed, step, task) convention, finite
    tp3b, _, tmb = run_looped_baseline(tl, LiteSpec(h=10), tp, adamw_init(tp, tcfg),
                                       [_task(t) for t in jts], (0, 0), adamw=tcfg)
    assert np.isfinite(float(tmb["loss"]))


def _jax_draws(key, n, n_draws):
    """The per-draw scores the JAX experiment uses: ``_index_scores`` of
    each key of its split chain."""
    out, k = [], key
    for _ in range(n_draws):
        k, sub = jax.random.split(k)
        out.append(_scores(sub, n)[None])
    return out


N_DRAWS = 4


def _first_conv(kind):
    return (lambda p: p["enc"]["blocks"][0]["w"]) if kind == "simple_cnaps" else None


@functools.lru_cache(maxsize=None)
def _jax_fig4(kind):
    """The JAX experiment, once per kind (both port backends are held to
    it)."""
    jl, _, jp, _ = _learners(kind, FDIM_FIG4[kind])
    with jd.use_backend("ref"):
        return j_gradient_experiment(jl.meta_loss, jp, j_sample(jax.random.key(4), TASK_CFG),
                                     H_FIG4[kind], N_DRAWS, jax.random.key(21),
                                     subsampled_estimator=True,
                                     param_filter=_first_conv(kind))


@pytest.mark.parametrize("kind,t_backend", [("protonets", "ref"),
                                            ("simple_cnaps", "ref"),
                                            ("simple_cnaps", "cuda")])
def test_gradient_experiment_matches_jax(kind, t_backend):
    _, tl, _, tp = _learners(kind, FDIM_FIG4[kind])
    jt = j_sample(jax.random.key(4), TASK_CFG)
    k = jax.random.key(21)
    h_values, n_draws = H_FIG4[kind], N_DRAWS
    want = _jax_fig4(kind)
    task = _task(jt)
    batch = TaskBatch(task.support_x[None], task.support_y[None], task.query_x[None],
                      task.query_y[None], torch.ones(1, 50), torch.ones(1, 20), way=5)
    draws = _jax_draws(k, 50, n_draws)
    with td.use_backend(t_backend):
        got = gradient_experiment(tl.meta_loss, tp, batch, h_values, n_draws,
                                  draw_scores=lambda d: draws[d], subsampled=True,
                                  param_filter=_first_conv(kind))
    tol_norm = 1e-4 if kind == "protonets" else TOL_FIG4[kind]
    assert abs(got["exact_norm"] - want["exact_norm"]) <= tol_norm * want["exact_norm"]
    tol = TOL_FIG4[kind]
    for mode in ("lite", "subsampled"):
        for h in h_values:
            for metric in ("rmse", "bias_mse"):
                w, g = want[mode][h][metric], got[mode][h][metric]
                assert abs(g - w) <= tol * abs(w), (mode, h, metric, g, w)
