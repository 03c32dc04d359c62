"""The port's optimizer and task-batched meta-train step against the JAX
package's, on the same params, optimizer state
(``repro_torch.bridge.opt_state_from_numpy``), tasks and H subsets.

* AdamW (fp32 and bf16 state; int8 in test_torch_sampler_ckpt.py),
  global-norm clipping and the cosine and WSD
  schedules against the JAX functions on the same numpy inputs: TOL = 1e-6
  of each leaf's max|reference| (measured: AdamW params and state equal,
  clipping 1.0e-7).
* Three steps of ``make_episodic_train_step`` for ProtoNets (T = 2,
  ``accum_steps`` 1 on ``ref``; 2 on ``cuda`` against JAX ``pallas``, with
  a cosine schedule and weight decay) against the JAX package's: per-step
  loss within TOL_STEP = 1e-4 of the JAX loss and params within TOL_STEP
  of each leaf's max|reference| (measured at most 2.5e-7 and 9.7e-6).
  Simple CNAPs is held one step at a time (test_torch_train_learners.py):
  at these widths its loss grows from 22 to about 300 in three steps and
  the two frameworks' trajectories part by more than its end-to-end
  tolerance when XLA's thread count changes (5.5e-3 against 4e-3 of the
  loss on one core, 8.5e-4 on several).
* A non-finite gradient (a NaN batch, or a Cholesky that fails) leaves
  params and optimizer state bit-identical and reports ``nonfinite``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MetaTrainConfig as JMeta
from repro.core.episodic import Task as JTask
from repro.core.episodic_train import task_key
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import _index_scores
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.data.episodic import HostEpisodicConfig as JHost
from repro.data.episodic import collate_task_batch as j_collate
from repro.data.episodic import host_task_batch_at as j_host
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import schedules as j_sched
from repro.train.step import make_episodic_init_state as j_init_state
from repro.train.step import make_episodic_train_step as j_train_step
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.common.tree import tree_leaves, tree_paths
from repro_torch.configs.base import MetaTrainConfig
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim import schedules as t_sched
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.train.step import make_episodic_train_step

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-6
TOL_STEP = 1e-4
WIDTHS, FDIM, IMG, T, N = (8, 16), 32, 16, 2, 24


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _tree_err(t_tree, j_tree):
    """Max over leaves, paired by path, of the leaf error over the leaf's
    max|reference|; the JAX tree goes through the bridge (HWIO -> OIHW)."""
    jt = tree_paths(params_from_numpy(jax.tree.map(np.asarray, j_tree), device="cpu"))
    tt = tree_paths(t_tree)
    assert set(tt) == set(jt)
    return max(_rel(tt[k].float().numpy(), jt[k].float().numpy()) for k in tt)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return dict(conv=dict(w=f(3, 3, 2, 4), b=f(4)), head=[dict(w=f(4, 5), b=f(5))])


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype):
    jcfg = JAdamW(weight_decay=0.1, state_dtype=state_dtype)
    tcfg = AdamWConfig(weight_decay=0.1, state_dtype=state_dtype)
    jp = jax.tree.map(jnp.asarray, _np_tree(0))
    js = j_adamw_init(jp, jcfg)
    tp = params_from_numpy(_np_tree(0), device="cpu")
    ts = adamw_init(tp, tcfg)
    for step in range(3):
        g = _np_tree(10 + step, scale=0.1)
        jp, js = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), js, 3e-2, jcfg)
        tp, ts = adamw_update(tp, params_from_numpy(g, device="cpu"), ts, 3e-2, tcfg)
    assert _tree_err(tp, jp) <= TOL
    assert _tree_err(ts["mu"], js["mu"]) <= TOL and _tree_err(ts["nu"], js["nu"]) <= TOL
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["mu"]["conv"]["w"].dtype == getattr(torch, state_dtype)


def test_adamw_int8_state_is_refused():
    # the int8 state is ported (test_torch_sampler_ckpt.py holds it against
    # the JAX package's); a state dtype outside the policy is still refused
    assert AdamWConfig(state_dtype="int8").state_dtype == "int8"
    with pytest.raises(ValueError, match="state_dtype"):
        AdamWConfig(state_dtype="int4")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_jax(max_norm):
    g = _np_tree(3)
    jg, jn = j_clip(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = clip_by_global_norm(params_from_numpy(g, device="cpu"), max_norm)
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    assert _tree_err(tg, jg) <= TOL


def test_schedules_match_jax():
    steps = np.arange(0, 60)
    for name in ("cosine", "wsd"):
        jf = j_sched.schedule_for(name, 3e-4, 5, 50)
        tf = t_sched.schedule_for(name, 3e-4, 5, 50)
        want = np.array([float(jf(jnp.int32(s))) for s in steps])
        got = np.array([float(tf(torch.tensor(s, dtype=torch.int32))) for s in steps])
        assert _rel(got, want) <= TOL, name
    assert t_sched.schedule_for(None, 1.0, 1, 1) is None
    assert float(t_sched.linear_warmup(0, 4, 2.0)) == 0.5


def _learners(kind, cov_eps=1.0):
    set_kw = dict(conv_blocks=2, conv_width=8, task_dim=16)
    jl = j_make(JCfg(kind=kind, way=5), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(**set_kw))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=5, cov_eps=cov_eps),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)),
                      SetEncoderConfig(**set_kw))
    return jl, tl


def _batch_at(s):
    """Step s's two tasks from the host sampler, the second cut short and
    collated with padding: (JAX batch, port batch)."""
    hb = j_host(17, JHost(way=5, shot=4, query_per_class=3, image_size=IMG), T, s)
    cut = [(20, 15), (17 - s, 13)]
    jb = j_collate([JTask(hb.support_x[t][:n], hb.support_y[t][:n], hb.query_x[t][:m],
                          hb.query_y[t][:m], 5) for t, (n, m) in enumerate(cut)],
                   support_size=N, query_size=15)
    tb = TaskBatch(*(np.asarray(getattr(jb, k)) for k in (
        "support_x", "support_y", "query_x", "query_y", "support_mask",
        "query_mask")), way=5).to("cpu")
    return jb, tb


CASES = {
    # kind, port backend, JAX backend, accum, schedule, weight decay
    "protonets-ref-accum1": ("protonets", "ref", "ref", 1, None, 0.0),
    "protonets-cuda-accum2-cosine": ("protonets", "cuda", "pallas", 2, "cosine", 0.01),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_track_jax(case):
    kind, t_be, j_be, accum, schedule, wd = CASES[case]
    jl, tl = _learners(kind)
    lite = dict(h=6, chunk_size=4)
    meta = dict(tasks_per_step=T, accum_steps=accum, lr=1e-3, schedule=schedule,
                warmup_steps=1, total_steps=3)
    j_adamw, t_adamw = JAdamW(weight_decay=wd), AdamWConfig(weight_decay=wd)
    jstate = j_init_state(jl, j_adamw)(jax.random.key(0))
    tstate = dict(params=params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), "cpu"),
                  opt=opt_state_from_numpy(jax.tree.map(np.asarray, jstate["opt"]), "cpu"))
    jstep = jax.jit(j_train_step(jl, JLite(**lite), JMeta(**meta, kernel_backend=j_be), j_adamw))
    tstep = make_episodic_train_step(tl, LiteSpec(**lite),
                                     MetaTrainConfig(**meta, kernel_backend=t_be), t_adamw)
    for s in range(3):
        jb, tb = _batch_at(s)
        key = jax.random.fold_in(jax.random.key(23), s)
        scores = torch.from_numpy(np.array(jax.vmap(
            lambda i: _index_scores(task_key(key, i), N))(jnp.arange(T))))
        jstate, jm = jstep(jstate, dict(tasks=jb, key=key))
        tstate, tm = tstep(tstate, dict(tasks=tb, scores=scores))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_STEP * abs(float(jm["loss"]))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["nonfinite"]) == float(jm["nonfinite"]) == 0.0
        assert _tree_err(tstate["params"], jstate["params"]) <= TOL_STEP
    assert int(tstate["opt"]["count"]) == 3


def _snapshot(state):
    return [t.clone() for t in tree_leaves(state)]


@pytest.mark.parametrize("fault", ["nan_batch", "cholesky_fails"])
def test_nonfinite_step_is_skipped_bit_identically(fault):
    """A NaN batch (ProtoNets), or a Simple CNAPs covariance whose Cholesky
    fails (a negative ridge): NaN gradients, params and optimizer state
    untouched to the bit (count included), ``nonfinite`` 1."""
    kind = "protonets" if fault == "nan_batch" else "simple_cnaps"
    _, tl = _learners(kind, cov_eps=-1e3 if fault == "cholesky_fails" else 1.0)
    params = tl.init(torch.Generator().manual_seed(0), "cpu")
    state = dict(params=params, opt=adamw_init(params, AdamWConfig()))
    step = make_episodic_train_step(tl, LiteSpec(h=6, chunk_size=4),
                                    MetaTrainConfig(tasks_per_step=T), AdamWConfig())
    _, tb = _batch_at(0)
    if fault == "nan_batch":
        tb = dataclasses.replace(tb, support_x=torch.full_like(tb.support_x, float("nan")))
    before = _snapshot(state)
    new, metrics = step(state, dict(tasks=tb, key=(23, 0)))
    assert float(metrics["nonfinite"]) == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    after = tree_leaves(new)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    # and a finite batch on the same state steps
    if fault == "nan_batch":
        new, metrics = step(state, dict(tasks=_batch_at(0)[1], key=(23, 0)))
        assert float(metrics["nonfinite"]) == 0.0 and int(new["opt"]["count"]) == 1


def test_meta_train_config_checks():
    with pytest.raises(ValueError, match="divisible"):
        MetaTrainConfig(tasks_per_step=3, accum_steps=2)
    for kw in (dict(dp_shards=2), dict(dcn_shards=2),
               dict(dcn_shards=2, grad_reduce="compressed")):
        # data-parallel training is ported: the knobs construct
        cfg = MetaTrainConfig(tasks_per_step=4, **kw)
        assert (cfg.dp_shards, cfg.dcn_shards) == (kw.get("dp_shards", 1),
                                                   kw.get("dcn_shards", 1))
    with pytest.raises(ValueError, match="CROSS-HOST"):
        MetaTrainConfig(grad_reduce="compressed")
    with pytest.raises(ValueError, match="kernel_backend"):
        MetaTrainConfig(kernel_backend="pallas")
    with pytest.raises(ValueError, match="must be >= 1"):
        MetaTrainConfig(accum_steps=0)
    assert MetaTrainConfig().kernel_backend == "auto"


def test_query_batches_and_validators_match_jax():
    from repro.core.episodic import query_batches as j_query_batches
    from repro_torch.core.episodic import Task, query_batches, validate_task, \
        validate_task_batch
    jb, tb = _batch_at(1)
    for t in range(T):
        jt = jb.task(t)
        tt = Task(tb.support_x[t], tb.support_y[t], tb.query_x[t], tb.query_y[t], 5,
                  tb.support_mask[t], tb.query_mask[t])
        validate_task(tt)
        for got, want in zip(query_batches(tt, 4), j_query_batches(jt, 4)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    validate_task_batch(tb)
    with pytest.raises(ValueError, match="task-axis"):
        validate_task_batch(dataclasses.replace(tb, query_y=tb.query_y[:1]))
    with pytest.raises(ValueError, match="query len"):
        validate_task(Task(tb.support_x[0], tb.support_y[0], tb.query_x[0],
                           tb.query_y[0][:3], 5))
