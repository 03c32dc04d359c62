"""First-order MAML and the FineTuner baseline of the port against the JAX
package's, on identical weights (repro_torch.bridge) and identical ragged
tasks (collated with padding):

* the task-mean ``meta_loss``, accuracy and gradients
  (``make_batched_meta_grads``): loss within TOL = 1e-4 relative, each
  gradient leaf within TOL of its max|reference| (measured: loss 0 and
  1.4e-6, gradients 2.3e-6 and 4.0e-6, FOMAML and FineTuner);
* batched adaptation and prediction (``adapt_batch`` / ``predict_batch``)
  in fp32 and, for FineTuner, with the int8 frozen backbone (the same int8
  bits on both sides; the head through the int8 matmul's plain version):
  logits within TOL of max|logit| (measured 2.5e-7; 4.4e-6 and 1.3e-6);
* serving through ``EpisodicServeEngine`` against the JAX engine on the
  same requests: logits within TOL of max|logit|, the same predictions
  and counters.

No H draws: neither learner has an aggregation site (``scores`` and the
LiteSpec are unused).  Neither learner calls a kernel but B4 (FineTuner's
int8 head), so one port backend (``ref``) suffices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.episodic import Task as JTask
from repro.core.episodic_train import make_batched_meta_grads as j_meta_grads
from repro.core.lite import LiteSpec as JLite
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.data.episodic import HostEpisodicConfig as JHost
from repro.data.episodic import collate_task_batch as j_collate
from repro.data.episodic import host_task_batch_at as j_host
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.serve.episodic import EpisodicRequest as JRequest
from repro.serve.episodic import EpisodicServeEngine as JEngine
from repro.serve.quant_params import dequantize_params as j_deq
from repro.serve.quant_params import quantize_frozen as j_qf
from repro_torch.bridge import params_from_numpy
from repro_torch.common.tree import tree_leaves
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import make_batched_meta_grads
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import KINDS, MetaLearnerConfig, make_learner
from repro_torch.launch import serve as t_launch
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
from repro_torch.serve.quant_params import FROZEN_SLICES

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-4
WIDTHS, FDIM, IMG, T = (8, 16), 32, 16, 2


def _learners(kind):
    jl = j_make(JCfg(kind=kind, way=5), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=5),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)))
    return jl, tl


def _batch():
    """Two host-sampler tasks (5-way, 4 shot, 3 queries a class), the second
    cut to 17 support and 13 query rows, collated to 24 and 15 rows."""
    hb = j_host(17, JHost(way=5, shot=4, query_per_class=3, image_size=IMG), T, 0)
    cut = [(20, 15), (17, 13)]
    jb = j_collate([JTask(hb.support_x[t][:n], hb.support_y[t][:n], hb.query_x[t][:m],
                          hb.query_y[t][:m], 5) for t, (n, m) in enumerate(cut)],
                   support_size=24, query_size=15)
    tb = TaskBatch(*(np.asarray(getattr(jb, k)) for k in (
        "support_x", "support_y", "query_x", "query_y", "support_mask",
        "query_mask")), way=5).to("cpu")
    return jb, tb


def _leaf_errs(tg, jg):
    jl = params_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(tree_leaves(tg), tree_leaves(jl))]


def test_every_kind_is_built():
    assert set(KINDS) == {"protonets", "cnaps", "simple_cnaps", "fomaml", "finetuner"}
    for kind in ("fomaml", "finetuner"):
        assert make_learner(MetaLearnerConfig(kind=kind), make_conv_backbone(
            ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM))).cfg.inner_steps == 5
    assert FROZEN_SLICES["finetuner"] == ("bb",) and FROZEN_SLICES["fomaml"] == ()
    with pytest.raises(ValueError, match="unknown meta-learner kind"):
        make_learner(MetaLearnerConfig(kind="maml"), None)


@pytest.mark.parametrize("kind", ["fomaml", "finetuner"])
def test_meta_loss_and_gradients_match(kind):
    jl, tl = _learners(kind)
    jp = jl.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb = _batch()
    jloss, jacc, jgrad = jax.jit(j_meta_grads(jl, JLite(h=6)))(jp, jb, jax.random.key(5))
    tloss, tacc, tgrad = make_batched_meta_grads(tl, LiteSpec(h=6))(
        tp, tb, torch.zeros(T, 24))
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    assert float(tacc) == pytest.approx(float(jacc), abs=1e-6)
    errs = _leaf_errs(tgrad, jgrad)
    assert max(errs) <= TOL
    # every leaf trains (FineTuner: the backbone, through the queries)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tgrad))


@pytest.mark.parametrize("kind,quant", [("fomaml", "none"), ("finetuner", "none"),
                                        ("finetuner", "int8")])
def test_adapt_predict_match(kind, quant):
    jl, tl = _learners(kind)
    jp = j_deq(j_qf(jl, jl.init(jax.random.key(0)), quant))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if quant == "int8":
        assert tp["bb"]["head"]["w"]["q"].dtype == torch.int8
    jb, tb = _batch()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.arange(T))
    js = jl.adapt_batch(jp, jb, keys, JLite(exact=True))
    jlog = np.asarray(jl.predict_batch(jp, js, jb.query_x))
    ts = tl.adapt_batch(tp, tb, LiteSpec(exact=True))
    tlog = tl.predict_batch(tp, ts, tb.query_x).numpy()
    assert tlog.shape == jlog.shape == (T, 15, 5)
    assert np.abs(tlog - jlog).max() <= TOL * np.abs(jlog).max()
    assert all(not t.requires_grad for t in tree_leaves(ts))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


@pytest.mark.parametrize("kind,quant", [("fomaml", "none"), ("finetuner", "int8")])
def test_engine_matches_jax_engine(kind, quant):
    jl, tl = _learners(kind)
    jp = jl.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cold, warm = t_launch.build_requests(5, 0.4, 3, 4, IMG, seed=5)
    kw = dict(n_slots=2, query_chunk=8, support_buckets=(16,), serve_quant=quant)
    je = JEngine(jl, jp, lite=JLite(exact=True, chunk_size=8), kernel_backend="ref",
                 clock=_Clock(), **kw)
    te = EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8),
                             kernel_backend="ref", clock=_Clock(), device="cpu", **kw)
    def copy(cls, rs):
        return [cls(uid=r.uid, support_x=r.support_x, support_y=r.support_y,
                    query_x=r.query_x, way=5) for r in rs]

    jc, jw, tc, tw = copy(JRequest, cold), copy(JRequest, warm), \
        copy(EpisodicRequest, cold), copy(EpisodicRequest, warm)
    for rj, rt in ((jc, tc), (jw, tw)):
        je.run_to_completion(rj)
        te.run_to_completion(rt)
    for rj, rt in zip(jc + jw, tc + tw):
        assert rt.done and rt.cache_hit == rj.cache_hit
        lj, lt = rj.all_logits(), rt.all_logits()
        assert lt.shape == lj.shape == (rj.n_queries, 5)
        assert np.abs(lt - lj).max() <= TOL * np.abs(lj).max()
        np.testing.assert_array_equal(rt.predictions(), rj.predictions())
    sj, st = je.stats(), te.stats()
    for k in ("tasks_adapted", "queries_served", "cache_hits", "hit_rate",
              "param_bytes_resident", "frozen_param_bytes_resident"):
        assert st[k] == sj[k], k
