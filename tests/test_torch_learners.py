"""The port's batched adaptation and prediction against the JAX package, on
identical weights (repro_torch.bridge) and identical tasks, like path
against like path:

* port ``ref`` against JAX ``ref`` (both Cholesky solves);
* port ``cuda`` on CPU tensors (the kernels' plain versions, with the
  explicit inverse ``sinv``) against JAX ``pallas`` in interpret mode;

for ProtoNets, CNAPs and Simple CNAPs, with fp32 and int8 frozen weights
(the same int8 bits on both sides).

Tolerances, relative to max|value|:

* class sums, second moments, prototypes, mu, CNAPs heads and logits:
  1e-5 (fp32 sums in different orders; measured <= 1.1e-6);
* Simple CNAPs ``chol`` and logits: 4e-3.  Measured 7.2e-4 (chol) and
  2.0e-3 (logits) at feature width 64.  The covariance is E[xx^T] - mu mu^T
  over about 6 examples a class, whose cancellation amplifies the ~1e-7
  differences of the two frameworks' features.  The JAX package's own
  equivalent paths differ as much on the same inputs (naive against ref
  backend: 6.2e-4 in logits; chunked against unchunked: 9.7e-4).  Argmax
  must agree wherever the top-2 margin exceeds the tolerance.

``test_simple_cnaps_head_from_identical_features`` isolates that gap: both
packages' Simple CNAPs adaptation and head run on a stub backbone whose
features are its input, fed the same numpy features (the JAX backbone's own,
under the JAX-adapted FiLM).  There ``chol`` and logits agree to
TOL_HEAD = 1e-5 relative (measured 5.0e-6 and 6.1e-6), so the head's
formulas are the same and the 4e-3 above comes from the features.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.episodic import Task as JTask
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import lite_class_stats, serve_sum
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.data.episodic import collate_task_batch as j_collate
from repro.kernels import dispatch as jd
from repro.models.backbone import BackboneDef as JBackboneDef
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.serve.quant_params import dequantize_params as j_deq
from repro.serve.quant_params import quantize_frozen as j_qf
from repro_torch.bridge import params_from_numpy
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.lite import LiteSpec, serve_class_stats
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.kernels import dispatch as td
from repro_torch.models.backbone import BackboneDef
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
TOL_SIMPLE_CNAPS = 4e-3
TOL_HEAD = 1e-5
WIDTHS, FDIM, IMG, T = (8, 16), 64, 16, 3
BACKENDS = [("ref", "ref"), ("cuda", "pallas")]      # (port, JAX)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _learners(kind):
    jl = j_make(JCfg(kind=kind, way=5), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(conv_blocks=2, conv_width=8, task_dim=16))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=5),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)),
                      SetEncoderConfig(conv_blocks=2, conv_width=8, task_dim=16))
    return jl, tl


def _tasks(seed=0):
    """T ragged tasks (17..30 support rows) collated to 32, and queries."""
    rng = np.random.default_rng(seed)
    tasks = []
    for n in (23, 30, 17)[:T]:
        sx = rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32)
        sy = np.concatenate([np.arange(5), rng.integers(0, 5, n - 5)]).astype(np.int32)
        tasks.append(JTask(sx, sy, np.zeros((1, IMG, IMG, 3), np.float32),
                           np.zeros((1,), np.int32), 5))
    jb = j_collate(tasks, support_size=32, query_size=1)
    tb = TaskBatch(*(np.asarray(getattr(jb, k)) for k in (
        "support_x", "support_y", "query_x", "query_y", "support_mask",
        "query_mask")), way=5).to("cpu")
    qx = rng.standard_normal((T, 9, IMG, IMG, 3)).astype(np.float32)
    return jb, tb, qx


def _run_both(kind, quant, t_backend, j_backend):
    jl, tl = _learners(kind)
    jp = j_deq(j_qf(jl, jl.init(jax.random.key(0)), quant))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb, qx = _tasks()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.arange(T))
    with jd.use_backend(j_backend):
        js = jl.adapt_batch(jp, jb, keys, JLite(exact=True, chunk_size=8))
        jlog = np.asarray(jl.predict_batch(jp, js, jnp.asarray(qx)))
    with td.use_backend(t_backend):
        ts = tl.adapt_batch(tp, tb, LiteSpec(exact=True, chunk_size=8))
        tlog = tl.predict_batch(tp, ts, torch.from_numpy(qx)).numpy()
    return js, ts, jlog, tlog


def _argmax_agrees_where_confident(jlog, tlog, tol):
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    confident = (top2[..., 1] - top2[..., 0]) > tol * np.abs(jlog).max()
    assert confident.any()
    np.testing.assert_array_equal(jlog.argmax(-1)[confident],
                                  tlog.argmax(-1)[confident])


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("t_backend,j_backend", BACKENDS)
def test_protonets_adapt_predict_match(quant, t_backend, j_backend):
    js, ts, jlog, tlog = _run_both("protonets", quant, t_backend, j_backend)
    assert _rel(ts.numpy(), js) <= TOL
    assert _rel(tlog, jlog) <= TOL
    _argmax_agrees_where_confident(jlog, tlog, TOL)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("t_backend,j_backend", BACKENDS)
def test_cnaps_adapt_predict_match(quant, t_backend, j_backend):
    js, ts, jlog, tlog = _run_both("cnaps", quant, t_backend, j_backend)
    for k in ("mu", "w", "b"):
        assert _rel(ts[k].numpy(), js[k]) <= TOL, k
    for jf, tf in zip(js["film"], ts["film"]):
        assert _rel(tf["gamma"].numpy(), jf["gamma"]) <= TOL
    assert _rel(tlog, jlog) <= TOL


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("t_backend,j_backend", BACKENDS)
def test_simple_cnaps_adapt_predict_match(quant, t_backend, j_backend):
    js, ts, jlog, tlog = _run_both("simple_cnaps", quant, t_backend, j_backend)
    assert _rel(ts["mu"].numpy(), js["mu"]) <= TOL
    assert _rel(ts["chol"].numpy(), js["chol"]) <= TOL_SIMPLE_CNAPS
    # the explicit inverse exists exactly when the kernel backend is in force
    assert ("sinv" in ts) == ("sinv" in js) == (t_backend == "cuda")
    assert np.isfinite(tlog).all()
    assert _rel(tlog, jlog) <= TOL_SIMPLE_CNAPS
    _argmax_agrees_where_confident(jlog, tlog, TOL_SIMPLE_CNAPS)


def _identity_features(p, x, film):
    return x.reshape(x.shape[0], -1)


@pytest.mark.parametrize("t_backend,j_backend", BACKENDS)
def test_simple_cnaps_head_from_identical_features(t_backend, j_backend):
    """Simple CNAPs statistics, ridge, Cholesky and Mahalanobis head of both
    packages on identical features: a stub backbone returns its input, and
    both get the features that the JAX backbone computes for ``_tasks()``
    under the JAX-adapted FiLM, as (4, 4, 4) "images"."""
    jl, _ = _learners("simple_cnaps")
    jp = jl.init(jax.random.key(0))
    jb, _, qx = _tasks()
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.arange(T))
    film = jl.adapt_batch(jp, jb, keys, JLite(exact=True, chunk_size=8))["film"]
    feats = lambda x, i: np.asarray(jl.backbone.features(
        jp["bb"], x, jax.tree.map(lambda a: a[i], film))).reshape(-1, 4, 4, 4)
    sx = np.stack([feats(jb.support_x[i], i) for i in range(T)])
    qf = np.stack([feats(qx[i], i) for i in range(T)])

    set_kw = dict(conv_blocks=2, conv_width=8, task_dim=16, in_channels=4)
    jl = j_make(JCfg(kind="simple_cnaps", way=5),
                JBackboneDef(lambda key: {}, _identity_features, FDIM, WIDTHS),
                JSetCfg(**set_kw))
    tl = make_learner(MetaLearnerConfig(kind="simple_cnaps", way=5),
                      BackboneDef(lambda gen, device=None: {}, _identity_features,
                                  FDIM, WIDTHS),
                      SetEncoderConfig(**set_kw))
    jp = jl.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jb = dataclasses.replace(jb, support_x=jnp.asarray(sx))
    tb = TaskBatch(sx, *(np.asarray(getattr(jb, k)) for k in (
        "support_y", "query_x", "query_y", "support_mask", "query_mask")),
        way=5).to("cpu")
    with jd.use_backend(j_backend):
        js = jl.adapt_batch(jp, jb, keys, JLite(exact=True, chunk_size=8))
        jlog = np.asarray(jl.predict_batch(jp, js, jnp.asarray(qf)))
    with td.use_backend(t_backend):
        ts = tl.adapt_batch(tp, tb, LiteSpec(exact=True, chunk_size=8))
        tlog = tl.predict_batch(tp, ts, torch.from_numpy(qf)).numpy()
    assert _rel(ts["mu"].numpy(), js["mu"]) <= TOL_HEAD
    assert _rel(ts["chol"].numpy(), js["chol"]) <= TOL_HEAD
    assert _rel(tlog, jlog) <= TOL_HEAD


@pytest.mark.parametrize("t_backend,j_backend", BACKENDS)
def test_class_stats_sums_and_second_moments_match(t_backend, j_backend):
    """The kernels' statistics (per-class sums, raw second moments) of one
    task's support set, chunked, with padded rows: 1e-5."""
    jl, tl = _learners("protonets")
    jp = jl.init(jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb, _ = _tasks(seed=3)
    feats = lambda p, x: jl.backbone.features(p, x, None)
    for i in range(T):
        with jd.use_backend(j_backend):
            js, jc = lite_class_stats(feats, jp["bb"], jb.support_x[i], jb.support_y[i],
                                      5, None, JLite(exact=True, chunk_size=8),
                                      mask=jb.support_mask[i], second_moment=True,
                                      sum_fn=serve_sum)
        ts, tc = serve_class_stats(
            lambda p, x: tl.backbone.features(p, x, None), tp["bb"],
            tb.support_x[i:i + 1], tb.support_y[i:i + 1], 5,
            LiteSpec(exact=True, chunk_size=8), tb.support_mask[i:i + 1],
            second_moment=True, backend=t_backend)
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
        assert _rel(ts["feat"][0].numpy(), js["feat"]) <= TOL
        assert _rel(ts["outer"][0].numpy(), js["outer"]) <= TOL


def test_naive_and_ref_second_moment_agree():
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.standard_normal((2, 19, 12)).astype(np.float32))
    w = torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 19))])
    a = td.class_second_moment(f, w, backend="naive")
    b = td.class_second_moment(f, w, backend="ref")
    c = td.class_second_moment(f, w, backend="cuda")    # plain version on CPU
    assert _rel(b.numpy(), a.numpy()) <= TOL and _rel(c.numpy(), a.numpy()) <= TOL


def test_bf16_compute_dtype_adapts_close_to_fp32():
    """LiteSpec.compute_dtype: bf16 chunk compute with fp32 accumulation
    gives fp32 class statistics within bf16 rounding of the fp32 run."""
    _, tl = _learners("protonets")
    tp = tl.init(torch.Generator().manual_seed(0), "cpu")
    _, tb, _ = _tasks()
    full = tl.adapt_batch(tp, tb, LiteSpec(exact=True, chunk_size=8))
    low = tl.adapt_batch(tp, tb, LiteSpec(exact=True, chunk_size=8,
                                          compute_dtype="bfloat16"))
    assert low.dtype == torch.float32
    assert _rel(low.numpy(), full.numpy()) <= 3e-2
