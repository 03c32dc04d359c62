"""The port's batched ``meta_loss`` against the JAX package's, on the same
ragged tasks (collated with padding), the same parameters
(repro_torch.bridge) and the same H subsets (the JAX package's own
``_index_scores(task_key(key, t), N)`` passed in as the port's scores):
the mean loss and accuracy over the T tasks and the gradient of that mean
(the JAX package's ``make_batched_meta_grads``), for ProtoNets, CNAPs and
Simple CNAPs.  Both port backends, ``ref`` and ``cuda`` on CPU tensors
(the kernels' plain forwards and the autograd Functions' backwards), are
held to one JAX ``ref`` result computed once per case; the Functions'
backwards are held to the JAX ``pallas`` backend op by op in
test_torch_train_autograd.py, and the Simple CNAPs head like path with
like path below.  Batched is compared with batched throughout (R2: the
JAX package's batched and solo Simple CNAPs differ).

Gradient tolerances are relative to each leaf's max|reference|, floored at
1e-5 of the largest |reference| gradient of any leaf: a leaf whose gradient
is zero by construction carries only rounding (CNAPs' ``head_gen/b2``: the
softmax's class sum cancels it, so its entries are 1e-5 against 1e4
elsewhere).

* ProtoNets and CNAPs: loss, accuracy and gradients within TOL = 1e-4
  (measured: loss 4.2e-6, gradients 1.2e-5, accuracy equal, on both
  backends; CNAPs' loss is 3.5e3 at these random weights).
* Simple CNAPs end to end: TOL_SIMPLE_CNAPS = 5e-2 on gradients and
  TOL_SIMPLE_CNAPS_LOSS = 4e-3 on the loss.  Measured 1.3e-2 (``ref``) and
  1.2e-2 (``cuda``) on gradients, 3.5e-4 on the loss.  The C1 gap
  (test_torch_learners.py: ~1e-7 differences of the two frameworks'
  convolutions, amplified by the E[xx^T] - mu mu^T cancellation over about
  four examples a class) grows through the Cholesky backward.  The JAX
  package's own equivalent paths differ as much on these inputs: its
  chunked and unchunked complement by 1.5e-2 in the gradients, its
  ``pallas`` and ``ref`` backends by 1.5e-2, ``naive`` and ``ref`` by
  5.1e-3.  Every leaf the reference trains must also get a gradient of the
  same sign.
* ``test_simple_cnaps_head_gradients_from_identical_features`` isolates
  the head: a stub backbone returns its input, both packages get the same
  numpy features, and the loss and the gradients with respect to the
  support and query features (statistics, ridge, Cholesky, Mahalanobis
  head and their backwards) agree within TOL_HEAD = 1e-4, port ``ref``
  with JAX ``ref`` and port ``cuda`` with JAX ``pallas`` (measured: loss
  equal, gradients at most 3.3e-5).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.episodic import Task as JTask
from repro.core.episodic_train import make_batched_meta_grads as j_meta_grads
from repro.core.episodic_train import task_key
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import _index_scores
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.data.episodic import HostEpisodicConfig as JHost
from repro.data.episodic import collate_task_batch as j_collate
from repro.data.episodic import host_task_batch_at as j_host
from repro.kernels import dispatch as jd
from repro.models.backbone import BackboneDef as JBackboneDef
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro_torch.bridge import params_from_numpy
from repro_torch.common.tree import tree_leaves
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import make_batched_meta_grads
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.kernels import dispatch as td
from repro_torch.models.backbone import BackboneDef
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-4
TOL_SIMPLE_CNAPS = 5e-2
TOL_SIMPLE_CNAPS_LOSS = 4e-3
TOL_HEAD = 1e-4
FLOOR = 1e-5
WIDTHS, FDIM, IMG, T = (8, 16), 32, 16, 2
LITE = dict(h=6, chunk_size=4)
T_BACKENDS = ["ref", "cuda"]
SET_KW = dict(conv_blocks=2, conv_width=8, task_dim=16)


def _learners(kind, jbb=None, tbb=None, set_kw=SET_KW):
    jl = j_make(JCfg(kind=kind, way=5), jbb or j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(**set_kw))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=5),
                      tbb or make_conv_backbone(ConvBackboneConfig(widths=WIDTHS,
                                                                   feature_dim=FDIM)),
                      SetEncoderConfig(**set_kw))
    return jl, tl


def _batches(images=None):
    """Two tasks of the host sampler (5-way, 4 shot, 3 queries a class),
    the second cut to 17 support and 13 query rows, collated to 24 and 15
    rows; ``images`` replaces the support and query inputs."""
    hb = j_host(17, JHost(way=5, shot=4, query_per_class=3, image_size=IMG), T, 0)
    sx, qx = (hb.support_x, hb.query_x) if images is None else images
    cut = [(20, 15), (17, 13)]
    jb = j_collate([JTask(sx[t][:n], hb.support_y[t][:n], qx[t][:m], hb.query_y[t][:m], 5)
                    for t, (n, m) in enumerate(cut)], support_size=24, query_size=15)
    tb = TaskBatch(*(np.asarray(getattr(jb, k)) for k in (
        "support_x", "support_y", "query_x", "query_y", "support_mask",
        "query_mask")), way=5).to("cpu")
    return jb, tb


def _scores(key, n):
    return torch.from_numpy(np.array(jax.vmap(
        lambda i: _index_scores(task_key(key, i), n))(jnp.arange(T))))


def _grad_errs(tg, jg):
    """Per-leaf errors, each over max(leaf's max|ref|, FLOOR * tree max)."""
    jl = [np.asarray(a) for a in tree_leaves(jg)]
    floor = FLOOR * max(np.abs(a).max() for a in jl)
    out = []
    for a, b in zip(tree_leaves(tg), jl):
        a = a.numpy()
        assert a.shape == b.shape
        out.append(np.abs(a - b).max() / max(np.abs(b).max(), floor))
    return out


@functools.lru_cache(maxsize=None)
def _jax_result(kind, lite_items, estimator):
    """The JAX package's mean loss, accuracy and gradients on its ``ref``
    backend (computed once per case: both port backends are held to it)."""
    jl, _ = _learners(kind)
    jp = jl.init(jax.random.key(0))
    jb, _ = _batches()
    key = jax.random.key(5)
    jspec = JLite(**dict(lite_items))
    if estimator is None:
        grads_fn = j_meta_grads(jl, jspec)
    else:
        def grads_fn(p, b, k):
            def loss(p):
                ls, accs = jax.vmap(lambda sx, sy, sm, qx, qy, qm, i: (lambda r: (
                    r[0], r[1]["accuracy"]))(jl.meta_loss(
                        p, JTask(sx, sy, qx, qy, 5, sm, qm), task_key(k, i), jspec,
                        estimator=estimator)))(
                    b.support_x, b.support_y, b.support_mask, b.query_x, b.query_y,
                    b.query_mask, jnp.arange(T))
                return jnp.mean(ls), jnp.mean(accs)
            (l, a), g = jax.value_and_grad(loss, has_aux=True)(p)
            return l, a, g
    with jd.use_backend("ref"):
        jloss, jacc, jgrad = jax.jit(grads_fn)(jp, jb, key)
    return (jp, float(jloss), float(jacc),
            params_from_numpy(jax.tree.map(np.asarray, jgrad), device="cpu"))


def _run_both(kind, t_backend, lite=LITE, estimator=None):
    jp, jloss, jacc, jgrad = _jax_result(kind, tuple(sorted(lite.items())), estimator)
    _, tl = _learners(kind)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _, tb = _batches()
    scores = _scores(jax.random.key(5), 24)
    with td.use_backend(t_backend):
        if estimator is None:
            tloss, tacc, tgrad = make_batched_meta_grads(tl, LiteSpec(**lite))(tp, tb, scores)
        else:
            for leaf in tree_leaves(tp):
                leaf.requires_grad_(True)
            losses, aux = tl.meta_loss(tp, tb, scores, LiteSpec(**lite), estimator=estimator)
            losses.mean().backward()
            tloss, tacc = losses.mean().detach(), aux["accuracy"].mean()
            tgrad = jax.tree.map(lambda a: a.grad if a.grad is not None
                                 else torch.zeros_like(a), tp)
    return jloss, jacc, jgrad, float(tloss), float(tacc), tgrad


@pytest.mark.parametrize("kind", ["protonets", "cnaps"])
@pytest.mark.parametrize("t_backend", T_BACKENDS)
def test_meta_loss_and_gradients_match(kind, t_backend):
    jloss, jacc, jgrad, tloss, tacc, tgrad = _run_both(kind, t_backend)
    assert abs(tloss - jloss) <= TOL * abs(jloss)
    assert tacc == pytest.approx(jacc, abs=1e-6)
    assert max(_grad_errs(tgrad, jgrad)) <= TOL
    if kind == "cnaps":
        # the frozen backbone gets no gradient in either package
        assert all(float(g.abs().max()) == 0.0 for g in tree_leaves(tgrad["bb"]))


@pytest.mark.parametrize("t_backend", T_BACKENDS)
def test_simple_cnaps_meta_loss_and_gradients_match(t_backend):
    jloss, jacc, jgrad, tloss, tacc, tgrad = _run_both("simple_cnaps", t_backend)
    assert abs(tloss - jloss) <= TOL_SIMPLE_CNAPS_LOSS * abs(jloss)
    errs = _grad_errs(tgrad, jgrad)
    assert max(errs) <= TOL_SIMPLE_CNAPS
    # every leaf the reference trains is trained here, with its sign
    for a, b in zip(tree_leaves(tgrad), tree_leaves(jgrad)):
        if float(b.abs().max()) > 0:
            assert float((a * b).sum()) > 0


@pytest.mark.parametrize("kind", ["protonets", "cnaps"])
def test_subsampled_estimator_matches(kind):
    """The paper's naive small-task baseline (estimator="subsampled").
    (Simple CNAPs is left out: the subset's second moments over the full
    class counts are indefinite here, and both packages' Cholesky factors
    come out NaN.)"""
    jloss, jacc, jgrad, tloss, tacc, tgrad = _run_both(kind, "ref", estimator="subsampled")
    assert abs(tloss - jloss) <= TOL * abs(jloss)
    assert tacc == pytest.approx(jacc, abs=1e-6)
    assert max(_grad_errs(tgrad, jgrad)) <= TOL


def _identity_features(p, x, film):
    return x.reshape(x.shape[0], -1)


def _head_learners():
    set_kw = dict(SET_KW, in_channels=2)
    return _learners("simple_cnaps",
                     JBackboneDef(lambda key: {}, _identity_features, FDIM, WIDTHS),
                     BackboneDef(lambda gen, device=None: {}, _identity_features, FDIM,
                                 WIDTHS), set_kw)


@functools.lru_cache(maxsize=None)
def _head_case(lite_items, j_backend):
    """Features (class means plus noise, as (4, 4, 2) "images") for the
    tasks of ``_batches``, and the JAX package's loss on ``j_backend`` and
    its gradients with respect to the support and query features."""
    rng = np.random.default_rng(2)
    hb = j_host(17, JHost(way=5, shot=4, query_per_class=3, image_size=IMG), T, 0)
    means = rng.standard_normal((T, 5, FDIM)).astype(np.float32)
    feat = lambda y: (np.take_along_axis(means, y[..., None].repeat(FDIM, -1), 1)
                      + rng.standard_normal(y.shape + (FDIM,)).astype(np.float32)
                      ).reshape(y.shape + (4, 4, 2))
    jb, tb = _batches((feat(hb.support_y), feat(hb.query_y)))
    jl, _ = _head_learners()
    jp = jl.init(jax.random.key(0))
    jspec = JLite(**dict(lite_items))

    def j_loss(sx, qx):
        b = dataclasses.replace(jb, support_x=sx, query_x=qx)
        return j_meta_grads(jl, jspec)(jp, b, jax.random.key(5))[0]
    with jd.use_backend(j_backend):
        jloss, (jgs, jgq) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
            jb.support_x, jb.query_x)
    return tb, jp, float(jloss), np.asarray(jgs), np.asarray(jgq)


@pytest.mark.parametrize("lite", [dict(exact=True), LITE])
@pytest.mark.parametrize("t_backend,j_backend", [("ref", "ref"), ("cuda", "pallas")])
def test_simple_cnaps_head_gradients_from_identical_features(t_backend, j_backend, lite):
    """Simple CNAPs on a stub backbone whose features are its input: the
    same numpy features go into both packages; the loss and its gradients
    with respect to the support and query features agree to TOL_HEAD, like
    path with like path (the explicit inverse against the explicit
    inverse)."""
    tb, jp, jloss, jgs, jgq = _head_case(tuple(sorted(lite.items())), j_backend)
    _, tl = _head_learners()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    sx = tb.support_x.clone().requires_grad_(True)
    qx = tb.query_x.clone().requires_grad_(True)
    with td.use_backend(t_backend):
        losses, _ = tl.meta_loss(tp, dataclasses.replace(tb, support_x=sx, query_x=qx),
                                 _scores(jax.random.key(5), 24), LiteSpec(**lite))
        losses.mean().backward()
    assert abs(float(losses.mean().detach()) - jloss) <= TOL_HEAD * abs(jloss)
    for got, want in ((sx.grad, jgs), (qx.grad, jgq)):
        assert np.abs(got.numpy() - want).max() <= TOL_HEAD * np.abs(want).max()
