"""Meta-learners + LITE: ProtoNets, CNAPs, Simple CNAPs, first-order MAML
and the FineTuner transfer baseline (paper Sec. 3.1 and 5).

Every learner speaks two task-batched, mask-aware contracts:

    losses, aux = learner.meta_loss(params, batch, scores, lite)   # (T,) each
    states = learner.adapt_batch(params, task_batch, lite)         # leaves (T, ...)
    logits = learner.predict_batch(params, states, query_x)        # (T, M, way)

``batch`` / ``task_batch`` is a :class:`repro_torch.core.episodic.TaskBatch`
of tensors: its examples are whatever the backbone takes, NHWC images or
(for an LM backbone, :mod:`repro_torch.models.lm_backbone`) int64 token
ids.  The task-lane axis T is a batch dimension written out (the JAX
package vmaps per-task functions).  ``meta_loss`` is the training loss: the
LITE estimators (:mod:`repro_torch.core.lite`) at every support-set
aggregation site, their H subsets chosen by ``scores`` (T, N), one draw a
task shared by every site; it returns per-task losses and accuracies, and
the caller differentiates their mean.  ``estimator="subsampled"`` is the
paper's naive small-task baseline.  Adaptation runs the forward-only serve
estimators under ``torch.inference_mode`` and draws no random numbers;
fomaml and finetuner take gradients inside adaptation (their inner SGD),
so theirs runs outside it, on detached leaves under ``torch.enable_grad``.

The class statistics and the Simple CNAPs Mahalanobis head go through
:mod:`repro_torch.kernels.dispatch`, whose ``cuda`` ops carry their own
autograd.  Anything task-adapted that feeds the support encoder (the
CNAPs FiLM parameters) enters the estimators as a *param*, beside the
detached backbone (``_film_as_params``), so the no-grad complement cannot
leak gradient through a closure.

fomaml writes the task-lane axis out as a loop: each lane's inner loop
adapts its own copy of every weight, backbone included, so the lanes
share no convolution.  finetuner's lanes share the frozen backbone, so
its heads (T, F, way) train together: one backward of the lanes' summed
losses gives each head its own gradient.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.init import lecun_normal
from repro_torch.common.linear import matmul
from repro_torch.common.tree import (tree_detach, tree_leaves, tree_map,
                                     tree_rebuild)
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.film import generate_film_params, init_film_generator
from repro_torch.core.lite import (LiteSpec, _flat_encode, _masked_onehot,
                                   _masked_scale, _take_rows, lite_class_stats,
                                   lite_segment_sum, lite_sum,
                                   sample_stratified_indices, serve_class_stats,
                                   serve_segment_sum, serve_sum,
                                   subsampled_task_sum)
from repro_torch.core.set_encoder import (SetEncoderConfig, encode_set,
                                          init_set_encoder)
from repro_torch.kernels import dispatch
from repro_torch.models.backbone import BackboneDef

Tree = Any
KINDS = ("protonets", "cnaps", "simple_cnaps", "fomaml", "finetuner")


@dataclasses.dataclass(frozen=True)
class MetaLearnerConfig:
    kind: str = "protonets"      # one of KINDS
    way: int = 5
    gen_hidden: int = 64
    head_hidden: int = 64
    inner_lr: float = 0.01       # fomaml / finetuner inner SGD
    inner_steps: int = 5
    cov_eps: float = 1.0         # simple-cnaps covariance ridge
    film_init_std: float = 0.1


@dataclasses.dataclass(frozen=True)
class MetaLearner:
    cfg: MetaLearnerConfig
    backbone: BackboneDef
    init: Callable[..., Tree]            # (torch.Generator, device) -> params
    meta_loss: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    adapt_batch: Callable[..., Tree]
    predict_batch: Callable[[Tree, Tree, torch.Tensor], torch.Tensor]


def _batched_api(adapt: Callable, predict: Callable,
                 inner_grad: bool = False):
    """Wrap the serving bodies in ``inference_mode``: serving never builds
    an autograd graph outside an inner loop.  ``inner_grad`` adapt bodies
    (fomaml, finetuner) differentiate their own inner loop, which an
    inference tensor cannot enter, so they run as they are."""
    def adapt_batch(params, batch: TaskBatch,
                    lite: LiteSpec = LiteSpec(exact=True)):
        args = (params, batch.support_x, batch.support_y, batch.support_mask, lite)
        if inner_grad:
            return adapt(*args)
        with torch.inference_mode():
            return adapt(*args)

    def predict_batch(params, states, qx):
        with torch.inference_mode():
            return predict(params, states, qx)

    return adapt_batch, predict_batch


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          w: torch.Tensor) -> torch.Tensor:
    """(T,) cross-entropy: each task's weighted mean over its real rows,
    so collator padding (support label -1, weight 0) never moves the loss."""
    ll = torch.log_softmax(logits, dim=-1).gather(
        -1, labels.clamp(min=0)[..., None])[..., 0]
    w = w.to(ll.dtype)
    return -torch.sum(ll * w, dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    hit = (logits.argmax(dim=-1) == labels).to(torch.float32)
    return torch.sum(hit * w, dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def _loss_and_metrics(logits: torch.Tensor, batch: TaskBatch):
    return (_xent(logits, batch.query_y, batch.query_mask),
            dict(accuracy=_accuracy(logits, batch.query_y, batch.query_mask)))


def _features_by_task(bb: BackboneDef, bb_params, x: torch.Tensor, film):
    """(T, M, ...) examples (NHWC images, or token ids for an LM backbone)
    -> (T, M, F) float32 features."""
    t, m = x.shape[:2]
    qf = bb.features(bb_params, x.flatten(0, 1), film)
    return qf.float().unflatten(0, (t, m))


# naive small-task estimators (the paper's Fig. 4 baseline), with the call
# shape of the LITE ones
def _sub_seg(encode_fn, params, xs, ys, num_classes: int, spec: LiteSpec,
             mask: torch.Tensor, scores: Optional[torch.Tensor]):
    """Class-stratified subsampling (at least one example a class, paper
    App. D.4, so class statistics stay finite); forward AND backward see
    only the subset, scaled by N/H.  Returns (sums, exact counts)."""
    t, n = ys.shape
    h = spec.resolved_h(n)
    if spec.exact or h >= n:
        idx = torch.arange(n, device=ys.device).expand(t, n)
        scale = torch.ones(t, device=ys.device)
    else:
        idx = sample_stratified_indices(scores, ys, num_classes, h, mask)
        scale = _masked_scale(mask, h)
    onehot_h = _masked_onehot(ys.gather(1, idx), num_classes, mask.gather(1, idx))
    enc = _flat_encode(encode_fn, params, _take_rows(xs, idx))
    sums = tree_map(lambda e: scale.reshape((-1,) + (1,) * (e.dim() - 1))
                    * torch.einsum("tb...,tbc->tc...", e.float(), onehot_h), enc)
    return sums, _masked_onehot(ys, num_classes, mask).sum(dim=1)


# ===========================================================================
# ProtoNets: metric head over class prototypes, all backbone params learned
# ===========================================================================

def make_protonets(cfg: MetaLearnerConfig, bb: BackboneDef) -> MetaLearner:
    def init(gen, device=None):
        return dict(bb=bb.init(gen, device))

    def encode(p, x):
        return bb.features(p, x, None)

    def _prototypes(params, sx, sy, mask, lite, seg):
        sums, counts = seg(encode, params["bb"], sx, sy, cfg.way, lite, mask)
        return sums / torch.clamp(counts, min=1.0)[..., None]   # (T, C, F)

    def _logits(params, protos, qx):
        qf = _features_by_task(bb, params["bb"], qx, None)       # (T, M, F)
        return -torch.sum((qf[:, :, None, :] - protos[:, None, :, :]) ** 2,
                          dim=-1)

    def meta_loss(params, batch: TaskBatch, scores, lite: LiteSpec,
                  estimator=None):
        seg = _sub_seg if estimator == "subsampled" else lite_segment_sum
        protos = _prototypes(params, batch.support_x, batch.support_y,
                             batch.support_mask, lite,
                             functools.partial(seg, scores=scores))
        return _loss_and_metrics(_logits(params, protos, batch.query_x), batch)

    def adapt(params, sx, sy, mask, lite):
        return _prototypes(params, sx, sy, mask, lite, serve_segment_sum)

    return MetaLearner(cfg, bb, init, meta_loss, *_batched_api(adapt, _logits))


# ===========================================================================
# CNAPs / Simple CNAPs: frozen backbone + per-task FiLM
# ===========================================================================

def _film_as_params(bb_params, film):
    """(detached backbone params, live FiLM tensors): the pytree the LITE
    estimators treat as their params, so the complement pass stops the
    gradient through FiLM as Eq. 8 requires."""
    return (tree_detach(bb_params), film)


def _make_cnaps_family(cfg: MetaLearnerConfig, bb: BackboneDef,
                       set_cfg: SetEncoderConfig, simple: bool) -> MetaLearner:
    fdim = bb.feature_dim

    def init(gen, device=None):
        p = dict(bb=bb.init(gen, device),
                 enc=init_set_encoder(gen, set_cfg, device),
                 film_gen=init_film_generator(gen, set_cfg.task_dim,
                                              bb.film_sites, cfg.gen_hidden,
                                              out_std=cfg.film_init_std,
                                              device=device))
        if not simple:   # CNAPs: classifier-weight generator MLP
            p["head_gen"] = dict(
                w1=lecun_normal(gen, (fdim, cfg.head_hidden), fdim, device),
                b1=torch.zeros(cfg.head_hidden, device=device),
                w2=lecun_normal(gen, (cfg.head_hidden, fdim + 1),
                                cfg.head_hidden, device),
                b2=torch.zeros(fdim + 1, device=device))
        return p

    def _features(pf, x):
        bbp, film = pf
        return bb.features(bbp, x, film)

    def _class_stats(pf, sx, sy, mask, lite, mode, scores):
        """Per-class feature sums (+ raw second moments for Simple CNAPs)
        through the dispatch-fused estimators; ``subsampled`` is the naive
        baseline, which keeps the literal outer-product composite (its
        forward sees only the H subset)."""
        if mode == "subsampled":
            def encode(p, x):
                feat = _features(p, x)
                if simple:
                    return dict(feat=feat,
                                outer=torch.einsum("bi,bj->bij", feat, feat))
                return dict(feat=feat)
            return _sub_seg(encode, pf, sx, sy, cfg.way, lite, mask, scores)
        if mode == "serve":
            return serve_class_stats(_features, pf, sx, sy, cfg.way, lite, mask,
                                     second_moment=simple)
        return lite_class_stats(_features, pf, sx, sy, cfg.way, lite, mask, scores,
                                second_moment=simple)

    def _configure(params, sx, sy, mask, lite, mode, scores=None):
        """Support set -> task state (FiLM and head statistics), by
        ``mode``: ``lite`` (training), ``subsampled`` (the naive baseline)
        or ``serve`` (forward-only adaptation)."""
        sum_est = dict(lite=functools.partial(lite_sum, scores=scores),
                       subsampled=functools.partial(subsampled_task_sum,
                                                    scores=scores),
                       serve=serve_sum)[mode]
        # task embedding: mean-pooled set encodings over real examples
        n = torch.clamp(mask.sum(dim=1), min=1.0)                   # (T,)
        z_sum = sum_est(lambda p, x: encode_set(p, x, set_cfg), params["enc"],
                        sx, lite, mask)
        film = generate_film_params(params["film_gen"], z_sum / n[:, None])
        sums, counts = _class_stats(_film_as_params(params["bb"], film), sx, sy,
                                    mask, lite, mode, scores)
        k_c = torch.clamp(counts, min=1.0)                          # (T, C)
        mu = sums["feat"] / k_c[..., None]                          # (T, C, F)
        state = dict(film=film, mu=mu)
        if simple:
            # Sigma_c = l_c S_c + (1 - l_c) S_task + eps I, l_c = k/(k+1)
            ex2 = sums["outer"] / k_c[..., None, None]
            cov_c = ex2 - torch.einsum("tci,tcj->tcij", mu, mu)
            n_tot = torch.clamp(counts.sum(dim=-1), min=1.0)        # (T,)
            mu_t = sums["feat"].sum(dim=1) / n_tot[:, None]
            ex2_t = sums["outer"].sum(dim=1) / n_tot[:, None, None]
            cov_t = ex2_t - torch.einsum("ti,tj->tij", mu_t, mu_t)
            lam = (k_c / (k_c + 1.0))[..., None, None]
            sigma = lam * cov_c + (1.0 - lam) * cov_t[:, None]
            # scale-aware ridge: cov_eps plus a fraction of the mean diagonal,
            # so fp32 cancellation in E[xx^T] - mu mu^T cannot push
            # eigenvalues below the jitter (Cholesky would fail)
            diag_mean = torch.diagonal(sigma, dim1=-2, dim2=-1).mean(dim=-1)
            eps = cfg.cov_eps + 1e-3 * torch.clamp(diag_mean, min=0.0)
            eye = torch.eye(fdim, dtype=sigma.dtype, device=sigma.device)
            sigma = sigma + eps[..., None, None] * eye
            # cholesky_ex: no host sync on an error check.  A failed
            # factorisation becomes NaN, as in the JAX package, which the
            # train step's non-finite check turns into a skipped step
            chol, info = torch.linalg.cholesky_ex(sigma)
            state["chol"] = torch.where((info == 0)[..., None, None], chol,
                                        float("nan"))
            if dispatch.resolve_backend(None, sigma.device) == "cuda":
                # the Mahalanobis kernel takes the explicit inverse: compute
                # it once here so every query dispatch skips the solves
                state["sinv"] = dispatch.chol_inverse(state["chol"])
        else:
            hg = params["head_gen"]
            h = torch.relu(matmul(mu, hg["w1"]) + hg["b1"])
            wb = matmul(h, hg["w2"]) + hg["b2"]
            state["w"] = wb[..., :fdim]                             # (T, C, F)
            state["b"] = wb[..., fdim]                              # (T, C)
        return state

    def _logits(params, state, qx):
        qf = _features_by_task(bb, tree_detach(params["bb"]), qx, state["film"])
        if simple:
            return -dispatch.mahalanobis_head(qf, state["mu"], state["chol"],
                                              sinv=state.get("sinv"))
        return torch.einsum("tmf,tcf->tmc", qf, state["w"]) + \
            state["b"][:, None, :]

    def meta_loss(params, batch: TaskBatch, scores, lite: LiteSpec,
                  estimator=None):
        mode = "subsampled" if estimator == "subsampled" else "lite"
        state = _configure(params, batch.support_x, batch.support_y,
                           batch.support_mask, lite, mode, scores)
        return _loss_and_metrics(_logits(params, state, batch.query_x), batch)

    def adapt(params, sx, sy, mask, lite):
        return _configure(params, sx, sy, mask, lite, "serve")

    return MetaLearner(cfg, bb, init, meta_loss, *_batched_api(adapt, _logits))


# ===========================================================================
# First-order MAML (paper baseline; no aggregation site, so no LITE)
# ===========================================================================

def make_fomaml(cfg: MetaLearnerConfig, bb: BackboneDef) -> MetaLearner:
    fdim = bb.feature_dim

    def init(gen, device=None):
        return dict(bb=bb.init(gen, device),
                    head=dict(w=lecun_normal(gen, (fdim, cfg.way), fdim, device),
                              b=torch.zeros(cfg.way, device=device)))

    def _logits_p(p, x):
        """(B, ...) examples -> (B, way) under one lane's weights ``p``."""
        return matmul(bb.features(p["bb"], x, None).float(), p["head"]["w"]) + p["head"]["b"]

    def _inner_adapt(params, sx, sy, sw):
        """One task's ``inner_steps`` SGD steps on its support loss, from
        detached ``params``; returns the adapted weights, detached."""
        p = tree_detach(params)
        with torch.enable_grad():
            for _ in range(cfg.inner_steps):
                leaves = [a.requires_grad_(True) for a in map(torch.Tensor.detach,
                                                               tree_leaves(p))]
                live = tree_rebuild(p, leaves)
                loss = _xent(_logits_p(live, sx)[None], sy[None], sw[None])[0]
                grads = torch.autograd.grad(loss, leaves)
                p = tree_rebuild(p, [(a - cfg.inner_lr * g).detach()
                                     for a, g in zip(leaves, grads)])
        return p

    def meta_loss(params, batch: TaskBatch, scores, lite: LiteSpec,
                  estimator=None):
        del scores, lite, estimator
        losses, accs = [], []
        for t in range(batch.num_tasks):
            adapted = _inner_adapt(params, batch.support_x[t], batch.support_y[t],
                                   batch.support_mask[t])
            # first order: the adapted point as a constant offset of params
            at = tree_map(lambda a, b: a + (b - a).detach(), params, adapted)
            logits = _logits_p(at, batch.query_x[t])[None]
            losses.append(_xent(logits, batch.query_y[t:t + 1], batch.query_mask[t:t + 1]))
            accs.append(_accuracy(logits, batch.query_y[t:t + 1],
                                  batch.query_mask[t:t + 1]))
        return torch.cat(losses), dict(accuracy=torch.cat(accs))

    def adapt(params, sx, sy, mask, lite):
        return tree_map(lambda *ls: torch.stack(ls), *[
            _inner_adapt(params, sx[t], sy[t], mask[t]) for t in range(sx.shape[0])])

    def predict(params, states, qx):
        return torch.stack([_logits_p(tree_map(lambda a: a[t], states), qx[t])
                            for t in range(qx.shape[0])])

    return MetaLearner(cfg, bb, init, meta_loss,
                       *_batched_api(adapt, predict, inner_grad=True))


# ===========================================================================
# FineTuner transfer baseline (frozen backbone, a linear head per task)
# ===========================================================================

def make_finetuner(cfg: MetaLearnerConfig, bb: BackboneDef) -> MetaLearner:
    fdim = bb.feature_dim

    def init(gen, device=None):
        return dict(bb=bb.init(gen, device))

    def adapt(params, sx, sy, mask, lite):
        """Heads {w (T, F, way), b (T, way)}: ``inner_steps`` SGD steps from
        zeros on the detached support features."""
        with torch.no_grad():
            feats = _features_by_task(bb, tree_detach(params["bb"]), sx, None)
        w = feats.new_zeros(sx.shape[0], fdim, cfg.way)
        b = feats.new_zeros(sx.shape[0], cfg.way)
        with torch.enable_grad():
            for _ in range(cfg.inner_steps):
                w, b = w.detach().requires_grad_(True), b.detach().requires_grad_(True)
                logits = torch.einsum("tnf,tfc->tnc", feats, w) + b[:, None, :]
                gw, gb = torch.autograd.grad(_xent(logits, sy, mask).sum(), (w, b))
                w, b = w - cfg.inner_lr * gw, b - cfg.inner_lr * gb
        return dict(w=w.detach(), b=b.detach())

    def predict(params, head, qx):
        qf = _features_by_task(bb, params["bb"], qx, None)
        return torch.einsum("tmf,tfc->tmc", qf, head["w"]) + head["b"][:, None, :]

    def meta_loss(params, batch: TaskBatch, scores, lite: LiteSpec,
                  estimator=None):
        head = adapt(params, batch.support_x, batch.support_y, batch.support_mask, lite)
        return _loss_and_metrics(predict(params, head, batch.query_x), batch)

    return MetaLearner(cfg, bb, init, meta_loss,
                       *_batched_api(adapt, predict, inner_grad=True))


def make_learner(cfg: MetaLearnerConfig, bb: BackboneDef,
                 set_cfg: Optional[SetEncoderConfig] = None) -> MetaLearner:
    if cfg.kind == "protonets":
        return make_protonets(cfg, bb)
    if cfg.kind in ("cnaps", "simple_cnaps"):
        if set_cfg is None:
            raise ValueError("CNAPs-family learners need a SetEncoderConfig")
        return _make_cnaps_family(cfg, bb, set_cfg,
                                  simple=cfg.kind == "simple_cnaps")
    if cfg.kind == "fomaml":
        return make_fomaml(cfg, bb)
    if cfg.kind == "finetuner":
        return make_finetuner(cfg, bb)
    raise ValueError(f"unknown meta-learner kind {cfg.kind!r}; choose from {KINDS}")
