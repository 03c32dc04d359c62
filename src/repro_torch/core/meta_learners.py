"""Meta-learners for test-time adaptation: ProtoNets, CNAPs and Simple
CNAPs (paper Sec. 3.1), the serving half.

Every learner speaks one batched, mask-aware contract (the episodic serving
engine's API):

    states = learner.adapt_batch(params, task_batch, lite)   # leaves (T, ...)
    logits = learner.predict_batch(params, states, query_x)  # (T, M, way)

``task_batch`` is a :class:`repro_torch.core.episodic.TaskBatch` of
tensors.  The task-lane axis T is a batch dimension written out (the JAX
package vmaps per-task functions).  Adaptation runs the forward-only LITE
serve estimators (:mod:`repro_torch.core.lite`): exact values over every
support example, chunk-bounded memory.  Serving draws no random numbers, so
``adapt_batch`` takes no keys.

The class statistics and the Simple CNAPs Mahalanobis head go through
:mod:`repro_torch.kernels.dispatch`.  ``meta_loss`` (training) and the
fomaml / finetuner learners are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common.init import lecun_normal
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.film import generate_film_params, init_film_generator
from repro_torch.core.lite import (LiteSpec, serve_class_stats,
                                   serve_segment_sum, serve_sum)
from repro_torch.core.set_encoder import (SetEncoderConfig, encode_set,
                                          init_set_encoder)
from repro_torch.kernels import dispatch
from repro_torch.models.backbone import BackboneDef

Tree = Any
SERVE_KINDS = ("protonets", "cnaps", "simple_cnaps")


@dataclasses.dataclass(frozen=True)
class MetaLearnerConfig:
    kind: str = "protonets"      # protonets | cnaps | simple_cnaps
    way: int = 5
    gen_hidden: int = 64
    head_hidden: int = 64
    cov_eps: float = 1.0         # simple-cnaps covariance ridge
    film_init_std: float = 0.1


@dataclasses.dataclass(frozen=True)
class MetaLearner:
    cfg: MetaLearnerConfig
    backbone: BackboneDef
    init: Callable[..., Tree]            # (torch.Generator, device) -> params
    adapt_batch: Callable[..., Tree]
    predict_batch: Callable[[Tree, Tree, torch.Tensor], torch.Tensor]


def _batched_api(adapt: Callable, predict: Callable):
    """Wrap the batched bodies in ``inference_mode``: serving never builds
    an autograd graph."""
    def adapt_batch(params, batch: TaskBatch,
                    lite: LiteSpec = LiteSpec(exact=True)):
        with torch.inference_mode():
            return adapt(params, batch.support_x, batch.support_y,
                         batch.support_mask, lite)

    def predict_batch(params, states, qx):
        with torch.inference_mode():
            return predict(params, states, qx)

    return adapt_batch, predict_batch


def _features_by_task(bb: BackboneDef, bb_params, x: torch.Tensor, film):
    """(T, M, H, W, C) -> (T, M, F) float32 features."""
    t, m = x.shape[:2]
    qf = bb.features(bb_params, x.flatten(0, 1), film)
    return qf.float().unflatten(0, (t, m))


# ===========================================================================
# ProtoNets: metric head over class prototypes
# ===========================================================================

def make_protonets(cfg: MetaLearnerConfig, bb: BackboneDef) -> MetaLearner:
    def init(gen, device=None):
        return dict(bb=bb.init(gen, device))

    def adapt(params, sx, sy, mask, lite):
        def encode(p, x):
            return bb.features(p, x, None)
        sums, counts = serve_segment_sum(encode, params["bb"], sx, sy, cfg.way,
                                         lite, mask)
        return sums / torch.clamp(counts, min=1.0)[..., None]   # (T, C, F)

    def predict(params, protos, qx):
        qf = _features_by_task(bb, params["bb"], qx, None)       # (T, M, F)
        return -torch.sum((qf[:, :, None, :] - protos[:, None, :, :]) ** 2,
                          dim=-1)

    return MetaLearner(cfg, bb, init, *_batched_api(adapt, predict))


# ===========================================================================
# CNAPs / Simple CNAPs: frozen backbone + per-task FiLM
# ===========================================================================

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

    def adapt(params, sx, sy, mask, lite):
        # task embedding: mean-pooled set encodings over real examples
        n = torch.clamp(mask.sum(dim=1), min=1.0)                   # (T,)
        z_sum = serve_sum(lambda p, x: encode_set(p, x, set_cfg),
                          params["enc"], sx, lite, mask)
        film = generate_film_params(params["film_gen"], z_sum / n[:, None])
        sums, counts = serve_class_stats(_features, (params["bb"], film), sx,
                                         sy, cfg.way, lite, mask,
                                         second_moment=simple)
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
            # cholesky_ex: no host sync on an error check
            state["chol"] = torch.linalg.cholesky_ex(sigma).L
            if dispatch.resolve_backend(None, sigma.device) == "cuda":
                # the Mahalanobis kernel takes the explicit inverse: compute
                # it once here so every query dispatch skips the solves
                state["sinv"] = dispatch.chol_inverse(state["chol"])
        else:
            hg = params["head_gen"]
            h = torch.relu(mu @ hg["w1"] + hg["b1"])
            wb = h @ hg["w2"] + hg["b2"]
            state["w"] = wb[..., :fdim]                             # (T, C, F)
            state["b"] = wb[..., fdim]                              # (T, C)
        return state

    def predict(params, state, qx):
        qf = _features_by_task(bb, params["bb"], qx, state["film"])
        if simple:
            return -dispatch.mahalanobis_head(qf, state["mu"], state["chol"],
                                              sinv=state.get("sinv"))
        return torch.einsum("tmf,tcf->tmc", qf, state["w"]) + \
            state["b"][:, None, :]

    return MetaLearner(cfg, bb, init, *_batched_api(adapt, predict))


def make_learner(cfg: MetaLearnerConfig, bb: BackboneDef,
                 set_cfg: Optional[SetEncoderConfig] = None) -> MetaLearner:
    if cfg.kind == "protonets":
        return make_protonets(cfg, bb)
    if cfg.kind in ("cnaps", "simple_cnaps"):
        if set_cfg is None:
            raise ValueError("CNAPs-family learners need a SetEncoderConfig")
        return _make_cnaps_family(cfg, bb, set_cfg,
                                  simple=cfg.kind == "simple_cnaps")
    raise ValueError(f"meta-learner kind {cfg.kind!r} is not ported; "
                     f"choose from {SERVE_KINDS}")
