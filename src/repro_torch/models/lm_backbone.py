"""An LM architecture as an episodic :class:`BackboneDef`: the port of the
JAX package's ``repro/models/lm_backbone.py``.

The paper's scheme wraps any feature extractor.  Here the support and
query examples are token sequences (B, S) int64, the features are the
final hidden states mean-pooled over S in fp32, and FiLM modulates the
residual stream after every block (one site of width d_model a layer).

Every ``family="transformer"`` config is taken: dense GQA, MoE and MLA
(an MoE trunk differentiates through the gmm kernel's autograd Function;
a frozen trunk launches no weight gradient).  The trunk is drawn in the
config's ``param_dtype``, each leaf cast as it is drawn (deepseek-v2 and
kimi-k2 publish bf16 params).

``family="mamba2"`` is taken too.  Its trunk has no per-layer FiLM: FiLM
is applied once, to the final hidden states, with gamma and beta the mean
of the per-layer stack, as in the reference (``film_sites`` still has one
entry a layer).  On ``cuda`` every SSD chunk runs the ssd_chunk kernel
(B6), inside its autograd Function where grad is on.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.film import apply_film
from repro_torch.models import layers as L
from repro_torch.models import mamba2, transformer
from repro_torch.models.backbone import BackboneDef


def _film_stack(film: Optional[List[Dict]]) -> Optional[Dict]:
    """Per-site {gamma, beta} of shape (D,) or (T, D), one a layer ->
    {gamma, beta} stacked on a leading L axis."""
    if film is None:
        return None
    return {k: torch.stack([f[k] for f in film]) for k in ("gamma", "beta")}


def make_lm_backbone(cfg: ModelConfig) -> BackboneDef:
    if cfg.family == "transformer":
        init_fn = transformer.init_transformer
    elif cfg.family == "mamba2":
        init_fn = mamba2.init_mamba2
    else:
        raise ValueError(f"episodic LM backbone unsupported for {cfg.family!r}")
    dtype = getattr(torch, cfg.compute_dtype)

    def init(gen: torch.Generator, device=None):
        return init_fn(gen, cfg, device, at_param_dtype=True)

    def features(params, tokens: torch.Tensor, film) -> torch.Tensor:
        """(B, S) int64 ids -> (B, d_model) float32.  The kernels run on the
        current kernel backend (:func:`repro_torch.kernels.dispatch.use_backend`)."""
        x = L.embed(params["embed"], tokens, dtype) * cfg.embed_scale
        fs = _film_stack(film)
        if cfg.family == "transformer":
            h, _ = transformer.trunk(params, x, cfg, backend=None, film=fs)
        else:
            h = mamba2.trunk(params, x, cfg, backend=None)
            if fs is not None:      # the final-state site: the per-layer mean
                h = apply_film(h, fs["gamma"].mean(0), fs["beta"].mean(0), channel_axis=-1)
        return h.float().mean(dim=1)

    return BackboneDef(init=init, features=features, feature_dim=cfg.d_model,
                       film_sites=(cfg.d_model,) * cfg.n_layers, name=f"lm:{cfg.name}")
