"""The vision backbone: conv3x3 (SAME) -> FiLM -> relu -> 2x2 max-pool per
block (the pool only while H, W >= 2), a global mean, and a linear head.
The paper's large-image regime is 224 x 224 at the default widths.

Inputs are NHWC; the convolutions run on an NCHW view through cuDNN, as the
JAX package leaves them to XLA.  Conv weights are OIHW.  The head's product
goes through :func:`repro_torch.common.linear.matmul`: a head weight in the
blockwise int8 form runs the ``int8_matmul`` kernel, a K-slice of it (the
``weight_stationary`` serving layout) its slice's product summed over the
serving group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.common.init import lecun_normal
from repro_torch.common.linear import matmul
from repro_torch.core.film import apply_film
from repro_torch.models.backbone import BackboneDef


@dataclasses.dataclass(frozen=True)
class ConvBackboneConfig:
    in_channels: int = 3
    widths: Sequence[int] = (32, 64, 128, 256)
    feature_dim: int = 256
    name: str = "convnet"


def init_conv_backbone(gen: torch.Generator, cfg: ConvBackboneConfig,
                       device=None) -> Dict:
    params: Dict[str, Any] = dict(blocks=[])
    ch = cfg.in_channels
    for w in cfg.widths:
        params["blocks"].append(dict(
            w=lecun_normal(gen, (w, ch, 3, 3), 3 * 3 * ch, device),
            b=torch.zeros(w, device=device)))
        ch = w
    params["head"] = dict(
        w=lecun_normal(gen, (ch, cfg.feature_dim), ch, device),
        b=torch.zeros(cfg.feature_dim, device=device))
    return params


def conv_features(params: Dict, x: torch.Tensor, film: Optional[List[Dict]],
                  cfg: ConvBackboneConfig) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, feature_dim).  One FiLM site per block."""
    h = x.permute(0, 3, 1, 2)                           # NCHW view
    for i, blk in enumerate(params["blocks"]):
        h = F.conv2d(h, blk["w"].to(h.dtype), padding=1) + \
            blk["b"].to(h.dtype)[:, None, None]
        if film is not None:
            h = apply_film(h, film[i]["gamma"], film[i]["beta"], channel_axis=1)
        h = torch.relu(h)
        if h.shape[2] >= 2 and h.shape[3] >= 2:
            h = F.max_pool2d(h, 2, 2)
    h = h.mean(dim=(2, 3))
    return matmul(h, params["head"]["w"]) + params["head"]["b"]


def make_conv_backbone(cfg: ConvBackboneConfig) -> BackboneDef:
    return BackboneDef(
        init=lambda gen, device=None: init_conv_backbone(gen, cfg, device),
        features=lambda p, x, film: conv_features(p, x, film, cfg),
        feature_dim=cfg.feature_dim,
        film_sites=tuple(cfg.widths),
        name=cfg.name,
        quant_native_paths=("head/w",),
        product_paths=("head/w",),
    )
