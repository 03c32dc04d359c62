"""Deep-set task encoder (paper Eq. 2), ``conv`` kind: per-example
encodings of a support set, which the learners MEAN-pool (LITE pools).

Blocks are conv3x3 (SAME) -> relu -> 2x2 max-pool (VALID, floor), with the
pool applied unconditionally (unlike the backbone), then a global mean and
a linear head to ``task_dim``.  Inputs are NHWC; the convolutions run on an
NCHW view through cuDNN.  Conv weights are OIHW.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.init import lecun_normal


@dataclasses.dataclass(frozen=True)
class SetEncoderConfig:
    kind: str = "conv"
    in_channels: int = 3
    task_dim: int = 64
    conv_blocks: int = 4
    conv_width: int = 32


def init_set_encoder(gen: torch.Generator, cfg: SetEncoderConfig,
                     device=None) -> Dict:
    if cfg.kind != "conv":
        raise ValueError(f"set encoder kind {cfg.kind!r} is not ported; "
                         f"only 'conv' is")
    params = dict(blocks=[])
    ch = cfg.in_channels
    for _ in range(cfg.conv_blocks):
        params["blocks"].append(dict(
            w=lecun_normal(gen, (cfg.conv_width, ch, 3, 3), 3 * 3 * ch, device),
            b=torch.zeros(cfg.conv_width, device=device)))
        ch = cfg.conv_width
    params["head"] = dict(w=lecun_normal(gen, (ch, cfg.task_dim), ch, device),
                          b=torch.zeros(cfg.task_dim, device=device))
    return params


def encode_set(params: Dict, x: torch.Tensor, cfg: SetEncoderConfig
               ) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, task_dim) per-example encodings."""
    if cfg.kind != "conv":
        raise ValueError(f"set encoder kind {cfg.kind!r} is not ported")
    h = x.permute(0, 3, 1, 2)                           # NCHW view
    for blk in params["blocks"]:
        h = F.conv2d(h, blk["w"].to(h.dtype), padding=1) + \
            blk["b"].to(h.dtype)[:, None, None]
        h = torch.relu(h)
        h = F.max_pool2d(h, 2, 2)
    h = h.mean(dim=(2, 3))
    return h @ params["head"]["w"] + params["head"]["b"]
