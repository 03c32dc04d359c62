"""Deep-set task encoder (paper Eq. 2): per-example encodings of a support
set, which the learners MEAN-pool (LITE pools).

Three kinds, as in the JAX package's ``core/set_encoder.py``:

* ``conv``: blocks of conv3x3 (SAME) -> relu -> 2x2 max-pool (VALID,
  floor), with the pool applied unconditionally (unlike the backbone),
  then a global mean and a linear head to ``task_dim``.  Inputs are NHWC;
  the convolutions run on an NCHW view through cuDNN.  Conv weights are
  OIHW.
* ``mlp``: pre-featurized supports (B, in_channels) -> relu MLP.
* ``tokens``: bag of tokens for the episodic LM, (B, S) int64 ids -> the
  normalised token histogram over the vocabulary (``in_channels``) ->
  the same MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.init import lecun_normal
from repro_torch.common.linear import matmul

KINDS = ("conv", "mlp", "tokens")


@dataclasses.dataclass(frozen=True)
class SetEncoderConfig:
    kind: str = "conv"            # one of KINDS
    in_channels: int = 3          # conv: image channels; mlp: feature dim; tokens: vocab
    task_dim: int = 64
    conv_blocks: int = 4
    conv_width: int = 32
    mlp_hidden: int = 128


def init_set_encoder(gen: torch.Generator, cfg: SetEncoderConfig,
                     device=None) -> Dict:
    if cfg.kind in ("mlp", "tokens"):
        return dict(
            w1=lecun_normal(gen, (cfg.in_channels, cfg.mlp_hidden), cfg.in_channels,
                            device),
            b1=torch.zeros(cfg.mlp_hidden, device=device),
            w2=lecun_normal(gen, (cfg.mlp_hidden, cfg.task_dim), cfg.mlp_hidden, device),
            b2=torch.zeros(cfg.task_dim, device=device))
    if cfg.kind != "conv":
        raise ValueError(f"unknown set encoder kind {cfg.kind!r}; choose from {KINDS}")
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


def token_histogram(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, S) int64 ids -> (B, vocab) float32 normalised histogram: integer
    counts over S, then one division by S, which is the JAX package's
    ``mean(one_hot(ids), axis=1)`` exactly, without the (B, S, vocab)
    one-hot (10.5 GB of fp32 at 40 sequences of 256 tokens over 256000)."""
    counts = torch.zeros(ids.shape[0], vocab, dtype=torch.float32, device=ids.device)
    counts.scatter_add_(1, ids, torch.ones(ids.shape, dtype=torch.float32,
                                           device=ids.device))
    return counts / ids.shape[1]


def encode_set(params: Dict, x: torch.Tensor, cfg: SetEncoderConfig
               ) -> torch.Tensor:
    """Per-example encodings (B, task_dim) of x: (B, H, W, C) images
    (``conv``), (B, in_channels) features (``mlp``) or (B, S) int64 token
    ids (``tokens``)."""
    if cfg.kind in ("mlp", "tokens"):
        if cfg.kind == "tokens":
            x = token_histogram(x, cfg.in_channels)
        h = torch.relu(matmul(x, params["w1"]) + params["b1"])
        return matmul(h, params["w2"]) + params["b2"]
    if cfg.kind != "conv":
        raise ValueError(f"unknown set encoder kind {cfg.kind!r}; choose from {KINDS}")
    h = x.permute(0, 3, 1, 2)                           # NCHW view
    for blk in params["blocks"]:
        h = F.conv2d(h, blk["w"].to(h.dtype), padding=1) + \
            blk["b"].to(h.dtype)[:, None, None]
        h = torch.relu(h)
        h = F.max_pool2d(h, 2, 2)
    h = h.mean(dim=(2, 3))
    return matmul(h, params["head"]["w"]) + params["head"]["b"]
