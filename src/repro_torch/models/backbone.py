"""Backbone protocol: anything that maps examples (images, or token
sequences for an LM backbone) to a feature vector and exposes FiLM
modulation sites can serve as a meta-learner's feature extractor."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class BackboneDef:
    """A feature extractor usable by the episodic layer.

    init: (torch.Generator, device) -> params.
    features: (params, x, film) -> (B, feature_dim) float32.  ``x`` is
      NHWC (B, H, W, C) images for a conv backbone, (B, S) int64 token ids
      for an LM backbone (:mod:`repro_torch.models.lm_backbone`).
      ``film`` is None or a list of {gamma, beta}, one per site, each of
      shape (C,) or (T, C); with (T, C) the batch is T tasks' rows in
      order, B = T * n.
    quant_native_paths: '/'-joined param paths whose weight ``features``
      consumes directly in the blockwise int8 ``{q, scale, n}`` form
      (through :func:`repro_torch.kernels.dispatch.int8_matmul`).
    product_paths: '/'-joined param paths of 2-D weights that ``features``
      reads only as the right operand of
      :func:`repro_torch.common.linear.matmul`, so that a serving layout
      may keep a K-slice of each on a rank (``weight_stationary``).
    """

    init: Callable[..., Tree]
    features: Callable[[Tree, torch.Tensor, Any], torch.Tensor]
    feature_dim: int
    film_sites: Sequence[int]
    name: str = "backbone"
    quant_native_paths: Sequence[str] = ()
    product_paths: Sequence[str] = ()
