"""Abstract stand-ins for every model input on torch's ``meta`` device:
params, caches and batches of one (arch x shape) cell with their shapes
and dtypes and no storage, the counterparts of the JAX package's
``repro/launch/specs.py`` (``jax.ShapeDtypeStruct`` there).  The roofline
(:mod:`repro_torch.roofline.analysis`) counts parameters on them; nothing
is allocated, so a trillion-parameter config costs a second of host time.

Two layout differences from the JAX package's specs:

* tokens are int64, the port's index dtype (``data/tokens.py::
  batch_to_device``), where the JAX package's are int32;
* a cache's ``len`` is a Python ``int`` (the port's engine keeps it on the
  host), where the JAX package's is an int32 scalar.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.tree import tree_map
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, ShapeSpec
from repro_torch.models.registry import get_api


def batch_specs_for(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Model-input ``meta`` tensors of one (arch x shape) cell: ``tokens``
    (B, S), or (B, 1) for decode (one new token against a ``seq_len``-deep
    cache); ``frontend_embeds`` (B, n_frontend_tokens, d_model) in the
    compute dtype for a ``vision_stub`` frontend and for the
    encoder-decoder, except at decode."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda *size, dtype: torch.empty(size, dtype=dtype, device="meta")  # noqa: E731
    if shape.kind == "decode":
        return dict(tokens=meta(b, 1, dtype=torch.int64))
    batch = dict(tokens=meta(b, s, dtype=torch.int64))
    if cfg.frontend == "vision_stub" or cfg.family == "encdec":
        batch["frontend_embeds"] = meta(b, cfg.n_frontend_tokens, cfg.d_model,
                                        dtype=getattr(torch, cfg.compute_dtype))
    return batch


def abstract_cache_for(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """The empty cache of ``shape.global_batch`` slots of ``shape.seq_len``
    positions, every tensor on ``meta``."""
    return get_api(cfg).init_cache(cfg, shape.global_batch, shape.seq_len, "meta")


def abstract_params_for(cfg: ModelConfig):
    """The tree ``api.init`` draws for ``cfg``, every leaf an empty ``meta``
    tensor of the leaf's shape and dtype."""
    # init draws on its generator's device, and no generator exists on
    # ``meta``: run it on a CPU generator under fake tensors, which allocate
    # nothing and carry shape and dtype.  FakeTensorMode is private API of
    # torch, so it is imported here and nowhere else.
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = get_api(cfg).init(torch.Generator(), cfg)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)


def shape_by_name(name: str) -> ShapeSpec:
    return SHAPES_BY_NAME[name]
