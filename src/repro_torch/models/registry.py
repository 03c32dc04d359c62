"""Model API dispatch: one interface over the model families, the port of
the JAX package's ``repro/models/registry.py``.

    api = get_api(cfg)
    params = api.init(gen, cfg)                  # on gen's device
    params = api.init(gen, cfg, at_param_dtype=True)   # each leaf cast as drawn
    loss, metrics = api.loss(params, batch, cfg, backend="auto")
    logits, cache = api.prefill(params, batch, cfg, backend="auto")
    logits, cache = api.decode_step(params, cache, tokens, cfg, backend="auto")
    cache = api.init_cache(cfg, batch_size, max_seq, device)
    params = api.compute_params(params, cfg)     # matmul weights cast once

The transformers (dense, MoE, MLA), mamba2 and the zamba2 hybrid are
ported.  The encoder-decoder family raises, naming the item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer, zamba2


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    compute_params: Callable


_APIS = {
    "transformer": ModelAPI(
        init=transformer.init_transformer,
        loss=transformer.loss,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_cache=transformer.init_cache,
        compute_params=transformer.compute_params,
    ),
    "mamba2": ModelAPI(
        init=mamba2.init_mamba2,
        loss=mamba2.loss,
        prefill=mamba2.prefill,
        decode_step=mamba2.decode_step,
        init_cache=mamba2.init_cache,
        compute_params=mamba2.compute_params,
    ),
    "hybrid": ModelAPI(
        init=zamba2.init_zamba2,
        loss=zamba2.loss,
        prefill=zamba2.prefill,
        decode_step=zamba2.decode_step,
        init_cache=zamba2.init_cache,
        compute_params=zamba2.compute_params,
    ),
}

_NOT_PORTED = {"encdec": "A14d"}


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP {_NOT_PORTED[cfg.family]})")
    return _APIS[cfg.family]
