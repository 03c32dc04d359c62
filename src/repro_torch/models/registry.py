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

Every family is ported: the transformers (dense, MoE, MLA), mamba2, the
zamba2 hybrid and the whisper encoder-decoder.  Whisper's ``loss`` and
``prefill`` read ``batch['frontend_embeds']`` (B, S_enc, d_model) beside
the tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer, whisper, zamba2


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
    "encdec": ModelAPI(
        init=whisper.init_whisper,
        loss=whisper.loss,
        prefill=whisper.prefill,
        decode_step=whisper.decode_step,
        init_cache=whisper.init_cache,
        compute_params=whisper.compute_params,
    ),
}


def get_api(cfg: ModelConfig) -> ModelAPI:
    return _APIS[cfg.family]
