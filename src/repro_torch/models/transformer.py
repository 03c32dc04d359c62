"""The dense decoder-only transformer (GQA attention, gated MLP; local /
global windows, softcaps, QKV bias, the minicpm scales and the phi-3-vision
frontend stub): the port of the dense half of the JAX package's
``repro/models/transformer.py``.

Parameters are the JAX package's tree: per-layer weights stacked on a
leading L axis under ``layers``; the JAX package's ``lax.scan`` over that
axis is a Python loop here.  Per-layer windows are Python ints
(:func:`layer_windows`).  The KV cache is ``{k, v: (L, B, S, Hkv, Dh) in
the compute dtype, len: int}``.

Entry points:
  loss(params, batch, cfg)          training objective (chunked cross-entropy)
  prefill(params, batch, cfg)       full-sequence forward -> (last logits, cache)
  decode_step(params, cache, tokens, cfg)  one-token decode; writes the new
                                    k and v into ``cache`` in place

  trunk(params, x, cfg, film=None)  embedded inputs -> final hidden states,
                                    per-layer FiLM, checkpointed blocks
                                    (the episodic LM backbone's forward)

``loss``, ``prefill`` and ``trunk`` run their attention on a kernel
backend (``auto``: the flash attention kernel on a CUDA tensor, see
:mod:`repro_torch.models.layers`; ``loss`` and ``trunk`` differentiate
through it).
Decode attends one query to the cache: the JAX package computes it in
plain array code, with no kernel, and so does the port.

MoE FFNs and MLA attention raise (ROADMAP A14b).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common.init import lecun_normal
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.film import apply_film
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L

Params = Dict
AUX_COEF = 0.01
GLOBAL_WINDOW = 1 << 30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the transformer variants this slice does not port."""
    if cfg.moe is not None or cfg.attention.kind == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs and MLA attention are not ported yet "
            f"(ROADMAP A14b); the port serves the dense GQA transformers")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    """One block's params; ``lead`` prefixes every leaf's shape (the stacked
    layers' (L,))."""
    require_dense(cfg)
    dev = L.init_device(gen, device)
    return dict(
        attn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        ffn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        attn=L.init_gqa(gen, cfg, dev, lead),
        ffn=L.init_mlp(gen, cfg.d_model, cfg.d_ff, dev, lead),
    )


def init_transformer(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random params drawn on ``gen``'s device (moved to ``device`` if
    given).  Torch cannot reproduce ``jax.random``: to compute what a JAX
    model computes, carry its params across with
    :func:`repro_torch.bridge.lm_params_from_numpy`."""
    dev = L.init_device(gen, device)
    p = dict(
        embed=L.init_embed(gen, cfg.vocab_padded, cfg.d_model, dev),
        layers=init_block(gen, cfg, dev, lead=(cfg.n_layers,)),
        final_norm=torch.zeros((cfg.d_model,), device=dev),
    )
    if not cfg.tie_embeddings:
        p["lm_head"] = lecun_normal(gen, (cfg.vocab_padded, cfg.d_model),
                                    cfg.vocab_padded, dev)
    return p


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with every matmul weight and bias of the layers cast to
    the compute dtype once.  The layers cast each weight to the
    activations' dtype at every call (``x @ w.to(x.dtype)``, as the JAX
    package reads), which re-reads and re-writes every fp32 weight on every
    step in eager PyTorch; after this cast that ``.to`` is free and the
    numbers are the same.  Norm scales, the embedding and the LM head keep
    their dtype (``unembed`` computes in f32)."""
    dt = _dtype(cfg)
    layers = dict(params["layers"])
    for part in ("attn", "ffn"):
        layers[part] = {k: v.to(dt) for k, v in layers[part].items()}
    return {**params, "layers": layers}


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer attention window (gemma2: even layers local)."""
    return [cfg.sliding_window if cfg.local_global and i % 2 == 0 else GLOBAL_WINDOW
            for i in range(cfg.n_layers)]


def _layer(params: Params, i: int) -> Params:
    return tree_map(lambda t: t[i], params["layers"])


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def block(cfg: ModelConfig, lp: Params, x: torch.Tensor, window: int,
          backend: Optional[str] = "auto", film: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (x', aux loss); the aux loss is 0 for a dense FFN.
    ``film`` {gamma, beta} of shape (D,) or (T, D) (task t on the t-th of T
    equal groups of rows) modulates the residual stream after the FFN
    residual, the LM-family FiLM site."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + cfg.residual_scale * L.gqa_attention(lp["attn"], h, cfg.attention,
                                                 window=window, backend=backend)
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    x = x + cfg.residual_scale * L.mlp(lp["ffn"], h)
    if film is not None:
        x = apply_film(x, film["gamma"], film["beta"], channel_axis=-1)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# matmuls with no batch dimension: ``x @ w`` of a (B, S, D) activation by a
# (D, F) weight reaches the dispatcher as ``aten.mm`` on the folded rows
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The JAX package's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of the weight matmuls, recompute everything else (norms, rope,
    the batched attention products and the flash attention kernel)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig) -> Optional[Dict]:
    """How ``trunk`` checkpoints its blocks (``cfg.remat_policy``, as the
    JAX package's ``_remat`` reads it): None for ``"none"`` (every
    activation saved), else the keyword arguments of
    ``torch.utils.checkpoint``: ``"nothing"`` saves only each block's
    input and recomputes the block in the backward, ``"dots"`` also saves
    the weight matmuls' outputs (a selective-checkpoint policy)."""
    if cfg.remat_policy == "none":
        return None
    if cfg.remat_policy == "dots":
        return dict(context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots))
    return {}


def trunk(params: Params, x: torch.Tensor, cfg: ModelConfig,
          backend: Optional[str] = "auto", film: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B, S, D) -> (final hidden states, aux loss).

    ``film``: optional per-layer FiLM {gamma, beta} stacked on a leading L
    axis, (L, D) or (L, T, D) for T tasks whose rows are in order.  While
    grad is enabled under ``remat_policy`` "nothing" or "dots" each block
    runs under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint``): its recompute in the backward runs the block's
    forward, and its kernels, a second time."""
    require_dense(cfg)
    remat = _remat(cfg) if torch.is_grad_enabled() else None
    # resolved now: a checkpoint's recompute runs in the backward, outside
    # the caller's use_backend scope
    backend = dispatch.resolve_backend(backend, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(layer_windows(cfg)):
        f = None if film is None else {k: v[i] for k, v in film.items()}
        if remat is not None:
            # the block draws no random numbers: no RNG state to restore
            x, a = checkpoint(block, cfg, _layer(params, i), x, w, backend, f,
                              use_reentrant=False, preserve_rng_state=False, **remat)
        else:
            x, a = block(cfg, _layer(params, i), x, w, backend, f)
        aux = aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def logits_head(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = L.unembed(table, h) * cfg.logit_scale
    logits = L.softcap(logits, cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def embed_inputs(params: Params, batch: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Token embedding (+ the frontend stub's embeddings prepended)."""
    x = L.embed(params["embed"], batch["tokens"], _dtype(cfg)) * cfg.embed_scale
    if cfg.frontend is not None and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(_dtype(cfg))
        x = torch.cat([fe, x], dim=1)
    return x


# --------------------------------------------------------------------------
# training loss (chunked cross-entropy over the sequence axis)
# --------------------------------------------------------------------------

def _chunk_nll(params: Params, h: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sum over the masked positions of one chunk's NLL, in f32."""
    logits = logits_head(params, h, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - ll) * mask)


def _xent(params: Params, h: torch.Tensor, labels: torch.Tensor,
          mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h: (B, S, D); labels, mask: (B, S).  Mean NLL over the mask.

    When ``cfg.loss_chunk`` divides S into more than one chunk, the chunks'
    sums are added in order into an f32 running sum (the JAX package's
    ``lax.scan``), and while grad is enabled each chunk runs under
    ``torch.utils.checkpoint``, so the backward holds one chunk's (B,
    chunk, Vp) f32 logits at a time, not all of them.  Otherwise one pass,
    as the reference does it."""
    s = h.shape[1]
    chunk = cfg.loss_chunk if cfg.loss_chunk > 0 else s
    n = s // chunk if s % chunk == 0 else 0
    denom = torch.clamp(torch.sum(mask), min=1.0)
    if n <= 1:
        return _chunk_nll(params, h, labels, mask, cfg) / denom
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        part = (params, h[:, i * chunk:(i + 1) * chunk],
                labels[:, i * chunk:(i + 1) * chunk], mask[:, i * chunk:(i + 1) * chunk], cfg)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *part, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_nll(*part)
    return total / denom


def loss(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
         ) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss.  ``batch['tokens']`` (B, S) int64 (and
    ``frontend_embeds`` for a frontend model, whose positions are dropped
    before the loss).  Labels are the tokens shifted by one, the last
    position masked.  Returns (nll + AUX_COEF * aux, dict(nll=, aux=))."""
    tokens = batch["tokens"]
    x = embed_inputs(params, batch, cfg)
    h, aux = trunk(params, x, cfg, backend=backend)
    h = h[:, x.shape[1] - tokens.shape[1]:, :]
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=tokens.device),
                 (0, 1))
    nll = _xent(params, h, labels, mask, cfg)
    return nll + AUX_COEF * aux, dict(nll=nll, aux=aux)


# --------------------------------------------------------------------------
# KV-cache inference
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device="cuda") -> Dict:
    """An empty cache of ``max_seq`` positions on ``device`` (the card
    unless the caller asks for the CPU)."""
    require_dense(cfg)
    a = cfg.attention
    shape = (cfg.n_layers, batch_size, max_seq, a.n_kv_heads, a.head_dim)
    return dict(k=torch.zeros(shape, dtype=_dtype(cfg), device=device),
                v=torch.zeros(shape, dtype=_dtype(cfg), device=device), len=0)


def prefill(params: Params, batch: Dict, cfg: ModelConfig,
            backend: Optional[str] = "auto") -> Tuple[torch.Tensor, Dict]:
    """Full forward over the prompt (``batch['tokens']`` (B, S) int64, and
    ``frontend_embeds`` for a frontend model); returns (last-token logits
    (B, Vp) f32, the cache of the prompt's S positions)."""
    require_dense(cfg)
    a = cfg.attention
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    ks = torch.empty((cfg.n_layers, b, s, a.n_kv_heads, a.head_dim), dtype=x.dtype,
                     device=x.device)
    vs = torch.empty_like(ks)
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, ks[i], vs[i] = L.gqa_project_qkv(lp["attn"], h, a, positions)
        o = L.causal_attention(q, ks[i], vs[i], window=w, cap=a.attn_softcap,
                               backend=backend)
        x = x + cfg.residual_scale * (o.reshape(b, s, -1) @ lp["attn"]["wo"].to(h.dtype))
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + cfg.residual_scale * L.mlp(lp["ffn"], h)
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return logits_head(params, h, cfg)[:, 0, :], dict(k=ks, v=vs, len=s)


def decode_step(params: Params, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int64; ``cache`` from
    :func:`init_cache` or :func:`prefill`.  Returns (logits (B, Vp) f32,
    the cache at ``len + 1``).

    The new k and v are written into ``cache['k']`` and ``cache['v']`` in
    place, at position ``len`` (the JAX package returns updated copies):
    the returned cache shares those tensors, and the one passed in must not
    be decoded from again.  Only the first ``len + 1`` positions are
    attended: the reference masks the rest to -1e30, whose softmax weight
    is exactly 0, so the slice computes the same up to summation order."""
    require_dense(cfg)
    a = cfg.attention
    x = L.embed(params["embed"], tokens, _dtype(cfg)) * cfg.embed_scale
    pos = int(cache["len"])
    k_c, v_c = cache["k"], cache["v"]
    if pos >= k_c.shape[2]:
        raise ValueError(f"the cache holds {k_c.shape[2]} positions; it is full")
    b = tokens.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    q_pos = torch.full((1,), pos, device=x.device)
    k_pos = torch.arange(pos + 1, device=x.device)
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.gqa_project_qkv(lp["attn"], h, a, positions)
        k_c[i, :, pos] = k[:, 0]
        v_c[i, :, pos] = v[:, 0]
        o = L.attention_scores(q, k_c[i, :, :pos + 1], v_c[i, :, :pos + 1], causal=False,
                               window=w, cap=a.attn_softcap, q_positions=q_pos,
                               k_positions=k_pos, k_len=pos + 1)
        x = x + cfg.residual_scale * (o.reshape(b, 1, -1) @ lp["attn"]["wo"].to(h.dtype))
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + cfg.residual_scale * L.mlp(lp["ffn"], h)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(params, h, cfg)[:, 0, :], dict(k=k_c, v=v_c, len=pos + 1)
