"""The decoder-only transformer: the port of the JAX package's
``repro/models/transformer.py``.  GQA or MLA attention, a dense gated MLP or
an MoE FFN; local / global windows, softcaps, QKV bias, the minicpm scales
and the phi-3-vision frontend stub.

Parameters are the JAX package's tree: per-layer weights stacked on a
leading L axis under ``layers``; the JAX package's ``lax.scan`` over that
axis is a Python loop here.  Per-layer windows are Python ints
(:func:`layer_windows`).  The cache is ``{k, v: (L, B, S, Hkv, Dh)}`` for
GQA and ``{ckv: (L, B, S, R), krope: (L, B, S, rope)}`` for MLA (the
latent cache), in the compute dtype, with ``len: int``; its sequence axis
is 2 in both.

Entry points:
  loss(params, batch, cfg)          training objective (chunked cross-entropy
                                    + AUX_COEF * the MoE load-balance loss)
  prefill(params, batch, cfg)       full-sequence forward -> (last logits, cache)
  decode_step(params, cache, tokens, cfg)  one-token decode; writes the new
                                    positions into ``cache`` in place

  trunk(params, x, cfg, film=None)  embedded inputs -> final hidden states,
                                    per-layer FiLM, checkpointed blocks
                                    (the episodic LM backbone's forward)

Every entry point takes a kernel backend (``auto``: the kernels on a CUDA
tensor, see :mod:`repro_torch.kernels.dispatch`).  GQA's full-sequence
attention runs the flash attention kernel (B5; ``loss`` and ``trunk``
differentiate through it); MLA's stays on the transcription (see
:mod:`repro_torch.models.layers`).  An MoE layer runs its three expert
projections through the gmm kernel (B7), in prefill, decode and training
alike (``loss`` and ``trunk`` differentiate through B7's autograd
Function, whose backward products run on B7 too).  Decode attention is
plain array code, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.common.init import drawn_as, lecun_normal
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core.film import apply_film
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.sharding.ctx import active_mesh, use_mesh

Params = Dict
AUX_COEF = 0.01
GLOBAL_WINDOW = 1 << 30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def moe_dispatch(lp: Params, h2d: torch.Tensor, cfg: ModelConfig,
                 backend: Optional[str] = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of one layer on (T, D) tokens.  On one device (no
    :func:`repro_torch.sharding.ctx.active_mesh`) ``moe_ffn``.  Under an
    active mesh ``h2d`` is this data shard's tokens, whole on every model
    rank (the port replicates dense compute over ``model``), and with
    ``cfg.moe_shard_map`` the layer runs expert-parallel
    (``moe_ffn_sharded``) in the residual's layout,
    ``cfg.activation_layout`` if ``cfg.shard_activations_model`` else
    ``"seq"``, as the reference picks it (``transformer.py:44-48``): the
    tokens are cut to the layout's block, and the output gathered back
    (Megatron's sequence-parallel pair: the cut's backward gathers, the
    gather's takes this rank's block, since every model rank holds the
    whole gradient of a value it holds whole).  The shared experts run on
    the whole tokens.  Where the layout's dim does not divide, or without
    ``moe_shard_map``, ``moe_ffn`` runs on the global tokens, as GSPMD runs
    it in the reference (``moe_ffn_global``)."""
    from repro_torch.launch.mesh import all_gather, split
    mesh = active_mesh()
    if mesh is None:
        return M.moe_ffn(lp, h2d, cfg.moe, backend=backend)
    layout = cfg.activation_layout if cfg.shard_activations_model else "seq"
    t, d = h2d.shape
    n_model = mesh.shape.get("model", 1)
    if not cfg.moe_shard_map or (d if layout == "hidden" else t) % n_model:
        return M.moe_ffn_global(lp, h2d, cfg.moe, mesh, backend)
    dim = 1 if layout == "hidden" else 0
    x_local = split(h2d, mesh, "model", dim)
    y, aux = M.moe_ffn_sharded(lp, x_local, cfg.moe, mesh, layout, backend, shared=False)
    y = all_gather(y, mesh, "model", dim, vjp="slice")
    if cfg.moe.n_shared > 0:
        y = y + M._shared_ffn(lp["shared"], h2d)
    return y, aux


def _ffn(lp: Params, h: torch.Tensor, cfg: ModelConfig, backend: Optional[str]
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN of one layer on (B, S, D): (y, aux loss); aux is 0 for a
    dense MLP."""
    if cfg.moe is None:
        return L.mlp(lp["ffn"], h), torch.zeros((), dtype=torch.float32, device=h.device)
    b, s, d = h.shape
    y, aux = moe_dispatch(lp["ffn"], h.reshape(b * s, d), cfg, backend)
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    """One block's params; ``lead`` prefixes every leaf's shape (the stacked
    layers' (L,))."""
    dev = L.init_device(gen, device)
    mla = cfg.attention.kind == "mla"
    return dict(
        attn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        ffn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        attn=(L.init_mla if mla else L.init_gqa)(gen, cfg, dev, lead),
        ffn=(M.init_moe(gen, cfg.d_model, cfg.moe, dev, lead) if cfg.moe is not None
             else L.init_mlp(gen, cfg.d_model, cfg.d_ff, dev, lead)),
    )


def init_transformer(gen: torch.Generator, cfg: ModelConfig, device=None,
                     at_param_dtype: bool = False) -> Params:
    """Random params drawn on ``gen``'s device (moved to ``device`` if
    given).  Torch cannot reproduce ``jax.random``: to compute what a JAX
    model computes, carry its params across with
    :func:`repro_torch.bridge.lm_params_from_numpy`.

    ``at_param_dtype``: every floating leaf in ``cfg.param_dtype``, each
    draw cast before the next is drawn (:func:`repro_torch.common.init.drawn_as`).
    The numbers are those of casting the fp32 tree after init, as the JAX
    package's ``make_init_state`` does; only the peak differs (one kimi-k2
    layer's experts are 67.6 GB in fp32, 33.8 in bf16)."""
    dt = getattr(torch, cfg.param_dtype) if at_param_dtype else None
    dev = L.init_device(gen, device)
    with drawn_as(dt):
        p = dict(
            embed=L.init_embed(gen, cfg.vocab_padded, cfg.d_model, dev),
            layers=init_block(gen, cfg, dev, lead=(cfg.n_layers,)),
            final_norm=torch.zeros((cfg.d_model,), device=dev),
        )
        if not cfg.tie_embeddings:
            p["lm_head"] = lecun_normal(gen, (cfg.vocab_padded, cfg.d_model),
                                        cfg.vocab_padded, dev)
    if dt is not None:              # the zero-initialised leaves
        p = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, p)
    return p


# leaves of ``attn`` / ``ffn`` that the layers read in f32, never through
# ``x @ w.to(x.dtype)``: MLA's norm scales and the MoE router
_F32_LEAVES = ("kv_norm", "q_norm", "router")


def _narrowed(tree: Params, dt: torch.dtype) -> Params:
    return {k: _narrowed(v, dt) if isinstance(v, dict)
            else v if k in _F32_LEAVES or v.element_size() <= dt.itemsize else v.to(dt)
            for k, v in tree.items()}


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with every matmul weight and bias of the layers cast to
    the compute dtype once, where that narrows it (nested dicts, such as
    the MoE's ``shared`` expert, leaf by leaf).  The layers cast each
    weight to the activations' dtype at every call (``x @ w.to(x.dtype)``,
    as the JAX package reads), which re-reads and re-writes every fp32
    weight on every step in eager PyTorch; after this cast that ``.to`` is
    free and the numbers are the same.  A weight narrower than the compute
    dtype (bf16 params, fp32 compute) is left as it is: widening it once
    would hold a second copy of twice its size, and the per-call cast
    gives the same numbers.  Norm scales, the router, the embedding and
    the LM head keep their dtype (they are read in f32)."""
    dt = _dtype(cfg)
    layers = dict(params["layers"])
    for part in ("attn", "ffn"):
        layers[part] = _narrowed(layers[part], dt)
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
    """x: (B, S, D) -> (x', aux loss); the aux loss is the MoE layer's
    load-balance loss, 0 for a dense FFN.
    ``film`` {gamma, beta} of shape (D,) or (T, D) (task t on the t-th of T
    equal groups of rows) modulates the residual stream after the FFN
    residual, the LM-family FiLM site."""
    a = cfg.attention
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if a.kind == "mla":
        attn_out = L.mla_attention(lp["attn"], h, a, cfg.norm_eps)
    else:
        attn_out = L.gqa_attention(lp["attn"], h, a, window=window, backend=backend)
    x = x + cfg.residual_scale * attn_out
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    y, aux = _ffn(lp, h, cfg, backend)
    x = x + cfg.residual_scale * y
    if film is not None:
        x = apply_film(x, film["gamma"], film["beta"], channel_axis=-1)
    return x, aux


# matmuls with no batch dimension: ``x @ w`` of a (B, S, D) activation by a
# (D, F) weight reaches the dispatcher as ``aten.mm`` on the folded rows
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The JAX package's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of the weight matmuls, recompute everything else (norms, rope,
    the batched attention products, the flash attention kernel and the
    MoE's expert projections).  An expert projection ``ecd,edf->ecf`` has a
    batch dim, so JAX recomputes it too; here it is the gmm kernel (B7)
    inside its autograd Function, whose output is no ``aten.mm``."""
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


def _block_under(mesh, *args):
    """:func:`block` under ``mesh`` (a checkpoint's recompute, in the
    backward, sees the mesh of its forward)."""
    with use_mesh(mesh):
        return block(*args)


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
    remat = _remat(cfg) if torch.is_grad_enabled() else None
    # resolved now: a checkpoint's recompute runs in the backward, outside
    # the caller's use_backend and use_mesh scopes (on another thread, on
    # the card)
    backend = dispatch.resolve_backend(backend, x.device)
    mesh = active_mesh()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(layer_windows(cfg)):
        f = None if film is None else {k: v[i] for k, v in film.items()}
        if remat is not None:
            # the block draws no random numbers: no RNG state to restore
            x, a = checkpoint(_block_under, mesh, cfg, _layer(params, i), x, w, backend, f,
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
    unless the caller asks for the CPU): ``k``, ``v`` (L, B, S, Hkv, Dh) for
    GQA, the latent ``ckv`` (L, B, S, R) and ``krope`` (L, B, S, rope) for
    MLA."""
    a = cfg.attention
    lead = (cfg.n_layers, batch_size, max_seq)
    zeros = lambda *shape: torch.zeros(shape, dtype=_dtype(cfg), device=device)
    if a.kind == "mla":
        return dict(ckv=zeros(*lead, a.kv_lora_rank), krope=zeros(*lead, a.qk_rope_dim),
                    len=0)
    return dict(k=zeros(*lead, a.n_kv_heads, a.head_dim),
                v=zeros(*lead, a.n_kv_heads, a.head_dim), len=0)


def prefill(params: Params, batch: Dict, cfg: ModelConfig,
            backend: Optional[str] = "auto") -> Tuple[torch.Tensor, Dict]:
    """Full forward over the prompt (``batch['tokens']`` (B, S) int64, and
    ``frontend_embeds`` for a frontend model); returns (last-token logits
    (B, Vp) f32, the cache of the prompt's S positions)."""
    a = cfg.attention
    mla = a.kind == "mla"
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    new = lambda *shape: torch.empty((cfg.n_layers, b, s, *shape), dtype=x.dtype,
                                     device=x.device)
    if mla:
        cache = dict(ckv=new(a.kv_lora_rank), krope=new(a.qk_rope_dim))
    else:
        cache = dict(k=new(a.n_kv_heads, a.head_dim), v=new(a.n_kv_heads, a.head_dim))
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        if mla:
            ckv, krope = L.mla_latent(lp["attn"], h, a, cfg.norm_eps, positions)
            cache["ckv"][i], cache["krope"][i] = ckv, krope.reshape(b, s, -1)
            attn_out = L.mla_attention(lp["attn"], h, a, cfg.norm_eps, latent=(ckv, krope))
        else:
            ks, vs = cache["k"], cache["v"]
            q, ks[i], vs[i] = L.gqa_project_qkv(lp["attn"], h, a, positions)
            o = L.causal_attention(q, ks[i], vs[i], window=w, cap=a.attn_softcap,
                                   backend=backend)
            attn_out = o.reshape(b, s, -1) @ lp["attn"]["wo"].to(h.dtype)
        x = x + cfg.residual_scale * attn_out
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + cfg.residual_scale * _ffn(lp, h, cfg, backend)[0]
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return logits_head(params, h, cfg)[:, 0, :], dict(cache, len=s)


def decode_step(params: Params, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig, backend: Optional[str] = "auto"
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int64; ``cache`` from
    :func:`init_cache` or :func:`prefill`.  Returns (logits (B, Vp) f32,
    the cache at ``len + 1``); an MoE FFN runs on ``backend``.

    The new position (k and v, or MLA's latent ckv and krope) is written
    into the cache's tensors in place, at position ``len`` (the JAX package
    returns updated copies): the returned cache shares those tensors, and
    the one passed in must not be decoded from again.  Only the first
    ``len + 1`` positions are attended: the reference masks the rest to
    -1e30, whose softmax weight is exactly 0, so the slice computes the
    same up to summation order."""
    a = cfg.attention
    mla = a.kind == "mla"
    x = L.embed(params["embed"], tokens, _dtype(cfg)) * cfg.embed_scale
    pos = int(cache["len"])
    kv = [cache[n] for n in (("ckv", "krope") if mla else ("k", "v"))]
    if pos >= kv[0].shape[2]:
        raise ValueError(f"the cache holds {kv[0].shape[2]} positions; it is full")
    b = tokens.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    q_pos = torch.full((1,), pos, device=x.device)
    k_pos = torch.arange(pos + 1, device=x.device)
    for i, w in enumerate(layer_windows(cfg)):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        if mla:
            ckv_c, krope_c = kv[0][i], kv[1][i]
            ckv, krope = L.mla_latent(lp["attn"], h, a, cfg.norm_eps, positions)
            ckv_c[:, pos] = ckv[:, 0]
            krope_c[:, pos] = krope[:, 0, 0]
            attn_out = L.mla_decode_attention(lp["attn"], h, a, cfg.norm_eps, ckv_c,
                                              krope_c, pos)
        else:
            k_c, v_c = kv[0][i], kv[1][i]
            q, k, v = L.gqa_project_qkv(lp["attn"], h, a, positions)
            k_c[:, pos] = k[:, 0]
            v_c[:, pos] = v[:, 0]
            o = L.attention_scores(q, k_c[:, :pos + 1], v_c[:, :pos + 1], causal=False,
                                   window=w, cap=a.attn_softcap, q_positions=q_pos,
                                   k_positions=k_pos, k_len=pos + 1)
            attn_out = o.reshape(b, 1, -1) @ lp["attn"]["wo"].to(h.dtype)
        x = x + cfg.residual_scale * attn_out
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + cfg.residual_scale * _ffn(lp, h, cfg, backend)[0]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(params, h, cfg)[:, 0, :], {**cache, "len": pos + 1}
