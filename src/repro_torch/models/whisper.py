"""Whisper-style encoder-decoder transformer: the port of the JAX package's
``repro/models/whisper.py``.

The audio (conv / mel) frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings ``frontend_embeds`` (B, S_enc,
d_model).  Encoder: bidirectional self-attention and the gated MLP;
decoder: causal self-attention, cross attention to the encoder's output,
the gated MLP.  Positions are rotary (the reference's deviation from the
original's learned / sinusoidal tables), ``arange(S)`` in each stack.

Parameters are the JAX package's tree: ``embed`` (tied with the LM head),
the ``encoder`` and ``decoder`` blocks stacked on a leading L axis,
``enc_norm`` and ``final_norm``.  The cache is ``{k, v: (L, B, S, Hkv,
Dh)`` for the decoder's self-attention, ``cross_k, cross_v: (L, B, S_enc,
H, Dh)`` (each layer's projections of the encoder's output, computed once
at prefill), ``len: int}``, in the compute dtype.

Every entry point takes a kernel backend (``auto``: the kernels on a CUDA
tensor).  On ``cuda`` every encoder layer's self-attention runs the flash
attention kernel (B5) without the causal mask, and every decoder layer's
full-sequence self-attention (prefill, training) runs it causal, each
inside its autograd Function wherever grad is on.  Cross attention (q of
the decoder's length against the encoder's S_enc keys) and decode's
self-attention are plain array code (:func:`repro_torch.models.layers.
attention_scores`), as in the reference: B5 takes one length for q and k.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.init import drawn_as, lecun_normal
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.sharding import serve as SV

Params = Dict


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    a = cfg.attention
    d, hd = cfg.d_model, a.n_heads * a.head_dim
    dev = L.init_device(gen, device)
    return dict(
        wq=lecun_normal(gen, (*lead, d, hd), d, dev),
        wk=lecun_normal(gen, (*lead, d, hd), d, dev),
        wv=lecun_normal(gen, (*lead, d, hd), d, dev),
        wo=lecun_normal(gen, (*lead, hd, d), hd, dev),
    )


def init_enc_block(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    dev = L.init_device(gen, device)
    return dict(
        attn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        ffn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        attn=L.init_gqa(gen, cfg, dev, lead),
        ffn=L.init_mlp(gen, cfg.d_model, cfg.d_ff, dev, lead),
    )


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    dev = L.init_device(gen, device)
    return dict(
        attn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        cross_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        ffn_norm=torch.zeros((*lead, cfg.d_model), device=dev),
        attn=L.init_gqa(gen, cfg, dev, lead),
        cross=init_cross_attn(gen, cfg, dev, lead),
        ffn=L.init_mlp(gen, cfg.d_model, cfg.d_ff, dev, lead),
    )


def init_whisper(gen: torch.Generator, cfg: ModelConfig, device=None,
                 at_param_dtype: bool = False) -> Params:
    """Random params drawn on ``gen``'s device (see
    :func:`repro_torch.models.transformer.init_transformer`)."""
    dt = getattr(torch, cfg.param_dtype) if at_param_dtype else None
    dev = L.init_device(gen, device)
    with drawn_as(dt):
        p = dict(
            embed=L.init_embed(gen, cfg.vocab_padded, cfg.d_model, dev),
            encoder=init_enc_block(gen, cfg, dev, lead=(cfg.n_encoder_layers,)),
            decoder=init_dec_block(gen, cfg, dev, lead=(cfg.n_layers,)),
            enc_norm=torch.zeros((cfg.d_model,), device=dev),
            final_norm=torch.zeros((cfg.d_model,), device=dev),
        )
    if dt is not None:              # the zero-initialised leaves
        p = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, p)
    return p


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with the attention, cross attention and MLP weights of
    both stacks cast to the compute dtype once, where that narrows them
    (:func:`repro_torch.models.transformer.compute_params`'s reason); norm
    scales and the embedding keep their dtype."""
    dt = _dtype(cfg)
    out = dict(params)
    for stack, parts in (("encoder", ("attn", "ffn")), ("decoder", ("attn", "cross", "ffn"))):
        blocks = dict(params[stack])
        for part in parts:
            blocks[part] = TT._narrowed(blocks[part], dt)
        out[stack] = blocks
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def enc_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
              backend: Optional[str] = "auto") -> torch.Tensor:
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + L.gqa_attention_bidir(lp["attn"], h, cfg.attention, backend=backend)
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + L.mlp(lp["ffn"], h)


def dec_block(lp: Params, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
              backend: Optional[str] = "auto") -> torch.Tensor:
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + L.gqa_attention(lp["attn"], h, cfg.attention, backend=backend)
    h = L.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
    x = x + cross_attention(lp["cross"], h, enc, cfg)
    h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + L.mlp(lp["ffn"], h)


def _stack(block, layer, n: int, x: torch.Tensor, extra: tuple, cfg: ModelConfig,
           backend: Optional[str]) -> torch.Tensor:
    """``x`` through ``n`` blocks, block ``i``'s params ``layer(i)`` (a
    serving view's :meth:`~repro_torch.sharding.serve.LocalView.layer` of
    one stack, which under a mesh gathers the layer).  While grad is
    enabled under ``remat_policy`` "nothing" or "dots" each block runs under
    ``torch.utils.checkpoint`` (the reference remats both stacks): its
    recompute in the backward runs the block's forward, and B5, again."""
    remat = TT._remat(cfg) if torch.is_grad_enabled() else None
    # resolved now: a checkpoint's recompute runs in the backward, outside
    # the caller's use_backend scope
    backend = dispatch.resolve_backend(backend, x.device)
    for i in range(n):
        args = (layer(i), x, *extra, cfg, backend)
        if remat is None:
            x = block(*args)
        else:
            # the block draws no random numbers: no RNG state to restore
            x = checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                           **remat)
    return x


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           backend: Optional[str] = "auto", view=None) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states (B, S_enc, D)
    in the compute dtype.  ``view``: the serving view whose layers the
    encoder reads (the whole ``params`` by default)."""
    view = view or SV.LocalView(params)
    x = frames.to(_dtype(cfg))
    x = _stack(enc_block, lambda i: view.layer("encoder", i), cfg.n_encoder_layers, x, (),
               cfg, backend)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def cross_kv(cp: Params, enc: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype):
    """One layer's cross-attention keys and values of the encoder's output:
    (B, S_enc, H, Dh) each, in ``dtype``."""
    a = cfg.attention
    b, se, _ = enc.shape
    k = (enc @ cp["wk"].to(dtype)).reshape(b, se, a.n_heads, a.head_dim)
    v = (enc @ cp["wv"].to(dtype)).reshape(b, se, a.n_heads, a.head_dim)
    return k, v


def cross_attention_cached(cp: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cfg: ModelConfig, view=None) -> torch.Tensor:
    """Cross attention of x on one layer's cross k and v; ``view``: a
    serving view over a mesh whose k and v are this rank's blocks
    (:meth:`repro_torch.sharding.serve.MeshView.attend`)."""
    a = cfg.attention
    b, s, _ = x.shape
    q = (x @ cp["wq"].to(x.dtype)).reshape(b, s, a.n_heads, a.head_dim)
    o = (view or SV.LocalView(None)).attend("cross_k", q, k, v, None)
    return o.reshape(b, s, -1) @ cp["wo"].to(x.dtype)


def cross_attention(cp: Params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return cross_attention_cached(cp, x, *cross_kv(cp, enc, cfg, x.dtype), cfg)


def decode_trunk(params: Params, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                 backend: Optional[str] = "auto") -> torch.Tensor:
    """Embedded tokens (B, S, D) and encoder states -> final hidden
    states."""
    view = SV.LocalView(params)
    x = _stack(dec_block, lambda i: view.layer("decoder", i), cfg.n_layers, x, (enc,), cfg,
               backend)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
         ) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss.  ``batch``: ``frontend_embeds`` (B, S_enc, D) float,
    ``tokens`` (B, S) int64.  Labels are the tokens shifted by one, the
    last position masked.  Returns (nll, dict(nll=, aux=0))."""
    tokens = batch["tokens"]
    enc = encode(params, batch["frontend_embeds"], cfg, backend)
    x = L.embed(params["embed"], tokens, _dtype(cfg))
    h = decode_trunk(params, x, enc, cfg, backend)
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=tokens.device),
                 (0, 1))
    nll = TT._xent(params, h, labels, mask, cfg)
    return nll, dict(nll=nll, aux=torch.zeros((), dtype=torch.float32, device=nll.device))


# --------------------------------------------------------------------------
# inference: decoder self-attention KV cache + precomputed cross K/V
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device="cuda") -> Dict:
    """An empty cache of ``max_seq`` decoder positions and the config's
    ``n_frontend_tokens`` encoder positions on ``device`` (the card unless
    the caller asks for the CPU)."""
    a = cfg.attention
    lead = (cfg.n_layers, batch_size)
    zeros = lambda *shape: torch.zeros(shape, dtype=_dtype(cfg), device=device)  # noqa: E731
    se = cfg.n_frontend_tokens
    return dict(k=zeros(*lead, max_seq, a.n_kv_heads, a.head_dim),
                v=zeros(*lead, max_seq, a.n_kv_heads, a.head_dim),
                cross_k=zeros(*lead, se, a.n_heads, a.head_dim),
                cross_v=zeros(*lead, se, a.n_heads, a.head_dim), len=0)


def prefill(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
            ) -> Tuple[torch.Tensor, Dict]:
    """The encoder over ``batch['frontend_embeds']`` and the decoder over
    the prompt ``batch['tokens']`` (B, S) int64; returns (last-token logits
    (B, Vp) f32, the cache of the prompt's S positions and every layer's
    cross k and v).  The decoder's self-attention runs causal on
    ``backend`` (B5 on ``cuda``), as the encoder's runs bidirectional.
    Under an active mesh, this rank's rows on its blocks (both stacks'
    layers gathered as they are reached; each layer's self and cross k and
    v cut to this rank's blocks), as
    :func:`repro_torch.models.transformer.prefill` runs them."""
    a = cfg.attention
    tokens, frames = batch["tokens"], batch["frontend_embeds"]
    b_all, s = tokens.shape
    se = frames.shape[1]
    view = SV.begin(params, cfg, b_all, s + se, seq=s, s_enc=se)
    tokens, frames = view.rows(tokens), view.rows(frames)
    enc = encode(params, frames, cfg, backend, view)
    x = L.embed(view.get("embed"), tokens, _dtype(cfg))
    b = x.shape[0]
    positions = torch.arange(s, device=x.device)
    new = lambda name, n, h: view.empty(name, (cfg.n_layers, b_all, n, h, a.head_dim),  # noqa: E731
                                        x.dtype, x.device)
    ks, vs = new("k", s, a.n_kv_heads), new("v", s, a.n_kv_heads)
    cks, cvs = new("cross_k", se, a.n_heads), new("cross_v", se, a.n_heads)
    for i in range(cfg.n_layers):
        lp = view.layer("decoder", i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.gqa_project_qkv(lp["attn"], h, a, positions)
        ks[i], vs[i] = view.cut("k", k), view.cut("v", v)
        o = L.causal_attention(q, k, v, cap=a.attn_softcap, backend=backend)
        x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"].to(h.dtype)
        h = L.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        ck, cv = cross_kv(lp["cross"], enc, cfg, h.dtype)
        cks[i], cvs[i] = view.cut("cross_k", ck), view.cut("cross_v", cv)
        x = x + cross_attention_cached(lp["cross"], h, ck, cv, cfg)
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + L.mlp(lp["ffn"], h)
        del lp
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return TT.logits_head(TT._head(view, cfg), h, cfg)[:, 0, :], view.finish(dict(
        k=ks, v=vs, cross_k=cks, cross_v=cvs, len=s))


def decode_step(params: Params, cache: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                backend: Optional[str] = "auto") -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int64.  Returns (logits (B, Vp) f32,
    the cache at ``len + 1``).  The new k and v are written into the cache's
    tensors in place (see :func:`repro_torch.models.transformer.decode_step`);
    only the first ``len + 1`` positions are attended, and the cross k and v
    are read as the prefill left them.  Under an active mesh, this rank's
    rows on its blocks (self and cross attention on this rank's blocks,
    merged over the ranks that split them).  No kernel runs here."""
    del backend
    a = cfg.attention
    pos = int(cache["len"])
    view = SV.begin(params, cfg, tokens.shape[0], 1, cache=cache)
    view.check_room("k", cache["k"], pos)
    tokens = view.rows(tokens)
    b = tokens.shape[0]
    x = L.embed(view.get("embed"), tokens, _dtype(cfg))
    positions = torch.full((b, 1), pos, device=x.device)
    for i in range(cfg.n_layers):
        lp = view.layer("decoder", i)
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.gqa_project_qkv(lp["attn"], h, a, positions)
        view.write(k_c, "k", pos, k[:, 0])
        view.write(v_c, "v", pos, v[:, 0])
        o = view.attend("k", q, k_c, v_c, pos)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"].to(h.dtype)
        h = L.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        x = x + cross_attention_cached(lp["cross"], h, cache["cross_k"][i],
                                       cache["cross_v"][i], cfg, view)
        h = L.rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + L.mlp(lp["ffn"], h)
        del lp
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TT.logits_head(TT._head(view, cfg), h, cfg)[:, 0, :], {**cache, "len": pos + 1}
