"""Zamba2-style hybrid: a Mamba-2 trunk with one SHARED attention + MLP
block applied at a fixed cadence (after every ``hybrid_attn_every - 1``
mamba layers); the port of the JAX package's ``repro/models/zamba2.py``.

Depth layout for n_layers=81, every=6: 13 groups x (5 mamba layers + the
shared block) + 3 tail mamba layers.  The shared block's weights appear
once in the param tree (its gradient is the sum over its application
sites); its activations differ per site, so decode keeps a KV cache per
SITE, not per layer.  The cache is ``{conv: (M, B, c, k-1), ssm: (M, B, h,
p, n)`` for the M mamba layers, ``k, v: (G, B, S, H, D)`` for the G sites,
``len: int}``.

Every entry point takes a kernel backend (``auto``: the kernels on a CUDA
tensor).  On ``cuda`` every SSD chunk of every mamba layer runs the
ssd_chunk kernel (B6, :mod:`repro_torch.models.mamba2`) and the shared
block's full-sequence attention the flash attention kernel (B5), each
inside its autograd Function wherever grad is on.  Decode attention is
plain array code, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.init import drawn_as
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as MB
from repro_torch.models import transformer as TT
from repro_torch.sharding import serve as SV

Params = Dict


def layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, mamba_per_group, n_tail_mamba)."""
    every = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every - 1, cfg.n_layers - n_groups * every


def n_mamba_layers(cfg: ModelConfig) -> int:
    g, pg, tail = layout(cfg)
    return g * pg + tail


def init_shared_block(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    dev = L.init_device(gen, device)
    return dict(
        attn_norm=torch.zeros((cfg.d_model,), device=dev),
        ffn_norm=torch.zeros((cfg.d_model,), device=dev),
        attn=L.init_gqa(gen, cfg, dev),
        ffn=L.init_mlp(gen, cfg.d_model, cfg.d_ff, dev),
    )


def init_zamba2(gen: torch.Generator, cfg: ModelConfig, device=None,
                at_param_dtype: bool = False) -> Params:
    """Random params drawn on ``gen``'s device (see
    :func:`repro_torch.models.mamba2.init_mamba2`)."""
    dt = getattr(torch, cfg.param_dtype) if at_param_dtype else None
    dev = L.init_device(gen, device)
    with drawn_as(dt):
        p = dict(embed=L.init_embed(gen, cfg.vocab_padded, cfg.d_model, dev),
                 mamba=MB.init_mamba_block(gen, cfg, dev, lead=(n_mamba_layers(cfg),)),
                 shared=init_shared_block(gen, cfg, dev),
                 final_norm=torch.zeros((cfg.d_model,), device=dev))
    if dt is not None:
        p = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, p)
    return p


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with the mamba blocks' matmul and conv weights
    (:func:`repro_torch.models.mamba2.compute_params`) and the shared
    block's attention and MLP weights cast to the compute dtype once, where
    that narrows them; norm scales, SSM parameters and the embedding keep
    their dtype."""
    dt = getattr(torch, cfg.compute_dtype)
    shared = dict(params["shared"])
    for part in ("attn", "ffn"):
        shared[part] = TT._narrowed(shared[part], dt)
    return {**params, "mamba": MB.narrow_block(params["mamba"], cfg), "shared": shared}


def _split_mamba(params: Params, cfg: ModelConfig):
    """Stacked mamba params -> (grouped (G, PG, ...), tail (T, ...)), views."""
    g, pg, _ = layout(cfg)
    grouped = tree_map(lambda a: a[: g * pg].reshape((g, pg) + a.shape[1:]), params["mamba"])
    tail_p = tree_map(lambda a: a[g * pg:], params["mamba"])
    return grouped, tail_p


def shared_attn_apply(sp: Params, x: torch.Tensor, cfg: ModelConfig,
                      backend: Optional[str] = "auto") -> torch.Tensor:
    h = L.rms_norm(x, sp["attn_norm"], cfg.norm_eps)
    x = x + L.gqa_attention(sp["attn"], h, cfg.attention, backend=backend)
    h = L.rms_norm(x, sp["ffn_norm"], cfg.norm_eps)
    return x + L.mlp(sp["ffn"], h)


def _at(tree: Params, *idx) -> Params:
    return tree_map(lambda t: t[idx], tree)


def _mamba_layers(params: Params, cfg: ModelConfig):
    """The mamba layers' params in depth order (the M leaves' order), each
    with the index of the shared site that follows it, or None:
    [(params, site or None), ...]."""
    grouped, tail_p = _split_mamba(params, cfg)
    g, pg, tail = layout(cfg)
    return ([(_at(grouped, gi, j), gi if j == pg - 1 else None)
             for gi in range(g) for j in range(pg)]
            + [(_at(tail_p, t), None) for t in range(tail)])


def trunk(params: Params, x: torch.Tensor, cfg: ModelConfig,
          backend: Optional[str] = "auto") -> torch.Tensor:
    """Embedded inputs (B, S, D) -> final hidden states.  While grad is
    enabled under ``remat_policy`` "nothing" or "dots" each mamba block
    runs under ``torch.utils.checkpoint``; the shared block is not
    checkpointed, as in the reference."""
    remat = TT._remat(cfg) if torch.is_grad_enabled() else None
    backend = dispatch.resolve_backend(backend, x.device)
    for lp, site in _mamba_layers(params, cfg):
        x = MB.remat_block(lp, x, cfg, backend, remat)
        if site is not None:
            x = shared_attn_apply(params["shared"], x, cfg, backend)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
         ) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss of ``batch['tokens']`` (B, S) int64 (see
    :func:`repro_torch.models.mamba2.loss`)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    return MB.lm_loss(params, tokens, trunk(params, x, cfg, backend), cfg)


# --------------------------------------------------------------------------
# inference: mamba states per mamba layer + KV cache per shared-attn SITE
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device="cuda") -> Dict:
    """An empty cache of ``max_seq`` positions a site on ``device`` (the card
    unless the caller asks for the CPU)."""
    a, s = cfg.attention, cfg.ssm
    g, _, _ = layout(cfg)
    nm = n_mamba_layers(cfg)
    zeros = lambda *shape, dtype=getattr(torch, cfg.compute_dtype): torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=device)
    return dict(
        conv=zeros(nm, batch_size, MB.conv_dim(cfg), s.d_conv - 1),
        ssm=zeros(nm, batch_size, s.n_heads(cfg.d_model), s.head_dim, s.d_state,
                  dtype=torch.float32),
        k=zeros(g, batch_size, max_seq, a.n_kv_heads, a.head_dim),
        v=zeros(g, batch_size, max_seq, a.n_kv_heads, a.head_dim),
        len=0)


def _sites(cfg: ModelConfig):
    """The index of the shared site after each mamba layer, in depth order
    (None where none follows): :func:`_mamba_layers`' order."""
    g, pg, tail = layout(cfg)
    return [gi if j == pg - 1 else None for gi in range(g) for j in range(pg)] + [None] * tail


def prefill(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
            ) -> Tuple[torch.Tensor, Dict]:
    """Full forward over the prompt (``batch['tokens']`` (B, S) int64);
    returns (last-token logits (B, Vp) f32, the cache of the prompt's S
    positions).  The shared block's attention runs on ``backend`` (B5 on
    ``cuda``).  Under an active mesh, this rank's rows on its blocks (the
    mamba layers as :func:`repro_torch.models.mamba2.prefill` runs them,
    each site's k and v as :func:`repro_torch.models.transformer.prefill`
    keeps them; the shared block gathered once)."""
    tokens = batch["tokens"]
    a = cfg.attention
    b_all, s = tokens.shape
    view = SV.begin(params, cfg, b_all, s, seq=s)
    tokens = view.rows(tokens)
    x = L.embed(view.get("embed"), tokens, getattr(torch, cfg.compute_dtype))
    b = x.shape[0]
    g, _, _ = layout(cfg)
    positions = torch.arange(s, device=x.device)
    sp = view.get("shared")
    conv, ssm = [], []
    kv = lambda name: view.empty(name, (g, b_all, s, a.n_kv_heads, a.head_dim),  # noqa: E731
                                 x.dtype, x.device)
    ks, vs = kv("k"), kv("v")
    for i, site in enumerate(_sites(cfg)):
        lp = view.layer("mamba", i)
        hn = L.rms_norm(x, lp["norm"], cfg.norm_eps)
        out, (conv_s, ssm_s) = MB.mamba_mixer(lp, hn, cfg, want_state=True, backend=backend)
        x = x + out
        conv.append(view.cut("conv", conv_s))
        ssm.append(view.cut("ssm", ssm_s))
        del lp
        if site is None:
            continue
        hn = L.rms_norm(x, sp["attn_norm"], cfg.norm_eps)
        q, k, v = L.gqa_project_qkv(sp["attn"], hn, a, positions)
        ks[site], vs[site] = view.cut("k", k), view.cut("v", v)
        o = L.causal_attention(q, k, v, cap=a.attn_softcap, backend=backend)
        x = x + o.reshape(b, s, -1) @ sp["attn"]["wo"].to(x.dtype)
        hn = L.rms_norm(x, sp["ffn_norm"], cfg.norm_eps)
        x = x + L.mlp(sp["ffn"], hn)
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return TT.logits_head(TT._head(view, cfg), h, cfg)[:, 0, :], view.finish(dict(
        conv=torch.stack(conv), ssm=torch.stack(ssm), k=ks, v=vs, len=s))


def decode_step(params: Params, cache: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                backend: Optional[str] = "auto") -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int64.  Returns (logits (B, Vp) f32,
    the cache at ``len + 1``).  The new mamba states and each site's new k
    and v are written into the cache's tensors in place (see
    :func:`repro_torch.models.transformer.decode_step`); only each site's
    first ``len + 1`` positions are attended.  Under an active mesh, this
    rank's rows on its blocks, as the transformer and mamba2 decode them.
    No kernel runs here."""
    del backend
    a = cfg.attention
    pos = int(cache["len"])
    view = SV.begin(params, cfg, tokens.shape[0], 1, cache=cache)
    view.check_room("k", cache["k"], pos)
    tokens = view.rows(tokens)
    b = tokens.shape[0]
    x = L.embed(view.get("embed"), tokens[:, 0], getattr(torch, cfg.compute_dtype))
    sp = view.get("shared")
    conv, ssm = cache["conv"], cache["ssm"]
    positions = torch.full((b, 1), pos, device=x.device)
    for i, site in enumerate(_sites(cfg)):
        lp = view.layer("mamba", i)
        hn = L.rms_norm(x, lp["norm"], cfg.norm_eps)
        out, conv[i], ssm[i] = MB.mamba_decode_mixer(lp, hn, cfg, conv[i], ssm[i], view)
        x = x + out
        del lp
        if site is None:
            continue
        k_c, v_c = cache["k"][site], cache["v"][site]
        hn = L.rms_norm(x[:, None, :], sp["attn_norm"], cfg.norm_eps)
        q, k, v = L.gqa_project_qkv(sp["attn"], hn, a, positions)
        view.write(k_c, "k", pos, k[:, 0])
        view.write(v_c, "v", pos, v[:, 0])
        o = view.attend("k", q, k_c, v_c, pos, cap=a.attn_softcap)
        h2 = x[:, None, :] + o.reshape(b, 1, -1) @ sp["attn"]["wo"].to(x.dtype)
        hn = L.rms_norm(h2, sp["ffn_norm"], cfg.norm_eps)
        x = (h2 + L.mlp(sp["ffn"], hn))[:, 0, :]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TT.logits_head(TT._head(view, cfg), h[:, None, :], cfg)[:, 0, :], {
        **cache, "len": pos + 1}
