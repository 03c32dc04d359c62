"""Transformer building blocks: the port of the JAX package's
``repro/models/layers.py`` (GQA and MLA attention, the gated MLP, embed and
unembed).

Layouts are the JAX package's: a weight is (d_in, d_out) and is used as
``x @ w``; activations are (B, S, D); q is (B, S, Hq, Dh), k and v are
(B, S, Hkv, Dh).  Initializers draw on an explicit ``torch.Generator``
(on its device; see :mod:`repro_torch.common.init`) and take ``lead``, a
leading shape for stacked layers.

Full-sequence self-attention, causal (:func:`gqa_attention`) or
bidirectional (:func:`gqa_attention_bidir`, whisper's encoder), takes a
kernel backend, one of :data:`repro_torch.kernels.dispatch.BACKENDS`, and
goes through :func:`repro_torch.kernels.dispatch.flash_attention`: ``cuda``
runs the hand-written flash attention kernel
(:func:`repro_torch.kernels.ops.flash_attention_gqa`; on a CPU tensor its
plain version) inside an autograd Function whose backward is the VJP of
:func:`attention_scores`, every other backend the transcription
:func:`attention_scores` of the JAX package's attention, and ``auto``
(the default) is ``cuda`` on a CUDA tensor and the transcription on the
CPU.  The two differ by where P is rounded: the transcription rounds the
normalised probabilities to v's dtype before the PV product, as the JAX
package does, while the kernel rounds the un-normalised P in registers
(and its plain version does not round P at all).

MLA (DeepSeek-V2) prefill stays on the transcription whatever the backend,
as in the reference: its q and k are nope + rope = 192 wide and its v 128,
which the flash attention kernel does not take (one head dim for q, k and
v).  Its absorbed decode is plain einsums against the latent cache, as in
the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.init import lecun_normal, normal_init
from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.kernels import dispatch

Params = Dict


def init_device(gen: torch.Generator, device) -> torch.device:
    """Where an initializer puts its params: ``device``, else the
    generator's device."""
    return torch.device(device) if device is not None else gen.device


def dot_f32(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation and an f32 result.  PyTorch has no
    bf16 x bf16 -> f32 product, so 16-bit operands are upcast first, as
    the JAX package does on the CPU; callers keep the operands small (decode
    passes the cache's first ``k_len`` positions only)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.einsum(subscripts, a, b)
    return torch.einsum(subscripts, a.float(), b.float())


# --------------------------------------------------------------------------
# norms / rotary / misc
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (d/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# attention core
# --------------------------------------------------------------------------

def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: Optional[int] = None,
                     cap: Optional[float] = None,
                     q_positions: Optional[torch.Tensor] = None,
                     k_positions: Optional[torch.Tensor] = None,
                     k_len: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Grouped scaled-dot-product attention, the JAX package's arithmetic.

    q: (B, Sq, Hq, Dh); k, v: (B, Sk, Hkv, Dh) with Hq % Hkv == 0.
    window: keys with q_pos - k_pos < window are seen.  k_len: the number of
    valid keys (decode).  Returns (B, Sq, Hq, Dh) in q's dtype; logits and
    softmax in f32, the probabilities rounded to v's dtype for the PV
    product.
    """
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    if scale is None:
        scale = dh ** -0.5
    logits = dot_f32("bqkgd,bskd->bkgqs", qg, k) * scale
    logits = softcap(logits, cap)
    dev = q.device
    qpos = torch.arange(sq, device=dev) if q_positions is None else q_positions
    kpos = torch.arange(sk, device=dev) if k_positions is None else k_positions
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    if k_len is not None:
        mask &= kpos[None, :] < k_len
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = dot_f32("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def _partial_softmax(logits: torch.Tensor):
    """(max, sum, weights) of f32 ``logits`` (..., K) masked with -inf: the
    weights exp(logits - max), 0 where masked; a row with no key left has
    max -inf, sum 0 and weights 0 (never NaN)."""
    m = logits.amax(-1)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, torch.zeros_like(m))[..., None])
    return m, p.sum(-1), p


def merge_partials(m: torch.Tensor, s: torch.Tensor, o: torch.Tensor, mesh, axes
                   ) -> torch.Tensor:
    """Softmax-weighted values from the partials of the key blocks that the
    ranks of ``axes`` hold: ``m`` and ``s`` (...) this rank's running max
    and sum, ``o`` (..., D) its weighted values, f32.  The partials are
    all-gathered in one call (every rank joins, with or without a key) and
    merged in rank order: each block rescaled by exp(m_r - max), a block
    that saw no key (m_r = -inf) by 0.  No axes: o / s."""
    if axes:
        packed = torch.cat([o, s[..., None], m[..., None]], dim=-1)
        every = mesh.all_gather_tensor(packed[None], axes, 0)
        o, s, m = every[..., :-2], every[..., -2], every[..., -1]
        w = torch.exp(m - m.amax(0))
        o = (o * w[..., None]).sum(0)
        s = (s * w).sum(0)
    return o / s[..., None]


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, lo: int,
                    pos: Optional[int], window: Optional[int] = None,
                    cap: Optional[float] = None, mesh=None, axes=()) -> torch.Tensor:
    """Decode attention on one block of a cache split over the sequence:
    q (B, Sq, Hq, Dh) at position ``pos`` against the block's keys k, v
    (B, S_blk, Hkv, Dh) at global positions lo .. lo + S_blk - 1, of which
    those up to ``pos`` are read (all of them where ``pos`` is None: cross
    attention); the softcap and the window apply on global positions before
    the merge over the ranks of ``axes`` (:func:`merge_partials`).  A block
    past ``pos`` or outside the window adds exactly 0.  Returns (B, Sq, Hq,
    Dv) in q's dtype; the logits, the softmax and the products in f32."""
    b, sq, hq, dh = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    n = k.shape[1] if pos is None else max(0, min(k.shape[1], pos + 1 - lo))
    if n == 0:
        m = torch.full((b, hkv, g, sq), float("-inf"), dtype=torch.float32, device=q.device)
        s, o = torch.zeros_like(m), torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                                                device=q.device)
    else:
        logits = dot_f32("bqkgd,bskd->bkgqs", q.reshape(b, sq, hkv, g, dh), k[:, :n]) \
            * dh ** -0.5
        logits = softcap(logits, cap)
        if pos is not None and window is not None:
            kpos = lo + torch.arange(n, device=q.device)
            logits = logits.masked_fill(~((pos - kpos) < window), float("-inf"))
        m, s, p = _partial_softmax(logits)
        o = dot_f32("bkgqs,bskd->bkgqd", p, v[:, :n])
    o = merge_partials(m, s, o, mesh, axes)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None, cap: Optional[float] = None,
                     backend: Optional[str] = "auto") -> torch.Tensor:
    """Full-sequence causal self-attention over q (B, S, Hq, Dh) and k, v
    (B, S, Hkv, Dh) on ``backend``: the flash attention kernel (in its
    autograd Function) on ``cuda``, :func:`attention_scores` otherwise
    (:func:`repro_torch.kernels.dispatch.flash_attention`)."""
    return dispatch.flash_attention(q, k, v, window=window, softcap=cap, backend=backend)


# --------------------------------------------------------------------------
# GQA attention layer
# --------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    a = cfg.attention
    d, hq, hkv, dh = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    dev = init_device(gen, device)
    p = dict(
        wq=lecun_normal(gen, (*lead, d, hq * dh), d, dev),
        wk=lecun_normal(gen, (*lead, d, hkv * dh), d, dev),
        wv=lecun_normal(gen, (*lead, d, hkv * dh), d, dev),
        wo=lecun_normal(gen, (*lead, hq * dh, d), hq * dh, dev),
    )
    if a.qkv_bias:
        p.update(bq=torch.zeros((*lead, hq * dh), device=dev),
                 bk=torch.zeros((*lead, hkv * dh), device=dev),
                 bv=torch.zeros((*lead, hkv * dh), device=dev))
    return p


def gqa_project_qkv(p: Params, x: torch.Tensor, a: AttentionConfig,
                    positions: torch.Tensor):
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if a.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, a.n_heads, a.head_dim)
    k = k.reshape(b, s, a.n_kv_heads, a.head_dim)
    v = v.reshape(b, s, a.n_kv_heads, a.head_dim)
    return apply_rope(q, positions, a.rope_theta), apply_rope(k, positions, a.rope_theta), v


def gqa_attention(p: Params, x: torch.Tensor, a: AttentionConfig, *,
                  window: Optional[int] = None,
                  backend: Optional[str] = "auto") -> torch.Tensor:
    """Full-sequence (prefill) GQA self-attention."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(p, x, a, torch.arange(s, device=x.device))
    o = causal_attention(q, k, v, window=window, cap=a.attn_softcap, backend=backend)
    return o.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def gqa_attention_bidir(p: Params, x: torch.Tensor, a: AttentionConfig, *,
                        backend: Optional[str] = "auto") -> torch.Tensor:
    """Full-sequence bidirectional GQA self-attention (whisper's encoder):
    every position sees every other, on ``backend`` as
    :func:`causal_attention` runs."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(p, x, a, torch.arange(s, device=x.device))
    o = dispatch.flash_attention(q, k, v, causal=False, softcap=a.attn_softcap,
                                 backend=backend)
    return o.reshape(b, s, -1) @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------------
# MLA attention layer (DeepSeek-V2): low-rank latent KV cache
# --------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    a = cfg.attention
    d, h = cfg.d_model, a.n_heads
    qk = a.qk_nope_dim + a.qk_rope_dim
    r = a.kv_lora_rank
    dev = init_device(gen, device)
    p = dict(
        wkv_a=lecun_normal(gen, (*lead, d, r + a.qk_rope_dim), d, dev),
        kv_norm=torch.zeros((*lead, r), device=dev),
        wk_b=lecun_normal(gen, (*lead, r, h * a.qk_nope_dim), r, dev),
        wv_b=lecun_normal(gen, (*lead, r, h * a.v_head_dim), r, dev),
        wo=lecun_normal(gen, (*lead, h * a.v_head_dim, d), h * a.v_head_dim, dev),
    )
    if a.q_lora_rank > 0:
        p["wq_a"] = lecun_normal(gen, (*lead, d, a.q_lora_rank), d, dev)
        p["q_norm"] = torch.zeros((*lead, a.q_lora_rank), device=dev)
        p["wq_b"] = lecun_normal(gen, (*lead, a.q_lora_rank, h * qk), a.q_lora_rank, dev)
    else:
        p["wq"] = lecun_normal(gen, (*lead, d, h * qk), d, dev)
    return p


def mla_queries(p: Params, x: torch.Tensor, a: AttentionConfig, eps: float,
                positions: torch.Tensor):
    """Returns (q_nope (B, S, H, nope), q_rope (B, S, H, rope))."""
    b, s, _ = x.shape
    if a.q_lora_rank > 0:
        ql = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], eps)
        q = ql @ p["wq_b"].to(x.dtype)
    else:
        q = x @ p["wq"].to(x.dtype)
    q = q.reshape(b, s, a.n_heads, a.qk_nope_dim + a.qk_rope_dim)
    q_nope, q_rope = q.split([a.qk_nope_dim, a.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, a.rope_theta)


def mla_latent(p: Params, x: torch.Tensor, a: AttentionConfig, eps: float,
               positions: torch.Tensor):
    """Compress x -> (c_kv (B, S, R) normalised latent, k_rope (B, S, 1,
    rope)): the pair is the decode-time cache."""
    b, s, _ = x.shape
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_rope = kv.split([a.kv_lora_rank, a.qk_rope_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], eps)
    k_rope = apply_rope(k_rope.reshape(b, s, 1, a.qk_rope_dim), positions, a.rope_theta)
    return c_kv, k_rope


def mla_attention(p: Params, x: torch.Tensor, a: AttentionConfig, eps: float,
                  latent=None) -> torch.Tensor:
    """Full-sequence MLA (train / prefill): the latent expanded to per-head
    K and V, then the transcription :func:`attention_scores` at scale
    (nope + rope)^-0.5.  ``latent``: :func:`mla_latent`'s output for x at
    positions 0..S-1, where the caller has it (prefill caches it)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = mla_queries(p, x, a, eps, positions)
    c_kv, k_rope = mla_latent(p, x, a, eps, positions) if latent is None else latent
    k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(b, s, a.n_heads, a.qk_nope_dim)
    v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(b, s, a.n_heads, a.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, a.n_heads, a.qk_rope_dim)], dim=-1)
    scale = (a.qk_nope_dim + a.qk_rope_dim) ** -0.5
    o = attention_scores(q, k, v, causal=True, cap=a.attn_softcap, scale=scale)
    return o.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def mla_block_attention(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
                        krope: torch.Tensor, *, lo: int, pos: int, cap: Optional[float],
                        scale: float, mesh=None, axes=()) -> torch.Tensor:
    """MLA's absorbed decode on one block of the latent cache split over the
    sequence: q_lat (B, S, H, R) and q_rope (B, S, H, rope) against the
    block's ckv (B, S_blk, R) and krope (B, S_blk, rope) at global positions
    lo .., those up to ``pos`` read, merged over the ranks of ``axes`` as
    :func:`block_attention` merges.  Returns o_lat (B, S, H, R) f32."""
    b, sq, h, r = q_lat.shape
    n = max(0, min(ckv.shape[1], pos + 1 - lo))
    if n == 0:
        m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q_lat.device)
        s, o = torch.zeros_like(m), torch.zeros((b, h, sq, r), dtype=torch.float32,
                                                device=q_lat.device)
    else:
        logits = (dot_f32("bshr,bkr->bhsk", q_lat, ckv[:, :n]) +
                  dot_f32("bshn,bkn->bhsk", q_rope, krope[:, :n]))
        m, s, p = _partial_softmax(softcap(logits * scale, cap))
        o = dot_f32("bhsk,bkr->bhsr", p, ckv[:, :n])
    return merge_partials(m, s, o, mesh, axes).permute(0, 2, 1, 3)


def mla_decode_attention(p: Params, x: torch.Tensor, a: AttentionConfig, eps: float,
                         cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
                         cache_len: int, view=None) -> torch.Tensor:
    """Absorbed-matmul MLA decode: the queries are mapped into the latent
    space (q_nope . wk_b per head) and attend to the R-wide latent cache
    directly.  x: (B, S, D) at positions ``cache_len`` ..; cache_ckv (B,
    Smax, R) and cache_krope (B, Smax, rope) already hold them.  Only the
    first ``cache_len + 1`` positions are attended: the reference masks the
    rest to -1e30 (softmax weight exactly 0).  ``view``: a serving view
    over a mesh (:class:`repro_torch.sharding.serve.MeshView`), whose cache
    is this rank's block of the sequence: the block's partial softmax,
    merged over the ranks that split it (:func:`mla_block_attention`)."""
    b, s, _ = x.shape
    h, rope, nope, dv = a.n_heads, a.qk_rope_dim, a.qk_nope_dim, a.v_head_dim
    r = a.kv_lora_rank
    positions = cache_len + torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope = mla_queries(p, x, a, eps, positions)
    wk_b = p["wk_b"].to(x.dtype).reshape(r, h, nope)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
    if view is not None and view.mesh is not None:
        o_lat = view.attend_latent(q_lat, q_rope, cache_ckv, cache_krope, cache_len,
                                   scale=(nope + rope) ** -0.5, cap=a.attn_softcap)
    else:
        ckv, krope = cache_ckv[:, :cache_len + 1], cache_krope[:, :cache_len + 1]
        logits = (dot_f32("bshr,bkr->bhsk", q_lat, ckv) +
                  dot_f32("bshn,bkn->bhsk", q_rope, krope))
        logits = softcap(logits * ((nope + rope) ** -0.5), a.attn_softcap)
        probs = torch.softmax(logits, dim=-1)
        o_lat = dot_f32("bhsk,bkr->bshr", probs.to(ckv.dtype), ckv)
    wv_b = p["wv_b"].to(x.dtype).reshape(r, h, dv)
    o = torch.einsum("bshr,rhd->bshd", o_lat.to(x.dtype), wv_b)
    return o.reshape(b, s, -1) @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------------
# dense gated-MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, device=None,
             lead=()) -> Params:
    dev = init_device(gen, device)
    return dict(
        w_gate=lecun_normal(gen, (*lead, d_model, d_ff), d_model, dev),
        w_up=lecun_normal(gen, (*lead, d_model, d_ff), d_model, dev),
        w_down=lecun_normal(gen, (*lead, d_ff, d_model), d_ff, dev),
    )


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab_padded: int, d_model: int,
               device=None) -> torch.Tensor:
    return normal_init(gen, (vocab_padded, d_model), 0.02, init_device(gen, device))


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return table[tokens].to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., D) -> logits (..., Vp) in f32."""
    return torch.einsum("...d,vd->...v", x.float(), table.float())
