"""The analytical H100 roofline of the port, the counterpart of the JAX
package's ``repro/roofline/analysis.py``.

The JAX package reads FLOPs and bytes from compiled HLO; the port counts
them from the configs.  Two layers:

* the bounds of the paths ``chip_smoke.py`` times (a prefill, a decode
  step, a training step of each family), each the least time one H100
  could take: the larger of the bytes the path must move over HBM's rate
  and its FLOPs over the peak of the units that do them
  (:mod:`repro_torch.roofline.constants`);
* the three-term analysis of every (arch x shape) cell, from the same
  functions at the cell's batch and length::

      T_compute  = bf16 FLOPs / bf16 peak + fp32 FLOPs / fp32 peak
      T_memory   = bytes / HBM rate
      T_coll     = 0 on one card; on a mesh the step's collectives' wire bytes
                   at the links' rates (:func:`lm_step_payloads`)
      bottleneck = argmax of the three
      MODEL_FLOPS = 6 N_active D (train; 2 N_active D for an inference pass)
      useful ratio = MODEL_FLOPS / the bound's FLOPs
      roofline fraction = T_ideal / T_bound,  T_ideal = MODEL_FLOPS / bf16 peak

and the wire bytes and link times of the data-parallel meta-training step
(:func:`dp_payloads`, :func:`dp_wire_bytes`, :func:`dp_collective_ms`).

``load_table(path, mesh)`` reads the same rows from the dry run's records
(:mod:`repro_torch.launch.dryrun`): FLOPs, bytes and payloads counted on
one rank's traced step, not from the configs.

``analyze_cell(arch, shape, mesh=)`` also reads a cell on the
production LM mesh, ``"single"`` (data 16 x model 16, 256 H100s) or
``"multi"`` (2 x 16 x 16, 512), as the port's sharded step runs it
(:mod:`repro_torch.sharding`): the dense compute split over the data
ranks and replicated over ``model``, the experts of an expert-parallel
layer over every chip; the state per chip the sanitized rules' blocks;
T_coll the payloads of :func:`lm_step_payloads` through the ring factors,
a ``model`` group of at most 8 cards (one node) on NVLink and every other
group on InfiniBand.  A mesh's prefill and decode cells read
``api.prefill`` and ``api.decode_step`` on placed params and cache
(:mod:`repro_torch.sharding.serve`): the dense compute split over the
ranks the rows split over, the state a chip its params' and cache's
blocks, T_coll the payloads of :func:`lm_serve_payloads`.

Every number here is derived from NVIDIA's data-sheet peaks; none is
measured.  The model modules are imported inside the functions that need
them, so importing the roofline imports no model code.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

from repro_torch.common.tree import tree_leaves, tree_paths
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
from repro_torch.optim.quant import BLOCK as QUANT_BLOCK
from repro_torch.roofline.constants import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES, HBM_BYTES_PER_S,
                                            IB_BYTES_PER_S, NVLINK_BYTES_PER_S)

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over HBM's
    rate and ``flops`` over ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one head."""
    if not causal:
        return s * s if window is None else sum(s - max(0, q - window + 1) for q in range(s))
    if window is None:
        return s * (s + 1) // 2
    return sum(min(q + 1, window) for q in range(s))


def flash_bwd_work(b: int, s: int, hq: int, hkv: int, d: int, itemsize: int, causal: bool,
                   window) -> tuple:
    """(bytes, FLOPs) of flash attention's backward (``flash_attention_gqa_bwd``)
    on q, o, do (b, s, hq, d), k, v (b, s, hkv, d): q, k, v, o, do and the
    fp32 lse (b, hq, s) read once, dq, dk and dv written once, in the
    inputs' dtype; 10 d FLOPs a seen (query, key) pair of a query head (q
    k^T and do v^T recomputed, dv, dk and dq: five products of 2 d), as
    :func:`attn_pairs` counts the pairs."""
    nbytes = itemsize * (4 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s
    return nbytes, 10.0 * d * b * hq * attn_pairs(s, causal, window)


def ssd_bwd_work(g: int, q: int, p: int, n: int, itemsize: int,
                 cotangents=(True, True, True, True)) -> tuple:
    """(bytes, FLOPs) of the SSD chunk's backward (``ssd_chunk_bwd``) on G
    chunks of q steps: x, dt, A, B, C read once in their dtype, the fp32
    cotangents that are given (gy, gst, gcd, gsd) read once, the fp32 gx,
    gdt, gA, gB, gC written once; the products counted once below the
    diagonal (C B^T, gy u^T, M^T gy, G2 B, G2^T C: 2 (3 n + 2 p) FLOPs a pair
    (l >= s) with gy) and the state's two (B gst^T, x gst: 4 q p n with
    gst)."""
    gy, gst, gcd, gsd = cotangents
    ins = itemsize * (q * p + q + 1 + 2 * q * n)
    cots = 4 * (gy * q * p + gst * p * n + gcd + gsd * q)
    outs = 4 * (q * p + q + 1 + 2 * q * n)
    pairs = q * (q + 1) // 2
    flops = gy * 2.0 * pairs * (3 * n + 2 * p) + gst * 4.0 * q * p * n
    return g * (ins + cots + outs), g * flops


# -- training state ----------------------------------------------------------

def state_bytes(n_params: int, state_dtype: str, param_dtype: str) -> int:
    """Bytes of the training state of ``n_params`` params: the params and
    their gradients in ``param_dtype``, AdamW's mu and nu in
    ``state_dtype``: 16 a param in fp32, 8 in bf16.  An int8 moment
    carries an fp32 scale for each block of QUANT_BLOCK values
    (``optim/quant.py``); a leaf's padding to whole blocks is not
    counted."""
    p = _ITEMSIZE[param_dtype]
    if state_dtype == "int8":
        return 2 * p * n_params + 2 * (n_params + 4 * n_params // QUANT_BLOCK)
    return 2 * p * n_params + 2 * _ITEMSIZE[state_dtype] * n_params


def adamw_update_bytes(n_params: int, cfg: ModelConfig) -> float:
    """Bytes AdamW's update moves: the params, mu and nu each read once and
    written once, that is the training state (:func:`state_bytes`) but the
    gradients, twice."""
    state = state_bytes(n_params, cfg.opt_state_dtype, cfg.param_dtype)
    return 2.0 * (state - _ITEMSIZE[cfg.param_dtype] * n_params)


# -- dense GQA transformers ----------------------------------------------------

def lm_work(cfg: ModelConfig, s: int, b: int, k_len: int):
    """((prefill bytes, FLOPs), (decode bytes, FLOPs)) of :func:`lm_bounds`.
    A layer with a sliding window attends to (and a decode step reads the
    cache of) at most its window's keys."""
    from repro_torch.models.transformer import layer_windows
    a = cfg.attention
    windows = layer_windows(cfg)
    per_layer = cfg.d_model * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim \
        + a.n_heads * a.head_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    weights = 2.0 * cfg.n_layers * per_layer + 4.0 * cfg.vocab_padded * cfg.d_model
    head_flops = 2.0 * cfg.d_model * cfg.vocab_padded
    pairs = sum(attn_pairs(s, True, w if w < s else None) for w in windows)
    flops = 2.0 * cfg.n_layers * per_layer * s + head_flops \
        + 4.0 * a.head_dim * a.n_heads * pairs
    keys = sum(min(k_len, w) for w in windows)
    cache = 2.0 * 2 * b * keys * a.n_kv_heads * a.head_dim
    decode = b * (2.0 * cfg.n_layers * per_layer + head_flops
                  + 4.0 * a.head_dim * a.n_heads * keys)
    return (weights, flops), (weights + cache, decode)


def lm_bounds(cfg: ModelConfig, s: int, b: int, k_len: int):
    """(prefill bound ms, by; decode bound ms, by).  The bytes: the layers'
    matmul weights in bf16 and the fp32 LM head, each read once (the
    embedding's rows are a gather), and for decode the cache's k_len
    positions of b slots.  The FLOPs, at the bf16 tensor-core peak:
    prefill of s tokens (the matmuls, causal attention's pairs, the last
    token's LM head); a decode step of b tokens (the matmuls, attention
    over the k_len keys, the head)."""
    (pb, pf), (db, df) = lm_work(cfg, s, b, k_len)
    return bound_ms(pb, pf, BF16_FLOPS), bound_ms(db, df, BF16_FLOPS)


def pretrain_bound(cfg: ModelConfig, b: int, s: int):
    """(bound ms, bf16 FLOPs, f32 FLOPs) of one step, forward and backward
    (3x the forward's FLOPs, the checkpoints' recompute not counted): the
    trunk's weight matmuls and attention (causal pairs within each layer's
    window) on the bf16 tensor cores, the f32 unembed at the fp32 rate; the
    two in sequence, since each waits on the other's output."""
    a = cfg.attention
    d, hq, hkv, dh, f = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim, cfg.d_ff
    per_token = 2 * (d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * f)
    from repro_torch.models.transformer import layer_windows
    pairs = sum(attn_pairs(s, True, w if w < s else None) for w in layer_windows(cfg))
    bf16 = 3 * (cfg.n_layers * per_token * b * s + 4.0 * dh * b * hq * pairs)
    f32 = 3 * 2.0 * b * s * cfg.vocab_padded * d
    return (bf16 / BF16_FLOPS + f32 / FP32_FLOPS) * 1e3, bf16, f32


# -- MoE and MLA transformers ------------------------------------------------------

def _moe_attention(cfg: ModelConfig):
    """(attention matmul weights of a layer, FLOPs of one (query, key) pair
    over every head, cached values a position of a layer) of an MLA or GQA
    config."""
    a = cfg.attention
    if a.kind == "mla":
        qk, h = a.qk_nope_dim + a.qk_rope_dim, a.n_heads
        attn = (cfg.d_model * a.q_lora_rank + a.q_lora_rank * h * qk
                + cfg.d_model * (a.kv_lora_rank + a.qk_rope_dim)
                + a.kv_lora_rank * h * (a.qk_nope_dim + a.v_head_dim)
                + h * a.v_head_dim * cfg.d_model)
        return attn, 2.0 * h * (qk + a.v_head_dim), a.kv_lora_rank + a.qk_rope_dim
    attn = cfg.d_model * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim \
        + a.n_heads * a.head_dim * cfg.d_model
    return attn, 4.0 * a.n_heads * a.head_dim, 2 * a.n_kv_heads * a.head_dim


def moe_work(cfg: ModelConfig, s: int, b: int, k_len: int):
    """((prefill bytes, FLOPs), (decode bytes, FLOPs)) of :func:`moe_bounds`."""
    m = cfg.moe
    attn, pair_flops, cache_row = _moe_attention(cfg)
    experts = 3 * m.n_experts * cfg.d_model * m.d_ff
    active = 3 * (m.top_k + m.n_shared) * cfg.d_model * m.d_ff + cfg.d_model * m.n_experts
    shared = 3 * m.n_shared * cfg.d_model * m.d_ff
    head = cfg.vocab_padded * cfg.d_model
    weights = 2.0 * (cfg.n_layers * (attn + experts + shared + cfg.d_model * m.n_experts)
                     + head)
    per_token = 2.0 * cfg.n_layers * (attn + active)
    prefill = per_token * s + 2.0 * head + cfg.n_layers * pair_flops * attn_pairs(s, True, None)
    cache = 2.0 * b * k_len * cfg.n_layers * cache_row
    decode = b * (per_token + 2.0 * head + cfg.n_layers * pair_flops * k_len)
    return (weights, prefill), (weights + cache, decode)


def moe_bounds(cfg: ModelConfig, s: int, b: int, k_len: int):
    """(prefill bound ms, by; decode bound ms, by).  The bytes: every bf16
    weight read once, every expert's included (the capacity buffer runs
    each expert, tokens or none), the LM head once (the embedding's rows
    are a gather), and for decode the cache's k_len positions of b slots.
    The FLOPs, at the bf16 tensor-core peak, count what the tokens need:
    the attention projections, causal attention's pairs, k experts and the
    shared ones a token, the router, the last token's (decode: each
    token's) LM head."""
    (pb, pf), (db, df) = moe_work(cfg, s, b, k_len)
    return bound_ms(pb, pf, BF16_FLOPS), bound_ms(db, df, BF16_FLOPS)


def moe_train_bound(cfg: ModelConfig, b: int, s: int, kept: int, n_params: int):
    """(bound ms, by, bf16 FLOPs, f32 FLOPs, bytes) of one training step.
    FLOPs: 3x the forward's (the checkpoints' recompute not counted): the
    attention projections, the shared experts and the ``kept`` routes'
    expert projections (this batch's routing, summed over the layers) on the bf16 tensor cores, GQA
    attention's causal pairs there too (B5); MLA's transcription (causal
    pairs), the router and the unembed in fp32, at the fp32 rate, in
    sequence with the bf16 work.  Bytes: AdamW's update of ``n_params``
    params (:func:`adamw_update_bytes`; bf16 params, mu and nu read once and
    written once)."""
    m = cfg.moe
    attn, pair_flops, _ = _moe_attention(cfg)
    shared = 3 * m.n_shared * cfg.d_model * m.d_ff
    t = b * s
    bf16 = 3 * 2.0 * (cfg.n_layers * t * (attn + shared) + kept * 3 * cfg.d_model * m.d_ff)
    f32 = 3 * 2.0 * (cfg.n_layers * t * cfg.d_model * m.n_experts
                     + t * cfg.vocab_padded * cfg.d_model)
    pairs = 3 * cfg.n_layers * pair_flops * b * attn_pairs(s, True, None)
    if cfg.attention.kind == "mla":
        f32 += pairs
    else:
        bf16 += pairs
    nbytes = adamw_update_bytes(n_params, cfg)
    t_ops = (bf16 / BF16_FLOPS + f32 / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", bf16, f32,
            nbytes)


# -- mamba2 and the zamba2 hybrid -------------------------------------------------

def ssm_shape(cfg: ModelConfig):
    """(mamba layers, shared sites, SSD heads) of an SSM or hybrid config."""
    from repro_torch.models import zamba2 as TZ
    if cfg.family == "hybrid":
        return TZ.n_mamba_layers(cfg), TZ.layout(cfg)[0], cfg.ssm.n_heads(cfg.d_model)
    return cfg.n_layers, 0, cfg.ssm.n_heads(cfg.d_model)


def _shared_block(cfg: ModelConfig) -> int:
    """Matmul weights of the hybrid's shared attention and MLP block."""
    a, d = cfg.attention, cfg.d_model
    return d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim + a.n_heads * a.head_dim * d \
        + 3 * d * cfg.d_ff


def ssm_flops(cfg: ModelConfig, s: int) -> float:
    """The forward FLOPs of one sequence of ``s`` tokens through the trunk of
    an SSM or hybrid config (weight matmuls, the SSD, the shared block's
    causal attention), without the LM head."""
    from repro_torch.models import mamba2 as TM
    sc = cfg.ssm
    nm, sites, h = ssm_shape(cfg)
    d, di, p, n, q = cfg.d_model, sc.d_inner(cfg.d_model), sc.head_dim, sc.d_state, \
        sc.chunk_size
    mm = d * TM.in_proj_dim(cfg) + di * d
    chunks = -(-s // q)
    ssd = h * (chunks * (q * (q + 1) * (n + p) + 2.0 * q * p * n) + 2.0 * s * p * n)
    flops = nm * (2.0 * mm * s + ssd)
    if sites:
        a = cfg.attention
        flops += sites * (2.0 * _shared_block(cfg) * s + 4.0 * a.head_dim * a.n_heads
                          * attn_pairs(s, True, None))
    return flops


def ssm_work(cfg: ModelConfig, s: int, b: int, k_len: int):
    """((prefill bytes, FLOPs), (decode bytes, FLOPs)) of :func:`ssm_bounds`."""
    from repro_torch.models import mamba2 as TM
    sc = cfg.ssm
    nm, sites, h = ssm_shape(cfg)
    d, di, p, n = cfg.d_model, sc.d_inner(cfg.d_model), sc.head_dim, sc.d_state
    c = TM.conv_dim(cfg)
    mm = d * TM.in_proj_dim(cfg) + di * d                          # a mamba block's matmuls
    shared, cache, attn = 0, 0.0, 0.0
    if sites:
        a = cfg.attention
        shared = _shared_block(cfg)
        cache = 2.0 * 2 * b * k_len * sites * a.n_kv_heads * a.head_dim
        attn = sites * (2.0 * shared + 4.0 * a.head_dim * a.n_heads * k_len)
    weights = 2.0 * (nm * (mm + c * sc.d_conv + c) + shared) + 4.0 * nm * (3 * h + d + di) \
        + 4.0 * cfg.vocab_padded * d
    head = 2.0 * d * cfg.vocab_padded
    states = 2.0 * nm * b * (2 * c * (sc.d_conv - 1) + 4 * h * p * n)
    dec_flops = b * (nm * (2.0 * mm + 4.0 * h * p * n) + attn + head)
    return (weights, ssm_flops(cfg, s) + head), (weights + states + cache, dec_flops)


def ssm_bounds(cfg: ModelConfig, s: int, b: int, k_len: int):
    """(prefill bound ms, by; decode bound ms, by) of ``cfg`` (mamba2 or
    zamba2).  The bytes: the mamba blocks' and the shared block's matmul
    and conv weights in bf16, their fp32 SSM parameters and norms, the fp32
    tied embedding read once by the LM head; a decode step of ``b`` slots
    also reads and writes every layer's conv and fp32 SSM states and reads
    each site's first ``k_len`` cached keys and values.  The FLOPs, at the
    bf16 tensor-core peak: prefill of ``s`` tokens (:func:`ssm_flops`, and
    the last token's head); a decode step of ``b`` tokens (the weight
    matmuls, the state update and read-out, attention over ``k_len`` keys,
    the head)."""
    (pb, pf), (db, df) = ssm_work(cfg, s, b, k_len)
    return bound_ms(pb, pf, BF16_FLOPS), bound_ms(db, df, BF16_FLOPS)


def ssm_train_bound(cfg: ModelConfig, b: int, s: int):
    """(bound ms, bf16 FLOPs, f32 FLOPs) of one training step of an SSM or
    hybrid config: the forward's FLOPs three times (the recompute not
    counted) at the bf16 peak, the fp32 unembed at the fp32 rate."""
    bf16 = 3 * b * ssm_flops(cfg, s)
    f32 = 3 * 2.0 * b * s * cfg.vocab_padded * cfg.d_model
    return (bf16 / BF16_FLOPS + f32 / FP32_FLOPS) * 1e3, bf16, f32


# -- the whisper encoder-decoder -----------------------------------------------------

def _whisper_attn(cfg: ModelConfig):
    """(matmul weights of a self-attention and MLP block, of the cross
    attention's q and o projections, of its k and v projections; the
    attention FLOPs of one (query, key) pair over every head)."""
    a = cfg.attention
    d, hd, kvd = cfg.d_model, a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    block = d * (hd + 2 * kvd) + hd * d + 3 * d * cfg.d_ff
    return block, 2 * d * hd, 2 * d * hd, 4.0 * a.head_dim * a.n_heads


def whisper_fwd_flops(cfg: ModelConfig, s: int) -> float:
    """The forward FLOPs of one sequence: the encoder over its frames
    (bidirectional attention), the decoder over ``s`` tokens (causal
    self-attention, cross attention to every frame, the cross k and v
    projections of the frames), without the LM head."""
    block, cross_qo, cross_kv, pair = _whisper_attn(cfg)
    se = cfg.n_frontend_tokens
    enc = cfg.n_encoder_layers * (2.0 * block * se + pair * se * se)
    dec = cfg.n_layers * (2.0 * (block + cross_qo) * s + 2.0 * cross_kv * se
                          + pair * (attn_pairs(s, True, None) + s * se))
    return enc + dec


def whisper_work(cfg: ModelConfig, s: int, b: int, k_len: int):
    """((prefill bytes, FLOPs), (decode bytes, FLOPs)) of :func:`whisper_bounds`."""
    block, cross_qo, cross_kv, pair = _whisper_attn(cfg)
    a, d, se, nl = cfg.attention, cfg.d_model, cfg.n_frontend_tokens, cfg.n_layers
    head_bytes, head_flops = 4.0 * cfg.vocab_padded * d, 2.0 * d * cfg.vocab_padded
    pre_bytes = 2.0 * (cfg.n_encoder_layers * block + nl * (block + cross_qo + cross_kv)) \
        + head_bytes
    dec_weights = nl * (block + cross_qo)
    cache = 2.0 * 2 * b * nl * (k_len * a.n_kv_heads + se * a.n_heads) * a.head_dim
    dec_flops = b * (2.0 * dec_weights + nl * pair * (k_len + se) + head_flops)
    return ((pre_bytes, whisper_fwd_flops(cfg, s) + head_flops),
            (2.0 * dec_weights + head_bytes + cache, dec_flops))


def whisper_bounds(cfg: ModelConfig, s: int, b: int, k_len: int):
    """(prefill bound ms, by; decode bound ms, by).  Prefill of one prompt of
    ``s`` tokens: every matmul weight of both stacks in bf16 and the fp32
    tied embedding (the LM head) read once, :func:`whisper_fwd_flops` and
    the last token's head at the bf16 tensor-core peak.  A decode step of
    ``b`` slots: the decoder's weights but the cross k and v projections
    (bf16) and the fp32 head read once, each slot's ``k_len`` cached keys
    and values and its cross k and v of every frame (bf16) read once; the
    FLOPs of its weight matmuls, attention over ``k_len`` keys and every
    frame, and the head."""
    (pb, pf), (db, df) = whisper_work(cfg, s, b, k_len)
    return bound_ms(pb, pf, BF16_FLOPS), bound_ms(db, df, BF16_FLOPS)


def whisper_train_bound(cfg: ModelConfig, b: int, s: int):
    """(bound ms, bf16 FLOPs, f32 FLOPs) of one training step of ``b``
    sequences of ``s`` tokens over their frames: the forward's FLOPs three
    times (the recompute not counted) at the bf16 peak, the fp32 unembed at
    the fp32 rate."""
    bf16 = 3 * b * whisper_fwd_flops(cfg, s)
    f32 = 3 * 2.0 * b * s * cfg.vocab_padded * cfg.d_model
    return (bf16 / BF16_FLOPS + f32 / FP32_FLOPS) * 1e3, bf16, f32


# -- the (arch x shape) cells ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree_counts(cfg: ModelConfig):
    """(total, active, embed, bytes) of ``cfg``'s abstract params."""
    from repro_torch.launch.specs import abstract_params_for
    total = active = embed = 0.0
    nbytes = 0
    for path, leaf in tree_paths(abstract_params_for(cfg)).items():
        n = float(leaf.numel())
        total += n
        nbytes += leaf.numel() * leaf.element_size()
        if path.split("/")[-1] in ("embed", "lm_head"):
            embed += n                      # embeddings excluded from 6ND flops
        elif cfg.moe is not None and "ffn" in path and leaf.dim() >= 3 \
                and leaf.shape[-3] == cfg.moe.n_experts:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return total, active, embed, nbytes


def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    """(total, active, embed) parameter counts from the abstract param tree.
    Expert banks (3D+ leaves under 'ffn' with leading E) count at top_k / E
    toward active; ``embed`` and ``lm_head`` leaves count toward embed, not
    active."""
    total, active, embed, _ = _tree_counts(cfg)
    return dict(total=total, active=active, embed=embed)


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Global MODEL_FLOPS for one step of this cell."""
    s = SHAPES_BY_NAME[shape_name]
    n_active = param_counts(cfg)["active"]
    if s.kind == "train":
        tokens = s.global_batch * s.seq_len
        return 6.0 * n_active * tokens
    if s.kind == "prefill":
        tokens = s.global_batch * s.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * s.global_batch


def _serving_work(cfg: ModelConfig):
    if cfg.family in ("mamba2", "hybrid"):
        return ssm_work
    if cfg.family == "encdec":
        return whisper_work
    return moe_work if cfg.moe is not None else lm_work


def cell_work(cfg: ModelConfig, shape: ShapeSpec):
    """(bytes, bf16 FLOPs, f32 FLOPs) of one step of the cell, from the
    family's bound function at the cell's batch B and length S: a training
    step of B x S (its bytes AdamW's update; an MoE step keeps every route,
    top_k a token in every layer); a prefill of B prompts of S tokens (the
    weights read once, B times one prompt's FLOPs); a decode step of B
    slots against an S-deep cache."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        n = param_counts(cfg)["total"]
        if cfg.moe is not None:
            kept = cfg.n_layers * b * s * cfg.moe.top_k
            _, _, bf16, f32, nbytes = moe_train_bound(cfg, b, s, kept, n)
            return nbytes, bf16, f32
        train = {"mamba2": ssm_train_bound, "hybrid": ssm_train_bound,
                 "encdec": whisper_train_bound}.get(cfg.family, pretrain_bound)
        _, bf16, f32 = train(cfg, b, s)
        return adamw_update_bytes(n, cfg), bf16, f32
    work = _serving_work(cfg)
    if shape.kind == "prefill":
        nbytes, flops = work(cfg, s, 1, s)[0]
        return nbytes, b * flops, 0.0
    nbytes, flops = work(cfg, 1, b, s)[1]
    return nbytes, flops, 0.0


def _state_bytes_of_cell(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Device bytes the cell holds before activations: the training state
    (:func:`state_bytes`); the params for prefill; the params and the cache
    for decode."""
    total, _, _, param_bytes = _tree_counts(cfg)
    if shape.kind == "train":
        return state_bytes(int(total), cfg.opt_state_dtype, cfg.param_dtype)
    if shape.kind == "prefill":
        return param_bytes
    from repro_torch.launch.specs import abstract_cache_for
    cache = abstract_cache_for(cfg, shape)
    return param_bytes + sum(t.numel() * t.element_size() for t in tree_leaves(cache)
                             if hasattr(t, "numel"))


def analyze_cell(arch: str, shape_name: str, mesh: Optional[str] = None) -> Dict:
    """The three-term roofline of one (arch x shape) cell, with the JAX
    package's keys: on one H100 (``mesh=None``; the row's ``mesh`` is
    "single", ``chips`` 1), or on the production mesh ``"single"`` (256
    chips) or ``"multi"`` (512, :func:`mesh_cell`).  A cell that
    :func:`cell_supported` refuses gives its ``skipped`` row."""
    ok, reason = cell_supported(arch, shape_name)
    if not ok:
        return dict(arch=arch, shape=shape_name, mesh=mesh or "single", skipped=reason[:60])
    if mesh is not None:
        return mesh_cell(arch, shape_name, mesh)
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    nbytes, bf16, f32 = cell_work(cfg, shape)
    t_compute = bf16 / BF16_FLOPS + f32 / FP32_FLOPS
    t_memory = nbytes / HBM_BYTES_PER_S
    terms = dict(compute=t_compute, memory=t_memory, collective=0.0)
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_name)
    state = _state_bytes_of_cell(cfg, shape)
    return dict(
        arch=arch, shape=shape_name, mesh="single", chips=1,
        t_compute=t_compute, t_memory=t_memory, t_collective=0.0,
        bottleneck=bottleneck,
        model_flops=mf, useful_ratio=mf / max(bf16 + f32, 1.0),
        roofline_fraction=mf / BF16_FLOPS / max(terms.values()),
        state_bytes_per_device=state,
        hbm_headroom_gib=(HBM_BYTES - state) / 2**30,
    )


def ring_all_reduce_bytes(nbytes: int, g: int) -> float:
    """Bytes one rank sends in a ring all-reduce of ``nbytes`` over ``g``
    ranks: 2 (g - 1) / g of the buffer (none in a group of one)."""
    return 2.0 * (g - 1) / g * nbytes if g > 1 else 0.0


def all_gather_bytes(nbytes: int, g: int) -> float:
    """Bytes one rank sends in an all-gather of its ``nbytes`` over ``g``
    ranks: its part to each of the g - 1 others."""
    return float((g - 1) * nbytes)


def dp_payloads(n_param_bytes: int, grad_reduce: str = "pmean",
                scale_bytes: Optional[int] = None) -> Dict[str, int]:
    """The bytes one rank hands the collectives of one step of the
    two-level data-parallel meta-training step
    (:func:`repro_torch.core.episodic_train.make_batched_meta_train_step`),
    by ``kind/axis`` as :mod:`repro_torch.launch.collectives` counts them,
    for fp32 params of ``n_param_bytes``.  Over ``data``: one all-reduce of
    the gradient with the loss and accuracy (8 bytes).  Over ``dcn``: the
    int32 finite verdict, then the same all-reduce (``pmean``), or the loss
    and accuracy and two all-gathers, of the int8 payload (one byte a
    parameter) and of the fp32 block scales, ``scale_bytes`` of them
    (``compressed``: :func:`repro_torch.optim.compress.compressed_scale_bytes`
    of the params).  A 1-D mesh makes the ``data`` all-reduce alone."""
    buf = n_param_bytes + 8
    if grad_reduce == "pmean":
        return {"all_reduce/data": buf, "all_reduce/dcn": 4 + buf}
    if scale_bytes is None:
        raise ValueError("grad_reduce='compressed' needs scale_bytes: "
                         "repro_torch.optim.compress.compressed_scale_bytes(params)")
    return {"all_reduce/data": buf, "all_reduce/dcn": 4 + 8,
            "all_gather/dcn": n_param_bytes // 4 + scale_bytes}


def dp_wire_stages(n_param_bytes: int, dp: int, dcn: int, grad_reduce: str = "pmean",
                   scale_bytes: Optional[int] = None) -> Dict[str, float]:
    """Bytes one rank sends over each mesh axis in one step on a (dcn, dp)
    mesh: :func:`dp_payloads` through the textbook algorithms, a ring
    all-reduce (:func:`ring_all_reduce_bytes`) and an all-gather
    (:func:`all_gather_bytes`) over the axis's ranks."""
    sizes = dict(data=dp, dcn=dcn)
    out = dict(data=0.0, dcn=0.0)
    for key, nbytes in dp_payloads(n_param_bytes, grad_reduce, scale_bytes).items():
        kind, axis = key.split("/")
        wire = ring_all_reduce_bytes if kind == "all_reduce" else all_gather_bytes
        out[axis] += wire(nbytes, sizes[axis])
    return out


def dp_wire_bytes(n_param_bytes: int, dp: int, dcn: int, grad_reduce: str = "pmean",
                  scale_bytes: Optional[int] = None) -> float:
    """The sum of :func:`dp_wire_stages`: the bytes one rank sends a step.
    At 2 x 2 with ``pmean`` it is 2.0 x the fp32 param bytes, plus 20 bytes
    of scalars."""
    return sum(dp_wire_stages(n_param_bytes, dp, dcn, grad_reduce, scale_bytes).values())


def dp_collective_ms(n_param_bytes: int, dp: int, dcn: int, grad_reduce: str = "pmean",
                     scale_bytes: Optional[int] = None) -> float:
    """The step's collectives at the links' rates: the ``data`` stage on
    NVLink, the ``dcn`` stage on InfiniBand, one after the other; derived
    from the data sheets, not measured."""
    st = dp_wire_stages(n_param_bytes, dp, dcn, grad_reduce, scale_bytes)
    return (st["data"] / NVLINK_BYTES_PER_S + st["dcn"] / IB_BYTES_PER_S) * 1e3


# -- the LM mesh -------------------------------------------------------------------------

PRODUCTION_MESHES = {"single": {"data": 16, "model": 16},
                     "multi": {"pod": 2, "data": 16, "model": 16}}
CARDS_PER_NODE = 8            # an H100 SXM node (NVIDIA's DGX H100)


class _MeshShape:
    """Axis sizes and nothing else: what the rules' ``sanitize`` reads."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _axes_label(names) -> str:
    return "+".join(names)


def _batch_axes(sizes: Dict[str, int], batch_axes=None) -> tuple:
    """The axes a batch splits over: ``batch_axes``, else (pod,) data."""
    if batch_axes is not None:
        return tuple(batch_axes)
    return ("pod", "data") if "pod" in sizes else ("data",)


def _reshard_payloads(block, src, dst, sizes: Dict[str, int], item: int):
    """The all-gathers :func:`repro_torch.sharding.place.reshard` makes to
    take a block of shape ``block`` under ``src`` to ``dst``: [(axes,
    bytes)], and the block's shape under ``dst``."""
    from repro_torch.sharding.ctx import entry_names
    cur, out = list(block), []
    moved = [d for d in range(len(cur)) if entry_names(src[d]) != entry_names(dst[d])]
    for d in moved:
        names = entry_names(src[d])
        if names and _prod(sizes[a] for a in names) > 1:
            out.append((names, _prod(cur) * item))
            cur[d] *= _prod(sizes[a] for a in names)
    for d in moved:
        names = entry_names(dst[d])
        if names:
            cur[d] //= _prod(sizes[a] for a in names)
    return out, bool(moved)


def ep_layer_payloads(cfg: ModelConfig, sizes: Dict[str, int], t_loc: int) -> Dict[str, int]:
    """The payloads one MoE layer of the sharded step hands its collectives
    on ``t_loc`` tokens a data shard, forward and backward (the forward's
    twice under a remat policy: the checkpoint's recompute runs it again),
    by ``kind/axis``, as ``transformer.moe_dispatch`` makes them.
    Expert-parallel: the reference's body moves 2 x T_loc x D a layer (its
    all-gather of the block, its reduce-scatter of y); the port's dense
    compute is whole on every model rank, so the layer also cuts its
    tokens to the block and gathers y back (Megatron's sequence-parallel
    pair), and the backward all-reduces the router's gradient over model.
    The fallback gathers the tokens over the data ranks."""
    from repro_torch.models.moe import ep_applies
    out: Dict[str, int] = {}

    def add(kind, names, nbytes, times=1):
        key = f"{kind}/{_axes_label(names)}"
        out[key] = out.get(key, 0) + nbytes * times

    m = cfg.moe
    dax = ("pod", "data") if "pod" in sizes else ("data",)
    n_data, n_model = _prod(sizes[a] for a in dax), sizes.get("model", 1)
    layout = cfg.activation_layout if cfg.shard_activations_model else "seq"
    d, item = cfg.d_model, _ITEMSIZE[cfg.compute_dtype]
    p_item = _ITEMSIZE[cfg.param_dtype]
    fwd = 2 if cfg.remat_policy != "none" else 1
    x = t_loc * d * item
    if not cfg.moe_shard_map or (d if layout == "hidden" else t_loc) % n_model:
        if n_data > 1:
            add("all_gather", dax, x, fwd)
            add("all_reduce", dax, 4, fwd)
            add("reduce_scatter", dax, n_data * x)
        return out
    if n_model > 1:
        add("all_gather", ("model",), x // n_model, fwd)        # the body's gather
        add("reduce_scatter", ("model",), x)                     # its VJP
        add("all_gather", ("model",), x // n_model, fwd)        # y gathered back
        add("all_gather", ("model",), x // n_model)              # the cut's VJP
    if ep_applies(m, sizes, t_loc, d, layout):
        add("reduce_scatter", ("model",), x, fwd)                # y out of the body
        add("all_gather", ("model",), x // n_model)              # its VJP
        add("all_reduce", ("model",), d * m.n_experts * p_item)  # the router's gradient
    else:
        if n_model > 1:
            for w in (d * m.n_experts, 3 * m.n_experts * d * m.d_ff):
                add("all_reduce", ("model",), w * p_item)
        if n_data > 1:
            add("all_gather", dax, x, fwd)
            add("reduce_scatter", dax, n_data * x)
    if n_data > 1:
        add("all_reduce", dax, 4, fwd)                            # aux over data
    if n_model > 1:
        add("all_reduce", ("model",), 4, fwd)                     # aux over model
    return out


def lm_step_payloads(cfg: ModelConfig, mesh_shape: Dict[str, int], B: int, S: int,
                     state_dtype: Optional[str] = None, skip_nonfinite: bool = True,
                     batch_axes: Optional[tuple] = None) -> Dict[str, int]:
    """The bytes one rank hands the collectives of one sharded LM step
    (:func:`repro_torch.train.step.make_train_step` with ``mesh=``) on a B
    x S token batch, by ``kind/axis`` as :mod:`repro_torch.launch.
    collectives` counts them: each leaf's FSDP and model all-gathers (the
    expert banks of an expert-parallel layer stay split over model), the
    reduce-scatters of their VJPs over the data axes, the all-reduce over
    the data axes a leaf's spec does not split; the MoE layers'
    (:func:`ep_layer_payloads`); the loss's mean over data, the finite
    verdict on the host group, the clip's sum over each axis; an int8
    state's reshards.  An axis of one rank makes no call.  ``batch_axes``:
    the step's (:func:`repro_torch.train.step.make_train_step`), which take
    the place of the data axes."""
    from repro_torch.common.tree import tree_paths as paths_of
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.quant import BLOCK
    from repro_torch.sharding.ctx import entry_names
    from repro_torch.sharding.place import block_shape, spec_paths
    from repro_torch.train.step import _at, expert_bank, ep_layer, lm_state_specs
    sizes = dict(mesh_shape)
    adam = AdamWConfig(state_dtype=state_dtype or cfg.opt_state_dtype)
    whole, specs = lm_state_specs(cfg, adam, _MeshShape(sizes), batch_axes)
    dax = _batch_axes(sizes, batch_axes)
    n_data = _prod(sizes[a] for a in dax)
    t_loc = B // n_data * S
    ep = ep_layer(cfg, _MeshShape(sizes), t_loc)
    out: Dict[str, int] = {}

    def add(kind, names, nbytes):
        key = f"{kind}/{_axes_label(names)}"
        out[key] = out.get(key, 0) + nbytes

    spec_at = spec_paths(specs["params"])
    leaves = list(paths_of(whole["params"]).items())
    for path, leaf in leaves:
        spec = spec_at[path]
        item = leaf.element_size()
        block = block_shape(leaf.shape, spec, sizes)
        cur = list(block)
        split = [(d, entry_names(e)) for d, e in enumerate(spec)
                 if entry_names(e) and _prod(sizes[a] for a in entry_names(e)) > 1]
        for d, names in split:
            if "model" not in names:
                add("all_gather", names, _prod(cur) * item)
                cur[d] *= _prod(sizes[a] for a in names)
                add("reduce_scatter", names, _prod(cur) * item)
        if not (ep and expert_bank(path, leaf.dim())):
            for d, names in split:
                if names == ("model",):
                    add("all_gather", names, _prod(cur) * item)
                    cur[d] *= sizes["model"]
        named = {a for e in spec for a in entry_names(e)}
        rest = tuple(a for a in dax if a not in named)
        if rest and _prod(sizes[a] for a in rest) > 1:
            add("all_reduce", rest, _prod(block) * item)
    if n_data > 1:
        add("all_reduce", dax, 4)                                 # the loss
    if cfg.moe is not None:
        for k, v in ep_layer_payloads(cfg, sizes, t_loc).items():
            out[k] = out.get(k, 0) + v * cfg.n_layers
    if skip_nonfinite:
        add("all_reduce", ("host",), 4)
    for a, n in sizes.items():
        if n > 1:
            add("all_reduce", (a,), 4)                            # the clip
    if adam.state_dtype == "int8":
        for path, leaf in leaves:
            sp = spec_at[path]
            qspec = _at(specs["opt"]["mu"], path)
            sq, ss = qspec["q"], qspec["scale"]
            item = leaf.element_size()
            block = block_shape(leaf.shape, sp, sizes)
            last = entry_names(sp[-1]) if leaf.dim() else ()
            u = tuple(sp)
            if last and _prod(sizes[a] for a in last) > 1 and block[-1] % BLOCK:
                u = u[:-1] + (None,)
            nb = (leaf.shape[-1] + BLOCK - 1) // BLOCK
            sshape = tuple(leaf.shape[:-1]) + (nb,)
            moves = []
            for _ in range(2):                                    # the param, its gradient
                moves += _reshard_payloads(block, sp, u, sizes, item)[0]
            for _ in ("mu", "nu"):
                for shape, spec, it in ((leaf.shape, sq, 1), (sshape, ss, 4)):
                    there, moved = _reshard_payloads(block_shape(shape, spec, sizes), spec,
                                                     u, sizes, it)
                    moves += there
                    if moved:
                        moves += _reshard_payloads(block_shape(shape, u, sizes), u, spec,
                                                   sizes, it)[0]
            for names, nbytes in moves:
                add("all_gather", names, nbytes)
    return out


def _gather_payloads(add, shape, spec, sizes: Dict[str, int], item: int,
                     keep_model: bool = False) -> None:
    """The all-gathers :func:`repro_torch.sharding.place.gather_for_use`
    makes to take a block of a leaf of ``shape`` under ``spec`` whole (its
    data axes' dims, then ``model``'s unless ``keep_model``)."""
    from repro_torch.sharding.ctx import entry_names
    from repro_torch.sharding.place import block_shape
    cur = list(block_shape(shape, spec, sizes))
    split = [(d, entry_names(e)) for d, e in enumerate(spec)
             if entry_names(e) and _prod(sizes[a] for a in entry_names(e)) > 1]
    for d, names in split:
        if "model" not in names:
            add("all_gather", names, _prod(cur) * item)
            cur[d] *= _prod(sizes[a] for a in names)
    if not keep_model:
        for d, names in split:
            if names == ("model",):
                add("all_gather", names, _prod(cur) * item)
                cur[d] *= sizes["model"]


def moe_serve_payloads(cfg: ModelConfig, sizes: Dict[str, int], t_loc: int) -> Dict[str, int]:
    """The payloads one MoE layer of a prefill or decode step under a mesh
    hands its collectives on ``t_loc`` tokens a data shard, by
    ``kind/axis``: ``transformer.moe_dispatch``'s forward
    (:func:`ep_layer_payloads` less the backward)."""
    from repro_torch.models.moe import ep_applies
    out: Dict[str, int] = {}

    def add(kind, names, nbytes):
        key = f"{kind}/{_axes_label(names)}"
        out[key] = out.get(key, 0) + nbytes

    dax = _batch_axes(sizes)
    n_data, n_model = _prod(sizes[a] for a in dax), sizes.get("model", 1)
    layout = cfg.activation_layout if cfg.shard_activations_model else "seq"
    x = t_loc * cfg.d_model * _ITEMSIZE[cfg.compute_dtype]
    if not cfg.moe_shard_map or (cfg.d_model if layout == "hidden" else t_loc) % n_model:
        if n_data > 1:
            add("all_gather", dax, x)
            add("all_reduce", dax, 4)
        return out
    if n_model > 1:
        add("all_gather", ("model",), x // n_model)              # the body's gather
        add("all_gather", ("model",), x // n_model)              # y gathered back
    if ep_applies(cfg.moe, sizes, t_loc, cfg.d_model, layout):
        add("reduce_scatter", ("model",), x)                     # y out of the body
    elif n_data > 1:
        add("all_gather", dax, x)                                # the fallback's tokens
    if n_data > 1:
        add("all_reduce", dax, 4)                                # aux over data
    if n_model > 1:
        add("all_reduce", ("model",), 4)                         # aux over model
    return out


# the stacked layers of each family's param tree, and the top-level leaves a
# prefill or decode gathers whole (once a use)
_STACKS = ("layers", "mamba", "encoder", "decoder")


def serve_cache_layout(cfg: ModelConfig, sizes: Dict[str, int], B: int, S: int, kind: str):
    """(the cache's whole shapes, their sanitized specs, the axes the rows
    split over, the tokens a row runs) of a ``kind`` ("prefill" or
    "decode") step of B rows: a prefill of S tokens writes a cache of its S
    positions (and a vision frontend's tokens; whisper's cross k and v at
    the config's frames), a decode step reads an S-deep one."""
    from repro_torch.sharding.serve import cache_shapes, cache_specs_for, row_axes
    front = cfg.n_frontend_tokens if (kind == "prefill" and cfg.frontend is not None) else 0
    seq = S + (front if cfg.family == "transformer" else 0)
    shapes = cache_shapes(cfg, B, seq)
    specs = cache_specs_for(shapes, B, sizes)
    per_row = (S + front) if kind == "prefill" else 1
    return shapes, specs, row_axes(specs, sizes), per_row


def lm_serve_payloads(cfg: ModelConfig, mesh_shape: Dict[str, int], B: int, S: int,
                      kind: str, param_dtype="float32") -> Dict[str, int]:
    """The bytes one rank hands the collectives of one ``api.prefill`` (a
    B x S prompt batch) or ``api.decode_step`` (B rows against an S-deep
    cache) under a mesh of axis sizes ``mesh_shape``
    (:mod:`repro_torch.sharding.serve`), by ``kind/axis`` as
    :mod:`repro_torch.launch.collectives` counts them, on params placed in
    ``param_dtype`` (one dtype's name, or ``{path: name}`` where the
    leaves differ: ``compute_params`` narrows the layers' matmul weights
    only): each leaf gathered whole where it is used (a stacked leaf one
    layer at a time, broadcast from the rank that holds the layer where the
    rules split the layer dim; the expert banks of an expert-parallel layer
    left split over ``model``; a top-level leaf once, the tied embedding
    serving the head too; whisper's encoder at prefill only); each MoE
    layer's forward (:func:`moe_serve_payloads`); and at
    decode each attention layer's merge of the partial softmax over the
    axes that split its cache's sequence ((rows, heads, Dv + 2) f32), its
    heads' outputs gathered over the axes that split the heads, and each
    mamba layer's conv outputs and y gathered over the axes that split
    their channels and heads."""
    from repro_torch.sharding.place import block_shape
    from repro_torch.sharding.serve import _group, param_spec_at
    from repro_torch.launch.specs import abstract_params_for
    from repro_torch.common.tree import tree_paths as paths_of
    from repro_torch.train.step import ep_layer, expert_bank
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind={kind!r} (want 'prefill' or 'decode')")
    sizes = dict(mesh_shape)
    shapes, specs, rows, per_row = serve_cache_layout(cfg, sizes, B, S, kind)
    n_rows = _prod(sizes[a] for a in rows)
    b_loc = B // n_rows
    ep = ep_layer(cfg, _MeshShape(sizes), b_loc * per_row)
    c_item = _ITEMSIZE[cfg.compute_dtype]
    out: Dict[str, int] = {}

    def item_of(path: str) -> int:
        dt = param_dtype if isinstance(param_dtype, str) else param_dtype[path]
        return _ITEMSIZE[dt]

    def add(kind_, names, nbytes, times=1):
        key = f"{kind_}/{_axes_label(names)}"
        out[key] = out.get(key, 0) + nbytes * times

    spec_at = param_spec_at(cfg, sizes)
    for path, leaf in paths_of(abstract_params_for(cfg)).items():
        top, spec, shape = path.split("/")[0], spec_at[path], tuple(leaf.shape)
        if top in _STACKS:
            if top == "encoder" and kind == "decode":
                continue
            lax = _group(spec, 0, sizes)
            layer = block_shape(shape[1:], spec[1:], sizes)
            for _ in range(shape[0]):
                if lax:
                    add("broadcast", lax, _prod(layer) * item_of(path))
                _gather_payloads(add, shape[1:], spec[1:], sizes, item_of(path),
                                 ep and expert_bank(path, len(shape)))
        elif top in ("embed", "lm_head", "shared"):
            _gather_payloads(add, shape, spec, sizes, item_of(path))
    if cfg.moe is not None:
        for k, v in moe_serve_payloads(cfg, sizes, b_loc * per_row).items():
            out[k] = out.get(k, 0) + v * cfg.n_layers
    if kind == "prefill":
        return out
    a = cfg.attention

    def attn(name, n_layers, hq, dv):
        sx, hx = _group(specs[name], 2, sizes), _group(specs[name], 3, sizes)
        h_loc = hq // (_prod(sizes[x] for x in hx) if hx else 1)
        if sx:
            add("all_gather", sx, b_loc * h_loc * (dv + 2) * 4, n_layers)
        if hx:
            add("all_gather", hx, b_loc * h_loc * dv * c_item, n_layers)

    if "ckv" in specs:
        attn("ckv", cfg.n_layers, a.n_heads, a.kv_lora_rank)
    elif "k" in specs:
        attn("k", shapes["k"][0], a.n_heads, a.head_dim)
    if "cross_k" in specs:
        attn("cross_k", cfg.n_layers, a.n_heads, a.head_dim)
    if "conv" in specs:
        n_mamba, c = shapes["conv"][0], shapes["conv"][2]
        ssm = shapes["ssm"]
        for name, width in (("conv", c), ("ssm", ssm[2] * ssm[3])):
            ax = _group(specs[name], 2, sizes)
            if ax:
                add("all_gather", ax, b_loc * width // _prod(sizes[x] for x in ax) * c_item,
                    n_mamba)
    return out


def _link_bytes_per_s(names, sizes: Dict[str, int]) -> float:
    """A group's link rate: NVLink for a ``model`` group within one node,
    InfiniBand for any other (the data and pod axes, and a model axis
    wider than a node)."""
    if tuple(names) == ("model",) and sizes["model"] <= CARDS_PER_NODE:
        return NVLINK_BYTES_PER_S
    return IB_BYTES_PER_S


def _wire(kind: str, nbytes: int, g: int) -> float:
    """The bytes a collective of ``kind`` handed ``nbytes`` puts on each
    rank's link in a group of ``g`` (the ring factors: an all-gather sends
    (g - 1) times its part, a reduce-scatter (g - 1) / g of its buffer, an
    all-reduce twice that, a pipelined broadcast its buffer once)."""
    return {"all_gather": all_gather_bytes(nbytes, g),
            "reduce_scatter": (g - 1) / g * nbytes,
            "all_reduce": ring_all_reduce_bytes(nbytes, g),
            "broadcast": float(nbytes)}[kind]


def _collective_terms(payloads: Dict[str, int], sizes: Dict[str, int]):
    """(axes, wire bytes) of each payload but the host group's verdict."""
    for key, nbytes in payloads.items():
        kind, label = key.split("/")
        if label == "host":
            continue
        names = tuple(label.split("+"))
        yield names, _wire(kind, nbytes, _prod(sizes[a] for a in names))


def collective_wire_bytes(payloads: Dict[str, int], sizes: Dict[str, int]) -> float:
    """The wire bytes of a step's payloads (:func:`_wire`), every group's
    summed: the measure the reference's guard on the MoE dispatch compares
    (``tests/test_distributed.py:142-159``)."""
    return sum(w for _, w in _collective_terms(payloads, sizes))


def lm_step_collective_s(payloads: Dict[str, int], sizes: Dict[str, int]) -> float:
    """Seconds of a step's collectives, one after another: each payload's
    wire bytes (:func:`_wire`) over its group's link
    (:func:`_link_bytes_per_s`); the host group's verdict is not counted.
    Derived from the data sheets, not measured."""
    return sum(w / _link_bytes_per_s(names, sizes) for names, w in
               _collective_terms(payloads, sizes))


def mesh_state_bytes(cfg: ModelConfig, sizes: Dict[str, int],
                     batch_axes: Optional[tuple] = None) -> int:
    """Bytes of one chip's training state on a mesh: its blocks of the
    params and their gradients and of AdamW's state, by the sanitized
    rules (:func:`repro_torch.train.step.lm_state_specs`, ``model``
    stripped where ``batch_axes`` hold it)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.ctx import is_spec
    from repro_torch.sharding.place import block_shape
    from repro_torch.train.step import lm_state_specs
    whole, specs = lm_state_specs(cfg, AdamWConfig(state_dtype=cfg.opt_state_dtype),
                                  _MeshShape(sizes), batch_axes)
    total = 0
    for part, mult in (("params", 2), ("opt", 1)):
        leaves = [t for t in tree_leaves(whole[part]) if hasattr(t, "shape")]
        sp = [s for s, t in zip(tree_leaves(specs[part], is_leaf=is_spec),
                                tree_leaves(whole[part])) if hasattr(t, "shape")]
        total += mult * sum(_prod(block_shape(t.shape, s, sizes)) * t.element_size()
                            for t, s in zip(leaves, sp))
    return total


def mesh_step_flops(cfg: ModelConfig, shape: ShapeSpec, sizes: Dict[str, int],
                    batch_axes: Optional[tuple] = None):
    """(bf16, fp32) FLOPs one chip spends in a train step of ``cfg`` on
    ``shape``'s global batch over a mesh of axis ``sizes``, from
    :func:`cell_work`: the dense FLOPs split over the data ranks
    (replicated over ``model``; split over ``batch_axes`` where given), an
    expert-parallel layer's expert projections over every chip, a fallback
    layer's the global tokens' on every chip."""
    from repro_torch.train.step import ep_layer
    chips = _prod(sizes.values())
    n_data = _prod(sizes[a] for a in _batch_axes(sizes, batch_axes))
    b, s = shape.global_batch, shape.seq_len
    _, bf16, f32 = cell_work(cfg, shape)
    experts = 0.0                # the expert projections' bf16 FLOPs, the whole batch
    if cfg.moe is not None:
        experts = 3 * 2.0 * cfg.n_layers * b * s * cfg.moe.top_k * 3 * cfg.d_model \
            * cfg.moe.d_ff
    expert_chip = experts / chips if ep_layer(cfg, _MeshShape(sizes), b // n_data * s) \
        else experts
    return (bf16 - experts) / n_data + expert_chip, f32 / n_data


def mesh_cell(arch: str, shape_name: str, mesh: str) -> Dict:
    """A train cell on the production mesh ``mesh`` ("single": 16 x 16,
    "multi": 2 x 16 x 16) as the port's sharded step runs it, counted from
    the config: the dense FLOPs over the data ranks (replicated over
    ``model``), an expert-parallel layer's experts over every chip (a
    fallback layer runs the global tokens' experts on every chip), the
    bytes AdamW moves in the chip's state, T_coll of
    :func:`lm_step_payloads`.  Its program-derived twin is
    :func:`load_table` over the dry run's records
    (:mod:`repro_torch.launch.dryrun`), which counts the same step's FLOPs,
    bytes and payloads on one rank's trace.  A config with
    ``tp_enabled=False`` whose batch covers the mesh runs pure data
    parallel (:func:`repro_torch.sharding.rules.tp_off_batch_axes`), as
    the dry run traces it.  A prefill or decode cell is
    :func:`_serve_cell`'s row, ``api.prefill`` / ``api.decode_step`` on
    placed params and cache (:mod:`repro_torch.sharding.serve`)."""
    from repro_torch.sharding.rules import tp_off_batch_axes
    sizes = PRODUCTION_MESHES[mesh]
    chips = _prod(sizes.values())
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    row = dict(arch=arch, shape=shape_name, mesh=mesh)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind != "train":
        return _serve_cell(cfg, shape, sizes, row)
    bax = tp_off_batch_axes(cfg.tp_enabled, b, sizes)
    n_data = _prod(sizes[a] for a in _batch_axes(sizes, bax))
    if b % n_data:
        return dict(row, skipped=f"batch {b} does not split over {n_data} data ranks")
    nbytes = cell_work(cfg, shape)[0]
    bf16_chip, f32_chip = mesh_step_flops(cfg, shape, sizes, bax)
    flops_chip = bf16_chip + f32_chip
    t_compute = bf16_chip / BF16_FLOPS + f32_chip / FP32_FLOPS
    state = mesh_state_bytes(cfg, sizes, bax)
    total_state = state_bytes(int(param_counts(cfg)["total"]), cfg.opt_state_dtype,
                              cfg.param_dtype)
    t_memory = nbytes * state / total_state / HBM_BYTES_PER_S
    payloads = lm_step_payloads(cfg, sizes, b, s, batch_axes=bax)
    t_coll = lm_step_collective_s(payloads, sizes)
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    mf = model_flops(cfg, shape_name)
    return dict(row, chips=chips, t_compute=t_compute, t_memory=t_memory,
                t_collective=t_coll, bottleneck=max(terms, key=terms.get), model_flops=mf,
                useful_ratio=mf / chips / max(flops_chip, 1.0),
                roofline_fraction=mf / (chips * BF16_FLOPS) / max(terms.values()),
                state_bytes_per_device=state, hbm_headroom_gib=(HBM_BYTES - state) / 2**30)


def serve_state_bytes(cfg: ModelConfig, sizes: Dict[str, int], B: int, S: int, kind: str
                      ) -> int:
    """Bytes of one chip's params (fp32, as ``api.init`` draws them) and
    cache blocks in a prefill or decode cell on a mesh, by the sanitized
    rules (:func:`repro_torch.sharding.place.lm_serve_layout` and
    :func:`serve_cache_layout`): the reference's ``_analytic_state_bytes``
    of both."""
    from repro_torch.sharding.ctx import is_spec
    from repro_torch.sharding.place import block_shape, lm_serve_layout
    params, pspecs = lm_serve_layout(cfg, sizes)
    total = sum(_prod(block_shape(t.shape, sp, sizes)) * t.element_size()
                for t, sp in zip(tree_leaves(params), tree_leaves(pspecs, is_leaf=is_spec)))
    shapes, specs, _, _ = serve_cache_layout(cfg, sizes, B, S, kind)
    return total + sum(_prod(block_shape(sh, specs[k], sizes))
                       * (4 if k == "ssm" else _ITEMSIZE[cfg.compute_dtype])
                       for k, sh in shapes.items())


def mesh_serve_flops(cfg: ModelConfig, shape: ShapeSpec, sizes: Dict[str, int]):
    """(bf16, fp32) FLOPs one chip spends in a prefill or decode step of
    ``shape`` over a mesh of axis ``sizes`` (:mod:`repro_torch.sharding.
    serve`), from :func:`cell_work`: the dense FLOPs split over the ranks
    the rows split over and replicated over the rest, a decode step's
    attention over its cache also over the ranks that split the cache's
    sequence or heads, an expert-parallel layer's expert projections over
    the ``model`` ranks too, a fallback layer's the global tokens' on every
    chip."""
    from repro_torch.train.step import ep_layer
    b, s = shape.global_batch, shape.seq_len
    _, _, rows, per_row = serve_cache_layout(cfg, sizes, b, s, shape.kind)
    n_rows = _prod(sizes[a] for a in rows)
    _, bf16, f32 = cell_work(cfg, shape)
    experts = 0.0
    if cfg.moe is not None:
        tokens = b * s if shape.kind == "prefill" else b
        experts = 2.0 * cfg.n_layers * tokens * cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff
    ep = ep_layer(cfg, _MeshShape(sizes), b // n_rows * per_row)
    expert_chip = experts / n_rows / sizes.get("model", 1) if ep else experts
    if shape.kind == "decode":
        # attention over the cache runs on this chip's block of it
        from repro_torch.sharding.place import block_shape
        shapes, specs = serve_cache_layout(cfg, sizes, b, s, shape.kind)[:2]
        name = next((k for k in ("ckv", "k") if k in shapes), None)
        if name is not None:
            work = _serving_work(cfg)
            attn = work(cfg, 1, b, s)[1][1] - work(cfg, 1, b, 0)[1][1]
            blk = block_shape(shapes[name], specs[name], sizes)
            split = _prod(shapes[name][2:]) / _prod(blk[2:])
            bf16 -= attn * (1 - 1 / split)
    return (bf16 - experts) / n_rows + expert_chip, f32 / n_rows


def _serve_cell(cfg: ModelConfig, shape: ShapeSpec, sizes: Dict[str, int], row: Dict) -> Dict:
    """A prefill or decode cell on a production mesh: FLOPs a chip from
    :func:`mesh_serve_flops`; bytes every weight read once (each chip
    gathers every layer) and the chip's block of the cache; T_coll of
    :func:`lm_serve_payloads` on fp32 params; the state a chip its blocks
    of the params and the cache (:func:`serve_state_bytes`)."""
    from repro_torch.sharding.place import block_shape
    chips = _prod(sizes.values())
    b, s = shape.global_batch, shape.seq_len
    shapes, specs, _, _ = serve_cache_layout(cfg, sizes, b, s, shape.kind)
    work = _serving_work(cfg)
    weights = work(cfg, s, 1, s)[0][0]
    cache_whole = work(cfg, 1, b, s)[1][0] - weights if shape.kind == "decode" else 0.0
    frac = sum(_prod(block_shape(sh, specs[k], sizes)) for k, sh in shapes.items()) \
        / max(sum(_prod(sh) for sh in shapes.values()), 1)
    bf16_chip, f32_chip = mesh_serve_flops(cfg, shape, sizes)
    flops_chip = bf16_chip + f32_chip
    t_compute = bf16_chip / BF16_FLOPS + f32_chip / FP32_FLOPS
    t_memory = (weights + cache_whole * frac) / HBM_BYTES_PER_S
    t_coll = lm_step_collective_s(lm_serve_payloads(cfg, sizes, b, s, shape.kind), sizes)
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    mf = model_flops(cfg, shape.name)
    state = serve_state_bytes(cfg, sizes, b, s, shape.kind)
    return dict(row, chips=chips, t_compute=t_compute, t_memory=t_memory,
                t_collective=t_coll, bottleneck=max(terms, key=terms.get), model_flops=mf,
                useful_ratio=mf / chips / max(flops_chip, 1.0),
                roofline_fraction=mf / (chips * BF16_FLOPS) / max(terms.values()),
                state_bytes_per_device=state, hbm_headroom_gib=(HBM_BYTES - state) / 2**30)


def cell_rows(mesh: Optional[str] = None) -> List[Dict]:
    """:func:`analyze_cell` of every arch in ``ARCH_IDS`` x every shape in
    ``SHAPES``, in that order."""
    return [analyze_cell(arch, s.name, mesh) for arch in ARCH_IDS for s in SHAPES]


def record_row(rec: Dict) -> Dict:
    """The roofline row of one ``ok`` record of the dry run
    (:mod:`repro_torch.launch.dryrun`), measured from the program's trace:
    T_comp its bf16 FLOPs at the bf16 peak and the rest at fp32's, T_mem
    its bytes (eager and unfused: every op's operands and results) over
    HBM's rate, T_coll its payloads through :func:`lm_step_collective_s`,
    the useful ratio :func:`model_flops` a chip over its FLOPs (so a row's
    FLOPs a chip are ``model_flops / chips / useful_ratio``, as in
    :func:`mesh_cell`'s); the state a chip its params and AdamW state (no
    gradients).  The keys are :func:`analyze_cell`'s."""
    cfg = get_config(rec["arch"])
    chips, flops = rec["chips"], rec["flops_per_device"]
    bf16 = rec.get("flops_by_dtype", {}).get("bfloat16", 0)
    t_compute = bf16 / BF16_FLOPS + (flops - bf16) / FP32_FLOPS
    t_memory = rec["bytes_per_device"] / HBM_BYTES_PER_S
    t_coll = lm_step_collective_s(rec["collectives"], rec["mesh_shape"])
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    mf = model_flops(cfg, rec["shape"])
    state = rec["state_bytes_per_device"]
    return dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
                t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
                bottleneck=max(terms, key=terms.get), model_flops=mf,
                useful_ratio=mf / chips / max(flops, 1.0),
                roofline_fraction=mf / (chips * BF16_FLOPS) / max(terms.values()),
                state_bytes_per_device=state, hbm_headroom_gib=(HBM_BYTES - state) / 2**30)


def load_table(path, mesh: str = "single") -> List[Dict]:
    """The rows :func:`format_markdown` prints, from the dry run's records
    at ``path`` on ``mesh`` (:func:`record_row`), sorted by key; a skipped
    record gives its ``skipped`` row, a failed one none."""
    import json
    import pathlib
    recs = json.loads(pathlib.Path(path).read_text())
    rows = []
    for _, rec in sorted(recs.items()):
        if rec.get("mesh") != mesh:
            continue
        if rec.get("status") == "skipped":
            rows.append(dict(arch=rec["arch"], shape=rec["shape"], mesh=mesh,
                             skipped=rec["reason"][:60]))
        elif rec.get("status") == "ok":
            rows.append(record_row(rec))
    return rows


def format_markdown(rows) -> str:
    hdr = ("| arch | shape | T_comp (ms) | T_mem (ms) | T_coll (ms) | "
           "bottleneck | useful | roofline frac | state GiB/chip |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {1e3*r['t_compute']:.2f} | "
            f"{1e3*r['t_memory']:.2f} | {1e3*r['t_collective']:.2f} | "
            f"{r['bottleneck']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{r['state_bytes_per_device']/2**30:.2f} |")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the serving layouts of a replica group and their chooser
#
# Serving turns training's balance around: a batch is a few episodes while
# the frozen weights are the big tensors, so the training layout (every
# leaf split on its largest dim and gathered before each dispatch) pays
# its weights' bytes on the wire at every dispatch.  weight_stationary
# keeps each 2-D product weight's K-slice on its rank and sums the partial
# products (activations) over the group; replicated moves nothing.  The JAX
# package scores each candidate on its compiled HLO; the port has none, so
# it runs the predict dispatch once under each layout on the group, reads
# the payloads its collectives were handed (``launch.collectives``) and
# prices them with the ring all-reduce and all-gather factors at NVLink's
# rate, beside the analytic FLOPs and bytes of the backbone's forward.
# ---------------------------------------------------------------------------

SERVING_LAYOUTS = ("training", "weight_stationary", "replicated")


def _largest_divisible_dim(shape, n: int) -> int:
    """Index of the largest dim divisible by n (the first of equals), or -1."""
    best, best_d = -1, 0
    for i, d in enumerate(shape):
        if d % n == 0 and d > best_d:
            best, best_d = i, d
    return best


def _weight_leaf_spec(shape, layout: str, axis: str, n: int) -> tuple:
    """The JAX package's PartitionSpec of one serving-weight leaf of
    ``shape`` (in its layout: conv weights HWIO) as a tuple, ``axis`` at the
    split dim, ``()`` for a whole leaf.  training: the largest dim ``n``
    divides; weight_stationary: dim 0 of a 2-D leaf (the contracting dim of
    its product) that ``n`` divides; replicated: nothing."""
    if layout not in SERVING_LAYOUTS:
        raise ValueError(f"unknown serving layout {layout!r}; choose from {SERVING_LAYOUTS}")
    if not shape or n <= 1 or layout == "replicated":
        return ()
    if layout == "weight_stationary":
        return (axis, None) if len(shape) == 2 and shape[0] % n == 0 else ()
    i = _largest_divisible_dim(shape, n)
    if i < 0:
        return ()
    return tuple(axis if k == i else None for k in range(len(shape)))


def _batch_leaf_spec(shape, layout: str, axis: str, n: int) -> tuple:
    """A batch operand's spec: training splits its leading (task-lane)
    dim; the serving layouts keep the batch whole on every rank."""
    if layout == "training" and shape and n > 1 and shape[0] % n == 0:
        return (axis,)
    return ()


def split_dim(spec: tuple) -> Optional[int]:
    """The dim a spec splits, or None."""
    for i, a in enumerate(spec):
        if a is not None:
            return i
    return None


def _conv_spec(shape, layout: str, axis: str, n: int) -> tuple:
    """The spec of a port conv weight (OIHW), chosen on its HWIO shape."""
    from repro_torch.bridge import HWIO_TO_OIHW, OIHW_TO_HWIO
    hwio = tuple(shape[i] for i in OIHW_TO_HWIO)
    spec = _weight_leaf_spec(hwio, layout, axis, n)
    return tuple(spec[i] for i in HWIO_TO_OIHW) if spec else ()


def serving_shardings(tree, n: int, layout: str, axis: str = "serve"):
    """The spec of every leaf of a serving-weights tree (a params tree, a
    quantized ``{q, scale, n}`` leaf's parts each by its own shape) under
    ``layout`` on a group of ``n`` ranks; a conv weight's dim is chosen in
    the JAX layout (HWIO), so that both packages split the same tensor
    dim."""
    from repro_torch.bridge import is_conv_weight
    from repro_torch.optim.quant import is_quantized

    def walk(t, key):
        if is_quantized(t):                 # q and scale: the JAX layout already
            return {k: _weight_leaf_spec(tuple(getattr(v, "shape", ())), layout, axis, n)
                    for k, v in t.items()}
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, key) for v in t]
        shape = tuple(getattr(t, "shape", ()))
        if is_conv_weight(t, key):
            return _conv_spec(shape, layout, axis, n)
        return _weight_leaf_spec(shape, layout, axis, n)

    return walk(tree, "")


def batch_shardings(tree, n: int, layout: str, axis: str = "serve"):
    """The spec of every batch operand (tensors of a dispatch's inputs)."""
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: _batch_leaf_spec(tuple(getattr(t, "shape", ())), layout,
                                               axis, n), tree)


def _lite_rows(n: int, chunk: Optional[int]) -> int:
    """Rows a LITE serve estimator runs over n support rows in ``chunk``s."""
    if chunk is None or chunk >= n:
        return n
    return -(-n // chunk) * chunk


def serving_payloads(weights, layout: str, group: int, lanes: int, rows: int, *,
                     dispatch: str = "predict", way: int = 0,
                     chunk: Optional[int] = None, axis: str = "serve") -> Dict[str, int]:
    """The bytes one rank of a ``group``-rank serving group (mesh axis
    ``axis``) hands its collectives in one dispatch, by ``kind/axis`` as
    :mod:`repro_torch.launch.collectives` counts them (payloads, no ring or
    all-gather factor), for ``weights`` (a
    :class:`repro_torch.serve.quant_params.ServingWeights` before placement)
    under ``layout``; ``lanes`` task lanes of ``rows`` query rows
    (``predict``) or support rows (``adapt``, with the learner's ``way`` and
    the LITE ``chunk``).  Every leaf the layout splits and the dispatch does
    not read as a K-slice is all-gathered, this rank's part of it;
    under ``weight_stationary`` each product with a split weight all-reduces
    its fp32 partial product, (its rows, N): in a predict dispatch the
    backbone's over the query rows, in an adapt dispatch the kind's
    products over their ``PRODUCT_LEAVES`` rows."""
    from repro_torch.serve.quant_params import _spec_paths, _walk, is_quantized_leaf
    if group <= 1 or layout in (None, "none", "replicated"):
        return {}
    specs = _spec_paths(serving_shardings(weights.tree, group, layout, axis))
    products = dict(weights.products) if layout == "weight_stationary" else {}
    in_rows = dict(chunks=lanes * _lite_rows(rows, chunk), support=lanes * rows,
                   tasks=lanes, classes=lanes * way)
    gathered, reduced = 0, 0

    def nbytes(t):
        return t.numel() * t.element_size() // group

    def visit(path, leaf):
        nonlocal gathered, reduced
        parts = ({f"{path}/q": leaf["q"], f"{path}/scale": leaf["scale"]}
                 if is_quantized_leaf(leaf) else {path: leaf})
        dims = {p: split_dim(specs.get(p, ())) for p in parts}
        if path in products and all(d == 0 for d in dims.values()):
            role = products[path]
            if dispatch == "adapt" or path.startswith("bb/"):
                m = lanes * rows if dispatch == "predict" else in_rows[role]
                n = (leaf["q"] if is_quantized_leaf(leaf) else leaf).shape[1]
                reduced += m * n * 4
            return leaf
        gathered += sum(nbytes(t) for p, t in parts.items() if dims[p] is not None)
        return leaf

    _walk(weights.tree, visit)
    out = {}
    if reduced:
        out[f"all_reduce/{axis}"] = reduced
    if gathered:
        out[f"all_gather/{axis}"] = gathered
    return out


def serving_wire_bytes(payload: Dict[str, int], group: int) -> float:
    """Bytes one rank sends for ``payload`` (``kind/axis`` -> bytes) over a
    group of ``group`` ranks: ring all-reduce and all-gather factors."""
    wire = 0.0
    for key, nbytes in payload.items():
        kind = key.split("/")[0]
        if kind == "all_reduce":
            wire += ring_all_reduce_bytes(nbytes, group)
        elif kind == "all_gather":
            wire += all_gather_bytes(nbytes, group)
    return wire


def serving_predict_work(weights, query_shape, layout: str, group: int):
    """(FLOPs, bytes) one rank spends in a predict dispatch over queries of
    ``query_shape`` (T, M, H, W, C) under ``layout``: the conv backbone's
    forward (3x3 SAME convolutions, a 2x2 pool after each while H, W >= 2,
    the head) over the T * M images, and the bytes of the weights it reads
    (a K-slice of a split product weight under ``weight_stationary``, else
    the whole leaf), the images and the features."""
    from repro_torch.serve.quant_params import _walk, is_quantized_leaf
    t, m, h, w = (int(d) for d in query_shape[:4])
    imgs = t * m
    products = {p for p, _ in weights.products} if layout == "weight_stationary" else set()
    flops, wbytes, feat = 0.0, 0, 0
    bb = weights.tree.get("bb", {}) if isinstance(weights.tree, dict) else {}
    for blk in bb.get("blocks", []):
        wt = blk["w"]
        if is_quantized_leaf(wt):
            kh, kw, cin, cout = wt["q"].shape                   # HWIO
        else:
            cout, cin, kh, kw = wt.shape                        # OIHW
        flops += 2.0 * kh * kw * cin * cout * h * w * imgs
        if h >= 2 and w >= 2:
            h, w = h // 2, w // 2
    head = bb.get("head", {}).get("w")
    if head is not None:
        k, n = (head["q"] if is_quantized_leaf(head) else head).shape
        split = "bb/head/w" in products and group > 1 and k % group == 0
        flops += 2.0 * k * n * imgs / (group if split else 1)
        feat = imgs * n * 4

    def visit(path, leaf):
        nonlocal wbytes
        parts = [leaf["q"], leaf["scale"]] if is_quantized_leaf(leaf) else [leaf]
        size = sum(p.numel() * p.element_size() for p in parts if hasattr(p, "numel"))
        wbytes += size // group if path in products and group > 1 and \
            parts[0].shape[0] % group == 0 else size
        return leaf

    if isinstance(weights.tree, dict) and "bb" in weights.tree:
        _walk(weights.tree["bb"], lambda p, leaf: visit(f"bb/{p}", leaf))
    in_bytes = imgs * int(query_shape[2]) * int(query_shape[3]) * int(query_shape[4]) * 4
    return flops, wbytes + in_bytes + feat


def score_serving_layout(fn, weights, args, mesh, layout: str) -> Dict:
    """Run ``fn(placed, *args)`` (the predict dispatch, e.g.
    ``learner.predict_batch(serving_params(w), states, query_x)``) once with
    ``weights`` placed under ``layout`` on ``mesh``'s serving group, and
    score it with the three terms: the payloads its collectives were handed
    on the wire (:func:`serving_wire_bytes`) at NVLink's rate, and
    :func:`serving_predict_work`'s FLOPs at the fp32 peak and bytes at
    HBM's rate.  The JAX package's row keys; ``bottleneck`` names the
    largest term and ``score`` is its time."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import serve_axis
    from repro_torch.serve.quant_params import place_serving_weights
    axis = serve_axis(mesh)
    group = mesh.shape[axis]
    placed = place_serving_weights(weights, mesh, layout)
    before_b, before_c = collectives.counter.payload(), collectives.counter.snapshot()
    fn(placed, *args)
    after_b, after_c = collectives.counter.payload(), collectives.counter.snapshot()
    payload = {k: v - before_b.get(k, 0) for k, v in after_b.items()
               if k.endswith(f"/{axis}") and v != before_b.get(k, 0)}
    count = sum(v - before_c.get(k, 0) for k, v in after_c.items() if k.endswith(f"/{axis}"))
    wire = serving_wire_bytes(payload, group)
    flops, nbytes = serving_predict_work(weights, args[-1].shape, layout, group)
    terms = dict(compute=flops / FP32_FLOPS, memory=nbytes / HBM_BYTES_PER_S,
                 collective=wire / NVLINK_BYTES_PER_S)
    return dict(layout=layout, wire_bytes=wire, payload=payload, collective_count=count,
                dot_flops=flops, bytes_accessed=nbytes, t_compute=terms["compute"],
                t_memory=terms["memory"], t_collective=terms["collective"],
                bottleneck=max(terms, key=terms.get), score=max(terms.values()))


def choose_serving_layout(fn, weights, args, mesh, layouts=SERVING_LAYOUTS) -> Dict:
    """Score every layout of ``layouts`` on ``mesh``'s group
    (:func:`score_serving_layout`) and pick the one whose largest term is
    least, ties going to the earlier entry.  Returns ``{"choice": name,
    "rows": {layout: row}}``."""
    rows = {lo: score_serving_layout(fn, weights, args, mesh, lo) for lo in layouts}
    return dict(choice=min(layouts, key=lambda lo: rows[lo]["score"]), rows=rows)


def choose_replica_serving_layout(fn, weights, args, mesh, layouts=SERVING_LAYOUTS) -> Dict:
    """The layout of a replicated deployment, scored on one replica group
    and applied to all: the groups of :func:`repro_torch.launch.mesh.
    make_replica_mesh` are congruent, so group 0's ranks score it (every
    collective within their group) and rank 0 hands the result to every
    rank over the host group.  Returns :func:`choose_serving_layout`'s dict
    and ``per_replica_wire_bytes``, the winner's wire bytes: what each
    replica's rank sends a predict dispatch, not a deployment total."""
    out = None
    if mesh.coords.get("replica", 0) == 0:
        out = choose_serving_layout(fn, weights, args, mesh, layouts)
        out["per_replica_wire_bytes"] = out["rows"][out["choice"]]["wire_bytes"]
    if mesh.shape.get("replica", 1) > 1:
        out = mesh.broadcast_object(out, src=0)
    return out
