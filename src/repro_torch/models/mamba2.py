"""Mamba-2 (SSD, state-space duality) language model: the port of the JAX
package's ``repro/models/mamba2.py``.

Training and prefill run the chunked SSD algorithm: within a chunk the
terms are dense products, across chunks a short recurrence over the
per-head (P, N) states.  Decode is the O(1)-state recurrence.

Parameters are the JAX package's tree (per-layer weights stacked on a
leading L axis under ``layers``); the JAX package's ``lax.scan`` over that
axis is a Python loop here.  The cache is ``{conv: (L, B, c, k-1)`` in the
compute dtype (the last k-1 inputs of the causal conv, before it),
``ssm: (L, B, h, p, n)`` in fp32, ``len: int}``.

Every entry point takes a kernel backend (``auto``: the kernels on a CUDA
tensor, see :mod:`repro_torch.kernels.dispatch`).  On ``cuda`` the
intra-chunk terms of every SSD chunk (y_diag, the chunk states and the two
decays) run the ssd_chunk kernel (B6) through
:func:`repro_torch.kernels.dispatch.ssd_chunk`, with fp32 operands as the
reference computes them, inside its autograd Function wherever grad is on;
every other backend runs the reference's einsums.  The inter-chunk
recurrence and its outputs are plain array code on every backend, as is
decode.
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
# matmul and conv weights of a block, cast to the compute dtype at every
# call (``x @ w.astype(x.dtype)`` in the reference): ``compute_params``
# casts them once
CAST_LEAVES = ("in_proj", "out_proj", "conv_w", "conv_b")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def conv_dim(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state


def in_proj_dim(cfg: ModelConfig) -> int:
    s = cfg.ssm
    return 2 * s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state + s.n_heads(cfg.d_model)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, device=None, lead=()) -> Params:
    """One block's params; ``lead`` prefixes every leaf's shape (the stacked
    layers' (L,)).  dt is drawn log-uniform in [dt_min, dt_max] and stored
    as its inverse softplus; ``A_log = log(1..nh)``."""
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    dev = L.init_device(gen, device)
    u = torch.rand((*lead, nh), generator=gen, device=gen.device).to(dev)
    lo, hi = torch.log(torch.tensor(s.dt_min)), torch.log(torch.tensor(s.dt_max))
    dt = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))            # inverse softplus
    conv_w = torch.randn((*lead, conv_dim(cfg), s.d_conv), generator=gen,
                         device=gen.device).mul_(0.1).to(dev)
    return dict(
        norm=torch.zeros((*lead, cfg.d_model), device=dev),
        in_proj=lecun_normal(gen, (*lead, cfg.d_model, in_proj_dim(cfg)), cfg.d_model, dev),
        conv_w=conv_w,
        conv_b=torch.zeros((*lead, conv_dim(cfg)), device=dev),
        A_log=torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
                        ).expand(*lead, nh).clone(),
        D=torch.ones((*lead, nh), device=dev),
        dt_bias=dt_bias,
        gate_norm=torch.zeros((*lead, d_inner), device=dev),
        out_proj=lecun_normal(gen, (*lead, d_inner, cfg.d_model), d_inner, dev),
    )


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, device=None,
                at_param_dtype: bool = False) -> Params:
    """Random params drawn on ``gen``'s device (moved to ``device`` if
    given); ``at_param_dtype``: every floating leaf in ``cfg.param_dtype``
    (see :func:`repro_torch.models.transformer.init_transformer`).  To
    compute what a JAX model computes, carry its params across with
    :func:`repro_torch.bridge.lm_params_from_numpy`."""
    dt = getattr(torch, cfg.param_dtype) if at_param_dtype else None
    dev = L.init_device(gen, device)
    with drawn_as(dt):
        p = dict(embed=L.init_embed(gen, cfg.vocab_padded, cfg.d_model, dev),
                 layers=init_mamba_block(gen, cfg, dev, lead=(cfg.n_layers,)),
                 final_norm=torch.zeros((cfg.d_model,), device=dev))
    if dt is not None:
        p = tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, p)
    return p


def narrow_block(lp: Params, cfg: ModelConfig) -> Params:
    """A block's (or the stacked blocks') :data:`CAST_LEAVES` in the
    compute dtype, where that narrows them; the rest as they are."""
    dt = _dtype(cfg)
    return {k: v.to(dt) if k in CAST_LEAVES and v.element_size() > dt.itemsize else v
            for k, v in lp.items()}


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """``params`` with each block's ``in_proj``, ``out_proj``, ``conv_w`` and
    ``conv_b`` cast to the compute dtype once (the reference casts each at
    every call: the same numbers).  ``A_log``, ``dt_bias``, ``D``, the norm
    scales and the embedding keep their dtype."""
    return {**params, "layers": narrow_block(params["layers"], cfg)}


def _layer(stacked: Params, i: int) -> Params:
    return tree_map(lambda t: t[i], stacked)


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., cs) -> (..., cs, cs) where out[i, j] = sum_{j < t <= i} x[t],
    -inf above the diagonal (the 1-semiseparable mask of SSD)."""
    cs = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(cs, device=x.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, torch.tensor(float("-inf"), device=x.device))


def _intra_chunk(xc, dtc, A, Bc, Cc, backend: str):
    """The intra-chunk terms of every chunk: xc (b, nc, cs, h, p), dtc (b,
    nc, cs, h), A (h,), Bc, Cc (b, nc, cs, h, n), fp32 -> (Y_diag (b, nc,
    cs, h, p), states (b, nc, h, p, n), chunk_decay (b, nc, h), state_decay
    (b, nc, cs, h)).

    ``cuda``: the ssd_chunk kernel over G = b * nc * h chunks, (b, nc, h)
    flattened into G in that order (A repeated b * nc times).  Otherwise the
    reference's einsums as written."""
    b, nc, cs, h, p = xc.shape
    n = Bc.shape[-1]
    if backend == "cuda":
        flat = lambda t: t.movedim(3, 2).reshape(b * nc * h, cs, -1)     # noqa: E731
        y, st, cd, sd = dispatch.ssd_chunk(
            flat(xc), dtc.movedim(3, 2).reshape(-1, cs), A.repeat(b * nc),
            flat(Bc), flat(Cc), backend="cuda")
        return (y.reshape(b, nc, h, cs, p).movedim(2, 3), st.reshape(b, nc, h, p, n),
                cd.reshape(b, nc, h), sd.reshape(b, nc, h, cs).movedim(2, 3))
    dA = dtc * A                                                  # (b,nc,cs,h)
    dA_cum = torch.cumsum(dA, dim=2)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))             # (b,nc,h,cs,cs)
    CB = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    Y_diag = torch.einsum("bchls,bcsh,bcshp->bclhp", CB * Lmat, dtc, xc)
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)       # (b,nc,cs,h)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", Bc, decay_states * dtc, xc)
    return Y_diag, states, torch.exp(dA_cum[:, :, -1, :]), torch.exp(dA_cum)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None,
                backend: Optional[str] = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan (Mamba-2 §6 listing).

    x: (b, s, h, p); dt: (b, s, h) post-softplus; A: (h,) negative;
    B, C: (b, s, h, n) (groups already broadcast to heads).
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) fp32).
    fp32 math inside; the intra-chunk terms on ``backend``
    (:func:`_intra_chunk`), the recurrence across chunks a loop over them.
    A ragged tail is zero padded: dt = 0 there, so its decay is the
    identity and its input zero."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        padseq = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))   # noqa: E731
        x_, dt, B, C = padseq(x), padseq(dt), padseq(B), padseq(C)
    else:
        x_ = x
    sp = s + pad
    nc = sp // chunk
    f32 = torch.float32
    xc = x_.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = B.reshape(b, nc, chunk, h, n).to(f32)
    Cc = C.reshape(b, nc, chunk, h, n).to(f32)
    Y_diag, states, chunk_decay, state_decay = _intra_chunk(
        xc, dtc, A.to(f32), Bc, Cc, dispatch.resolve_backend(backend, x.device))

    # inter-chunk recurrence: each chunk sees the state before it
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device) if init_state is None
             else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                        # (b,nc,h,p,n)

    Y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, prev_states, state_decay)
    y = (Y_diag + Y_off).reshape(b, sp, h, p)
    if pad:
        y = y[:, :s]
    return y.to(x.dtype), state


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xBC: (b, s, c); w: (c, k)."""
    k = w.shape[-1]
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[:, i]
    return out + bias


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner = cfg.ssm.d_inner(cfg.d_model)
    c = conv_dim(cfg)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + c],
            zxbcdt[..., d_inner + c:])


def mamba_mixer(lp: Params, x: torch.Tensor, cfg: ModelConfig, want_state: bool = False,
                backend: Optional[str] = "auto"):
    """x: (b, s, d_model) -> y (b, s, d_model) [, (conv_state (b, c, k-1),
    ssm_state (b, h, p, n) fp32)]."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    d_inner = s_cfg.d_inner(cfg.d_model)
    nh, hp, gn, n = (s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.n_groups,
                     s_cfg.d_state)

    z, xBC, dt = _split_zxbcdt(x @ lp["in_proj"].to(x.dtype), cfg)
    conv_in = xBC
    xBC = F.silu(_causal_conv(xBC, lp["conv_w"].to(x.dtype), lp["conv_b"].to(x.dtype)))
    xs = xBC[..., :d_inner].reshape(b, s, nh, hp)
    rep = nh // gn
    Bmat = xBC[..., d_inner:d_inner + gn * n].reshape(b, s, gn, n).repeat_interleave(rep, 2)
    Cmat = xBC[..., d_inner + gn * n:].reshape(b, s, gn, n).repeat_interleave(rep, 2)
    dt = F.softplus(dt.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])

    y, final_state = ssd_chunked(xs, dt, A, Bmat, Cmat, s_cfg.chunk_size, backend=backend)
    y = y + xs * lp["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps)
    out = y @ lp["out_proj"].to(x.dtype)
    if want_state:
        conv_state = conv_in[:, -(s_cfg.d_conv - 1):, :].transpose(1, 2)   # (b,c,k-1)
        return out, (conv_state, final_state)
    return out


def mamba_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                backend: Optional[str] = "auto") -> torch.Tensor:
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    return x + mamba_mixer(lp, h, cfg, backend=backend)


def remat_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, backend: str,
                remat: Optional[Dict]) -> torch.Tensor:
    """:func:`mamba_block`, under ``torch.utils.checkpoint`` with ``remat``'s
    keyword arguments (:func:`repro_torch.models.transformer._remat`) unless
    it is None."""
    if remat is None:
        return mamba_block(lp, x, cfg, backend)
    # the block draws no random numbers: no RNG state to restore
    return checkpoint(mamba_block, lp, x, cfg, backend, use_reentrant=False,
                      preserve_rng_state=False, **remat)


# --------------------------------------------------------------------------
# model-level entry points
# --------------------------------------------------------------------------

def trunk(params: Params, x: torch.Tensor, cfg: ModelConfig,
          backend: Optional[str] = "auto") -> torch.Tensor:
    """Embedded inputs (B, S, D) -> final hidden states.  While grad is
    enabled under ``remat_policy`` "nothing" or "dots" each block runs under
    ``torch.utils.checkpoint`` (the JAX package's ``_remat``): its recompute
    in the backward runs the block's forward, and its SSD kernels, again."""
    remat = TT._remat(cfg) if torch.is_grad_enabled() else None
    # resolved now: a checkpoint's recompute runs in the backward, outside
    # the caller's use_backend scope
    backend = dispatch.resolve_backend(backend, x.device)
    for i in range(cfg.n_layers):
        x = remat_block(_layer(params["layers"], i), x, cfg, backend, remat)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params: Params, tokens: torch.Tensor, h: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss over final hidden states h of ``tokens``: labels the
    tokens shifted by one, the last position masked; (nll, dict(nll=,
    aux=0)).  The shared chunked cross-entropy ``transformer._xent``."""
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=tokens.device),
                 (0, 1))
    nll = TT._xent(params, h, labels, mask, cfg)
    return nll, dict(nll=nll, aux=torch.zeros((), dtype=torch.float32, device=h.device))


def loss(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
         ) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss of ``batch['tokens']`` (B, S) int64; the embedding
    has no ``embed_scale``, as in the reference."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, _dtype(cfg))
    return lm_loss(params, tokens, trunk(params, x, cfg, backend), cfg)


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device="cuda") -> Dict:
    """An empty cache on ``device`` (the card unless the caller asks for the
    CPU).  The SSM state is O(1) in the sequence length: ``max_seq`` is not
    read."""
    del max_seq
    s = cfg.ssm
    nh, hp = s.n_heads(cfg.d_model), s.head_dim
    return dict(
        conv=torch.zeros((cfg.n_layers, batch_size, conv_dim(cfg), s.d_conv - 1),
                         dtype=_dtype(cfg), device=device),
        ssm=torch.zeros((cfg.n_layers, batch_size, nh, hp, s.d_state), dtype=torch.float32,
                        device=device),
        len=0)


def prefill(params: Params, batch: Dict, cfg: ModelConfig, backend: Optional[str] = "auto"
            ) -> Tuple[torch.Tensor, Dict]:
    """Full forward over the prompt (``batch['tokens']`` (B, S) int64);
    returns (last-token logits (B, Vp) f32, the cache after S tokens).
    Under an active mesh, this rank's rows on its blocks, as
    :func:`repro_torch.models.transformer.prefill` runs them: the whole
    mixer for its rows (B6 on every SSD chunk), then its block of the
    states, ``ssm``'s heads and ``conv``'s channels."""
    tokens = batch["tokens"]
    b_all, s = tokens.shape
    view = SV.begin(params, cfg, b_all, s, seq=s)
    tokens = view.rows(tokens)
    x = L.embed(view.get("embed"), tokens, _dtype(cfg))
    conv, ssm = [], []
    for i in range(cfg.n_layers):
        lp = view.layer("layers", i)
        hn = L.rms_norm(x, lp["norm"], cfg.norm_eps)
        out, (conv_s, ssm_s) = mamba_mixer(lp, hn, cfg, want_state=True, backend=backend)
        x = x + out
        conv.append(view.cut("conv", conv_s))
        ssm.append(view.cut("ssm", ssm_s))
        del lp
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return TT.logits_head(TT._head(view, cfg), h, cfg)[:, 0, :], view.finish(dict(
        conv=torch.stack(conv), ssm=torch.stack(ssm), len=s))


def _part(t: torch.Tensor, dim: int, lo: int, n: int) -> torch.Tensor:
    """``t``'s [lo, lo + n) along ``dim``: ``t`` itself where that is all of
    it (one device: no slicing op on the decode's host-bound path)."""
    return t if lo == 0 and n == t.shape[dim] else t.narrow(dim, lo, n)


def mamba_decode_mixer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor, view=None):
    """Single-token recurrence. x: (b, d_model); conv_state: (b, c, k-1);
    ssm_state: (b, h, p, n) f32.  Returns (y (b, d_model), new conv state,
    new SSM state (fp32)).

    ``view``: a serving view over a mesh
    (:class:`repro_torch.sharding.serve.MeshView`) whose states are this
    rank's blocks, ``conv``'s channels and ``ssm``'s heads: the rank
    convolves its channels (the conv outputs gathered over the axes that
    split them), updates its heads' states and gathers y over the axes
    that split the heads before the gated norm and the output projection."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    d_inner = s_cfg.d_inner(cfg.d_model)
    nh, hp, gn, n = (s_cfg.n_heads(cfg.d_model), s_cfg.head_dim, s_cfg.n_groups,
                     s_cfg.d_state)
    z, xBC, dt = _split_zxbcdt(x @ lp["in_proj"].to(x.dtype), cfg)
    view = view or SV.LocalView(None)
    c0, cn = view.channels("conv", 2, xBC.shape[-1])
    h0, hn = view.channels("ssm", 2, nh)
    conv = lambda t, dim: _part(t, dim, c0, cn)        # noqa: E731
    heads = lambda t, dim: _part(t, dim, h0, hn)       # noqa: E731

    window = torch.cat([conv_state, conv(xBC, 1)[:, :, None]], dim=-1)  # (b,c,k)
    new_conv_state = window[..., 1:]
    conv_out = torch.sum(window * conv(lp["conv_w"], 0).to(x.dtype), dim=-1) \
        + conv(lp["conv_b"], 0).to(x.dtype)
    xBC = F.silu(view.join("conv", 2, conv_out, 1))

    xs = heads(xBC[..., :d_inner].reshape(b, nh, hp), 1)
    Bv = xBC[..., d_inner:d_inner + gn * n].reshape(b, gn, n).repeat_interleave(nh // gn, 1)
    Cv = xBC[..., d_inner + gn * n:].reshape(b, gn, n).repeat_interleave(nh // gn, 1)
    Bv, Cv = heads(Bv, 1), heads(Cv, 1)
    dt = heads(F.softplus(dt.float() + lp["dt_bias"]), 1)               # (b, h)
    A = -torch.exp(heads(lp["A_log"], 0))
    dA = torch.exp(dt * A)                                              # (b, h)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, Bv.float(), xs.float())
    new_state = ssm_state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cv.float()).to(x.dtype)
    y = y + xs * heads(lp["D"], 0).to(x.dtype)[None, :, None]
    y = view.join("ssm", 2, y.reshape(b, hn * hp), 1)
    y = L.rms_norm(y * F.silu(z), lp["gate_norm"], cfg.norm_eps)
    return y @ lp["out_proj"].to(x.dtype), new_conv_state, new_state


def decode_step(params: Params, cache: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                backend: Optional[str] = "auto") -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int64.  Returns (logits (B, Vp) f32,
    the cache at ``len + 1``).  The new conv and SSM states are written into
    the cache's tensors in place (the JAX package returns new ones): the
    returned cache shares them, and the one passed in must not be decoded
    from again.  Under an active mesh, this rank's rows on its blocks
    (:func:`mamba_decode_mixer`).  No kernel runs here: ``backend`` is
    taken for the API's sake."""
    del backend
    view = SV.begin(params, cfg, tokens.shape[0], 1, cache=cache)
    tokens = view.rows(tokens)
    x = L.embed(view.get("embed"), tokens[:, 0], _dtype(cfg))
    conv, ssm = cache["conv"], cache["ssm"]
    for i in range(cfg.n_layers):
        lp = view.layer("layers", i)
        hn = L.rms_norm(x, lp["norm"], cfg.norm_eps)
        out, conv[i], ssm[i] = mamba_decode_mixer(lp, hn, cfg, conv[i], ssm[i], view)
        x = x + out
        del lp
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return TT.logits_head(TT._head(view, cfg), h[:, None, :], cfg)[:, 0, :], {
        **cache, "len": cache["len"] + 1}
