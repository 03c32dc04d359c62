"""Mixture-of-Experts FFN with sort-based token dispatch: the port of the JAX
package's ``repro/models/moe.py`` on one device (its expert-parallel
``moe_ffn_sharded`` is ROADMAP A12).

Token -> expert assignments are sorted by expert id, packed into an
(E, C, D) capacity buffer, run through one grouped matmul per projection
and combined back with the router weights.  C = :func:`capacity`; a slot
past capacity is dropped (GShard semantics).  The three expert projections
go through :func:`repro_torch.kernels.dispatch.gmm`: the hand-written gmm
kernel (B7) on the ``cuda`` backend, forward and backward (its autograd
Function), the reference's einsum otherwise.

Where PyTorch differs from JAX, the port keeps the reference's numbers:

* **Top-k ties.**  ``jax.lax.top_k`` takes the lower index first.
  ``torch.topk`` documents no order among equal values (on the CPU an
  all-equal row of 10 comes back as 8, 6, 7, 5), so the router takes the
  first k of a stable descending sort, which breaks ties by the lower
  index.
* **The sort.**  ``jnp.argsort`` is stable and so is this one
  (``stable=True``): within an expert, slots go in token order, and the
  capacity drop set is the reference's.
* **Pack and combine** are gathers, not scatter-adds.  Slot j of expert e
  holds the token at sorted position starts[e] + j (the reference's
  scatter adds each kept token into its own slot, onto zeros); each token
  adds its k weighted expert outputs one at a time in the compute dtype, in
  ascending expert id, the order in which the reference's scatter-add meets
  them.  The pack's backward is the same fixed-order gather (:class:`_Pack`).
  No atomics, so two runs on the card give the same bits, forward and
  backward.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.init import lecun_normal
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import dispatch

Params = Dict


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, device=None,
             lead=()) -> Params:
    """Router (D, E), experts (E, D, F) / (E, F, D) and, with ``n_shared``,
    a shared gated MLP of width ``n_shared * d_ff``; ``lead`` prefixes every
    leaf's shape."""
    e, f = cfg.n_experts, cfg.d_ff
    dev = torch.device(device) if device is not None else gen.device
    p = dict(
        router=lecun_normal(gen, (*lead, d_model, e), d_model, dev),
        w_gate=lecun_normal(gen, (*lead, e, d_model, f), d_model, dev),
        w_up=lecun_normal(gen, (*lead, e, d_model, f), d_model, dev),
        w_down=lecun_normal(gen, (*lead, e, f, d_model), f, dev),
    )
    if cfg.n_shared > 0:
        sf = cfg.n_shared * f
        p["shared"] = dict(
            w_gate=lecun_normal(gen, (*lead, d_model, sf), d_model, dev),
            w_up=lecun_normal(gen, (*lead, d_model, sf), d_model, dev),
            w_down=lecun_normal(gen, (*lead, sf, d_model), sf, dev),
        )
    return p


def router_probs(p: Params, x: torch.Tensor, cfg: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (weights (T, k) renormalised, expert ids (T, k), probs
    (T, E)), in f32; ties go to the lower expert id."""
    logits = x.float() @ p["router"].float()
    if cfg.router_softcap is not None:
        logits = cfg.router_softcap * torch.tanh(logits / cfg.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i, probs


def load_balance_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e, f_e the share of the
    T * k assignments that went to expert e."""
    f = torch.bincount(expert_ids.reshape(-1), minlength=n_experts).float() \
        / expert_ids.numel()
    return n_experts * torch.sum(f * probs.mean(dim=0))


def capacity(t: int, cfg: MoEConfig) -> int:
    c = int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)   # align slots


class _Pack(torch.autograd.Function):
    """The capacity buffer: ``buf[e, j] = x[rows[e, j]]`` where
    ``filled[e, j]``, else 0.

    Backward: a token's gradient is the sum of its kept slots' gradients,
    added one at a time in the compute dtype in ascending expert id (its
    sorted positions ``pos``), the order in which the reference's
    scatter-add into x (the transpose of its gather ``x[tok_sorted]``)
    meets them; a slot dropped at capacity (clamped to slot c - 1) adds
    exactly 0.  Autograd's own backward of the gather is an indexed add
    whose order among a token's k slots, and whose precision, are the
    library's; this one is a fixed-order gather, like the combine."""

    @staticmethod
    def forward(ctx, x, rows, filled, slot, keep, pos):
        ctx.save_for_backward(slot, keep, pos)
        ctx.tokens = x.shape[0]
        return torch.where(filled, x[rows], torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, g):
        slot, keep, pos = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        dx = torch.zeros((ctx.tokens, g.shape[1]), dtype=g.dtype, device=g.device)
        for i in range(pos.shape[1]):
            s = pos[:, i]
            dx = dx + torch.where(keep[s][:, None], g[slot[s]], zero)
        return dx, None, None, None, None, None


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig,
            backend: Optional[str] = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flattened tokens -> (y (T, D) in x's dtype, aux loss f32)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)
    dev = x.device

    weights, expert_ids, probs = router_probs(p, x, cfg)        # (T, k)
    aux = load_balance_loss(probs, expert_ids, e)

    flat_e = expert_ids.reshape(-1)                              # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // k                                      # token of slot
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts                    # segment starts
    pos_in_e = torch.arange(t * k, device=dev) - starts[e_sorted]   # rank in expert
    keep = pos_in_e < c                                          # capacity drop
    slot = e_sorted * c + torch.clamp(pos_in_e, max=c - 1)

    # each token's k sorted positions in ascending expert id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    pos = torch.sort(inv.reshape(t, k), dim=1).values            # (T, k)

    # pack: slot j of expert e takes sorted position starts[e] + j, if any
    j = torch.arange(c, device=dev)
    src = torch.clamp(starts[:, None] + j, max=t * k - 1)        # (E, C)
    filled = (j < counts[:, None])[..., None]
    buf = _Pack.apply(x, tok_sorted[src], filled, slot, keep, pos)

    # grouped expert FFN: one grouped matmul per projection (B7 on cuda)
    dt = x.dtype
    g = F.silu(dispatch.gmm(buf, p["w_gate"].to(dt), backend=backend))
    u = dispatch.gmm(buf, p["w_up"].to(dt), backend=backend)
    out = dispatch.gmm(g * u, p["w_down"].to(dt), backend=backend).reshape(e * c, d)

    # combine: each token's k slots in ascending expert id (sorted position)
    scale = (weights.reshape(-1)[order] * keep).to(dt)
    y = torch.zeros((t, d), dtype=dt, device=dev)
    for i in range(k):
        s = pos[:, i]
        y = y + out[slot[s]] * scale[s][:, None]

    if cfg.n_shared > 0:
        sp = p["shared"]
        sg = F.silu(x @ sp["w_gate"].to(dt))
        su = x @ sp["w_up"].to(dt)
        y = y + (sg * su) @ sp["w_down"].to(dt)
    return y, aux
