"""Mixture-of-Experts FFN with sort-based token dispatch: the port of the JAX
package's ``repro/models/moe.py``, on one device (:func:`moe_ffn`) and
expert-parallel over a (data, model) mesh (:func:`moe_ffn_sharded`).

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

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.init import lecun_normal
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import (all_gather, grad_all_reduce, local_block, pmean,
                                     reduce_scatter)

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


def _token_positions(order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Each token's k positions in the sorted order, in ascending expert
    id: (T, k)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    return torch.sort(inv.reshape(t, k), dim=1).values


def _shared_ffn(sp: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' gated MLP on x, in x's dtype."""
    dt = x.dtype
    return (F.silu(x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))) @ sp["w_down"].to(dt)


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

    pos = _token_positions(order, t, k)                           # (T, k)

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
        y = y + _shared_ffn(p["shared"], x)
    return y, aux


# ===========================================================================
# Expert parallelism over a (data, model) mesh (the reference's shard_map
# path, ``moe.py:125-256``).  Tokens stay on their (pod, data) shard; every
# ``model`` rank routes all of its shard's tokens (redundantly, in f32) and
# runs only its own E/m experts on them; one all-gather over ``model`` on
# the way in and one reduce-scatter on the way out, 2 x T_loc x D a layer.
# Two layouts of a rank's block of the (T, D) tokens, as the residual
# stream's: 'hidden' (T_loc, D/m), gathered and scattered on the hidden
# axis; 'seq' (T_loc/m, D), on the token axis.
#
# The gradient contract (what the LM step builds on): the block's gradient
# is this rank's; a replicated leaf's (the router, the shared experts,
# every leaf of the fallback) is whole on every model rank, the sum of the
# ranks' parts (an all-reduce over model in the backward); the aux loss is
# the mean over (pod,) data and model, whose backward divides by each.
# ===========================================================================

def ep_applies(cfg: MoEConfig, mesh_shape, t_loc: int, d: int, layout: str) -> bool:
    """Whether :func:`moe_ffn_sharded` runs its expert-parallel body: a
    model axis of more than one rank that divides E and the layout's
    dim (D for 'hidden', the data shard's T_loc tokens for 'seq'); the
    reference's fallback conditions (``moe.py:224-229``) otherwise."""
    n_model = dict(mesh_shape).get("model", 1)
    divides = d % n_model == 0 if layout == "hidden" else t_loc % n_model == 0
    return n_model > 1 and cfg.n_experts % n_model == 0 and divides


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes a batch is split over: (pod, data) where the mesh has pod."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _gather_dim(layout: str) -> int:
    if layout not in ("hidden", "seq"):
        raise ValueError(f"layout={layout!r} (want 'hidden' or 'seq')")
    return 1 if layout == "hidden" else 0


def _moe_local_body(p_local: Params, xf: torch.Tensor, cfg: MoEConfig, mesh,
                    backend: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One model rank's part on its data shard's gathered tokens xf (T_loc,
    D): every token routed, this rank's experts [m0, m0 + E/m) run on their
    slots (capacity of T_loc, as ``moe_ffn`` on the shard), their outputs
    scaled by the router weights and added into (T_loc, D) in each token's
    ascending expert order, zero for the other ranks' experts.  Returns
    that partial sum (to be reduce-scattered over model) and this rank's
    aux loss."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = p_local["w_gate"].shape[0]
    m0 = mesh.coords["model"] * e_loc
    c = capacity(t, cfg)
    dev = xf.device
    router = grad_all_reduce(p_local["router"], mesh, "model")
    weights, expert_ids, probs = router_probs(dict(router=router), xf, cfg)
    aux = load_balance_loss(probs, expert_ids, e)

    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // k
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[e_sorted]
    mine = (e_sorted >= m0) & (e_sorted < m0 + e_loc)
    keep = (pos_in_e < c) & mine
    slot = torch.clamp(e_sorted - m0, 0, e_loc - 1) * c + torch.clamp(pos_in_e, max=c - 1)
    pos = _token_positions(order, t, k)

    j = torch.arange(c, device=dev)
    src = torch.clamp(starts[m0:m0 + e_loc, None] + j, max=t * k - 1)   # (E_loc, C)
    filled = (j < counts[m0:m0 + e_loc, None])[..., None]
    buf = _Pack.apply(xf, tok_sorted[src], filled, slot, keep, pos)

    dt = xf.dtype
    g = F.silu(dispatch.gmm(buf, p_local["w_gate"].to(dt), backend=backend))
    u = dispatch.gmm(buf, p_local["w_up"].to(dt), backend=backend)
    out = dispatch.gmm(g * u, p_local["w_down"].to(dt), backend=backend).reshape(e_loc * c, d)

    scale = (weights.reshape(-1)[order] * keep).to(dt)
    y = torch.zeros((t, d), dtype=dt, device=dev)
    for i in range(k):
        s = pos[:, i]
        y = y + out[slot[s]] * scale[s][:, None]
    return y, aux


def _moe_global(p: Params, x: torch.Tensor, cfg: MoEConfig, mesh,
                backend: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on every data shard's tokens gathered, this shard's rows
    of its output, and its aux (the global one, the same on every rank)."""
    axes = data_axes(mesh)
    y, aux = moe_ffn(p, all_gather(x, mesh, axes, 0, vjp="sum"), cfg, backend=backend)
    return local_block(y, mesh, axes, 0), aux


def moe_ffn_global(p: Params, x: torch.Tensor, cfg: MoEConfig, mesh,
                   backend: Optional[str] = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's fallback under a mesh, ``moe_ffn`` on the global
    tokens: x is this data shard's (T_loc, D), whole on every model rank;
    the shards are gathered over (pod,) data, ``moe_ffn`` runs on all of
    them (the whole expert bank, capacity of the global T) and each rank
    keeps its shard's rows; aux is the global one, averaged over the data
    ranks (the same value; its backward divides by their count)."""
    y, aux = _moe_global(p, x, cfg, mesh, backend)
    return y, pmean(aux, mesh, data_axes(mesh))


def moe_ffn_sharded(p_local: Params, x_local: torch.Tensor, cfg: MoEConfig, mesh,
                    layout: str = "hidden", backend: Optional[str] = "auto",
                    shared: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN on this rank's block of the tokens.

    ``x_local``: (T_loc, D/m) for ``layout='hidden'``, (T_loc/m, D) for
    ``'seq'``, the rank's block of its data shard's tokens; ``p_local``: the
    router whole, the expert banks this rank's E/m experts (E/m, D, F) /
    (E/m, F, D) (whole where E/m does not divide), the shared experts
    whole.  Returns (this rank's block of y, aux averaged over (pod,) data
    and model).  ``shared``: add the shared experts, run on the gathered
    tokens and cut to the block (the LM's ``moe_dispatch`` adds them itself
    on the tokens every model rank holds whole, and passes False).

    Where :func:`ep_applies` does not hold (one model rank, or E not
    divisible by it), the tokens are gathered over model and data and
    ``moe_ffn`` runs on all of them (:func:`moe_ffn_global`), as the
    reference falls back; the block of its output is returned."""
    dim = _gather_dim(layout)
    xf = all_gather(x_local, mesh, "model", dim, vjp="sum")      # (T_loc, D)
    t_loc, d = xf.shape
    axes = data_axes(mesh)
    if ep_applies(cfg, mesh.shape, t_loc, d, layout):
        if p_local["w_gate"].shape[0] * mesh.shape["model"] != cfg.n_experts:
            raise ValueError(f"moe_ffn_sharded: the expert banks hold "
                             f"{p_local['w_gate'].shape[0]} experts, not this rank's "
                             f"{cfg.n_experts} / {mesh.shape['model']}")
        y, aux = _moe_local_body(p_local, xf, cfg, mesh, backend)
        y = reduce_scatter(y, mesh, "model", dim)
    else:
        whole = {k: v for k, v in p_local.items() if k != "shared"}
        whole = tree_map(lambda w: grad_all_reduce(w, mesh, "model"), whole)
        y, aux = _moe_global(whole, xf, dataclasses.replace(cfg, n_shared=0), mesh, backend)
        y = local_block(y, mesh, "model", dim)
    aux = pmean(pmean(aux, mesh, axes), mesh, "model")
    if shared and cfg.n_shared > 0:
        sp = tree_map(lambda w: grad_all_reduce(w, mesh, "model"), p_local["shared"])
        y = y + local_block(_shared_ffn(sp, xf), mesh, "model", dim)
    return y, aux
