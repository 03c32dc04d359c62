"""Plain PyTorch oracles, one for each function of the JAX package's kernel
oracles, with the same names, signatures and layouts.  The tests hold the
kernels' plain versions and the entry point :mod:`repro_torch.kernels.ops`
against them; nothing on a card's main path calls them."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (BH, S, D) -> (BH, S, D) in q's dtype."""
    s = q.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def mahalanobis_ref(q, mu, sinv) -> torch.Tensor:
    """q: (B, F); mu: (C, F); sinv: (C, F, F) -> d2 (B, C)."""
    diff = q.float()[:, None, :] - mu.float()[None]
    return torch.einsum("bcf,cfg,bcg->bc", diff, sinv.float(), diff)


def one_hot(labels, num_classes: int) -> torch.Tensor:
    """(B,) integer labels -> (B, C) fp32 one-hot; a label outside [0, C)
    gives a zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes).float()


def segment_pool_ref(x, labels, num_classes: int):
    """x: (B, F); labels: (B,) -> (sums (C, F), counts (C,))."""
    onehot = one_hot(labels, num_classes)
    return torch.einsum("bc,bf->cf", onehot, x.float()), onehot.sum(dim=0)


def ssd_chunk_ref(x, dt, A, B, C):
    """Intra-chunk SSD terms for ONE chunk.

    x: (Q, H, P); dt: (Q, H); A: (H,); B, C: (Q, H, N)
    Returns (y_diag (Q, H, P), state (H, P, N), chunk_decay (H,),
             state_decay (Q, H)).
    """
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    dA_cum = torch.cumsum(dt * A[None, :], dim=0)                # (Q, H)
    q = x.shape[0]
    seg = dA_cum[:, None, :] - dA_cum[None, :, :]                # (Q, Q, H) l - s
    pos = torch.arange(q, device=x.device)
    mask = (pos[:, None] >= pos[None, :])[..., None]
    # exp only where l >= s: above the diagonal seg > 0 may overflow
    L = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    CB = torch.einsum("lhn,shn->lsh", C, B)
    y_diag = torch.einsum("lsh,sh,shp->lhp", CB * L, dt, x)
    decay_states = torch.exp(dA_cum[-1:, :] - dA_cum)            # (Q, H)
    state = torch.einsum("qhn,qh,qhp->hpn", B, decay_states * dt, x)
    return y_diag, state, torch.exp(dA_cum[-1]), torch.exp(dA_cum)


def gmm_ref(x, w) -> torch.Tensor:
    """Grouped (per-expert) matmul: x (E, C, D), w (E, D, F) -> (E, C, F),
    summed in fp32 (fp64 for fp64 operands)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum("ecd,edf->ecf", x.to(acc), w.to(acc)).to(x.dtype)
