"""The reference's LITE training steps: the task-mean loss, its gradient
(the tasks one after another, their gradients summed), the global-norm clip
and AdamW, from the benchmark's weights, batches and H scores."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.model import adapt, logits


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(tree, leaves: Dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                          for k, v in enumerate(tree))
    return leaves.get(prefix, tree)


def run_steps(cfg: Dict, traffic: Dict, weights: Dict, batches: List[Dict],
              scores: List[torch.Tensor], lower=None) -> Dict:
    """``len(batches)`` steps from ``weights``.  Returns each step's loss,
    the first step's clipped gradient and the trained leaves after the last
    step, by path.  ``lower``: the control (``reference.model``)."""
    opt = cfg["optimizer"]
    h, chunk = traffic["lite_h"], traffic["lite_chunk"]
    leaves = {p: t.detach().clone() for p, t in _flat(weights).items()}   # all trained
    mu = {p: torch.zeros_like(t) for p, t in leaves.items()}
    nu = {p: torch.zeros_like(t) for p, t in leaves.items()}
    losses, grad1 = [], None
    for step, (batch, sc) in enumerate(zip(batches, scores)):
        live = {p: t.clone().requires_grad_(True) for p, t in leaves.items()}
        params = _rebuild(weights, live)
        grads = {p: torch.zeros_like(t) for p, t in leaves.items()}
        total = 0.0
        n_tasks = batch["support_x"].shape[0]
        for t in range(n_tasks):
            h_idx = torch.argsort(sc[t].to(batch["support_x"].device), stable=True)[:h]
            state = adapt(cfg, params, batch["support_x"][t], batch["support_y"][t], h_idx, chunk,
                          lower)
            lg = logits(cfg, params, state, batch["query_x"][t], lower)
            loss = F.cross_entropy(lg, batch["query_y"][t]) / n_tasks
            gs = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
            for p, g in zip(live, gs):
                if g is not None:
                    grads[p] += g
            total += float(loss.detach())
        losses.append(total)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, opt["max_grad_norm"] / max(float(norm), 1e-12))
        grads = {p: g * scale for p, g in grads.items()}
        if step == 0:
            grad1 = {p: g.clone() for p, g in grads.items()}
        c1 = 1.0 - opt["b1"] ** (step + 1)
        c2 = 1.0 - opt["b2"] ** (step + 1)
        for p, g in grads.items():
            mu[p] = opt["b1"] * mu[p] + (1 - opt["b1"]) * g
            nu[p] = opt["b2"] * nu[p] + (1 - opt["b2"]) * g * g
            upd = (mu[p] / c1) / (torch.sqrt(nu[p] / c2) + opt["eps"])
            if leaves[p].dim() >= 2:
                upd = upd + opt["weight_decay"] * leaves[p]
            leaves[p] = leaves[p] - opt["lr"] * upd
    return dict(losses=losses, grad1=grad1, params=leaves)
