"""AdamW as the JAX package writes it (``repro/optim/adamw.py``), a pure
function ``(params, grads, state, lr) -> (params, state)`` on trees of
tensors, not ``torch.optim.AdamW``: bias correction keyed on the state's
update ``count``, weight decay on leaves of two or more dimensions only
(norms and biases exempt), and a state dtype policy.

state dtype:
  'float32'   classic
  'bfloat16'  half-size m/v

The JAX package's 'int8' state quantizes m/v in blocks along
``p.shape[-1]``; the port's conv weights are OIHW where the JAX package's
are HWIO, so those blocks would run along another axis.  It waits for its
own decision (ROADMAP) and raises here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_rebuild

Tree = Any
STATE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"     # 'float32' | 'bfloat16'

    def __post_init__(self):
        if self.state_dtype not in STATE_DTYPES:
            raise ValueError(
                f"AdamW state_dtype={self.state_dtype!r} is not ported "
                f"(choose from {STATE_DTYPES}): the int8 state's quantisation "
                f"blocks run along p.shape[-1], which the port's OIHW conv "
                f"weights do not share with the JAX package's HWIO")


def adamw_init(params: Tree, cfg: AdamWConfig) -> Dict:
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    count_device = tree_leaves(params)[0].device
    return dict(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                count=torch.zeros((), dtype=torch.int32, device=count_device))


def adamw_update(params: Tree, grads: Tree, state: Dict, lr,
                 cfg: AdamWConfig) -> Tuple[Tree, Dict]:
    """One AdamW step; ``lr`` a float or a 0-dim tensor.  Nothing here
    reads a value back to the host."""
    dt = getattr(torch, cfg.state_dtype)
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float()
        m_f = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_f = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        step = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
        if p.dim() >= 2:     # decay matrices only (norms/bias exempt)
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m_f.to(dt), v_f.to(dt)

    out = [upd(*leaves) for leaves in zip(*map(tree_leaves, (
        params, grads, state["mu"], state["nu"])))]
    pick = lambda i: tree_rebuild(params, [o[i] for o in out])  # noqa: E731
    return pick(0), dict(mu=pick(1), nu=pick(2), count=count)
