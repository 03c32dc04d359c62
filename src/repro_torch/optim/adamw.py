"""AdamW as the JAX package writes it (``repro/optim/adamw.py``), a pure
function ``(params, grads, state, lr) -> (params, state)`` on trees of
tensors, not ``torch.optim.AdamW``: bias correction keyed on the state's
update ``count``, weight decay on leaves of two or more dimensions only
(norms and biases exempt), and a state dtype policy.

state dtype:
  'float32'   classic
  'bfloat16'  half-size m/v
  'int8'      blockwise-quantized m/v (:mod:`repro_torch.optim.quant`):
              ``mu`` linear, ``nu`` in the log domain, a 4x smaller state

The int8 state quantizes in blocks along the last axis of the JAX
package's layout.  A 4-D conv leaf is OIHW here and HWIO there, so its
state is quantized over the leaf's HWIO view (permuted OIHW -> HWIO
before ``quantize``, back after ``dequantize``): its blocks run along the
output channels as the JAX package's do, and its ``{q, scale, n}`` leaves
are the JAX package's layout, which the checkpoints store as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import HWIO_TO_OIHW, OIHW_TO_HWIO
from repro_torch.common.tree import tree_leaves, tree_map, tree_rebuild
from repro_torch.optim.quant import (dequantize, dequantize_log, is_quantized,
                                     quantize, quantize_log, zeros_quantized,
                                     zeros_quantized_log)

Tree = Any
STATE_DTYPES = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"     # 'float32' | 'bfloat16' | 'int8'

    def __post_init__(self):
        if self.state_dtype not in STATE_DTYPES:
            raise ValueError(f"AdamW state_dtype={self.state_dtype!r} (choose "
                             f"from {STATE_DTYPES})")


def _jax_shape(p: torch.Tensor) -> Tuple[int, ...]:
    return tuple(p.permute(*OIHW_TO_HWIO).shape) if p.dim() == 4 else tuple(p.shape)


def _zeros_state(p: torch.Tensor, cfg: AdamWConfig, log: bool):
    if cfg.state_dtype == "int8":
        make = zeros_quantized_log if log else zeros_quantized
        return make(_jax_shape(p), device=p.device)
    return torch.zeros(p.shape, dtype=getattr(torch, cfg.state_dtype), device=p.device)


def _read_state(s, p: torch.Tensor, cfg: AdamWConfig, log: bool) -> torch.Tensor:
    if cfg.state_dtype != "int8":
        return s.float()
    x = (dequantize_log if log else dequantize)(s, _jax_shape(p)[-1])
    return x.permute(*HWIO_TO_OIHW) if p.dim() == 4 else x


def _write_state(x: torch.Tensor, p: torch.Tensor, cfg: AdamWConfig, log: bool):
    if cfg.state_dtype != "int8":
        return x.to(getattr(torch, cfg.state_dtype))
    if p.dim() == 4:
        x = x.permute(*OIHW_TO_HWIO)
    return (quantize_log if log else quantize)(x)


def adamw_init(params: Tree, cfg: AdamWConfig) -> Dict:
    # mu (signed, well scaled) quantizes linearly; nu (positive, a wide
    # dynamic range under 1/sqrt) in the log domain
    count_device = tree_leaves(params)[0].device
    return dict(mu=tree_map(lambda p: _zeros_state(p, cfg, False), params),
                nu=tree_map(lambda p: _zeros_state(p, cfg, True), params),
                count=torch.zeros((), dtype=torch.int32, device=count_device))


def adamw_update(params: Tree, grads: Tree, state: Dict, lr,
                 cfg: AdamWConfig) -> Tuple[Tree, Dict]:
    """One AdamW step; ``lr`` a float or a 0-dim tensor.  Nothing here
    reads a value back to the host."""
    count = state["count"] + 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float()
        m_f = cfg.b1 * _read_state(m, p, cfg, False) + (1 - cfg.b1) * g
        v_f = cfg.b2 * _read_state(v, p, cfg, True) + (1 - cfg.b2) * g * g
        step = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
        if p.dim() >= 2:     # decay matrices only (norms/bias exempt)
            step = step + cfg.weight_decay * p.float()
        return ((p.float() - lr * step).to(p.dtype), _write_state(m_f, p, cfg, False),
                _write_state(v_f, p, cfg, True))

    leaves = lambda t: tree_leaves(t, is_leaf=is_quantized)  # noqa: E731
    out = [upd(*ls) for ls in zip(*map(leaves, (params, grads, state["mu"],
                                                state["nu"])))]
    pick = lambda i: tree_rebuild(params, [o[i] for o in out])  # noqa: E731
    return pick(0), dict(mu=pick(1), nu=pick(2), count=count)
