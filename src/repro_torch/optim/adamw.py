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
package's layout.  A conv weight (:func:`repro_torch.bridge.is_conv_weight`:
a 4-D leaf but an MoE layer's experts) is OIHW here and HWIO there, so its
state is quantized over the leaf's HWIO view (permuted OIHW -> HWIO
before ``quantize``, back after ``dequantize``): its blocks run along the
output channels as the JAX package's do, and its ``{q, scale, n}`` leaves
are the JAX package's layout, which the checkpoints store as they are.
Every other leaf, an MoE layer's stacked (L, E, D, F) experts included,
has one layout in both packages.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.bridge import HWIO_TO_OIHW, OIHW_TO_HWIO, is_conv_weight
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths, tree_rebuild
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


def _conv_flags(params: Tree) -> List[bool]:
    """Per leaf of ``params``, in ``tree_leaves`` order: whether it is a
    conv weight (:func:`repro_torch.bridge.is_conv_weight`)."""
    return [is_conv_weight(t, path.rsplit("/", 1)[-1])
            for path, t in tree_paths(params).items()]


def _jax_shape(p: torch.Tensor, conv: bool) -> Tuple[int, ...]:
    return tuple(p.permute(*OIHW_TO_HWIO).shape) if conv else tuple(p.shape)


def _zeros_state(p: torch.Tensor, cfg: AdamWConfig, log: bool, conv: bool):
    if cfg.state_dtype == "int8":
        make = zeros_quantized_log if log else zeros_quantized
        return make(_jax_shape(p, conv), device=p.device)
    return torch.zeros(p.shape, dtype=getattr(torch, cfg.state_dtype), device=p.device)


def _read_state(s, p: torch.Tensor, cfg: AdamWConfig, log: bool, conv: bool) -> torch.Tensor:
    if cfg.state_dtype != "int8":
        return s.float()
    x = (dequantize_log if log else dequantize)(s, _jax_shape(p, conv)[-1])
    return x.permute(*HWIO_TO_OIHW) if conv else x


def _write_state(x: torch.Tensor, cfg: AdamWConfig, log: bool, conv: bool):
    if cfg.state_dtype != "int8":
        return x.to(getattr(torch, cfg.state_dtype))
    if conv:
        x = x.permute(*OIHW_TO_HWIO)
    return (quantize_log if log else quantize)(x)


def adamw_init(params: Tree, cfg: AdamWConfig) -> Dict:
    # mu (signed, well scaled) quantizes linearly; nu (positive, a wide
    # dynamic range under 1/sqrt) in the log domain
    count_device = tree_leaves(params)[0].device
    convs = _conv_flags(params)

    def state(log: bool):
        it = iter(convs)
        return tree_map(lambda p: _zeros_state(p, cfg, log, next(it)), params)

    return dict(mu=state(False), nu=state(True),
                count=torch.zeros((), dtype=torch.int32, device=count_device))


def _upd(p, g, m, v, c1, c2, lr, cfg: AdamWConfig, conv: bool):
    """One leaf's (new param, new mu, new nu)."""
    g = g.float()
    m_f = cfg.b1 * _read_state(m, p, cfg, False, conv) + (1 - cfg.b1) * g
    v_f = cfg.b2 * _read_state(v, p, cfg, True, conv) + (1 - cfg.b2) * g * g
    step = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
    if p.dim() >= 2:     # decay matrices only (norms/bias exempt)
        step = step + cfg.weight_decay * p.float()
    return ((p.float() - lr * step).to(p.dtype), _write_state(m_f, cfg, False, conv),
            _write_state(v_f, cfg, True, conv))


def _bias_corrections(count: torch.Tensor, cfg: AdamWConfig):
    return 1.0 - cfg.b1 ** count.float(), 1.0 - cfg.b2 ** count.float()


def adamw_update(params: Tree, grads: Tree, state: Dict, lr,
                 cfg: AdamWConfig) -> Tuple[Tree, Dict]:
    """One AdamW step; ``lr`` a float or a 0-dim tensor.  Nothing here
    reads a value back to the host."""
    count = state["count"] + 1
    c1, c2 = _bias_corrections(count, cfg)
    leaves = lambda t: tree_leaves(t, is_leaf=is_quantized)  # noqa: E731
    out = [_upd(*ls, c1, c2, lr, cfg, conv)
           for *ls, conv in zip(*map(leaves, (params, grads, state["mu"], state["nu"])),
                                _conv_flags(params))]
    pick = lambda i: tree_rebuild(params, [o[i] for o in out])  # noqa: E731
    return pick(0), dict(mu=pick(1), nu=pick(2), count=count)


# elements of one leaf updated at a time by ``adamw_update_``: its fp32
# temporaries (the gradient, mu, nu, the step) then take a few times 64 MB
# however large the leaf (gemma2-2b's (256000, 2304) embedding is 590 M)
UPDATE_CHUNK = 1 << 24


def _row_slices(p: torch.Tensor, conv: bool = False):
    """Indices that cut ``p`` into blocks of at most about UPDATE_CHUNK
    elements: the first axis one of whose rows (one index of it) fits
    UPDATE_CHUNK is cut in slices of rows, each (but the last) a multiple
    of 64 elements, and the axes before it one index at a time (a stacked
    (L, E, D, F) expert leaf: one layer and a few experts a block).  Every
    block starts at a multiple of 64 elements, so that an elementwise op's
    vectorised body and scalar tail see the same elements as on the whole
    leaf; where one index of the axes before it would not hold a multiple
    of 64, only the leading axis is cut.  The int8 state's blocks run
    along the last axis, so a block holds whole ones; a conv leaf, whose
    int8 state is laid out HWIO, and a leaf of one dimension are not cut."""
    if conv or p.dim() <= 1 or p.numel() <= UPDATE_CHUNK:
        return [...]
    ax = next(i for i in range(p.dim()) if math.prod(p.shape[i + 1:]) <= UPDATE_CHUNK)
    if math.prod(p.shape[ax:]) % 64:
        ax = 0
    row = math.prod(p.shape[ax + 1:])
    align = 64 // math.gcd(row, 64)
    rows = max(align, UPDATE_CHUNK // row // align * align)
    return [(*lead, slice(r, r + rows)) for lead in itertools.product(*map(range, p.shape[:ax]))
            for r in range(0, p.shape[ax], rows)]


def _state_rows(s, rows):
    if is_quantized(s):
        return dict(q=s["q"][rows], scale=s["scale"][rows], n=s["n"])
    return s[rows]


def _assign(dst, src, ok) -> None:
    """``dst[...] = src`` (where ``ok``, else unchanged), a quantized leaf
    part by part."""
    if is_quantized(dst):
        for k in ("q", "scale"):
            _assign(dst[k], src[k], ok)
        return
    dst.copy_(src if ok is None else torch.where(ok, src, dst))


def adamw_update_(params: Tree, grads: List, state: Dict, lr, cfg: AdamWConfig,
                  grad_scale=None, ok=None) -> None:
    """:func:`adamw_update` in place: the leaves of ``params`` and ``state``
    are overwritten with the updated values, the counterpart of a jitted
    step's donated buffers.  ``grads`` is a list in ``tree_leaves(params)``
    order; each entry is set to None once its leaf is updated, so the
    caller's reference is the last.  ``mu`` and ``nu`` are matched to the
    params by path.

    ``grad_scale`` (a 0-dim tensor) multiplies every gradient first,
    ``clip_by_global_norm``'s factor (:func:`repro_torch.optim.clip.
    clip_scale`).  ``ok`` (a 0-dim bool tensor) keeps params and state
    bit-identical where it is false, ``count`` included.  Leaves are
    updated a slice of rows at a time (:func:`_row_slices`), so the peak
    is params, grads and state once each plus one slice's temporaries.
    Bit-equal to ``adamw_update`` after ``clip_by_global_norm`` on the
    CPU."""
    count = state["count"] + 1
    c1, c2 = _bias_corrections(count, cfg)
    leaves = []
    tree_map(lambda p, m, v: leaves.append((p, m, v)), params, state["mu"], state["nu"])
    for i, ((p, m, v), conv) in enumerate(zip(leaves, _conv_flags(params))):
        g, grads[i] = grads[i], None
        for rows in _row_slices(p, conv):
            gs = g[rows] if grad_scale is None else g[rows] * grad_scale
            new = _upd(p[rows], gs, _state_rows(m, rows), _state_rows(v, rows), c1, c2,
                       lr, cfg, conv)
            for dst, src in zip((p[rows], _state_rows(m, rows), _state_rows(v, rows)), new):
                _assign(dst, src, ok)
        del g
    _assign(state["count"], count, ok)
