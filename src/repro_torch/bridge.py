"""Carry the JAX package's parameters into the port.

``params_from_numpy(tree)`` takes a JAX params pytree whose leaves are numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
params: the same nested dicts and lists, 4-D conv weights turned from HWIO
into OIHW, and blockwise-int8 ``{q, scale, n}`` leaves carried verbatim
(their conv weights stay HWIO, the port's convention for quantized leaves).
With the same weights both packages compute the same function.

``opt_state_from_numpy(opt)`` does the same for an AdamW state
``{mu, nu, count}``: ``mu`` and ``nu`` mirror the params and take the same
layout change, ``count`` is carried as it is, so both packages can start
from the same params *and* optimizer state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)


def _leaf(a, device) -> Any:
    if isinstance(a, (int, float, bool)) or a is None:
        return a
    a = np.array(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: torch reads its bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    else:
        t = torch.from_numpy(a).to(device)
    if t.dim() == 4 and t.is_floating_point():
        t = t.permute(*_HWIO_TO_OIHW).contiguous()
    return t


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """JAX-layout numpy params -> port params on ``device``: the card
    unless the caller asks for the CPU."""
    if isinstance(tree, dict) and {"q", "scale"} <= set(tree):
        n = tree.get("n")
        return dict(q=torch.from_numpy(np.array(tree["q"])).to(device),
                    scale=torch.from_numpy(np.array(tree["scale"])).to(device),
                    n=int(n) if n is not None else int(np.shape(tree["q"])[-1]))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf(tree, device)


def opt_state_from_numpy(opt: Any, device="cuda") -> Any:
    """JAX-layout numpy AdamW state ``{mu, nu, count}`` -> the port's."""
    return dict(mu=params_from_numpy(opt["mu"], device),
                nu=params_from_numpy(opt["nu"], device),
                count=torch.from_numpy(np.array(opt["count"])).to(device))
