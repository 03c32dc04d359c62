"""Weight initializers on explicit ``torch.Generator``s (fan-in scaled).

Torch cannot reproduce ``jax.random`` draws, so a port model initialized
from a seed has its own random weights; to compute exactly what a JAX model
computes, carry its weights across with :mod:`repro_torch.bridge`.

Inside :func:`drawn_as` every draw is cast to the given dtype as soon as it
is drawn, before the next: a model's fp32 draws then never coexist, and
the numbers are those of casting the whole tree after init."""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch

_draw_dtype: contextvars.ContextVar = contextvars.ContextVar("repro_torch_draw_dtype",
                                                             default=None)


@contextlib.contextmanager
def drawn_as(dtype: Optional[torch.dtype]):
    """Scope in which :func:`normal_init` (and so :func:`lecun_normal`)
    returns its draws cast to ``dtype`` (None: as drawn, fp32)."""
    token = _draw_dtype.set(dtype)
    try:
        yield
    finally:
        _draw_dtype.reset(token)


def normal_init(gen: torch.Generator, shape, std: float = 0.02,
                device=None) -> torch.Tensor:
    """``std`` times standard normals drawn on ``gen``'s device (a CUDA
    generator draws on the card, so a model of billions of weights is not
    drawn on one host thread), then moved to ``device`` (default: where
    they were drawn).  A CPU generator's draws do not depend on
    ``device``.  The draw is scaled in place, so a leaf's fp32 draw is its
    only temporary."""
    t = torch.randn(shape, generator=gen, device=gen.device).mul_(std)
    dt = _draw_dtype.get()
    return (t if dt is None else t.to(dt)).to(device)


def lecun_normal(gen: torch.Generator, shape, fan_in: int,
                 device=None) -> torch.Tensor:
    """std = 1/sqrt(fan_in)."""
    return normal_init(gen, shape, 1.0 / math.sqrt(fan_in), device)
