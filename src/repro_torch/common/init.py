"""Weight initializers on explicit ``torch.Generator``s (fan-in scaled).

Torch cannot reproduce ``jax.random`` draws, so a port model initialized
from a seed has its own random weights; to compute exactly what a JAX model
computes, carry its weights across with :mod:`repro_torch.bridge`."""
from __future__ import annotations

import math

import torch


def normal_init(gen: torch.Generator, shape, std: float = 0.02,
                device=None) -> torch.Tensor:
    """``std`` times standard normals drawn on ``gen``'s device (a CUDA
    generator draws on the card, so a model of billions of weights is not
    drawn on one host thread), then moved to ``device`` (default: where
    they were drawn).  A CPU generator's draws do not depend on
    ``device``."""
    return (std * torch.randn(shape, generator=gen, device=gen.device)).to(device)


def lecun_normal(gen: torch.Generator, shape, fan_in: int,
                 device=None) -> torch.Tensor:
    """std = 1/sqrt(fan_in)."""
    return normal_init(gen, shape, 1.0 / math.sqrt(fan_in), device)
