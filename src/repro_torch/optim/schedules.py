"""LR schedules: cosine (llama-style) and WSD (warmup-stable-decay), as
functions of the optimizer's update count (an int or a 0-dim tensor) that
return an fp32 tensor."""
from __future__ import annotations

import functools
import math

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float):
    return peak * torch.clamp((_as_f32(step) + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    s = _as_f32(step)
    warm = linear_warmup(s, warmup_steps, peak)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, peak * cos)


def wsd_schedule(step, peak: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, final_frac: float = 0.01):
    """Warmup -> Stable (constant peak) -> Decay (exponential-ish linear)."""
    s = _as_f32(step)
    warm = linear_warmup(s, warmup_steps, peak)
    in_decay = s >= warmup_steps + stable_steps
    t = torch.clamp((s - warmup_steps - stable_steps) / max(decay_steps, 1), 0.0, 1.0)
    decay = peak * torch.exp(math.log(final_frac) * t)
    return torch.where(s < warmup_steps, warm,
                       torch.where(in_decay, decay, torch.full_like(s, peak)))


def schedule_for(name, peak: float, warmup_steps: int, total_steps: int):
    """A schedule name -> a ``step -> lr`` callable; ``None`` -> None (the
    constant-lr contract).  'wsd' is 80 % stable and 18 % decay of
    ``total_steps``.  The step is the optimizer's update count, so a resume
    from a checkpoint lands on the same lr."""
    if name is None:
        return None
    if total_steps <= 0:
        raise ValueError(f"schedule={name!r} needs total_steps > 0")
    if name == "cosine":
        return functools.partial(cosine_schedule, peak=peak,
                                 warmup_steps=warmup_steps,
                                 total_steps=total_steps)
    if name == "wsd":
        return functools.partial(
            wsd_schedule, peak=peak, warmup_steps=warmup_steps,
            stable_steps=int(total_steps * 0.8),
            decay_steps=max(int(total_steps * 0.18), 1))
    raise ValueError(f"unknown schedule {name!r} (None|'cosine'|'wsd')")
