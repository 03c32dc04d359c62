"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.common.tree import global_norm, tree_map


def clip_scale(grads, max_norm: float):
    """(min(1, max_norm / max(norm, 1e-12)), norm), both 0-dim tensors left
    on the device: the factor ``clip_by_global_norm`` multiplies every
    gradient by."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / max(norm, 1e-12)), norm), the norm and the
    scale left on the device."""
    scale, norm = clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), norm
