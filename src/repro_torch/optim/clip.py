"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.common.tree import global_norm, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / max(norm, 1e-12)), norm), the norm and the
    scale left on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
