"""FiLM (Perez et al. 2018): film(x) = x * (1 + gamma) + beta per channel,
with gamma/beta generated per task from the set encoder's task embedding by
a 2-layer MLP per site (paper Fig. B.4)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.common.init import lecun_normal, normal_init
from repro_torch.common.linear import matmul


def apply_film(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               channel_axis: int = 1) -> torch.Tensor:
    """``x * (1 + gamma) + beta`` broadcast over every axis but the channel
    axis.  gamma/beta (C,) apply to every row; (T, C) apply task t to the
    t-th of T equal groups of rows along axis 0."""
    ca = channel_axis % x.dim()
    if gamma.dim() == 1:
        shape = [1] * x.dim()
        shape[ca] = x.shape[ca]
        return x * (1.0 + gamma.reshape(shape).to(x.dtype)) + \
            beta.reshape(shape).to(x.dtype)
    t = gamma.shape[0]
    xt = x.unflatten(0, (t, -1))                         # (T, n, ...)
    shape = [t] + [1] * (xt.dim() - 1)
    shape[ca + 1] = x.shape[ca]
    out = xt * (1.0 + gamma.reshape(shape).to(x.dtype)) + \
        beta.reshape(shape).to(x.dtype)
    return out.flatten(0, 1)


def init_film_generator(gen: torch.Generator, task_dim: int,
                        channel_sizes: Sequence[int], hidden: int = 64,
                        out_std: float = 0.01, device=None) -> Dict:
    """Per-site MLP z -> hidden -> (gamma, beta); small random output layers
    start near the identity."""
    sites = []
    for ch in channel_sizes:
        sites.append(dict(
            w1=lecun_normal(gen, (task_dim, hidden), task_dim, device),
            b1=torch.zeros(hidden, device=device),
            w_gamma=normal_init(gen, (hidden, ch), out_std, device),
            b_gamma=torch.zeros(ch, device=device),
            w_beta=normal_init(gen, (hidden, ch), out_std, device),
            b_beta=torch.zeros(ch, device=device)))
    return dict(sites=sites)


def generate_film_params(params: Dict, z: torch.Tensor) -> List[Dict]:
    """Task embedding(s) z (task_dim,) or (T, task_dim) -> per-site
    {gamma, beta} of shape (C,) or (T, C)."""
    out = []
    for site in params["sites"]:
        h = torch.relu(matmul(z, site["w1"]) + site["b1"])
        out.append(dict(gamma=matmul(h, site["w_gamma"]) + site["b_gamma"],
                        beta=matmul(h, site["w_beta"]) + site["b_beta"]))
    return out
