"""Simple CNAPs Mahalanobis head over a leading task-lane axis:

    d2[t, m, c] = (q[t, m] - mu[t, c])^T Sinv[t, c] (q[t, m] - mu[t, c])

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/mahalanobis.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_tensor, ptr, require, stream


def mahalanobis_plain(q: torch.Tensor, mu: torch.Tensor,
                      sinv: torch.Tensor) -> torch.Tensor:
    """q: (T, M, F); mu: (T, C, F); sinv: (T, C, F, F) -> (T, M, C)."""
    diff = q.float()[:, :, None, :] - mu.float()[:, None, :, :]   # (T, M, C, F)
    t = torch.einsum("tmci,tcij->tmcj", diff, sinv.float())
    return torch.sum(t * diff, dim=-1)


def mahalanobis(q: torch.Tensor, mu: torch.Tensor,
                sinv: torch.Tensor) -> torch.Tensor:
    """q: (T, M, F); mu: (T, C, F); sinv: (T, C, F, F), all fp32 ->
    (T, M, C) fp32 squared distances."""
    if q.device.type == "cpu":
        return mahalanobis_plain(q, mu, sinv)
    check_tensor("q", q, 3, (torch.float32,), q.device)
    check_tensor("mu", mu, 3, (torch.float32,), q.device)
    check_tensor("sinv", sinv, 4, (torch.float32,), q.device)
    t, m, f = q.shape
    c = mu.shape[1]
    require(mu.shape == (t, c, f), lambda: f"mu {tuple(mu.shape)} vs q {tuple(q.shape)}")
    require(sinv.shape == (t, c, f, f), lambda: f"sinv {tuple(sinv.shape)} vs mu {tuple(mu.shape)}")
    out = torch.empty((t, m, c), dtype=torch.float32, device=q.device)
    _build.launch("rt_mahalanobis", "mahalanobis", ptr(q), ptr(mu), ptr(sinv),
                  ptr(out), t, m, c, f, stream(q.device))
    return out
