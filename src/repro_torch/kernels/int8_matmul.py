"""Blockwise-int8 weight x float activation matmul (serving, forward only):

    out[m, n] = sum_k x[m, k] * q[k, n] * scale[k, n // BLOCK]

``q``/``scale`` are the ``{q, scale, n}`` form of
:mod:`repro_torch.optim.quant`.  On a CUDA tensor the wrapper launches the
hand-written kernel (``csrc/int8_matmul.cu``: TM x 32 output tiles, K split
over 8 groups of warps in a block, the scale folded into x) with the plan
that :func:`int8_matmul_plan` picks, or raises; on a CPU tensor it runs the
plain PyTorch version beside it (dequantize, then one GEMM).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_tensor, ptr, require,
                                          require_no_grad, stream)
from repro_torch.optim.quant import BLOCK, dequantize

TILE_N = 32               # output columns a block (kTileN); divides BLOCK
GROUPS = 8                # K groups a block (kGroups); each sums chunk / 8 rows of a chunk
MAX_CHUNK = 256           # K rows a shared-memory stage holds
TARGET_BLOCKS = 128       # about one wave of the H100's 132 SMs


class Int8MatmulPlan(NamedTuple):
    tile_m: int     # output rows a block: 8, or 4 where 8 leaves too few blocks
    chunk: int      # K rows a shared-memory stage holds (a multiple of 32)
    stages: int     # 1: the whole K at once; 2: streamed through two stages
    vec: bool       # 16-byte cp.async of x and q; else 4-byte x and byte loads of q

    @property
    def route(self) -> str:
        return "cp16" if self.vec else "cp4"


@functools.lru_cache(maxsize=256)
def int8_matmul_plan(m: int, k: int, n: int, aligned: bool) -> Int8MatmulPlan:
    """The kernel's plan for x (M, K) @ q (K, N); ``aligned`` says whether
    the bases of x and q are 16-byte aligned.  A plain function of its
    arguments (cached: the serving path asks it on every dispatch).

    Tiles of 8 rows where they make 128 blocks or more, else of 4.  K is
    staged at once up to 256 rows (rounded up to 32, the 8 groups' 4-row
    steps), a longer K in two stages of 256.  The 16-byte copies need K %
    4 == 0 and N % 16 == 0 besides the aligned bases."""
    require(m >= 1 and k >= 1 and n >= 1,
            lambda: f"int8_matmul: M {m}, K {k}, N {n}; the kernel takes M, K, N >= 1")
    tile_m = 8 if -(-m // 8) * -(-n // TILE_N) >= TARGET_BLOCKS else 4
    chunk = min(-(-k // 32) * 32, MAX_CHUNK)
    return Int8MatmulPlan(tile_m, chunk, 1 if k <= chunk else 2,
                          aligned and k % 4 == 0 and n % 16 == 0)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float; q: (K, N) int8; scale: (K, ceil(N/BLOCK)) -> (M, N) f32."""
    w = dequantize(dict(q=q, scale=scale, n=q.shape[-1]))
    return x.float() @ w


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x: (M, K) fp32; q: (K, N) int8; scale: (K, ceil(N/BLOCK)) fp32 ->
    (M, N) fp32."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    require_no_grad("int8_matmul", x, q, scale)
    check_tensor("x", x, 2, (torch.float32,), x.device)
    check_tensor("q", q, 2, (torch.int8,), x.device)
    check_tensor("scale", scale, 2, (torch.float32,), x.device)
    m, k = x.shape
    kq, n = q.shape
    nb = -(-n // BLOCK)
    require(kq == k, lambda: f"contraction mismatch: x K={k} vs q K={kq}")
    require(scale.shape == (k, nb), lambda: f"scale {tuple(scale.shape)}, expected {(k, nb)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    p = int8_matmul_plan(m, k, n, x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    _build.launch("rt_int8_matmul", "int8_matmul", ptr(x), ptr(q), ptr(scale),
                  ptr(out), m, k, n, nb, p.tile_m, p.chunk, p.stages, int(p.vec),
                  stream(x.device), route=p.route)
    return out
