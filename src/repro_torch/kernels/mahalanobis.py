"""Simple CNAPs Mahalanobis head over a leading task-lane axis:

    d2[t, m, c] = (q[t, m] - mu[t, c])^T Sinv[t, c] (q[t, m] - mu[t, c])

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/mahalanobis.cu``: one thread-block cluster per (t, c, query tile),
each block reading its own slice of Sinv's rows; past F 2048 the "stream"
route, which walks the columns in slices) with the plan that
:func:`mahalanobis_plan` picks, or raises; on a CPU tensor it runs the
plain PyTorch version beside it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_tensor, ptr, require,
                                          require_no_grad, stream)

MAX_CLUSTER = 8           # blocks a cluster (the portable limit)
MIN_ROWS = 32             # Sinv rows worth a block of their own
MAX_TILE = 32             # queries a cluster serves (kMaxTile in the kernel)
SMEM_BYTES = 200 * 1024   # dynamic shared memory a block may plan for
DIFF_BYTES = 64 * 1024    # of which at most this for the diff tile
BAND_ROWS = 32            # stream route: Sinv rows a block (kBandRows)
SLICE_COLS = 256          # stream route: columns a stage (kSliceCols)
MAX_F = 65536             # Sinv of one class is then 16 GiB


class MahalanobisPlan(NamedTuple):
    k: int            # blocks a cluster (stream: bands of Sinv rows, one block each);
                      # block r owns Sinv rows [r * rows, (r + 1) * rows)
    rows: int         # Sinv rows a block
    stage_rows: int   # rows a shared-memory stage holds
    stages: int       # 1: the whole slice at once; 2: streamed through two stages
    tile: int         # queries a cluster
    bulk: bool        # one bulk copy a stage (stream: 16-byte cp.async); else 4-byte cp.async
    cols: int = 0     # > 0: the stream route, Sinv's columns walked in slices of this
                      # by bands of 32 rows, one block a band, no cluster

    @property
    def route(self) -> str:
        return "stream" if self.cols else "bulk" if self.bulk else "threads"


@functools.lru_cache(maxsize=256)
def mahalanobis_plan(m: int, f: int, aligned: bool) -> MahalanobisPlan:
    """The kernel's plan for M queries a lane at width F; ``aligned`` says
    whether Sinv's base is 16-byte aligned.  A plain function of its
    arguments (cached: the serving path asks it on every query dispatch).

    k grows with F to 8 blocks (one per 32 rows of Sinv) and each block
    takes ceil(F / k) rows; a cluster serves up to 32 queries.  The diff
    tile (its queries rounded up to 8, the kernel's pass) gets at most 64
    KB up to F 2048; the slice of Sinv gets the rest of 200 KB: whole if it
    fits, else in two stages that stream it.  The bulk copy needs a
    16-byte-aligned base and a slice of a multiple of 16 bytes, which F %
    4 == 0 gives.

    Past F 2048 (eight diff rows over 64 KB) the stream route: one block
    for each band of 32 rows of Sinv (k = ceil(F / 32) bands, no cluster),
    tiles of up to 8 queries, two stages of a slice of 256 columns (16-byte
    copies on the same condition as the bulk copy), the bands' partial sums
    added by a second kernel in band order.  F up to 65536."""
    row_bytes = 4 * f
    require(m >= 1 and 1 <= f <= MAX_F,
            lambda: f"mahalanobis: M {m}, F {f}; the kernel takes M >= 1 and "
                    f"1 <= F <= {MAX_F}")
    if 8 * row_bytes > DIFF_BYTES:
        return MahalanobisPlan(-(-f // BAND_ROWS), BAND_ROWS, BAND_ROWS, 2, min(8, m),
                               aligned and f % 4 == 0, SLICE_COLS)
    k = min(MAX_CLUSTER, -(-f // MIN_ROWS))
    rows = -(-f // k)
    tile = min(MAX_TILE, m, DIFF_BYTES // row_bytes // 8 * 8)
    room = SMEM_BYTES - -(-tile // 8) * 8 * row_bytes
    if rows * row_bytes <= room:
        stage_rows, stages = rows, 1
    else:
        stage_rows, stages = room // 2 // row_bytes, 2
    return MahalanobisPlan(k, rows, stage_rows, stages, tile, aligned and f % 4 == 0)


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
    require_no_grad("mahalanobis", q, mu, sinv)
    check_tensor("q", q, 3, (torch.float32,), q.device)
    check_tensor("mu", mu, 3, (torch.float32,), q.device)
    check_tensor("sinv", sinv, 4, (torch.float32,), q.device)
    t, m, f = q.shape
    c = mu.shape[1]
    require(mu.shape == (t, c, f), lambda: f"mu {tuple(mu.shape)} vs q {tuple(q.shape)}")
    require(sinv.shape == (t, c, f, f), lambda: f"sinv {tuple(sinv.shape)} vs mu {tuple(mu.shape)}")
    out = torch.empty((t, m, c), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    p = mahalanobis_plan(m, f, sinv.data_ptr() % 16 == 0)
    # the stream route's partial sums, one a (lane, class, tile, band, query)
    part = (torch.empty(t * c * -(-m // p.tile) * p.k * 8, dtype=torch.float32,
                        device=q.device) if p.cols else None)
    _build.launch("rt_mahalanobis", "mahalanobis", ptr(q), ptr(mu), ptr(sinv),
                  ptr(out), t, m, c, f, p.k, p.rows, p.stage_rows, p.stages, p.tile,
                  int(p.bulk), p.cols, ptr(part) if p.cols else None, stream(q.device),
                  route=p.route)
    return out
