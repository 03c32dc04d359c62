"""The sum orders of the H100 kernels for the Simple CNAPs head
(``csrc/mahalanobis.cu``) and the class second moment
(``csrc/segment_pool.cu::second_moment_kernel``), and the Mahalanobis
kernel's planner, on the CPU.

* A dense numpy model of the Mahalanobis kernel's arithmetic: for the plan
  :func:`mahalanobis_plan` picks, each cluster rank's slice of Sinv rows
  gives a partial d2 per query (fp32), and the partials are added in rank
  order, tile by tile of queries.
* A dense numpy model of the second-moment kernel's arithmetic: the class
  weight folded into the left operand, rows of B added one by one in fp32,
  and the 32 x 32 tiles below the diagonal copied from their mirrors above.
* Both held against the JAX package's Pallas kernels in interpret mode
  within 1e-5 of max|out|, the tolerance chip_smoke.py holds the kernels to
  against their plain versions on the card.
* The planner's branches: the bulk copy against the per-thread copy (F % 4
  and the alignment of Sinv), the cluster size k at small F, the query
  tiles, the two streaming stages at wide F, the "stream" route past F
  2048 (bands of 32 rows of Sinv, one block each, walked in column slices;
  its bands' partials, added in band order, are the model's rank
  partials with k bands of 32 rows), and the widths it refuses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mahalanobis as j_md
from repro.kernels import segment_pool as j_sp
from repro_torch.kernels.mahalanobis import MahalanobisPlan, mahalanobis_plan

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
TILE = 32   # the second-moment kernel's output tile edge


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def mahalanobis_model(q, mu, sinv, plan: MahalanobisPlan):
    """The kernel's order of sums, in fp32: per query tile and cluster rank,
    sum_i diff[m, i] * (Sinv[i, :] . diff[m, :]) over the rank's rows; the
    ranks' partials added in rank order."""
    t, m, f = q.shape
    c = mu.shape[1]
    out = np.full((t, m, c), np.nan, np.float32)
    for m0 in range(0, m, plan.tile):
        diff = (q[:, m0:m0 + plan.tile, None, :] - mu[:, None, :, :]).astype(np.float32)
        total = np.zeros(diff.shape[:3], np.float32)
        for rank in range(plan.k):
            i0, i1 = rank * plan.rows, min(f, (rank + 1) * plan.rows)
            rows = np.einsum("tcij,tmcj->tmci", sinv[:, :, i0:i1], diff).astype(np.float32)
            part = np.sum(rows * diff[..., i0:i1], axis=-1, dtype=np.float32)
            total = (total + part).astype(np.float32)
        out[:, m0:m0 + plan.tile] = total
    return out


# F across the backbones (64-512) and off the kernel's tiles; M one tile,
# a ragged tile, several tiles; F 640 streams through two stages; F 2304
# (gemma2-2b's d_model) takes the stream route
MD_CASES = [(f, m) for f in (16, 40, 72, 200, 256, 512) for m in (8, 13, 130)] + [
    (640, 8), (2304, 8)]


@pytest.mark.parametrize("f,m", MD_CASES)
def test_mahalanobis_sum_order_matches_pallas(f, m):
    rng = np.random.default_rng(f * 1000 + m)
    t, c = (1, 2) if f > 2048 else (1, 3) if f >= 256 else (2, 5)
    q = rng.standard_normal((t, m, f)).astype(np.float32)
    mu = rng.standard_normal((t, c, f)).astype(np.float32)
    a = rng.standard_normal((t, c, f, f)).astype(np.float32) / np.sqrt(f)
    sinv = (a @ np.swapaxes(a, -1, -2) + np.eye(f, dtype=np.float32)).astype(np.float32)
    plan = mahalanobis_plan(m, f, True)
    assert plan.route == ("stream" if f > 2048 else "bulk")
    got = mahalanobis_model(q, mu, sinv, plan)
    want = np.stack([np.asarray(j_md.mahalanobis(
        jnp.asarray(q[i]), jnp.asarray(mu[i]), jnp.asarray(sinv[i]), interpret=True))
        for i in range(t)])
    assert np.isfinite(got).all()
    _close(got, want)


# (M, F, Sinv aligned) -> (k, rows, stage_rows, stages, tile, bulk)
PLAN_CASES = {
    "serving shape: 8 blocks of 32 rows, one bulk copy": (
        (8, 256, True), MahalanobisPlan(8, 32, 32, 1, 8, True)),
    "F % 4 != 0: per-thread copies": ((8, 250, True), MahalanobisPlan(8, 32, 32, 1, 8, False)),
    "Sinv base misaligned: per-thread copies": (
        (8, 256, False), MahalanobisPlan(8, 32, 32, 1, 8, False)),
    "F 16: one block": ((8, 16, True), MahalanobisPlan(1, 16, 16, 1, 8, True)),
    "F 40: two blocks": ((8, 40, True), MahalanobisPlan(2, 20, 20, 1, 8, True)),
    "F 72: three blocks": ((13, 72, True), MahalanobisPlan(3, 24, 24, 1, 13, True)),
    "F 200: seven blocks, the last short": (
        (13, 200, True), MahalanobisPlan(7, 29, 29, 1, 13, True)),
    "M 130: tiles of 32 queries": ((130, 256, True), MahalanobisPlan(8, 32, 32, 1, 32, True)),
    "M 1": ((1, 64, True), MahalanobisPlan(2, 32, 32, 1, 1, True)),
    "F 512: 64 rows, 128 KB in one copy": (
        (130, 512, True), MahalanobisPlan(8, 64, 64, 1, 32, True)),
    "F 640: two stages of 36 rows": ((8, 640, True), MahalanobisPlan(8, 80, 36, 2, 8, True)),
    "F 2048: tile of 8 queries, stages of 8 rows": (
        (130, 2048, True), MahalanobisPlan(8, 256, 8, 2, 8, True)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_mahalanobis_plan(case):
    args, want = PLAN_CASES[case]
    plan = mahalanobis_plan(*args)
    assert plan == want
    m, f, _ = args
    # every row of Sinv belongs to one rank, no rank is empty, and the
    # shared memory the kernel asks for fits a block
    assert (plan.k - 1) * plan.rows < f <= plan.k * plan.rows
    assert (plan.stage_rows == plan.rows) if plan.stages == 1 else (plan.stage_rows < plan.rows)
    tile8 = -(-plan.tile // 8) * 8
    assert 4 * f * (plan.stages * plan.stage_rows + tile8) <= 200 * 1024
    assert plan.route == ("bulk" if plan.bulk else "threads")


# past F 2048 (M, F, Sinv aligned) -> (bands, rows, stage_rows, stages,
# tile, bulk, cols): d_models of src/repro/configs/ (gemma2-2b,
# minitron-4b, zamba2-7b, qwen2-72b) and the widest F the route takes
STREAM_PLAN_CASES = {
    "F 2049: the first width past the diff budget, 4-byte copies": (
        (8, 2049, True), MahalanobisPlan(65, 32, 32, 2, 8, False, 256)),
    "F 2304": ((8, 2304, True), MahalanobisPlan(72, 32, 32, 2, 8, True, 256)),
    "F 3072": ((8, 3072, True), MahalanobisPlan(96, 32, 32, 2, 8, True, 256)),
    "F 3584, M 13: two tiles of 8 queries": (
        (13, 3584, True), MahalanobisPlan(112, 32, 32, 2, 8, True, 256)),
    "F 8192": ((8, 8192, True), MahalanobisPlan(256, 32, 32, 2, 8, True, 256)),
    "F 8192, Sinv misaligned: 4-byte copies": (
        (8, 8192, False), MahalanobisPlan(256, 32, 32, 2, 8, False, 256)),
    "F 8192, M 3": ((3, 8192, True), MahalanobisPlan(256, 32, 32, 2, 3, True, 256)),
    "F 65536: the widest": ((8, 65536, True), MahalanobisPlan(2048, 32, 32, 2, 8, True, 256)),
}


@pytest.mark.parametrize("case", list(STREAM_PLAN_CASES))
def test_mahalanobis_stream_plan(case):
    args, want = STREAM_PLAN_CASES[case]
    plan = mahalanobis_plan(*args)
    assert plan == want
    m, f, _ = args
    assert plan.route == "stream"
    # every row of Sinv belongs to one band; a tile is at most the 8
    # queries of the kernel's registers; two stages of 32 rows x 256 columns
    # of Sinv, 8 q rows and mu fit the shared memory
    assert (plan.k - 1) * plan.rows < f <= plan.k * plan.rows
    assert plan.tile <= 8
    assert 2 * 4 * (plan.rows + 8 + 1) * plan.cols <= 200 * 1024


@pytest.mark.parametrize("m,f", [(8, 0), (0, 64), (8, 65537)])
def test_mahalanobis_plan_refuses(m, f):
    with pytest.raises(ValueError, match="the kernel takes"):
        mahalanobis_plan(m, f, True)


def second_moment_model(x, w):
    """The kernel's order of sums, in fp32: out[c, i, j] += (w[b, c] x[b, i])
    x[b, j] for b in order; tiles below the diagonal mirror those above."""
    t, b, f = x.shape
    c = w.shape[2]
    out = np.zeros((t, c, f, f), np.float32)
    for r in range(b):
        left = (w[:, r, :, None] * x[:, r, None, :]).astype(np.float32)     # (T, C, F)
        out = (out + left[..., :, None] * x[:, r, None, None, :]).astype(np.float32)
    nt = -(-f // TILE)
    for ti in range(nt):
        for tj in range(ti + 1, nt):
            rows, cols = slice(ti * TILE, (ti + 1) * TILE), slice(tj * TILE, (tj + 1) * TILE)
            out[..., cols, rows] = np.swapaxes(out[..., rows, cols], -1, -2)
    return out


def _weights(rng, t, b, c, pad):
    y = rng.integers(0, c, (t, b))
    w = np.eye(c, dtype=np.float32)[y]
    if pad:
        w[:, b - pad:] = 0.0
    return w


# (T, B, F, C, pad rows, x dtype): one or several 16-row steps, a ragged
# last step, one tile or several, ragged F, 16-bit inputs
SM_CASES = [
    (2, 32, 256, 5, 0, "float32"),
    (1, 37, 200, 5, 5, "bfloat16"),
    (2, 21, 72, 5, 3, "float16"),
    (1, 130, 40, 5, 0, "float32"),
    (2, 8, 16, 3, 2, "float32"),
    (1, 32, 130, 4, 4, "float32"),
]


@pytest.mark.parametrize("t,b,f,c,pad,dtype", SM_CASES)
def test_second_moment_sum_order_matches_pallas(t, b, f, c, pad, dtype):
    rng = np.random.default_rng(b * 1000 + f)
    x = rng.standard_normal((t, b, f)).astype(np.float32)
    w = _weights(rng, t, b, c, pad)
    # the kernel reads 16-bit x converted to fp32: the model gets the same values
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    got = second_moment_model(x, w)
    want = np.stack([np.asarray(j_sp.class_second_moment(
        jnp.asarray(x[i]), jnp.asarray(w[i]), block_f=64, interpret=True)) for i in range(t)])
    _close(got, want)
    # the mirrored tiles make the result exactly symmetric off the diagonal tiles
    nt = -(-f // TILE)
    if nt > 1:
        np.testing.assert_array_equal(got[..., TILE:, :TILE],
                                      np.swapaxes(got[..., :TILE, TILE:], -1, -2))
