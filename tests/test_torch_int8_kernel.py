"""The sum order of the H100 int8 serving matmul (``csrc/int8_matmul.cu``)
and its planner, on the CPU.

* A dense numpy model of the kernel's arithmetic: for the plan
  :func:`int8_matmul_plan` picks, the scale of each 128-column quantisation
  block folded into x (x' = x * scale, fp32), each of the block's 8 K
  groups summing its rows of every K chunk in order in fp32, and the
  groups' partial tiles added in group order.  Held against the JAX
  package's Pallas kernel in interpret mode within 1e-5 of max|out|, the
  tolerance chip_smoke.py holds the kernel to against its plain version on
  the card.
* The planner's branches: the tile rows against the number of blocks, the
  K chunk (rounded to the groups' 4-row steps; two stages for a long K),
  the 16-byte copies against the 4-byte ones (K % 4, N % 16, the alignment
  of x and q), and the shapes it refuses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul as j_im
from repro.optim import quant as j_quant
from repro_torch.kernels.int8_matmul import (GROUPS, MAX_CHUNK, TILE_N, Int8MatmulPlan,
                                             int8_matmul_plan)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
BLOCK = 128   # the quantisation block


def int8_matmul_model(x, q, scale, plan: Int8MatmulPlan):
    """The kernel's order of sums, in fp32: per quantisation block nb, x' =
    x * scale[:, nb]; per K group g, sum_k x'[:, k] q[k, :] over the
    group's rows of each chunk, chunks in order; the groups' partials added
    in group order."""
    m, k = x.shape
    n = q.shape[1]
    step = plan.chunk // GROUPS
    out = np.full((m, n), np.nan, np.float32)
    for nb in range(scale.shape[1]):
        cols = slice(nb * BLOCK, min(n, (nb + 1) * BLOCK))
        xs = (x * scale[None, :, nb]).astype(np.float32)
        w = q[:, cols].astype(np.float32)
        total = np.zeros((m, w.shape[1]), np.float32)
        for g in range(GROUPS):
            part = np.zeros_like(total)
            for k0 in range(g * step, k, plan.chunk):
                for kk in range(k0, min(k, k0 + step)):
                    part = (part + xs[:, kk, None] * w[kk]).astype(np.float32)
            total = (total + part).astype(np.float32)
        out[:, cols] = total
    return out


# the serving path's adapt chunk (M 128) and query dispatch (M 32); ragged
# M, K and N on the 4-byte path (N % 16, K % 4); a K of two stages
MODEL_CASES = [(128, 256, 256), (32, 256, 256), (50, 200, 300), (50, 130, 300), (8, 600, 40)]


@pytest.mark.parametrize("m,k,n", MODEL_CASES)
def test_int8_matmul_sum_order_matches_pallas(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    qs = j_quant.quantize(jnp.asarray(w))
    q, scale = np.asarray(qs["q"]), np.asarray(qs["scale"])
    plan = int8_matmul_plan(m, k, n, True)
    got = int8_matmul_model(x, q, scale, plan)
    want = np.asarray(j_im.int8_matmul(jnp.asarray(x), qs["q"], qs["scale"], interpret=True))
    assert np.isfinite(got).all() and got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= TOL, err


# (M, K, N, x and q aligned) -> (tile_m, chunk, stages, vec)
PLAN_CASES = {
    "adapt chunk M128: tiles of 8 rows, 128 blocks": (
        (128, 256, 256, True), Int8MatmulPlan(8, 256, 1, True)),
    "query dispatch M32: tiles of 4 rows, 64 blocks": (
        (32, 256, 256, True), Int8MatmulPlan(4, 256, 1, True)),
    "M64: 8 rows would make 64 blocks, so 4": (
        (64, 256, 256, True), Int8MatmulPlan(4, 256, 1, True)),
    "many tiles": ((4096, 256, 256, True), Int8MatmulPlan(8, 256, 1, True)),
    "K % 4 != 0: 4-byte copies, the chunk rounded up to 32": (
        (32, 130, 256, True), Int8MatmulPlan(4, 160, 1, False)),
    "N % 16 != 0: 4-byte copies": ((50, 200, 300, True), Int8MatmulPlan(4, 224, 1, False)),
    "x or q misaligned: 4-byte copies": (
        (32, 256, 256, False), Int8MatmulPlan(4, 256, 1, False)),
    "N 320: tiles across a partial quantisation block": (
        (50, 200, 320, True), Int8MatmulPlan(4, 224, 1, True)),
    "short K: one 32-row chunk": ((32, 20, 256, True), Int8MatmulPlan(4, 32, 1, True)),
    "long K: two stages of 256 rows": (
        (128, 8192, 256, True), Int8MatmulPlan(8, 256, 2, True)),
    "one element": ((1, 1, 1, True), Int8MatmulPlan(4, 32, 1, False)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_int8_matmul_plan(case):
    args, want = PLAN_CASES[case]
    plan = int8_matmul_plan(*args)
    assert plan == want
    m, k, n, aligned = args
    # an output tile lies inside one quantisation block; the chunk splits
    # into the 8 groups' 4-row steps; one stage holds all of K, or K
    # streams through two of 256 rows
    assert BLOCK % TILE_N == 0
    assert plan.chunk % (GROUPS * 4) == 0 and plan.chunk <= MAX_CHUNK
    assert (plan.stages == 1 and k <= plan.chunk) or (plan.stages == 2 and
                                                       plan.chunk == MAX_CHUNK < k)
    assert plan.tile_m in (4, 8)
    assert plan.vec == (aligned and k % 4 == 0 and n % 16 == 0)
    assert plan.route == ("cp16" if plan.vec else "cp4")


@pytest.mark.parametrize("m,k,n", [(0, 256, 256), (32, 0, 256), (32, 256, 0)])
def test_int8_matmul_plan_refuses(m, k, n):
    with pytest.raises(ValueError, match="the kernel takes"):
        int8_matmul_plan(m, k, n, True)
