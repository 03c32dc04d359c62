"""The plain PyTorch versions of the port's four kernels against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

The CUDA kernels themselves need a card and nvcc; chip_smoke.py holds each
of them against these plain versions on the GPU.  Here the plain versions
(what a kernel wrapper runs for a CPU tensor) are held against the TPU
kernels' own semantics.  Tolerance: 1e-5 relative to max|out| -- both sides
accumulate in fp32, in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_matmul as j_im
from repro.kernels import mahalanobis as j_md
from repro.kernels import segment_pool as j_sp
from repro.optim import quant as j_quant
from repro_torch.kernels import int8_matmul as t_im
from repro_torch.kernels import mahalanobis as t_md
from repro_torch.kernels import segment_pool as t_sp
from repro_torch.kernels._checks import check_tensor, require

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _weights(rng, t, b, c, pad):
    """Mask-folded one-hot: ``pad`` trailing zero-weight (padded) rows."""
    y = rng.integers(0, c, (t, b))
    w = np.eye(c, dtype=np.float32)[y]
    if pad:
        w[:, b - pad:] = 0.0
    return w


# (T, B, F, C, pad rows, x dtype): ragged B (not a multiple of 128), padded
# rows, C = 5, F not a multiple of the kernel tiles
AGG_CASES = [
    (2, 37, 72, 5, 5, "float32"),
    (3, 130, 40, 5, 0, "float32"),
    (1, 8, 16, 3, 2, "float32"),
    (2, 21, 48, 5, 4, "bfloat16"),
]


@pytest.mark.parametrize("t,b,f,c,pad,dtype", AGG_CASES)
def test_segment_sum_plain_matches_pallas(t, b, f, c, pad, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((t, b, f)).astype(np.float32)
    w = _weights(rng, t, b, c, pad)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = np.stack([np.asarray(j_sp.segment_pool_weighted(
        xj[i], jnp.asarray(w[i]), interpret=True)) for i in range(t)])
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = t_sp.segment_pool_weighted(xt, torch.from_numpy(w))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("t,b,f,c,pad,dtype", AGG_CASES)
def test_class_second_moment_plain_matches_pallas(t, b, f, c, pad, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((t, b, f)).astype(np.float32)
    w = _weights(rng, t, b, c, pad)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = np.stack([np.asarray(j_sp.class_second_moment(
        xj[i], jnp.asarray(w[i]), block_f=32, interpret=True)) for i in range(t)])
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = t_sp.class_second_moment(xt, torch.from_numpy(w))
    assert got.shape == (t, c, f, f)
    _close(got.numpy(), want)


@pytest.mark.parametrize("t,m,c,f", [(2, 8, 5, 40), (3, 13, 5, 72), (1, 130, 4, 16)])
def test_mahalanobis_plain_matches_pallas(t, m, c, f):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((t, m, f)).astype(np.float32)
    mu = rng.standard_normal((t, c, f)).astype(np.float32)
    a = rng.standard_normal((t, c, f, f)).astype(np.float32) / np.sqrt(f)
    sinv = (a @ np.swapaxes(a, -1, -2) + np.eye(f, dtype=np.float32)).astype(np.float32)
    want = np.stack([np.asarray(j_md.mahalanobis(
        jnp.asarray(q[i]), jnp.asarray(mu[i]), jnp.asarray(sinv[i]), interpret=True))
        for i in range(t)])
    got = t_md.mahalanobis(*(torch.from_numpy(v) for v in (q, mu, sinv)))
    _close(got.numpy(), want)


# (M, K, N): N not a multiple of the 128-wide quantization block, ragged M/K
@pytest.mark.parametrize("m,k,n", [(32, 64, 64), (13, 40, 200), (50, 130, 300)])
def test_int8_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    qs = j_quant.quantize(jnp.asarray(w))
    want = np.asarray(j_im.int8_matmul(jnp.asarray(x), qs["q"], qs["scale"],
                                       interpret=True))
    got = t_im.int8_matmul(torch.from_numpy(x),
                           torch.from_numpy(np.array(qs["q"])),
                           torch.from_numpy(np.array(qs["scale"])))
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrappers' argument checks, as far as the CPU can build bad arguments
# ---------------------------------------------------------------------------

class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports cuda:0 as its device, so that the checks
    after the device check can be reached without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


_CUDA0 = torch.device("cuda", 0)
_F32 = (torch.float32,)

BAD_ARGS = {
    "not a tensor": (lambda: [[1.0, 2.0]], "x: expected a tensor"),
    "a CPU tensor": (lambda: torch.zeros(2, 3, 4), "x: the kernel takes CUDA tensors, got cpu"),
    "the wrong rank": (lambda: torch.zeros(2, 3).as_subclass(_ReportsCuda),
                       "x: expected 3-D, got shape (2, 3)"),
    "the wrong dtype": (lambda: torch.zeros(2, 3, 4, dtype=torch.float64).as_subclass(
        _ReportsCuda), "x: dtype torch.float64 not in [torch.float32]"),
    "non-contiguous": (lambda: torch.zeros(2, 4, 3).transpose(1, 2).as_subclass(_ReportsCuda),
                       "x: must be contiguous"),
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_check_tensor_raises_naming_the_argument(case):
    make, message = BAD_ARGS[case]
    with pytest.raises(ValueError) as err:
        check_tensor("x", make(), 3, _F32, _CUDA0)
    assert str(err.value) == message


def test_check_tensor_passes_a_good_argument():
    check_tensor("x", torch.zeros(2, 3, 4).as_subclass(_ReportsCuda), 3, _F32, _CUDA0)


def test_require_builds_its_message_only_on_failure():
    calls = []

    def msg():
        calls.append(1)
        return "w (2, 3) does not match x"

    require(True, msg)
    assert calls == []
    with pytest.raises(ValueError, match=r"w \(2, 3\) does not match x"):
        require(False, msg)
    assert calls == [1]
    with pytest.raises(ValueError, match="empty chunk"):
        require(False, "empty chunk")
