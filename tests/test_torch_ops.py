"""The port's kernel entry point ``repro_torch.kernels.ops`` against the JAX
package's ``repro.kernels.ops`` (Pallas kernels in interpret mode), on the
same numpy inputs, on the CPU, where each port function runs its kernel's
plain version.  The CUDA kernels themselves need a card; chip_smoke.py holds
each of them against these plain versions there.

Tolerances (``np.testing.assert_allclose`` with atol = rtol), those of the
JAX package's own sweeps in tests/test_kernels.py: attention 2e-5 (fp32) and
2e-2 (bf16); gmm 1e-4 (fp32) and 5e-2 (bf16); ssd_chunk 3e-4 absolute on y
and the states (rtol 1e-3) and 1e-5 on the decays; the SSD composition
2e-3 / 1e-2.  The class-statistics wrappers: 1e-4 (fp32 sums in other
orders), counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ATTN_VARIANTS = [(True, None, None), (False, None, None), (True, 24, None),
                 (True, None, 50.0), (True, 24, 30.0)]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GMM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(a, dtype="float32"):
    """The same numpy values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol if atol is None else atol, rtol=tol)


def _qkv(rng, shape, kv_shape=None, dtype="float32"):
    kv_shape = kv_shape or shape
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape, kv_shape, kv_shape)]
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,cap", ATTN_VARIANTS)
def test_flash_attention_matches_jax(causal, window, cap, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(0), (2, 64, 32), dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ops.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, jops.flash_attention(qj, kj, vj, **kw), ATTN_TOL[dtype])


@pytest.mark.parametrize("causal,window,cap", ATTN_VARIANTS)
def test_flash_attention_ragged_s_matches_jax(causal, window, cap):
    """S = 100: not a multiple of any power-of-two tile."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(1), (2, 100, 32))
    kw = dict(causal=causal, window=window, softcap=cap)
    _close(ops.flash_attention(qt, kt, vt, **kw), jops.flash_attention(qj, kj, vj, **kw),
           ATTN_TOL["float32"])


@pytest.mark.parametrize("window,cap", [(None, None), (24, 30.0)])
def test_flash_attention_gqa_matches_jax(window, cap):
    """Hq 4 over Hkv 2: query head h reads kv head h // 2."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(2), (2, 48, 4, 32),
                                        kv_shape=(2, 48, 2, 32))
    kw = dict(causal=True, window=window, softcap=cap)
    got = ops.flash_attention_gqa(qt, kt, vt, **kw)
    assert got.shape == qt.shape
    _close(got, jops.flash_attention_gqa(qj, kj, vj, **kw), ATTN_TOL["float32"])


@pytest.mark.parametrize("e,c,d,f,dtype", [(2, 130, 200, 300, "float32"),
                                           (2, 130, 200, 300, "bfloat16"),
                                           (3, 32, 48, 40, "float32")])
def test_gmm_matches_jax(e, c, d, f, dtype):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.standard_normal((e, c, d)).astype(np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((e, d, f)).astype(np.float32), dtype)
    got = ops.gmm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (e, c, f)
    _close(got, jops.gmm(xj, wj), GMM_TOL[dtype])


def _ssd_inputs(rng, g, q, p, n):
    return (rng.standard_normal((g, q, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((g, q)))).astype(np.float32),
            -np.exp(rng.standard_normal(g)).astype(np.float32),
            rng.standard_normal((g, q, n)).astype(np.float32),
            rng.standard_normal((g, q, n)).astype(np.float32))


@pytest.mark.parametrize("g,q,p,n", [(6, 32, 16, 8), (2, 64, 32, 16)])
def test_ssd_chunk_matches_jax(g, q, p, n):
    args = _ssd_inputs(np.random.default_rng(4), g, q, p, n)
    got = ops.ssd_chunk(*(torch.from_numpy(a) for a in args))
    want = jops.ssd_chunk(*(jnp.asarray(a) for a in args))
    shapes = [(g, q, p), (g, p, n), (g,), (g, q)]
    for i, (t, j, shape) in enumerate(zip(got, want, shapes)):
        assert t.dtype == torch.float32 and tuple(t.shape) == shape
        if i < 2:       # y_diag, states
            _close(t, j, 1e-3, atol=3e-4)
        else:           # chunk_decay, state_decay
            _close(t, j, 0.0, atol=1e-5)


def test_ssd_chunk_composes_with_jax_model():
    """The port's chunks + a torch inter-chunk recurrence == the JAX model's
    chunked SSD (repro.models.mamba2.ssd_chunked)."""
    rng = np.random.default_rng(5)
    b, s, h, p, n, chunk = 2, 64, 3, 8, 4, 16
    nc = s // chunk
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, h, n)).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    y_model, final_model = ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk)

    x, dt, A, B, C = (torch.from_numpy(a) for a in (x, dt, A, B, C))

    def to_g(t, feat):   # (b, s, h, feat) -> (b * nc * h, chunk, feat)
        return t.reshape(b, nc, chunk, h, feat).permute(0, 1, 3, 2, 4).reshape(-1, chunk, feat)

    dtg = dt.reshape(b, nc, chunk, h).permute(0, 1, 3, 2).reshape(-1, chunk)
    yk, stk, cdk, sdk = ops.ssd_chunk(to_g(x, p), dtg, A.repeat(b * nc), to_g(B, n),
                                      to_g(C, n))
    stk = stk.reshape(b, nc, h, p, n)
    cdk = cdk.reshape(b, nc, h)
    sdk = sdk.reshape(b, nc, h, chunk).permute(0, 1, 3, 2)           # (b, nc, chunk, h)
    yk = yk.reshape(b, nc, h, chunk, p).permute(0, 1, 3, 2, 4)
    Cc = C.reshape(b, nc, chunk, h, n)
    state = torch.zeros((b, h, p, n))
    ys = []
    for ci in range(nc):
        ys.append(yk[:, ci] + torch.einsum("blhn,bhpn,blh->blhp", Cc[:, ci], state,
                                           sdk[:, ci]))
        state = state * cdk[:, ci][:, :, None, None] + stk[:, ci]
    _close(torch.cat(ys, dim=1), y_model, 1e-2, atol=2e-3)
    _close(state, final_model, 1e-2, atol=2e-3)


def _onehot(rng, b, c, pad=0):
    w = np.eye(c, dtype=np.float32)[rng.integers(0, c, b)]
    w[b - pad:] = 0.0
    return w


@pytest.mark.parametrize("b,f,c", [(64, 32, 5), (130, 64, 10), (16, 16, 3)])
def test_mahalanobis_matches_jax(b, f, c):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, f)).astype(np.float32)
    mu = rng.standard_normal((c, f)).astype(np.float32)
    a = rng.standard_normal((c, f, f)).astype(np.float32)
    sinv = (np.einsum("cij,ckj->cik", a, a) + 0.1 * np.eye(f)).astype(np.float32)
    got = ops.mahalanobis(*(torch.from_numpy(t) for t in (q, mu, sinv)))
    want = jops.mahalanobis(*(jnp.asarray(t) for t in (q, mu, sinv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("b,f,c", [(100, 48, 7), (257, 64, 4), (8, 8, 2)])
def test_segment_pool_matches_jax(b, f, c):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, f)).astype(np.float32)
    y = rng.integers(0, c, b).astype(np.int32)
    s1, c1 = ops.segment_pool(torch.from_numpy(x), torch.from_numpy(y), c)
    s2, c2 = jops.segment_pool(jnp.asarray(x), jnp.asarray(y), c)
    _close(s1, s2, 1e-4)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c2))


@pytest.mark.parametrize("fn", ["ops", "oracle"])
def test_segment_pool_padding_label_matches_jax(fn):
    """A -1 padding label weighs its row 0 (a zero one-hot row, as
    jax.nn.one_hot gives), in the entry point and in the oracle."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    y = rng.integers(0, 5, 24).astype(np.int32)
    y[-4:] = -1
    port, jax_fn = ((ops.segment_pool, jops.segment_pool) if fn == "ops"
                    else (tref.segment_pool_ref, jref.segment_pool_ref))
    s1, c1 = port(torch.from_numpy(x), torch.from_numpy(y), 5)
    s2, c2 = jax_fn(jnp.asarray(x), jnp.asarray(y), 5)
    _close(s1, s2, 1e-4)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c2))
    assert float(c1.sum()) == 20.0


@pytest.mark.parametrize("b,f,c,pad", [(37, 72, 5, 5), (130, 40, 5, 0)])
def test_weighted_pool_and_second_moment_match_jax(b, f, c, pad):
    """Mask-folded one-hot weights with ``pad`` zero-weight rows."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, f)).astype(np.float32)
    w = _onehot(rng, b, c, pad)
    xt, wt, xj, wj = torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)
    _close(ops.segment_pool_weighted(xt, wt), jops.segment_pool_weighted(xj, wj), 1e-4)
    _close(ops.class_second_moment(xt, wt), jops.class_second_moment(xj, wj), 1e-4)


def _ref_inputs(name, rng):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    if name == "attention_ref":
        return (r(2, 40, 16), r(2, 40, 16), r(2, 40, 16)), dict(causal=True, window=9,
                                                               softcap=20.0)
    if name == "mahalanobis_ref":
        a = r(3, 12, 12)
        return (r(10, 12), r(3, 12), np.einsum("cij,ckj->cik", a, a) + np.eye(12)), {}
    if name == "segment_pool_ref":
        return (r(20, 8), rng.integers(0, 4, 20).astype(np.int32), 4), {}
    if name == "ssd_chunk_ref":
        q, h = 16, 3
        return (r(q, h, 4), np.log1p(np.exp(r(q, h))), -np.exp(r(h)), r(q, h, 5),
                r(q, h, 5)), {}
    return (r(2, 9, 11), r(2, 11, 7)), {}


@pytest.mark.parametrize("name", ["attention_ref", "mahalanobis_ref", "segment_pool_ref",
                                  "ssd_chunk_ref", "gmm_ref"])
def test_oracles_match_jax(name):
    args, kw = _ref_inputs(name, np.random.default_rng(9))
    conv_t = lambda a: torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
    conv_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    got = getattr(tref, name)(*map(conv_t, args), **kw)
    want = getattr(jref, name)(*map(conv_j, args), **kw)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for t, j in zip(got, want, strict=True):
        _close(t, jax.device_get(j), 2e-5)
