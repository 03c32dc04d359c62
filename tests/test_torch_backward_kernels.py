"""The backward kernels' plain versions (``ssd_scan.ssd_chunk_bwd_plain``,
``flash_attention.flash_attention_gqa_bwd_plain`` and the forward's
``attention_lse_plain``) against ``jax.vjp`` of the JAX package's own
functions, on the same numpy inputs, on the CPU; and the two autograd
Functions (``dispatch._SSDChunk``, ``dispatch._FlashAttention``) on CPU
tensors, where their backwards run those closed forms.  The CUDA kernels
need a card: chip_smoke.py holds each against these plain versions there.

Tolerances: fp32, 1e-5 of each gradient's largest value (the same sums in
other orders; the closed form's Delta = rowsum(dO o O) where autograd sums
P o dP); the bf16 attention case 4e-2 (P rounded to bf16 on both sides, but
at different points of the product chain); the lse 1e-6 absolute (logits of
order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro.models.layers import attention_scores
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL = 1e-5
TOL_BF16 = 4e-2
TOL_LSE = 1e-6


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# B6: ssd_chunk's backward
# ---------------------------------------------------------------------------

def _ssd_inputs(q, g=3, p=16, n=16, seed=0):
    """x (G, Q, P), dt (G, Q), A (G,), B, C (G, Q, N) fp32, dt and A in
    Mamba-2's initialisation ranges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, q, p)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (g, q))).astype(np.float32)
    A = -rng.uniform(1, 16, g).astype(np.float32)
    B, C = (rng.standard_normal((g, q, n)).astype(np.float32) for _ in range(2))
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((g, q, p), (g, p, n), (g,),
                                                                (g, q))]
    return [x, dt, A, B, C], cots


def _jax_ssd_vjp(ins, cots):
    """jax.vjp of ``ssd_chunk_ref`` with the G chunks as its heads, the
    gradients laid out as the port's (G, ...) inputs."""
    x, dt, A, B, C = (jnp.asarray(a) for a in ins)

    def f(x, dt, A, B, C):
        y, st, cd, sd = ssd_chunk_ref(x.transpose(1, 0, 2), dt.T, A, B.transpose(1, 0, 2),
                                      C.transpose(1, 0, 2))
        return y.transpose(1, 0, 2), st, cd, sd.T

    _, vjp = jax.vjp(f, x, dt, A, B, C)
    return vjp(tuple(jnp.asarray(c) for c in cots))


KEEP = {"all": (1, 1, 1, 1), "no gy": (0, 1, 1, 1), "no states": (1, 0, 1, 1),
        "no chunk_decay": (1, 1, 0, 1), "no state_decay": (1, 1, 1, 0)}


@pytest.mark.parametrize("keep", list(KEEP))
@pytest.mark.parametrize("q", [32, 64, 37])
def test_ssd_bwd_plain_matches_jax_vjp(q, keep):
    """Each of the five gradients within TOL of its largest value, a
    cotangent on each output and each one left out (None for the port,
    zeros for JAX)."""
    ins, cots = _ssd_inputs(q, seed=q)
    mask = KEEP[keep]
    want = _jax_ssd_vjp(ins, [c if k else np.zeros_like(c) for c, k in zip(cots, mask)])
    got = ssd_scan.ssd_chunk_bwd_plain(*(torch.from_numpy(a) for a in ins),
                                       *(torch.from_numpy(c) if k else None
                                         for c, k in zip(cots, mask)))
    for name, gt, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert gt.dtype == torch.float32 and tuple(gt.shape) == w.shape, name
        assert _rel(gt, w) <= TOL, (name, _rel(gt, w))


def test_ssd_bwd_wrapper_on_cpu_is_the_closed_form():
    """``ssd_chunk_bwd`` on CPU tensors is its plain version, bit for bit."""
    ins, cots = _ssd_inputs(20, seed=5)
    t = [torch.from_numpy(a) for a in ins]
    c = [torch.from_numpy(a) for a in cots]
    for a, b in zip(ssd_scan.ssd_chunk_bwd(*t, c[0], None, c[2], None),
                    ssd_scan.ssd_chunk_bwd_plain(*t, c[0], None, c[2], None)):
        assert torch.equal(a, b)


def test_ssd_function_backward_on_cpu():
    """``dispatch.ssd_chunk`` on ``cuda`` with CPU tensors: the Function's
    gradients are the closed form's (bit for bit) for the outputs the loss
    reaches, an unreached output's cotangent is None (not zeros), and an
    operand that needs no gradient gets none."""
    ins, cots = _ssd_inputs(24, seed=7)
    live = [torch.from_numpy(a).requires_grad_(i != 2) for i, a in enumerate(ins)]
    y, st, cd, sd = td.ssd_chunk(*live, backend="cuda")
    gy, gsd = torch.from_numpy(cots[0]), torch.from_numpy(cots[3])
    got = torch.autograd.grad((y * gy).sum() + (sd * gsd).sum(),
                              [t for t in live if t.requires_grad])
    want = ssd_scan.ssd_chunk_bwd_plain(*(t.detach() for t in live), gy, None, None, gsd)
    for a, b in zip(got, [w for i, w in enumerate(want) if i != 2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# B5: flash attention's backward and the forward's lse
# ---------------------------------------------------------------------------

ATTN = {"causal": dict(causal=True), "bidirectional": dict(causal=False),
        "causal window": dict(causal=True, window=9),
        "causal softcap": dict(causal=True, softcap=3.0),
        "window softcap, bidirectional": dict(causal=False, window=7, softcap=2.5)}


def _attn_inputs(dtype, s=37, hq=4, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, s, hq, d), (2, s, hkv, d), (2, s, hkv, d), (2, s, hq, d))]
    jd = getattr(jnp, dtype)
    td_ = getattr(torch, dtype)
    return [jnp.asarray(a, jd) for a in arrs], [torch.from_numpy(a).to(td_) for a in arrs]


def _jax_attention(kw):
    return lambda q, k, v: attention_scores(q, k, v, causal=kw["causal"],
                                            window=kw.get("window"), cap=kw.get("softcap"))


@pytest.mark.parametrize("variant,dtype", [(v, "float32") for v in ATTN]
                         + [("causal", "bfloat16"), ("causal softcap", "bfloat16")])
def test_flash_bwd_plain_matches_jax_vjp(variant, dtype):
    """dq, dk, dv of the closed form (from the port's plain forward's output
    and lse) against jax.vjp of ``attention_scores``: GQA 2:1, S 37, within
    TOL (fp32) or TOL_BF16 (bf16) of each gradient's largest value."""
    kw = ATTN[variant]
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _attn_inputs(dtype)
    _, vjp = jax.vjp(_jax_attention(kw), qj, kj, vj)
    want = vjp(doj)
    o, lse = fa.flash_attention_gqa_plain(qt, kt, vt, with_lse=True, **kw)
    got = fa.flash_attention_gqa_bwd_plain(qt, kt, vt, o, lse, dot, **kw)
    tol = TOL if dtype == "float32" else TOL_BF16
    for name, gt, w in zip("qkv", got, want):
        assert gt.dtype == qt.dtype and tuple(gt.shape) == w.shape, name
        assert _rel(gt.float(), np.asarray(w, np.float32)) <= tol, (name, variant)


@pytest.mark.parametrize("variant", list(ATTN))
def test_lse_plain_matches_jax_logsumexp(variant):
    """The rows' log-sum-exp of the masked, scaled, softcapped logits
    against jax.nn.logsumexp of the same logits in JAX, (B, Hq, S)."""
    kw = ATTN[variant]
    (qj, kj, _, _), (qt, kt, _, _) = _attn_inputs("float32", seed=3)
    b, s, hq, d = qt.shape
    hkv = kt.shape[2]
    logits = jnp.einsum("bqkgd,bskd->bkgqs", qj.reshape(b, s, hkv, hq // hkv, d), kj) * d ** -0.5
    if kw.get("softcap") is not None:
        logits = kw["softcap"] * jnp.tanh(logits / kw["softcap"])
    pos = jnp.arange(s)
    mask = jnp.ones((s, s), bool)
    if kw["causal"]:
        mask &= pos[:, None] >= pos[None, :]
    if kw.get("window") is not None:
        mask &= (pos[:, None] - pos[None, :]) < kw["window"]
    want = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1).reshape(b, hq, s)
    got = fa.attention_lse_plain(qt, kt, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, s)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL_LSE


def test_lse_of_a_row_with_no_key_is_inf():
    """A row the window hides wholly (window 0) gets +inf, so the backward's
    P = exp(t - lse) is 0 there, as the kernel's forward output is."""
    _, (q, k, v, do) = _attn_inputs("float32", s=5)
    lse = fa.attention_lse_plain(q, k, causal=True, window=0)
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())


def test_flash_bwd_wrapper_on_cpu_asks_only_what_is_needed():
    """``flash_attention_gqa_bwd`` on CPU tensors is its plain version, with
    None for what is not asked."""
    _, (q, k, v, do) = _attn_inputs("float32", seed=4)
    o, lse = fa.flash_attention_gqa(q, k, v, causal=True, with_lse=True)
    full = fa.flash_attention_gqa_bwd_plain(q, k, v, o, lse, do, causal=True)
    dq, dk, dv = fa.flash_attention_gqa_bwd(q, k, v, o, lse, do, causal=True, need_dkv=False)
    assert torch.equal(dq, full[0]) and dk is None and dv is None
    dq, dk, dv = fa.flash_attention_gqa_bwd(q, k, v, o, lse, do, causal=True, need_dq=False)
    assert dq is None and torch.equal(dk, full[1]) and torch.equal(dv, full[2])


def test_flash_function_backward_on_cpu():
    """``dispatch.flash_attention`` on ``cuda`` with CPU tensors, GQA,
    window and softcap: the Function's gradients are the closed form's on
    its forward's output and lse, bit for bit, and within TOL of autograd
    through the port's transcription ``attention_scores``."""
    from repro_torch.models.layers import attention_scores as t_attention
    _, (q, k, v, do) = _attn_inputs("float32", seed=6)
    kw = dict(causal=True, window=11, softcap=4.0)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = td.flash_attention(*live, backend="cuda", **kw)
    got = torch.autograd.grad(out, live, do)
    o, lse = fa.flash_attention_gqa_plain(q, k, v, with_lse=True, **kw)
    closed = fa.flash_attention_gqa_bwd_plain(q, k, v, o, lse, do, **kw)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(t_attention(*live, causal=True, window=11, cap=4.0), live, do)
    for a, b, w in zip(got, closed, ref):
        assert torch.equal(a, b) and _rel(a, w) <= TOL
