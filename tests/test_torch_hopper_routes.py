"""The route choice of the tensor-core kernels, the numerics of the
tensor-core route, and the kernel build's digest, on the CPU.

* :func:`gmm_route`, :func:`flash_route`, :func:`ssd_route` and the
  backwards' :func:`flash_bwd_route` and :func:`ssd_bwd_route` pick
  ``"wgmma"`` or ``"simt"`` from dtype, widths, strides and
  ``data_ptr() % 16`` alone, so CPU tensors (strided views, offset slices)
  exercise every case.
* A dense model of ssd_chunk's tensor-core arithmetic (fp32 and fp16
  operands and the fp32 intermediates split three ways into bf16, the part
  products summed in fp32, the kernel's block-scan cumsum order) is held
  against the JAX kernel per row within 2.5e-5, a quarter of the 1e-4 the
  card is held to.
* A dense model of the tensor-core route's arithmetic (bf16 / fp16 products
  summed in fp32; in attention, P = exp(s - m) rounded to q's dtype before
  P V while l sums the fp32 P) is held against the JAX package's
  ``repro.kernels.ops`` (Pallas in interpret mode), per output row: the
  largest error of a row over that row's max|want|, within 1e-2 in bf16
  and 2e-3 in fp16, the tolerances ``chip_smoke.py`` holds the kernels to
  on the card.  Rounding P is the one rounding the plain versions do not
  make; at most 2^-9 (bf16) or 2^-12 (fp16) of each p, plus one rounding
  of the output.
* Dense models of the two backward kernels' "wgmma" routes (attention:
  P and dS rounded to the dtype where the kernel rounds them; the SSD
  chunk: G2, M and w o x split three ways, products over
  :data:`SPLIT_PAIRS`) against ``jax.vjp`` of ``attention_scores`` and of
  ``ssd_chunk_ref``, with the tolerances stated beside each.
* ``_build._digest`` hashes every file of ``csrc/``, headers included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import ssd_chunk_ref
from repro.models.layers import attention_scores
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_tensor, stored_transposed
from repro_torch.kernels.flash_attention import flash_bwd_route, flash_route
from repro_torch.kernels.gmm import gmm_route
from repro_torch.kernels.ssd_scan import ssd_bwd_route, ssd_route

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROW_TOL = {"bfloat16": 1e-2, "float16": 2e-3}


def _offset(shape, dtype):
    """A contiguous tensor whose base is one element past a 16-byte
    boundary (the allocator aligns the buffer it views)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _wide(shape, pad, dtype):
    """A view of the first ``shape[-1]`` of ``shape[-1] + pad`` columns:
    the rows are ``(shape[-1] + pad)`` elements apart."""
    return torch.zeros(*shape[:-1], shape[-1] + pad, dtype=dtype)[..., :shape[-1]]


BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32

GMM_CASES = {
    "bf16": (lambda: (torch.zeros(2, 3, 16, dtype=BF), torch.zeros(2, 16, 24, dtype=BF)),
             "wgmma"),
    "fp16": (lambda: (torch.zeros(2, 3, 16, dtype=F16), torch.zeros(2, 16, 24, dtype=F16)),
             "wgmma"),
    "fp32": (lambda: (torch.zeros(2, 3, 16), torch.zeros(2, 16, 24)), "simt"),
    "dtypes differ": (lambda: (torch.zeros(2, 3, 16, dtype=BF),
                               torch.zeros(2, 16, 24, dtype=F16)), "simt"),
    "D 20: x rows of 40 bytes": (lambda: (torch.zeros(2, 3, 20, dtype=BF),
                                          torch.zeros(2, 20, 24, dtype=BF)), "simt"),
    "F 12: w rows of 24 bytes": (lambda: (torch.zeros(2, 3, 16, dtype=BF),
                                          torch.zeros(2, 16, 12, dtype=BF)), "simt"),
    "x base off 16 bytes": (lambda: (_offset((2, 3, 16), BF), torch.zeros(2, 16, 24, dtype=BF)),
                            "simt"),
    "w base off 16 bytes": (lambda: (torch.zeros(2, 3, 16, dtype=BF), _offset((2, 16, 24), BF)),
                            "simt"),
    "w view, rows 32 apart": (lambda: (torch.zeros(2, 3, 16, dtype=BF), _wide((2, 16, 24), 8, BF)),
                              "wgmma"),
    "w view, rows 28 apart": (lambda: (torch.zeros(2, 3, 16, dtype=BF), _wide((2, 16, 24), 4, BF)),
                              "simt"),
    "D 0": (lambda: (torch.zeros(2, 3, 0, dtype=BF), torch.zeros(2, 0, 24, dtype=BF)), "simt"),
    # the backward's operands: views of the stored x (E, C, D) and w (E, D, F)
    "x^T view (dw = x^T g)": (lambda: (torch.zeros(2, 8, 16, dtype=BF).transpose(1, 2),
                                       torch.zeros(2, 8, 24, dtype=BF)), "wgmma"),
    "w^T view (dx = g w^T)": (lambda: (torch.zeros(2, 3, 24, dtype=BF),
                                       torch.zeros(2, 16, 24, dtype=BF).transpose(1, 2)),
                              "wgmma"),
    "x^T and w^T views, fp16": (lambda: (torch.zeros(2, 16, 8, dtype=F16).transpose(1, 2),
                                         torch.zeros(2, 24, 16, dtype=F16).transpose(1, 2)),
                                "wgmma"),
    "x^T view, stored rows of 24 bytes (C 12)": (
        lambda: (torch.zeros(2, 16, 12, dtype=BF).transpose(1, 2),
                 torch.zeros(2, 12, 24, dtype=BF)), "simt"),
    "w^T view, out rows of 24 bytes (N 12)": (
        lambda: (torch.zeros(2, 3, 16, dtype=BF),
                 torch.zeros(2, 12, 16, dtype=BF).transpose(1, 2)), "simt"),
    "w^T view, base off 16 bytes": (
        lambda: (torch.zeros(2, 3, 16, dtype=BF), _offset((2, 24, 16), BF).transpose(1, 2)),
        "simt"),
    "x^T view, fp32": (lambda: (torch.zeros(2, 8, 16).transpose(1, 2), torch.zeros(2, 8, 24)),
                       "simt"),
}


@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_route(case):
    make, want = GMM_CASES[case]
    x, w = make()
    assert gmm_route(x, w) == want


def test_gmm_checks_take_the_transposed_layout_only():
    """gmm's operands may be the transpose of a contiguous tensor in their
    last two axes (``stored_transposed``), and ``check_tensor`` lets
    that layout alone through, only where the wrapper asks."""
    class _Cuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    dev = torch.device("cuda", 0)
    viewed = torch.zeros(2, 8, 16).transpose(1, 2)
    assert stored_transposed(viewed) and not stored_transposed(torch.zeros(2, 16, 8))
    assert not stored_transposed(torch.zeros(2, 16, 8)[:, :, :4])
    check_tensor("x", viewed.as_subclass(_Cuda), 3, (F32,), dev, transposed_ok=True)
    for t, ok, msg in ((viewed, False, "x: must be contiguous"),
                       (torch.zeros(2, 16, 12)[:, :, :8], True,
                        "x: must be contiguous or the transpose of a contiguous tensor in its "
                        "last two axes"),
                       (torch.zeros(4, 8, 16).transpose(0, 2), True,
                        "x: must be contiguous or the transpose of a contiguous tensor in its "
                        "last two axes")):
        with pytest.raises(ValueError) as err:
            check_tensor("x", t.as_subclass(_Cuda), 3, (F32,), dev, transposed_ok=ok)
        assert str(err.value) == msg


def _gqa(d, dtype, s=8, hq=4, hkv=2):
    return (torch.zeros(1, s, hq, d, dtype=dtype), torch.zeros(1, s, hkv, d, dtype=dtype),
            torch.zeros(1, s, hkv, d, dtype=dtype))


FLASH_CASES = {
    "bf16 D64": (lambda: _gqa(64, BF), "wgmma"),
    "bf16 D128": (lambda: _gqa(128, BF), "wgmma"),
    "bf16 D256": (lambda: _gqa(256, BF), "wgmma"),
    "fp16 D128": (lambda: _gqa(128, F16), "wgmma"),
    "fp32 D128": (lambda: _gqa(128, F32), "simt"),
    "bf16 D112 (zamba2)": (lambda: _gqa(112, BF, hq=4, hkv=4), "wgmma"),
    "fp16 D112": (lambda: _gqa(112, F16), "wgmma"),
    "bf16 D96 (phi-3-vision)": (lambda: _gqa(96, BF, hq=4, hkv=4), "wgmma"),
    "fp16 D96": (lambda: _gqa(96, F16), "wgmma"),
    "fp32 D112": (lambda: _gqa(112, F32), "simt"),
    "(BH, S, D) bf16 D112": (lambda: (torch.zeros(2, 8, 112, dtype=BF),) * 3, "wgmma"),
    "bf16 D80: no template case": (lambda: _gqa(80, BF), "simt"),
    "bf16 D32: no template case": (lambda: _gqa(32, BF), "simt"),
    "k and v fp16 under bf16 q": (lambda: (_gqa(128, BF)[0], *_gqa(128, F16)[1:]), "simt"),
    "(BH, S, D) bf16 D256": (lambda: (torch.zeros(2, 8, 256, dtype=BF),) * 3, "wgmma"),
    "q base off 16 bytes": (lambda: (_offset((1, 8, 4, 128), BF), *_gqa(128, BF)[1:]), "simt"),
    "v base off 16 bytes": (lambda: (*_gqa(128, BF)[:2], _offset((1, 8, 2, 128), BF)), "simt"),
    "q view, rows 136 apart": (lambda: (_wide((1, 8, 4, 128), 8, BF), *_gqa(128, BF)[1:]),
                               "wgmma"),
    "q view, rows 132 apart": (lambda: (_wide((1, 8, 4, 128), 4, BF), *_gqa(128, BF)[1:]),
                               "simt"),
    "heads-first views (B, H, S, D) -> (B, S, H, D)": (
        lambda: tuple(torch.zeros(1, h, 8, 128, dtype=BF).transpose(1, 2) for h in (4, 2, 2)),
        "wgmma"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_route(case):
    make, want = FLASH_CASES[case]
    assert flash_route(*make()) == want


# the backward's route: "wgmma" wherever the forward's is, with the
# output's cotangent (laid out as q) readable too
FLASH_BWD_CASES = {
    **{k: (lambda make=make: (*make(), torch.empty_like(make()[0])), want)
       for k, (make, want) in FLASH_CASES.items()},
    "do base off 16 bytes": (lambda: (*_gqa(128, BF), _offset((1, 8, 4, 128), BF)), "simt"),
    "do fp16 under bf16 q": (lambda: (*_gqa(128, BF), torch.zeros(1, 8, 4, 128, dtype=F16)),
                             "simt"),
}


@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_flash_bwd_route(case):
    make, want = FLASH_BWD_CASES[case]
    assert flash_bwd_route(*make()) == want


# ---------------------------------------------------------------------------
# the tensor-core route's numerics against the JAX package
# ---------------------------------------------------------------------------

def _row_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    got, want = got.reshape(-1, want.shape[-1]), want.reshape(-1, want.shape[-1])
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


def tc_attention_model(q, k, v, *, causal, window, softcap, dtype):
    """The tensor-core route's arithmetic, dense: q, k, v (BH, S, D) in
    ``dtype``; fp32 logits, softcap and masks as the plain version; P =
    exp(s - m) rounded to ``dtype`` before P V, l summed from the fp32 P;
    out = P V / max(l, 1e-30) rounded to ``dtype``."""
    s_len, d = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(s_len)
    mask = torch.ones(s_len, s_len, dtype=torch.bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p.to(dtype).float(), v.float())
    return (o / l.clamp_min(1e-30)).to(dtype)


ATTN_CASES = [  # (S, D, causal, window, softcap)
    (256, 128, True, None, None),
    (256, 256, True, None, 50.0),
    (256, 256, True, 96, 50.0),
    (200, 128, False, 64, 30.0),
    (200, 112, True, None, None),       # zamba2's head dim
    (256, 96, False, 64, 30.0),         # phi-3-vision's
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("s,d,causal,window,cap", ATTN_CASES)
def test_tc_attention_model_matches_jax(s, d, causal, window, cap, dtype):
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal((2, s, d)).astype(np.float32) for _ in range(3)]
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = tc_attention_model(tq, tk, tv, dtype=getattr(torch, dtype), **kw)
    want = jops.flash_attention(jq, jk, jv, **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    assert _row_err(got.float().numpy(), np.asarray(want, np.float32)) <= ROW_TOL[dtype]


def _row_err_floor(got, want, floor: float) -> float:
    """:func:`_row_err` with each row held to no less than ``floor`` times
    the tensor's max|want|, as ``chip_smoke.py::row_err`` holds the
    gradients (a row whose true value is about 0, as dq of a query that
    sees one key, keeps only rounding noise)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    got, want = got.reshape(-1, want.shape[-1]), want.reshape(-1, want.shape[-1])
    err = np.abs(got - want).max(axis=-1)
    scale = np.maximum(np.abs(want).max(axis=-1), max(1e-30, floor * np.abs(want).max()))
    return float((err / scale).max())


def tc_attention_bwd_model(q, k, v, do, *, causal, window, softcap, dtype):
    """The backward's "wgmma" route, dense: q, do (B, S, Hq, D) and k, v (B,
    S, Hkv, D) in ``dtype``.  The forward as :func:`tc_attention_model`
    gives O (rounded to ``dtype``) and the rows' lse; then, with fp32
    sums: Delta = rowsum(dO o O); P = exp(t - lse) on the mask; dV = P^T
    dO with P rounded to ``dtype``; dP = dO V^T; dS = g (dP - Delta)
    scale, g = P (1 - tanh^2) under the softcap, else P; dS rounded to
    ``dtype``; dQ = dS K and dK = dS^T q, each rounded to ``dtype``."""
    b, s_len, hq, d = q.shape
    rep = hq // k.shape[2]
    f = lambda t: t.float()  # noqa: E731
    kr, vr = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", f(q), f(kr)) * d ** -0.5
    th = None
    if softcap is not None:
        th = torch.tanh(sc / softcap)
        sc = softcap * th
    pos = torch.arange(s_len)
    mask = torch.ones(s_len, s_len, dtype=torch.bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    sc = sc.masked_fill(~mask, -torch.inf)
    lse = torch.logsumexp(sc, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - lse), 0.0)
    o = (torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).float(), f(vr))).to(dtype)
    delta = torch.einsum("bqhd,bqhd->bhq", f(do), f(o))[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), f(do))
    dp = torch.einsum("bqhd,bkhd->bhqk", f(do), f(vr))
    g = p if th is None else p * (1 - th * th)
    ds = (g * (dp - delta) * d ** -0.5).to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, f(kr))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, f(q))
    grp = lambda t: t.reshape(b, s_len, k.shape[2], rep, d).sum(3)  # noqa: E731
    return dq.to(dtype), grp(dk).to(dtype), grp(dv).to(dtype)


# the backward model against jax.vjp in fp32 of the same (dtype-rounded)
# inputs, per row, rows held to at least 1e-2 of the tensor's max
# (chip_smoke.py's BWD_ROW_FLOOR): the model's roundings are P and dS to the
# dtype and the three gradients, and dS's 2^-9 (bf16) is amplified by the
# cancellation of dQ = dS K, most under the softcap (measured 3.6e-2 in bf16,
# 4.5e-3 in fp16); 4e-2 in bf16 is the bf16 tolerance of the closed form
# against jax.vjp (test_torch_backward_kernels.py), 1e-2 in fp16
BWD_ROW_TOL = {"bfloat16": 4e-2, "float16": 1e-2}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("s,d,causal,window,cap", ATTN_CASES)
def test_tc_attention_bwd_model_matches_jax_vjp(s, d, causal, window, cap, dtype):
    """The backward's arithmetic, GQA 2:1, at each variant of ATTN_CASES
    (S 256 and the ragged 200), against jax.vjp of the JAX package's
    ``attention_scores`` in fp32 on the same inputs rounded to the dtype."""
    rng = np.random.default_rng(17)
    shapes = ((1, s, 2, d), (1, s, 1, d), (1, s, 1, d), (1, s, 2, d))
    tq, tk, tv, tdo = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                       .to(getattr(torch, dtype)) for sh in shapes)
    got = tc_attention_bwd_model(tq, tk, tv, tdo, causal=causal, window=window, softcap=cap,
                                 dtype=getattr(torch, dtype))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv, tdo))
    _, vjp = jax.vjp(lambda q, k, v: attention_scores(q, k, v, causal=causal, window=window,
                                                      cap=cap), jq, jk, jv)
    for name, t, w in zip("qkv", got, vjp(jdo)):
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == w.shape, name
        err = _row_err_floor(t.float().numpy(), np.asarray(w, np.float32), 1e-2)
        assert err <= BWD_ROW_TOL[dtype], (name, err)


def tc_gmm_model(x, w, slab: int = 64):
    """The tensor-core route's gmm: exact products summed in fp32 one
    ``slab``-deep K slab at a time, rounded to x's dtype."""
    acc = torch.zeros(x.shape[0], x.shape[1], w.shape[2])
    for k0 in range(0, x.shape[2], slab):
        acc += torch.einsum("ecd,edf->ecf", x[:, :, k0:k0 + slab].float(),
                            w[:, k0:k0 + slab].float())
    return acc.to(x.dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tc_gmm_model_matches_jax(dtype):
    rng = np.random.default_rng(12)
    e, c, d, f = 3, 130, 200, 264
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    got = tc_gmm_model(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w)))
    want = jops.gmm(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w)))
    assert got.dtype == getattr(torch, dtype)
    assert _row_err(got.float().numpy(), np.asarray(want, np.float32)) <= ROW_TOL[dtype]


# ---------------------------------------------------------------------------
# the build hashes headers too
# ---------------------------------------------------------------------------

def test_digest_follows_every_csrc_file(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "parts.cuh"\n')
    (tmp_path / "parts.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest()
    assert _build._digest() == first                 # nothing changed
    (tmp_path / "parts.cuh").write_text("// v2\n")
    second = _build._digest()
    assert second != first                           # a header edit rebuilds
    (tmp_path / "k.cu").write_text('#include "parts.cuh"\n// edit\n')
    assert _build._digest() not in (first, second)   # so does a source edit


def test_build_compiles_only_sources(tmp_path, monkeypatch):
    for name in ("a.cu", "b.cu", "parts.cuh"):
        (tmp_path / name).write_text("")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources()] == ["a.cu", "b.cu"]


# ---------------------------------------------------------------------------
# ssd_chunk: the route choice and the tensor-core route's numerics
# ---------------------------------------------------------------------------

def _ssd(g=2, q=64, p=32, n=16, dtype=F32, **over):
    t = dict(x=torch.zeros(g, q, p, dtype=dtype), dt=torch.zeros(g, q, dtype=dtype),
             A=torch.zeros(g, dtype=dtype), B=torch.zeros(g, q, n, dtype=dtype),
             C=torch.zeros(g, q, n, dtype=dtype))
    t.update({k: v() for k, v in over.items()})
    return t["x"], t["dt"], t["A"], t["B"], t["C"]


SSD_CASES = {
    "fp32 P32 N16": (lambda: _ssd(), "wgmma"),
    "bf16 P64 N128": (lambda: _ssd(p=64, n=128, dtype=BF), "wgmma"),
    "fp16 P16 N32": (lambda: _ssd(p=16, n=32, dtype=F16), "wgmma"),
    "bf16 Q100 P64 N128": (lambda: _ssd(q=100, p=64, n=128, dtype=BF), "wgmma"),
    "dt fp32 under bf16 x": (lambda: _ssd(dtype=BF, dt=lambda: torch.zeros(2, 64)), "simt"),
    "B fp16 under fp32 x": (lambda: _ssd(B=lambda: torch.zeros(2, 64, 16, dtype=F16)), "simt"),
    "P 24: not a multiple of 16": (lambda: _ssd(p=24), "simt"),
    "N 8: not a multiple of 16": (lambda: _ssd(n=8), "simt"),
    "P 128: wider than the tile": (lambda: _ssd(p=128), "simt"),
    "N 144: wider than the tile": (lambda: _ssd(n=144), "simt"),
    "Q 512": (lambda: _ssd(q=512), "wgmma"),
    "Q 520: dt and dA outgrow shared memory": (lambda: _ssd(q=520), "simt"),
    "x base off 16 bytes": (lambda: _ssd(x=lambda: _offset((2, 64, 32), F32)), "simt"),
    "C base off 16 bytes": (lambda: _ssd(dtype=BF, C=lambda: _offset((2, 64, 16), BF)),
                            "simt"),
}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_route(case):
    make, want = SSD_CASES[case]
    assert ssd_route(*make()) == want


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_bwd_route(case):
    """The backward's route is "wgmma" exactly where the forward's is: the
    same dtypes, widths, chunk length and alignment."""
    make, want = SSD_CASES[case]
    assert ssd_bwd_route(*make()) == want


def _split3(t: torch.Tensor):
    """fp32 -> (hi, mid, lo) as floats: hi = bf16(t), mid = bf16(t - hi),
    lo = bf16(t - hi - mid), each difference exact in fp32."""
    parts, rest = [], t
    for _ in range(3):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


# the products of two three-way split operands that the kernel sums: all
# terms down to 2^-16 of hi * hi (hi*lo ~ 2^-18, mid*mid ~ 2^-18)
SPLIT_PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))


def _split_matmul(a_parts, b_parts):
    if len(b_parts) == 1:                       # b exact in bf16
        return sum(a @ b_parts[0] for a in a_parts)
    return sum(a_parts[i] @ b_parts[j] for i, j in SPLIT_PAIRS)


def block_cumsum_model(d: np.ndarray, threads: int = 128) -> np.ndarray:
    """The kernel's cumsum of the fp32 values ``d`` (Q,), in its order of
    additions: thread t runs over its ceil(Q / threads) consecutive values;
    the lanes of each warp scan the thread totals (Hillis-Steele, offsets
    1 .. 16); a value is then (totals of the warps before, in order, + its
    lane's exclusive prefix) + its running sum."""
    f32 = np.float32
    q = d.shape[0]
    k = -(-q // threads)
    run = np.zeros((threads, k), f32)
    tot = np.zeros(threads, f32)
    for t in range(threads):
        acc = f32(0)
        for j in range(k):
            if t * k + j < q:
                acc = f32(acc + d[t * k + j])
                run[t, j] = acc
        tot[t] = acc
    inc = tot.reshape(-1, 32).copy()
    off = 1
    while off < 32:
        up = np.concatenate([np.zeros((inc.shape[0], off), f32), inc[:, :-off]], axis=1)
        inc = np.where(np.arange(32) >= off, (inc + up).astype(f32), inc)
        off *= 2
    excl = np.concatenate([np.zeros((inc.shape[0], 1), f32), inc[:, :-1]], axis=1)
    out = np.zeros(q, f32)
    for t in range(threads):
        w, lane = divmod(t, 32)
        base = f32(0)
        for v in range(w):
            base = f32(base + inc[v, 31])
        start = f32(base + excl[w, lane])
        for j in range(k):
            if t * k + j < q:
                out[t * k + j] = f32(start + run[t, j])
    return out


def tc_ssd_model(x, dt, A, B, C):
    """The "wgmma" route's arithmetic, dense, one chunk at a time: the
    block-scan cumsum; fp32 and fp16 inputs split three ways into bf16
    (bf16 inputs taken as they are); the fp32 intermediates S' = (S *
    exp(dA[l] - dA[s])) * dt[s] (below the diagonal) and decay * dt * x
    split the same way; every product summed in fp32 over
    :data:`SPLIT_PAIRS` (one split operand: over its three parts)."""
    f = lambda t: t.float()
    parts = (lambda t: [f(t)]) if x.dtype == torch.bfloat16 else (lambda t: _split3(f(t)))
    ys, sts, cds, sds = [], [], [], []
    for g in range(x.shape[0]):
        d = (f(dt[g]) * f(A[g])).numpy()
        dA = torch.from_numpy(block_cumsum_model(d))
        q = dA.shape[0]
        xs, bs, cs = parts(x[g]), parts(B[g]), parts(C[g])
        s = _split_matmul(cs, [b.T for b in bs])
        mask = torch.tril(torch.ones(q, q, dtype=torch.bool))
        seg = torch.where(mask, dA[:, None] - dA[None, :], 0.0)
        sp = torch.where(mask, (s * torch.exp(seg)) * f(dt[g])[None, :], 0.0)
        ys.append(_split_matmul(_split3(sp), xs))
        w = torch.exp(dA[-1] - dA) * f(dt[g])
        sts.append(_split_matmul([a.T for a in _split3(f(x[g]) * w[:, None])], bs))
        cds.append(torch.exp(dA[-1]))
        sds.append(torch.exp(dA))
    return torch.stack(ys), torch.stack(sts), torch.stack(cds), torch.stack(sds)


# the "wgmma" route's budget on the card is 1e-4 per row (OPS_TOL in
# chip_smoke.py); its model must stay within a quarter of it
SSD_MODEL_TOL = 2.5e-5


def _ssd_numpy(rng, g, q, p, n):
    """Mamba-2's initialisation ranges, as chip_smoke.py draws them: dt
    log-uniform in [1e-3, 1e-1], A = -uniform(1, 16)."""
    dt = np.exp(np.log(1e-3) + rng.random((g, q)) * np.log(100.0))
    A = -(1.0 + 15.0 * rng.random(g))
    x, B, C = (rng.standard_normal((g, q, k)) for k in (p, n, n))
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("q,p,n", [(64, 16, 16), (100, 32, 32), (100, 16, 32), (256, 64, 128)])
def test_tc_ssd_model_matches_jax(q, p, n, dtype):
    args = _ssd_numpy(np.random.default_rng(13), 3, q, p, n)
    got = tc_ssd_model(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in args))
    want = jops.ssd_chunk(*(jnp.asarray(a, getattr(jnp, dtype)) for a in args))
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape
        assert _row_err(t.numpy(), np.asarray(j, np.float32)) <= SSD_MODEL_TOL


def tc_ssd_bwd_model(x, dt, A, B, C, gy, gst, gcd, gsd):
    """The backward's "wgmma" route, dense, one chunk at a time, in fp32:
    x, B, C, the cotangents and the fp32 intermediates G2 = (gy u^T) o L, M
    = (C B^T) o L and w o x entering every product split three ways into
    bf16, each product summed over :data:`SPLIT_PAIRS`; the row and column
    sums of G2 o CB, gx, gw and sum_p x o gu, and the O(Q) rest (gc, its
    reverse cumsum, gdt, gA) as the finishing kernel takes them."""
    outs = [[] for _ in range(5)]
    for g in range(x.shape[0]):
        xs, bs, cs, gys, gsts = (_split3(t[g]) for t in (x, B, C, gy, gst))
        dtg, a = dt[g], A[g]
        q = x.shape[1]
        c = torch.cumsum(dtg * a, 0)
        mask = torch.tril(torch.ones(q, q, dtype=torch.bool))
        L = torch.where(mask, torch.exp(torch.where(mask, c[:, None] - c[None, :], 0.0)), 0.0)
        cb = _split_matmul(cs, [t.T for t in bs])
        g2 = _split_matmul(gys, [t.T for t in xs]) * dtg[None, :] * L
        e = g2 * cb
        gC = _split_matmul(_split3(g2), bs)
        gB = _split_matmul([t.T for t in _split3(g2)], cs)
        gu = _split_matmul([t.T for t in _split3(cb * L)], gys)
        w = torch.exp(c[-1] - c) * dtg
        bg = _split_matmul(bs, [t.T for t in gsts])
        gB = gB + _split_matmul(_split3(w[:, None] * x[g]), gsts)
        gx = dtg[:, None] * gu + w[:, None] * bg
        gw = (x[g] * bg).sum(1)
        gc = e.sum(1) - e.sum(0) - gw * w + gsd[g] * torch.exp(c)
        gc[-1] += (gw * w).sum() + gcd[g] * torch.exp(c[-1])
        ga = torch.flip(torch.cumsum(torch.flip(gc, (0,)), 0), (0,))
        gdt = (x[g] * gu).sum(1) + gw * torch.exp(c[-1] - c) + a * ga
        for out, t in zip(outs, (gx, gdt, (ga * dtg).sum(), gB, gC)):
            out.append(t)
    return tuple(torch.stack(o) for o in outs)


# per row against jax.vjp in fp32: the route's budget on the card is 1e-4
# per row against the closed form (chip_smoke.py's BWD_TOL); its model must
# stay within a quarter of it
SSD_BWD_MODEL_TOL = 2.5e-5


@pytest.mark.parametrize("q,p,n", [(128, 32, 64), (100, 64, 128)])
def test_tc_ssd_bwd_model_matches_jax_vjp(q, p, n):
    """The backward's arithmetic at a chunk of two 64-row strips and at a
    ragged one (Q 100) at the widths of mamba2-780m (P 64, N 128), against
    jax.vjp of the JAX package's ``ssd_chunk_ref`` with the chunks as its
    heads, cotangents on all four outputs."""
    rng = np.random.default_rng(19)
    ins = _ssd_numpy(rng, 2, q, p, n)
    cots = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, q, p), (2, p, n), (2,), (2, q))]
    got = tc_ssd_bwd_model(*(torch.from_numpy(a) for a in ins + cots))
    x, dt, A, B, C = (jnp.asarray(a) for a in ins)

    def f(x, dt, A, B, C):
        y, st, cd, sd = ssd_chunk_ref(x.transpose(1, 0, 2), dt.T, A, B.transpose(1, 0, 2),
                                      C.transpose(1, 0, 2))
        return y.transpose(1, 0, 2), st, cd, sd.T

    _, vjp = jax.vjp(f, x, dt, A, B, C)
    for name, t, w in zip(("x", "dt", "A", "B", "C"), got,
                          vjp(tuple(jnp.asarray(c) for c in cots))):
        assert tuple(t.shape) == w.shape, name
        err = _row_err(t.numpy(), np.asarray(w, np.float32))
        assert err <= SSD_BWD_MODEL_TOL, (name, err)


def test_block_cumsum_model_is_a_cumsum():
    d = np.random.default_rng(14).standard_normal(300).astype(np.float32)
    got = block_cumsum_model(d)
    np.testing.assert_allclose(got, np.cumsum(d.astype(np.float64)), rtol=0, atol=1e-4)
    assert got[0] == d[0]
