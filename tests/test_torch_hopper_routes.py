"""The route choice of the tensor-core kernels, the numerics of the
tensor-core route, and the kernel build's digest, on the CPU.

* :func:`gmm_route` and :func:`flash_route` pick ``"wgmma"`` or ``"simt"``
  from dtype, head dim, strides and ``data_ptr() % 16`` alone, so CPU
  tensors (strided views, offset slices) exercise every case.
* A dense model of the tensor-core route's arithmetic (bf16 / fp16 products
  summed in fp32; in attention, P = exp(s - m) rounded to q's dtype before
  P V while l sums the fp32 P) is held against the JAX package's
  ``repro.kernels.ops`` (Pallas in interpret mode), per output row: the
  largest error of a row over that row's max|want|, within 1e-2 in bf16
  and 2e-3 in fp16, the tolerances ``chip_smoke.py`` holds the kernels to
  on the card.  Rounding P is the one rounding the plain versions do not
  make; at most 2^-9 (bf16) or 2^-12 (fp16) of each p, plus one rounding
  of the output.
* ``_build._digest`` hashes every file of ``csrc/``, headers included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_route
from repro_torch.kernels.gmm import gmm_route

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
}


@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_route(case):
    make, want = GMM_CASES[case]
    x, w = make()
    assert gmm_route(x, w) == want


def _gqa(d, dtype, s=8, hq=4, hkv=2):
    return (torch.zeros(1, s, hq, d, dtype=dtype), torch.zeros(1, s, hkv, d, dtype=dtype),
            torch.zeros(1, s, hkv, d, dtype=dtype))


FLASH_CASES = {
    "bf16 D64": (lambda: _gqa(64, BF), "wgmma"),
    "bf16 D128": (lambda: _gqa(128, BF), "wgmma"),
    "bf16 D256": (lambda: _gqa(256, BF), "wgmma"),
    "fp16 D128": (lambda: _gqa(128, F16), "wgmma"),
    "fp32 D128": (lambda: _gqa(128, F32), "simt"),
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
