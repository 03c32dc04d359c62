"""The port's MoE FFN and MLA attention against the JAX package's, on the CPU.

Inputs are numpy draws from a seed; the JAX package's own params cross with
``bridge.lm_params_from_numpy``.  Tolerances, relative to the reference's
max|y| (logits: max|logit| over the true vocab):

* fp32 compute: 1e-5 (sums in other orders; the router's softmax and its
  top-k see the same f32 logits, so routings and capacity drop sets are
  equal);
* bf16 compute, one layer's functions: 4e-2, as ``test_torch_lm_models.py``
  reads bf16 (eager PyTorch rounds every op's output where XLA's fusions
  keep some in f32); the aux loss, computed in f32 from the same routing,
  1e-5.

Whole-model bf16 parity against the JAX package is left out on purpose: a
routing whose k-th and (k+1)-th router probabilities nearly tie can flip
between the two packages' bf16 roundings, and a flipped expert moves that
token's output by a whole expert's share, beyond any rounding tolerance.
bf16 is held instead where it is a property of the port alone: decode
against prefill at ``capacity_factor`` 8 (no drops) within 0.02, as
``tests/test_arch_smoke.py`` holds the JAX package.

The ``cuda`` backend on CPU tensors runs the gmm kernel's plain version
(fp32 sums, the output rounded once) in place of the reference's einsum.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.lm_backbone import make_lm_backbone as j_lm_bb
from repro.models.registry import get_api as j_get_api
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bridge import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.configs import registry as treg
from repro_torch.kernels import _checks, dispatch
from repro_torch.kernels import gmm as tgm
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as TT
from repro_torch.models.lm_backbone import make_lm_backbone
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

MOE_ARCHS = ["kimi-k2-1t-a32b", "deepseek-v2-236b"]
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
PROMPT = 24
MAX_SEQ = 40


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


def _rel(got, want, vocab=None) -> float:
    got, want = _f32(got), _f32(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, dtype="float32", **moe):
    jc = dataclasses.replace(jreg.get_smoke_config(arch), compute_dtype=dtype)
    tc = dataclasses.replace(treg.get_smoke_config(arch), compute_dtype=dtype)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return _np(JT.init_transformer(jax.random.key(0), jreg.get_smoke_config(arch)))


def _tokens(cfg, b=1, s=PROMPT, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(toks).long())


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

# (name, MoEConfig fields): the smoke config's, one that must drop, one
# with a router softcap
MOE_CASES = {"smoke": {}, "cf0.5": dict(capacity_factor=0.5),
             "softcap": dict(router_softcap=2.0)}


def _moe_inputs(case, dtype, t=40, seed=1):
    jc, tc = _cfgs("kimi-k2-1t-a32b", dtype, **MOE_CASES[case])
    jp = _np(JM.init_moe(jax.random.key(3), jc.d_model, jc.moe))
    x = np.random.default_rng(seed).standard_normal((t, jc.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jc.moe, tc.moe, jp, lm_params_from_numpy(jp, "cpu"), jx, tx


def _kept(ids: np.ndarray, c: int):
    """Per token, the experts that keep it: the reference's stable sort by
    expert id, then capacity c, in numpy."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    seen = {}
    for pos in order:
        e = flat[pos]
        rank[pos] = seen.get(e, 0)
        seen[e] = rank[pos] + 1
    keep = (rank < c).reshape(t, k)
    return [frozenset(ids[i][keep[i]].tolist()) for i in range(t)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_jax(case, dtype):
    """router_probs, capacity, load_balance_loss and moe_ffn; at
    capacity_factor 0.5 tokens drop, and the drop sets are the
    reference's."""
    jm, tm, jp, tp, jx, tx = _moe_inputs(case, dtype)
    t = tx.shape[0]
    assert M.capacity(t, tm) == JM.capacity(t, jm)
    jw, ji, jpr = JM.router_probs(jp, jx, jm)
    tw, ti, tpr = M.router_probs(tp, tx, tm)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tw, jw) <= 1e-5 and _rel(tpr, jpr) <= 1e-5
    assert _rel(M.load_balance_loss(tpr, ti, tm.n_experts),
                JM.load_balance_loss(jpr, ji, jm.n_experts)) <= 1e-5
    c = M.capacity(t, tm)
    kept = _kept(ti.numpy(), c)
    assert kept == _kept(np.asarray(ji), c)
    dropped = sum(tm.top_k - len(s) for s in kept)
    assert (dropped > 0) == (case == "cf0.5")
    jy, jaux = JM.moe_ffn(jp, jx, jm)
    ty, taux = M.moe_ffn(tp, tx, tm, backend="ref")
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert _rel(ty, jy) <= TOL[dtype]
    assert _rel(taux, jaux) <= 1e-5


def test_router_ties_go_to_the_lower_index():
    """All-equal router probabilities: jax.lax.top_k takes experts 0..k-1,
    and so does the port (a stable descending sort; torch.topk documents
    no order among ties)."""
    jm, tm, jp, tp, jx, tx = _moe_inputs("smoke", "float32", t=6)
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, ji, _ = JM.router_probs(jp, jx, jm)
    _, ti, _ = M.router_probs(tp, tx, tm)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [list(range(tm.top_k))] * 6
    # ties between some experts only: rows whose top picks tie pairwise
    r = np.zeros_like(jp["router"])
    r[0, [1, 2, 5, 6]] = 1.0
    jw, ji, _ = JM.router_probs(dict(jp, router=r), jnp.ones_like(jx), jm)
    tw, ti, _ = M.router_probs(dict(tp, router=torch.from_numpy(r)), torch.ones_like(tx), tm)
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and ti[0].tolist() == [1, 2]


def test_moe_cuda_backend_on_cpu_matches_ref():
    """The gmm kernel's plain version in place of the einsum: in fp32 within
    1e-5, in bf16 within 4e-2 (the einsum rounds in bf16 where the plain
    version sums in fp32 and rounds once)."""
    for dtype in ("float32", "bfloat16"):
        _, tm, _, tp, _, tx = _moe_inputs("cf0.5", dtype)
        want, aux = M.moe_ffn(tp, tx, tm, backend="ref")
        got, aux2 = M.moe_ffn(tp, tx, tm, backend="cuda")
        assert _rel(got, want) <= TOL[dtype] and float(aux) == float(aux2)


def test_moe_combine_is_deterministic():
    """Two runs give the same bits (no atomics in pack or combine)."""
    _, tm, _, tp, _, tx = _moe_inputs("smoke", "bfloat16", t=64)
    a, _ = M.moe_ffn(tp, tx, tm, backend="ref")
    b, _ = M.moe_ffn(tp, tx, tm, backend="ref")
    assert torch.equal(a, b)


def test_gmm_dispatch_refuses_grad_on_cuda_naming_its_item():
    """B7 differentiates through its autograd Function: on the ``cuda``
    backend (the kernel's plain version on CPU tensors) an operand that
    requires grad gets the ``ref`` einsum's output and gradients; the raw
    wrapper still refuses a tensor that requires grad outside the
    Function, naming the Function (``dispatch._GMM``)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 16, generator=g, requires_grad=True)
    w = torch.randn(2, 16, 8, generator=g, requires_grad=True)
    dout = torch.randn(2, 8, 8, generator=g)
    got = dispatch.gmm(x, w, backend="cuda")
    want = dispatch.gmm(x, w, backend="ref")
    assert got.grad_fn is not None and _rel(got, want) <= 1e-6
    for a, b in zip(torch.autograd.grad(got, (x, w), dout),
                    torch.autograd.grad(want, (x, w), dout)):
        assert _rel(a, b) <= 1e-6
    meta = [t.detach().to("meta").requires_grad_(True) for t in (x, w)]
    with pytest.raises(RuntimeError, match=r"dispatch\._GMM"):
        tgm.gmm(*meta)
    with pytest.raises(RuntimeError, match=r"dispatch\._GMM"):
        _checks.require_no_grad("gmm", x, w, missing="dispatch._GMM")


def test_loss_through_moe_on_cuda_backend_raises():
    """``loss`` through an MoE layer on the ``cuda`` backend no longer
    raises: its value and every gradient leaf match ``ref``'s (fp32, 1e-5
    / 1e-4 of each leaf's max)."""
    jc, tc = _cfgs("kimi-k2-1t-a32b")
    _, tb = _tokens(tc, b=2, s=16)
    out = {}
    for backend in ("ref", "cuda"):
        tp = tree_map(lambda t: t.requires_grad_(True),
                      lm_params_from_numpy(_jax_params("kimi-k2-1t-a32b"), "cpu"))
        loss, _ = TT.loss(tp, tb, tc, backend=backend)
        out[backend] = (loss, torch.autograd.grad(loss, tree_leaves(tp)))
    assert _rel(out["cuda"][0], out["ref"][0]) <= 1e-5
    for a, b in zip(out["cuda"][1], out["ref"][1]):
        assert _rel(a, b) <= 1e-4


def test_moe_dispatch_without_a_mesh_is_moe_ffn_bit_for_bit(monkeypatch):
    """Over several ranks but with no active mesh the layer is ``moe_ffn``
    on this rank's tokens, bit for bit; under ``use_mesh`` it runs
    expert-parallel (tests/test_torch_moe_ep.py), and nothing raises."""
    from repro_torch.models import moe as M
    _, tc = _cfgs("kimi-k2-1t-a32b")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 4)
    p = M.init_moe(torch.Generator().manual_seed(0), tc.d_model, tc.moe)
    x = torch.randn(4, tc.d_model, generator=torch.Generator().manual_seed(1))
    got, want = TT.moe_dispatch(p, x, tc), M.moe_ffn(p, x, tc.moe)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_functions_match_jax(dtype):
    """mla_queries, mla_latent, mla_attention and mla_decode_attention (the
    absorbed decode against a latent cache of 13 valid positions)."""
    jc, tc = _cfgs("deepseek-v2-236b", dtype)
    a, eps = jc.attention, jc.norm_eps
    jp = _np(JL.init_mla(jax.random.key(4), jc))
    tp = lm_params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jpos, tpos = jnp.arange(16), torch.arange(16)
    for j, t in zip(JL.mla_queries(jp, jx, a, eps, jpos), L.mla_queries(tp, tx, a, eps, tpos)):
        assert t.dtype == tdt and tuple(t.shape) == j.shape and _rel(t, j) <= TOL[dtype]
    for j, t in zip(JL.mla_latent(jp, jx, a, eps, jpos), L.mla_latent(tp, tx, a, eps, tpos)):
        assert tuple(t.shape) == j.shape and _rel(t, j) <= TOL[dtype]
    want = JL.mla_attention(jp, jx, a, eps)
    assert _rel(L.mla_attention(tp, tx, a, eps), want) <= TOL[dtype]
    latent = L.mla_latent(tp, tx, a, eps, tpos)
    assert torch.equal(L.mla_attention(tp, tx, a, eps, latent=latent),
                       L.mla_attention(tp, tx, a, eps))

    ckv = rng.standard_normal((2, 20, a.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, 20, a.qk_rope_dim)).astype(np.float32)
    q = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    want = JL.mla_decode_attention(jp, jnp.asarray(q, jdt), a, eps, jnp.asarray(ckv, jdt),
                                   jnp.asarray(krope, jdt), jnp.asarray(12, jnp.int32))
    got = L.mla_decode_attention(tp, torch.from_numpy(q).to(tdt), a, eps,
                                 torch.from_numpy(ckv).to(tdt),
                                 torch.from_numpy(krope).to(tdt), 12)
    assert got.dtype == tdt and _rel(got, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """prefill (last logits and the cache) and three decode steps from it
    spliced into a MAX_SEQ cache, fp32 compute, within 1e-5."""
    jc, tc = _cfgs(arch)
    jp = _jax_params(arch)
    tp = lm_params_from_numpy(jp, "cpu")
    jb, tb = _tokens(jc)
    jl, jcache = JT.prefill(jax.tree.map(jnp.asarray, jp), jb, jc)
    tl, tcache = TT.prefill(tp, tb, tc, backend="ref")
    assert _rel(tl, jl, jc.vocab) <= TOL["float32"]
    names = ("ckv", "krope") if jc.attention.kind == "mla" else ("k", "v")
    assert sorted(tcache) == sorted(jcache) == sorted(names + ("len",))
    for n in names:
        assert tuple(tcache[n].shape) == jcache[n].shape
        assert _rel(tcache[n], jcache[n]) <= TOL["float32"]
    jfull = JT.init_cache(jc, 1, MAX_SEQ)
    jfull = dict(len=jcache["len"], **{n: jax.lax.dynamic_update_slice(
        jfull[n], jcache[n], (0,) * jfull[n].ndim) for n in names})
    tfull = lm_cache_from_numpy(_np(jfull), "cpu")
    assert sorted(tfull) == sorted(names + ("len",)) and tfull["len"] == PROMPT
    jparams = jax.tree.map(jnp.asarray, jp)
    for tok in (5, 17, 3):
        jl, jfull = JT.decode_step(jparams, jfull, jnp.asarray([[tok]], jnp.int32), jc)
        tl, tfull = TT.decode_step(tp, tfull, torch.tensor([[tok]]), tc, backend="ref")
        assert _rel(tl, jl, jc.vocab) <= TOL["float32"]
    assert tfull["len"] == int(jfull["len"]) == PROMPT + 3
    for n in names:
        assert _rel(tfull[n], jfull[n]) <= TOL["float32"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_backend_on_cpu_matches_ref(arch):
    """prefill and a decode step on ``cuda`` (the gmm kernel's plain
    version; flash attention's for kimi-k2's GQA) against ``ref``, fp32."""
    _, tc = _cfgs(arch)
    tp = lm_params_from_numpy(_jax_params(arch), "cpu")
    _, tb = _tokens(tc, b=2)
    out = {}
    for backend in ("ref", "cuda"):
        logits, cache = TT.prefill(tp, tb, tc, backend=backend)
        full = TT.init_cache(tc, 2, MAX_SEQ, "cpu")
        for n, t in cache.items():
            if n != "len":
                full[n][:, :, :t.shape[2]] = t
        full["len"] = cache["len"]
        step, _ = TT.decode_step(tp, full, torch.tensor([[3], [9]]), tc, backend=backend)
        out[backend] = (logits, step)
    for got, want in zip(out["cuda"], out["ref"]):
        assert _rel(got, want, tc.vocab) <= TOL["float32"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """``loss`` (nll + AUX_COEF * the load-balance loss) and its gradient
    on ``ref``, fp32 compute: the loss within 1e-5, every gradient leaf
    within 1e-4 of its max|reference| (test_torch_lm_train.py's
    tolerances)."""
    jc, tc = _cfgs(arch)
    jb, tb = _tokens(jc, b=2, s=16)
    jp = _jax_params(arch)
    (jl, jm), jg = jax.value_and_grad(lambda p: JT.loss(p, jb, jc), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    live = tree_map(lambda t: t.requires_grad_(True), lm_params_from_numpy(jp, "cpu"))
    tl, tm = TT.loss(live, tb, tc, backend="ref")
    tg = torch.autograd.grad(tl, tree_leaves(live))
    assert float(jm["aux"]) > 0
    for k in ("nll", "aux"):
        assert _rel(tm[k], jm[k]) <= 1e-5
    assert _rel(tl, jl) <= 1e-5
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        assert g.shape == w.shape and _rel(g, w) <= 1e-4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_decode_matches_prefill(arch):
    """Token-by-token bf16 decode from an empty cache reproduces the
    prefill's last logits within 0.02 (capacity_factor 8: nothing drops),
    as tests/test_arch_smoke.py holds the JAX package."""
    _, tc = _cfgs(arch, "bfloat16", capacity_factor=8.0)
    tp = TT.init_transformer(torch.Generator().manual_seed(0), tc)
    _, tb = _tokens(tc, b=2, s=8)
    want, _ = TT.prefill(tp, tb, tc, backend="ref")
    cache = TT.init_cache(tc, 2, 12, "cpu")
    for i in range(8):
        got, cache = TT.decode_step(tp, cache, tb["tokens"][:, i:i + 1], tc, backend="ref")
    assert float((got - want).abs().max()) < 0.02


# ---------------------------------------------------------------------------
# params: bridge, compute_params, init at the param dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_and_cache_cross_with_their_leaves(arch):
    """Every leaf crosses by its path, the MoE's nested ``shared`` dict and
    MLA's latent projections included; the port inits the same tree."""
    jp = _jax_params(arch)
    tp = lm_params_from_numpy(jp, "cpu")
    jpaths, tpaths = tree_paths(jp), tree_paths(tp)
    assert sorted(jpaths) == sorted(tpaths)
    assert "layers/ffn/shared/w_gate" in tpaths and "layers/ffn/router" in tpaths
    for k, a in jpaths.items():
        assert np.array_equal(tpaths[k].numpy(), a), k
    mine = tree_paths(TT.init_transformer(torch.Generator().manual_seed(0),
                                          treg.get_smoke_config(arch)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: a.shape for k, a in jpaths.items()}
    jc = jreg.get_smoke_config(arch)
    jcache = _np(JT.init_cache(jc, 2, 8))
    tcache = lm_cache_from_numpy(dict(jcache, len=np.asarray(5, np.int32)), "cpu")
    assert tcache["len"] == 5
    for k, a in jcache.items():
        if k != "len":
            assert tuple(tcache[k].shape) == a.shape
    got = TT.init_cache(treg.get_smoke_config(arch), 2, 8, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items() if k != "len"} == \
        {k: a.shape for k, a in jcache.items() if k != "len"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_compute_params_is_the_per_call_cast(arch):
    """Nested dicts cast leaf by leaf; the router and MLA's norm scales keep
    f32; the logits are the per-call cast's, bit for bit.  bf16 weights
    under fp32 compute are not widened."""
    _, tc = _cfgs(arch, "bfloat16")
    tp = lm_params_from_numpy(_jax_params(arch), "cpu")
    cp = TT.compute_params(tp, tc)
    ffn, attn = cp["layers"]["ffn"], cp["layers"]["attn"]
    assert ffn["shared"]["w_down"].dtype == ffn["w_gate"].dtype == torch.bfloat16
    assert ffn["router"].dtype == torch.float32
    if "kv_norm" in attn:
        assert attn["kv_norm"].dtype == attn["q_norm"].dtype == torch.float32
    _, tb = _tokens(tc)
    assert torch.equal(TT.prefill(cp, tb, tc, backend="ref")[0],
                       TT.prefill(tp, tb, tc, backend="ref")[0])
    p16 = tree_map(lambda t: t.to(torch.bfloat16), tp)
    kept = TT.compute_params(p16, dataclasses.replace(tc, compute_dtype="float32"))
    assert all(a is b for a, b in zip(tree_leaves(kept), tree_leaves(p16)))


def test_init_at_param_dtype_casts_each_draw():
    """Each leaf cast as it is drawn gives the numbers of casting the fp32
    tree after init (the JAX package's make_init_state); without the
    keyword init is as before."""
    cfg = dataclasses.replace(treg.get_smoke_config("deepseek-v2-236b"),
                              param_dtype="bfloat16")
    full = TT.init_transformer(torch.Generator().manual_seed(3), cfg)
    assert {t.dtype for t in tree_leaves(full)} == {torch.float32}
    cast = TT.init_transformer(torch.Generator().manual_seed(3), cfg, at_param_dtype=True)
    want = tree_map(lambda t: t.to(torch.bfloat16), full)
    for a, b in zip(tree_leaves(cast), tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_episodic_backbone_over_moe_raises_naming_part_2():
    """The episodic LM backbone over MLA + MoE builds (it no longer raises)
    and its features, with a FiLM list and without, match
    ``repro.models.lm_backbone``'s on the JAX params in fp32 within 1e-5."""
    jc, tc = _cfgs("deepseek-v2-236b")
    jbb, tbb = j_lm_bb(jc), make_lm_backbone(tc)
    assert tbb.feature_dim == jbb.feature_dim and tuple(tbb.film_sites) == tuple(jbb.film_sites)
    jp = _jax_params("deepseek-v2-236b")
    tp = lm_params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab, size=(3, 12)).astype(np.int32)
    film = [{k: (0.1 * rng.standard_normal(jc.d_model)).astype(np.float32)
             for k in ("gamma", "beta")} for _ in range(jc.n_layers)]
    for f in (None, film):
        want = jbb.features(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks),
                            None if f is None else [tree_map(jnp.asarray, s) for s in f])
        got = tbb.features(tp, torch.from_numpy(toks).long(),
                           None if f is None else [tree_map(torch.from_numpy, s) for s in f])
        assert got.dtype == torch.float32 and _rel(got, want) <= TOL["float32"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_match_jax(arch):
    """Both engines on the same weights and prompts, fp32 compute, 2 slots:
    one stacked cohort and a ragged one; the tokens are equal request for
    request."""
    jc, tc = _cfgs(arch)
    jp = _jax_params(arch)
    prompts = [np.arange(6, dtype=np.int32) + 3 * i for i in range(2)] + \
        [np.arange(4 + 3 * i, dtype=np.int32) for i in range(2)]
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    JEngine(jc, jax.tree.map(jnp.asarray, jp), n_slots=2, max_seq=32).run_to_completion(jr)
    ServeEngine(tc, lm_params_from_numpy(jp, "cpu"), n_slots=2, max_seq=32,
                kernel_backend="ref").run_to_completion(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and len(r.out_tokens) == 5 for r in tr)


def test_engine_mla_cache_splice():
    """The MLA latent cache (ckv, krope) through the engine's splice and
    stacking (tests/test_serve.py's case, capacity_factor 8): every
    request completes, the stacked cohort's cache is the latent one, and
    the tokens are the JAX engine's."""
    jc, tc = _cfgs("deepseek-v2-236b", capacity_factor=8.0)
    jp = _np(j_get_api(jc).init(jax.random.key(1), jc))
    jr = [JRequest(uid=i, prompt=np.arange(4, dtype=np.int32) + i, max_new_tokens=4)
          for i in range(3)]
    tr = [Request(uid=i, prompt=np.arange(4, dtype=np.int32) + i, max_new_tokens=4)
          for i in range(3)]
    JEngine(jc, jax.tree.map(jnp.asarray, jp), n_slots=2, max_seq=48).run_to_completion(jr)
    eng = ServeEngine(tc, lm_params_from_numpy(jp, "cpu"), n_slots=2, max_seq=48)
    stacked = []
    step = eng.step

    def spy():
        n = step()
        if eng._stacked is not None:
            stacked.append({k: tuple(v.shape) for k, v in eng._stacked[1].items()
                            if k != "len"})
        return n

    eng.step = spy
    eng.run_to_completion(tr)
    assert all(r.done and len(r.out_tokens) == 4 for r in tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    a = tc.attention
    assert stacked and stacked[0] == {"ckv": (tc.n_layers, 2, 48, a.kv_lora_rank),
                                      "krope": (tc.n_layers, 2, 48, a.qk_rope_dim)}
    assert get_api(tc).init_cache(tc, 1, 48, "cpu").keys() == {"ckv", "krope", "len"}
