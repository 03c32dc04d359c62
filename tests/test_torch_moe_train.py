"""Training through the port's MoE and MLA transformers against the JAX
package's, on the CPU: the gmm kernel's autograd Function
(``dispatch._GMM``), the pack's fixed-order backward, ``loss`` and its
gradient on the ``cuda`` backend, ``make_train_step`` with fp32 and the
published AdamW state dtypes, the remat policies through MoE, the episodic
LM backbone over MoE / MLA, the train state's bridge and checkpoints, and
the launcher.

Smoke configs (kimi-k2-smoke: GQA + MoE, 8 experts top-2, 1 shared;
deepseek-v2-smoke: MLA + MoE, 2 shared), fp32 compute.  Inputs are numpy
draws from a seed; the JAX package's params cross with ``bridge``.  The
``cuda`` backend on CPU tensors runs the kernels' plain versions inside
their autograd Functions, so B7's backward is two more grouped matmuls on
its plain version.  Tolerances:

* ``_GMM``: ``torch.autograd.gradcheck`` in fp64; dx and dw in fp32 within
  TOL_VJP = 1e-6 of the einsum's VJP, over each one's max (sums in other
  orders);
* the pack's backward: bit-equal to the JAX package's ``.at[slot].add``
  backward in fp32 and bf16 (both add a token's slots one at a time, in
  ascending expert id, onto zeros);
* ``loss`` within TOL_LOSS = 1e-5 relative, every gradient leaf within
  TOL_GRAD = 1e-4 of its max|reference|; three ``make_train_step`` steps:
  loss, nll, aux and grad_norm within 1e-5, each parameter's update within
  UPDATE_TOL x LR: 0.05 for fp32 and bf16 state (test_torch_lm_train.py's
  tolerance and reason), 1.0 for int8 state (measured 0.55 on
  kimi-k2-smoke, against 0.13 on the dense gemma2-smoke: an expert's rows
  see few tokens, so more of its elements carry small moments, on which
  the two packages' log and exp, an ulp apart, move a few int8 levels).
  Also with int8 state, an element whose second moment the log-domain
  state holds at its floor (dequantized to 0 after the step: every
  gradient it has seen under about 1e-6) while its first moment is not 0
  takes AdamW's step m / eps, which turns a difference in the 7th digit of
  m into tens of LR in both packages (measured 45 LR).  Those elements
  (measured 1.1 % of the parameters a step, bound at 2 %) are left out of
  the update bound;
* the episodic learners: test_torch_episodic_lm.py's 1e-5 / 1e-4;
* bit-equal: the remat policies against ``"none"``, the in-place AdamW
  update against ``adamw_update``, the bridge's round trips, the
  checkpoints both ways.

Whole-model bf16 parity against the JAX package is left out on purpose: a
routing whose k-th and (k+1)-th router probabilities nearly tie can flip
between the two packages' bf16 roundings, and a flipped expert moves that
token's output by a whole expert's share, beyond any rounding tolerance
(test_torch_moe_mla.py's reason).  bf16 training is held on the card
against an fp32-compute run (``chip_smoke.py`` phase 5e).
"""
import dataclasses
import functools
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import _index_scores
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.data.episodic import EpisodicTokenConfig as JTokCfg
from repro.data.episodic import sample_token_task as j_sample
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.lm_backbone import make_lm_backbone as j_lm_bb
from repro.optim import AdamWConfig as JAdamW
from repro.train import step as JS
from repro.train.checkpoint import CheckpointManager as JCkpt
from repro_torch.bridge import (learner_params_from_numpy, lm_params_from_numpy,
                                lm_state_from_numpy, lm_state_to_numpy)
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.configs import registry as treg
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import make_reached_meta_grads
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig, batch_to_device
from repro_torch.kernels import dispatch
from repro_torch.kernels import gmm as tgm
from repro_torch.models import moe as M
from repro_torch.models import transformer as TT
from repro_torch.models.lm_backbone import make_lm_backbone
from repro_torch.optim import adamw as TA
from repro_torch.optim.clip import clip_by_global_norm, clip_scale
from repro_torch.optim.quant import dequantize, dequantize_log
from repro_torch.train import step as TS
from repro_torch.train.checkpoint import CheckpointManager

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

MOE_ARCHS = ["kimi-k2-1t-a32b", "deepseek-v2-236b"]
PUBLISHED_STATE = {"kimi-k2-1t-a32b": "int8", "deepseek-v2-236b": "bfloat16"}
TOL_VJP = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
LR = 1e-3
UPDATE_TOL = {"float32": 0.05, "bfloat16": 0.05, "int8": 1.0}
SEQ = 16
TASK = dict(way=4, shot=6, query_per_class=4, seq_len=32, concentration=1.0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch, dtype="float32", remat=None, **moe):
    kw = dict(compute_dtype=dtype) | ({} if remat is None else dict(remat_policy=remat))
    jc = dataclasses.replace(jreg.get_smoke_config(arch), **kw)
    tc = dataclasses.replace(treg.get_smoke_config(arch), **kw)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if torch.is_tensor(want) else \
        np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, JT.init_transformer(jax.random.key(0),
                                                        jreg.get_smoke_config(arch)))


def _batch(cfg, seed=0, s=SEQ):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(2, s)).astype(np.int32)
    return dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(toks).long())


class _Products:
    """Counts what ``dispatch._GMM``'s backward computes (dx, dw) and the
    gmm wrapper's calls, forward and backward alike."""

    def __init__(self, monkeypatch):
        self.dx = self.dw = self.calls = 0
        backward, wrapper = dispatch._GMM.backward, tgm.gmm

        def counted_backward(ctx, g):
            dx, dw = backward(ctx, g)
            self.dx += dx is not None
            self.dw += dw is not None
            return dx, dw

        def counted_wrapper(x, w):
            self.calls += 1
            return wrapper(x, w)

        monkeypatch.setattr(dispatch._GMM, "backward", staticmethod(counted_backward))
        monkeypatch.setattr(tgm, "gmm", counted_wrapper)


# ---------------------------------------------------------------------------
# B7's autograd Function
# ---------------------------------------------------------------------------

def test_gmm_function_gradcheck():
    """``dispatch.gmm`` on ``cuda`` with CPU tensors (the Function around
    the kernel's plain version) in fp64, with both operands and with each
    one alone requiring grad."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 12, generator=g, dtype=torch.float64)
    w = torch.randn(3, 12, 8, generator=g, dtype=torch.float64)
    for need in ((True, True), (True, False), (False, True)):
        ins = [t.clone().requires_grad_(n) for t, n in zip((x, w), need)]
        assert torch.autograd.gradcheck(lambda a, b: dispatch.gmm(a, b, backend="cuda"),
                                        tuple(ins))


@pytest.mark.parametrize("c", [16, 200], ids=["C16", "C200"])
def test_gmm_function_matches_einsum_vjp(c, monkeypatch):
    """dx = g w^T and dw = x^T g in fp32 against the VJP of the reference's
    einsum, at a capacity of 16 and at deepseek-v2's 200 (dw's K, not a
    multiple of the kernel's 64-deep slab); a weight that needs no
    gradient gets no dw product, and the wrapper is called once more for
    each product."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, c, 24, generator=g)
    w = torch.randn(3, 24, 40, generator=g)
    dout = torch.randn(3, c, 40, generator=g)
    want = torch.autograd.grad(torch.einsum("ecd,edf->ecf", x.requires_grad_(True),
                                            w.requires_grad_(True)), (x, w), dout)
    count = _Products(monkeypatch)
    xs, ws = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    out = dispatch.gmm(xs, ws, backend="cuda")
    got = torch.autograd.grad(out, (xs, ws), dout)
    assert (count.calls, count.dx, count.dw) == (3, 1, 1)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _rel(a, b) <= TOL_VJP
    frozen = w.detach()
    out = dispatch.gmm(xs, frozen, backend="cuda")
    dx, = torch.autograd.grad(out, (xs,), dout)
    assert (count.calls, count.dx, count.dw) == (5, 2, 1)
    assert _rel(dx, want[0]) <= TOL_VJP


def test_gmm_backward_reads_views_and_matches_jax_grad(monkeypatch):
    """``_GMM.backward`` hands the gmm wrapper w^T and x^T as transposed
    views of the saved w and x (non-contiguous, on their storage: no copy),
    and dx, dw on those views match ``jax.grad`` of the JAX package's
    ``ref.gmm_ref`` at E 3, C 40, D 64, F 48 within TOL_VJP."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    e, c, d, f = 3, 40, 64, 48
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    g = rng.standard_normal((e, c, f)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jref.gmm_ref(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    seen, wrapper = [], tgm.gmm
    monkeypatch.setattr(tgm, "gmm", lambda a, b: seen.append((a, b)) or wrapper(a, b))
    xs, ws = (torch.from_numpy(t).requires_grad_(True) for t in (x, w))
    got = torch.autograd.grad(dispatch.gmm(xs, ws, backend="cuda"), (xs, ws),
                              torch.from_numpy(g))
    (fx, fw), (g_dx, wt), (xt, g_dw) = seen
    assert fx.is_contiguous() and fw.is_contiguous()
    assert g_dx.is_contiguous() and g_dw.is_contiguous()
    for view, stored, shape in ((wt, ws, (e, f, d)), (xt, xs, (e, d, c))):
        assert tuple(view.shape) == shape and not view.is_contiguous()
        assert view.transpose(1, 2).is_contiguous()
        assert view.data_ptr() == stored.data_ptr()       # the saved tensor itself
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _rel(a, b) <= TOL_VJP


# ---------------------------------------------------------------------------
# the MoE layer's pack and combine
# ---------------------------------------------------------------------------

def _pack_case(dtype, monkeypatch):
    """The pack's inputs of one ``moe_ffn`` call (kimi-k2-smoke's layer at
    top-4 and capacity_factor 0.5, 40 tokens: slots drop) and the same
    layer's JAX config and params."""
    jc, tc = _cfgs("kimi-k2-1t-a32b", dtype, top_k=4, capacity_factor=0.5)
    jp = jax.tree.map(np.asarray, JM.init_moe(jax.random.key(3), jc.d_model, jc.moe))
    x = np.random.default_rng(1).standard_normal((40, jc.d_model)).astype(np.float32)
    seen = []
    apply = M._Pack.apply
    monkeypatch.setattr(M._Pack, "apply", lambda *a: seen.append(a) or apply(*a))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    M.moe_ffn(lm_params_from_numpy(jp, "cpu"), tx, tc.moe, backend="cuda")
    return jc, jp, x, seen[0], apply


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_backward_matches_jax_scatter(dtype, monkeypatch):
    """The pack's fixed-order backward against the JAX package's: the
    transpose of its gather ``x[tok_sorted]`` and of its ``.at[slot].add``
    into the capacity buffer, on the same routing, bit for bit; a token
    whose every slot was dropped gets exactly 0 through the pack, though
    the gradient at the slot its dropped assignments clamp to is not 0."""
    jc, jp, x, (tx, rows, filled, slot, keep, pos), apply = _pack_case(dtype, monkeypatch)
    e, c = filled.shape[:2]
    t, k = pos.shape
    gbuf = np.random.default_rng(2).standard_normal((e, c, jc.d_model)).astype(np.float32)
    xs = tx.detach().requires_grad_(True)
    buf = apply(xs, rows, filled, slot, keep, pos)
    dx, = torch.autograd.grad(buf, xs, torch.from_numpy(gbuf).to(xs.dtype))

    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x, jdt)
    _, ids, _ = JM.router_probs(jp, jx, jc.moe)
    flat = ids.reshape(-1)
    order = jnp.argsort(flat)
    counts = jnp.zeros((e,), jnp.int32).at[flat].add(1)
    rank = jnp.arange(t * k) - (jnp.cumsum(counts) - counts)[flat[order]]
    jslot = flat[order] * c + jnp.minimum(rank, c - 1)
    tok = jnp.repeat(jnp.arange(t), k)[order]

    def pack(v):   # the reference's pack, moe.py:100-104
        contrib = jnp.where((rank < c)[:, None], v[tok], 0).astype(v.dtype)
        return jnp.zeros((e * c, jc.d_model), v.dtype).at[jslot].add(
            contrib, mode="drop").reshape(e, c, jc.d_model)

    jbuf, vjp = jax.vjp(pack, jx)
    jdx, = vjp(jnp.asarray(gbuf, jdt))
    assert np.array_equal(buf.detach().float().numpy(), np.asarray(jbuf, np.float32))
    assert np.array_equal(dx.float().numpy(), np.asarray(jdx, np.float32))
    gone = [i for i in range(t) if not bool(keep[pos[i]].any())]
    assert gone, "the case must drop every slot of some token"
    assert not dx[gone].any()
    assert all(gbuf.reshape(e * c, -1)[int(slot[p])].any() for i in gone for p in pos[i])


def test_dropped_slots_get_exactly_zero_gradient(monkeypatch):
    """At capacity_factor 0.5, through ``loss`` on ``cuda``: a dropped
    assignment (clamped to slot c - 1 with weight 0) gives its router
    weight exactly 0 gradient; the kept ones do not, but at the last
    position of a sequence, which no unmasked label reads."""
    _, tc = _cfgs("kimi-k2-1t-a32b", capacity_factor=0.5)
    router = M.router_probs
    held = []

    def keep_weights(p, x, cfg):
        w, ids, probs = router(p, x, cfg)
        w.retain_grad()
        held.append((w, ids))
        return w, ids, probs

    monkeypatch.setattr(M, "router_probs", keep_weights)
    live = tree_map(lambda t: t.requires_grad_(True),
                    lm_params_from_numpy(_jax_params("kimi-k2-1t-a32b"), "cpu"))
    loss, _ = TT.loss(live, _batch(tc)[1], tc, backend="cuda")
    loss.backward()
    dropped = 0
    for w, ids in held:
        t, k = ids.shape
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=tc.moe.n_experts)
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(t * k) - (torch.cumsum(counts, 0) - counts)[flat[order]]
        drop = (rank >= M.capacity(t, tc.moe)).reshape(t, k)
        dropped += int(drop.sum())
        read = (torch.arange(t) % SEQ != SEQ - 1)[:, None]
        assert torch.all(w.grad[drop] == 0) and bool((w.grad[~drop & read] != 0).all())
    assert dropped > 0


# ---------------------------------------------------------------------------
# loss and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [None, 0.5], ids=["cf-smoke", "cf0.5"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_on_cuda_backend_match_jax(arch, cf, monkeypatch):
    """``loss`` and every gradient leaf on ``cuda`` (B7's Function on its
    plain version, the pack's backward; flash attention's Function for
    kimi-k2's GQA) against the JAX package's; every expert projection
    differentiates x and w."""
    moe = {} if cf is None else dict(capacity_factor=cf)
    jc, tc = _cfgs(arch, **moe)
    jb, tb = _batch(jc)
    jp = _jax_params(arch)
    (jl, jm), jg = jax.value_and_grad(lambda p: JT.loss(p, jb, jc), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    count = _Products(monkeypatch)
    live = tree_map(lambda t: t.requires_grad_(True), lm_params_from_numpy(jp, "cpu"))
    tl, tm = TT.loss(live, tb, tc, backend="cuda")
    tg = torch.autograd.grad(tl, tree_leaves(live))
    assert count.dx == count.dw == 3 * tc.n_layers
    assert _rel(tl, jl) <= TOL_LOSS
    for k in ("nll", "aux"):
        assert _rel(tm[k], jm[k]) <= TOL_LOSS
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg):
        assert _rel(g, w) <= TOL_GRAD


def _states(arch, state_dtype):
    jc, tc = _cfgs(arch)
    jstate = JS.make_init_state(jc, JAdamW(state_dtype=state_dtype))(jax.random.key(0))
    return jc, tc, jstate, lm_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


def _eps_steps(jstate, state_dtype):
    """Per parameter leaf, where the JAX package's step was m / eps: its
    int8 state's second moment after the step dequantizes to 0 and its
    first moment does not (nowhere for the other state dtypes)."""
    if state_dtype != "int8":
        return [np.zeros(np.shape(p), bool) for p in jax.tree.leaves(jstate["params"])]
    moments = [jax.tree.leaves(jstate["opt"][k], is_leaf=lambda x: isinstance(x, dict)
                               and "q" in x) for k in ("mu", "nu")]
    read = lambda v, f: np.asarray(f(dict(q=torch.tensor(np.asarray(v["q"])),  # noqa: E731
                                          scale=torch.tensor(np.asarray(v["scale"]))),
                                     int(np.shape(v["q"])[-1])))
    return [(read(nu, dequantize_log) == 0) & (read(mu, dequantize) != 0)
            for mu, nu in zip(*moments)]


@pytest.mark.parametrize("state", ["float32", "published"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_jax(arch, state):
    """Three ``make_train_step`` steps on ``cuda`` against the JAX package's
    jitted ``train_step`` without a mesh, with fp32 AdamW state and with
    the arch's published one (kimi-k2 int8, deepseek-v2 bf16)."""
    state_dtype = PUBLISHED_STATE[arch] if state == "published" else "float32"
    jc, tc, jstate, tstate = _states(arch, state_dtype)
    jstep = jax.jit(JS.make_train_step(jc, JAdamW(state_dtype=state_dtype),
                                       schedule=lambda c: LR))
    tstep = TS.make_train_step(tc, TA.AdamWConfig(state_dtype=state_dtype),
                               schedule=lambda c: torch.tensor(LR))
    pipe = TokenPipeline(TokenPipelineConfig(vocab=tc.vocab, seq_len=SEQ, global_batch=2))
    eps_steps = 0
    for s in range(3):
        b = pipe.batch_at(s)
        before = [p.clone() for p in tree_leaves(tstate["params"])]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        with dispatch.use_backend("cuda"):
            out, tm = tstep(tstate, batch_to_device(b, "cpu"))
        assert out is tstate
        for k in ("loss", "nll", "grad_norm", "aux"):
            assert _rel(tm[k], jm[k]) <= TOL_LOSS
        assert float(tm["nonfinite"]) == 0.0
        for p, o, w, f in zip(tree_leaves(tstate["params"]), before,
                              jax.tree.leaves(jstate["params"]),
                              _eps_steps(jstate, state_dtype)):
            du = np.abs((p - o).numpy() - (np.asarray(w) - o.numpy()))
            assert float(np.where(f, 0.0, du).max()) <= UPDATE_TOL[state_dtype] * LR
            eps_steps += int(f.sum())
    assert eps_steps <= 0.02 * 3 * sum(p.numel() for p in tree_leaves(tstate["params"]))
    back = jax.tree.map(np.asarray, lm_state_to_numpy(tstate))
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("policy", ["none", "nothing", "dots"])
def test_remat_policies_through_moe(policy, monkeypatch):
    """deepseek-v2-smoke (MLA + MoE) under each ``remat_policy`` on
    ``cuda``: the loss and gradient against the JAX package's under the
    same policy, bit-equal to the port's ``"none"``.  B7's wrapper calls in
    the backward: the dx and dw products of every projection, and under
    ``"nothing"`` and ``"dots"`` the three projections' recompute too
    (``"dots"`` keeps only the outputs of matmuls without a batch dim,
    and an expert projection has one, as in the JAX package)."""
    jc, tc = _cfgs("deepseek-v2-236b", remat=policy)
    jb, tb = _batch(jc)
    jp = _jax_params("deepseek-v2-236b")
    (jl, _), jg = jax.value_and_grad(lambda p: JT.loss(p, jb, jc), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    count = _Products(monkeypatch)
    runs = {}
    for c in (dataclasses.replace(tc, remat_policy="none"), tc):
        live = tree_map(lambda t: t.requires_grad_(True), lm_params_from_numpy(jp, "cpu"))
        loss, _ = TT.loss(live, tb, c, backend="cuda")
        before = count.calls
        grads = torch.autograd.grad(loss, tree_leaves(live))
        runs[c.remat_policy] = (loss, grads, count.calls - before)
    loss, grads, bwd_calls = runs[policy]
    n = tc.n_layers
    assert bwd_calls == (6 * n if policy == "none" else 9 * n)
    assert _rel(loss, jl) <= TOL_LOSS
    assert all(_rel(g, w) <= TOL_GRAD for g, w in zip(grads, jax.tree.leaves(jg)))
    assert torch.equal(loss, runs["none"][0])
    assert all(map(torch.equal, grads, runs["none"][1]))


def test_inplace_update_of_an_moe_state_is_bit_equal(monkeypatch):
    """``adamw_update_`` on deepseek-v2-smoke's tree (the nested ``shared``
    dict, the (L, E, D, F) expert leaves) with int8 state and
    UPDATE_CHUNK small enough that the expert leaves go in blocks of one
    layer and a few experts, against ``adamw_update`` after the clip, bit
    for bit; the int8 moments keep the JAX package's layout (quantized
    along F), and a (1, 160, 5120, 1536) leaf goes in blocks within
    UPDATE_CHUNK that cover it once."""
    cfg = TA.AdamWConfig(state_dtype="int8")
    params = lm_params_from_numpy(_jax_params("deepseek-v2-236b"), "cpu")
    w = params["layers"]["ffn"]["w_gate"]                           # (2, 8, 64, 64)
    monkeypatch.setattr(TA, "UPDATE_CHUNK", 4096)
    assert TA._row_slices(w) == [(i, slice(j, j + 1)) for i in range(2) for j in range(8)]
    ref = (params, TA.adamw_init(params, cfg))
    mine = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, ref)
    assert tuple(ref[1]["mu"]["layers"]["ffn"]["w_gate"]["q"].shape) == tuple(w.shape)
    gen = torch.Generator().manual_seed(0)
    for s in range(2):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
        lr = torch.tensor(1e-2 * (s + 1))
        clipped, _ = clip_by_global_norm(grads, 1.0)
        ref = TA.adamw_update(ref[0], clipped, ref[1], lr, cfg)
        scale, _ = clip_scale(grads, 1.0)
        TA.adamw_update_(mine[0], tree_leaves(grads), mine[1], lr, cfg, grad_scale=scale)
        for a, b in zip(tree_leaves(ref), tree_leaves(mine)):
            assert a == b if not torch.is_tensor(a) else torch.equal(a, b)
    monkeypatch.undo()
    big = torch.empty(1, 160, 5120, 1536, device="meta")
    blocks = TA._row_slices(big)
    sizes = [big[b].numel() for b in blocks]
    assert max(sizes) <= TA.UPDATE_CHUNK and sum(sizes) == big.numel()
    assert blocks == [(0, slice(j, j + 2)) for j in range(0, 160, 2)]


# ---------------------------------------------------------------------------
# the episodic LM backbone over MoE and MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_episodic_backbone_over_moe_matches_jax(arch, kind, monkeypatch):
    """LITE (h 6) meta-loss, accuracy and every leaf's gradient of ProtoNets
    (the backbone trained: B7's dw is reached) and Simple CNAPs (the
    backbone frozen: no dw product at all, dx only) over the MoE smoke
    configs, on ``cuda``, against ``repro.models.lm_backbone``'s learners
    on the JAX package's task, H scores and params."""
    jc, tc = _cfgs(arch)
    set_kw = dict(kind="tokens", task_dim=32, in_channels=jc.vocab)
    jl = j_make(JCfg(kind=kind, way=TASK["way"]), j_lm_bb(jc), JSetCfg(**set_kw))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=TASK["way"]), make_lm_backbone(tc),
                      SetEncoderConfig(**set_kw))
    task = j_sample(jax.random.key(3), JTokCfg(vocab=jc.vocab, **TASK))
    jp = jl.init(jax.random.key(1))
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jl.meta_loss(p, task, jax.random.key(0), JLite(h=6)), has_aux=True))(jp)
    arrays = [np.asarray(getattr(task, k)) for k in ("support_x", "support_y", "query_x",
                                                      "query_y")]
    ones = lambda y: np.ones((1,) + y.shape, np.float32)  # noqa: E731
    tb = TaskBatch(*(a[None] for a in arrays), support_mask=ones(arrays[1]),
                   query_mask=ones(arrays[3]), way=TASK["way"]).to("cpu")
    scores = torch.from_numpy(np.array(_index_scores(jax.random.key(0),
                                                     tb.support_y.shape[1])))[None]
    tp = learner_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    count = _Products(monkeypatch)
    with dispatch.use_backend("cuda"):
        loss, acc, grads = make_reached_meta_grads(tl, LiteSpec(h=6))(tp, tb, scores)
    assert abs(float(loss) - float(jloss)) <= TOL_LOSS * abs(float(jloss))
    assert float(acc) == pytest.approx(float(jaux["accuracy"]), abs=1e-6)
    jg = tree_paths(jax.tree.map(np.asarray, jg))
    for k, g in zip(tree_paths(tp), grads):
        if g is None:
            assert float(np.abs(jg[k]).max()) == 0.0, f"{k}: reached in the reference"
        else:
            assert _rel(g, jg[k]) <= TOL_GRAD, k
    assert count.dx > 0
    assert (count.dw > 0) == (kind == "protonets")
    if kind == "simple_cnaps":
        assert all(g is None for k, g in zip(tree_paths(tp), grads) if k.startswith("bb/"))


def test_backbone_draws_the_trunk_at_its_param_dtype():
    """The episodic backbone's trunk in the config's ``param_dtype``, each
    leaf cast as it is drawn (deepseek-v2 publishes bf16 params): the
    numbers of casting the fp32 draw."""
    cfg = dataclasses.replace(treg.get_smoke_config("deepseek-v2-236b"),
                              param_dtype="bfloat16")
    got = make_lm_backbone(cfg).init(torch.Generator().manual_seed(2))
    want = TT.init_transformer(torch.Generator().manual_seed(2), cfg)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the train state across packages, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_state_crosses_both_ways(arch, tmp_path):
    """A JAX MoE / MLA train state with the arch's published AdamW state
    (kimi-k2 int8 ``{q, scale, n}``, deepseek-v2 bf16) crosses to the port
    and back bit for bit; the port's own ``make_init_state`` builds the
    same tree of the same shapes and dtypes; and a port checkpoint of it
    restores in the JAX package's manager, and back, bit for bit (the
    expert leaves are not conv weights: no layout change)."""
    state_dtype = PUBLISHED_STATE[arch]
    jc, tc, jstate, tstate = _states(arch, state_dtype)
    want = jax.tree.map(np.asarray, jstate)
    back = lm_state_to_numpy(tstate)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    mine = TS.make_init_state(tc, TA.AdamWConfig(state_dtype=state_dtype))(
        torch.Generator().manual_seed(0), "cpu")
    shapes = lambda tree: {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))  # noqa: E731
                           for k, v in tree_paths(tree).items()}
    assert shapes(lm_state_to_numpy(mine)) == shapes(want)
    assert isinstance(tstate["opt"]["mu"]["layers"]["ffn"]["w_gate"], dict) == \
        (state_dtype == "int8")

    CheckpointManager(tmp_path / "port", keep=1).save(3, tstate)
    step, restored, _ = JCkpt(tmp_path / "port").restore_latest(
        jax.eval_shape(JS.make_init_state(jc, JAdamW(state_dtype=state_dtype)),
                       jax.random.key(0)))
    assert step == 3
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, restored)),
                    jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    JCkpt(tmp_path / "jax", keep=1).save(4, jstate)
    step, again, _ = CheckpointManager(tmp_path / "jax").restore_latest(mine)
    assert step == 4
    again, tstate = tree_paths(again), tree_paths(tstate)
    assert again.keys() == tstate.keys()
    for k, a in again.items():
        assert a == tstate[k] if not torch.is_tensor(a) else torch.equal(a, tstate[k])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_trains_moe_on_cpu(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <MoE arch> --device
    cpu``: three steps through the loop with checkpoints, exit 0; a rerun
    on the same directory has nothing to do."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
           arch, "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-every", "3",
           "--ckpt-dir", str(tmp_path)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"arch={treg.get_smoke_config(arch).name}" in out.stdout
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("done at step 3") and "device=cpu" in line
    loss = [float(x) for x in line.split("loss ")[1].split(";")[0].split(" -> ")]
    assert all(math.isfinite(x) for x in loss)
    again = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert again.returncode == 0 and "nothing to do" in again.stdout
