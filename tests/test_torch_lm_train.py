"""LM training of the port's dense transformers against the JAX package's,
on the CPU: ``loss`` (chunked cross-entropy, the rematerialisation
policies), ``make_train_step`` with fp32, bf16 and int8 AdamW state, the
non-finite skip, the in-place AdamW update and the token pipeline.

The same numpy tokens and the same weights (``bridge.lm_params_from_numpy``
/ ``lm_state_from_numpy``) go into both packages; the JAX side runs its
step jitted without a mesh.  Tolerances:

* fp32 compute (``compute_dtype`` replaced): the loss and nll within
  TOL_LOSS = 1e-5 relative; every gradient leaf within TOL_GRAD = 1e-4 of
  its max|reference| (measured: losses 9e-8, gradients 1.8e-6; sums in
  other orders);
* bf16 compute, gemma2-smoke: the loss within TOL_BF16 = 4e-2 relative
  (test_torch_lm_models.py's bf16 tolerance: eager PyTorch rounds every
  op's output to bf16 where XLA's fusions keep some in f32);
* three training steps at a constant lr of LR = 1e-3: loss, nll and
  grad_norm within 1e-5 relative, lr exact, and each parameter's update
  within UPDATE_TOL times LR of the JAX package's: 0.05 for fp32 and bf16
  state (measured 0.022: an element whose gradient is near 0 takes a
  normalised Adam step whose sign and size follow its rounding), 0.5 for
  int8 state (measured 0.13: the JAX package's log and exp differ from
  torch's by an ulp, which moves a few int8 levels of mu and nu);
* bit-equal: the in-place update against ``adamw_update`` after
  ``clip_by_global_norm``; the skipped step's params and state; the token
  batches; ``remat_policy`` "nothing" and "dots" against "none" on the
  port (a recompute runs the same arithmetic).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.data.tokens import TokenPipeline as JPipe
from repro.data.tokens import TokenPipelineConfig as JPipeCfg
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.train import step as JS
from repro_torch.bridge import lm_params_from_numpy, lm_state_from_numpy, lm_state_to_numpy
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import registry as treg
from repro_torch.data.tokens import (Prefetcher, TokenPipeline, TokenPipelineConfig,
                                     batch_to_device)
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw as TA
from repro_torch.optim.clip import clip_by_global_norm, clip_scale
from repro_torch.train import step as TS

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DENSE = ["minitron-4b", "gemma2-2b", "minicpm-2b", "qwen2-72b", "phi-3-vision-4.2b"]
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_BF16 = 4e-2
LR = 1e-3
UPDATE_TOL = {"float32": 0.05, "bfloat16": 0.05, "int8": 0.5}
SEQ = 48             # past gemma2-smoke's window of 32; 3 loss chunks of 16


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jreg.get_smoke_config(arch), compute_dtype=dtype, **kw),
            dataclasses.replace(treg.get_smoke_config(arch), compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, JT.init_transformer(jax.random.key(0),
                                                        jreg.get_smoke_config(arch)))


def _batch(cfg, seed=0, s=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(2, s)).astype(np.int32)
    jb, tb = dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(toks).long())
    if cfg.frontend is not None:
        fe = rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        jb["frontend_embeds"], tb["frontend_embeds"] = jnp.asarray(fe), torch.from_numpy(fe)
    return jb, tb


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_grads(tc, params_np, tb, backend="ref"):
    """(loss, metrics, gradients in leaf order) of the port's ``loss``."""
    live = tree_map(lambda t: t.detach().requires_grad_(True),
                    lm_params_from_numpy(params_np, "cpu"))
    loss, metrics = get_api(tc).loss(live, tb, tc, backend=backend)
    return loss, metrics, torch.autograd.grad(loss, tree_leaves(live))


def _jax_grads(jc, params_np, jb):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JT.loss(p, jb, jc), has_aux=True)(jax.tree.map(jnp.asarray, params_np))
    return loss, metrics, jax.tree.leaves(grads)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_jax(arch):
    """Each dense smoke config in fp32 compute (minicpm-2b's scales,
    qwen2-72b's QKV bias, phi-3-vision's prepended frontend positions,
    gemma2-2b's window and softcaps), through ``api.loss`` on both port
    backends (``cuda`` on CPU tensors: B5's plain version inside its
    autograd Function)."""
    jc, tc = _cfgs(arch)
    jb, tb = _batch(jc)
    jl, jm, jg = _jax_grads(jc, _jax_params(arch), jb)
    for backend in ("ref", "cuda"):
        tl, tm, tg = _port_grads(tc, _jax_params(arch), tb, backend)
        assert _rel(tl, jl) <= TOL_LOSS and _rel(tm["nll"], jm["nll"]) <= TOL_LOSS
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
        assert len(tg) == len(jg)
        for g, w in zip(tg, jg):
            assert g.shape == w.shape and _rel(g, w) <= TOL_GRAD


def test_loss_bf16_matches_jax():
    jc, tc = _cfgs("gemma2-2b", "bfloat16")
    jb, tb = _batch(jc)
    jl, jm = JT.loss(jax.tree.map(jnp.asarray, _jax_params("gemma2-2b")), jb, jc)
    with torch.no_grad():
        tl, tm = TT.loss(lm_params_from_numpy(_jax_params("gemma2-2b"), "cpu"), tb, tc)
    assert tl.dtype == torch.float32
    assert _rel(tl, jl) <= TOL_BF16 and _rel(tm["nll"], jm["nll"]) <= TOL_BF16


def test_xent_chunks_match_jax(monkeypatch):
    """``loss_chunk`` 16 (three chunks, each checkpointed while grad is on:
    its logits are computed again in the backward) and 0 (one pass)
    against the JAX package's with the same chunk; a chunk that does not
    divide S is one pass, as in the reference."""
    calls = []
    orig = TT._chunk_nll
    monkeypatch.setattr(TT, "_chunk_nll", lambda *a: calls.append(1) or orig(*a))
    losses = {}
    for chunk in (0, 16, 32):
        jc, tc = _cfgs("gemma2-2b", loss_chunk=chunk)
        jb, tb = _batch(jc)
        jl, _, jg = _jax_grads(jc, _jax_params("gemma2-2b"), jb)
        calls.clear()
        tl, _, tg = _port_grads(tc, _jax_params("gemma2-2b"), tb)
        assert len(calls) == (6 if chunk == 16 else 1)
        assert _rel(tl, jl) <= TOL_LOSS
        assert all(_rel(g, w) <= TOL_GRAD for g, w in zip(tg, jg))
        losses[chunk] = tl
    assert torch.equal(losses[0], losses[32])
    with torch.no_grad():
        calls.clear()
        _, tc = _cfgs("gemma2-2b", loss_chunk=16)
        TT.loss(lm_params_from_numpy(_jax_params("gemma2-2b"), "cpu"), _batch(tc)[1], tc)
        assert len(calls) == 3


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in TT._DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["none", "nothing", "dots"])
def test_remat_policies_match_jax(policy):
    """Each ``remat_policy`` against the JAX package's under the same
    policy, and bit-equal to the port's ``"none"``.  The backward's weight
    matmuls: ``"nothing"`` runs every forward one again, ``"dots"`` keeps
    their outputs and runs none again (the JAX package's
    ``dots_with_no_batch_dims_saveable``)."""
    jc, tc = _cfgs("minitron-4b", remat_policy=policy)
    jb, tb = _batch(jc)
    jl, _, jg = _jax_grads(jc, _jax_params("minitron-4b"), jb)
    counts = {}
    for c in (dataclasses.replace(tc, remat_policy="none"), tc):
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                        lm_params_from_numpy(_jax_params("minitron-4b"), "cpu"))
        fwd, bwd = _CountMM(), _CountMM()
        with fwd:
            loss, _ = TT.loss(live, tb, c, backend="cuda")
        with bwd:
            grads = torch.autograd.grad(loss, tree_leaves(live))
        counts[c.remat_policy] = (loss, grads, fwd.mm, bwd.mm)
    loss, grads, n_fwd, n_bwd = counts[policy]
    assert _rel(loss, jl) <= TOL_LOSS
    assert all(_rel(g, w) <= TOL_GRAD for g, w in zip(grads, jg))
    none = counts["none"]
    assert torch.equal(loss, none[0]) and all(map(torch.equal, grads, none[1]))
    assert n_fwd == none[2] and none[3] > 0
    if policy == "nothing":     # the recompute stops once it has what the backward needs
        assert none[3] < n_bwd <= none[3] + 7 * tc.n_layers    # q k v o gate up down
    else:
        assert n_bwd == none[3]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _states(arch, state_dtype):
    jc, tc = _cfgs(arch)
    jstate = JS.make_init_state(jc, JAdamW(state_dtype=state_dtype))(jax.random.key(0))
    return jc, tc, jstate, lm_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_train_step_matches_jax(state_dtype):
    jc, tc, jstate, tstate = _states("gemma2-2b", state_dtype)
    jstep = jax.jit(JS.make_train_step(jc, JAdamW(state_dtype=state_dtype),
                                       schedule=lambda c: LR))
    tstep = TS.make_train_step(tc, TA.AdamWConfig(state_dtype=state_dtype),
                               schedule=lambda c: torch.tensor(LR))
    pipe = TokenPipeline(TokenPipelineConfig(vocab=tc.vocab, seq_len=SEQ, global_batch=2))
    for s in range(3):
        b = pipe.batch_at(s)
        before = [p.clone() for p in tree_leaves(tstate["params"])]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        out, tm = tstep(tstate, batch_to_device(b, "cpu"))
        assert out is tstate          # updated in place
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr", "nll", "aux", "nonfinite"}
        for k in ("loss", "nll", "grad_norm"):
            assert _rel(tm[k], jm[k]) <= TOL_LOSS
        assert float(tm["lr"]) == float(jm["lr"]) and float(tm["nonfinite"]) == 0.0
        for p, o, w in zip(tree_leaves(tstate["params"]), before,
                           jax.tree.leaves(jstate["params"])):
            du = (p - o).numpy() - (np.asarray(w) - o.numpy())
            assert float(np.abs(du).max()) <= UPDATE_TOL[state_dtype] * LR
        assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"]) == s + 1


def test_eval_step_and_defaults_match_jax():
    """``make_eval_step``, ``adamw_for`` and the default cosine schedule
    (peak 3e-4, warmup 2000) against the JAX package's."""
    jc, tc, jstate, tstate = _states("minitron-4b", "float32")
    jb, tb = _batch(jc, seed=4)
    jm = JS.make_eval_step(jc)(jstate["params"], jb)
    tm = TS.make_eval_step(tc)(tstate["params"], tb)
    assert set(tm) == set(jm) and all(_rel(tm[k], jm[k]) <= TOL_LOSS for k in jm)
    assert dataclasses.asdict(TS.adamw_for(tc)) == dataclasses.asdict(JS.adamw_for(jc))
    _, jmet = jax.jit(JS.make_train_step(jc, JS.adamw_for(jc)))(jstate, jb)
    _, tmet = TS.make_train_step(tc, TS.adamw_for(tc))(tstate, tb)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_nonfinite_step_leaves_state_bit_identical(state_dtype):
    """A NaN in the inputs (phi-3-vision's frontend embeddings) makes every
    gradient NaN: params and AdamW state (``count`` included) come out
    bit-identical after a real step moved them, ``nonfinite`` is 1, as
    in the JAX package's step."""
    jc, tc, jstate, tstate = _states("phi-3-vision-4.2b", state_dtype)
    step = TS.make_train_step(tc, TA.AdamWConfig(state_dtype=state_dtype),
                              schedule=lambda c: torch.tensor(LR))
    jb, tb = _batch(tc, seed=1)
    _, m = step(tstate, tb)
    assert float(m["nonfinite"]) == 0.0
    snap = lm_state_to_numpy(tstate)
    bad = dict(tb, frontend_embeds=tb["frontend_embeds"].clone())
    bad["frontend_embeds"][0, 0, 0] = float("nan")
    _, m = step(tstate, bad)
    assert float(m["nonfinite"]) == 1.0 and not np.isfinite(float(m["loss"]))
    after = lm_state_to_numpy(tstate)
    for a, b in zip(jax.tree.leaves(snap), jax.tree.leaves(after)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    jbad = dict(jb, frontend_embeds=jnp.asarray(bad["frontend_embeds"].numpy()))
    _, jm = jax.jit(JS.make_train_step(jc, JAdamW(state_dtype=state_dtype)))(jstate, jbad)
    assert float(jm["nonfinite"]) == 1.0


# ---------------------------------------------------------------------------
# the in-place update
# ---------------------------------------------------------------------------

SHAPES = [(300, 16), (1000, 3), (7, 130), (3, 5, 64), (300,), (4, 3, 3, 3)]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_inplace_update_bit_equal(state_dtype, monkeypatch):
    """``adamw_update_`` with the clip's factor and the finiteness flag
    against ``clip_by_global_norm``, ``adamw_update`` and a per-leaf
    ``where``, bit for bit, over three steps and then a NaN gradient, with
    UPDATE_CHUNK small enough that the (300, 16) and (1000, 3) leaves go
    in slices of rows (the conv leaf and the vector whole)."""
    monkeypatch.setattr(TA, "UPDATE_CHUNK", 256)
    assert len(TA._row_slices(torch.zeros(300, 16))) == 19
    assert len(TA._row_slices(torch.zeros(1000, 3))) == 16
    cfg = TA.AdamWConfig(state_dtype=state_dtype)
    gen = torch.Generator().manual_seed(0)
    params = {f"p{i}": torch.randn(s, generator=gen) for i, s in enumerate(SHAPES)}
    ref = (params, TA.adamw_init(params, cfg))
    mine = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, ref)
    for s in range(4):
        grads = {k: torch.randn(p.shape, generator=gen) * 3 for k, p in params.items()}
        if s == 3:
            grads["p1"][5, 1] = float("nan")
        lr = torch.tensor(1e-2 * (s + 1))
        ok = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        clipped, _ = clip_by_global_norm(grads, 1.0)
        new_p, new_opt = TA.adamw_update(ref[0], clipped, ref[1], lr, cfg)
        pick = lambda n, o: torch.where(ok, n, o) if torch.is_tensor(n) else n  # noqa: E731
        ref = (tree_map(pick, new_p, ref[0]), tree_map(pick, new_opt, ref[1]))
        scale, _ = clip_scale(grads, 1.0)
        glist = tree_leaves(grads)
        TA.adamw_update_(mine[0], glist, mine[1], lr, cfg, grad_scale=scale, ok=ok)
        assert all(g is None for g in glist)
        for a, b in zip(tree_leaves(ref), tree_leaves(mine)):
            if torch.is_tensor(a):
                assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                          b.view(-1).view(torch.uint8))
            else:
                assert a == b
    assert int(mine[1]["count"]) == 3


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(), dict(vocab=8192, seq_len=64, global_batch=3,
                                              branching=2, seed=5)])
def test_token_pipeline_bit_equal_to_jax(cfg):
    tp, jp = TokenPipeline(TokenPipelineConfig(**cfg)), JPipe(JPipeCfg(**cfg))
    for s in (0, 1, 17):
        a, b = tp.batch_at(s), jp.batch_at(s)
        assert a.keys() == b.keys() and a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert np.array_equal(a["tokens"], b["tokens"])
    on = batch_to_device(tp.batch_at(2), "cpu")
    assert on["tokens"].dtype == torch.int64
    assert np.array_equal(on["tokens"].numpy(), jp.batch_at(2)["tokens"])
    it = iter(tp)
    pf = Prefetcher(iter(tp), depth=2, device="cpu")
    try:
        for _ in range(3):
            got, want = next(pf), next(it)
            assert got["tokens"].dtype == torch.int64
            assert np.array_equal(got["tokens"].numpy(), want["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_lm_state_bridge_round_trip():
    """An int8 LM train state crosses to the port and back leaf for leaf,
    bit for bit, ``n`` an int."""
    _, _, jstate, tstate = _states("minitron-4b", "int8")
    back = lm_state_to_numpy(tstate)
    want = jax.tree.map(np.asarray, jstate)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(tstate["opt"]["mu"]["embed"]["n"], int)
