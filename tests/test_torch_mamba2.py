"""The port's Mamba-2 LM against the JAX package's, on the CPU: the SSD
core (``ssd_chunked`` on both backends, S a multiple of the chunk and
ragged, with and without an initial state), the causal conv, the mixer and
its states, ``prefill`` and ``decode_step`` chained, ``loss`` and every
gradient leaf, one ``make_train_step`` step against the JAX package's step
jitted without a mesh, the serving engine token for token, the episodic
backbone's features, ssd_chunk's autograd Function (``dispatch._SSDChunk``)
and the launchers and examples.

Smoke config mamba2-smoke (2 layers, d_model 64, 8 SSD heads of 16, state
16, chunks of 32, vocab 256).  Inputs are numpy draws from a seed; the JAX
package's params cross with ``bridge.lm_params_from_numpy``.  The ``cuda``
backend on CPU tensors runs the ssd_chunk kernel's plain version over the
G = b * nc * h flattened chunks, inside its autograd Function where grad
is on: that checks the flattening and the Function's backward formula
here; the kernel itself is checked on the card (``chip_smoke.py`` phases
6d and 5f).  Tolerances, each over the reference's max|.|:

* fp32 compute: TOL = 1e-4 (measured: logits 3e-7, caches 5e-7, gradient
  leaves 3.6e-6; sums in other orders);
* bf16 compute: TOL_BF16 = 5e-2, the SSM families' tolerance of
  tests/test_arch_smoke.py:91 (measured: logits 7.9e-3, the fp32 SSM state
  2.3e-2: eager PyTorch rounds every op's output to bf16 where XLA's
  fusions keep some in f32);
* ``make_train_step``: loss and grad_norm within TOL, each parameter's
  update within 0.05 x LR (test_torch_lm_train.py's bound and reason);
* the Function's backward: within TOL of autograd through the reference's
  einsums (the plain version computes in fp32 whatever it is given, so
  no fp64 finite differences).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba2 as JM
from repro.models.registry import get_api as j_get_api
from repro.optim import AdamWConfig as JAdamW
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import step as JS
from repro_torch.bridge import lm_params_from_numpy, lm_state_from_numpy
from repro_torch.common.tree import tree_leaves, tree_paths, tree_rebuild
from repro_torch.configs import registry as treg
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig, batch_to_device
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import ssd_scan
from repro_torch.models import mamba2 as TM
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw as TA
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import step as TS

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "mamba2-780m"
TOL = 1e-4
TOL_BF16 = 5e-2
TOLS = {"float32": TOL, "bfloat16": TOL_BF16}
BACKENDS = ["ref", "cuda"]
LR = 1e-3


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jreg.get_smoke_config(ARCH), compute_dtype=dtype),
            dataclasses.replace(treg.get_smoke_config(ARCH), compute_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _models(dtype="float32"):
    jc, tc = _cfgs(dtype)
    jp = JM.init_mamba2(jax.random.key(0), jc)
    return jc, jp, tc, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------

def _ssd_inputs(s, seed, h=4, p=8, n=16, b=2):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, (h,)).astype(np.float32)
    return [f(b, s, h, p), dt, A, f(b, s, h, n), f(b, s, h, n), f(b, h, p, n)]


@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "init-state"])
@pytest.mark.parametrize("s", [64, 50], ids=["S-multiple", "S-ragged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_ssd_chunked_matches_jax(backend, s, init):
    *args, s0 = _ssd_inputs(s, seed=s + init)
    jy, jst = JM.ssd_chunked(*map(jnp.asarray, args), 16,
                             init_state=jnp.asarray(s0) if init else None)
    ty, tst = TM.ssd_chunked(*map(torch.from_numpy, args), 16,
                             init_state=torch.from_numpy(s0) if init else None,
                             backend=backend)
    assert ty.dtype == torch.float32 and tst.dtype == torch.float32
    assert _rel(ty, jy) <= TOL and _rel(tst, jst) <= TOL


def test_ssd_chunked_bf16_input_rounds_y():
    """y leaves in x's dtype (bf16), the state in fp32, on both backends."""
    x, dt, A, B, C, _ = _ssd_inputs(40, seed=7)
    jy, jst = JM.ssd_chunked(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (dt, A, B, C)),
                             16)
    for backend in BACKENDS:
        ty, tst = TM.ssd_chunked(torch.from_numpy(x).bfloat16(),
                                 *map(torch.from_numpy, (dt, A, B, C)), 16, backend=backend)
        assert ty.dtype == torch.bfloat16 and tst.dtype == torch.float32
        assert _rel(ty, jy) <= TOL_BF16 and _rel(tst, jst) <= TOL_BF16


def test_cuda_backend_flattens_every_chunk_into_one_kernel_call(monkeypatch):
    """On ``cuda`` the intra-chunk terms of every chunk go through one
    ``dispatch.ssd_chunk`` call, (b, nc, h) flattened into G in that order,
    in fp32; the zero-padded tail is a chunk of its own."""
    calls = []
    orig = td.ssd_chunk

    def rec(x, dt, A, B, C, backend=None):
        calls.append((tuple(x.shape), tuple(B.shape), x.dtype, backend))
        return orig(x, dt, A, B, C, backend)

    monkeypatch.setattr(td, "ssd_chunk", rec)
    x, dt, A, B, C, _ = _ssd_inputs(50, seed=3)
    TM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), 16, backend="cuda")
    assert calls == [((2 * 4 * 4, 16, 8), (2 * 4 * 4, 16, 16), torch.float32, "cuda")]
    calls.clear()
    TM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), 16, backend="ref")
    assert calls == []


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 9, 12), (12, 4), (12,)))
    want = JM._causal_conv(*map(jnp.asarray, (x, w, b)))
    got = TM._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert _rel(got, want) <= 1e-6


def test_segsum_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 7)).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(x)))
    got = TM._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5


# ---------------------------------------------------------------------------
# the mixer, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_and_states_match_jax(dtype, backend):
    """``mamba_mixer(want_state=True)``: the output, the conv state (the last
    k-1 inputs of the conv, before it) and the fp32 SSM state."""
    jc, jp, tc, tp = _models(dtype)
    x = np.random.default_rng(6).standard_normal((2, 45, jc.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = {k: v[0] for k, v in TM.compute_params(tp, tc)["layers"].items()}
    dt = getattr(jnp, dtype)
    jo, (jconv, jssm) = JM.mamba_mixer(jl, jnp.asarray(x, dt), jc, want_state=True)
    to, (tconv, tssm) = TM.mamba_mixer(tl, torch.from_numpy(x).to(getattr(torch, dtype)), tc,
                                       want_state=True, backend=backend)
    assert to.dtype == tconv.dtype == getattr(torch, dtype) and tssm.dtype == torch.float32
    assert tuple(tconv.shape) == (2, TM.conv_dim(tc), tc.ssm.d_conv - 1)
    for got, want in ((to, jo), (tconv, jconv), (tssm, jssm)):
        assert _rel(got, want) <= TOLS[dtype]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, backend):
    """``prefill`` on a ragged prompt (45 tokens, chunks of 32), then four
    ``decode_step``s chained: the logits and every cache leaf at each."""
    jc, jp, tc, tp = _models(dtype)
    tp = TM.compute_params(tp, tc)
    toks = _tokens(jc, (2, 45))
    jl, jcache = JM.prefill(jp, dict(tokens=jnp.asarray(toks)), jc)
    tl, tcache = TM.prefill(tp, dict(tokens=torch.from_numpy(toks).long()), tc,
                            backend=backend)
    tol = TOLS[dtype]
    assert tl.shape == (2, jc.vocab_padded) and tl.dtype == torch.float32
    assert bool((tl[:, jc.vocab:] == -1e30).all())
    assert _rel(tl[:, :jc.vocab], jl[:, :jc.vocab]) <= tol
    assert tcache["len"] == int(jcache["len"]) == 45
    for step, tok in enumerate((5, 17, 3, 250)):
        for k in ("conv", "ssm"):
            assert tcache[k].dtype == (torch.float32 if k == "ssm" else getattr(torch, dtype))
            assert _rel(tcache[k], jcache[k]) <= tol, (step, k)
        t = np.full((2, 1), tok, np.int32)
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(t), jc)
        tl, tcache = TM.decode_step(tp, tcache, torch.from_numpy(t).long(), tc)
        assert _rel(tl[:, :jc.vocab], jl[:, :jc.vocab]) <= tol, step
    assert tcache["len"] == int(jcache["len"]) == 49


def test_init_cache_and_tree_match_jax_layout():
    jc, jp, tc, _ = _models()
    tp = TM.init_mamba2(torch.Generator().manual_seed(0), tc)
    want = {k: (a.shape, str(a.dtype)) for k, a in tree_paths(jax.tree.map(np.asarray, jp)).items()}
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1]) for k, t in tree_paths(tp).items()} \
        == want
    assert torch.equal(tp["layers"]["A_log"],
                       torch.log(torch.arange(1, 9, dtype=torch.float32)).expand(2, 8))
    dt = torch.nn.functional.softplus(tp["layers"]["dt_bias"])
    assert float(dt.min()) >= tc.ssm.dt_min * 0.999 and float(dt.max()) <= tc.ssm.dt_max * 1.001
    jcache = JM.init_cache(jc, 3, 64)
    tcache = TM.init_cache(tc, 3, 64, "cpu")
    assert tcache["len"] == 0
    for k in ("conv", "ssm"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert str(tcache[k].dtype).split(".")[1] == str(jcache[k].dtype)
    bf = TM.init_mamba2(torch.Generator().manual_seed(0),
                        dataclasses.replace(tc, param_dtype="bfloat16"), at_param_dtype=True)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf))


def test_compute_params_is_the_per_call_cast():
    """The four cast leaves narrowed once, the rest kept; the same
    numbers as the per-call cast."""
    _, _, tc, tp = _models("bfloat16")
    cp = TM.compute_params(tp, tc)
    for k, v in cp["layers"].items():
        want = torch.bfloat16 if k in TM.CAST_LEAVES else torch.float32
        assert v.dtype == want, k
    assert cp["embed"].dtype == torch.float32 and cp["embed"] is tp["embed"]
    toks = torch.from_numpy(_tokens(tc, (1, 20)))
    a, _ = TM.prefill(tp, dict(tokens=toks.long()), tc)
    b, _ = TM.prefill(cp, dict(tokens=toks.long()), tc)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# loss, gradients and the train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    jc, jp, _, _ = _models()
    toks = _tokens(jc, (2, 40), seed=8)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: JM.loss(p, dict(tokens=jnp.asarray(toks)), jc), has_aux=True))(jp)
    return toks, float(loss), tree_paths(jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_gradients_match_jax(backend):
    _, _, tc, tp = _models()
    toks, jloss, jg = _jax_loss_and_grads()
    live = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, metrics = TM.loss(tree_rebuild(tp, live), dict(tokens=torch.from_numpy(toks).long()),
                            tc, backend=backend)
    grads = torch.autograd.grad(loss, live)
    assert _rel(loss, jloss) <= TOL and float(metrics["aux"]) == 0.0
    assert torch.equal(loss, metrics["nll"])
    for (path, want), g in zip(jg.items(), grads):
        assert _rel(g, want) <= TOL, path


def test_ssd_dispatch_under_grad_reaches_the_function(monkeypatch):
    """On ``cuda`` with grad on, every layer's SSD goes through
    ``dispatch._SSDChunk`` (the loss's graph holds its backward node, one a
    layer), and the Function's backward runs once a layer."""
    _, _, tc, tp = _models()
    toks, _, _ = _jax_loss_and_grads()
    runs = []
    orig = td._SSDChunk.backward

    def counted(ctx, *gs):
        runs.append(1)
        return orig(ctx, *gs)

    monkeypatch.setattr(td._SSDChunk, "backward", staticmethod(counted))
    live = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, _ = TM.loss(tree_rebuild(tp, live), dict(tokens=torch.from_numpy(toks).long()), tc,
                      backend="cuda")
    torch.autograd.grad(loss, live)
    assert len(runs) == tc.n_layers
    x, dt, A, B, C, _ = (torch.from_numpy(a) for a in _ssd_inputs(32, seed=1))
    out = td.ssd_chunk(x.reshape(-1, 32, 8).requires_grad_(True),
                       dt.permute(0, 2, 1).reshape(-1, 32), A.repeat(2),
                       B.reshape(-1, 32, 16), C.reshape(-1, 32, 16), backend="cuda")
    assert all(type(o.grad_fn).__name__ == "_SSDChunkBackward" for o in out)
    plain = td.ssd_chunk(x.reshape(-1, 32, 8).requires_grad_(True),
                         dt.permute(0, 2, 1).reshape(-1, 32), A.repeat(2),
                         B.reshape(-1, 32, 16), C.reshape(-1, 32, 16), backend="ref")
    assert "_SSDChunk" not in type(plain[0].grad_fn).__name__


def _small_chunk(dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    dt = torch.exp(torch.empty(3, 6, dtype=dtype).uniform_(-5, -2, generator=g))
    A = -torch.empty(3, dtype=dtype).uniform_(1, 4, generator=g)
    return [r(3, 6, 4), dt, A, r(3, 6, 5), r(3, 6, 5)]


def test_ssd_function_gradients_match_the_reference_einsums():
    """``_SSDChunk``'s backward (the VJP of the kernel's plain version,
    recomputed), reached through ``_intra_chunk``'s G flattening on
    ``cuda``, against autograd through the reference's einsums on ``ref``:
    all five operands, a random cotangent on each of the four outputs, fp32
    within TOL of each gradient's max."""
    g = torch.Generator().manual_seed(3)
    b, nc, cs, h, p, n = 2, 3, 8, 4, 8, 16
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    dt = torch.exp(torch.empty(b, nc, cs, h).uniform_(-5, -2, generator=g))
    A = -torch.empty(h).uniform_(1, 4, generator=g)
    ins = [r(b, nc, cs, h, p), dt, A, r(b, nc, cs, h, n), r(b, nc, cs, h, n)]
    grads = {}
    for backend in BACKENDS:
        live = [t.clone().requires_grad_(True) for t in ins]
        outs = TM._intra_chunk(*live, backend)
        cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
                for i, o in enumerate(outs)]
        grads[backend] = torch.autograd.grad(outs, live, cots)
    for got, want in zip(grads["cuda"], grads["ref"]):
        assert float((got - want).abs().max() / want.abs().max()) <= TOL


def test_ssd_function_takes_none_or_zero_cotangents():
    """A cotangent of None (an output not reached) or of zeros gives the
    same gradient as leaving the output out; an operand that needs no
    grad gets None."""
    x, dt, A, B, C = _small_chunk(torch.float32, seed=2)
    x.requires_grad_(True)
    dt.requires_grad_(True)
    y, st, cd, sd = td._SSDChunk.apply(x, dt, A, B, C)
    gx, gdt = torch.autograd.grad(y.sum() + 0.0 * cd.sum(), (x, dt))
    wx, wdt = torch.autograd.grad(ssd_scan.ssd_chunk_plain(x, dt, A, B, C)[0].sum(), (x, dt))
    assert torch.allclose(gx, wx, atol=1e-6) and torch.allclose(gdt, wdt, atol=1e-6)
    ctx = type("Ctx", (), dict(saved_tensors=(x.detach(), dt.detach(), A, B, C),
                               needs_input_grad=(True, True, False, False, False)))()
    got = td._SSDChunk.backward(ctx, torch.ones_like(y), None, torch.zeros_like(cd), None)
    assert got[2:] == (None, None, None)
    assert torch.allclose(got[0], wx, atol=1e-6) and torch.allclose(got[1], wdt, atol=1e-6)
    assert td._SSDChunk.backward(ctx, None, None, None, None) == (None,) * 5


def test_bare_wrapper_refuses_grad_naming_the_function():
    """The ssd_chunk wrapper's device path (reached with "meta" tensors)
    refuses a tensor that requires grad, naming ``dispatch._SSDChunk``."""
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="dispatch._SSDChunk"):
        ssd_scan.ssd_chunk(m(2, 8, 16).requires_grad_(True), m(2, 8), m(2), m(2, 8, 16),
                           m(2, 8, 16))


def test_train_step_matches_jax():
    """One ``make_train_step`` step (fp32 state, constant lr) against the
    JAX package's step jitted without a mesh."""
    jc, tc = _cfgs("float32")
    jstate = JS.make_init_state(jc, JAdamW())(jax.random.key(0))
    tstate = lm_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(JS.make_train_step(jc, JAdamW(), schedule=lambda c: LR))
    tstep = TS.make_train_step(tc, TA.AdamWConfig(), schedule=lambda c: torch.tensor(LR))
    b = TokenPipeline(TokenPipelineConfig(vocab=tc.vocab, seq_len=40, global_batch=2)
                      ).batch_at(0)
    before = [p.clone() for p in tree_leaves(tstate["params"])]
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    out, tm = tstep(tstate, batch_to_device(b, "cpu"))
    assert out is tstate
    for k in ("loss", "nll", "grad_norm"):
        assert _rel(tm[k], jm[k]) <= TOL, k
    for p, o, w in zip(tree_leaves(tstate["params"]), before, jax.tree.leaves(jstate["params"])):
        du = (p - o).numpy() - (np.asarray(w) - o.numpy())
        assert float(np.abs(du).max()) <= 0.05 * LR


# ---------------------------------------------------------------------------
# serving, the episodic backbone, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [(12, 12, 12), (12, 7, 33)], ids=["stacked", "ragged"])
def test_engine_matches_jax(lengths):
    """The port's ``ServeEngine`` against the JAX package's, greedy in fp32,
    token for token: a cohort of equal prompts decodes stacked, a ragged one
    slot by slot."""
    jc, jp, tc, tp = _models()
    prompts = [_tokens(jc, (n,), seed=i) for i, n in enumerate(lengths)]
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    JEngine(jc, jp, n_slots=3, max_seq=48).run_to_completion(jr)
    ServeEngine(tc, tp, n_slots=3, max_seq=48, kernel_backend="cuda").run_to_completion(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and len(r.out_tokens) == 5 for r in tr)


def test_registry_serves_and_trains_mamba2():
    _, _, tc, _ = _models()
    api = get_api(tc)
    assert (api.init, api.loss, api.prefill, api.decode_step, api.init_cache,
            api.compute_params) == (TM.init_mamba2, TM.loss, TM.prefill, TM.decode_step,
                                    TM.init_cache, TM.compute_params)
    assert j_get_api(_cfgs()[0]).loss is JM.loss


def test_launchers_and_examples_run_mamba2(tmp_path, capsys):
    from repro_torch.examples import episodic_lm, serve_lm, train_lm
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots", "2",
                      "--max-new", "4"])
    assert out["tokens"] == 12
    assert "mamba2-smoke (mamba2 cache): 3 requests" in capsys.readouterr().out
    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
                "16", "--ckpt-dir", str(tmp_path / "ck")])
    assert "done at step 3" in capsys.readouterr().out
    train_lm.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16", "--device",
                   "cpu", "--ckpt-dir", str(tmp_path / "ex")])
    assert "final loss:" in capsys.readouterr().out
    serve_lm.main(["--arch", ARCH, "--requests", "2", "--max-new", "3", "--device", "cpu"])
    assert "all requests complete" in capsys.readouterr().out
    episodic_lm.main(["--arch", ARCH, "--device", "cpu", "--steps", "1"])
    assert "mamba2-smoke" in capsys.readouterr().out
