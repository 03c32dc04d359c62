"""The port's Zamba2 hybrid against the JAX package's, on the CPU: the
layout, the tree and the cache, ``prefill`` and ``decode_step`` chained
(logits and every cache leaf: the mamba layers' states and each shared
site's k and v), ``loss`` and every gradient leaf (the shared block's the
sum over its sites), one ``make_train_step`` step against the JAX
package's step jitted without a mesh, the serving engine token for token
(a stacked and a ragged cohort, prompts of different lengths spliced into
one engine's slots), where the kernels are reached, and the launchers and
examples.

Smoke config zamba2-smoke (7 layers at every 3: 2 groups of 2 mamba layers
and the shared block, then 1 tail mamba layer; d_model 64, 4 heads of 16,
d_ff 128, SSD state 16, chunks of 32, vocab 256).  Inputs are numpy draws
from a seed; the JAX package's params cross with
``bridge.lm_params_from_numpy``.  The ``cuda`` backend on CPU tensors runs
the ssd_chunk and flash attention kernels' plain versions inside their
autograd Functions; the kernels themselves are checked on the card
(``chip_smoke.py`` phases 6d and 5f).  Tolerances, each over the
reference's max|.|:

* fp32 compute: TOL = 1e-4 (measured: logits 7e-7, caches 1.1e-6,
  gradient leaves 2.4e-6; sums in other orders);
* bf16 compute: TOL_BF16 = 5e-2, the SSM families' tolerance of
  tests/test_arch_smoke.py:91 (measured: logits 1.6e-2, k and v 3.2e-2:
  eager PyTorch rounds every op's output to bf16 where XLA's fusions keep
  some in f32, and the kernel path's attention does not round P);
* ``make_train_step``: loss and grad_norm within TOL, each parameter's
  update within 0.05 x LR (test_torch_lm_train.py's bound and reason).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import zamba2 as JZ
from repro.optim import AdamWConfig as JAdamW
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import step as JS
from repro_torch.bridge import (is_conv_weight, lm_cache_from_numpy, lm_params_from_numpy,
                                lm_state_from_numpy, lm_state_to_numpy)
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths, tree_rebuild
from repro_torch.configs import registry as treg
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig, batch_to_device
from repro_torch.kernels import dispatch as td
from repro_torch.models import mamba2 as TM
from repro_torch.models import zamba2 as TZ
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw as TA
from repro_torch.optim.clip import clip_by_global_norm, clip_scale
from repro_torch.serve import engine as TE
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import step as TS

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "zamba2-7b"
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
    jp = JZ.init_zamba2(jax.random.key(0), jc)
    return jc, jp, tc, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("n_layers,every", [(7, 3), (81, 6), (12, 6), (6, 6), (5, 6)])
def test_layout_matches_jax(n_layers, every):
    jc, tc = (dataclasses.replace(c, n_layers=n_layers, hybrid_attn_every=every)
              for c in _cfgs())
    assert TZ.layout(tc) == JZ.layout(jc)
    assert TZ.n_mamba_layers(tc) == JZ.n_mamba_layers(jc)


def test_init_tree_and_cache_match_jax_layout():
    jc, jp, tc, _ = _models()
    tp = TZ.init_zamba2(torch.Generator().manual_seed(0), tc)
    want = {k: (a.shape, str(a.dtype)) for k, a in tree_paths(jax.tree.map(np.asarray, jp)).items()}
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1]) for k, t in tree_paths(tp).items()} \
        == want
    jcache, tcache = JZ.init_cache(jc, 2, 48), TZ.init_cache(tc, 2, 48, "cpu")
    assert tcache["len"] == 0 and set(tcache) == set(jcache)
    for k in ("conv", "ssm", "k", "v"):
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        assert str(tcache[k].dtype).split(".")[1] == str(jcache[k].dtype), k


def test_compute_params_narrows_mamba_and_shared_weights():
    _, _, tc, tp = _models("bfloat16")
    cp = TZ.compute_params(tp, tc)
    for k, v in cp["mamba"].items():
        assert v.dtype == (torch.bfloat16 if k in TM.CAST_LEAVES else torch.float32), k
    for part in ("attn", "ffn"):
        assert all(v.dtype == torch.bfloat16 for v in cp["shared"][part].values())
    assert cp["shared"]["attn_norm"].dtype == torch.float32
    toks = torch.from_numpy(_tokens(tc, (1, 20))).long()
    a, _ = TZ.prefill(tp, dict(tokens=toks), tc)
    b, _ = TZ.prefill(cp, dict(tokens=toks), tc)
    assert torch.equal(a, b)


PROMPT = _tokens(_cfgs()[0], (2, 45), seed=1)
STEPS = (5, 17, 3, 250)


@functools.lru_cache(maxsize=None)
def _jax_chain(dtype):
    """The JAX package's prefill of PROMPT spliced into a 56-position cache,
    then a decode step for each token of STEPS: [(logits, cache), ...]."""
    jc, jp, _, _ = _models(dtype)
    toks, steps = PROMPT, STEPS
    jl, jpre = JZ.prefill(jp, dict(tokens=jnp.asarray(toks)), jc)
    jfull = JZ.init_cache(jc, toks.shape[0], 56)
    jcache = dict(jfull, conv=jpre["conv"], ssm=jpre["ssm"], len=jpre["len"],
                  **{kv: jax.lax.dynamic_update_slice(jfull[kv], jpre[kv], (0,) * 5)
                     for kv in ("k", "v")})
    out = [(jl, jpre)]
    for tok in steps:
        jl, jcache = JZ.decode_step(jp, jcache, jnp.full((toks.shape[0], 1), tok, jnp.int32),
                                    jc)
        out.append((jl, jcache))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, backend):
    """``prefill`` on a ragged prompt (45 tokens, chunks of 32) spliced into
    a 56-position cache, then four ``decode_step``s chained: the logits and
    every cache leaf at each.  In bf16 the logits are held to the JAX
    package's bf16 run and the cache leaves to its fp32-compute run: the
    deepest SSM state of the two bf16 runs differ by 5.9e-2 of its max,
    most of it the JAX run's own rounding (5.5e-2 from its fp32 run,
    against the port's 2.6e-2)."""
    jc, jp, tc, tp = _models(dtype)
    tp = TZ.compute_params(tp, tc)
    toks, steps = PROMPT, STEPS
    want = _jax_chain(dtype)
    want_cache = _jax_chain("float32")
    tol = TOLS[dtype]
    tl, tcache = TZ.prefill(tp, dict(tokens=torch.from_numpy(toks).long()), tc, backend=backend)
    assert tcache["len"] == int(want[0][1]["len"]) == 45
    for step, ((jl, _), (_, jcache)) in enumerate(zip(want, want_cache)):
        if step:
            t = torch.full((2, 1), steps[step - 1])
            tl, tcache = TZ.decode_step(tp, tcache, t, tc)
        else:
            tcache = TE._splice_cache(TZ.init_cache(tc, 2, 56, "cpu"), tcache)
        assert _rel(tl[:, :jc.vocab], jl[:, :jc.vocab]) <= tol, step
        for k in ("conv", "ssm", "k", "v"):
            got = tcache[k][:, :, :45] if step == 0 and k in ("k", "v") else tcache[k]
            assert _rel(got, jcache[k]) <= tol, (step, k)
    assert tcache["len"] == int(want[-1][1]["len"]) == 49
    # the port reads a JAX cache through the bridge, and decodes on from it
    jcache = want[-1][1]
    tl2, _ = TZ.decode_step(tp, lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu"),
                            torch.full((2, 1), 9), tc)
    jl2, _ = JZ.decode_step(jp, jcache, jnp.full((2, 1), 9, jnp.int32), jc)
    assert _rel(tl2[:, :jc.vocab], jl2[:, :jc.vocab]) <= tol


def test_kernels_reached_once_a_chunk_call_and_a_site(monkeypatch):
    """On ``cuda`` a prefill makes one ssd_chunk call a mamba layer and one
    flash attention call a shared site; a decode step makes none."""
    jc, _, tc, tp = _models()
    calls = []
    for name in ("ssd_chunk", "flash_attention"):
        orig = getattr(td, name)
        monkeypatch.setattr(td, name, lambda *a, _o=orig, _n=name, **kw: (calls.append(_n),
                                                                           _o(*a, **kw))[1])
    _, cache = TZ.prefill(tp, dict(tokens=torch.from_numpy(_tokens(tc, (1, 40))).long()), tc,
                          backend="cuda")
    g, _, _ = TZ.layout(tc)
    assert sorted(calls) == ["flash_attention"] * g + ["ssd_chunk"] * TZ.n_mamba_layers(tc)
    calls.clear()
    full = TE._splice_cache(TZ.init_cache(tc, 1, 48, "cpu"), cache)
    TZ.decode_step(tp, full, torch.tensor([[3]]), tc, backend="cuda")
    assert calls == []


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    jc, jp, _, _ = _models()
    toks = _tokens(jc, (2, 40), seed=8)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: JZ.loss(p, dict(tokens=jnp.asarray(toks)), jc), has_aux=True))(jp)
    return toks, float(loss), tree_paths(jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_gradients_match_jax(backend):
    """The loss and every leaf's gradient, the shared block's summed over
    its two sites (checked to have a gradient from each: its gradient on
    one site alone differs)."""
    jc, jp, tc, tp = _models()
    toks, jloss, jg = _jax_loss_and_grads()
    live = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, metrics = TZ.loss(tree_rebuild(tp, live), dict(tokens=torch.from_numpy(toks).long()),
                            tc, backend=backend)
    grads = dict(zip(tree_paths(tp), torch.autograd.grad(loss, live)))
    assert _rel(loss, jloss) <= TOL and float(metrics["aux"]) == 0.0
    assert grads.keys() == jg.keys()
    for path, want in jg.items():
        assert _rel(grads[path], want) <= TOL, path
    one_site = dataclasses.replace(jc, n_layers=4)       # 1 group and 1 tail layer
    jp1 = dict(jp, mamba=jax.tree.map(lambda a: a[:3], jp["mamba"]))
    g1 = jax.jit(jax.grad(lambda p: JZ.loss(p, dict(tokens=jnp.asarray(toks)),
                                            one_site)[0]))(jp1)
    assert _rel(grads["shared/ffn/w_down"], g1["shared"]["ffn"]["w_down"]) > 10 * TOL


def test_train_step_matches_jax():
    """One ``make_train_step`` step (fp32 state, constant lr) against the
    JAX package's step jitted without a mesh; the shared block's 2-D MLP
    leaves (keyed as experts are) update as the JAX package's do."""
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


def test_int8_state_of_the_shared_block_keeps_the_jax_layout(monkeypatch):
    """The shared block's 2-D MLP leaves are keyed ``w_gate``, ``w_up`` and
    ``w_down`` as MoE experts are; no leaf of the tree is taken for a conv
    weight, the int8 AdamW state crosses both ways in the JAX package's
    layout (mamba2's 3-D ``conv_w`` (M, c, k) too), and the in-place update
    in blocks of rows is bit-equal to ``adamw_update`` after the clip."""
    jc, tc = _cfgs()
    jstate = JS.make_init_state(jc, JAdamW(state_dtype="int8"))(jax.random.key(0))
    tstate = lm_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert not any(is_conv_weight(t, k.rsplit("/", 1)[-1])
                   for k, t in tree_paths(tstate["params"]).items())
    back, want = lm_state_to_numpy(tstate), jax.tree.map(np.asarray, jstate)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    cfg = TA.AdamWConfig(state_dtype="int8")
    params = tstate["params"]
    assert params["mamba"]["conv_w"].dim() == 3 and params["shared"]["ffn"]["w_up"].dim() == 2
    monkeypatch.setattr(TA, "UPDATE_CHUNK", 2048)
    assert len(TA._row_slices(params["shared"]["ffn"]["w_up"])) == 4
    fresh = TA.adamw_init(params, cfg)
    shapes = lambda tree: [tuple(t.shape) if torch.is_tensor(t) else t  # noqa: E731
                           for t in tree_leaves(tree)]
    assert shapes(fresh) == shapes(tstate["opt"])
    ref = (params, fresh)
    mine = tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, ref)
    gen = torch.Generator().manual_seed(0)
    for s in range(2):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
        lr = torch.tensor(1e-2 * (s + 1))
        ref = TA.adamw_update(ref[0], clip_by_global_norm(grads, 1.0)[0], ref[1], lr, cfg)
        TA.adamw_update_(mine[0], tree_leaves(grads), mine[1], lr, cfg,
                         grad_scale=clip_scale(grads, 1.0)[0])
        for a, b in zip(tree_leaves(ref), tree_leaves(mine)):
            assert a == b if not torch.is_tensor(a) else torch.equal(a, b)


def _both(lengths, max_new, **kw):
    jc, jp, tc, tp = _models()
    prompts = [_tokens(jc, (n,), seed=i) for i, n in enumerate(lengths)]
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    JEngine(jc, jp, **kw).run_to_completion(jr)
    ServeEngine(tc, tp, kernel_backend="cuda", **kw).run_to_completion(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and len(r.out_tokens) == max_new for r in tr)
    return tr


@pytest.mark.parametrize("lengths", [(12, 12), (12, 7, 33, 20)], ids=["stacked", "ragged"])
def test_engine_matches_jax(lengths):
    """The port's ``ServeEngine`` against the JAX package's, greedy in fp32,
    token for token: two equal prompts decode stacked; four ragged ones
    pass through two slots, each prefill spliced into a slot that held a
    prompt of another length."""
    _both(lengths, 5, n_slots=2, max_seq=48)


def test_splice_copies_ssm_states_whole_and_kv_by_prompt():
    """``_splice_cache``: the conv and SSM states replace the slot's whole;
    each site's k and v fill the prompt's positions and leave the rest."""
    _, _, tc, tp = _models()
    full = TZ.init_cache(tc, 1, 48, "cpu")
    for k in ("conv", "ssm", "k", "v"):
        full[k].fill_(7.0)
    _, pre = TZ.prefill(tp, dict(tokens=torch.from_numpy(_tokens(tc, (1, 13))).long()), tc)
    out = TE._splice_cache(full, pre)
    assert out is full and out["len"] == 13
    assert torch.equal(out["conv"], pre["conv"]) and torch.equal(out["ssm"], pre["ssm"])
    for k in ("k", "v"):
        assert torch.equal(out[k][:, :, :13], pre[k]) and bool((out[k][:, :, 13:] == 7).all())


def test_launchers_and_examples_run_zamba2(tmp_path, capsys):
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots", "2",
                      "--max-new", "4"])
    assert out["tokens"] == 12
    assert "zamba2-smoke (hybrid cache): 3 requests" in capsys.readouterr().out
    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
                "16", "--ckpt-dir", str(tmp_path / "ck")])
    assert "done at step 3" in capsys.readouterr().out
    train_lm.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16", "--device",
                   "cpu", "--ckpt-dir", str(tmp_path / "ex")])
    assert "final loss:" in capsys.readouterr().out
    serve_lm.main(["--arch", ARCH, "--requests", "2", "--max-new", "3", "--device", "cpu"])
    assert "all requests complete" in capsys.readouterr().out
    assert get_api(_cfgs()[1]).prefill is TZ.prefill
