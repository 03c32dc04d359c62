"""The port's whisper encoder-decoder against the JAX package's, on the CPU:
the tree and the cache, ``encode``, ``prefill`` and teacher-forced
``decode_step`` chained (logits and every cache leaf), ``loss`` and every
gradient leaf under the remat policies "none" and "nothing", one
``make_train_step`` step against the JAX package's step jitted without a
mesh, B5's autograd Function without the causal mask, the serving engine
token for token (a stacked and a ragged cohort), where the kernels are
reached, the splice, the launchers and examples, and why the chip's gate
drives the model on random frames (the engine's zero frames make the
encoder exactly 0).

Smoke config whisper-smoke (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, d_ff 128, 16 frames, vocab 256).  Inputs (tokens and frames)
are numpy draws from a seed; the JAX package's params cross with
``bridge.lm_params_from_numpy``.  The JAX loss is called without a mesh
(ROADMAP R4).  The ``cuda`` backend on CPU tensors runs the flash attention
kernel's plain version inside its autograd Function; the kernel itself is
checked on the card (``chip_smoke.py`` phase 6e).  Tolerances, each over
the reference's max|.|:

* fp32 compute: TOL = 1e-5 (measured at prefill: logits 8.6e-7, caches
  6.1e-7; sums in other orders); gradient leaves TOL_GRAD = 1e-4 (the LM
  training tests' bound: a leaf's gradient sums over every position);
* bf16 compute: TOL_BF16 = 4e-2 (test_torch_lm_models.py's reason: eager
  PyTorch rounds every op's output to bf16 where XLA's fusions keep some
  in f32, and the kernel path's attention does not round P; measured at
  prefill: logits 2.1e-2, caches 9.9e-3);
* ``make_train_step``: loss and grad_norm within TOL_GRAD, each
  parameter's update within 0.05 x LR (test_torch_lm_train.py's bound and
  reason).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import whisper as JW
from repro.optim import AdamWConfig as JAdamW
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import step as JS
from repro_torch.bridge import (is_conv_weight, lm_cache_from_numpy, lm_params_from_numpy,
                                lm_state_from_numpy, lm_state_to_numpy)
from repro_torch.common.tree import tree_leaves, tree_paths, tree_rebuild
from repro_torch.configs import registry as treg
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as L
from repro_torch.models import whisper as TW
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw as TA
from repro_torch.serve import engine as TE
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import step as TS

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "whisper-base"
TOL = 1e-5
TOL_GRAD = 1e-4
TOL_BF16 = 4e-2
TOLS = {"float32": TOL, "bfloat16": TOL_BF16}
BACKENDS = ["ref", "cuda"]
LR = 1e-3


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jreg.get_smoke_config(ARCH), compute_dtype=dtype, **kw),
            dataclasses.replace(treg.get_smoke_config(ARCH), compute_dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _models(dtype="float32"):
    jc, tc = _cfgs(dtype)
    jp = JW.init_whisper(jax.random.key(0), jc)
    return jc, jp, tc, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def _frames(cfg, b, seed=0):
    return np.random.default_rng(100 + seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def _tbatch(toks, frames):
    return dict(tokens=torch.from_numpy(toks).long(), frontend_embeds=torch.from_numpy(frames))


def _jbatch(toks, frames):
    return dict(tokens=jnp.asarray(toks), frontend_embeds=jnp.asarray(frames))


def test_init_tree_and_cache_match_jax_layout():
    jc, jp, tc, _ = _models()
    tp = TW.init_whisper(torch.Generator().manual_seed(0), tc)
    want = {k: (a.shape, str(a.dtype))
            for k, a in tree_paths(jax.tree.map(np.asarray, jp)).items()}
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1]) for k, t in tree_paths(tp).items()} \
        == want
    jcache, tcache = JW.init_cache(jc, 2, 48), TW.init_cache(tc, 2, 48, "cpu")
    assert tcache["len"] == 0 and set(tcache) == set(jcache)
    for k in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        assert str(tcache[k].dtype).split(".")[1] == str(jcache[k].dtype), k


def test_registry_and_bridge_carry_whisper():
    """``get_api`` gives the port's whisper; every leaf is at most 3-D, none
    is taken for a conv weight, and a train state crosses both ways bit for
    bit."""
    jc, tc = _cfgs()
    api = get_api(tc)
    assert (api.init, api.loss, api.prefill, api.decode_step, api.init_cache,
            api.compute_params) == (TW.init_whisper, TW.loss, TW.prefill, TW.decode_step,
                                    TW.init_cache, TW.compute_params)
    jstate = JS.make_init_state(jc, JAdamW())(jax.random.key(0))
    tstate = lm_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    paths = tree_paths(tstate["params"])
    assert max(t.dim() for t in paths.values()) == 3
    assert not any(is_conv_weight(t, k.rsplit("/", 1)[-1]) for k, t in paths.items())
    back, want = lm_state_to_numpy(tstate), jax.tree.map(np.asarray, jstate)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_compute_params_narrows_both_stacks():
    _, _, tc, tp = _models("bfloat16")
    cp = TW.compute_params(tp, tc)
    for stack, parts in (("encoder", ("attn", "ffn")), ("decoder", ("attn", "cross", "ffn"))):
        for part in parts:
            assert all(v.dtype == torch.bfloat16 for v in cp[stack][part].values()), part
        assert cp[stack]["attn_norm"].dtype == torch.float32
    assert cp["embed"].dtype == torch.float32 and tp["decoder"]["cross"]["wq"].dtype == \
        torch.float32
    toks, fr = _tokens(tc, (1, 7)), _frames(tc, 1)
    a, _ = TW.prefill(tp, _tbatch(toks, fr), tc)
    b, _ = TW.prefill(cp, _tbatch(toks, fr), tc)
    assert torch.equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype, backend):
    jc, jp, tc, tp = _models(dtype)
    fr = _frames(tc, 2)
    want = JW.encode(jp, jnp.asarray(fr), jc)
    got = TW.encode(tp, torch.from_numpy(fr), tc, backend=backend)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= TOLS[dtype]


PROMPT = _tokens(_cfgs()[0], (2, 11), seed=1)
FRAMES = _frames(_cfgs()[0], 2, seed=1)
STEPS = (5, 17, 3)


@functools.lru_cache(maxsize=None)
def _jax_chain(dtype):
    """The JAX package's prefill of PROMPT on FRAMES spliced into a
    24-position cache, then a decode step for each token of STEPS:
    [(logits, cache), ...]."""
    jc, jp, _, _ = _models(dtype)
    jl, jpre = JW.prefill(jp, _jbatch(PROMPT, FRAMES), jc)
    jfull = JW.init_cache(jc, 2, 24)
    jcache = dict(jfull, cross_k=jpre["cross_k"], cross_v=jpre["cross_v"], len=jpre["len"],
                  **{kv: jax.lax.dynamic_update_slice(jfull[kv], jpre[kv], (0,) * 5)
                     for kv in ("k", "v")})
    out = [(jl, jpre)]
    for tok in STEPS:
        jl, jcache = JW.decode_step(jp, jcache, jnp.full((2, 1), tok, jnp.int32), jc)
        out.append((jl, jcache))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, backend):
    """``prefill`` of an 11-token prompt on random frames, spliced into a
    24-position cache, then three teacher-forced ``decode_step``s chained:
    the logits and the cache leaves ``k``, ``v``, ``cross_k``, ``cross_v``
    and ``len`` at each; then a decode step from the JAX cache carried
    across."""
    jc, jp, tc, tp = _models(dtype)
    tp = TW.compute_params(tp, tc)
    want = _jax_chain(dtype)
    tol = TOLS[dtype]
    tl, tcache = TW.prefill(tp, _tbatch(PROMPT, FRAMES), tc, backend=backend)
    assert tcache["len"] == int(want[0][1]["len"]) == 11
    for step, (jl, jcache) in enumerate(want):
        if step:
            tl, tcache = TW.decode_step(tp, tcache, torch.full((2, 1), STEPS[step - 1]), tc)
        else:
            tcache = TE._splice_cache(TW.init_cache(tc, 2, 24, "cpu"), tcache)
        assert tcache["len"] == int(jcache["len"]), step
        assert _rel(tl[:, :jc.vocab], jl[:, :jc.vocab]) <= tol, step
        for k in ("k", "v", "cross_k", "cross_v"):
            got = tcache[k][:, :, :11] if step == 0 and k in ("k", "v") else tcache[k]
            assert _rel(got, jcache[k]) <= tol, (step, k)
    assert tcache["len"] == 14
    jcache = want[-1][1]
    tl2, _ = TW.decode_step(tp, lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu"),
                            torch.full((2, 1), 9), tc)
    jl2, _ = JW.decode_step(jp, jcache, jnp.full((2, 1), 9, jnp.int32), jc)
    assert _rel(tl2[:, :jc.vocab], jl2[:, :jc.vocab]) <= tol


def test_zero_frames_give_a_zero_encoder_and_random_frames_reach_the_logits():
    """Why the chip's gate drives the model on random frames and reads the
    cross k and v: the engine prefills on zero frames (as the reference
    does), and then rms_norm, the bias-free projections and the MLP keep
    every encoder state at exactly 0, so the cross k and v are 0 and no
    fault of the encoder (B5's included) can show in an engine run.  On
    random frames the encoder reaches the cross k and v and the logits."""
    jc, jp, tc, tp = _models()
    toks = _tokens(tc, (1, 6), seed=3)
    zero = np.zeros((1, tc.n_frontend_tokens, tc.d_model), np.float32)
    lz, cz = TW.prefill(tp, _tbatch(toks, zero), tc, backend="cuda")
    assert float(cz["cross_k"].abs().max()) == 0.0 and float(cz["cross_v"].abs().max()) == 0.0
    _, jcz = JW.prefill(jp, _jbatch(toks, zero), jc)
    assert float(jnp.abs(jcz["cross_k"]).max()) == 0.0
    lr, cr = TW.prefill(tp, _tbatch(toks, _frames(tc, 1, seed=3)), tc, backend="cuda")
    assert float(cr["cross_k"].abs().max()) > 0.1
    assert _rel(lr[:, :tc.vocab], lz[:, :tc.vocab]) > 1e-2


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(policy):
    jc, _ = _cfgs(remat_policy=policy)
    jp = _models()[1]
    toks, fr = _tokens(jc, (2, 20), seed=8), _frames(jc, 2, seed=8)
    (loss, _), g = jax.jit(jax.value_and_grad(lambda p: JW.loss(p, _jbatch(toks, fr), jc),
                                              has_aux=True))(jp)
    return toks, fr, float(loss), tree_paths(jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", ["none", "nothing"])
def test_loss_and_gradients_match_jax(policy, backend, monkeypatch):
    """The loss and every leaf's gradient against ``jax.value_and_grad`` of
    the JAX loss, under the same remat policy; on ``cuda`` B5 runs once an
    encoder and once a decoder layer in the forward (bidirectional, then
    causal) and, under "nothing", once more each in the checkpoints'
    recompute."""
    _, tc = _cfgs(remat_policy=policy)
    tp = _models()[3]
    toks, fr, jloss, jg = _jax_loss_and_grads(policy)
    calls = []
    orig = td._fa.flash_attention_gqa
    monkeypatch.setattr(td._fa, "flash_attention_gqa",
                        lambda *a, **kw: (calls.append(kw["causal"]), orig(*a, **kw))[1])
    live = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, metrics = TW.loss(tree_rebuild(tp, live), _tbatch(toks, fr), tc, backend=backend)
    n_fwd = len(calls)
    grads = dict(zip(tree_paths(tp), torch.autograd.grad(loss, live)))
    assert _rel(loss, jloss) <= TOL and float(metrics["aux"]) == 0.0
    assert float(metrics["nll"].detach()) == float(loss.detach())
    assert grads.keys() == jg.keys()
    for path, want in jg.items():
        assert _rel(grads[path], want) <= TOL_GRAD, path
    if backend == "ref":
        assert calls == []
        return
    assert calls[:n_fwd] == [False] * tc.n_encoder_layers + [True] * tc.n_layers
    # the recompute runs the decoder's blocks first, in reverse
    assert calls[n_fwd:] == ([] if policy == "none" else
                             [True] * tc.n_layers + [False] * tc.n_encoder_layers)


def test_train_step_matches_jax():
    """One ``make_train_step`` step (fp32 state, constant lr) against the
    JAX package's step jitted without a mesh, on a batch of the token
    pipeline's tokens and random frames."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    jc, tc = _cfgs("float32")
    jstate = JS.make_init_state(jc, JAdamW())(jax.random.key(0))
    tstate = lm_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(JS.make_train_step(jc, JAdamW(), schedule=lambda c: LR))
    tstep = TS.make_train_step(tc, TA.AdamWConfig(), schedule=lambda c: torch.tensor(LR))
    toks = TokenPipeline(TokenPipelineConfig(vocab=tc.vocab, seq_len=16, global_batch=2)
                         ).batch_at(0)["tokens"]
    fr = _frames(tc, 2, seed=4)
    before = [p.clone() for p in tree_leaves(tstate["params"])]
    jstate, jm = jstep(jstate, _jbatch(toks, fr))
    out, tm = tstep(tstate, _tbatch(toks, fr))
    assert out is tstate
    for k in ("loss", "nll", "grad_norm"):
        assert _rel(tm[k], jm[k]) <= TOL_GRAD, k
    for p, o, w in zip(tree_leaves(tstate["params"]), before, jax.tree.leaves(jstate["params"])):
        du = (p - o).numpy() - (np.asarray(w) - o.numpy())
        assert float(np.abs(du).max()) <= 0.05 * LR


@pytest.mark.parametrize("s", [23, 37])
def test_flash_attention_op_without_the_causal_mask(s):
    """``dispatch.flash_attention(causal=False)`` on ``cuda`` with CPU
    tensors at a ragged S: the Function's forward (the kernel's plain
    version) within TOL of the transcription ``attention_scores(causal=
    False)``, its backward (the backward kernel's closed form,
    ``flash_attention_gqa_bwd_plain``, from the forward's output and lse)
    bit-equal to that closed form and within TOL of autograd through the
    transcription, and different from the causal one's."""
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(2, s, h, 16, generator=g) for h in (4, 2, 2))
    dout = torch.randn(2, s, 4, 16, generator=g)

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ins)
        out.backward(dout)
        return out.detach(), [t.grad for t in ins]

    want, wgrads = run(lambda *a: L.attention_scores(*a, causal=False))
    got, grads = run(lambda *a: td.flash_attention(*a, causal=False, backend="cuda"))
    assert _rel(got, want) <= TOL
    o, lse = tfa.flash_attention_gqa_plain(q, k, v, with_lse=True, causal=False)
    closed = tfa.flash_attention_gqa_bwd_plain(q, k, v, o, lse, dout, causal=False)
    for a, b, w in zip(grads, closed, wgrads):
        assert torch.equal(a, b) and _rel(a, w) <= TOL
    causal, cgrads = run(lambda *a: td.flash_attention(*a, causal=True, backend="cuda"))
    assert _rel(causal, want) > 1e-2 and _rel(cgrads[1], wgrads[1]) > 1e-2
    assert torch.equal(td.flash_attention(q, k, v, causal=False, backend="ref"), want)


def test_kernels_reached_on_both_stacks_and_not_in_decode(monkeypatch):
    """On ``cuda`` a prefill makes one flash attention call an encoder layer
    (bidirectional) and one a decoder layer (causal); a decode step makes
    none."""
    _, _, tc, tp = _models()
    calls = []
    orig = td.flash_attention
    monkeypatch.setattr(td, "flash_attention",
                        lambda *a, **kw: (calls.append(kw.get("causal", True)),
                                          orig(*a, **kw))[1])
    _, cache = TW.prefill(tp, _tbatch(_tokens(tc, (1, 9)), _frames(tc, 1)), tc,
                          backend="cuda")
    assert calls == [False] * tc.n_encoder_layers + [True] * tc.n_layers
    calls.clear()
    full = TE._splice_cache(TW.init_cache(tc, 1, 16, "cpu"), cache)
    TW.decode_step(tp, full, torch.tensor([[3]]), tc, backend="cuda")
    assert calls == []


def test_splice_copies_cross_kv_whole_and_kv_by_prompt():
    """``_splice_cache``: the cross k and v replace the slot's whole, by
    name; the self-attention k and v fill the prompt's positions and leave
    the rest."""
    _, _, tc, tp = _models()
    full = TW.init_cache(tc, 1, 24, "cpu")
    for k in ("k", "v", "cross_k", "cross_v"):
        full[k].fill_(7.0)
    _, pre = TW.prefill(tp, _tbatch(_tokens(tc, (1, 13)), _frames(tc, 1)), tc)
    out = TE._splice_cache(full, pre)
    assert out is full and out["len"] == 13
    assert "cross_k" in TE._WHOLE_LEAVES and "cross_v" in TE._WHOLE_LEAVES
    for k in ("cross_k", "cross_v"):
        assert torch.equal(out[k], pre[k])
    for k in ("k", "v"):
        assert torch.equal(out[k][:, :, :13], pre[k]) and bool((out[k][:, :, 13:] == 7).all())


@pytest.mark.parametrize("lengths", [(9, 9), (9, 5, 14, 7)], ids=["stacked", "ragged"])
def test_engine_matches_jax(lengths):
    """The port's ``ServeEngine`` against the JAX package's, greedy in fp32,
    token for token (both prefill on zero frames): two equal prompts
    decode stacked; four ragged ones pass through two slots, each prefill
    spliced into a slot that held a prompt of another length."""
    jc, jp, tc, tp = _models()
    prompts = [_tokens(jc, (n,), seed=i) for i, n in enumerate(lengths)]
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    JEngine(jc, jp, n_slots=2, max_seq=32).run_to_completion(jr)
    ServeEngine(tc, tp, kernel_backend="cuda", n_slots=2, max_seq=32).run_to_completion(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and len(r.out_tokens) == 5 for r in tr)


def test_launchers_and_examples_serve_whisper_and_refuse_token_training(tmp_path, capsys):
    """The serving launcher and example serve whisper; the training
    launcher and example refuse it before building any state: the token
    pipeline yields no frames (ROADMAP R6)."""
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--slots", "2",
                      "--max-new", "4"])
    assert out["tokens"] == 12
    assert "whisper-smoke (encdec cache): 3 requests" in capsys.readouterr().out
    serve_lm.main(["--arch", ARCH, "--requests", "2", "--max-new", "3", "--device", "cpu"])
    assert "all requests complete" in capsys.readouterr().out
    for main, argv in ((train.main, ["--ckpt-dir", str(tmp_path / "ck")]),
                       (train_lm.main, ["--ckpt-dir", str(tmp_path / "ex")])):
        with pytest.raises(ValueError, match="R6"):
            main(["--arch", ARCH, "--device", "cpu", "--steps", "2", *argv])
    assert not (tmp_path / "ck").exists() and not (tmp_path / "ex").exists()
