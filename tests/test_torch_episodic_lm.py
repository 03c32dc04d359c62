"""The episodic LM path of the port against the JAX package's, on the CPU:
LITE meta-training of ProtoNets and Simple CNAPs over a dense GQA
transformer (minitron-smoke: 2 layers, d_model 64, 8 / 2 heads of 16,
vocab 256), its pieces, and the example.

The same numpy tokens (the JAX package's own token tasks) and the same
weights (``bridge.learner_params_from_numpy``) go into both packages; the
H subsets are the JAX package's own ``_index_scores(key, N)``, passed in as
the port's ``scores``.  Tasks are 4-way, 6 shot, 4 queries a class, 32
tokens, at concentration 1.0 (at the JAX test's 0.3 every task is solved
and Simple CNAPs' loss is 2e-5, which would test nothing).  Tolerances:

* fp32 compute (``compute_dtype="float32"``): forward values (hidden
  states, features, set encodings, logits, losses) within TOL_FWD = 1e-5
  of their max|reference|; gradients within TOL_GRAD = 1e-4 of each leaf's
  max|reference| (measured: losses at most 5.9e-7, gradients at most
  5.9e-6, on both port backends; sums in other orders).
* bf16 compute, one case (ProtoNets, h 6): TOL_BF16 = 4e-2, the bf16
  tolerance of test_torch_lm_models.py (measured: loss 2.6e-3, gradients
  2.0e-2).  Eager PyTorch
  rounds every op's output to bf16 where XLA's fusions keep some in f32.
  (Simple CNAPs' gradients in bf16 differed by up to 0.4 of a leaf's max
  at concentration 0.3: the E[xx^T] - mu mu^T cancellation amplifies bf16
  features' rounding, so its bf16 case is held on the card, against an
  fp32 run.)
* token histograms bit-equal; the example's step bit-equal to the
  zero-filled step; ``remat_policy="nothing"`` bit-equal to ``"none"``;
  B5's op's backward bit-equal to autograd through the transcription.

Both port backends run: ``ref`` (the transcription of the JAX attention)
and ``cuda`` on CPU tensors (the kernels' plain versions inside their
autograd Functions, flash attention's backward the VJP of the
transcription).  A leaf the loss does not reach (the CNAPs backbone,
ProtoNets' unused LM head) gets no gradient in the port and a zero one in
the JAX package.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.registry import get_smoke_config as j_smoke
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import _index_scores
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.core.set_encoder import encode_set as j_encode
from repro.core.set_encoder import init_set_encoder as j_init_enc
from repro.data.episodic import EpisodicTokenConfig as JTokCfg
from repro.data.episodic import sample_token_task as j_sample
from repro.models import transformer as JT
from repro.models.lm_backbone import make_lm_backbone as j_lm_bb
from repro_torch.bridge import (learner_params_from_numpy, learner_params_to_numpy,
                                lm_params_from_numpy, params_from_numpy)
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import make_batched_meta_grads, make_reached_meta_grads
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import (SetEncoderConfig, encode_set,
                                          init_set_encoder, token_histogram)
from repro_torch.data.episodic import (EpisodicTokenConfig, sample_token_task,
                                       token_task_batch_at)
from repro_torch.examples.episodic_lm import heldout_accuracy, main, make_meta_step
from repro_torch.kernels import dispatch as td
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.lm_backbone import make_lm_backbone
from repro_torch.optim.clip import clip_by_global_norm

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCH = "minitron-4b"
TOL_FWD = 1e-5
TOL_GRAD = 1e-4
TOL_BF16 = 4e-2
TASK = dict(way=4, shot=6, query_per_class=4, seq_len=32, concentration=1.0)
SPECS = [dict(exact=True), dict(h=6), dict(h=6, chunk_size=5)]
SPEC_IDS = ["exact", "h6", "h6-chunk5"]
BACKENDS = ["ref", "cuda"]
SET_KW = dict(kind="tokens", task_dim=32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_smoke(ARCH), compute_dtype=dtype),
            dataclasses.replace(t_smoke(ARCH), compute_dtype=dtype))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _task():
    """The JAX package's token task (seed 3) and the same task as a port
    TaskBatch of one task, all-ones masks."""
    jc, _ = _cfgs()
    task = j_sample(jax.random.key(3), JTokCfg(vocab=jc.vocab, **TASK))
    arrays = [np.asarray(getattr(task, k)) for k in ("support_x", "support_y",
                                                      "query_x", "query_y")]
    ones = lambda y: np.ones((1,) + y.shape, np.float32)  # noqa: E731
    tb = TaskBatch(*(a[None] for a in arrays), support_mask=ones(arrays[1]),
                   query_mask=ones(arrays[3]), way=TASK["way"]).to("cpu")
    return task, tb


def _learners(kind, dtype="float32"):
    jc, tc = _cfgs(dtype)
    set_kw = dict(SET_KW, in_channels=jc.vocab)
    jl = j_make(JCfg(kind=kind, way=TASK["way"]), j_lm_bb(jc), JSetCfg(**set_kw))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=TASK["way"]), make_lm_backbone(tc),
                      SetEncoderConfig(**set_kw))
    return jl, tl


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(kind, spec_items, dtype):
    """The JAX package's meta-loss, accuracy and gradients on its task,
    key 0 (computed once per case; both port backends are held to it)."""
    jl, _ = _learners(kind, dtype)
    jp = jl.init(jax.random.key(1))
    task, _ = _task()
    spec = JLite(**dict(spec_items))
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p: jl.meta_loss(p, task, jax.random.key(0), spec), has_aux=True))(jp)
    return (jax.tree.map(np.asarray, jp), float(loss), float(aux["accuracy"]),
            tree_paths(jax.tree.map(np.asarray, g)))


def _port_loss_and_grads(kind, spec, dtype, backend):
    jp, *_ = _jax_loss_and_grads(kind, tuple(sorted(spec.items())), dtype)
    _, tl = _learners(kind, dtype)
    tp = learner_params_from_numpy(jp, "cpu")
    _, tb = _task()
    scores = torch.from_numpy(np.array(_index_scores(jax.random.key(0),
                                                     tb.support_y.shape[1])))[None]
    with td.use_backend(backend):
        loss, acc, grads = make_reached_meta_grads(tl, LiteSpec(**spec))(tp, tb, scores)
    return float(loss), float(acc), dict(zip(tree_paths(tp), grads))


def _grad_errs(tg, jg):
    """Per-leaf errors over each leaf's max|reference|; a leaf the port does
    not reach must be zero in the reference."""
    assert tg.keys() == jg.keys()
    errs = {}
    for k, b in jg.items():
        if tg[k] is None:
            assert float(np.abs(b).max()) == 0.0, f"{k}: reached in the reference"
        else:
            errs[k] = _rel(tg[k], b)
    return errs


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tokens", "mlp"])
def test_set_encoder_matches_jax(kind):
    """The ``tokens`` and ``mlp`` kinds: the same tree shapes, bit-equal
    histograms, encodings within TOL_FWD."""
    in_ch = 256 if kind == "tokens" else 48
    cfg_kw = dict(kind=kind, in_channels=in_ch, task_dim=16, mlp_hidden=32)
    jp = j_init_enc(jax.random.key(0), JSetCfg(**cfg_kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    own = init_set_encoder(torch.Generator().manual_seed(0), SetEncoderConfig(**cfg_kw))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    rng = np.random.default_rng(0)
    if kind == "tokens":
        x = rng.integers(0, in_ch, size=(6, 40)).astype(np.int32)
        hist = token_histogram(torch.from_numpy(x).long(), in_ch)
        want = np.asarray(jnp.mean(jax.nn.one_hot(x, in_ch, dtype=jnp.float32), axis=1))
        assert np.array_equal(hist.numpy(), want)
        tx = torch.from_numpy(x).long()
    else:
        x = rng.standard_normal((6, in_ch)).astype(np.float32)
        tx = torch.from_numpy(x)
    got = encode_set(tp, tx, SetEncoderConfig(**cfg_kw))
    assert _rel(got, j_encode(jp, jnp.asarray(x), JSetCfg(**cfg_kw))) <= TOL_FWD


@functools.lru_cache(maxsize=None)
def _lm_params(dtype="float32"):
    jc, _ = _cfgs(dtype)
    jp = JT.init_transformer(jax.random.key(0), jc)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _film(rng, lead):
    jc, _ = _cfgs()
    f = lambda: (0.1 * rng.standard_normal(lead + (jc.d_model,))).astype(np.float32)  # noqa: E731
    return dict(gamma=f(), beta=f())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("per_task", [False, True], ids=["film-LD", "film-LTD"])
def test_trunk_with_film_matches_jax(per_task, backend):
    """``trunk(film=)`` with one (L, D) FiLM for every row, and with a
    (L, T, D) FiLM for T = 2 tasks of 2 rows each (the JAX trunk run per
    task on its rows)."""
    jc, tc = _cfgs()
    jp, tp = _lm_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 24, jc.d_model)).astype(np.float32)
    film = _film(rng, (jc.n_layers, 2) if per_task else (jc.n_layers,))
    if per_task:
        want = np.concatenate([np.asarray(JT.trunk(
            jp, jnp.asarray(x[2 * t:2 * t + 2]), jc,
            {k: jnp.asarray(v[:, t]) for k, v in film.items()})[0]) for t in range(2)])
    else:
        want = np.asarray(JT.trunk(jp, jnp.asarray(x), jc,
                                   {k: jnp.asarray(v) for k, v in film.items()})[0])
    with td.use_backend(backend):
        got, aux = TT.trunk(tp, torch.from_numpy(x), tc, backend=None,
                            film={k: torch.from_numpy(v) for k, v in film.items()})
    assert float(aux) == 0.0
    assert _rel(got, want) <= TOL_FWD


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_backbone_features_match_jax(dtype):
    """Features (embedding x embed_scale, trunk with per-layer FiLM, mean
    over S in fp32), with a FiLM list and without."""
    jc, tc = _cfgs(dtype)
    jbb, tbb = j_lm_bb(jc), make_lm_backbone(tc)
    assert tbb.feature_dim == jbb.feature_dim and tuple(tbb.film_sites) == tuple(jbb.film_sites)
    jp, tp = _lm_params(dtype)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jc.vocab, size=(3, 20)).astype(np.int32)
    film = [_film(rng, ()) for _ in range(jc.n_layers)]
    tol = TOL_FWD if dtype == "float32" else TOL_BF16
    for f in (None, film):
        want = jbb.features(jp, jnp.asarray(toks), None if f is None else [
            {k: jnp.asarray(v) for k, v in s.items()} for s in f])
        got = tbb.features(tp, torch.from_numpy(toks).long(), None if f is None else [
            {k: torch.from_numpy(v) for k, v in s.items()} for s in f])
        assert got.dtype == torch.float32 and got.shape == (3, jc.d_model)
        assert _rel(got, want) <= tol


def test_mamba2_backbone_raises_naming_a14c():
    """The mamba2 backbone once raised here, naming A14c; it now builds and
    its features (final-state FiLM at the per-layer mean) match the JAX
    package's on both backends, with a FiLM list and without."""
    jc = dataclasses.replace(j_smoke("mamba2-780m"), compute_dtype="float32")
    tc = dataclasses.replace(t_smoke("mamba2-780m"), compute_dtype="float32")
    jbb, tbb = j_lm_bb(jc), make_lm_backbone(tc)
    assert tbb.feature_dim == jbb.feature_dim and tuple(tbb.film_sites) == tuple(jbb.film_sites)
    jp = jbb.init(jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jc.vocab, size=(3, 20)).astype(np.int32)
    film = [_film(rng, ()) for _ in range(jc.n_layers)]
    for f in (None, film):
        want = jbb.features(jp, jnp.asarray(toks), None if f is None else [
            {k: jnp.asarray(v) for k, v in s.items()} for s in f])
        for backend in BACKENDS:
            with td.use_backend(backend):
                got = tbb.features(tp, torch.from_numpy(toks).long(), None if f is None else [
                    {k: torch.from_numpy(v) for k, v in s.items()} for s in f])
            assert got.dtype == torch.float32 and got.shape == (3, jc.d_model)
            assert _rel(got, want) <= TOL_FWD


# ---------------------------------------------------------------------------
# B5's autograd Function and rematerialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,cap", [(None, None), (8, None), (8, 5.0)])
def test_flash_attention_op_forward_and_backward(window, cap):
    """``dispatch.flash_attention`` on ``cuda`` with CPU tensors: the
    Function's forward (the kernel's plain version) within TOL_FWD of the
    transcription, its backward (the backward kernel's closed form,
    ``flash_attention_gqa_bwd_plain``, from the forward's output and lse)
    bit-equal to that closed form and within TOL_FWD of autograd through the
    transcription; a tensor that needs no gradient gets none."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 24, h, 16, generator=g) for h in (4, 2, 2))
    dout = torch.randn(2, 24, 4, 16, generator=g)

    def run(fn, need=(True, True, True)):
        ins = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), need)]
        out = fn(*ins)
        out.backward(dout)
        return out.detach(), [t.grad for t in ins]

    want, wgrads = run(lambda *a: L.attention_scores(*a, causal=True, window=window, cap=cap))
    got, grads = run(lambda *a: td.flash_attention(*a, window=window, softcap=cap,
                                                   backend="cuda"))
    assert _rel(got, want) <= TOL_FWD
    kw = dict(causal=True, window=window, softcap=cap)
    o, lse = tfa.flash_attention_gqa_plain(q, k, v, with_lse=True, **kw)
    closed = tfa.flash_attention_gqa_bwd_plain(q, k, v, o, lse, dout, **kw)
    for a, b, w in zip(grads, closed, wgrads):
        assert torch.equal(a, b) and _rel(a, w) <= TOL_FWD
    _, part = run(lambda *a: td.flash_attention(*a, window=window, softcap=cap,
                                                backend="cuda"), (False, True, False))
    assert part[0] is None and part[2] is None and torch.equal(part[1], closed[1])
    ref = td.flash_attention(q, k, v, window=window, softcap=cap, backend="ref")
    assert torch.equal(ref, L.attention_scores(q, k, v, causal=True, window=window, cap=cap))


def _trunk_grads(policy, monkeypatch):
    """Gradients of a fixed functional of the trunk's output with respect to
    FiLM, the input and every weight it reads, on ``cuda`` (CPU tensors), with the
    number of flash attention forwards it ran."""
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, remat_policy=policy)
    _, tp = _lm_params()
    calls = []
    orig = tfa.flash_attention_gqa
    monkeypatch.setattr(tfa, "flash_attention_gqa",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 16, tc.d_model)).astype(np.float32))
    film = {k: torch.from_numpy(v) for k, v in _film(rng, (tc.n_layers, 2)).items()}
    trunk_params = {k: tp[k] for k in ("layers", "final_norm")}   # what trunk reads
    live = tree_map(lambda t: t.detach().requires_grad_(True), (trunk_params, x, film))
    with td.use_backend("cuda"):
        h, _ = TT.trunk(live[0], live[1], tc, backend=None, film=live[2])
    (h * torch.linspace(-1, 1, h.shape[-1])).sum().backward()
    return [t.grad for t in tree_leaves(live)], len(calls)


def test_remat_nothing_matches_none(monkeypatch):
    """``remat_policy="nothing"`` checkpoints each block, and ``"dots"``
    does so keeping the weight matmuls' outputs: the same gradients bit
    for bit as ``"none"``, and the recompute runs the Function's forward
    (the kernel on the card) once more a layer under either."""
    n_layers = _cfgs()[1].n_layers
    g_none, calls_none = _trunk_grads("none", monkeypatch)
    assert calls_none == n_layers
    for policy in ("nothing", "dots"):
        g_remat, calls_remat = _trunk_grads(policy, monkeypatch)
        assert calls_remat == 2 * n_layers
        for a, b in zip(g_remat, g_none):
            assert a is not None and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the learners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
def test_meta_loss_and_gradients_match_jax(kind, spec, backend):
    """``test_system``'s three LiteSpecs, in fp32 compute: the loss, the
    accuracy and every leaf's gradient; the CNAPs backbone gets none."""
    _, jloss, jacc, jgrads = _jax_loss_and_grads(kind, tuple(sorted(spec.items())),
                                                 "float32")
    loss, acc, grads = _port_loss_and_grads(kind, spec, "float32", backend)
    assert abs(loss - jloss) <= TOL_FWD * abs(jloss)
    assert acc == pytest.approx(jacc, abs=1e-6)
    errs = _grad_errs(grads, jgrads)
    assert max(errs.values()) <= TOL_GRAD
    if kind == "simple_cnaps":
        assert all(g is None for k, g in grads.items() if k.startswith("bb/"))
        assert all(g is not None for k, g in grads.items()
                   if k.startswith(("enc/", "film_gen/")))


@pytest.mark.parametrize("backend", BACKENDS)
def test_meta_loss_bf16_matches_jax(backend):
    """One case in the configs' own bf16 compute: ProtoNets, h 6."""
    spec = dict(h=6)
    _, jloss, _, jgrads = _jax_loss_and_grads("protonets", tuple(spec.items()), "bfloat16")
    loss, _, grads = _port_loss_and_grads("protonets", spec, "bfloat16", backend)
    assert abs(loss - jloss) <= TOL_BF16 * abs(jloss)
    assert max(_grad_errs(grads, jgrads).values()) <= TOL_BF16


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
def test_adapt_and_predict_match_jax(kind, backend):
    """Adaptation (forward-only, exact) and query logits, relative to
    max|logit|; the ``cuda`` Simple CNAPs head runs on the explicit
    inverse, ``ref`` and the JAX package on Cholesky solves."""
    jp, *_ = _jax_loss_and_grads(kind, (("exact", True),), "float32")
    jl, tl = _learners(kind)
    task, tb = _task()
    jparams = jax.tree.map(jnp.asarray, jp)
    want = jl.predict(jparams, jl.adapt(jparams, task.support_x, task.support_y),
                      task.query_x)
    with td.use_backend(backend):
        logits, acc = heldout_accuracy(tl, learner_params_from_numpy(jp, "cpu"), tb)
    assert _rel(logits[0], want) <= TOL_FWD
    assert float(acc) == pytest.approx(
        float(jnp.mean(jnp.argmax(want, -1) == task.query_y)), abs=1e-6)


@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
def test_example_step_leaves_unreached_leaves_untouched(kind):
    """The example's step (gradient over the reached leaves only) gives the
    zero-filled step's params bit for bit, and returns every unreached leaf
    as the same tensor."""
    _, tl = _learners(kind)
    params = tl.init(torch.Generator().manual_seed(0), "cpu")
    batch = token_task_batch_at(1, EpisodicTokenConfig(vocab=256, **TASK), 2, 0, "cpu")
    scores = torch.rand(2, batch.support_y.shape[1], generator=torch.Generator().manual_seed(1))
    lite = LiteSpec(h=6, chunk_size=5)
    new, loss, _ = make_meta_step(tl, lite)(params, batch, scores)
    zloss, _, zgrads = make_batched_meta_grads(tl, lite)(params, batch, scores)
    clipped, _ = clip_by_global_norm(zgrads, 10.0)
    want = tree_map(lambda p, g: p - 1e-3 * g, params, clipped)
    assert float(loss) == float(zloss)
    untouched = 0
    for p, a, b in zip(tree_leaves(params), tree_leaves(new), tree_leaves(want)):
        assert torch.equal(a, b)
        untouched += a is p
    n_bb = len(tree_leaves(params["bb"]))
    assert untouched == (n_bb if kind == "simple_cnaps" else 1)   # ProtoNets: lm_head


# ---------------------------------------------------------------------------
# data, bridge, example
# ---------------------------------------------------------------------------

def test_task_batch_to_keeps_token_ids_int64():
    """Integer inputs (token ids) stay integers on the device; images become
    float32 as before."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256000, size=(2, 5, 7)).astype(np.int32)
    ids[1, 0, 0] = 2 ** 24 + 1       # no float32 holds it
    y = np.zeros((2, 5), np.int32)
    ones = np.ones((2, 5), np.float32)
    tb = TaskBatch(ids, y, ids, y, ones, ones, way=5).to("cpu")
    assert tb.support_x.dtype == torch.int64 and tb.query_x.dtype == torch.int64
    assert np.array_equal(tb.support_x.numpy(), ids)
    imgs = rng.standard_normal((2, 5, 4, 4, 3))
    tb = TaskBatch(imgs, y, imgs, y, ones, ones, way=5).to("cpu")
    assert tb.support_x.dtype == torch.float32 and tb.support_y.dtype == torch.int64


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31), step=st.integers(0, 1000), t=st.integers(1, 3),
       way=st.integers(2, 5), shot=st.integers(1, 4), q=st.integers(1, 3),
       seq=st.integers(1, 12), vocab=st.integers(2, 300))
def test_token_sampler_contract(seed, step, t, way, shot, q, seq, vocab):
    """Shapes and int64 ids in [0, vocab); every class ``shot`` times in
    the support, in a permuted order over a batch; the queries class by
    class; all-ones masks; a pure function of (seed, step)."""
    cfg = EpisodicTokenConfig(way=way, shot=shot, query_per_class=q, seq_len=seq,
                              vocab=vocab)
    b = token_task_batch_at(seed, cfg, t, step, "cpu")
    assert b.support_x.shape == (t, way * shot, seq) and b.query_x.shape == (t, way * q, seq)
    for a in (b.support_x, b.query_x, b.support_y, b.query_y):
        assert a.dtype == torch.int64
    assert int(b.support_x.min()) >= 0 and int(b.support_x.max()) < vocab
    assert int(b.query_x.min()) >= 0 and int(b.query_x.max()) < vocab
    for i in range(t):
        assert torch.equal(torch.bincount(b.support_y[i], minlength=way),
                           torch.full((way,), shot))
        assert torch.equal(b.query_y[i], torch.arange(way).repeat_interleave(q))
    assert bool((b.support_mask == 1).all()) and bool((b.query_mask == 1).all())
    again = token_task_batch_at(seed, cfg, t, step, "cpu")
    for f in ("support_x", "support_y", "query_x", "query_y"):
        assert torch.equal(getattr(b, f), getattr(again, f))


def test_token_sampler_classes_and_steps_differ():
    """Class unigrams are distinct (each class's tokens closer to its own
    distribution than to another's), the support is permuted, and the next
    step draws other tasks."""
    cfg = EpisodicTokenConfig(way=5, shot=8, query_per_class=8, seq_len=64, vocab=256)
    b = token_task_batch_at(7, cfg, 2, 0, "cpu")
    for i in range(2):
        hist = lambda x: torch.stack([torch.bincount(r.flatten(), minlength=256)  # noqa: E731
                                      for r in x]).float()
        sx = b.support_x[i][torch.argsort(b.support_y[i], stable=True)]
        sup = hist(sx.reshape(5, -1)) / (8 * 64)
        qry = hist(b.query_x[i].reshape(5, -1)) / (8 * 64)
        dist = torch.cdist(qry, sup, p=1)                # (query class, support class)
        assert torch.equal(dist.argmin(dim=1), torch.arange(5))
        assert not torch.equal(b.support_y[i], b.support_y[i].sort().values)
    assert not torch.equal(b.support_x, token_task_batch_at(7, cfg, 2, 1, "cpu").support_x)
    one = sample_token_task(torch.Generator().manual_seed(0), cfg)
    assert one.support_x.shape == (40, 64) and one.query_y.shape == (40,)


def test_learner_params_cross_by_path():
    """A learner tree round-trips bit for bit; ``bb`` crosses as an LM tree
    (a 4-D leaf there, such as stacked experts, is not transposed), the
    rest as before (a 4-D leaf there is a conv weight, HWIO <-> OIHW)."""
    jl, _ = _learners("simple_cnaps")
    tree = jax.tree.map(np.asarray, jl.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    tree["bb"]["experts"] = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    tree["enc"]["conv"] = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    port = learner_params_from_numpy(tree, "cpu")
    assert tuple(port["bb"]["experts"].shape) == (2, 3, 4, 5)
    assert tuple(port["enc"]["conv"].shape) == (4, 2, 3, 3)
    back = learner_params_to_numpy(port)
    want, got = tree_paths(tree), tree_paths(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_example_runs_on_cpu():
    """``python -m repro_torch.examples.episodic_lm --device cpu --steps 2``
    exits 0 and prints the held-out accuracy."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.episodic_lm", "--device", "cpu",
         "--steps", "2"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "held-out episodic accuracy over minitron-smoke" in proc.stdout


def test_example_raises_without_a_card():
    """Without ``--device cpu`` the example needs a CUDA card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--steps", "1"])
