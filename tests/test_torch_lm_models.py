"""The port's dense GQA transformers against the JAX package's, on the CPU.

Every config of ``repro_torch.configs`` equals the JAX package's field for
field.  For the five dense GQA smoke configs, ``prefill`` (last logits and
the cache) and three ``decode_step``s run on the JAX model's weights
(``bridge.lm_params_from_numpy``) and the same numpy tokens.  Logits are
compared over the true vocab (the padded entries are -1e30 in both),
relative to max|logit|:

* fp32 compute: within 1e-5 (observed <= 1e-6: sums in other orders);
* bf16 compute: within 4e-2.  Both packages round to bf16 after each op,
  but XLA's fusions keep some intermediates in f32 (a residual update, the
  rope's products) where eager PyTorch rounds each op's output: about ten
  bf16 roundings (2^-8 = 3.9e-3 each) apart over two layers (observed up
  to 1.4e-2).  The caches are held to max|k| the same way, at 1e-5 and
  4e-2.

The ``cuda`` backend on CPU tensors runs the flash attention kernel's plain
version (no rounding of P) in place of the transcription of the JAX
attention (P rounded to v's dtype): in fp32 they agree within 1e-5 of
max|logit|; in bf16 within the bf16 tolerance above.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.bridge import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.common.init import lecun_normal, normal_init
from repro_torch.common.tree import tree_leaves, tree_paths
from repro_torch.configs import registry as treg
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_api

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

DENSE = ["minitron-4b", "gemma2-2b", "minicpm-2b", "qwen2-72b", "phi-3-vision-4.2b"]
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
PROMPT = 40          # past gemma2-smoke's window of 32
MAX_SEQ = 64


@functools.lru_cache(maxsize=None)
def _models(arch, dtype):
    jc = dataclasses.replace(jreg.get_smoke_config(arch), compute_dtype=dtype)
    tc = dataclasses.replace(treg.get_smoke_config(arch), compute_dtype=dtype)
    jp = JT.init_transformer(jax.random.key(0), jc)
    return jc, jp, tc, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed=0, s=PROMPT):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(1, s)).astype(np.int32)
    jb, tb = dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(toks).long())
    if cfg.frontend is not None:
        fe = rng.standard_normal((1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        jb["frontend_embeds"], tb["frontend_embeds"] = jnp.asarray(fe), torch.from_numpy(fe)
    return jb, tb


def _rel(got, want, vocab=None) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_equal_jax(arch):
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.LONG_CONTEXT_OK == jreg.LONG_CONTEXT_OK
    for get in ("get_config", "get_smoke_config"):
        tc, jc = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        for t, j in ((tc, jc), (tc.attention, jc.attention), (tc.moe, jc.moe),
                     (tc.ssm, jc.ssm)):
            assert type(t).__name__ == type(j).__name__
            if t is not None:
                assert [f.name for f in dataclasses.fields(t)] == \
                    [f.name for f in dataclasses.fields(j)]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.vocab_padded == jc.vocab_padded


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, dtype):
    jc, jp, tc, tp = _models(arch, dtype)
    jb, tb = _batch(jc)
    jl, jcache = JT.prefill(jp, jb, jc)
    tl, tcache = TT.prefill(tp, tb, tc, backend="ref")
    assert tl.shape == (1, jc.vocab_padded) and tl.dtype == torch.float32
    assert bool((tl[:, jc.vocab:] == -1e30).all())
    assert _rel(tl, jl, jc.vocab) <= TOL[dtype]
    assert tcache["len"] == int(jcache["len"]) == PROMPT + (jc.n_frontend_tokens
                                                             if jc.frontend else 0)
    for kv in ("k", "v"):
        assert tcache[kv].dtype == getattr(torch, dtype)
        assert tuple(tcache[kv].shape) == jcache[kv].shape
        assert _rel(tcache[kv], jcache[kv]) <= TOL[dtype]

    # three decode steps from the prefill spliced into a MAX_SEQ cache
    jfull = JT.init_cache(jc, 1, MAX_SEQ)
    jfull = dict(len=jcache["len"], **{kv: jax.lax.dynamic_update_slice(
        jfull[kv], jcache[kv], (0,) * 5) for kv in ("k", "v")})
    tfull = lm_cache_from_numpy(jax.tree.map(np.asarray, jfull), "cpu")
    for tok in (5, 17, 3):
        jl, jfull = JT.decode_step(jp, jfull, jnp.asarray([[tok]], jnp.int32), jc)
        tl, tfull = TT.decode_step(tp, tfull, torch.tensor([[tok]]), tc)
        assert _rel(tl, jl, jc.vocab) <= TOL[dtype]
    assert tfull["len"] == int(jfull["len"])
    assert _rel(tfull["k"], jfull["k"]) <= TOL[dtype]


@pytest.mark.parametrize("arch", DENSE)
def test_cuda_backend_on_cpu_matches_ref(arch):
    """The kernel path's arithmetic (the plain flash attention) against the
    transcription, on every prefill layer."""
    for dtype in ("float32", "bfloat16"):
        jc, _, tc, tp = _models(arch, dtype)
        _, tb = _batch(jc, seed=1)
        want, wc = TT.prefill(tp, tb, tc, backend="ref")
        got, gc = TT.prefill(tp, tb, tc, backend="cuda")
        assert _rel(got, want, jc.vocab) <= TOL[dtype]
        # layer 0's k and v come before any attention: equal bits
        assert torch.equal(gc["k"][0], wc["k"][0]) and torch.equal(gc["v"][0], wc["v"][0])


def test_trunk_matches_jax():
    jc, jp, tc, tp = _models("gemma2-2b", "float32")
    jb, tb = _batch(jc)
    jx = JT.embed_inputs(jp, jb, jc)
    tx = TT.embed_inputs(tp, tb, tc)
    assert _rel(tx, jx) <= TOL["float32"]
    jh, jaux = JT.trunk(jp, jx, jc)
    th, taux = TT.trunk(tp, tx, tc)
    assert _rel(th, jh) <= TOL["float32"] and float(taux) == float(jaux) == 0.0
    assert _rel(TT.logits_head(tp, th, tc), JT.logits_head(jp, jh, jc), jc.vocab) <= \
        TOL["float32"]
    assert TT.layer_windows(tc) == [int(w) for w in JT.layer_windows(jc)]


@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_matches_jax_layout(arch):
    """Random port params have the JAX tree's paths, shapes and dtypes, and
    the compute cast touches only the layers' matmul weights and biases."""
    jc, jp, tc, _ = _models(arch, "bfloat16")
    tp = get_api(tc).init(torch.Generator().manual_seed(0), tc)
    jpaths = tree_paths(jax.tree.map(np.asarray, jp))
    tpaths = tree_paths(tp)
    assert sorted(jpaths) == sorted(tpaths)
    for k, a in jpaths.items():
        assert tuple(tpaths[k].shape) == a.shape and tpaths[k].dtype == torch.float32, k
    cast = tree_paths(TT.compute_params(tp, tc))
    for k, t in cast.items():
        want = torch.bfloat16 if k.startswith(("layers/attn/", "layers/ffn/")) \
            else torch.float32
        assert t.dtype == want, k


def test_init_cpu_draws_unchanged_and_device_default():
    """A CPU generator's draws are the ones it always gave (existing seeds
    do not move), wherever the result goes; they land on the generator's
    device unless one is named."""
    g = torch.Generator().manual_seed(7)
    want = 0.5 * torch.randn((3, 4), generator=g)
    g = torch.Generator().manual_seed(7)
    got = normal_init(g, (3, 4), 0.5)
    assert torch.equal(got, want) and got.device.type == "cpu"
    g = torch.Generator().manual_seed(7)
    assert torch.equal(lecun_normal(g, (3, 4), 4, device="cpu"), want)


def test_compute_params_is_the_per_call_cast():
    """Casting the weights once gives the per-call cast's logits, bit for
    bit."""
    jc, _, tc, tp = _models("qwen2-72b", "bfloat16")
    _, tb = _batch(jc)
    a, _ = TT.prefill(tp, tb, tc, backend="ref")
    b, _ = TT.prefill(TT.compute_params(tp, tc), tb, tc, backend="ref")
    assert torch.equal(a, b)


def test_decode_writes_the_cache_in_place():
    jc, _, tc, tp = _models("minitron-4b", "float32")
    cache = TT.init_cache(tc, 2, 8, "cpu")
    k0 = cache["k"]
    _, new = TT.decode_step(tp, cache, torch.tensor([[1], [2]]), tc)
    assert new["k"] is k0 and new["len"] == 1 and cache["len"] == 0
    assert bool(k0[:, :, 0].abs().sum() > 0) and bool((k0[:, :, 1:] == 0).all())
    full = TT.init_cache(tc, 1, 2, "cpu")
    full["len"] = 2
    with pytest.raises(ValueError, match="full"):
        TT.decode_step(tp, full, torch.tensor([[1]]), tc)


def test_attention_window_and_softcap_mask():
    """The transcription's window rule (q - k < window) and softcap, against
    the flash kernel's plain version on (BH, S, D) with one head."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 20, 1, 8, generator=g) for _ in range(3))
    for window, cap in ((None, None), (5, None), (5, 30.0), (100, 50.0)):
        got = L.attention_scores(q, k, v, causal=True, window=window, cap=cap)
        want = L.causal_attention(q, k, v, window=window, cap=cap, backend="cuda")
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_unported_families_raise_naming_their_item(arch):
    """The last family to be ported (whisper, A14d) now builds and runs one
    prefill on random frames: finite logits over the padded vocab and a
    cache of the prompt's positions and the encoder's frames."""
    from repro_torch.models import whisper as TW
    cfg = treg.get_smoke_config(arch)
    api = get_api(cfg)
    assert api.prefill is TW.prefill
    params = api.init(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    batch = dict(tokens=torch.randint(0, cfg.vocab, (2, 5), generator=g),
                 frontend_embeds=torch.randn(2, cfg.n_frontend_tokens, cfg.d_model,
                                             generator=g))
    logits, cache = api.prefill(params, batch, cfg)
    assert logits.shape == (2, cfg.vocab_padded) and bool(logits[:, :cfg.vocab].isfinite().all())
    assert cache["len"] == 5 and cache["k"].shape[2] == 5
    assert cache["cross_k"].shape[2] == cfg.n_frontend_tokens


def test_params_cross_with_their_leaves():
    jc, jp, _, tp = _models("minicpm-2b", "float32")
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    assert len(tree_leaves(tp)) == len(jl)
    for k, a in tree_paths(jax.tree.map(np.asarray, jp)).items():
        assert np.array_equal(tree_paths(tp)[k].numpy(), a), k
