"""LM prefill and decode over a (data, model) mesh
(:mod:`repro_torch.sharding.serve`) on 4 gloo ranks on the CPU as (data 2,
model 2), held against the JAX package's one-device ``prefill`` and
``decode_step`` on the same weights (``bridge.lm_params_from_numpy``) and
tokens, fp32 compute, the smoke configs:

* gemma2-smoke (dense GQA, local / global windows, softcaps), its 2 kv
  heads taking the sequence path (the sequence over ``model``);
* the same with 16 kv heads (and 16 query heads), which takes the heads
  path (``cache_specs`` splits heads over model where 16 divides them);
* the same with a local window of 4, smaller than a cache block of 12
  positions, so that at positions 16-18 a rank's block is wholly masked on
  every local layer;
* deepseek-v2-smoke (MLA's latent cache over the sequence, MoE
  expert-parallel on each data shard's rows);
* mamba2-smoke (the SSM states by heads, the conv states by channels);
* zamba2-smoke (the mamba layers and each shared site's k and v);
* whisper-smoke (the self k and v and the cross k and v by sequence).

The batch of 4 rows splits 2 a data rank; the reference runs each data
shard's rows alone (the MoE capacity is a shard's, as under the mesh).
Prefill runs on the ``cuda`` backend (the kernels' plain versions on CPU
tensors: B5 on every GQA and whisper layer, B6 on every SSD chunk, B7 on
a rank's E/m experts).  Per rank:

* the logits after prefill and after each of 3 decode steps within TOL =
  1e-5 of the reference's max|logit| over the true vocab;
* each cache block after prefill and after the 3 steps within TOL of its
  leaf's max|.|, against the slice of the reference's cache under the
  reference's own sanitized ``cache_specs``;
* the payloads one prefill and one decode step hand their collectives
  equal to ``roofline.lm_serve_payloads``.

A planted fault (the first sequence block's partial dropped from the merge)
must fail the decode comparison.  Decoding from a mesh prefill's own cache,
which holds exactly S positions, raises as on one device.  The same launch
checks the sharded train step with ``model`` stripped from every spec and
the batch over every axis (``tp_enabled=False``, whisper-smoke), on this
mesh and on a (pod 2, data 1, model 2) one: its loss and first moment
equal the JAX package's one-device ``make_train_step`` on the whole batch.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.registry import get_api as j_get_api
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.sharding import rules as J
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.launch.local_ranks import run_ranks

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
B, S, MAX = 4, 16, 24
DECODE_TOKENS = (5, 17, 3)
SIZES = dict(data=2, model=2)
# name: (arch, config overrides, attention overrides)
CASES = {
    "gqa": ("gemma2-2b", {}, {}),
    "gqa_heads": ("gemma2-2b", {}, dict(n_heads=16, n_kv_heads=16)),
    "gqa_window": ("gemma2-2b", dict(sliding_window=4), {}),
    "mla_moe": ("deepseek-v2-236b", {}, {}),
    "mamba2": ("mamba2-780m", {}, {}),
    "zamba2": ("zamba2-7b", {}, {}),
    "whisper": ("whisper-base", {}, {}),
}


def _cfg(registry, name):
    arch, over, attn = CASES[name]
    cfg = registry.get_smoke_config(arch)
    if attn:
        over = dict(over, attention=dataclasses.replace(cfg.attention, **attn))
    return dataclasses.replace(cfg, compute_dtype="float32", **over)


RANK_CODE = r'''
import dataclasses, json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.common.tree import tree_paths
from repro_torch.configs import registry
from repro_torch.launch import collectives
from repro_torch.launch.mesh import init_distributed, make_mesh_for
from repro_torch.models import layers
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline import lm_serve_payloads
from repro_torch.sharding.ctx import use_mesh
from repro_torch.sharding.place import (gather_tree, place_lm_cache, place_lm_params,
                                        shard_tree, spec_paths)
from repro_torch.sharding.rules import tp_off_batch_axes
from repro_torch.train.step import lm_state_specs, make_train_step

inp = pickle.load(open(sys.argv[1], "rb"))
out_dir = sys.argv[2]
init_distributed("cpu", init_method=os.environ["RANKS_INIT_METHOD"])
rank = int(os.environ["RANK"])
mesh = make_mesh_for((2, 2), ("data", "model"))
arrays, info = {}, {}

def cfg_of(name):
    arch, over, attn = inp["cases"][name]
    cfg = registry.get_smoke_config(arch)
    if attn:
        over = dict(over, attention=dataclasses.replace(cfg.attention, **attn))
    return dataclasses.replace(cfg, compute_dtype="float32", **over)

def decode(api, params, cache, cfg, name, tag):
    for t, tok in enumerate(inp["decode_tokens"]):
        collectives.counter.reset()
        with use_mesh(mesh):
            logits, cache = api.decode_step(params, cache, torch.full((inp["B"], 1), tok), cfg)
        arrays[f"{name}/{tag}{t}/logits"] = logits.numpy()
    return cache

for name in inp["cases"]:
    cfg = cfg_of(name)
    api = get_api(cfg)
    params = place_lm_params(lm_params_from_numpy(inp["params"][name], "cpu"), mesh)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"][name].items()}
    collectives.counter.reset()
    with use_mesh(mesh):
        logits, cache = api.prefill(params, batch, cfg, backend="cuda")
    pre = collectives.counter.payload()
    arrays[f"{name}/prefill/logits"] = logits.numpy()
    for k, v in cache.items():
        if torch.is_tensor(v):
            arrays[f"{name}/prefill/{k}"] = v.numpy()
    full = None
    if inp["cases"][name][0] != "mamba2-780m":
        # the prefill's own cache holds exactly S positions: decode refuses it
        try:
            with use_mesh(mesh):
                api.decode_step(params, cache, torch.full((inp["B"], 1), 1), cfg)
        except ValueError as e:
            full = str(e)
    mc = decode(api, params, place_lm_cache(lm_cache_from_numpy(inp["spliced"][name], "cpu"),
                                            mesh), cfg, name, "decode")
    dec = collectives.counter.payload()
    for k, v in mc.items():
        if torch.is_tensor(v):
            arrays[f"{name}/decoded/{k}"] = v.numpy()
    info[name] = dict(
        len=[cache["len"], mc["len"]], full=full, prefill_payload=pre, decode_payload=dec,
        want_prefill=lm_serve_payloads(cfg, mesh.shape, inp["B"], inp["S"], "prefill"),
        want_decode=lm_serve_payloads(cfg, mesh.shape, inp["B"], inp["MAX"], "decode"),
        specs={k: repr(v) for k, v in mc["specs"].items()})
    if name == "gqa":
        # the planted fault: the first sequence block's partial dropped from the merge
        merge = layers.merge_partials
        def dropped(m, s, o, mesh_, axes):
            if axes and mesh_.index_of(axes) == 0:
                m, s, o = torch.full_like(m, float("-inf")), torch.zeros_like(s), \
                    torch.zeros_like(o)
            return merge(m, s, o, mesh_, axes)
        layers.merge_partials = dropped
        try:
            decode(api, params, place_lm_cache(lm_cache_from_numpy(inp["spliced"][name], "cpu"),
                                               mesh), cfg, name, "planted")
        finally:
            layers.merge_partials = merge

# the sharded train step with tp_enabled=False (whisper-smoke, the batch
# over every axis): on this (data, model) mesh and on a (pod, data, model)
# one, each from the reference's params placed under the stripped specs
cfg = cfg_of("whisper")
adam = AdamWConfig()
tbatch = {k: torch.from_numpy(v) for k, v in inp["batch"]["whisper"].items()}
for tag, m in (("tp_off", mesh), ("tp_off_pod", make_mesh_for((2, 1, 2),
                                                              ("pod", "data", "model")))):
    # the rule with tensor parallelism off (the smoke config keeps it on)
    bax = tp_off_batch_axes(False, inp["B"], m.shape)
    _, specs = lm_state_specs(cfg, adam, m, bax)
    p = lm_params_from_numpy(inp["params"]["whisper"], "cpu")
    sharded = shard_tree(dict(params=p, opt=adamw_init(p, adam)), specs, m)
    collectives.counter.reset()
    sharded, m2 = make_train_step(cfg, adam, schedule=lambda c: 1e-3, mesh=m,
                                  batch_axes=bax)(sharded, tbatch)
    mu = gather_tree(sharded["opt"]["mu"], specs["opt"]["mu"], m)
    info[tag] = dict(loss=float(m2["loss"]), batch_axes=list(bax),
                     keys=sorted(collectives.counter.payload()),
                     specs=sorted({repr(s) for s in spec_paths(specs["params"]).values()}))
    for k, v in tree_paths(mu).items():
        arrays[f"{tag}/mu/{k}"] = v.numpy()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
torch.distributed.destroy_process_group()
'''


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(name, params, batch):
    """The JAX package's prefill and 3 decode steps on each data shard's
    rows alone, stitched back along the batch: (prefill logits, prefill
    cache, [decode logits], decoded cache, the spliced cache decode starts
    from)."""
    cfg = _cfg(jreg, name)
    api = j_get_api(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    rows = B // SIZES["data"]
    out = []
    for i in range(SIZES["data"]):
        part = {k: jnp.asarray(v[i * rows:(i + 1) * rows]) for k, v in batch.items()}
        logits, cache = api.prefill(jp, part, cfg)
        full = api.init_cache(cfg, rows, MAX)
        spliced = {k: (v if k == "len" else
                       jax.lax.dynamic_update_slice(full[k], cache[k], (0,) * full[k].ndim))
                   for k, v in cache.items()}
        state, steps = spliced, []
        for tok in DECODE_TOKENS:
            step_logits, state = api.decode_step(jp, state, jnp.full((rows, 1), tok, jnp.int32),
                                                 cfg)
            steps.append(np.asarray(step_logits))
        out.append((np.asarray(logits), _np(cache), steps, _np(state), _np(spliced)))

    def cat(trees):
        return {k: (trees[0][k] if k == "len" else np.concatenate([t[k] for t in trees], 1))
                for k in trees[0]}
    return (np.concatenate([o[0] for o in out]), cat([o[1] for o in out]),
            [np.concatenate([o[2][t] for o in out]) for t in range(len(DECODE_TOKENS))],
            cat([o[3] for o in out]), cat([o[4] for o in out]))


def _tp_off_reference(params, batch):
    """The JAX package's one-device ``make_train_step`` on the whole batch
    (whisper-smoke, lr 1e-3, AdamW's defaults): (loss, {path: first
    moment})."""
    cfg = _cfg(jreg, "whisper")
    jp = jax.tree.map(jnp.asarray, params)
    adam = JAdamW()
    step = jax.jit(j_make_train_step(cfg, adam, schedule=lambda c: 1e-3))
    state, m = step(dict(params=jp, opt=j_adamw_init(jp, adam)),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    mu = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_flatten_with_path(state["opt"]["mu"])[0]}
    return float(m["loss"]), mu


class _Stub:
    def __init__(self, shape):
        self.shape = dict(shape)


def _block(a: np.ndarray, spec, coords) -> np.ndarray:
    """This rank's block of ``a`` under ``spec`` (numpy slicing, the first
    axis of an entry outermost)."""
    for d, entry in enumerate(spec):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n, i = 1, 0
        for nm in names:
            n, i = n * SIZES[nm], i * SIZES[nm] + coords[nm]
        if n > 1:
            step = a.shape[d] // n
            a = a[(slice(None),) * d + (slice(i * step, (i + 1) * step),)]
    return a


def _specs(cache):
    """The reference's sanitized cache specs of a cache (its own rules)."""
    cache = {k: v for k, v in cache.items() if k != "len"}
    return J.sanitize(J.cache_specs(cache, B, SIZES["data"]), cache, _Stub(SIZES))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_serve_mesh")
    rng = np.random.default_rng(0)
    params, batches, refs, spliced = {}, {}, {}, {}
    for name in CASES:
        cfg = _cfg(jreg, name)
        params[name] = _np(j_get_api(cfg).init(jax.random.key(1), cfg))
        batch = dict(tokens=rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int64))
        if cfg.family == "encdec":
            batch["frontend_embeds"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        batches[name] = batch
        refs[name] = _reference(name, params[name], batch)
        spliced[name] = refs[name][4]
    refs["tp_off"] = _tp_off_reference(params["whisper"], batches["whisper"])
    inp = dict(params=params, batch=batches, spliced=spliced, cases=CASES, B=B, S=S, MAX=MAX,
               decode_tokens=DECODE_TOKENS)
    with open(d / "inp.pkl", "wb") as f:
        pickle.dump(inp, f)
    run_ranks([sys.executable, "-c", RANK_CODE, str(d / "inp.pkl"), str(d)], 4, d / "store",
              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as z:
            ranks.append(({k: z[k] for k in z.files},
                          json.loads((d / f"rank{r}.json").read_text())))
    return ranks, refs


def _coords(r):
    return dict(data=r // SIZES["model"], model=r % SIZES["model"])


def _logit_err(got, want, vocab):
    return float(np.abs(got[:, :vocab] - want[:, :vocab]).max()
                 / np.abs(want[:, :vocab]).max())


def _cache_errs(arrays, name, tag, cache, rank):
    specs = _specs(cache)
    errs = {}
    for k, sp in specs.items():
        want = _block(cache[k], sp, _coords(rank))
        got = arrays[f"{name}/{tag}/{k}"]
        assert got.shape == want.shape, (name, tag, k, got.shape, want.shape)
        errs[k] = float(np.abs(got - want).max() / max(np.abs(cache[k]).max(), 1e-30))
    return errs


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_the_reference_on_each_rank(served, name):
    ranks, refs = served
    logits, cache = refs[name][:2]
    vocab = _cfg(jreg, name).vocab
    for r, (arrays, info) in enumerate(ranks):
        rows = _block(logits, (("data",),), _coords(r))
        assert _logit_err(arrays[f"{name}/prefill/logits"], rows, vocab) <= TOL, (name, r)
        errs = _cache_errs(arrays, name, "prefill", cache, r)
        assert max(errs.values()) <= TOL, (name, r, errs)
        assert info[name]["len"] == [S + 0, S + len(DECODE_TOKENS)]


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_the_reference_on_each_rank(served, name):
    ranks, refs = served
    steps, decoded = refs[name][2:4]
    vocab = _cfg(jreg, name).vocab
    for r, (arrays, info) in enumerate(ranks):
        for t, want in enumerate(steps):
            rows = _block(want, (("data",),), _coords(r))
            err = _logit_err(arrays[f"{name}/decode{t}/logits"], rows, vocab)
            assert err <= TOL, (name, r, t, err)
        errs = _cache_errs(arrays, name, "decoded", decoded, r)
        assert max(errs.values()) <= TOL, (name, r, errs)


def test_the_cache_layouts_are_the_ones_named(served):
    """The cases take the paths they are named for: gemma2's 2 kv heads
    and MLA's latent split the sequence over model, 16 kv heads split the
    heads; the SSM states split heads and channels; whisper's cross k and v
    (16 frames) split their sequence; every batch dim over data."""
    ranks, _ = served
    specs = ranks[0][1]
    assert specs["gqa"]["specs"]["k"] == "P(None, 'data', 'model', None, None)"
    assert specs["gqa_heads"]["specs"]["k"] == "P(None, 'data', None, 'model', None)"
    assert specs["mla_moe"]["specs"]["ckv"] == "P(None, 'data', 'model', None)"
    assert specs["mamba2"]["specs"] == {"conv": "P(None, 'data', 'model', None)",
                                        "ssm": "P(None, 'data', 'model', None, None)"}
    assert specs["whisper"]["specs"]["cross_k"] == "P(None, 'data', 'model', None, None)"


@pytest.mark.parametrize("name", list(CASES))
def test_payloads_equal_the_roofline(served, name):
    ranks, _ = served
    for _, info in ranks:
        got = info[name]
        assert got["prefill_payload"] == got["want_prefill"], name
        assert got["decode_payload"] == got["want_decode"], name


def test_decoding_a_full_mesh_cache_raises(served):
    """A mesh prefill keeps exactly S positions of its cache (each rank a
    block of S / 2 where the sequence splits): a decode step from it raises
    on every rank, naming the whole length, as on one device."""
    ranks, _ = served
    for _, info in ranks:
        for name in CASES:
            if CASES[name][0] != "mamba2-780m":
                assert info[name]["full"] == f"the cache holds {S} positions; it is full", name


def test_a_dropped_partial_fails_the_comparison(served):
    """The first sequence block's partial dropped from the merge: the
    global layers lose 12 of their keys, and the logits leave TOL on every
    rank."""
    ranks, refs = served
    steps = refs["gqa"][2]
    vocab = _cfg(jreg, "gqa").vocab
    for r, (arrays, _) in enumerate(ranks):
        errs = [_logit_err(arrays[f"gqa/planted{t}/logits"], _block(w, (("data",),), _coords(r)),
                           vocab) for t, w in enumerate(steps)]
        assert all(np.isfinite(errs)) and min(errs) > 100 * TOL, errs


def _check_tp_off(served, tag, axes):
    ranks, refs = served
    loss, want_mu = refs["tp_off"]
    for arrays, info in ranks:
        got = info[tag]
        assert got["batch_axes"] == list(axes)
        assert abs(got["loss"] - loss) <= TOL * abs(loss), (tag, got["loss"], loss)
        assert not any("model" in sp for sp in got["specs"]), got["specs"]
        assert not any(k.startswith(("all_gather/model", "reduce_scatter/model"))
                       for k in got["keys"]), got["keys"]
        mus = {k[len(tag) + 4:]: v for k, v in arrays.items() if k.startswith(f"{tag}/mu/")}
        assert mus.keys() == want_mu.keys()
        for k, v in mus.items():
            want = want_mu[k]
            assert np.abs(v - want).max() <= TOL * max(np.abs(want).max(), 1e-30), (tag, k)


def test_tp_off_step_equals_the_one_device_step(served):
    """whisper-smoke's sharded step with its 4 rows one a rank (batch over
    (data, model), ``model`` stripped from every spec), from the JAX
    package's params placed under those specs: the loss within TOL of the
    JAX package's one-device ``make_train_step`` on the whole batch, each
    leaf's first moment within TOL of its max; no collective gathers over
    model."""
    _check_tp_off(served, "tp_off", ("data", "model"))


def test_tp_off_step_on_a_pod_mesh_equals_the_one_device_step(served):
    """The same step on a (pod 2, data 1, model 2) mesh: the batch over
    (pod, data, model), each leaf split over (pod, data) at most, so its
    gradient is summed over ``model`` alone, the batch axis its spec leaves
    unsplit (summing it over the whole batch group would add the other
    pod's different blocks); against the same JAX step."""
    _check_tp_off(served, "tp_off_pod", ("pod", "data", "model"))
    for _, info in served[0]:
        assert "all_reduce/model" in info["tp_off_pod"]["keys"]
