"""The port's partition rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding`` on the CPU, leaf by leaf by path, exact.

* ``param_specs`` over the port's abstract params (``launch/specs.py`` on
  ``meta``) against the reference's over ``eval_shape``, for every
  ``ARCH_IDS`` full config, raw and after ``sanitize`` on 16 x 16, 2 x 16 x
  16, 2 x 2 and (4, 1) (a stub with a ``shape`` dict stands in for the
  mesh: both packages' ``_sanitize`` read only that);
* ``opt_state_specs`` over ``make_init_state``'s AdamW state, fp32 and
  int8, raw and sanitized;
* ``batch_specs`` of every train cell's batch, ``cache_specs`` of the
  decode_32k and long_500k caches with the batch and the data size the
  reference's dry run passes (16), ``strip_axes`` and ``residual_spec``;
* the reference's ``test_param_specs_cover_big_leaves`` on the port.
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.launch import specs as JS
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.sharding import ctx as jctx
from repro.sharding import rules as J
from repro.train.step import make_init_state as j_init_state
from repro_torch.common.tree import tree_paths
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import specs as TS
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules as T
from repro_torch.train.step import lm_state_specs

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCHS = treg.ARCH_IDS
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1}}


class StubMesh:
    """Axis sizes only: what both packages' ``_sanitize`` read."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_paths(tree, specs) -> dict:
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, J.P))
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert len(paths) == len(leaves)
    return {p: tuple(s) for p, s in zip(paths, leaves)}


def _torch_paths(specs) -> dict:
    out = {}

    def walk(t, prefix):
        if isinstance(t, tctx.P):
            out[prefix] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            for i, v in enumerate(t):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
    walk(specs, "")
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JS.abstract_params_for(jreg.get_config(arch))


@functools.lru_cache(maxsize=None)
def _torch_params(arch):
    return TS.abstract_params_for(treg.get_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_state(arch, state_dtype):
    cfg = jreg.get_config(arch)
    return jax.eval_shape(j_init_state(cfg, JAdamW(state_dtype=state_dtype)),
                          jax.random.key(0))


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", [None] + list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    jp, tp = _jax_params(arch), _torch_params(arch)
    js, ts = J.param_specs(jp), T.param_specs(tp)
    if mesh is not None:
        js = J.sanitize(js, jp, StubMesh(MESHES[mesh]))
        ts = T.sanitize(ts, tp, StubMesh(MESHES[mesh]))
    _same(_torch_paths(ts), _jax_paths(jp, js))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(arch, state_dtype):
    jstate = _jax_state(arch, state_dtype)
    cfg = treg.get_config(arch)
    adam = AdamWConfig(state_dtype=state_dtype)
    for mesh in [None] + list(MESHES):
        if mesh is None:
            tstate, _ = lm_state_specs(cfg, adam, StubMesh(MESHES["2x2"]))
            ts = T.opt_state_specs(tstate["opt"])
            js = J.opt_state_specs(jstate["opt"])
        else:
            tstate, tspecs = lm_state_specs(cfg, adam, StubMesh(MESHES[mesh]))
            ts = tspecs["opt"]
            js = J.sanitize(dict(params=J.param_specs(jstate["params"]),
                                 opt=J.opt_state_specs(jstate["opt"])), jstate,
                            StubMesh(MESHES[mesh]))["opt"]
            _same(_torch_paths(tspecs["params"]),
                  _jax_paths(jstate["params"],
                             J.sanitize(J.param_specs(jstate["params"]), jstate["params"],
                                        StubMesh(MESHES[mesh]))))
        _same(_torch_paths(ts), _jax_paths(jstate["opt"], js))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch):
    for shape in tbase.SHAPES:
        if shape.kind != "train" or not treg.cell_supported(arch, shape.name)[0]:
            continue
        tb = TS.batch_specs_for(treg.get_config(arch), shape)
        jb = JS.batch_specs_for(jreg.get_config(arch), JSHAPES[shape.name])
        for mesh in [None] + list(MESHES):
            ts, js = T.batch_specs(tb), J.batch_specs(jb)
            if mesh is not None:
                ts = T.sanitize(ts, tb, StubMesh(MESHES[mesh]))
                js = J.sanitize(js, jb, StubMesh(MESHES[mesh]))
            _same(_torch_paths(ts), _jax_paths(jb, js))


CACHE_CELLS = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
               if treg.cell_supported(a, s)[0]]


@pytest.mark.parametrize("arch,shape_name", CACHE_CELLS)
def test_cache_specs_equal_the_reference(arch, shape_name):
    shape = tbase.SHAPES_BY_NAME[shape_name]
    tc = TS.abstract_cache_for(treg.get_config(arch), shape)
    jc = JS.abstract_cache_for(jreg.get_config(arch), JSHAPES[shape_name])
    for mesh in [None] + list(MESHES):
        ts = T.cache_specs(tc, shape.global_batch, 16)
        js = J.cache_specs(jc, shape.global_batch, 16)
        if mesh is not None:
            ts = T.sanitize(ts, tc, StubMesh(MESHES[mesh]))
            js = J.sanitize(js, jc, StubMesh(MESHES[mesh]))
        _same(_torch_paths(ts), _jax_paths(jc, js))


@pytest.mark.parametrize("arch", ARCHS)
def test_strip_axes_and_residual_spec_equal_the_reference(arch):
    for axes in (("model",), ("pod", "data"), ("data",)):
        ts = T.strip_axes(T.param_specs(_torch_params(arch)), axes)
        js = J.strip_axes(J.param_specs(_jax_params(arch)), axes)
        _same(_torch_paths(ts), _jax_paths(_jax_params(arch), js))
    for layout in ("hidden", "seq"):
        for sam in (True, False):
            tcfg = dataclasses.replace(treg.get_config(arch), activation_layout=layout,
                                       shard_activations_model=sam)
            jcfg = dataclasses.replace(jreg.get_config(arch), activation_layout=layout,
                                       shard_activations_model=sam)
            assert tuple(tctx.residual_spec(tcfg)) == tuple(jctx.residual_spec(jcfg))


def test_sanitize_drops_absent_and_non_dividing_axes():
    mesh = StubMesh({"data": 4, "model": 2})
    for spec, shape in ((((("pod", "data"), "model")), (8, 6)),
                        (("model", ("pod", "data")), (3, 8)),
                        ((("data", "model"), None), (8, 5)),
                        ((("data", "model"), None), (6, 5)),
                        (("pod",), (2,))):
        got = tctx._sanitize(tctx.P(*spec), shape, mesh)
        want = jctx._sanitize(jctx.P(*spec), shape, mesh)
        assert tuple(got) == tuple(want), (spec, shape, got, want)


def test_param_specs_cover_big_leaves():
    """Every >= 1 M-element parameter of every arch gets at least one sharded
    dim (the reference's ``test_distributed.py`` test, on the port)."""
    for arch in ARCHS:
        params = _torch_params(arch)
        specs = _torch_paths(T.param_specs(params))
        for path, leaf in tree_paths(params).items():
            if leaf.numel() >= 1 << 20:
                assert any(e is not None for e in specs[path]), (arch, path, leaf.shape)
