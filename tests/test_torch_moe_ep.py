"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_ffn_sharded``)
on 4 gloo ranks on the CPU, against the JAX package's ``moe_ffn_sharded``
on 4 forced host devices (one subprocess), and its gradient against the
reference's ``moe_ffn`` VJP on each data shard alone.

* Forward, every case on the same inputs (numpy seed): on the 2 x 2 mesh
  in both layouts, with shared experts, without, and with a capacity drop;
  the fallbacks, a model axis of 1 ((4, 1)) and E not divisible by it (E 6
  on (1, 4)), where both packages run ``moe_ffn`` on the global tokens.
  Each rank's block of y within TOL_Y = 1e-5 (fp32: only the order of the
  partial sums over model differs) and aux within TOL_AUX = 1e-6 of the
  reference's.
* Gradient (2 x 2, both layouts, with and without a capacity drop): the
  loss sum(y * ct) + c * aux of each rank's block; the rank's gradient of
  its block of x, of the router and shared experts (whole on every model
  rank) and of its E/m experts against ``jax.vjp`` of ``moe_ffn`` on its
  data shard alone with that shard's ct and c / n_data (the aux is a mean
  over the data ranks), each within TOL_GRAD = 1e-5 of its leaf's
  max|reference|.
* The LM's ``moe_dispatch`` under an active mesh: no longer raises, and
  runs ``moe_ffn_sharded`` (its ranks' y equal the shard's ``moe_ffn``).

One module fixture starts the 4 ranks once and the JAX subprocess beside
them; every test reads their results.
"""
import dataclasses
import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as JM
from repro_torch.launch.local_ranks import run_ranks

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_Y = 1e-5
TOL_AUX = 1e-6
TOL_GRAD = 1e-5
D, F = 32, 16
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# name: (MoE config, T, mesh)
CASES = {
    "base": (dict(n_experts=8, top_k=2, n_shared=1, d_ff=F), 64, "2x2"),
    "noshared": (dict(n_experts=8, top_k=3, n_shared=0, d_ff=F), 64, "2x2"),
    "drop": (dict(n_experts=8, top_k=2, n_shared=1, d_ff=F, capacity_factor=0.5), 256, "2x2"),
    "model1": (dict(n_experts=8, top_k=2, n_shared=1, d_ff=F), 64, "4x1"),
    "e_indiv": (dict(n_experts=6, top_k=2, n_shared=1, d_ff=F), 64, "1x4"),
}
GRAD_CASES = ("base", "drop")
LAYOUTS = ("hidden", "seq")
AUX_CT = 0.7


def _inputs(name):
    kw, t, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    e, s = kw["n_experts"], kw["n_shared"] * F
    n = lambda *shape, fan: (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    p = dict(router=n(D, e, fan=D), w_gate=n(e, D, F, fan=D), w_up=n(e, D, F, fan=D),
             w_down=n(e, F, D, fan=F))
    if s:
        p["shared"] = dict(w_gate=n(D, s, fan=D), w_up=n(D, s, fan=D), w_down=n(s, D, fan=s))
    return dict(p=p, x=rng.standard_normal((t, D)).astype(np.float32),
                ct=rng.standard_normal((t, D)).astype(np.float32))


RANK_CODE = r'''
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.common.tree import tree_map, tree_paths
from repro_torch.configs.base import MoEConfig
from repro_torch.launch.mesh import init_distributed, make_mesh_for
from repro_torch.models import moe as M

inp = pickle.load(open(sys.argv[1], "rb"))
out_dir = sys.argv[2]
init_distributed("cpu", init_method=os.environ["RANKS_INIT_METHOD"])
rank = int(os.environ["RANK"])
meshes = {k: make_mesh_for(v, ("data", "model")) for k, v in inp["meshes"].items()}
arrays = {}

def block(a, mesh, layout):
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    di, mi = mesh.coords["data"], mesh.coords["model"]
    a = a[di * a.shape[0] // nd:(di + 1) * a.shape[0] // nd]
    if layout == "hidden":
        return a[:, mi * a.shape[1] // nm:(mi + 1) * a.shape[1] // nm]
    return a[mi * a.shape[0] // nm:(mi + 1) * a.shape[0] // nm]

for name, (kw, t, mesh_name) in inp["cases"].items():
    cfg = MoEConfig(**kw)
    mesh = meshes[mesh_name]
    nm, mi = mesh.shape["model"], mesh.coords["model"]
    case = inp[name]
    p = tree_map(torch.from_numpy, case["p"])
    if cfg.n_experts % nm == 0:
        el = cfg.n_experts // nm
        p = dict(p, **{k: p[k][mi * el:(mi + 1) * el] for k in ("w_gate", "w_up", "w_down")})
    for layout in inp["layouts"]:
        x = block(torch.from_numpy(case["x"]), mesh, layout)
        grad = name in inp["grad_cases"]
        leaves = tree_map(lambda w: w.clone().requires_grad_(grad), p)
        x = x.clone().requires_grad_(grad)
        y, aux = M.moe_ffn_sharded(leaves, x, cfg, mesh, layout, backend="ref")
        arrays[f"{name}/{layout}/y"] = y.detach().numpy()
        arrays[f"{name}/{layout}/aux"] = aux.detach().numpy()
        if grad:
            ct = block(torch.from_numpy(case["ct"]), mesh, layout)
            ((y * ct).sum() + inp["aux_ct"] * aux).backward()
            arrays[f"{name}/{layout}/dx"] = x.grad.numpy()
            for k, w in tree_paths(leaves).items():
                arrays[f"{name}/{layout}/d/{k}"] = w.grad.numpy()

# the LM's dispatch under an active mesh, on the 2 x 2 mesh
import dataclasses
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import transformer
from repro_torch.sharding import use_mesh
lm = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), compute_dtype="float32")
mesh = meshes["2x2"]
case = inp["base"]
cfg = MoEConfig(**inp["cases"]["base"][0])
lm = dataclasses.replace(lm, moe=cfg, d_model=32)
p = tree_map(torch.from_numpy, case["p"])
el = cfg.n_experts // 2
mi = mesh.coords["model"]
p = dict(p, **{k: p[k][mi * el:(mi + 1) * el] for k in ("w_gate", "w_up", "w_down")})
x = torch.from_numpy(case["x"])
di = mesh.coords["data"]
xs = x[di * 32:(di + 1) * 32]
with use_mesh(mesh):
    y, aux = transformer.moe_dispatch(p, xs, lm, backend="ref")
arrays["dispatch/y"] = y.numpy()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(dict(coords=mesh.coords), f)
torch.distributed.destroy_process_group()
'''

JAX_CODE = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import MoEConfig
from repro.models import moe as JM
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (kw, t, mesh_name) in inp["cases"].items():
    cfg = MoEConfig(**kw)
    mesh = Mesh(np.asarray(jax.devices()).reshape(inp["meshes"][mesh_name]), ("data", "model"))
    p = jax.tree.map(jnp.asarray, inp[name]["p"])
    x = jnp.asarray(inp[name]["x"])
    for layout in inp["layouts"]:
        y, aux = jax.jit(lambda p, x: JM.moe_ffn_sharded(p, x, cfg, mesh, layout=layout))(p, x)
        out[f"{name}/{layout}/y"] = np.asarray(y)
        out[f"{name}/{layout}/aux"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
'''


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    inp = {name: _inputs(name) for name in CASES}
    inp.update(cases=CASES, meshes=MESHES, layouts=LAYOUTS, grad_cases=GRAD_CASES,
               aux_ct=AUX_CT)
    with open(d / "inp.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", JAX_CODE, str(d / "inp.pkl"),
                            str(d / "jax.npz")], env=jax_env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks([sys.executable, "-c", RANK_CODE, str(d / "inp.pkl"), str(d)], 4,
                  d / "store", env=env, timeout=240)
        said, _ = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, said[-3000:]
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as z:
            ranks.append(({k: z[k] for k in z.files},
                          json.loads((d / f"rank{r}.json").read_text())))
    with np.load(d / "jax.npz") as z:
        jx = {k: z[k] for k in z.files}
    return ranks, jx, inp


def _coords(r, mesh_name):
    """Rank r's (data, model) coordinates on a mesh (rank = data * M + model)."""
    nd, nm = MESHES[mesh_name]
    return r // nm, r % nm


def _block(a, mesh_name, layout, r):
    nd, nm = MESHES[mesh_name]
    di, mi = _coords(r, mesh_name)
    a = a[di * a.shape[0] // nd:(di + 1) * a.shape[0] // nd]
    if layout == "hidden":
        return a[:, mi * a.shape[1] // nm:(mi + 1) * a.shape[1] // nm]
    return a[mi * a.shape[0] // nm:(mi + 1) * a.shape[0] // nm]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_the_reference_moe_ffn_sharded(ep, name, layout):
    ranks, jx, _ = ep
    mesh_name = CASES[name][2]
    want_y = jx[f"{name}/{layout}/y"]
    for r, (got, _) in enumerate(ranks):
        y = got[f"{name}/{layout}/y"]
        w = _block(want_y, mesh_name, layout, r)
        assert y.shape == w.shape
        assert np.abs(y - w).max() <= TOL_Y, (name, layout, r, np.abs(y - w).max())
        aux = got[f"{name}/{layout}/aux"]
        assert abs(float(aux) - float(jx[f"{name}/{layout}/aux"])) <= TOL_AUX


def test_the_drop_case_drops_slots():
    """The capacity-drop case really drops: some expert gets more of a data
    shard's slots than ``capacity(T_loc)``."""
    kw, t, mesh_name = CASES["drop"]
    cfg = JMoE(**kw)
    inp = _inputs("drop")
    t_loc = t // MESHES[mesh_name][0]
    dropped = 0
    for di in range(MESHES[mesh_name][0]):
        x = jnp.asarray(inp["x"][di * t_loc:(di + 1) * t_loc])
        _, ids, _ = JM.router_probs(jax.tree.map(jnp.asarray, inp["p"]), x, cfg)
        counts = np.bincount(np.asarray(ids).reshape(-1), minlength=cfg.n_experts)
        dropped += int(np.maximum(counts - JM.capacity(t_loc, cfg), 0).sum())
    assert dropped > 0


@functools.lru_cache(maxsize=None)
def _shard_vjp(name, di):
    """``jax.vjp`` of the reference's ``moe_ffn`` on data shard ``di`` alone,
    with that shard's ct and AUX_CT / n_data on the aux."""
    kw, t, mesh_name = CASES[name]
    cfg = JMoE(**kw)
    nd = MESHES[mesh_name][0]
    inp = _inputs(name)
    t_loc = t // nd
    p = jax.tree.map(jnp.asarray, inp["p"])
    x = jnp.asarray(inp["x"][di * t_loc:(di + 1) * t_loc])
    ct = jnp.asarray(inp["ct"][di * t_loc:(di + 1) * t_loc])
    def vjp(p, x, ct):
        return jax.vjp(lambda p, x: JM.moe_ffn(p, x, cfg), p, x)[1]((ct, jnp.float32(AUX_CT / nd)))

    dp, dx = jax.jit(vjp)(p, x, ct)
    return jax.tree.map(np.asarray, dp), np.asarray(dx)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_paths(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradient_matches_each_shards_moe_ffn_vjp(ep, name, layout):
    ranks, _, _ = ep
    kw, t, mesh_name = CASES[name]
    nm = MESHES[mesh_name][1]
    el = kw["n_experts"] // nm
    for r, (got, _) in enumerate(ranks):
        di, mi = _coords(r, mesh_name)
        dp, dx = _shard_vjp(name, di)
        nd = MESHES[mesh_name][0]
        t_loc = t // nd
        full_dx = np.zeros((t, D), np.float32)
        full_dx[di * t_loc:(di + 1) * t_loc] = dx
        want = {"dx": _block(full_dx, mesh_name, layout, r)}
        for k, v in _paths(dp).items():
            want[f"d/{k}"] = v[mi * el:(mi + 1) * el] if k in ("w_gate", "w_up", "w_down") \
                else v
        for k, w in want.items():
            g = got[f"{name}/{layout}/{k}"]
            assert g.shape == w.shape, (k, g.shape, w.shape)
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= TOL_GRAD, (name, layout, r, k, err)


def test_moe_dispatch_runs_expert_parallel_under_a_mesh(ep):
    """``transformer.moe_dispatch`` under ``use_mesh`` (2 x 2, the smoke
    LM's 'hidden' layout, the shared experts on the whole tokens): every
    rank's y is its data shard's ``moe_ffn``, whole."""
    ranks, _, _ = ep
    kw, _, _ = CASES["base"]
    cfg = JMoE(**kw)
    inp = _inputs("base")
    p = jax.tree.map(jnp.asarray, inp["p"])
    for r, (got, _) in enumerate(ranks):
        di = r // 2
        want, _ = JM.moe_ffn(p, jnp.asarray(inp["x"][di * 32:(di + 1) * 32]), cfg)
        assert np.abs(got["dispatch/y"] - np.asarray(want)).max() <= TOL_Y


def test_ep_applies_is_the_reference_fallback_rule():
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import ep_applies
    cfg = MoEConfig(n_experts=8)
    assert ep_applies(cfg, {"data": 2, "model": 2}, 16, 32, "hidden")
    assert not ep_applies(cfg, {"data": 4, "model": 1}, 16, 32, "hidden")
    assert not ep_applies(dataclasses.replace(cfg, n_experts=6), {"model": 4}, 16, 32, "seq")
    assert not ep_applies(cfg, {"model": 2}, 16, 33, "hidden")
    assert not ep_applies(cfg, {"model": 2}, 15, 32, "seq")
    assert ep_applies(cfg, {"model": 2}, 15, 32, "hidden")
