"""The port's sharded LM step (``repro_torch.train.step.make_train_step``
with ``mesh=``, :mod:`repro_torch.sharding`) on 4 gloo ranks on the CPU,
held against the JAX package's ``loss`` and gradient without a mesh.

The reference's own LM step under a mesh raises (ROADMAP R4: its
embedding gather under a (data, model) mesh), so the port is held against
what that step computes: with every data shard holding B / n whole rows,
the mean over the data shards of the reference's ``loss`` and ``jax.grad``
on each shard alone (the MoE capacity is a shard's, as under the mesh),
then ``clip_by_global_norm`` and ``adamw_update`` (lr 1e-3).  fp32 compute
and params, the smoke configs:

* 2 x 2: deepseek-v2-smoke (MLA, MoE with shared experts, expert-parallel
  in the 'hidden' and the 'seq' layout) and gemma2-smoke (dense, local /
  global windows, softcaps); (4, 1): gemma2-smoke.  Loss within TOL =
  1e-5 (relative), the gathered AdamW first moment after the step
  ((1 - b1) times the clipped gradient) within TOL of each leaf's
  max|reference|, and the gathered params within TOL of each leaf's max
  where the reference's gradient exceeds TOL of its leaf's largest (AdamW's
  first step is lr * sign(g), blind to a gradient at rounding level);
* the MoE config on 2 x 2 with int8 AdamW state (its ``q`` and
  ``scale`` laid out by their own rules and resharded to each param's
  block for the update): loss and params as above;
* (4, 1) with the MoE config: one model rank, where the reference's
  ``moe_ffn_sharded`` falls back to ``moe_ffn`` on the global tokens
  (``moe.py:224-229``), so the step equals the reference's on the whole
  batch, held the same way;
* the sharded init's blocks equal the single-device init's blocks, leaf
  for leaf; shard / gather round trips; a checkpoint written on the 2 x 2
  mesh restores on (4, 1) to the same whole leaves;
* the payloads one step hands its collectives equal
  ``roofline.lm_step_payloads``;
* the launcher under ``torchrun`` with 4 gloo ranks (the (4, 1) test mesh,
  ``--full`` printing the reference's warning).
"""
import dataclasses
import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro_torch.launch.local_ranks import run_ranks

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = 1e-3
B, S = 4, 16
# name: (arch, config overrides)
CONFIGS = {"moe": ("deepseek-v2-236b", {}),
           "moe_seq": ("deepseek-v2-236b", dict(activation_layout="seq")),
           "dense": ("gemma2-2b", {})}
# run: (config, mesh); the reference of each is the mean over its data shards
RUNS = {"moe_2x2": ("moe", (2, 2)), "moe_seq_2x2": ("moe_seq", (2, 2)),
        "dense_2x2": ("dense", (2, 2)), "dense_4x1": ("dense", (4, 1)),
        "moe_4x1": ("moe", (4, 1)), "moe_2x2_int8": ("moe", (2, 2))}


def _state_dtype(run):
    return "int8" if run.endswith("_int8") else "float32"


def _cfg(pkg_registry, name):
    arch, over = CONFIGS[name]
    return dataclasses.replace(pkg_registry.get_smoke_config(arch), compute_dtype="float32",
                               **over)


RANK_CODE = r'''
import dataclasses, json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.configs import registry
from repro_torch.launch import collectives
from repro_torch.launch.mesh import init_distributed, make_mesh_for
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.roofline import lm_step_payloads
from repro_torch.sharding.place import gather_tree, shard_tree
from repro_torch.train.checkpoint import CheckpointManager, ShardedCheckpointManager
from repro_torch.train.step import (lm_state_specs, make_init_state, make_sharded_init_state,
                                    make_train_step)

inp = pickle.load(open(sys.argv[1], "rb"))
out_dir = sys.argv[2]
init_distributed("cpu", init_method=os.environ["RANKS_INIT_METHOD"])
rank = int(os.environ["RANK"])
meshes = {v: make_mesh_for(v, ("data", "model")) for v in ((2, 2), (4, 1))}
arrays, info = {}, {}

def same(a, b):
    return torch.equal(a, b) if torch.is_tensor(a) else a == b

def cfg_of(name):
    arch, over = inp["configs"][name]
    return dataclasses.replace(registry.get_smoke_config(arch), compute_dtype="float32", **over)

def whole_state(name, adam):
    p = lm_params_from_numpy(inp["params"][name], "cpu")
    return dict(params=p, opt=adamw_init(p, adam))

batch = dict(tokens=torch.from_numpy(inp["tokens"]))
for run, (name, shape) in inp["runs"].items():
    cfg, mesh = cfg_of(name), meshes[tuple(shape)]
    adam = AdamWConfig(state_dtype="int8" if run.endswith("_int8") else "float32")
    whole, specs = lm_state_specs(cfg, adam, mesh)
    state = shard_tree(whole_state(name, adam), specs, mesh)
    step = make_train_step(cfg, adam, schedule=lambda c: inp["lr"], mesh=mesh)
    collectives.counter.reset()
    state, m = step(state, batch)
    info[run] = dict(metrics={k: float(v) for k, v in m.items()},
                     payload=collectives.counter.payload(),
                     want_payload=lm_step_payloads(cfg, mesh.shape, B=batch["tokens"].shape[0],
                                                   S=batch["tokens"].shape[1],
                                                   state_dtype=adam.state_dtype))
    got = gather_tree(state, specs, mesh)
    for k, v in tree_paths(got["params"]).items():
        arrays[f"{run}/params/{k}"] = v.numpy()
    if adam.state_dtype != "int8":
        for k, v in tree_paths(got["opt"]["mu"]).items():
            arrays[f"{run}/mu/{k}"] = v.numpy()
    if run == "moe_2x2":
        # a checkpoint written on 2 x 2, restored on (4, 1)
        ck = CheckpointManager(os.path.join(out_dir, "ckpt"), keep=2)
        ShardedCheckpointManager(ck, mesh, whole, specs).save(1, state)
        mesh41 = meshes[(4, 1)]
        whole41, specs41 = lm_state_specs(cfg, adam, mesh41)
        _, restored, _ = ShardedCheckpointManager(ck, mesh41, whole41, specs41).restore_latest(
            shard_tree(whole_state(name, adam), specs41, mesh41))
        back = gather_tree(restored, specs41, mesh41)
        want = tree_paths(got)
        info["ckpt_equal"] = tree_paths(back).keys() == want.keys() and all(
            same(v, want[k]) for k, v in tree_paths(back).items())

# the sharded init's blocks against the single-device init's, and round trips
for name in ("moe", "dense"):
    for shape in ((2, 2), (4, 1)):
        mesh = meshes[shape]
        for sd in ("float32", "int8"):
            a = AdamWConfig(state_dtype=sd)
            _, specs = lm_state_specs(cfg_of(name), a, mesh)
            blocks = make_sharded_init_state(cfg_of(name), a, mesh)(
                torch.Generator().manual_seed(3), "cpu")
            full = make_init_state(cfg_of(name), a)(torch.Generator().manual_seed(3), "cpu")
            want = shard_tree(full, specs, mesh)
            key = f"init/{name}/{shape[0]}x{shape[1]}/{sd}"
            info[key] = all(same(x, y) for x, y in
                            zip(tree_leaves(blocks), tree_leaves(want)))
            back = gather_tree(want, specs, mesh)
            info[key + "/roundtrip"] = all(same(x, y) for x, y in
                                           zip(tree_leaves(back), tree_leaves(full)))
            info[key + "/elems"] = [sum(t.numel() for t in tree_leaves(tree)
                                        if torch.is_tensor(t)) for tree in (blocks, full)]
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
torch.distributed.destroy_process_group()
'''


@functools.lru_cache(maxsize=None)
def _value_and_grad(arch):
    # without a mesh the reference's loss does not read the layout: one
    # compiled function serves both MoE configs
    cfg = _cfg(jreg, next(n for n, (a, _) in CONFIGS.items() if a == arch))
    return jax.jit(jax.value_and_grad(lambda p, t: JT.loss(p, dict(tokens=t), cfg)[0]))


def _jax_ref(name, params, tokens, shards, state_dtype="float32"):
    """The reference's per-shard mean of loss and gradient, clipped, one
    AdamW update in ``state_dtype``: (mean loss, new params, new mu (None
    for int8), the mean gradient)."""
    vg = _value_and_grad(CONFIGS[name][0])
    rows = tokens.shape[0] // shards
    losses, grads = [], []
    for i in range(shards):
        loss, g = vg(params, jnp.asarray(tokens[i * rows:(i + 1) * rows]))
        losses.append(float(loss))
        grads.append(g)
    g = jax.tree.map(lambda *x: sum(x) / shards, *grads)
    adam = JAdamW(state_dtype=state_dtype)

    def update(params, g):
        gc, _ = j_clip(g, 1.0)
        return j_adamw_update(params, gc, j_adamw_init(params, adam), LR, adam)

    p1, o1 = jax.jit(update)(params, g)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)  # noqa: E731
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return float(np.mean(losses)), flat(p1), \
        None if state_dtype == "int8" else flat(o1["mu"]), flat(g)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    tokens = np.random.default_rng(0).integers(0, 256, size=(B, S)).astype(np.int64)
    params = {}
    for name in ("moe", "dense"):
        p = jax.jit(JT.init_transformer, static_argnums=1)(jax.random.key(1), _cfg(jreg, name))
        params[name] = jax.tree.map(np.asarray, p)
    params["moe_seq"] = params["moe"]              # the layout is not in the params
    inp = dict(params=params, tokens=tokens, configs=CONFIGS, runs=RUNS, lr=LR)
    with open(d / "inp.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # the ranks in a thread, the reference meanwhile in this process
    failed = []

    def ranks_run():
        try:
            run_ranks([sys.executable, "-c", RANK_CODE, str(d / "inp.pkl"), str(d)], 4,
                      d / "store", env=env, timeout=240)
        except Exception as e:      # re-raised below, in the test's thread
            failed.append(e)

    thread = threading.Thread(target=ranks_run)
    thread.start()
    refs = {}
    for run, (name, (nd, _)) in RUNS.items():
        jp = jax.tree.map(jnp.asarray, params[name])
        # at one model rank the MoE layer is the reference's fallback, moe_ffn
        # on the global tokens: the whole batch as one shard
        shards = 1 if run == "moe_4x1" else nd
        refs[run] = _jax_ref(name, jp, tokens, shards, _state_dtype(run))
    thread.join()
    if failed:
        raise failed[0]
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as z:
            ranks.append(({k: z[k] for k in z.files},
                          json.loads((d / f"rank{r}.json").read_text())))
    return ranks, refs


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_step_matches_the_reference_per_shard_mean(mesh_runs, run):
    ranks, refs = mesh_runs
    loss, p1, mu, g = refs[run]
    for r, (arrays, info) in enumerate(ranks):
        m = info[run]["metrics"]
        assert abs(m["loss"] - loss) <= TOL * abs(loss), (run, r, m["loss"], loss)
        assert m["nonfinite"] == 0.0
        for k, want in (mu or {}).items():
            got = arrays[f"{run}/mu/{k}"]
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got - want).max() <= TOL * scale, (run, r, k)
        for k, want in p1.items():
            got = arrays[f"{run}/params/{k}"]
            keep = np.abs(g[k]) > TOL * np.abs(g[k]).max()
            if keep.any():
                err = np.abs(got - want)[keep].max() / max(np.abs(want).max(), 1e-30)
                assert err <= TOL, (run, r, k, err)
        # every rank holds the same global metrics and gathered state
        assert m == ranks[0][1][run]["metrics"]


def test_step_payloads_equal_the_roofline(mesh_runs):
    ranks, _ = mesh_runs
    for arrays, info in ranks:
        for run in RUNS:
            assert info[run]["payload"] == info[run]["want_payload"], run


def test_sharded_init_blocks_equal_the_single_device_init(mesh_runs):
    ranks, _ = mesh_runs
    for _, info in ranks:
        keys = [k for k in info if k.startswith("init/") and k.count("/") == 3]
        assert len(keys) == 8
        for k in keys:
            assert info[k], k
            assert info[k + "/roundtrip"], k


def test_sharded_state_is_about_a_quarter_on_four_ranks(mesh_runs):
    """On 2 x 2 and on (4, 1) a rank holds about a quarter of the state:
    the large leaves split on both of their dims' axes, only norm scales
    and other small leaves whole."""
    ranks, _ = mesh_runs
    for _, info in ranks:
        for name in ("moe", "dense"):
            for shape in ("2x2", "4x1"):
                for sd in ("float32", "int8"):
                    block, whole = info[f"init/{name}/{shape}/{sd}/elems"]
                    assert 0.25 * whole <= block < 0.3 * whole, (name, shape, sd, block, whole)


def test_checkpoint_from_2x2_restores_on_4x1(mesh_runs):
    ranks, _ = mesh_runs
    assert all(info["ckpt_equal"] for _, info in ranks)


def test_launcher_under_torchrun_on_a_test_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", "deepseek-v2-236b", "--device",
         "cpu", "--steps", "2", "--batch", "4", "--seq", "16", "--full", "--ckpt-dir",
         str(tmp_path / "ck")], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    said = out.stdout + out.stderr
    assert out.returncode == 0, said[-3000:]
    assert "[warn] --full needs >=256 devices (have 4); running the smoke config on the " \
           "test mesh" in out.stdout
    assert "arch=deepseek-v2-smoke mesh={'data': 4, 'model': 1} backend=gloo devices=4" \
        in out.stdout
    assert out.stdout.count("done at step 2") == 1         # rank 0 prints


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="nproc-per-node 256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="nproc-per-node 768"):
        make_production_mesh(multi_pod=True, pods=3)


WORLD1_CODE = r'''
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch.common.tree import tree_paths
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import init_distributed, make_test_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_init_state, make_sharded_init_state, make_train_step
init_distributed("cpu", init_method=os.environ["RANKS_INIT_METHOD"])
mesh = make_test_mesh()
out = {}
for arch in ("deepseek-v2-236b", "gemma2-2b"):
    cfg = get_smoke_config(arch)
    adam = AdamWConfig(state_dtype="int8")
    batch = dict(tokens=torch.randint(0, cfg.vocab, (2, 16),
                                      generator=torch.Generator().manual_seed(1)))
    one = make_init_state(cfg, adam)(torch.Generator().manual_seed(0), "cpu")
    sharded = make_sharded_init_state(cfg, adam, mesh)(torch.Generator().manual_seed(0), "cpu")
    _, m1 = make_train_step(cfg, adam)(one, batch)
    _, m2 = make_train_step(cfg, adam, mesh=mesh)(sharded, batch)
    a, b = tree_paths(one), tree_paths(sharded)
    out[arch] = a.keys() == b.keys() and all(
        torch.equal(v, b[k]) if torch.is_tensor(v) else v == b[k] for k, v in a.items()) \
        and bool(m1["loss"] == m2["loss"])
print(json.dumps(out))
torch.distributed.destroy_process_group()
'''


def test_world_of_one_is_bit_equal_to_one_process(tmp_path):
    """The (1, 1) test mesh's step (every collective over a group of one,
    skipped) is bit-equal to the step without a mesh, int8 state included."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (said,) = run_ranks([sys.executable, "-c", WORLD1_CODE], 1, tmp_path / "store", env=env,
                        timeout=240)
    assert json.loads(said.strip().splitlines()[-1]) == {"deepseek-v2-236b": True,
                                                         "gemma2-2b": True}
