"""The port's int8 error-feedback compression (``repro_torch.optim.compress``),
its elastic re-mesh (``repro_torch.train.elastic``), the data-parallel
checkpoint (``MeshCheckpointManager``) and the launcher under ``torchrun``,
on the CPU, against the JAX package where it has the same function.

* ``ef_compress`` against the JAX package's on the same numpy leaves (a
  conv weight among them, quantized over its HWIO view as the JAX
  package's is; last axes that are not multiples of 128): g_hat and the
  residual within TOL_Q = 1e-7 (measured: bit-equal);
* the error-feedback bound of tests/test_optim.py on the port;
* ``compressed_all_reduce`` over the 2 ranks of each ``dcn`` group of a
  2 x 2 mesh against the sum of the JAX package's per-rank
  ``ef_compress`` outputs on the same inputs (within TOL_Q);
* ``choose_mesh_shape`` against the JAX package's;
* 4 -> 2 -> 4 ranks through ``elastic_transition`` (two ranks leave, two
  join): the state round-trips bit-exact and a 2-D leaf split over
  ``data`` lands in each rank's slice;
* a compressed 2 x 2 state saved by rank 0 and restored on every rank:
  the file's ``opt['ef']`` has the shape of the JAX package's
  ``init_ef_state`` leaf in its layout, and a step from the restored state
  is bit-equal to a step from the live one;
* ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train --episodic --device cpu --dcn-shards 2
  --grad-reduce compressed``: it trains (``world=2``), checkpoints into the
  ``_ef2`` directory, says "nothing to do" when rerun, and a world that
  does not match the flags exits non-zero with the mesh's message.

The ranks are ``python -c`` processes on gloo with a ``file://`` store
(:func:`repro_torch.launch.local_ranks.run_ranks`), one launch of 4 for
the module.
"""
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

from repro.core.episodic_train import init_ef_state as j_init_ef_state
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.optim.compress import ef_compress as j_ef_compress
from repro.train.elastic import choose_mesh_shape as j_choose_mesh_shape
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.common.tree import tree_paths
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.optim.compress import ef_compress, zeros_error
from repro_torch.train.elastic import choose_mesh_shape

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_Q = 1e-7


def _leaves(seed, scale=0.01):
    """A JAX-layout numpy tree: a conv weight (HWIO, last axis 200), last
    axes of 5, 129 and 300."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return dict(conv=dict(w=f(3, 3, 2, 200)), head=dict(w=f(130, 5), b=f(300)),
                x=f(2, 3, 129))


def _port(tree):
    return params_from_numpy(tree, "cpu")


def _err(got_port, want_jax):
    g = tree_paths(params_to_numpy(got_port))
    w = tree_paths(jax.tree.map(np.asarray, want_jax))
    assert set(g) == set(w)
    return max(float(np.abs(g[k] - w[k]).max()) for k in g)


def test_ef_compress_matches_jax():
    g, e = _leaves(0), _leaves(1, scale=0.001)
    jh, je = j_ef_compress(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    th, te = ef_compress(_port(g), _port(e))
    assert _err(th, jh) <= TOL_Q and _err(te, je) <= TOL_Q
    assert th["conv"]["w"].shape == (200, 2, 3, 3)      # the port's OIHW


def test_ef_compression_error_feedback_bound():
    """tests/test_optim.py's bound on the port: the accumulated compressed
    stream stays within one step's quantization error of the true one."""
    gen = torch.Generator().manual_seed(0)
    gs = [0.01 * torch.randn(4, 256, generator=gen) for _ in range(50)]
    err = zeros_error(dict(g=gs[0]))
    acc_hat, acc_true = torch.zeros_like(gs[0]), torch.zeros_like(gs[0])
    for g in gs:
        g_hat, err = ef_compress(dict(g=g), err)
        acc_hat += g_hat["g"]
        acc_true += g
    resid = float((acc_hat - acc_true).abs().max())
    assert resid <= float(err["g"].abs().max()) + 1e-6


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_choose_mesh_shape_matches_jax(mp):
    for n in range(1, 17):
        assert choose_mesh_shape(n, mp) == j_choose_mesh_shape(n, mp)


RANK_CODE = r'''
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import init_ef_state, make_batched_meta_train_step
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.launch.mesh import init_distributed, make_mesh_for, make_two_level_dp_mesh
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compress import compressed_all_reduce
from repro_torch.train.checkpoint import CheckpointManager, MeshCheckpointManager
from repro_torch.train.elastic import choose_mesh_shape, elastic_transition, gather_state, reshard

inp = pickle.load(open(sys.argv[1], "rb"))
out_dir = sys.argv[2]
base = os.environ["RANKS_INIT_METHOD"]
init_distributed("cpu", init_method=base)
rank = int(os.environ["RANK"])
info = {}

# compressed_all_reduce over each dcn group (ranks {0, 2} and {1, 3})
mesh = make_two_level_dp_mesh(2, 2)
c = mesh.coords["dcn"]
summed, new_err = compressed_all_reduce(params_from_numpy(inp["g"][c], "cpu"), mesh, "dcn",
                                        params_from_numpy(inp["e"][c], "cpu"))
np.savez(os.path.join(out_dir, f"car{rank}.npz"),
         **{"sum/" + k: v for k, v in tree_paths(params_to_numpy(summed)).items()},
         **{"err/" + k: v for k, v in tree_paths(params_to_numpy(new_err)).items()})

# a compressed 2 x 2 step, saved by rank 0, restored on every rank
learner = make_learner(MetaLearnerConfig(kind="protonets", way=5),
                       make_conv_backbone(ConvBackboneConfig(widths=(8,), feature_dim=16)),
                       SetEncoderConfig(kind="conv", conv_blocks=1, conv_width=4, task_dim=8))
adamw = AdamWConfig(weight_decay=0.0)
step = make_batched_meta_train_step(learner, LiteSpec(h=4), adamw=adamw, mesh=mesh,
                                    grad_reduce="compressed")
fields = ("support_x", "support_y", "query_x", "query_y", "support_mask", "query_mask")
def batch(s):
    return TaskBatch(*(torch.from_numpy(np.array(inp["batches"][s][k])) for k in fields), way=5)
scores = [torch.from_numpy(s) for s in inp["scores"]]
params = learner.init(torch.Generator().manual_seed(0), "cpu")
opt = dict(adamw_init(params, adamw), ef=init_ef_state(params, 2))
p1, o1, _ = step(params, opt, batch(0), scores[0])
state = dict(params=p1, opt=o1)
ckpt = MeshCheckpointManager(CheckpointManager(os.path.join(out_dir, "ck"), keep=2), mesh)
ckpt.save(1, state)
template = dict(params=params, opt=opt)
got, state2, _ = ckpt.restore_latest(template)
same_restore = all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(state2)))
pa, oa, _ = step(state["params"], state["opt"], batch(1), scores[1])
pb, ob, _ = step(state2["params"], state2["opt"], batch(1), scores[1])
info["ckpt"] = dict(step=got, same_restore=same_restore,
                    same_step=all(torch.equal(a, b) for a, b in
                                  zip(tree_leaves((pa, oa)), tree_leaves((pb, ob)))),
                    ef_row=list(tree_leaves(state2["opt"]["ef"])[0].shape))

# elastic 4 -> 2 -> 4: two ranks leave, then two join
full = torch.arange(64.0).reshape(8, 8)
def specs_for(mesh, abstract):
    return tree_map(lambda a: ("data", None) if a.dim() == 2 else None, abstract)
def world(n, tag):
    def make():
        dist.destroy_process_group()
        if rank >= n:
            return None
        os.environ["WORLD_SIZE"] = str(n)
        init_distributed("cpu", init_method=base + tag)
        return make_mesh_for(choose_mesh_shape(n, 1), ("data", "model"))
    return make
m4 = make_mesh_for(choose_mesh_shape(4, 1), ("data", "model"))
s4 = reshard(dict(w=full.numpy(), step=np.asarray(3)), specs_for(m4, dict(w=full, step=full[0, 0])), m4)
s2 = elastic_transition(s4, m4, world(2, "_w2"), specs_for, specs_for(m4, s4))
slices = {}
if s2 is not None:
    slices["w2"] = s2["w"].tolist()
    m2 = make_mesh_for(choose_mesh_shape(2, 1), ("data", "model"))
    s4b = elastic_transition(s2, m2, world(4, "_w4"), specs_for, specs_for(m2, s2))
else:
    # a rank that left joins the new world of 4 with no state of its own
    def join():
        os.environ["WORLD_SIZE"] = "4"
        init_distributed("cpu", init_method=base + "_w4")
        return make_mesh_for(choose_mesh_shape(4, 1), ("data", "model"))
    s4b = elastic_transition(None, None, join, specs_for)
m4b = make_mesh_for(choose_mesh_shape(4, 1), ("data", "model"))
slices["w4"] = s4b["w"].tolist()
back = gather_state(s4b, m4b, specs_for(m4b, s4b))
info["elastic"] = dict(slices=slices, roundtrip=bool(np.array_equal(back["w"], full.numpy())),
                       step=int(back["step"]))
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro.core.episodic_train import task_key
    from repro.core.lite import _index_scores
    from repro.data.episodic import EpisodicImageConfig, sample_image_task_batch
    d = tmp_path_factory.mktemp("ce_ranks")
    g = [_leaves(10 + c) for c in range(2)]
    e = [_leaves(20 + c, scale=0.001) for c in range(2)]
    tcfg = EpisodicImageConfig(way=5, shot=4, query_per_class=2, image_size=8)
    key = jax.random.key(9)
    inp = dict(g=g, e=e,
               batches=[{k: np.asarray(getattr(b, k)) for k in (
                   "support_x", "support_y", "query_x", "query_y", "support_mask",
                   "query_mask")} for b in (sample_image_task_batch(jax.random.key(s), tcfg, 8)
                                            for s in (3, 4))],
               scores=[np.array(jax.vmap(lambda i: _index_scores(
                   task_key(jax.random.fold_in(key, s), i), 20))(jnp.arange(8)))
                   for s in range(2)])
    with open(d / "inp.pkl", "wb") as f:
        pickle.dump(inp, f)
    run_ranks([sys.executable, "-c", RANK_CODE, str(d / "inp.pkl"), str(d)], 4, d / "store",
              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=240)
    return d, inp, [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]


def test_compressed_all_reduce_matches_jax_ef_compress_sum(ranks):
    d, inp, _ = ranks
    outs = [j_ef_compress(jax.tree.map(jnp.asarray, inp["g"][c]),
                          jax.tree.map(jnp.asarray, inp["e"][c])) for c in range(2)]
    want_sum = tree_paths(jax.tree.map(lambda a, b: np.asarray(a + b), outs[0][0], outs[1][0]))
    for r in range(4):
        with np.load(d / f"car{r}.npz") as z:
            got = {k: z[k] for k in z.files}
        want_err = tree_paths(jax.tree.map(np.asarray, outs[r // 2][1]))
        for k, w in want_sum.items():
            assert np.abs(got["sum/" + k] - w).max() <= TOL_Q, k
        for k, w in want_err.items():
            assert np.abs(got["err/" + k] - w).max() <= TOL_Q, k


def test_mesh_checkpoint_holds_the_jax_ef_leaf_and_restores_exactly(ranks):
    d, _, infos = ranks
    for info in infos:
        c = info["ckpt"]
        assert c["step"] == 1 and c["same_restore"] and c["same_step"]
        assert c["ef_row"][0] == 1                  # each rank keeps its own row
    params = j_make(JCfg(kind="protonets", way=5), j_bb(JBBCfg(widths=(8,), feature_dim=16)),
                    JSetCfg(kind="conv", conv_blocks=1, conv_width=4, task_dim=8)
                    ).init(jax.random.key(0))
    want = {k: v.shape for k, v in
            tree_paths(jax.tree.map(np.asarray, j_init_ef_state(params, 2))).items()}
    with np.load(d / "ck" / "step_0000000001" / "state.npz") as z:
        got = {k[len("opt/ef/"):]: z[k].shape for k in z.files if k.startswith("opt/ef/")}
    assert got == want


def test_elastic_4_2_4_round_trips_and_splits_over_data(ranks):
    _, _, infos = ranks
    full = np.arange(64.0).reshape(8, 8)
    for r, info in enumerate(infos):
        el = info["elastic"]
        assert el["roundtrip"] and el["step"] == 3
        np.testing.assert_array_equal(el["slices"]["w4"], full[2 * r:2 * r + 2])
        if r < 2:
            np.testing.assert_array_equal(el["slices"]["w2"], full[4 * r:4 * r + 4])
        else:
            assert "w2" not in el["slices"]


def _torchrun(tmp_path, *flags, nproc=2):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
                           "--episodic", "--device", "cpu", "--steps", "2",
                           "--tasks-per-step", "4", "--image-size", "12", *flags],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_launcher_under_torchrun_trains_resumes_and_refuses_a_wrong_world(tmp_path):
    flags = ("--dcn-shards", "2", "--grad-reduce", "compressed")
    out = _torchrun(tmp_path, *flags)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "world=2 backend=gloo device=cpu" in out.stdout
    assert out.stdout.count("done at step 2; resumed_from=None") == 1     # rank 0 prints
    ck = tmp_path / "repro_torch_train_ckpt_episodic_protonets_ef2"
    assert (ck / "step_0000000002" / "COMMIT").exists()
    again = _torchrun(tmp_path, *flags)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "nothing to do: checkpoint already at step 2" in again.stdout
    wrong = _torchrun(tmp_path, "--dp-shards", "2", *flags)
    assert wrong.returncode != 0
    assert "world has 2 rank(s)" in wrong.stdout + wrong.stderr
    assert "--nproc-per-node 4" in wrong.stdout + wrong.stderr
