"""Data-parallel LITE meta-training of the port (``make_batched_meta_train_step``
with a mesh, :mod:`repro_torch.launch.mesh`) on 4 gloo ranks on the CPU,
held against the JAX package's single-device step.

The JAX package's own sharded step cannot run on this toolchain (ROADMAP
R1: its ``shard_map(check_rep=False)`` raises), so the port is held against
what that step must equal:

* the reference's single-device step (``mesh=None``): with equal shard
  sizes a mean of shard means is the global mean, so the 1-D, the 2 x 2 and
  the accumulated 2 x 2 steps equal it within the reference's own bounds
  (tests/test_multihost.py): params and loss within TOL_DP = 1e-5.  The
  first update is about lr * sign(g), blind to the gradient's scale, so
  the gradient is held too: its norm before the clip within TOL_DP of the
  reference's, and AdamW's first moment after the step, (1 - b1) times the
  clipped gradient, within TOL_DP of each leaf's max|reference|.
  Simple CNAPs is held to the tolerances of its single-device tests
  (tests/test_torch_train_learners.py): the loss within
  TOL_SIMPLE_CNAPS_LOSS = 4e-3 of it, the params, the norm and the first
  moment within TOL_SIMPLE_CNAPS = 5e-2 of each leaf's max|reference| (the
  covariance's Cholesky amplifies changes of summation order);
* for the compressed reduction, the reference's functions composed on one
  device in the order of its sharded body: ``make_batched_meta_grads`` on
  each shard's tasks with their global ids, the mean over ``data``,
  ``ef_compress`` on each ``dcn`` row, the sum over ``dcn`` divided by
  ``dcn``, ``clip_by_global_norm`` and ``adamw_update``: params within
  TOL_EF = 1e-6; the residual, (g + e) - dequantize(quantize(g + e)),
  carries the two frameworks' own gradient rounding, so it is held within
  TOL_EF_GRAD = 1e-5 of each leaf's max|data-mean gradient| (measured
  1.4e-6 of it, 4.9e-6 absolute on a leaf whose gradient reaches 3.8),
  and the gradient's norm and first moment within TOL_EF_GRAD of the
  reference's.
  The quantization itself is held bit for bit on equal inputs in
  tests/test_torch_compress_elastic.py.

One module fixture starts the 4 ranks once (``python -c``, no JAX in them,
a ``file://`` store, every rank killed when one fails); they run every
scenario and write their results as ``.npz``; each test reads them.  The
learner is tests/test_multihost.py's tiny ProtoNets (widths (8,), feature
16, 5-way 4-shot, 2 queries a class, 8 px, h 4, T 8), and Simple CNAPs at
the same size, the params crossed over from the JAX package's init by
``repro_torch.bridge`` and the H scores fed in as the (T, N) tensor.
"""
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

from repro.core.episodic_train import make_batched_meta_grads as j_grads
from repro.core.episodic_train import make_batched_meta_train_step as j_step
from repro.core.episodic_train import task_key
from repro.core.lite import LiteSpec as JLite
from repro.core.lite import _index_scores
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.data.episodic import EpisodicImageConfig, sample_image_task_batch
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim.compress import ef_compress as j_ef_compress
from repro_torch.configs.base import MetaTrainConfig
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.roofline import dp_wire_bytes

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_DP = 1e-5
TOL_EF = 1e-6
TOL_EF_GRAD = 1e-5
TOL_SIMPLE_CNAPS = 5e-2
TOL_SIMPLE_CNAPS_LOSS = 4e-3
T, N, STEPS = 8, 20, 10
FIELDS = ("support_x", "support_y", "query_x", "query_y", "support_mask", "query_mask")

# every rank runs every scenario of this file; the results land in
# <out>/rank<r>.npz (path-keyed leaves, JAX layout) and <out>/rank<r>.json
RANK_CODE = r'''
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import init_ef_state, make_batched_meta_train_step
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.kernels import _build
from repro_torch.launch import collectives
from repro_torch.launch.mesh import init_distributed, make_dp_mesh, make_two_level_dp_mesh
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compress import compressed_scale_bytes
from repro_torch.roofline import dp_payloads

inp = pickle.load(open(sys.argv[1], "rb"))
out_dir = sys.argv[2]
init_distributed("cpu", init_method=os.environ["RANKS_INIT_METHOD"])
rank = int(os.environ["RANK"])
adamw = AdamWConfig(weight_decay=0.0)
lite = LiteSpec(h=4)
fields = ("support_x", "support_y", "query_x", "query_y", "support_mask", "query_mask")
meshes = dict(d4=make_dp_mesh(4), t14=make_two_level_dp_mesh(1, 4),
              t22=make_two_level_dp_mesh(2, 2))
arrays, info = {}, {}

def learner(kind):
    return make_learner(MetaLearnerConfig(kind=kind, way=5),
                        make_conv_backbone(ConvBackboneConfig(widths=(8,), feature_dim=16)),
                        SetEncoderConfig(kind="conv", conv_blocks=1, conv_width=4, task_dim=8))

def batch(b):
    return TaskBatch(*(torch.from_numpy(np.array(b[k])) for k in fields), way=5)

def put(name, params, opt, metrics):
    for k, v in tree_paths(params_to_numpy(params)).items():
        arrays[f"{name}/params/{k}"] = v
    for part in ("mu", "nu"):
        for k, v in tree_paths(params_to_numpy(opt[part])).items():
            arrays[f"{name}/{part}/{k}"] = v
    if "ef" in opt:
        for k, v in tree_paths(params_to_numpy(tree_map(lambda e: e[0], opt["ef"]))).items():
            arrays[f"{name}/ef/{k}"] = v
    info[name] = {k: float(v) for k, v in metrics.items()} | {"count": int(opt["count"])}

def step_for(kind, mesh, **kw):
    return make_batched_meta_train_step(learner(kind), lite, adamw=adamw,
                                        mesh=None if mesh is None else meshes[mesh], **kw)

def fresh(kind, compressed=False):
    p = params_from_numpy(inp[kind], "cpu")
    o = adamw_init(p, adamw)
    if compressed:
        o["ef"] = init_ef_state(p, 2)
    return p, o

b0, s0 = batch(inp["batch"]), torch.from_numpy(inp["scores"])
runs = [("d4", "d4", {}), ("t14", "t14", {}), ("t22", "t22", {}),
        ("t22_acc2", "t22", dict(accum_steps=2)),
        ("t22_comp", "t22", dict(grad_reduce="compressed")),
        ("t22_comp_acc2", "t22", dict(grad_reduce="compressed", accum_steps=2))]
pbytes = sum(p.numel() * p.element_size() for p in tree_leaves(fresh("protonets")[0]))
scale_bytes = compressed_scale_bytes(fresh("protonets")[0])
for name, mesh, kw in runs:
    p, o = fresh("protonets", "grad_reduce" in kw)
    step = step_for("protonets", mesh, **kw)
    _build.launches.reset()
    collectives.counter.reset()
    p1, o1, m1 = step(p, o, b0, s0)
    put(name, p1, o1, m1)
    info[name + "/collectives"] = collectives.counter.snapshot()
    info[name + "/payload"] = collectives.counter.payload()
    info[name + "/want_payload"] = dp_payloads(pbytes, kw.get("grad_reduce", "pmean"),
                                               scale_bytes)
    info[name + "/pbytes"] = pbytes

p, o = fresh("simple_cnaps")
p1, o1, m1 = step_for("simple_cnaps", "t22")(p, o, b0, s0)
put("sc_t22", p1, o1, m1)

# ten exact and ten compressed steps on the 2 x 2 mesh
exact, comp = step_for("protonets", "t22"), step_for("protonets", "t22", grad_reduce="compressed")
pe, oe = fresh("protonets")
pc, oc = fresh("protonets", True)
losses = []
for b, s in zip(inp["ten_batches"], inp["ten_scores"]):
    b, s = batch(b), torch.from_numpy(s)
    pe, oe, _ = exact(pe, oe, b, s)
    pc, oc, mc = comp(pc, oc, b, s)
    losses.append(float(mc["loss"]))
pnorm = float(torch.sqrt(sum((x ** 2).sum() for x in tree_leaves(pe))))
drift = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(pe), tree_leaves(pc)))
info["ten"] = dict(losses=losses, pnorm=pnorm, drift=drift,
                   ef_l1=sum(float(e.abs().sum()) for e in tree_leaves(oc["ef"])))

# NaN planted in rank 3's two tasks only: every rank must skip, bit for bit
bad = dict(inp["batch"])
bad["support_x"] = np.array(bad["support_x"])
bad["support_x"][6:8] = np.nan
for name, kw, (p, o) in (("nan_pmean", {}, (pe, oe)),
                         ("nan_comp", dict(grad_reduce="compressed"), (pc, oc))):
    new_p, new_o, m = step_for("protonets", "t22", **kw)(p, o, batch(bad), s0)
    before, after = tree_leaves(p) + tree_leaves(o), tree_leaves(new_p) + tree_leaves(new_o)
    info[name] = dict(nonfinite=float(m["nonfinite"]), same=len(before) == len(after)
                      and all(torch.equal(a, b) for a, b in zip(after, before)))
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
'''


def _learner(kind):
    return j_make(JCfg(kind=kind, way=5), j_bb(JBBCfg(widths=(8,), feature_dim=16)),
                  JSetCfg(kind="conv", conv_blocks=1, conv_width=4, task_dim=8))


def _scores(key):
    return np.array(jax.vmap(lambda i: _index_scores(task_key(key, i), N))(jnp.arange(T)))


def _np_batch(b):
    return {k: np.asarray(getattr(b, k)) for k in FIELDS}


def _flat(tree, prefix):
    from repro_torch.common.tree import tree_paths
    return {f"{prefix}/{k}": np.asarray(v) for k, v in
            tree_paths(jax.tree.map(np.asarray, tree)).items()}


def _composition(jl, spec, adamw, params, opt, batch, key):
    """The reference's functions in its sharded body's order on one device:
    shard grads with global ids, mean over data, ef_compress per dcn row,
    sum over dcn / dcn, clip, AdamW.  Returns (params, AdamW's mu, the
    gradient's global norm before the clip, [ef row 0, row 1], [data-mean
    gradient of row 0, row 1])."""
    gfn = jax.jit(j_grads(jl, spec))
    shard = [gfn(params, jax.tree.map(lambda a: a[r * 2:(r + 1) * 2], batch), key,
                 jnp.arange(r * 2, r * 2 + 2))[2] for r in range(4)]
    rows = [jax.tree.map(lambda a, b: (a + b) / 2, shard[2 * c], shard[2 * c + 1])
            for c in range(2)]
    zeros = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), params)
    comp = [j_ef_compress(g, zeros) for g in rows]
    g = jax.tree.map(lambda a, b: (a + b) / 2, comp[0][0], comp[1][0])
    g, gnorm = j_clip(g, 10.0)
    p, o = j_adamw_update(params, g, opt, 1e-3, adamw)
    return p, o["mu"], float(gnorm), [comp[0][1], comp[1][1]], rows


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_ranks")
    spec, adamw = JLite(h=4), JAdamW(weight_decay=0.0)
    tcfg = EpisodicImageConfig(way=5, shot=4, query_per_class=2, image_size=8)
    batch = sample_image_task_batch(jax.random.key(3), tcfg, T)
    key = jax.random.key(9)
    ref, inp = {}, dict(batch=_np_batch(batch), scores=_scores(key))
    for kind in ("protonets", "simple_cnaps"):
        jl = _learner(kind)
        params = jl.init(jax.random.key(0))
        inp[kind] = jax.tree.map(np.asarray, params)
        opt = j_adamw_init(params, adamw)
        p0, o0, m0 = jax.jit(j_step(jl, spec, adamw=adamw))(params, opt, batch, key)
        ref[kind] = dict(params=_flat(p0, "params"), mu=_flat(o0["mu"], "mu"),
                         loss=float(m0["loss"]), grad_norm=float(m0["grad_norm"]))
        if kind == "protonets":
            pc, mu, gnorm, efs, rows = _composition(jl, spec, adamw, params, opt, batch, key)
            ref["comp"] = dict(params=_flat(pc, "params"), mu=_flat(mu, "mu"), grad_norm=gnorm,
                               ef=[_flat(e, "ef") for e in efs],
                               grads=[_flat(g, "ef") for g in rows])
    inp["ten_batches"] = [_np_batch(sample_image_task_batch(jax.random.key(100 + s), tcfg, T))
                          for s in range(STEPS)]
    inp["ten_scores"] = [_scores(jax.random.fold_in(key, s)) for s in range(STEPS)]
    with open(d / "inp.pkl", "wb") as f:
        pickle.dump(inp, f)
    run_ranks([sys.executable, "-c", RANK_CODE, str(d / "inp.pkl"), str(d)], 4, d / "store",
              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=240)
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append((arrays, json.loads((d / f"rank{r}.json").read_text())))
    return ref, ranks


def _part(arrays, run, part):
    pre = f"{run}/{part}/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def _max_err(got, want, rel=False):
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) /
               (max(float(np.abs(want[k]).max()), 1e-30) if rel else 1.0) for k in got)


@pytest.mark.parametrize("run", ["d4", "t22", "t22_acc2"])
def test_dp_step_matches_single_device_reference(dp, run):
    ref, ranks = dp
    want = {k[len("params/"):]: v for k, v in ref["protonets"]["params"].items()}
    for arrays, info in ranks:
        assert _max_err(_part(arrays, run, "params"), want) < TOL_DP
        assert abs(info[run]["loss"] - ref["protonets"]["loss"]) < TOL_DP
        assert info[run]["nonfinite"] == 0.0 and info[run]["count"] == 1


@pytest.mark.parametrize("run, kind, tol", [
    ("d4", "protonets", TOL_DP), ("t22", "protonets", TOL_DP),
    ("t22_acc2", "protonets", TOL_DP), ("sc_t22", "simple_cnaps", TOL_SIMPLE_CNAPS)])
def test_dp_step_gradient_matches_single_device_reference(dp, run, kind, tol):
    """The gradient, which the first update (about lr * sign(g)) does not
    show: its global norm before the clip (the ``grad_norm`` metric) within
    ``tol`` of the reference's, and AdamW's first moment after the step,
    (1 - b1) times the clipped gradient, leaf by leaf within ``tol`` of the
    leaf's max|reference|.  A reduction that lost or doubled a division by
    dp or dcn fails on the norm, one that mixed the shards' weights on the
    moment."""
    ref, ranks = dp
    want = {k[len("mu/"):]: v for k, v in ref[kind]["mu"].items()}
    for arrays, info in ranks:
        assert abs(info[run]["grad_norm"] / ref[kind]["grad_norm"] - 1) <= tol
        assert _max_err(_part(arrays, run, "mu"), want, rel=True) <= tol


def test_dp_step_simple_cnaps_matches_single_device_reference(dp):
    ref, ranks = dp
    want = {k[len("params/"):]: v for k, v in ref["simple_cnaps"]["params"].items()}
    for arrays, info in ranks:
        assert _max_err(_part(arrays, "sc_t22", "params"), want, rel=True) <= TOL_SIMPLE_CNAPS
        loss = ref["simple_cnaps"]["loss"]
        assert abs(info["sc_t22"]["loss"] - loss) <= TOL_SIMPLE_CNAPS_LOSS * abs(loss)


@pytest.mark.parametrize("part", ["params", "mu", "nu"])
def test_two_level_dcn1_is_bit_equal_to_1d(dp, part):
    _, ranks = dp
    for arrays, info in ranks:
        a, b = _part(arrays, "t14", part), _part(arrays, "d4", part)
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
        assert info["t14"]["loss"] == info["d4"]["loss"]
        assert info["t14"]["count"] == info["d4"]["count"]


@pytest.mark.parametrize("run", ["d4", "t22", "t22_comp", "sc_t22"])
def test_every_rank_holds_the_same_state(dp, run):
    _, ranks = dp
    first = _part(ranks[0][0], run, "params")
    for arrays, info in ranks[1:]:
        got = _part(arrays, run, "params")
        assert all(np.array_equal(got[k], first[k]) for k in first)
        assert info[run] == ranks[0][1][run]


def test_compressed_step_matches_reference_composition(dp):
    ref, ranks = dp
    want = {k[len("params/"):]: v for k, v in ref["comp"]["params"].items()}
    mu = {k[len("mu/"):]: v for k, v in ref["comp"]["mu"].items()}
    for r, (arrays, info) in enumerate(ranks):
        assert _max_err(_part(arrays, "t22_comp", "params"), want) < TOL_EF
        # the gradient, which the first update does not show
        assert abs(info["t22_comp"]["grad_norm"] / ref["comp"]["grad_norm"] - 1) <= TOL_EF_GRAD
        assert _max_err(_part(arrays, "t22_comp", "mu"), mu, rel=True) <= TOL_EF_GRAD
        row = ref["comp"]["ef"][r // 2]           # rank = dcn * 2 + data
        ef = {k[len("ef/"):]: v for k, v in row.items()}
        got = _part(arrays, "t22_comp", "ef")
        grad = {k[len("ef/"):]: v for k, v in ref["comp"]["grads"][r // 2].items()}
        assert set(got) == set(ef)
        for k in got:
            assert np.abs(got[k] - ef[k]).max() <= TOL_EF_GRAD * np.abs(grad[k]).max(), k


def test_compressed_training_tracks_exact_and_learns(dp):
    _, ranks = dp
    ten = ranks[0][1]["ten"]
    assert ten["ef_l1"] > 0.0
    assert ten["drift"] < 2e-2 * max(ten["pnorm"], 1.0), ten
    assert ten["losses"][-1] < ten["losses"][0], ten["losses"]


@pytest.mark.parametrize("run", ["nan_pmean", "nan_comp"])
def test_nan_on_one_rank_skips_on_every_rank(dp, run):
    _, ranks = dp
    for _, info in ranks:
        assert info[run] == dict(nonfinite=1.0, same=True)


@pytest.mark.parametrize("reduce", ["t22", "t22_comp"])
def test_collectives_flat_in_accum_and_bytes_match_roofline(dp, reduce):
    _, ranks = dp
    for _, info in ranks:
        assert info[reduce + "/collectives"] == info[reduce + "_acc2/collectives"]
        for run in (reduce, reduce + "_acc2"):
            # the buffers handed to the collectives, counted at the calls,
            # against the roofline's prediction from the param bytes
            assert info[run + "/payload"] == info[run + "/want_payload"]
        assert info["d4/payload"] == {"all_reduce/data": info["d4/pbytes"] + 8}
    info = ranks[0][1]
    assert info["t22/collectives"] == {"all_reduce/data": 1, "all_reduce/dcn": 2}
    assert info["t22_comp/collectives"] == {"all_reduce/data": 1, "all_reduce/dcn": 2,
                                            "all_gather/dcn": 2}
    # 2 x 2 pmean on the wire: 2.0 x the fp32 param bytes, plus loss,
    # accuracy and the verdict
    assert dp_wire_bytes(info["t22/pbytes"], 2, 2) == 2 * info["t22/pbytes"] + 20


# -- single process: the checks made before any rank is needed --------------

def test_indivisible_batch_and_compressed_without_two_level_are_rejected():
    from repro_torch.core.episodic_train import make_batched_meta_train_step
    from repro_torch.core.lite import LiteSpec
    from repro_torch.launch.mesh import DPMesh

    class _Learner:
        pass

    one_d = DPMesh(shape={"data": 4}, axis_names=("data",), coords={"data": 0},
                   groups={}, host_group=None, rank=0, backend="gloo")
    with pytest.raises(ValueError, match="two-level mesh"):
        make_batched_meta_train_step(_Learner(), LiteSpec(h=4), mesh=one_d,
                                     grad_reduce="compressed")
    with pytest.raises(ValueError, match="grad_reduce"):
        make_batched_meta_train_step(_Learner(), LiteSpec(h=4), grad_reduce="mean")
    with pytest.raises(ValueError, match="lack dp_axis"):
        make_batched_meta_train_step(_Learner(), LiteSpec(h=4), mesh=one_d, dp_axis="x")
    step = make_batched_meta_train_step(_Learner(), LiteSpec(h=4), mesh=one_d,
                                        accum_steps=2)
    from repro_torch.core.episodic import TaskBatch
    tb = TaskBatch(*(torch.zeros(4, 1) for _ in FIELDS), way=5)
    with pytest.raises(ValueError, match="not divisible by dp_shards"):
        step({}, {}, tb, torch.zeros(4, 1))


@pytest.mark.parametrize("kw, match", [
    (dict(tasks_per_step=6, dp_shards=4), "divisible"),
    (dict(tasks_per_step=8, dp_shards=2, dcn_shards=2, accum_steps=4), "divisible"),
    (dict(grad_reduce="compressed", dcn_shards=1), "CROSS-HOST"),
    (dict(grad_reduce="psum"), "grad_reduce"),
    (dict(dp_shards=0), "must be >= 1"),
])
def test_meta_config_validates_at_construction(kw, match):
    with pytest.raises(ValueError, match=match):
        MetaTrainConfig(**kw)


def test_meta_config_takes_the_dp_knobs():
    cfg = MetaTrainConfig(tasks_per_step=8, dp_shards=2, dcn_shards=2,
                          grad_reduce="compressed", accum_steps=2)
    assert (cfg.dp_shards, cfg.dcn_shards, cfg.grad_reduce) == (2, 2, "compressed")


@pytest.mark.parametrize("build", ["dp", "two_level", "mesh_for"])
def test_mesh_errors_name_torchrun_and_the_world(build, monkeypatch):
    from repro_torch.launch import mesh as m
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    call = {"dp": lambda: m.make_dp_mesh(4),
            "two_level": lambda: m.make_two_level_dp_mesh(2, 2),
            "mesh_for": lambda: m.make_mesh_for((2, 2), ("dcn", "data"))}[build]
    with pytest.raises(ValueError, match=r"world has 1 rank.*--nproc-per-node 4"):
        call()


def test_episodic_step_needs_a_mesh_for_the_dp_knobs():
    from repro_torch.core.lite import LiteSpec
    from repro_torch.train.step import make_episodic_train_step
    with pytest.raises(ValueError, match="requires a mesh"):
        make_episodic_train_step(None, LiteSpec(h=4), MetaTrainConfig(dp_shards=2))
