"""The port's on-device task sampler, bucketed collation and step cache,
the log-domain quantisers and int8 AdamW state, and checkpoints that
cross-load with the JAX package's:

* the class patterns' bilinear upsampling against ``jax.image.resize(...,
  "linear")`` on the same arrays, within 1e-6 (measured 4.8e-7);
* the device sampler (on the CPU here): the same (seed, step) gives the
  same batch bit for bit, another step or seed another; a class's mean
  over its examples has RMS ``class_sep`` and the examples scatter around
  it with std ``noise`` (each within 5 %), the support rows shuffled;
* ``collate_with_buckets`` bit-exact with the JAX package's;
* ``BucketedStepCache.compile_count`` equal to the JAX cache's on the same
  ragged stream, and flat once every bucket has been seen;
* the log-domain quantisers: the integer codes and scales equal to the JAX
  package's where a block holds a zero (as AdamW's fresh second moment
  does), within one code and one ulp of scale elsewhere (each framework
  takes its own log), ``dequantize_log`` within 4 ulp; their zeros bit-exact;
* int8 AdamW over 3 steps against the JAX package's on the same params and
  gradients, a conv leaf among them: params within 1e-6 of each leaf's
  max|reference|, the state's codes within one quantisation step, its
  scales within 1e-6 relative, in the JAX package's (HWIO) layout;
* checkpoints: a step directory written by the JAX ``CheckpointManager``
  restores in the port equal to the bridged state, and one written by the
  port restores in the JAX package equal to the original, for fp32, bf16
  and int8 AdamW state; the bridge's round trip is exact;
* the launcher trains on the CPU from both sources.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.episodic import Task as JTask
from repro.core.lite import LiteSpec as JLite
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.data.episodic import collate_with_buckets as j_collate_buckets
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import quant as jq
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.pipeline import BucketedStepCache as JBucketedStepCache
from repro_torch.bridge import (opt_state_from_numpy, opt_state_to_numpy,
                                params_from_numpy, params_to_numpy)
from repro_torch.common.tree import tree_leaves, tree_paths
from repro_torch.core.episodic import Task
from repro_torch.core.episodic_train import make_batched_meta_train_step
from repro_torch.core.lite import LiteSpec, index_scores
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.data.episodic import (EpisodicImageConfig, collate_with_buckets,
                                       image_task_stream, plan_buckets,
                                       task_batch_at, upsample_patterns)
from repro_torch.launch.train import main as train_main
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim import quant as tq
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.quant import is_quantized
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.pipeline import BucketedStepCache

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL_RESIZE = 1e-6


@pytest.mark.parametrize("size", [16, 24, 30])
def test_upsampling_matches_jax_resize(size):
    base = np.random.default_rng(size).standard_normal(
        (2, 5, size // 4, size // 4, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(base), (2, 5, size, size, 3), "linear"))
    got = upsample_patterns(torch.from_numpy(base), size).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_RESIZE * np.abs(want).max()


def test_device_sampler_is_a_pure_function_of_its_step():
    cfg = EpisodicImageConfig(way=5, shot=3, query_per_class=2, image_size=12)
    a, b = task_batch_at(7, cfg, 3, 4, "cpu"), task_batch_at(7, cfg, 3, 4, "cpu")
    for f in ("support_x", "support_y", "query_x", "query_y", "support_mask", "query_mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.support_x, task_batch_at(7, cfg, 3, 5, "cpu").support_x)
    assert not torch.equal(a.support_x, task_batch_at(8, cfg, 3, 4, "cpu").support_x)
    assert a.support_x.shape == (3, 15, 12, 12, 3) and a.support_x.dtype == torch.float32
    assert a.query_x.shape == (3, 10, 12, 12, 3) and a.support_y.dtype == torch.int64
    assert bool((a.support_mask == 1).all()) and bool((a.query_mask == 1).all())
    for t in range(3):      # every class shot times; queries class by class
        assert torch.equal(torch.bincount(a.support_y[t], minlength=5), torch.full((5,), 3))
        assert torch.equal(a.query_y[t], torch.arange(5).repeat_interleave(2))
    assert any(not torch.equal(a.support_y[t], a.support_y[t].sort().values)
               for t in range(3))
    stream = image_task_stream(7, cfg, "cpu")
    first, second = next(stream), next(stream)
    assert isinstance(first, Task) and first.support_x.shape == (15, 12, 12, 3)
    assert not torch.equal(first.support_x, second.support_x)


def test_device_sampler_statistics():
    cfg = EpisodicImageConfig(way=5, shot=64, query_per_class=2, image_size=16,
                              class_sep=0.5, noise=1.5)
    b = task_batch_at(3, cfg, 4, 0, "cpu")
    order = torch.argsort(b.support_y, dim=1, stable=True)
    x = torch.stack([b.support_x[t, order[t]] for t in range(4)]).reshape(
        4, 5, 64, 16, 16, 3).double()
    mean = x.mean(dim=2)                            # (T, way, H, W, C)
    noise_sd = float(torch.sqrt(((x - mean[:, :, None]) ** 2).sum() /
                                (x.numel() - mean.numel())))
    sep = float(torch.sqrt(torch.mean(mean ** 2) - cfg.noise ** 2 / cfg.shot))
    assert abs(noise_sd - cfg.noise) <= 0.05 * cfg.noise
    assert abs(sep - cfg.class_sep) <= 0.05 * cfg.class_sep


def _ragged_tasks():
    rng = np.random.default_rng(3)
    tasks = []
    for n, m in ((7, 5), (12, 9), (3, 2)):
        tasks.append(JTask(rng.standard_normal((n, 4, 4, 3)).astype(np.float32),
                           rng.integers(0, 5, n).astype(np.int32),
                           rng.standard_normal((m, 4, 4, 3)).astype(np.float32),
                           rng.integers(0, 5, m).astype(np.int32), 5))
    return tasks


def test_collate_with_buckets_is_bit_exact():
    tasks = _ragged_tasks()
    for group in (tasks, tasks[2:], tasks[:1]):
        want = j_collate_buckets(group, (8, 16), (4, 12))
        got = collate_with_buckets(group, (8, 16), (4, 12))
        for f in ("support_x", "support_y", "query_x", "query_y", "support_mask",
                  "query_mask"):
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    with pytest.raises(ValueError, match="exceeds every planned bucket"):
        collate_with_buckets(tasks, (8,), (16,))


def test_step_cache_count_is_flat_on_a_ragged_stream():
    learner = make_learner(MetaLearnerConfig(kind="protonets", way=3), make_conv_backbone(
        ConvBackboneConfig(widths=(4,), feature_dim=8)))
    params = learner.init(torch.Generator().manual_seed(0), "cpu")
    cfg = AdamWConfig(weight_decay=0.0)
    opt = adamw_init(params, cfg)
    step = BucketedStepCache(make_batched_meta_train_step(learner, LiteSpec(h=4),
                                                          adamw=cfg))
    j_step = JBucketedStepCache(lambda batch: jnp.sum(batch.support_x))
    shots = [2, 3, 5, 2, 5, 3, 2, 5, 3, 2]   # ragged stream, 3 size modes
    s_buckets = plan_buckets([3 * s for s in shots], max_buckets=2, multiple=4)
    q_buckets = plan_buckets([6] * len(shots), max_buckets=1, multiple=4)
    counts = []
    for i, shot in enumerate(shots):
        t = next(image_task_stream(100 + i, EpisodicImageConfig(
            way=3, shot=shot, query_per_class=2, image_size=10), "cpu"))
        task = JTask(*(a.numpy() for a in (t.support_x, t.support_y, t.query_x,
                                           t.query_y)), way=3)
        batch = collate_with_buckets([task], s_buckets, q_buckets)
        j_step(j_collate_buckets([task], s_buckets, q_buckets))
        tb = batch.to("cpu")
        params, opt, _ = step(params, opt, tb,
                              index_scores(0, i, [0], tb.support_y.shape[1]))
        counts.append(step.compile_count)
    assert counts[-1] == j_step.compile_count <= len(s_buckets) * len(q_buckets)
    assert counts[4:] == [counts[4]] * (len(counts) - 4)


def _positive(shape, seed, zero_per_block):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) ** 2 * 10.0 ** rng.integers(-12, 3, shape)).astype(np.float32)
    if zero_per_block:
        x[..., ::tq.BLOCK] = 0.0
    return x


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (300,), (5, 257)])
def test_log_quantisers_match_jax(shape):
    for zero_per_block in (True, False):
        x = _positive(shape, len(shape), zero_per_block)
        j, t = jq.quantize_log(jnp.asarray(x)), tq.quantize_log(torch.from_numpy(x))
        jcode, tcode = np.asarray(j["q"]).astype(int), t["q"].numpy().astype(int)
        jscale, tscale = np.asarray(j["scale"]), t["scale"].numpy()
        assert t["n"] == j["n"] == shape[-1] and tcode.shape == jcode.shape
        if zero_per_block:
            assert np.array_equal(tcode, jcode) and np.array_equal(tscale, jscale)
        else:
            assert np.abs(tcode - jcode).max() <= 1
            np.testing.assert_array_max_ulp(tscale, jscale, maxulp=1)
        # dequantized from the same codes and scales
        same = dict(q=torch.from_numpy(np.array(j["q"])),
                    scale=torch.from_numpy(np.array(jscale)), n=j["n"])
        np.testing.assert_array_max_ulp(tq.dequantize_log(same).numpy(),
                                        np.asarray(jq.dequantize_log(j)), maxulp=4)
    for jz, tz in ((jq.zeros_quantized(shape), tq.zeros_quantized(shape)),
                   (jq.zeros_quantized_log(shape), tq.zeros_quantized_log(shape))):
        assert np.array_equal(np.asarray(jz["q"]), tz["q"].numpy())
        assert np.array_equal(np.asarray(jz["scale"]), tz["scale"].numpy())
        assert jz["n"] == tz["n"]


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return dict(conv=dict(w=f(3, 3, 2, 160), b=f(160)), head=[dict(w=f(160, 5), b=f(5))])


def test_int8_adamw_matches_jax():
    jcfg = JAdamW(weight_decay=0.1, state_dtype="int8")
    tcfg = AdamWConfig(weight_decay=0.1, state_dtype="int8")
    jp = jax.tree.map(jnp.asarray, _np_tree(0))
    js = j_adamw_init(jp, jcfg)
    tp = params_from_numpy(_np_tree(0), device="cpu")
    ts = adamw_init(tp, tcfg)
    for step in range(3):
        g = _np_tree(10 + step, scale=0.1)
        jp, js = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), js, 3e-2, jcfg)
        tp, ts = adamw_update(tp, params_from_numpy(g, device="cpu"), ts, 3e-2, tcfg)
    want = tree_paths(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    for k, a in tree_paths(tp).items():
        assert float((a - want[k]).abs().max()) <= 1e-6 * float(want[k].abs().max()), k
    assert int(ts["count"]) == int(js["count"]) == 3
    # the state in the JAX package's layout: the conv leaf's codes are HWIO
    assert ts["mu"]["conv"]["w"]["q"].shape == (3, 3, 2, 160)
    for part in ("mu", "nu"):
        got = tree_paths(ts[part])
        for k, a in tree_paths(jax.tree.map(np.asarray, js[part])).items():
            b = got[k]
            if k.endswith("/q"):
                assert np.abs(b.numpy().astype(int) - a.astype(int)).max() <= 1, k
            elif k.endswith("/scale"):
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, err_msg=k)
            else:
                assert int(b) == int(a), k


def _jax_state(state_dtype):
    jl = j_make(JCfg(kind="protonets", way=5), j_bb(JBBCfg(widths=(4, 8), feature_dim=160)))
    jp = jl.init(jax.random.key(0))
    cfg = JAdamW(weight_decay=0.1, state_dtype=state_dtype)
    grads = jax.tree.map(lambda p: 0.1 * jnp.cos(jnp.arange(p.size, dtype=jnp.float32)
                                                 ).reshape(p.shape), jp)
    jp, opt = j_adamw_update(jp, grads, j_adamw_init(jp, cfg), 3e-2, cfg)
    return dict(params=jp, opt=opt)


def _to_port(jstate):
    return dict(params=params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                                         device="cpu"),
                opt=opt_state_from_numpy(jax.tree.map(np.asarray, jstate["opt"]),
                                         device="cpu"))


def _same(a, b):
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_checkpoints_cross_load(tmp_path, state_dtype):
    jstate = _jax_state(state_dtype)
    pstate = _to_port(jstate)
    if state_dtype == "int8":
        assert is_quantized(pstate["opt"]["mu"]["bb"]["blocks"][0]["w"])
    # written by the JAX package, restored by the port
    JCheckpointManager(tmp_path / "jax").save(3, jstate)
    step, back, _ = CheckpointManager(tmp_path / "jax").restore_latest(pstate)
    got, want = tree_paths(back), tree_paths(pstate)
    assert step == 3 and set(got) == set(want)
    assert all(_same(got[k], want[k]) for k in want)
    assert back["params"]["bb"]["blocks"][0]["w"].shape == (4, 3, 3, 3)      # OIHW
    # written by the port, restored by the JAX package
    CheckpointManager(tmp_path / "port").save(5, pstate)
    jback, _ = JCheckpointManager(tmp_path / "port").restore(5, jstate)
    flat_j = jax.tree_util.tree_flatten_with_path(jback)[0]
    flat_w = jax.tree.leaves(jstate)
    assert len(flat_j) == len(flat_w)
    for (path, a), b in zip(flat_j, flat_w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b), path
    # and the port's own round trip
    _, again, _ = CheckpointManager(tmp_path / "port").restore_latest(pstate)
    assert all(_same(a, b) for a, b in zip(tree_leaves(again), tree_leaves(pstate)))
    # a template of another shape (or a leaf stored in another layout) raises
    wrong = dict(pstate, params=dict(pstate["params"], bb=dict(
        pstate["params"]["bb"], blocks=[dict(w=torch.zeros(3, 4, 3, 3), b=torch.zeros(4)),
                                        pstate["params"]["bb"]["blocks"][1]])))
    with pytest.raises(ValueError, match="params/bb/blocks/0/w"):
        CheckpointManager(tmp_path / "port").restore(5, wrong)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_bridge_round_trip(state_dtype):
    jstate = jax.tree.map(np.asarray, _jax_state(state_dtype))
    pstate = _to_port(jstate)
    for back, want in ((params_to_numpy(pstate["params"]), jstate["params"]),
                       (opt_state_to_numpy(pstate["opt"]), jstate["opt"])):
        bl, wl = jax.tree.leaves(back), jax.tree.leaves(want)
        assert len(bl) == len(wl)
        for a, b in zip(bl, wl):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("source", ["device", "host"])
def test_launcher_trains_from_both_sources(tmp_path, capsys, source):
    train_main(["--episodic", "--device", "cpu", "--data-source", source, "--steps", "2",
                "--tasks-per-step", "2", "--image-size", "12", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"data_source={source} kernel_backend=auto device=cpu" in out
    assert "done at step 2; resumed_from=None" in out
