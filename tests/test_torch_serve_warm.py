"""The port's two-tier task-state store: the L1 LRU, the disk warm tier
(its sharded layout, restart, rescan, quarantine, the warm fault sites),
spill -> rehydrate bit-exact for all five learner kinds, and the npz
payload read and written by both packages.

The store tests run the port alone; the layout, the uid hash, the seeded
fault plan and the payload are held against the JAX package's own."""
import numpy as np
import pytest
import torch

import jax
from repro.core.lite import LiteSpec as JLite
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.faults.plan import FaultPlan as JFaultPlan
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.serve.episodic import WarmTaskStore as JWarmTaskStore
from repro.serve.episodic import stable_uid_hash as j_hash
from repro.train.checkpoint import load_array_tree as j_load
from repro.train.checkpoint import save_array_tree as j_save
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.common.tree import tree_leaves, tree_paths
from repro_torch.core.episodic import index_task_state
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import KINDS, MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
from repro_torch.faults import WARM_CORRUPT, WARM_VANISH, FaultPlan
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.serve.episodic import (EpisodicRequest, EpisodicServeEngine,
                                        TaskStateCache, TwoTierTaskStore,
                                        WarmTaskStore, stable_uid_hash)
from repro_torch.train.checkpoint import load_array_tree, save_array_tree

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

WIDTHS, FDIM, IMG, WAY = (8, 16), 16, 12, 5
LITE = LiteSpec(exact=True, chunk_size=8)
TCFG = HostEpisodicConfig(way=WAY, shot=2, query_per_class=2, image_size=IMG)


def _learner(kind):
    return make_learner(MetaLearnerConfig(kind=kind, way=WAY, inner_steps=2),
                        make_conv_backbone(ConvBackboneConfig(widths=WIDTHS,
                                                              feature_dim=FDIM)),
                        SetEncoderConfig(conv_blocks=2, conv_width=8, task_dim=16))


def _params(learner):
    return learner.init(torch.Generator().manual_seed(0), "cpu")


def _states(learner, params, n=2, seed=3):
    """``n`` adapted single-task states of one host batch."""
    batch = host_task_batch_at(seed, TCFG, n, 0).to("cpu")
    states = learner.adapt_batch(params, batch, LITE)
    return [index_task_state(states, i) for i in range(n)]


def _requests(n, uids=None, seed=3, support=True):
    b = host_task_batch_at(seed, TCFG, n, 0)
    return [EpisodicRequest(uid=i if uids is None else uids[i],
                            support_x=b.support_x[i] if support else None,
                            support_y=b.support_y[i] if support else None,
                            query_x=b.query_x[i], way=WAY) for i in range(n)]


def _bit_equal(a, b) -> bool:
    pa, pb = tree_paths(a), tree_paths(b)
    return list(pa) == list(pb) and all(
        pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape
        and torch.equal(pa[k], pb[k]) for k in pa)


def _small_state():
    return dict(a=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                b=torch.ones(4, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the L1 and the warm tier's layout
# ---------------------------------------------------------------------------


def test_task_state_cache_overwrite_and_eviction_stats():
    spilled = []
    c = TaskStateCache(capacity=2, on_evict=lambda u, s: spilled.append((u, s)))
    c.put(1, "a")
    c.put(1, "a2")                       # overwrite: not a hit, not a miss
    assert (c.hits, c.misses, c.overwrites, c.evictions) == (0, 0, 1, 0)
    assert len(c) == 1 and c.get(1) == "a2"
    c.put(2, "b")
    c.put(1, "a3")                       # refreshes recency too
    c.put(3, "c")                        # evicts 2 (LRU), not 1
    assert (c.hits, c.misses, c.overwrites, c.evictions) == (1, 0, 2, 1)
    assert spilled == [(2, "b")]
    assert 2 not in c and 1 in c and 3 in c
    assert c.peek(1) == "a3" and c.get(2) is None
    assert (c.hits, c.misses) == (1, 1)


def test_warm_store_rescan_on_miss_cross_store(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32)}
    b = WarmTaskStore(tmp_path, shards=4)           # scans an empty dir
    a = WarmTaskStore(tmp_path, shards=4)
    a.put(7, state)                                 # after b's scan
    assert 7 in b
    assert torch.equal(b.get(7)["w"], state["w"])
    assert b.rescan_hits == 1
    assert b.get(999) is None
    # corruption found through b quarantines the entry and its sidecar, so
    # no store, now or later, brings it back
    a._path(7).write_bytes(b"junk")
    assert b.get(7) is None and b.quarantined == 1
    b2 = WarmTaskStore(tmp_path, shards=4)
    assert b2.get(7) is None and b2.quarantined == 0


def test_uid_hash_and_shard_layout_are_the_jax_packages(tmp_path):
    """Every uid's files live where the JAX package's store puts them
    (negative uids too); entries written under another shard count load
    and migrate to the canonical shard on the next put."""
    uids = list(range(-6, 12)) + [2**40 + 3, -(2**62)]
    assert [stable_uid_hash(u) for u in uids] == [j_hash(u) for u in uids]
    state = {"w": torch.ones(3)}
    s = WarmTaskStore(tmp_path, shards=8)
    for uid in uids:
        s.put(uid, state)
    assert not list(tmp_path.glob("uid_*"))         # nothing at the root
    jstore = JWarmTaskStore(tmp_path, shards=8)
    assert jstore.template_restores == 0            # it lists no port sidecar
    for uid in uids:
        assert (jstore._shard_dir(uid) / f"uid_{uid}.npz").exists(), uid
        assert (jstore._shard_dir(uid) / f"uid_{uid}.tmpl.json").exists(), uid
        assert WarmTaskStore(tmp_path, shards=8).get(uid) is not None

    flat = tmp_path / "flat"
    WarmTaskStore(flat, shards=1).put(3, state)
    resharded = WarmTaskStore(flat, shards=8)
    assert resharded.get(3) is not None
    resharded.put(3, state)                         # migrates
    assert not (flat / "uid_3.npz").exists()
    canon = flat / f"shard_{j_hash(3) % 8}"
    assert (canon / "uid_3.npz").exists()
    assert WarmTaskStore(flat, shards=8).get(3) is not None


def test_restart_serves_every_surviving_uid(tmp_path):
    learner = _learner("simple_cnaps")
    sts = _states(learner, _params(learner), n=3)
    first = WarmTaskStore(tmp_path, shards=2)
    for uid, st in enumerate(sts):
        first.put(uid, st)
    (first._tmpl_path(2)).write_text("{not json")    # an unreadable sidecar
    again = WarmTaskStore(tmp_path, shards=2)
    assert again.template_restores == 2 and len(again) == 2
    assert not again._tmpl_path(2).exists()         # dropped
    for uid in (0, 1):
        assert _bit_equal(again.get(uid), sts[uid])
    assert again.get(2) is None and again.quarantined == 0


# ---------------------------------------------------------------------------
# spill -> rehydrate, every learner kind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_spill_rehydrate_roundtrip_bitexact(kind, tmp_path):
    learner = _learner(kind)
    st0, st1 = _states(learner, _params(learner))
    store = TwoTierTaskStore(capacity=1, warm_dir=tmp_path, device="cpu")
    store.put(0, st0)
    store.put(1, st1)                    # capacity 1: spills uid 0
    assert store.spills == 1 and len(store.l1) == 1
    back = store.get(0)                  # L1 miss -> rehydrate
    assert store.rehydrates == 1
    assert _bit_equal(back, st0), kind
    assert all(t.device.type == "cpu" for t in tree_leaves(back))
    assert store.spills == 2             # the promotion spilled uid 1
    assert _bit_equal(store.get(1), st1), kind


@pytest.mark.parametrize("kind", KINDS)
def test_capacity1_thrash_rehydrates_bitexact(kind, tmp_path):
    """Repeats (support-less) through a capacity-1 L1 are all served by
    rehydration, with logits bit-equal to each user served alone, and the
    dispatch counts flat."""
    learner = _learner(kind)
    params = _params(learner)
    kw = dict(lite=LITE, n_slots=1, query_chunk=4, support_buckets=(16,),
              cache_capacity=1, device="cpu")
    solo = []
    for u in (0, 1):
        e = EpisodicServeEngine(learner, params, **kw)
        solo.append(_requests(2)[u])
        e.run_to_completion([solo[u]])
    eng = EpisodicServeEngine(learner, params, warm_dir=tmp_path, **kw)
    eng.run_to_completion(_requests(2))
    s = eng.stats()
    assert s["tasks_adapted"] == 2 and s["spills"] >= 1
    compiles = (s["adapt_compiles"], s["predict_compiles"])
    b = host_task_batch_at(3, TCFG, 2, 0)
    repeats = [EpisodicRequest(uid=u, query_x=b.query_x[u], way=WAY)
               for u in (0, 1, 0)]
    eng.run_to_completion(repeats)
    s = eng.stats()
    assert s["tasks_adapted"] == 2 and s["rehydrates"] >= 2
    assert (s["adapt_compiles"], s["predict_compiles"]) == compiles
    for r in repeats:
        assert r.done and r.cache_hit
        np.testing.assert_array_equal(r.all_logits(), solo[r.uid].all_logits(),
                                      err_msg=f"{kind} uid={r.uid}")



@pytest.mark.parametrize("kind", KINDS)
def test_rehydrated_and_fresh_states_share_a_cohort(kind, tmp_path):
    """A rehydrated state (a plain tensor from disk) and a freshly adapted
    one (from ``inference_mode``, or from FOMAML's and FineTuner's grad
    bodies) stack into one query dispatch, and each lane's logits are those
    of its user served alone."""
    learner = _learner(kind)
    params = _params(learner)
    kw = dict(lite=LITE, n_slots=2, query_chunk=4, support_buckets=(16,),
              device="cpu")
    eng = EpisodicServeEngine(learner, params, cache_capacity=1,
                              warm_dir=tmp_path, **kw)
    first = _requests(3)
    eng.run_to_completion(first[:2])              # uid 0 spilled
    repeat = EpisodicRequest(uid=0, query_x=first[0].query_x, way=WAY)
    new = _requests(3)[2]
    eng.run_to_completion([repeat, new])          # one cohort
    s = eng.stats()
    assert s["rehydrates"] == 1 and s["tasks_adapted"] == 3
    assert (s["adapt_compiles"], s["predict_compiles"]) == (1, 1)
    for r in (repeat, new):
        alone = _requests(3)[r.uid]
        EpisodicServeEngine(learner, params, **kw).run_to_completion([alone])
        np.testing.assert_array_equal(r.all_logits(), alone.all_logits(),
                                      err_msg=f"{kind} uid={r.uid}")

# ---------------------------------------------------------------------------
# quarantine and the warm fault sites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep_bytes", [0, 40])
def test_warm_store_truncated_file_quarantined(tmp_path, keep_bytes):
    w = WarmTaskStore(tmp_path / "warm")
    w.put(5, _small_state())
    with open(w._path(5), "r+b") as f:
        f.truncate(keep_bytes)
    assert w.get(5) is None and w.quarantined == 1
    assert not w._path(5).exists()
    assert len(list((tmp_path / "warm").glob("quarantine_uid_5_*.npz"))) == 1
    assert 5 not in w
    assert w.get(5) is None and w.quarantined == 1   # a miss now, not a recount


def test_warm_store_corrupt_fault_site(tmp_path):
    plan = FaultPlan.single(WARM_CORRUPT, at=5, payload=32)
    w = WarmTaskStore(tmp_path / "warm", fault_plan=plan)
    w.put(4, _small_state())                        # untargeted: intact
    w.put(5, _small_state())
    assert plan.fired_count(WARM_CORRUPT) == 1 and plan.fired_count() == 1
    assert w.get(5) is None and w.quarantined == 1
    assert _bit_equal(w.get(4), _small_state()) and w.quarantined == 1


def test_spill_survives_vanished_warm_dir(tmp_path):
    plan = FaultPlan.single(WARM_VANISH)
    store = TwoTierTaskStore(1, warm_dir=tmp_path / "warm", fault_plan=plan,
                             device="cpu")
    store.put(1, _small_state())
    store.put(2, _small_state())                    # evicts 1: the spill dies
    assert store.spill_errors == 1 and store.warm_disabled
    assert store.get(1) is None                     # discarded
    store.put(3, _small_state())                    # further evictions: silent
    assert store.spill_errors == 1 and plan.fired_count(WARM_VANISH) == 1
    assert store.get(3) is not None and 2 not in store


def test_device_copy_errors_are_not_disk_faults(tmp_path, monkeypatch):
    """An error of the copy to the host (spill) or back to the device
    (rehydrate) propagates: it is neither a spill error nor a quarantine."""
    planted = RuntimeError("CUDA error: an illegal memory access was encountered")
    store = TwoTierTaskStore(1, warm_dir=tmp_path, device="cpu")
    store.put(1, _small_state())
    store.put(2, _small_state())                    # uid 1 on disk

    def bad_to(self, *args, **kwargs):              # a device move only
        if args and isinstance(args[0], (torch.device, str)):
            raise planted
        return real_to(self, *args, **kwargs)

    real_to = torch.Tensor.to
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "to", bad_to)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            store.get(1)
    assert store.quarantined == 0 and store.rehydrates == 0
    assert 1 in store.warm and _bit_equal(store.get(1), _small_state())

    def bad_cpu(self, *args, **kwargs):
        raise planted

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", bad_cpu)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            store.put(3, _small_state())            # evicts: the spill's copy
    assert store.spill_errors == 0 and not store.warm_disabled


def test_seeded_fault_plan_is_the_jax_packages():
    for seed in (0, 7):
        got = FaultPlan.seeded(seed, WARM_CORRUPT, 50, 0.2, payload=8)
        want = JFaultPlan.seeded(seed, WARM_CORRUPT, 50, 0.2, payload=8)
        assert [(s.site, s.at, s.payload) for s in got.specs] == \
            [(s.site, s.at, s.payload) for s in want.specs]
    plan = FaultPlan.single(WARM_VANISH).extend(FaultPlan.single(WARM_CORRUPT))
    assert plan.fire(WARM_CORRUPT, 3) is not None and plan.fire(WARM_VANISH, 1)
    assert plan.fired_count(WARM_CORRUPT) == 1 and plan.fired_count() == 2


# ---------------------------------------------------------------------------
# the npz payload, both ways
# ---------------------------------------------------------------------------


def test_payload_crosses_between_the_packages(tmp_path):
    """A FOMAML state (a whole backbone: 4-D conv leaves, HWIO on disk) made
    from bridged weights: the port writes and JAX reads it with its crc32
    checked, and JAX writes and the port reads, both bit-exact."""
    jl = j_make(JCfg(kind="fomaml", way=WAY, inner_steps=2),
                j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)))
    jp = jl.init(jax.random.key(0))
    tl = _learner("fomaml")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    (t_state,) = _states(tl, tp, n=1)
    assert any(t.dim() == 4 for t in tree_leaves(t_state))
    b = host_task_batch_at(3, TCFG, 1, 0)
    j_state = jax.jit(lambda p, sx, sy: jl.adapt(
        p, sx, sy, key=jax.random.key(0), lite=JLite(exact=True, chunk_size=8)))(
            jp, b.support_x[0], b.support_y[0])
    j_tmpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j_state)

    save_array_tree(tmp_path / "port.npz", t_state)
    got = j_load(tmp_path / "port.npz", j_tmpl, verify=True)
    want = params_to_numpy(t_state)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(np.asarray(g), w),
                 got, want)

    j_save(tmp_path / "jax.npz", j_state)
    back = load_array_tree(tmp_path / "jax.npz", t_state, verify=True)
    assert _bit_equal(back, params_from_numpy(
        jax.tree.map(np.asarray, j_state), device="cpu"))
