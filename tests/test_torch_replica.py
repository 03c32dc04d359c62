"""The port's replica router (``repro_torch.serve.replica``) against the JAX
package's ``repro.serve.replica``, and the serving layouts over
``torch.distributed`` groups (gloo ranks on the CPU).

In one process (``mesh=None``) the port's router and the reference's run
on the same weights (``bridge.params_from_numpy``) and requests (the numpy
host sampler), both on their ``ref`` kernel backends: the routing, every
integer counter of ``stats()`` and of each ``per_replica`` dict, and the
failover counts under one ``replica.dead`` plan are equal; logits agree
within tests/test_torch_engine.py's serving tolerances of max|logit| (1e-5,
and 4e-3 for Simple CNAPs, whose covariance amplifies the two frameworks'
convolution differences, ROADMAP C1).  The port's own contracts follow the
reference's tests/test_replica.py and the three ``replica.dead`` tests of
tests/test_faults.py: resizing keeps spilled states bit-exact, rejections
are priced by the routed replica's EWMA, int8 composes per replica,
failover reroutes, rehydrates bit-exactly, fails a supportless orphan and
guards the last replica.

Two launches of gloo ranks (``launch/local_ranks.py::run_ranks``, no JAX in
them) cover the mesh mode:

* 4 ranks as 2 replicas x 2: the router under each layout of
  ``SERVING_LAYOUTS``.  ``replicated`` is bit-equal to one solo engine in
  this process; ``weight_stationary`` and ``training`` sum in another order,
  so their logits are held at the tolerances above and Simple CNAPs' head
  inputs (the adapted FiLM and class means) at 1e-5 of max.  Every layout
  is also held, at the same tolerances, against the JAX engine's
  ``serve_layout`` on two replica meshes of 2 forced host devices, run in a
  subprocess beside the ranks.  Both ranks of a group hold the same logits;
  a dispatch's payloads equal ``roofline.serving_payloads``; no collective
  runs outside ``serve`` and the host group; a ``replica.dead`` fault on
  group 1 gives the in-process router's counts, bits, enqueue times and
  pooled latencies.
* 2 ranks as one group of 2: a replica group's predict wire equals a solo
  2-rank engine's, and a group of 4's (the first launch) is larger; a
  serving axis named ``tp`` is read from the mesh by every consumer.

The layouts cannot run on the card here; chip_smoke.py phase 4c runs them
there.
"""
import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import FakeClock
from repro.core.lite import LiteSpec as JLite
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.faults.plan import REPLICA_DEAD as J_REPLICA_DEAD
from repro.faults.plan import FaultPlan as JFaultPlan
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.serve.episodic import EpisodicRequest as JRequest
from repro.serve.replica import ReplicatedServeEngine as JRouter
from repro.serve.replica import uid_replica as j_uid_replica
from repro_torch.bridge import params_from_numpy
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
from repro_torch.faults import REPLICA_DEAD, FaultPlan
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
from repro_torch.serve.replica import (DEFAULT_WARM_SHARDS, ReplicatedServeEngine,
                                       uid_replica)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTHS, FDIM, IMG, WAY = (8, 16), 48, 12, 5
SET_KW = dict(conv_blocks=2, conv_width=8, task_dim=16)
TOLS = {"protonets": 1e-5, "simple_cnaps": 4e-3}
TOL_HEAD_INPUTS = 1e-5
TCFG = HostEpisodicConfig(way=WAY, shot=3, query_per_class=2, image_size=IMG)
ENGINE_KW = dict(n_slots=2, query_chunk=4, support_buckets=(16,))
# the integer counters of a replica's stats() (the latencies are floats)
COUNTERS = ("tasks_adapted", "queries_served", "steps", "queue_depth", "cache_hits",
            "cache_misses", "evictions", "overwrites", "spills", "rehydrates",
            "rescan_hits", "quarantined", "spill_errors", "rejections",
            "deadline_abandoned", "failed_requests", "slo_preemptions",
            "adapt_compiles", "predict_compiles")
ROUTER_COUNTERS = COUNTERS + ("n_replicas", "live_replicas", "replica_failovers",
                              "rerouted_requests", "failover_failed")


@functools.lru_cache(maxsize=None)
def _models(kind):
    jl = j_make(JCfg(kind=kind, way=WAY), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(**SET_KW))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=WAY),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)),
                      SetEncoderConfig(**SET_KW))
    jp = jl.init(jax.random.key(0))
    return jl, jp, tl, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _task(uid, seed=11):
    b = host_task_batch_at(seed + uid, TCFG, 1, 0)
    return b.support_x[0], b.support_y[0], b.query_x[0]


def _request(uid, support=True, pkg="torch"):
    sx, sy, qx = _task(uid)
    cls = JRequest if pkg == "jax" else EpisodicRequest
    return cls(uid=uid, support_x=sx if support else None,
               support_y=sy if support else None, query_x=qx, way=WAY)


def _router(kind="protonets", pkg="torch", **kw):
    jl, jp, tl, tp = _models(kind)
    kw = dict(ENGINE_KW, kernel_backend="ref", **kw)
    if pkg == "jax":
        return JRouter(jl, jp, lite=JLite(exact=True, chunk_size=8), **kw)
    return ReplicatedServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8),
                                 device="cpu", **kw)


def _solo(kind="protonets", **kw):
    _, _, tl, tp = _models(kind)
    return EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8),
                               device="cpu", kernel_backend="ref", **dict(ENGINE_KW, **kw))


def _uids_for(replica, replicas, n, start=0):
    out, u = [], start
    while len(out) < n:
        if uid_replica(u, replicas) == replica:
            out.append(u)
        u += 1
    return out


def _close(got, want, kind):
    assert got.shape == want.shape
    if want.size:
        assert np.abs(got - want).max() <= TOLS[kind] * np.abs(want).max()


def _same_counters(st, sj):
    for k in ROUTER_COUNTERS:
        assert st[k] == sj[k], (k, st[k], sj[k])
    assert len(st["per_replica"]) == len(sj["per_replica"])
    for pt, pj in zip(st["per_replica"], sj["per_replica"]):
        for k in COUNTERS:
            assert pt[k] == pj[k], (k, pt[k], pj[k])


def test_uid_replica_matches_reference():
    for replicas in (1, 2, 3, 4, 8):
        got = [uid_replica(u, replicas) for u in range(10_000)]
        assert got == [j_uid_replica(u, replicas) for u in range(10_000)]
    assert DEFAULT_WARM_SHARDS == 8


@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
def test_router_matches_reference(kind):
    """A mixed-uid workload (a cold wave, then support-less repeats) through
    2 replicas of each package: the same routing, the same counters, logits
    within the serving tolerance; the port's router is bit-equal to its own
    solo engine (which replica adapts a task never changes its logits)."""
    uids = list(range(6))
    assert len({uid_replica(u, 2) for u in uids}) == 2
    runs = {}
    for pkg in ("jax", "torch"):
        router = _router(kind, pkg, replicas=2, clock=FakeClock())
        reqs = [_request(u, pkg=pkg) for u in uids] + \
            [_request(u, False, pkg=pkg) for u in uids[:3]]
        router.run_to_completion(reqs)
        runs[pkg] = (router, reqs)
    (jr, jreqs), (tr, treqs) = runs["jax"], runs["torch"]
    assert [tr.route(u) for u in range(50)] == [jr.route(u) for u in range(50)]
    _same_counters(tr.stats(), jr.stats())
    assert tr.stats()["tasks_adapted"] == len(uids)
    solo = _solo(kind)
    sreqs = [_request(u) for u in uids] + [_request(u, False) for u in uids[:3]]
    solo.run_to_completion(sreqs)
    for a, b, s in zip(treqs, jreqs, sreqs):
        assert a.done and b.done and not a.failed
        _close(a.all_logits(), b.all_logits(), kind)
        np.testing.assert_array_equal(a.all_logits(), s.all_logits())


def test_resizing_replicas_keeps_spilled_states_bit_exact(tmp_path):
    """2 replicas spill every state to a shared warm root (an L1 of 1); a
    deployment of 4 over the same root serves every support-less repeat
    from it, bit-exactly, adapting nothing, though some uids moved home."""
    warm = tmp_path / "warm"
    uids = list(range(8))
    first = [_request(u) for u in uids]
    r2 = _router(replicas=2, warm_dir=warm, cache_capacity=1)
    r2.run_to_completion(first)
    r2.run_to_completion([_request(u) for u in _uids_for(0, 2, 1, start=100)
                          + _uids_for(1, 2, 1, start=100)])
    assert r2.stats()["spills"] >= len(uids)
    assert not list(warm.glob("uid_*")) and any(warm.glob("shard_*/uid_*.npz"))
    r4 = _router(replicas=4, warm_dir=warm, cache_capacity=1)
    assert [u for u in uids if uid_replica(u, 4) != uid_replica(u, 2)]
    repeats = [_request(u, False) for u in uids]
    r4.run_to_completion(repeats)
    s4 = r4.stats()
    assert all(r.done and not r.failed for r in repeats)
    assert s4["tasks_adapted"] == 0 and s4["rehydrates"] == len(uids)
    for a, b in zip(first, repeats):
        np.testing.assert_array_equal(a.all_logits(), b.all_logits())


def test_rejection_priced_by_routed_replica_ewma():
    router = _router(replicas=2, max_queue=1)
    router.replicas[0]._adapt_cost_est_us = 5000.0
    router.replicas[1]._adapt_cost_est_us = 100.0
    u0a, u0b = _uids_for(0, 2, 2)
    (u1,) = _uids_for(1, 2, 1)
    assert router.submit(_request(u0a))
    rej = _request(u0b)
    assert not router.submit(rej)
    assert rej.rejected and rej.retry_after_us == 5000.0
    ok = _request(u1)
    assert router.submit(ok) and not ok.rejected
    assert router.stats()["rejections"] == 1


def test_int8_composes_per_replica():
    """serve_quant='int8' on every replica: R x the solo int8 engine's
    resident bytes, and its logits bit for bit; the JAX router's counters."""
    router = _router(replicas=2, serve_quant="int8")
    reqs = [_request(u) for u in range(4)]
    router.run_to_completion(reqs)
    solo = _solo(serve_quant="int8")
    sreqs = [_request(u) for u in range(4)]
    solo.run_to_completion(sreqs)
    for a, b in zip(reqs, sreqs):
        np.testing.assert_array_equal(a.all_logits(), b.all_logits())
    rs, ss = router.stats(), solo.stats()
    assert rs["param_bytes_resident"] == 2 * ss["param_bytes_resident"]
    assert rs["frozen_param_bytes_resident"] < rs["frozen_param_bytes_fp32"]
    jr = _router(pkg="jax", replicas=2, serve_quant="int8")
    jr.run_to_completion([_request(u, pkg="jax") for u in range(4)])
    _same_counters(rs, jr.stats())
    assert rs["param_bytes_resident"] == jr.stats()["param_bytes_resident"]


def _failover(pkg, tmp_path):
    """The reference's reroute scenario: three uids homed on replica 1
    spilled (an L1 of 1), then ``replica.dead`` at 1 and their support-less
    repeats."""
    plan = JFaultPlan if pkg == "jax" else FaultPlan
    site = J_REPLICA_DEAD if pkg == "jax" else REPLICA_DEAD
    router = _router(pkg=pkg, replicas=2, warm_dir=tmp_path / f"warm_{pkg}",
                     cache_capacity=1)
    u1 = _uids_for(1, 2, 3)
    first = [_request(u, pkg=pkg) for u in u1]
    router.run_to_completion(first)
    router.run_to_completion([_request(u, pkg=pkg) for u in _uids_for(1, 2, 1, 100)])
    router.fault_plan = plan.single(site, at=1)
    repeats = [_request(u, False, pkg=pkg) for u in u1]
    router.run_to_completion(repeats)
    return router, first, repeats, u1


def test_replica_dead_reroutes_and_rehydrates_bit_exact(tmp_path):
    jr, jfirst, jrep, _ = _failover("jax", tmp_path)
    router, first, repeats, u1 = _failover("torch", tmp_path)
    s = router.stats()
    assert s["replica_failovers"] == 1 and s["live_replicas"] == 1
    assert s["rerouted_requests"] == len(u1)
    assert router.fault_plan.fired == [(REPLICA_DEAD, 1, "error")]
    assert all(router.route(u) == 0 for u in u1)
    for a, b, j in zip(first, repeats, jrep):
        assert b.done and not b.failed
        np.testing.assert_array_equal(a.all_logits(), b.all_logits())
        _close(b.all_logits(), j.all_logits(), "protonets")
    assert s["tasks_adapted"] == len(u1) + 1
    assert s["per_replica"][0]["rescan_hits"] >= len(u1)
    _same_counters(s, jr.stats())


def test_replica_dead_supportless_unspilled_fails_terminal():
    out = {}
    for pkg in ("jax", "torch"):
        router = _router(pkg=pkg, replicas=2)
        (u,) = _uids_for(1, 2, 1)
        router.run_to_completion([_request(u, pkg=pkg)])
        site = J_REPLICA_DEAD if pkg == "jax" else REPLICA_DEAD
        router.fault_plan = (JFaultPlan if pkg == "jax" else FaultPlan).single(site, at=1)
        orphan = _request(u, False, pkg=pkg)
        healthy = _request(_uids_for(1, 2, 2)[1], pkg=pkg)
        router.submit(orphan)
        router.submit(healthy)
        router.run_to_completion([])
        out[pkg] = (router.stats(), orphan, healthy)
    s, orphan, healthy = out["torch"]
    assert orphan.failed and orphan.done and not orphan.logits
    assert healthy.done and not healthy.failed
    assert s["replica_failovers"] == 1 and s["failover_failed"] == 1
    assert s["failed_requests"] >= 1 and s["per_replica"][0]["queries_served"] > 0
    _same_counters(s, out["jax"][0])
    _close(healthy.all_logits(), out["jax"][2].all_logits(), "protonets")


def test_last_replica_cannot_be_quarantined():
    router = _router(replicas=2)
    router.quarantine_replica(0)
    with pytest.raises(RuntimeError, match="last live"):
        router.quarantine_replica(1)
    assert all(router.route(u) == 1 for u in range(8))


def test_example_serves_through_replicas(capsys):
    from repro_torch.examples import serve_episodic
    s = serve_episodic.main(["--device", "cpu", "--replicas", "2", "--users", "4",
                             "--requests", "6", "--shot", "2"])
    said = capsys.readouterr().out
    assert "replica 0:" in said and "replica 1:" in said
    assert s["tasks_adapted"] == 4 and s["n_replicas"] == 2 and s["cache_hits"] == 2


# -- the mesh mode: gloo ranks -------------------------------------------------

RANK_CODE = r'''
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import params_from_numpy
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.faults import REPLICA_DEAD, FaultPlan
from repro_torch.launch import collectives
from repro_torch.launch.mesh import init_distributed, make_replica_mesh
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.roofline import (SERVING_LAYOUTS, choose_replica_serving_layout,
                                  score_serving_layout, serving_payloads)
from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
from repro_torch.serve.quant_params import quantize_frozen, serving_params
from repro_torch.serve.replica import ReplicatedServeEngine

inp = pickle.load(open(sys.argv[1], "rb"))
out_dir, which = sys.argv[2], sys.argv[3]
init_distributed("cpu", init_method=os.environ["RANKS_INIT_METHOD"])
rank = int(os.environ["RANK"])
tl = make_learner(MetaLearnerConfig(kind="simple_cnaps", way=5),
                  make_conv_backbone(ConvBackboneConfig(widths=(8, 16), feature_dim=48)),
                  SetEncoderConfig(conv_blocks=2, conv_width=8, task_dim=16))
tp = params_from_numpy(inp["params"], "cpu")
kw = dict(lite=LiteSpec(exact=True, chunk_size=8), n_slots=2, query_chunk=4,
          support_buckets=(16,), kernel_backend="ref", device="cpu", serve_quant="int8")
info, arrays = {}, {}

def reqs(support=True, uids=None):
    return [EpisodicRequest(uid=u, support_x=inp["tasks"][u][0] if support else None,
                            support_y=inp["tasks"][u][1] if support else None,
                            query_x=inp["tasks"][u][2], way=5)
            for u in (inp["uids"] if uids is None else uids)]

def probe():
    sw = quantize_frozen(tl, tp, "int8")
    eng = EpisodicServeEngine(tl, tp, **kw)
    eng.run_to_completion(reqs(uids=inp["uids"][:2]))
    st = [eng.store.l1.peek(u) for u in inp["uids"][:2]]
    from repro_torch.core.episodic import stack_task_states
    qx = torch.from_numpy(np.stack([inp["tasks"][u][2][:4] for u in inp["uids"][:2]]))
    fn = lambda w, s, q: tl.predict_batch(serving_params(w), s, q)
    return fn, sw, (stack_task_states(st), qx)

DEAD_KEYS = ("replica_failovers", "live_replicas", "rerouted_requests", "failover_failed",
             "tasks_adapted", "rehydrates", "spills", "query_p50_us", "query_p99_us",
             "adapt_p50_us", "adapt_p99_us")

if which == "2x2":
    mesh = make_replica_mesh(2, 2)
    own = mesh.coords["replica"]
    for layout in SERVING_LAYOUTS:
        collectives.counter.reset()
        router = ReplicatedServeEngine(tl, tp, replicas=2, mesh=mesh, serve_layout=layout, **kw)
        rs = reqs() + reqs(False, inp["uids"][:2])
        for r in rs:
            router.submit(r)
        while router.busy:
            router.step()
        for i, r in enumerate(rs):
            if router._home[i] == own:
                arrays[f"{layout}/own/{i}"] = r.all_logits()
        router.sync_results()
        for i, r in enumerate(rs):
            arrays[f"{layout}/all/{i}"] = r.all_logits()
        eng = router.replicas[own]
        for u in inp["uids"]:
            st = eng.store.l1.peek(u)
            if st is not None:
                arrays[f"{layout}/mu/{u}"] = st["mu"].numpy()
                arrays[f"{layout}/film/{u}"] = torch.cat(
                    [torch.cat([f["gamma"].ravel(), f["beta"].ravel()])
                     for f in st["film"]]).numpy()
        info[layout] = dict(stats={k: v for k, v in router.stats().items()
                                   if k != "per_replica"},
                            keys=sorted(collectives.counter.snapshot()))
        # one step of a group's engine: one adapt and one predict dispatch
        eng = EpisodicServeEngine(tl, tp, mesh=mesh, serve_layout=layout, **kw)
        for r in reqs(uids=inp["uids"][:2]):
            eng.submit(r)
        collectives.counter.reset()
        eng.step()
        got = collectives.counter.payload()
        sw = quantize_frozen(tl, tp, "int8")
        want = serving_payloads(sw, layout, 2, 2, 16, dispatch="adapt", way=5, chunk=8)
        for k, v in serving_payloads(sw, layout, 2, 2, 4).items():
            want[k] = want.get(k, 0) + v
        info[layout]["payload"], info[layout]["want_payload"] = got, want
        info[layout]["dispatches"] = [eng.adapt_dispatches, eng.predict_dispatches]
    # the scheduler's clock read from each group's index 0 (an SLO and a
    # deadline far away: the same decisions as without them)
    router = ReplicatedServeEngine(tl, tp, replicas=2, mesh=mesh,
                                   serve_layout="weight_stationary", query_slo_us=1e12,
                                   deadline_us=1e12, **kw)
    rs = router.run_to_completion(reqs() + reqs(False, inp["uids"][:2]))
    for i, r in enumerate(rs):
        arrays[f"slo/all/{i}"] = r.all_logits()
    info["slo"] = {k: router.stats()[k] for k in ("slo_preemptions", "deadline_abandoned")}
    pick = choose_replica_serving_layout(*probe(), mesh)
    info["pick"] = dict(choice=pick["choice"], per_replica=pick["per_replica_wire_bytes"],
                        rows={k: {c: v[c] for c in ("wire_bytes", "score", "bottleneck")}
                              for k, v in pick["rows"].items()})
    # replica.dead on group 1, the reference's failover scenario, on a
    # clock every rank sets alike: 1.0 while submitting, 2.0 while stepping
    now = [0.0]
    router = ReplicatedServeEngine(tl, tp, replicas=2, mesh=mesh, warm_dir=inp["warm"],
                                   clock=lambda: now[0], **dict(kw, cache_capacity=1))
    router.run_to_completion(reqs(uids=inp["u1"]))
    router.run_to_completion(reqs(uids=inp["u1_evict"]))
    router.fault_plan = FaultPlan.single(REPLICA_DEAD, at=1)
    rep = reqs(False, inp["u1"])
    now[0] = 1.0
    for r in rep:
        router.submit(r)
    now[0] = 2.0
    router.run_to_completion([])
    s = router.stats()
    info["dead"] = {k: s[k] for k in DEAD_KEYS}
    for i, r in enumerate(rep):
        arrays[f"dead/{i}"] = r.all_logits()
    info["dead"]["done"] = [bool(r.done and not r.failed) for r in rep]
    info["dead"]["t_enqueue"] = [r.t_enqueue for r in rep]
    mesh4 = make_replica_mesh(1, 4)
    info["ws_wire_group4"] = score_serving_layout(*probe(), mesh4, "weight_stationary")["wire_bytes"]
    info["ws_wire_group2"] = score_serving_layout(*probe(), mesh, "weight_stationary")["wire_bytes"]
else:
    mesh = make_replica_mesh(1, 2)
    info["ws_wire_solo2"] = score_serving_layout(*probe(), mesh, "weight_stationary")["wire_bytes"]
    # a serving axis named otherwise: the engine, the router, the warm
    # tier's writer, the group clock and the chooser read it from the mesh
    mesh_tp = make_replica_mesh(1, 2, axis="tp")
    collectives.counter.reset()
    router = ReplicatedServeEngine(tl, tp, replicas=1, mesh=mesh_tp,
                                   serve_layout="weight_stationary", query_slo_us=1e12,
                                   deadline_us=1e12, warm_dir=inp["warm"] + "_tp",
                                   **dict(kw, cache_capacity=1))
    rs = router.run_to_completion(reqs() + reqs(False, inp["uids"][:2]))
    for i, r in enumerate(rs):
        arrays[f"tp/all/{i}"] = r.all_logits()
    s = router.stats()
    info["tp"] = dict(keys=sorted(collectives.counter.snapshot()),
                      counts={k: s[k] for k in ("tasks_adapted", "spills", "rehydrates",
                                                "cache_hits")},
                      wire=score_serving_layout(*probe(), mesh_tp,
                                                "weight_stationary")["wire_bytes"])
np.savez(os.path.join(out_dir, f"{which}_rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"{which}_rank{rank}.json"), "w") as f:
    json.dump(info, f)
'''

JAX_LAYOUT_CODE = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.lite import LiteSpec
from repro.core.meta_learners import MetaLearnerConfig, make_learner
from repro.core.set_encoder import SetEncoderConfig
from repro.launch.mesh import make_replica_mesh
from repro.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro.roofline.analysis import SERVING_LAYOUTS
from repro.serve.episodic import EpisodicRequest
from repro.serve.replica import ReplicatedServeEngine, uid_replica

inp = pickle.load(open(sys.argv[1], "rb"))
assert len(jax.devices()) == 4
lr = make_learner(MetaLearnerConfig(kind="simple_cnaps", way=5),
                  make_conv_backbone(ConvBackboneConfig(widths=(8, 16), feature_dim=48)),
                  SetEncoderConfig(conv_blocks=2, conv_width=8, task_dim=16))
params = jax.tree.map(jnp.asarray, inp["params"])
kw = dict(lite=LiteSpec(exact=True, chunk_size=8), n_slots=2, query_chunk=4,
          support_buckets=(16,), kernel_backend="ref", serve_quant="int8")
uids = inp["uids"]
arrays = {}
for layout in SERVING_LAYOUTS:
    router = ReplicatedServeEngine(lr, params, replicas=2, meshes=make_replica_mesh(2, 2),
                                   serve_layout=layout, **kw)
    rs = [EpisodicRequest(uid=u, support_x=inp["tasks"][u][0] if sup else None,
                          support_y=inp["tasks"][u][1] if sup else None,
                          query_x=inp["tasks"][u][2], way=5)
          for sup, us in ((True, uids), (False, uids[:2])) for u in us]
    router.run_to_completion(rs)
    for i, r in enumerate(rs):
        assert r.done and not r.failed
        arrays[f"{layout}/all/{i}"] = r.all_logits()
    for u in uids:
        st = router.replicas[uid_replica(u, 2)].store.l1.get(u)
        arrays[f"{layout}/mu/{u}"] = np.asarray(st["mu"])
        arrays[f"{layout}/film/{u}"] = np.concatenate(
            [np.concatenate([np.ravel(f["gamma"]), np.ravel(f["beta"])]) for f in st["film"]])
np.savez(sys.argv[2], **arrays)
'''

UIDS = list(range(4))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("replica_ranks")
    jl, jp, tl, tp = _models("simple_cnaps")
    u1 = _uids_for(1, 2, 3)
    u1_evict = _uids_for(1, 2, 1, 100)
    tasks = {u: _task(u) for u in set(UIDS + u1 + u1_evict)}
    inp = dict(params=jax.tree.map(np.asarray, jp), tasks=tasks, uids=UIDS, u1=u1,
               u1_evict=u1_evict, warm=str(d / "warm"))
    with open(d / "inp.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # the JAX engine's layouts on 4 host devices, beside the gloo ranks
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", JAX_LAYOUT_CODE, str(d / "inp.pkl"),
                            str(d / "jax_layouts.npz")], env=jax_env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for which, world in (("2x2", 4), ("solo2", 2)):
            run_ranks([sys.executable, "-c", RANK_CODE, str(d / "inp.pkl"), str(d), which],
                      world, d / f"store_{which}", env=env, timeout=240)
            out[which] = []
            for r in range(world):
                with np.load(d / f"{which}_rank{r}.npz") as z:
                    arrays = {k: z[k] for k in z.files}
                out[which].append((arrays,
                                   json.loads((d / f"{which}_rank{r}.json").read_text())))
        said, _ = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, said[-3000:]
    with np.load(d / "jax_layouts.npz") as z:
        out["jax"] = {k: z[k] for k in z.files}
    return out, inp


def _solo_run():
    solo = _solo("simple_cnaps", serve_quant="int8")
    rs = [_request(u) for u in UIDS] + [_request(u, False) for u in UIDS[:2]]
    solo.run_to_completion(rs)
    return solo, rs


def test_replicated_groups_bit_equal_to_solo_engine(ranks):
    out, _ = ranks
    _, rs = _solo_run()
    for arrays, info in out["2x2"]:
        for i, r in enumerate(rs):
            np.testing.assert_array_equal(arrays[f"replicated/all/{i}"], r.all_logits())
        assert info["replicated"]["stats"]["tasks_adapted"] == len(UIDS)


@pytest.mark.parametrize("layout", ["weight_stationary", "training"])
def test_sharded_layouts_within_tolerance_of_solo_engine(ranks, layout):
    out, _ = ranks
    solo, rs = _solo_run()
    for arrays, info in out["2x2"]:
        for i, r in enumerate(rs):
            _close(arrays[f"{layout}/all/{i}"], r.all_logits(), "simple_cnaps")
        for u in UIDS:
            if f"{layout}/mu/{u}" not in arrays:
                continue
            st = solo.store.l1.peek(u)
            want_mu = st["mu"].numpy()
            want_film = torch.cat([torch.cat([f["gamma"].ravel(), f["beta"].ravel()])
                                   for f in st["film"]]).numpy()
            for got, want in ((arrays[f"{layout}/mu/{u}"], want_mu),
                              (arrays[f"{layout}/film/{u}"], want_film)):
                assert np.abs(got - want).max() <= TOL_HEAD_INPUTS * np.abs(want).max()


@pytest.mark.parametrize("layout", ["training", "weight_stationary", "replicated"])
def test_ranks_of_a_group_hold_the_same_logits(ranks, layout):
    out, _ = ranks
    for g in (0, 1):
        a, b = out["2x2"][2 * g][0], out["2x2"][2 * g + 1][0]
        own = [k for k in a if k.startswith(f"{layout}/own/")]
        assert own and sorted(own) == sorted(k for k in b if k.startswith(f"{layout}/own/"))
        for k in own:
            np.testing.assert_array_equal(a[k], b[k])
    # and after the results cross the host group, every rank holds them all
    first = out["2x2"][0][0]
    for arrays, _ in out["2x2"][1:]:
        for k in first:
            if k.startswith(f"{layout}/all/"):
                np.testing.assert_array_equal(arrays[k], first[k])


@pytest.mark.parametrize("layout", ["training", "weight_stationary", "replicated"])
def test_dispatch_payloads_equal_serving_payloads(ranks, layout):
    out, _ = ranks
    for _, info in out["2x2"]:
        row = info[layout]
        assert row["dispatches"] == [1, 1]
        assert row["payload"] == row["want_payload"]
        if layout == "replicated":
            assert row["payload"] == {}
        else:
            assert row["payload"]
        # no collective between replica groups but the host group's
        assert all(k.endswith("/serve") or k.endswith("/host") for k in row["keys"])


def test_group_clock_keeps_the_ranks_in_step(ranks):
    """With an SLO and a deadline set, a group's ranks read its index 0's
    clock (one broadcast a reading) and so take the same decisions."""
    out, _ = ranks
    for arrays, info in out["2x2"]:
        assert info["slo"] == {"slo_preemptions": 0, "deadline_abandoned": 0}
        for k in arrays:
            if k.startswith("slo/all/"):
                np.testing.assert_array_equal(
                    arrays[k], arrays[k.replace("slo/", "weight_stationary/")])


def test_replica_dead_on_group_one_matches_in_process_router(ranks, tmp_path):
    """The counts, the bits and the enqueue times: a request rerouted off
    the dead group keeps the time it was submitted at (1.0 on the clock
    both runs set alike, not the 2.0 of the step that rerouted it), so the
    pooled latencies include the detour in both modes."""
    out, inp = ranks
    now = [0.0]
    router = ReplicatedServeEngine(*_models("simple_cnaps")[2:], replicas=2,
                                   warm_dir=tmp_path / "warm", cache_capacity=1,
                                   lite=LiteSpec(exact=True, chunk_size=8), device="cpu",
                                   kernel_backend="ref", serve_quant="int8",
                                   clock=lambda: now[0], **ENGINE_KW)
    router.run_to_completion([_request(u) for u in inp["u1"]])
    router.run_to_completion([_request(u) for u in inp["u1_evict"]])
    router.fault_plan = FaultPlan.single(REPLICA_DEAD, at=1)
    rep = [_request(u, False) for u in inp["u1"]]
    now[0] = 1.0
    for r in rep:
        router.submit(r)
    now[0] = 2.0
    router.run_to_completion([])
    s = router.stats()
    assert [r.t_enqueue for r in rep] == [1.0] * len(rep)
    for arrays, info in out["2x2"]:
        dead = info["dead"]
        for k in ("replica_failovers", "live_replicas", "rerouted_requests",
                  "failover_failed", "tasks_adapted", "rehydrates", "spills",
                  "query_p50_us", "query_p99_us", "adapt_p50_us", "adapt_p99_us"):
            assert dead[k] == s[k], (k, dead[k], s[k])
        assert dead["done"] == [True] * len(rep)
        assert dead["t_enqueue"] == [r.t_enqueue for r in rep]
        for i, r in enumerate(rep):
            np.testing.assert_array_equal(arrays[f"dead/{i}"], r.all_logits())
    assert s["replica_failovers"] == 1 and s["rerouted_requests"] == len(inp["u1"])


def test_chooser_on_a_replica_group(ranks):
    out, _ = ranks
    picks = [info["pick"] for _, info in out["2x2"]]
    assert all(p == picks[0] for p in picks)          # rank 0's result everywhere
    rows = picks[0]["rows"]
    assert rows["replicated"]["wire_bytes"] == 0
    assert 0 < rows["weight_stationary"]["wire_bytes"] < rows["training"]["wire_bytes"]
    best = min(r["score"] for r in rows.values())
    assert picks[0]["choice"] == next(lo for lo in ("training", "weight_stationary",
                                                    "replicated")
                                      if rows[lo]["score"] == best)
    assert picks[0]["per_replica"] == rows[picks[0]["choice"]]["wire_bytes"]


def test_replica_wire_follows_the_group_not_the_deployment(ranks):
    out, _ = ranks
    group2 = {info["ws_wire_group2"] for _, info in out["2x2"]}
    group4 = {info["ws_wire_group4"] for _, info in out["2x2"]}
    solo2 = {info["ws_wire_solo2"] for _, info in out["solo2"]}
    assert len(group2) == len(group4) == len(solo2) == 1
    assert group2 == solo2 and min(group4) > min(group2) > 0


@pytest.mark.parametrize("layout", ["training", "weight_stationary", "replicated"])
def test_two_groups_match_the_reference_layouts(ranks, layout):
    """The port's 2 x 2 gloo ranks against the JAX engine's ``serve_layout``
    on 2 replica meshes of 2 host devices, on the same params and tasks:
    logits at the serving tolerance, Simple CNAPs' head inputs (class means
    and adapted FiLM) at 1e-5 of max."""
    out, _ = ranks
    ref = out["jax"]
    for arrays, _ in out["2x2"]:
        got = [k for k in arrays if k.startswith(f"{layout}/all/")]
        assert got and len(got) == len([k for k in ref if k.startswith(f"{layout}/all/")])
        for k in got:
            _close(arrays[k], ref[k], "simple_cnaps")
        for u in UIDS:
            for part in ("mu", "film"):
                k = f"{layout}/{part}/{u}"
                if k in arrays:
                    want = ref[k]
                    assert np.abs(arrays[k] - want).max() <= TOL_HEAD_INPUTS * np.abs(want).max()


def test_serving_axis_is_read_from_the_mesh(ranks):
    """``make_replica_mesh(..., axis="tp")``: every collective of the group
    runs on ``tp``, the warm tier spills and rehydrates through the group's
    writer, and the logits and the chooser's wire are those of the
    default axis."""
    out, _ = ranks
    _, rs = _solo_run()
    wires = set()
    for arrays, info in out["solo2"]:
        row = info["tp"]
        assert any(k.endswith("/tp") for k in row["keys"])
        assert all(k.endswith("/tp") or k.endswith("/host") for k in row["keys"])
        assert row["counts"]["tasks_adapted"] == len(UIDS)
        assert row["counts"]["spills"] > 0 and row["counts"]["rehydrates"] > 0
        for i, r in enumerate(rs):
            _close(arrays[f"tp/all/{i}"], r.all_logits(), "simple_cnaps")
        wires.add(row["wire"])
    assert wires == {info["ws_wire_solo2"] for _, info in out["solo2"]}
