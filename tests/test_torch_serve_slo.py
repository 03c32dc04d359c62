"""The port's serving engine against the JAX engine under one scripted
fake clock: SLO preemption, the bounded queue, deadlines, the warm tier's
corrupt-entry fallback and terminal failure, the clean run's zero
degradation counters, and flat dispatch counts across a rehydrate.

Each scenario drives both engines, on the same weights
(``bridge.params_from_numpy``) and requests, through the same steps and
clock advances; every ``stats()`` key of the JAX engine, every outcome flag
and every ``t_*`` stamp must be equal, and the logits agree within
tests/test_torch_engine.py's ``TOLS`` of max|logit| (both engines on their
``ref`` backends)."""
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import FakeClock
from repro.core.lite import LiteSpec as JLite
from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.faults.plan import FaultPlan as JFaultPlan
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.serve.episodic import EpisodicRequest as JRequest
from repro.serve.episodic import EpisodicServeEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
from repro_torch.faults import WARM_CORRUPT, FaultPlan
from repro_torch.launch import serve as t_launch
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

WIDTHS, FDIM, IMG, WAY = (8, 16), 48, 12, 5
TOLS = {"protonets": 1e-5, "simple_cnaps": 4e-3}
TCFG = HostEpisodicConfig(way=WAY, shot=2, query_per_class=2, image_size=IMG)
OUTCOME = ("done", "rejected", "retry_after_us", "abandoned", "failed",
           "cache_hit", "served", "t_enqueue", "t_admit", "t_adapt",
           "t_first_logit", "t_done")


@functools.lru_cache(maxsize=None)
def _models(kind):
    jl = j_make(JCfg(kind=kind, way=WAY), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(conv_blocks=2, conv_width=8, task_dim=16))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=WAY),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)),
                      SetEncoderConfig(conv_blocks=2, conv_width=8, task_dim=16))
    jp = jl.init(jax.random.key(0))
    return jl, jp, tl, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


class Side:
    """One package's engine, request type and fault plan, so that a
    scenario is written once for both."""

    def __init__(self, pkg, kind, tmp_path):
        self.pkg, self.kind = pkg, kind
        self.clock = FakeClock()
        self.Request = JRequest if pkg == "jax" else EpisodicRequest
        self.FaultPlan = JFaultPlan if pkg == "jax" else FaultPlan
        self.warm_dir = tmp_path / f"warm_{pkg}"

    def engine(self, warm=False, clock=None, **kw):
        jl, jp, tl, tp = _models(self.kind)
        kw.setdefault("n_slots", 2)
        kw.setdefault("query_chunk", 4)
        kw.setdefault("support_buckets", (16,))
        kw.update(kernel_backend="ref", clock=clock or self.clock,
                  warm_dir=self.warm_dir if warm else None)
        if self.pkg == "jax":
            return JEngine(jl, jp, lite=JLite(exact=True, chunk_size=8), **kw)
        return EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8),
                                   device="cpu", **kw)

    def request(self, uid, support=True, seed=11):
        b = host_task_batch_at(seed + uid, TCFG, 1, 0)
        return self.Request(uid=uid, support_x=b.support_x[0] if support else None,
                            support_y=b.support_y[0] if support else None,
                            query_x=b.query_x[0], way=WAY)


def _both(scenario, kind, tmp_path):
    """Run ``scenario(side) -> (engine, requests)`` for both packages and
    hold the port to the JAX engine; returns the port's (engine, requests)."""
    je, jreqs = scenario(Side("jax", kind, tmp_path))
    te, treqs = scenario(Side("torch", kind, tmp_path))
    sj, st = je.stats(), te.stats()
    for k in sj:
        assert st[k] == sj[k], (k, st[k], sj[k])
    assert len(treqs) == len(jreqs)
    for rj, rt in zip(jreqs, treqs):
        for f in OUTCOME:
            assert getattr(rt, f) == getattr(rj, f), (rt.uid, f)
        lj, lt = rj.all_logits(), rt.all_logits()
        assert lt.shape == lj.shape
        if lj.size:
            assert np.abs(lt - lj).max() <= TOLS[kind] * np.abs(lj).max()
    return te, treqs


@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
def test_slo_preemption_defers_adapt_wave(kind, tmp_path):
    """A pending adapt wave is deferred exactly when a live lane's deadline
    is ahead but would pass during the estimated adapt dispatch; a deadline
    already missed never preempts."""
    def scenario(side):
        eng = side.engine(query_slo_us=1.5e6, adapt_cost_hint_us=1.0e6)
        a, b = side.request(0), side.request(1)          # 10 queries each
        eng.submit(a)
        eng.step()                            # t=0: no live lane -> adapt
        assert eng.stats()["tasks_adapted"] == 1 and a.served == 4
        side.clock.advance_to(0.8)
        eng.submit(b)
        eng.step()                            # lands at 1.8 > a's 1.5: deferred
        s = eng.stats()
        assert s["slo_preemptions"] == 1 and s["tasks_adapted"] == 1
        assert a.served == 8 and b.served == 0 and b.t_adapt is None
        side.clock.advance_to(1.6)            # a's deadline missed
        eng.step()
        s = eng.stats()
        assert s["slo_preemptions"] == 1 and s["tasks_adapted"] == 2
        assert a.done and b.t_adapt == 1.6
        side.clock.advance_to(2.0)
        eng.run_to_completion([])
        assert b.done and b.t_done == 2.0
        # without an SLO the same schedule never defers
        ctl = side.engine(clock=FakeClock(), adapt_cost_hint_us=1.0e6)
        ctl.submit(side.request(0))
        ctl.step()
        ctl.submit(side.request(1))
        ctl.step()
        assert ctl.stats()["slo_preemptions"] == 0
        assert ctl.stats()["tasks_adapted"] == 2
        return eng, [a, b]

    _both(scenario, kind, tmp_path)


def test_bounded_queue_rejects_with_retry_after(tmp_path):
    def scenario(side):
        eng = side.engine(n_slots=1, max_queue=2, adapt_cost_hint_us=100.0)
        reqs = [side.request(i) for i in range(4)]
        assert [eng.submit(r) for r in reqs] == [True, True, False, False]
        assert reqs[2].rejected and reqs[2].retry_after_us == 300.0
        assert eng.stats()["rejections"] == 2
        side.clock.advance(0.5)
        eng.run_to_completion([])
        for r in reqs[:2]:
            assert r.done and r.served == r.n_queries
        assert not reqs[2].done and not reqs[2].logits
        return eng, reqs

    _both(scenario, "protonets", tmp_path)


def test_deadline_abandons_queued_and_unadapted_requests(tmp_path):
    def scenario(side):
        eng = side.engine(n_slots=1, deadline_us=1000.0)
        served = side.request(0)
        eng.run_to_completion([served])       # completes before its deadline
        assert served.done and not served.abandoned
        lane, queued = side.request(1), side.request(2)
        assert eng.add_request(lane)          # admitted, adapt pending
        eng.submit(queued)
        side.clock.advance(0.01)              # 10 ms, past both deadlines
        eng.step()
        assert lane.abandoned and lane.done and not lane.logits
        assert queued.abandoned and queued.done
        assert eng.stats()["deadline_abandoned"] == 2
        late = side.request(3)
        eng.run_to_completion([late])         # the lane was freed
        assert late.done and not late.abandoned
        return eng, [served, lane, queued, late]

    _both(scenario, "protonets", tmp_path)


def test_corrupt_warm_entry_falls_back_to_readapt(tmp_path):
    """uid 0's spilled state is truncated on disk; its repeat (support
    attached) quarantines it and re-adapts, with the dispatch counts flat
    and logits bit-equal to a cold engine's."""
    def scenario(side):
        plan = side.FaultPlan.single(WARM_CORRUPT, at=0)
        eng = side.engine(warm=True, cache_capacity=1, fault_plan=plan)
        first = [side.request(0), side.request(1)]
        eng.run_to_completion(first[:1])
        eng.run_to_completion(first[1:])      # evicts 0 -> corrupt spill
        compiles = (eng.stats()["adapt_compiles"], eng.stats()["predict_compiles"])
        repeat = side.request(0)
        eng.run_to_completion([repeat])
        s = eng.stats()
        assert repeat.done and not repeat.failed and repeat.cache_hit is False
        assert s["quarantined"] == 1 and s["rehydrates"] == 0
        assert (s["adapt_compiles"], s["predict_compiles"]) == compiles
        cold = side.engine(clock=FakeClock())
        ref = side.request(0)
        cold.run_to_completion([ref])
        np.testing.assert_array_equal(repeat.all_logits(), ref.all_logits())
        return eng, first + [repeat]

    _both(scenario, "simple_cnaps", tmp_path)


def test_supportless_request_on_quarantined_state_fails_terminal(tmp_path):
    def scenario(side):
        plan = side.FaultPlan.single(WARM_CORRUPT, at=0)
        eng = side.engine(warm=True, cache_capacity=1, fault_plan=plan)
        first = [side.request(0), side.request(1)]
        eng.run_to_completion(first[:1])
        eng.run_to_completion(first[1:])      # spill + corrupt uid 0
        orphan, healthy = side.request(0, support=False), side.request(2)
        eng.run_to_completion([orphan, healthy])
        assert orphan.failed and orphan.done and not orphan.logits
        assert healthy.done and not healthy.failed
        assert eng.stats()["failed_requests"] == 1
        return eng, first + [orphan, healthy]

    _both(scenario, "protonets", tmp_path)


def test_clean_run_has_zero_degradation_counters(tmp_path):
    def scenario(side):
        eng = side.engine()
        reqs = [side.request(0), side.request(1)]
        eng.run_to_completion(reqs)
        s = eng.stats()
        for k in ("quarantined", "spill_errors", "rejections",
                  "deadline_abandoned", "failed_requests", "slo_preemptions"):
            assert s[k] == 0, k
        return eng, reqs

    _both(scenario, "protonets", tmp_path)


def test_rehydrate_keeps_dispatch_counts_flat(tmp_path):
    def scenario(side):
        eng = side.engine(warm=True, n_slots=1, cache_capacity=1)
        first = [side.request(u) for u in range(3)]
        eng.run_to_completion(first)
        counts = (eng.stats()["adapt_compiles"], eng.stats()["predict_compiles"])
        repeats = [side.request(u, support=False) for u in (0, 1, 2, 0)]
        side.clock.advance(1.0)
        eng.run_to_completion(repeats)
        s = eng.stats()
        assert s["rehydrates"] >= 3 and s["tasks_adapted"] == 3
        assert (s["adapt_compiles"], s["predict_compiles"]) == counts
        for r in repeats:
            assert r.done and r.cache_hit
            np.testing.assert_array_equal(r.all_logits(), first[r.uid].all_logits())
        return eng, first + repeats

    te, _ = _both(scenario, "protonets", tmp_path)
    st = te.stats()
    assert st["adapt_dispatches"] == 3 and st["predict_dispatches"] > 0


def test_launcher_rehydrates_from_its_warm_dir(tmp_path, capsys):
    s = t_launch.main(["--episodic", "--device", "cpu", "--requests", "6",
                       "--image-size", "12", "--shot", "2", "--cache-capacity",
                       "1", "--warm-dir", str(tmp_path / "warm"),
                       "--query-slo-us", "1e9", "--max-queue", "16"])
    out = capsys.readouterr().out
    assert "store: evictions=" in out and "degradation: quarantined=0" in out
    assert s["rehydrates"] > 0 and s["spills"] > 0
    assert s["tasks_adapted"] == 3 and s["queries_served"] == 6 * 20
