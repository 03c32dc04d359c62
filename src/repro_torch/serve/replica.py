"""Multi-replica episodic serving: replicated weights, a task population
partitioned by uid hash, and a replica-aware router (the port of the JAX
package's ``repro/serve/replica.py``).

At many users the scaling axis of episodic serving is the task population,
not the model.  One :class:`EpisodicServeEngine` is bounded by its slots
and its device group; the router scales past it by replication:

* **Weights stay within a replica group.**  Each replica holds a whole copy
  of the serving weights, placed in its ``serve_layout`` on its own group
  (:func:`repro_torch.launch.mesh.make_replica_mesh`); the layout's
  collectives run within the group, so a replica's wire per step follows
  its group's size, not the deployment's.
* **Requests route by uid hash.**  ``stable_uid_hash(uid) % replicas``
  (crc32, the same in every process) picks the replica, so a repeat user
  lands where its adapted state lives.  Each replica keeps its own L1; the
  warm tier is one directory in uid-hash shard subdirs (a fixed count,
  :data:`DEFAULT_WARM_SHARDS`, apart from the replica count), so any replica
  finds any uid's spilled state: the failover and resize paths.
* **Round-robin steps.**  ``step()`` steps every live replica once, the one
  that went first going last next time.
* **Admission rebalances only at the queue.**  A rejection's
  ``retry_after_us`` is the routed replica's own adapt-cost EWMA.
* **Failover** (fault site ``replica.dead``): a replica found dead is
  quarantined; its unfinished requests re-route to the survivors by linear
  probing from their hash.  A spilled state rehydrates bit-exactly there, an
  L1-only one re-adapts if its support rode along, else the request fails
  terminally (counted, never a crash).

``stats()`` sums the counters, pools the raw latency observations before
taking nearest-rank p50/p99, and keeps each replica's under ``per_replica``.

Two modes.  ``mesh=None``: every replica runs in this process on
``device`` (one card, or the CPU), the JAX router's single-device mode.
``mesh=make_replica_mesh(R, d)``: one process a rank, every rank running
this router over the same request stream and stepping only its own
replica's engine; decisions are pure (the hash, a seeded ``FaultPlan``), so
every rank takes the same ones, and ``busy``, the failover's drained
requests, the results and ``stats()`` cross the host group.  At the end of
``run_to_completion`` every rank holds every request's outcome and logits,
as its home group's ``serve`` index 0 computed them.  ``stats()`` is then a
collective: every rank calls it.

    mesh = make_replica_mesh(replicas=2, devices_per_replica=2)
    router = ReplicatedServeEngine(learner, params, replicas=2, mesh=mesh,
                                   warm_dir="/tmp/warm", serve_quant="int8",
                                   serve_layout="weight_stationary",
                                   n_slots=4, support_buckets=(64,))
    router.run_to_completion(requests)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.faults.plan import REPLICA_DEAD
from repro_torch.launch.mesh import serve_axis
from repro_torch.serve.episodic import (EpisodicRequest, EpisodicServeEngine,
                                        _pctl, stable_uid_hash)

# the warm tier's shard count: a function of the uid alone partitions the
# directory, so it must not follow the replica count (resizing re-routes
# uids, never their files); 1, 2, 4 and 8 replicas divide it, and then each
# replica touches its own subdirs
DEFAULT_WARM_SHARDS = 8

# summed over replicas in stats()
_SUMMED = ("tasks_adapted", "queries_served", "queue_depth", "cache_hits",
           "cache_misses", "evictions", "overwrites", "spills", "rehydrates",
           "rescan_hits", "quarantined", "spill_errors", "rejections",
           "deadline_abandoned", "failed_requests", "slo_preemptions",
           "adapt_compiles", "predict_compiles", "param_bytes_resident",
           "param_bytes_fp32", "frozen_param_bytes_resident",
           "frozen_param_bytes_fp32")
# a request's outcome, which the home group's index 0 hands every rank
_OUTCOME = ("logits", "served", "cache_hit", "done", "rejected", "retry_after_us",
            "abandoned", "failed", "t_enqueue", "t_admit", "t_adapt", "t_first_logit",
            "t_done")


def uid_replica(uid: int, replicas: int) -> int:
    """The uid's home replica, ``stable_uid_hash(uid) % replicas``: pure and
    the same in every process (the routing repeat users rely on)."""
    return stable_uid_hash(uid) % replicas


def _reset_for_reroute(req: EpisodicRequest) -> None:
    """Scrub a request drained from a dead replica back to submittable: its
    logits died with the replica (partial results are dropped, not
    spliced); ``t_enqueue`` stays, so the pooled percentiles include the
    detour."""
    req.logits = []
    req.served = 0
    req.cache_hit = None
    req.done = False
    req.t_admit = None
    req.t_adapt = None
    req.t_first_logit = None
    req.t_done = None


class ReplicatedServeEngine:
    """Replica-aware router over :class:`EpisodicServeEngine` replicas.

    ``replicas``, ``mesh``, ``warm_dir``, ``warm_shards``, ``fault_plan``,
    ``clock`` and ``device`` are the router's; every other keyword
    (``n_slots``, ``support_buckets``, ``serve_quant``, ``serve_layout``,
    ``cache_capacity``, ...) goes to every replica's engine as it is, so
    int8 and the layouts compose per replica as on one engine.  An adapted
    state depends on the params and the support set only, so which replica
    adapts a task never changes its logits.

    With ``mesh`` (:func:`repro_torch.launch.mesh.make_replica_mesh`, its
    ``replica`` axis ``replicas`` long) this rank builds only its own
    replica's engine, on the mesh's ``serve`` group; the module docstring
    has the rest of that mode's contract.
    """

    def __init__(self, learner, params, *, replicas: int = 2, mesh=None,
                 warm_dir=None, warm_shards: Optional[int] = None,
                 fault_plan=None, clock=None, device="cuda", **engine_kw):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if mesh is not None and mesh.shape.get("replica") != replicas:
            raise ValueError(f"got a mesh of shape {mesh.shape} for {replicas} "
                             f"replicas; build it with make_replica_mesh(replicas, "
                             f"devices_per_replica)")
        if warm_shards is None:
            warm_shards = DEFAULT_WARM_SHARDS
        self.n_replicas = replicas
        self.mesh = mesh
        self.fault_plan = fault_plan
        self.own = mesh.coords["replica"] if mesh is not None else None
        self.axis = serve_axis(mesh) if mesh is not None else None

        def engine(r):
            return EpisodicServeEngine(learner, params, mesh=mesh, warm_dir=warm_dir,
                                       warm_shards=warm_shards, fault_plan=fault_plan,
                                       clock=clock, device=device, **engine_kw)

        self.replicas: List[Optional[EpisodicServeEngine]] = [
            engine(r) if mesh is None or r == self.own else None
            for r in range(replicas)]
        self._dead: set[int] = set()
        self._rr = 0                         # round-robin rotation offset
        self.steps = 0
        self.replica_failovers = 0
        self.rerouted_requests = 0
        self.failover_failed = 0
        # mesh mode: every submitted request in order, and its replica
        self._submitted: List[EpisodicRequest] = []
        self._home: List[int] = []

    # -- routing -------------------------------------------------------------

    def route(self, uid: int) -> int:
        """The live replica serving ``uid``: its hash home, or, if that one
        is quarantined, the first live one probing on from it."""
        for k in range(self.n_replicas):
            cand = (uid_replica(uid, self.n_replicas) + k) % self.n_replicas
            if cand not in self._dead:
                return cand
        raise RuntimeError("all replica groups are dead")

    @property
    def live_replicas(self) -> List[int]:
        return [r for r in range(self.n_replicas) if r not in self._dead]

    def _local(self, r: int) -> bool:
        return self.mesh is None or r == self.own

    def _lead(self, r: int) -> int:
        """Mesh mode: the global rank of replica ``r``'s serving index 0."""
        return self.mesh.rank_at(**{"replica": r, self.axis: 0})

    def submit(self, req: EpisodicRequest) -> bool:
        """Route ``req`` by uid and enqueue it on its replica, whose bounded
        queue may reject it with that replica's ``retry_after_us``.  In mesh
        mode a request for another group is recorded, stamped with this
        rank's engine's clock (so that a failover here keeps its enqueue
        time, as in one process), and returns True; its outcome arrives
        with the results."""
        r = self.route(req.uid)
        if self.mesh is not None:
            self._submitted.append(req)
            self._home.append(r)
            if req.t_enqueue is None:
                req.t_enqueue = self.replicas[self.own].clock()
        if not self._local(r):
            return True
        return self.replicas[r].submit(req)

    # -- failover ------------------------------------------------------------

    def _check_faults(self) -> None:
        if self.fault_plan is None:
            return
        for r in list(self.live_replicas):
            if self.fault_plan.fire(REPLICA_DEAD, r) is not None:
                self.quarantine_replica(r)

    def _drained(self, r: int) -> List[Tuple[Optional[int], EpisodicRequest]]:
        """(order of submission, request) of replica ``r``'s unfinished
        requests, drained from its engine.  In mesh mode the dead group's
        ``serve`` index 0 names them to every rank over the host group, and
        each rank takes its own copies."""
        if self.mesh is None:
            return [(None, q) for q in self.replicas[r].drain_unfinished()]
        mine = self.replicas[r].drain_unfinished() if r == self.own else []
        seq = {id(q): i for i, q in enumerate(self._submitted)}
        seqs = self.mesh.broadcast_object([seq[id(q)] for q in mine],
                                          src=self._lead(r))
        return [(i, self._submitted[i]) for i in seqs]

    def quarantine_replica(self, r: int) -> None:
        """Take replica ``r`` out of rotation and re-route its unfinished
        requests to the survivors.  A spilled state rehydrates on the new
        replica (the shared warm root, rescan on a miss); an L1-only state
        is lost with the replica: a request with its support re-adapts, a
        support-less one whose uid the survivor cannot find fails
        terminally (``failover_failed``), and the router keeps serving."""
        if r in self._dead:
            return
        if len(self.live_replicas) == 1:
            raise RuntimeError(f"cannot quarantine replica {r}: it is the last live "
                               f"replica group")
        self._dead.add(r)
        self.replica_failovers += 1
        for i, req in self._drained(r):
            _reset_for_reroute(req)
            t = self.route(req.uid)
            if i is not None:
                self._home[i] = t
            if not self._local(t):
                continue
            target = self.replicas[t]
            if req.support_x is None and req.uid not in target.store:
                # nothing can rebuild this task's state: its L1 copy died
                # with the replica and it never spilled
                req.failed = True
                req.done = True
                req.t_done = target.clock()
                self.failover_failed += 1
                continue
            self.rerouted_requests += 1
            target.submit(req)
        print(f"replica router: quarantined replica {r}, re-routed "
              f"{self.rerouted_requests} request(s) to survivors "
              f"{self.live_replicas}", flush=True)

    # -- stepping ------------------------------------------------------------

    def step(self) -> int:
        """Fire any pending ``replica.dead`` faults, then step every live
        replica (in mesh mode: this rank's, if live) once, in round-robin
        order.  Returns the queries served here."""
        self._check_faults()
        live = self.live_replicas
        if not live:
            raise RuntimeError("all replica groups are dead")
        k = self._rr % len(live)
        self._rr += 1
        served = 0
        for r in live[k:] + live[:k]:
            if self._local(r):
                served += self.replicas[r].step()
        self.steps += 1
        return served

    @property
    def busy(self) -> bool:
        """Whether any live replica has work; in mesh mode agreed by every
        rank over the host group, so that all leave the loop together."""
        mine = any(self.replicas[r].busy for r in self.live_replicas if self._local(r))
        return self.mesh.any_rank(mine) if self.mesh is not None else mine

    def run_to_completion(self, requests: List[EpisodicRequest],
                          max_steps: int = 100000) -> List[EpisodicRequest]:
        for req in requests:
            self.submit(req)
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        self.sync_results()
        return requests

    def sync_results(self) -> None:
        """Mesh mode: every rank takes each submitted request's outcome and
        logits from the ``serve`` index 0 rank of the group that served it
        (one host-group broadcast a replica)."""
        if self.mesh is None:
            return
        for r in range(self.n_replicas):
            src = self._lead(r)
            mine = None
            if self.mesh.rank == src:
                mine = {i: {f: getattr(q, f) for f in _OUTCOME}
                        for i, q in enumerate(self._submitted) if self._home[i] == r}
            for i, out in self.mesh.broadcast_object(mine, src=src).items():
                for f, v in out.items():
                    setattr(self._submitted[i], f, v)

    # -- observability -------------------------------------------------------

    def _replica_stats(self):
        """[(stats, adapt latencies, query latencies)] of every replica, and
        the router counters that the replicas' own ranks keep (mesh mode:
        gathered over the host group from each group's index 0)."""
        def own(eng):
            return (eng.stats(), list(eng._adapt_lat_us), list(eng._query_lat_us))
        if self.mesh is None:
            return ([own(eng) for eng in self.replicas],
                    (self.rerouted_requests, self.failover_failed))
        every = self.mesh.all_gather_object(
            (self.mesh.coords, own(self.replicas[self.own]),
             (self.rerouted_requests, self.failover_failed)))
        leads = {c["replica"]: (o, k) for c, o, k in every if c[self.axis] == 0}
        per = [leads[r][0] for r in range(self.n_replicas)]
        return per, tuple(sum(leads[r][1][j] for r in leads) for j in range(2))

    def stats(self) -> Dict[str, object]:
        """Counters summed over replicas (``param_bytes_resident`` so counts
        R whole copies), nearest-rank p50/p99 over the pooled raw latencies
        of every replica, the mean spill and rehydrate times over all of
        them, the router's own counts (``replica_failovers``,
        ``rerouted_requests``, ``failover_failed``, ``live_replicas``,
        ``steps``), and each replica's ``stats()`` under ``per_replica``.
        In mesh mode a collective of every rank."""
        per, (rerouted, failed) = self._replica_stats()
        stats = [p[0] for p in per]
        out: Dict[str, object] = {k: sum(p[k] for p in stats) for k in _SUMMED}
        lookups = out["cache_hits"] + out["cache_misses"]
        out["hit_rate"] = out["cache_hits"] / lookups if lookups else 0.0
        adapt_lat = [x for p in per for x in p[1]]
        query_lat = [x for p in per for x in p[2]]
        out["adapt_p50_us"] = _pctl(adapt_lat, 50)
        out["adapt_p99_us"] = _pctl(adapt_lat, 99)
        out["query_p50_us"] = _pctl(query_lat, 50)
        out["query_p99_us"] = _pctl(query_lat, 99)
        for key, n in (("spill_mean_us", "spills"), ("rehydrate_mean_us", "rehydrates")):
            out[key] = (sum(p[key] * p[n] for p in stats) / out[n]) if out[n] else 0.0
        out["failed_requests"] += failed
        out["steps"] = self.steps
        out["n_replicas"] = self.n_replicas
        out["live_replicas"] = len(self.live_replicas)
        out["replica_failovers"] = self.replica_failovers
        out["rerouted_requests"] = rerouted
        out["failover_failed"] = failed
        out["per_replica"] = stats
        return out
