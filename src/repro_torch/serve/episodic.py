"""Episodic serving engine: adapt many tasks, answer their query streams.

A request is one episode: a support set to adapt on and a query stream to
answer.  ``submit`` enqueues; each ``step`` admits FIFO from the queue into
up to ``n_slots`` live task lanes (head-of-line: a request whose uid is
already live waits, so one uid is never adapted twice at once), adapts the
newly admitted tasks in one batched dispatch per support bucket, and serves
the next query chunk of every live task in one batched dispatch.  Lanes are
padded to ``n_slots``, so every dispatch has one shape per bucket.

Adapted states live in an LRU keyed by task uid (:class:`TaskStateCache`):
a repeat uid skips adaptation.  Requests carry enqueue / admit / adapt /
first-logit / done timestamps from the engine's injectable ``clock``, and
``stats()`` reports nearest-rank p50/p99 adapt and first-logit latency.

The engine runs on ``device`` (default ``"cuda"``) and raises if that
device is not available; a CPU run must ask for it.  The kernel backend
(:mod:`repro_torch.kernels.dispatch`) is fixed at construction: ``auto``
resolves to the CUDA kernels on a GPU and to ``ref`` on the CPU.

Not ported yet: the disk warm tier, SLO scheduling, deadlines, the bounded
queue, fault injection, sharded layouts and replicas.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_to
from repro_torch.core.episodic import Task, index_task_state, stack_task_states
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearner
from repro_torch.data.episodic import (bucket_for, collate_task_batch,
                                       iter_query_chunks)
from repro_torch.kernels import dispatch
from repro_torch.serve.quant_params import (dequantize_params, param_bytes,
                                            quantize_frozen)

Tree = Any


def _pctl(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (no interpolation)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class EpisodicRequest:
    """One episode.  ``uid`` is the task identity (the cache key): a repeat
    uid may omit its support set while its state is cached.  ``query_x`` is
    served in engine-sized chunks, logits kept in arrival order.  The
    ``t_*`` timestamps (seconds) come from the engine's clock."""

    uid: int
    query_x: np.ndarray                          # (M, H, W, C)
    support_x: Optional[np.ndarray] = None       # (N, H, W, C)
    support_y: Optional[np.ndarray] = None       # (N,)
    way: int = 5
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    served: int = 0
    cache_hit: Optional[bool] = None
    done: bool = False
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None
    t_adapt: Optional[float] = None
    t_first_logit: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def n_queries(self) -> int:
        return int(np.asarray(self.query_x).shape[0])

    def all_logits(self) -> np.ndarray:
        """(M, way) logits in query order (complete once ``done``)."""
        if not self.logits:
            return np.zeros((0, self.way), np.float32)
        return np.concatenate(self.logits, axis=0)

    def predictions(self) -> np.ndarray:
        return np.argmax(self.all_logits(), axis=-1)


class TaskStateCache:
    """LRU of adapted task states keyed by uid.  ``hits``/``misses`` count
    ``get`` lookups only; ``put`` on a present uid is an overwrite;
    ``evictions`` counts capacity evictions."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.overwrites = 0
        self.evictions = 0
        self._d: "collections.OrderedDict[int, Tree]" = collections.OrderedDict()

    def get(self, uid: int) -> Optional[Tree]:
        if uid in self._d:
            self._d.move_to_end(uid)
            self.hits += 1
            return self._d[uid]
        self.misses += 1
        return None

    def peek(self, uid: int) -> Optional[Tree]:
        """The state of ``uid`` without counting a lookup or touching recency."""
        return self._d.get(uid)

    def put(self, uid: int, state: Tree) -> None:
        if uid in self._d:
            self.overwrites += 1
        self._d[uid] = state
        self._d.move_to_end(uid)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def __contains__(self, uid: int) -> bool:
        return uid in self._d

    def __len__(self) -> int:
        return len(self._d)


@dataclasses.dataclass
class _Slot:
    req: EpisodicRequest
    state: Optional[Tree]                        # None => awaiting adaptation
    stream: Iterator


class EpisodicServeEngine:
    """Single-device adapt-many-tasks engine over the batched contract
    (``learner.adapt_batch`` / ``learner.predict_batch``).

    ``support_buckets`` are the planned support pad caps
    (:func:`repro_torch.data.episodic.plan_buckets`); a larger support set
    is rejected at admission.  ``serve_quant='int8'`` stores the learner's
    frozen slice in blockwise int8 (dequantized at each dispatch, the head
    left int8 for the ``int8_matmul`` kernel).  ``params`` may live on any
    device; the engine moves them to ``device``.
    """

    def __init__(self, learner: MetaLearner, params: Tree, *,
                 lite: Optional[LiteSpec] = None, n_slots: int = 4,
                 query_chunk: int = 8, support_buckets: Sequence[int] = (64,),
                 cache_capacity: int = 64,
                 kernel_backend: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 serve_quant: str = "none", device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.device = resolve_device(device)
        self.learner = learner
        self.serve_quant = serve_quant
        params = tree_to(params, self.device)
        self._weights = quantize_frozen(learner, params, serve_quant)
        self._param_bytes = param_bytes(self._weights)
        self.lite = lite if lite is not None else LiteSpec(exact=True,
                                                           chunk_size=32)
        self.n_slots = n_slots
        self.query_chunk = query_chunk
        self.support_buckets = tuple(sorted(support_buckets))
        self.store = TaskStateCache(cache_capacity)
        self.clock = clock if clock is not None else time.monotonic
        self.kernel_backend = dispatch.resolve_backend(kernel_backend, self.device)
        self._queue: "collections.deque[EpisodicRequest]" = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        # the (n_slots, ...) predict-side stack of an unchanged live cohort
        self._stacked_states: Optional[tuple] = None
        self._adapt_lat_us: List[float] = []
        self._query_lat_us: List[float] = []
        self.tasks_adapted = 0
        self.queries_served = 0
        self.steps = 0
        self.adapt_dispatches = 0
        self.predict_dispatches = 0

    # -- scheduling ----------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def submit(self, req: EpisodicRequest) -> None:
        """Enqueue ``req`` (stamps ``t_enqueue``); admission is FIFO in
        ``step``."""
        if req.t_enqueue is None:
            req.t_enqueue = self.clock()
        self._queue.append(req)

    def _try_admit(self, req: EpisodicRequest) -> bool:
        """Admit ``req`` into a free slot; False defers (no free slot, or its
        uid is live)."""
        if self._free_slot() is None:
            return False
        if req.way != self.learner.cfg.way:
            raise ValueError(f"request way={req.way} != learner way="
                             f"{self.learner.cfg.way}")
        if any(s is not None and s.req.uid == req.uid for s in self._slots):
            return False
        if req.support_x is not None:
            n = int(np.asarray(req.support_x).shape[0])
            if n > self.support_buckets[-1]:
                raise ValueError(
                    f"request uid={req.uid}: support size {n} exceeds every "
                    f"planned bucket {self.support_buckets}; re-plan buckets "
                    f"from a fresh stream histogram")
        elif req.uid not in self.store:
            raise ValueError(f"request uid={req.uid}: no cached task state "
                             f"and no support set to adapt on")
        state = self.store.get(req.uid)
        req.cache_hit = state is not None
        req.t_admit = self.clock()
        self._slots[self._free_slot()] = _Slot(
            req=req, state=state,
            stream=iter_query_chunks(req.query_x, self.query_chunk))
        return True

    def _admit_from_queue(self) -> None:
        while self._queue and self._try_admit(self._queue[0]):
            self._queue.popleft()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the two batched dispatches ------------------------------------------

    def _adapt_pending(self) -> None:
        """One ``adapt_batch`` dispatch per support bucket among the slots
        awaiting adaptation, padded to ``n_slots`` lanes.  A task's pad cap
        follows its own support size, so its state does not depend on its
        co-tenants."""
        need = [i for i, s in enumerate(self._slots)
                if s is not None and s.state is None]
        if not need:
            return
        groups: Dict[int, List[int]] = {}
        for i in need:
            n = int(np.asarray(self._slots[i].req.support_x).shape[0])
            groups.setdefault(bucket_for(n, self.support_buckets), []).append(i)
        for cap, idxs in sorted(groups.items()):
            tasks = []
            for i in idxs:
                r = self._slots[i].req
                sx = np.asarray(r.support_x, np.float32)
                tasks.append(Task(
                    support_x=sx, support_y=np.asarray(r.support_y, np.int32),
                    query_x=np.zeros((1,) + sx.shape[1:], np.float32),
                    query_y=np.zeros((1,), np.int32), way=r.way))
            while len(tasks) < self.n_slots:     # fixed task-lane count
                tasks.append(tasks[0])
            batch = collate_task_batch(tasks, support_size=cap,
                                       query_size=1).to(self.device)
            with dispatch.use_backend(self.kernel_backend):
                states = self.learner.adapt_batch(
                    dequantize_params(self._weights), batch, self.lite)
            self._sync()
            t1 = self.clock()
            self.adapt_dispatches += 1
            for lane, i in enumerate(idxs):
                st = index_task_state(states, lane)
                slot = self._slots[i]
                slot.state = st
                slot.req.t_adapt = t1
                self._adapt_lat_us.append((t1 - slot.req.t_enqueue) * 1e6)
                self.store.put(slot.req.uid, st)
            self.tasks_adapted += len(idxs)

    def _retire(self, i: int) -> None:
        r = self._slots[i].req
        r.done = True
        r.t_done = self.clock()
        self._slots[i] = None

    def _serve_queries(self) -> int:
        """One ``predict_batch`` dispatch serving the next query chunk of
        every live task; empty lanes carry a filler state and zero queries."""
        lanes = []                                # (slot_idx, chunk, n_real)
        for i, s in enumerate(self._slots):
            if s is None or s.state is None:
                continue
            item = next(s.stream, None)
            if item is None:                      # stream exhausted (M == 0)
                self._retire(i)
                continue
            chunk, _, n_real = item
            lanes.append((i, chunk, n_real))
        if not lanes:
            return 0
        chunk_shape = lanes[0][1].shape
        if any(l[1].shape != chunk_shape for l in lanes):
            raise ValueError("live tasks disagree on query trailing shape; "
                             "one engine serves one model input spec")
        qx = np.zeros((self.n_slots,) + chunk_shape, np.float32)
        for lane, (_, chunk, _) in enumerate(lanes):
            qx[lane] = chunk
        cohort = tuple((i, self._slots[i].req.uid) for i, _, _ in lanes)
        if self._stacked_states is not None and self._stacked_states[0] == cohort:
            stacked = self._stacked_states[1]
        else:
            states = [self._slots[i].state for i, _, _ in lanes]
            states.extend([states[0]] * (self.n_slots - len(lanes)))
            stacked = stack_task_states(states)
            self._stacked_states = (cohort, stacked)
        with dispatch.use_backend(self.kernel_backend):
            out = self.learner.predict_batch(
                dequantize_params(self._weights), stacked,
                torch.from_numpy(qx).to(self.device))
        logits = out.float().cpu().numpy()
        self.predict_dispatches += 1
        t_out = self.clock()
        served = 0
        for lane, (i, _, n_real) in enumerate(lanes):
            r = self._slots[i].req
            r.logits.append(logits[lane, :n_real])
            r.served += n_real
            served += n_real
            if r.t_first_logit is None:
                r.t_first_logit = t_out
                self._query_lat_us.append((t_out - r.t_enqueue) * 1e6)
            if r.served >= r.n_queries:
                self._retire(i)
        return served

    def step(self) -> int:
        """Admit from the queue, adapt the pending tasks, serve one query
        chunk per live task.  Returns the number of queries served."""
        self._admit_from_queue()
        self._adapt_pending()
        served = self._serve_queries()
        self.queries_served += served
        self.steps += 1
        return served

    def run_to_completion(self, requests: List[EpisodicRequest],
                          max_steps: int = 100000) -> List[EpisodicRequest]:
        for r in requests:
            self.submit(r)
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return requests

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Counters and nearest-rank latency percentiles (us): adapt is
        enqueue -> state ready (cold requests only), query is enqueue ->
        first logit.  ``hit_rate`` is over cache lookups at admission."""
        c = self.store
        lookups = c.hits + c.misses
        return dict(
            tasks_adapted=self.tasks_adapted,
            queries_served=self.queries_served,
            steps=self.steps,
            adapt_dispatches=self.adapt_dispatches,
            predict_dispatches=self.predict_dispatches,
            queue_depth=len(self._queue),
            cache_hits=c.hits,
            cache_misses=c.misses,
            hit_rate=c.hits / lookups if lookups else 0.0,
            evictions=c.evictions,
            overwrites=c.overwrites,
            adapt_p50_us=_pctl(self._adapt_lat_us, 50),
            adapt_p99_us=_pctl(self._adapt_lat_us, 99),
            query_p50_us=_pctl(self._query_lat_us, 50),
            query_p99_us=_pctl(self._query_lat_us, 99),
            param_bytes_resident=self._param_bytes["resident_bytes"],
            param_bytes_fp32=self._param_bytes["fp32_bytes"],
            frozen_param_bytes_resident=self._param_bytes["frozen_resident_bytes"],
            frozen_param_bytes_fp32=self._param_bytes["frozen_fp32_bytes"],
        )

