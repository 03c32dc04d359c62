"""Episodic serving engine: adapt many tasks, answer their query streams.

A request is one episode: a support set to adapt on and a query stream to
answer.  Re-adaptation is the expensive tail of serving, so the engine is
built around keeping adapted task states:

* **Continuous batching** — ``submit`` enqueues; each ``step`` admits FIFO
  from the queue into up to ``n_slots`` live task lanes (head-of-line: a
  request whose uid is already live waits, so one uid is never adapted
  twice at once), adapts the newly admitted tasks in one batched dispatch
  per support bucket, and serves the next query chunk of every live task
  in one batched dispatch.  Lanes are padded to ``n_slots``, so every
  dispatch has one shape per bucket; both dispatches go through a
  per-shape :class:`repro_torch.train.pipeline.BucketedStepCache`, whose
  counts ``stats()`` reports as ``adapt_compiles`` / ``predict_compiles``.
* **Latency accounting from an injectable clock** — requests carry
  enqueue / admit / adapt / first-logit / done timestamps from the
  engine's ``clock`` (default ``time.monotonic``), and ``stats()`` reports
  nearest-rank p50/p99 adapt and first-logit latency.
* **SLO-aware scheduling** — with ``query_slo_us`` set, a step whose
  pending adapt wave would push a live lane's first query past its
  deadline (estimated from an EWMA of measured adapt-dispatch time,
  seeded by ``adapt_cost_hint_us``) defers the wave and serves queries
  instead; a deadline already missed no longer preempts, so adapt waves
  cannot starve.
* **Backpressure, deadlines, faults** — ``max_queue`` rejects a submit
  over the bound with a ``retry_after_us`` estimate; ``deadline_us``
  abandons a request still without logits past its deadline;
  ``fault_plan`` drives the warm tier's sites ``warm.corrupt`` and
  ``warm.vanish``.
* **Two-tier task-state store** — adapted states live in an L1 LRU keyed
  by uid (:class:`TaskStateCache`); with ``warm_dir`` set, L1 eviction
  spills the state to a disk warm tier (:class:`WarmTaskStore`, one npz a
  uid in the JAX package's format) and a repeat uid that misses L1
  rehydrates bit-exactly instead of re-adapting.  Only the disk's errors
  are handled as the disk's: the copies between the card and the host lie
  outside every ``except``, so a CUDA error propagates.

The engine runs on ``device`` (default ``"cuda"``) and raises if that
device is not available; a CPU run must ask for it.  The kernel backend
(:mod:`repro_torch.kernels.dispatch`) is fixed at construction: ``auto``
resolves to the CUDA kernels on a GPU and to ``ref`` on the CPU.

* **Serving layouts** — with ``mesh`` (a replica group from
  :func:`repro_torch.launch.mesh.make_replica_mesh`, one process a rank)
  and ``serve_layout``, the weights are placed in the layout on the
  group's ranks (:func:`repro_torch.serve.quant_params.place_serving_weights`)
  and every dispatch runs under it: ``weight_stationary`` multiplies this
  rank's K-slice of each split product weight and sums the partial
  products over the group; ``training`` gathers every split leaf before a
  dispatch; ``replicated`` moves nothing.  The batch stays whole on every
  rank, as in the JAX engine, so every rank of the group adapts, stores and
  serves the same tasks and holds the same logits.  Only the group's rank
  of ``serve`` index 0 writes the warm tier; the others read what it
  wrote, and learn at each spill whether it landed.  With ``query_slo_us``
  or ``deadline_us`` set the group reads index 0's clock, so that its
  ranks take the same scheduling decisions.  Several replicas route
  through :class:`repro_torch.serve.replica.ReplicatedServeEngine`.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import pathlib
import shutil
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.tree import tree_map, tree_to
from repro_torch.core.episodic import Task, index_task_state, stack_task_states
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearner
from repro_torch.data.episodic import (bucket_for, collate_task_batch,
                                       iter_query_chunks)
from repro_torch.faults.plan import WARM_CORRUPT, WARM_VANISH
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import serve_axis
from repro_torch.serve.quant_params import (param_bytes, place_serving_weights,
                                            quantize_frozen, serving_params)
from repro_torch.train.checkpoint import (ChecksumError, load_array_tree,
                                          save_array_tree)
from repro_torch.train.pipeline import BucketedStepCache

Tree = Any

# the port's template sidecar; the JAX package's store writes (and lists)
# ``uid_*.tmpl.pkl`` pickles of jax.ShapeDtypeStruct, which the port cannot
# read, so neither store lists or drops the other's sidecars
_SIDECAR = ".tmpl.json"
# what reading a warm entry raises when the file is bad: a truncated or
# zero-byte npz (EOFError, BadZipFile), a bad member (ValueError,
# KeyError), a crc32 mismatch, the file system itself
_READ_ERRORS = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile,
                zlib.error, ChecksumError)


def stable_uid_hash(uid: int) -> int:
    """Process-stable hash of a task uid: crc32 of its 8-byte little-endian
    signed encoding, the JAX package's own (Python's ``hash`` is salted per
    process; warm-dir shards must agree across restarts)."""
    return zlib.crc32(int(uid).to_bytes(8, "little", signed=True))


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
    """One episode.  ``uid`` is the task identity (the store key): a repeat
    uid may omit its support set while its state is in either store tier.
    ``query_x`` is served in engine-sized chunks, logits kept in arrival
    order.

    Degradation outcomes (each also a ``stats()`` counter): ``rejected`` —
    the bounded queue refused the submit (``retry_after_us`` says when to
    offer it again); ``abandoned`` — its deadline passed before its first
    logit; ``failed`` — a support-less request whose only stored state was
    quarantined, so nothing can produce its logits.

    The ``t_*`` timestamps (seconds) come from the engine's clock:
    ``t_adapt`` is absent on a store hit."""

    uid: int
    query_x: np.ndarray                          # (M, H, W, C)
    support_x: Optional[np.ndarray] = None       # (N, H, W, C)
    support_y: Optional[np.ndarray] = None       # (N,)
    way: int = 5
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    served: int = 0
    cache_hit: Optional[bool] = None
    done: bool = False
    rejected: bool = False
    retry_after_us: Optional[float] = None
    abandoned: bool = False
    failed: bool = False
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
    """LRU of adapted task states keyed by uid, the L1 of the two-tier
    store.  ``hits``/``misses`` count ``get`` lookups only; ``put`` on a
    present uid is an overwrite (recency refreshed); ``evictions`` counts
    capacity evictions, each ``(uid, state)`` handed to ``on_evict`` (the
    warm tier's spill) before it leaves L1."""

    def __init__(self, capacity: int = 64,
                 on_evict: Optional[Callable[[int, Tree], None]] = None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.overwrites = 0
        self.evictions = 0
        self._on_evict = on_evict
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
            old_uid, old_state = self._d.popitem(last=False)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(old_uid, old_state)

    def __contains__(self, uid: int) -> bool:
        return uid in self._d

    def __len__(self) -> int:
        return len(self._d)


def _template_json(tree: Tree):
    """The structure, shapes and dtypes of a state tree, as JSON."""
    if isinstance(tree, dict):
        return {"dict": {k: _template_json(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_template_json(v) for v in tree]}
    return {"shape": list(tree.shape), "dtype": str(tree.dtype).removeprefix("torch.")}


def _template_from_json(obj) -> Tree:
    """:func:`_template_json`'s inverse: the tree with a meta tensor (shape
    and dtype, no storage) at every leaf."""
    if "dict" in obj:
        return {k: _template_from_json(v) for k, v in obj["dict"].items()}
    if "list" in obj:
        return [_template_from_json(v) for v in obj["list"]]
    if "tuple" in obj:
        return tuple(_template_from_json(v) for v in obj["tuple"])
    dtype = getattr(torch, obj["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {obj['dtype']!r}")
    return torch.empty(obj["shape"], dtype=dtype, device="meta")


class WarmTaskStore:
    """Disk warm tier for spilled task states: one npz per uid written by
    :func:`repro_torch.train.checkpoint.save_array_tree` (the JAX package's
    format, leaves in its layout) and published by ``os.replace``, so a
    rehydrated state is bit-exact to the spilled one.  ``put`` takes a tree
    of host tensors and ``get`` returns one: moving states to and from the
    card is the caller's job.

    Each uid's template (structure, shapes, dtypes) is held in memory and
    written beside the npz, after it, as a JSON sidecar ``uid_N.tmpl.json``:
    a fresh store over the same directory reads the sidecars and serves
    every surviving uid (``template_restores``).  A sidecar that cannot be
    read is dropped (its uid re-adapts).

    With ``shards > 1`` a uid's files live in ``shard_{stable_uid_hash(uid)
    % shards}``, the JAX package's directory for it.  A ``get`` or ``in``
    miss rescans the uid's canonical sidecar path, the root and every shard
    (``rescan_hits``), so a uid spilled by another store after this one's
    startup scan is still found, and a ``put`` migrates an entry written
    under another shard count to its canonical shard.

    Every read checks the crc32 the writer embedded.  A read that fails on
    the file (truncated, bad zip, checksum, missing leaf, or the file gone)
    quarantines the entry: the npz is renamed aside
    (``quarantine_uid_N_K.npz``), the sidecar and template dropped,
    ``quarantined`` bumped, and ``get`` returns None.  ``fault_plan`` site
    ``warm.corrupt`` truncates a uid's just-published npz to ``payload``
    bytes (default 16).

    A store with ``writer=False`` reads what another process's store over
    the same directory writes (a serving group's other ranks): it never
    writes, renames or removes a file, and its quarantine only drops the
    entry from its own view."""

    def __init__(self, directory: str | pathlib.Path, fault_plan=None,
                 shards: int = 1, writer: bool = True):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.dir = pathlib.Path(directory)
        self.writer = writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.shards = int(shards)
        self._templates: Dict[int, Tree] = {}
        # the subdir each known uid's files live in: its canonical shard,
        # unless written under another shard count and not yet migrated
        self._homes: Dict[int, pathlib.Path] = {}
        self._fault_plan = fault_plan
        self.quarantined = 0
        self.template_restores = 0
        self.rescan_hits = 0
        for side in sorted(self.dir.glob(f"uid_*{_SIDECAR}")) + \
                sorted(self.dir.glob(f"shard_*/uid_*{_SIDECAR}")):
            if self._load_sidecar(side):
                self.template_restores += 1

    def _load_sidecar(self, side: pathlib.Path) -> bool:
        try:
            uid = int(side.name.split(".")[0].split("_", 1)[1])
            self._templates[uid] = _template_from_json(json.loads(side.read_text()))
            self._homes[uid] = side.parent
            return True
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"warm tier: dropping unreadable template sidecar "
                  f"{side.name} ({type(e).__name__}: {e})", flush=True)
            if self.writer:
                side.unlink(missing_ok=True)
            return False

    def _shard_dir(self, uid: int) -> pathlib.Path:
        """Canonical subdir for ``uid``, a function of (uid, shards) only."""
        if self.shards == 1:
            return self.dir
        return self.dir / f"shard_{stable_uid_hash(uid) % self.shards}"

    def _home(self, uid: int) -> pathlib.Path:
        return self._homes.get(uid, self._shard_dir(uid))

    def _path(self, uid: int) -> pathlib.Path:
        return self._home(uid) / f"uid_{uid}.npz"

    def _tmpl_path(self, uid: int) -> pathlib.Path:
        return self._home(uid) / f"uid_{uid}{_SIDECAR}"

    def _rescan(self, uid: int) -> bool:
        """Look for ``uid``'s sidecar written after this store's startup
        scan: its canonical shard first, then the root and every shard."""
        name = f"uid_{uid}{_SIDECAR}"
        candidates = [self._shard_dir(uid) / name, self.dir / name]
        candidates += sorted(self.dir.glob(f"shard_*/{name}"))
        for side in candidates:
            if side.exists() and self._load_sidecar(side):
                self.rescan_hits += 1
                return True
        return False

    def put(self, uid: int, state: Tree) -> None:
        if not self.writer:
            raise RuntimeError("a reading warm store (writer=False) writes nothing")
        home = self._shard_dir(uid)
        if home != self.dir:
            # parents=False: a vanished warm root stays an OSError for the
            # caller (warm.vanish degrades to L1-only), never recreated here
            home.mkdir(exist_ok=True)
        old_home = self._homes.get(uid)
        tmp = home / f".tmp_uid_{uid}.npz"
        save_array_tree(tmp, state)
        os.replace(tmp, home / f"uid_{uid}.npz")
        tmpl = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"),
                        state)
        self._templates[uid] = tmpl
        self._homes[uid] = home
        # the sidecar after the npz: a crash between the two leaves an npz
        # that no store lists, never a sidecar naming a half-written file
        side_tmp = home / f".tmp_uid_{uid}{_SIDECAR}"
        with open(side_tmp, "w") as f:
            json.dump(_template_json(tmpl), f)
        os.replace(side_tmp, home / f"uid_{uid}{_SIDECAR}")
        if old_home is not None and old_home != home:
            # migrated from another shard layout: drop the old files so a
            # rescan can never resurrect the stale copy
            (old_home / f"uid_{uid}.npz").unlink(missing_ok=True)
            (old_home / f"uid_{uid}{_SIDECAR}").unlink(missing_ok=True)
        if self._fault_plan is not None:
            spec = self._fault_plan.fire(WARM_CORRUPT, uid)
            if spec is not None:
                keep = int(spec.payload) if spec.payload is not None else 16
                with open(self._path(uid), "r+b") as f:
                    f.truncate(keep)

    def _quarantine(self, uid: int, err: Exception) -> None:
        path = self._path(uid)
        self.quarantined += 1
        self._templates.pop(uid, None)
        if not self.writer:
            self._homes.pop(uid, None)
            print(f"warm tier: dropped uid={uid} ({type(err).__name__}: {err}; "
                  f"the writer quarantines the file)", flush=True)
            return
        self._tmpl_path(uid).unlink(missing_ok=True)
        if path.exists():
            aside = path.parent / f"quarantine_uid_{uid}_{self.quarantined}.npz"
            os.replace(path, aside)
            where = f"moved aside to {aside.name}"
        else:
            where = "file already gone"
        self._homes.pop(uid, None)
        print(f"warm tier: quarantined uid={uid} ({type(err).__name__}: "
              f"{err}; {where})", flush=True)

    def get(self, uid: int) -> Optional[Tree]:
        """``uid``'s state as host tensors, or None (unknown, or
        quarantined now)."""
        if uid not in self._templates and not self._rescan(uid):
            return None
        path = self._path(uid)
        if not path.exists():
            self._quarantine(uid, FileNotFoundError(str(path)))
            return None
        try:
            return load_array_tree(path, self._templates[uid], verify=True)
        except _READ_ERRORS as e:
            self._quarantine(uid, e)
            return None

    def __contains__(self, uid: int) -> bool:
        if uid not in self._templates and not self._rescan(uid):
            return False
        return self._path(uid).exists()

    def __len__(self) -> int:
        return sum(1 for uid in self._templates if self._path(uid).exists())


class TwoTierTaskStore:
    """L1 LRU of resident task states (on ``device``) over an optional disk
    warm tier.

    ``get`` promotes a warm hit back into L1, which may spill another
    state.  ``hits``/``misses`` are the L1's; ``spills`` counts evictions
    that landed in the warm tier, ``rehydrates`` warm-tier loads, and
    ``spill_s`` / ``rehydrate_s`` their total seconds on ``clock`` (copy
    and disk together).  Without ``warm_dir`` eviction discards.

    A spill whose write fails with an ``OSError`` (the warm directory
    removed under the engine: the ``warm.vanish`` site) is logged and
    counted once in ``spill_errors``, and the store serves L1-only from
    then on; a discarded state re-adapts on its next request.  The copy
    from the card to the host (spill) and back (rehydrate) lies outside
    every ``except``: a device error propagates.

    ``spilled(ok) -> ok`` is called after every spill with whether it
    landed: a serving group's ranks agree there that the writer's
    (``warm_writer``) file is on disk before any of them reads it."""

    def __init__(self, capacity: int = 64,
                 warm_dir: Optional[str | pathlib.Path] = None,
                 fault_plan=None, warm_shards: int = 1, device="cuda",
                 clock: Callable[[], float] = time.perf_counter,
                 warm_writer: bool = True,
                 spilled: Optional[Callable[[bool], bool]] = None):
        self.device = resolve_device(device)
        self.warm = (WarmTaskStore(warm_dir, fault_plan=fault_plan,
                                   shards=warm_shards, writer=warm_writer)
                     if warm_dir is not None else None)
        self._spilled = spilled
        self.l1 = TaskStateCache(capacity, on_evict=self._spill)
        self._fault_plan = fault_plan
        self._clock = clock
        self.spills = 0
        self.rehydrates = 0
        self.spill_errors = 0
        self.spill_s = 0.0
        self.rehydrate_s = 0.0
        self.warm_disabled = False

    @property
    def quarantined(self) -> int:
        return self.warm.quarantined if self.warm is not None else 0

    @property
    def rescan_hits(self) -> int:
        return self.warm.rescan_hits if self.warm is not None else 0

    def _warm_live(self) -> bool:
        return self.warm is not None and not self.warm_disabled

    def _spill(self, uid: int, state: Tree) -> None:
        if not self._warm_live():
            return
        t0 = self._clock()
        host = tree_map(lambda t: t.cpu(), state)
        if self._fault_plan is not None and \
                self._fault_plan.fire(WARM_VANISH, uid) is not None and self.warm.writer:
            shutil.rmtree(self.warm.dir, ignore_errors=True)
        err = None
        if self.warm.writer:
            try:
                self.warm.put(uid, host)
            except OSError as e:
                err = e
        if self._spilled is not None and not self._spilled(err is None):
            err = err or OSError(f"the serving group's warm writer failed to spill "
                                 f"uid={uid}")
        if err is not None:
            self.spill_errors += 1
            self.warm_disabled = True
            print(f"warm tier: spill of uid={uid} failed ({type(err).__name__}: "
                  f"{err}); degrading to L1-only, evicted states will re-adapt",
                  flush=True)
            return
        self.spill_s += self._clock() - t0
        self.spills += 1

    def get(self, uid: int) -> Optional[Tree]:
        state = self.l1.get(uid)
        if state is not None:
            return state
        if self._warm_live():
            t0 = self._clock()
            host = self.warm.get(uid)
            if host is not None:
                state = tree_to(host, self.device)
                self.rehydrate_s += self._clock() - t0
                self.rehydrates += 1
                self.l1.put(uid, state)          # promote (may spill another)
                return state
        return None

    def put(self, uid: int, state: Tree) -> None:
        self.l1.put(uid, state)

    def __contains__(self, uid: int) -> bool:
        return uid in self.l1 or (self._warm_live() and uid in self.warm)

    def __len__(self) -> int:
        return len(self.l1)


@dataclasses.dataclass
class _Slot:
    req: EpisodicRequest
    state: Optional[Tree]                        # None => awaiting adaptation
    stream: Iterator


class EpisodicServeEngine:
    """Single-device adapt-many-tasks engine over the batched contract
    (``learner.adapt_batch`` / ``learner.predict_batch``); the module
    docstring has the whole contract.

    ``support_buckets`` are the planned support pad caps
    (:func:`repro_torch.data.episodic.plan_buckets`); a larger support set
    is rejected at admission.  ``serve_quant='int8'`` stores the learner's
    frozen slice in blockwise int8 (dequantized at each dispatch, the head
    left int8 for the ``int8_matmul`` kernel).  ``params`` may live on any
    device; the engine moves them to ``device``.

    ``warm_dir`` (and ``warm_shards`` uid-hash subdirs under it) turns on
    the disk warm tier; ``fault_plan`` reaches its fault sites.
    ``query_slo_us`` is the first-logit SLO the scheduler defends, planning
    with ``adapt_cost_hint_us`` until an adapt dispatch has been timed.
    ``max_queue`` bounds the admission queue (admitted requests are never
    dropped for it); ``deadline_us`` abandons a request still without logits
    that long after its enqueue.  All default off.

    ``serve_layout`` (a name of
    :data:`repro_torch.roofline.analysis.SERVING_LAYOUTS`) with ``mesh``
    (:func:`repro_torch.launch.mesh.make_replica_mesh`: its ``serve``
    group) places the weights in that layout on the group's ranks; the
    module docstring says what each dispatch then does.  Resolve ``'auto'``
    with :func:`repro_torch.roofline.analysis.choose_serving_layout` before
    construction: the engine applies a layout, it does not score one.
    ``stats()``'s parameter bytes count the whole tree, before placement.
    """

    def __init__(self, learner: MetaLearner, params: Tree, *,
                 lite: Optional[LiteSpec] = None, n_slots: int = 4,
                 query_chunk: int = 8, support_buckets: Sequence[int] = (64,),
                 cache_capacity: int = 64,
                 kernel_backend: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 warm_dir: Optional[str | pathlib.Path] = None,
                 query_slo_us: Optional[float] = None,
                 adapt_cost_hint_us: Optional[float] = None,
                 fault_plan=None,
                 max_queue: Optional[int] = None,
                 deadline_us: Optional[float] = None,
                 serve_quant: str = "none", device="cuda",
                 warm_shards: int = 1, serve_layout: Optional[str] = None,
                 mesh=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.device = resolve_device(device)
        self.learner = learner
        self.serve_quant = serve_quant
        params = tree_to(params, self.device)
        self._weights = quantize_frozen(learner, params, serve_quant)
        self._param_bytes = param_bytes(self._weights)
        self.serve_layout = serve_layout
        self.mesh = mesh
        self._weights = place_serving_weights(self._weights, mesh, serve_layout)
        self.lite = lite if lite is not None else LiteSpec(exact=True,
                                                           chunk_size=32)
        self.n_slots = n_slots
        self.query_chunk = query_chunk
        self.support_buckets = tuple(sorted(support_buckets))
        self.clock = clock if clock is not None else time.monotonic
        group = mesh.shape[serve_axis(mesh)] if mesh is not None else 1
        if group > 1 and (query_slo_us is not None or deadline_us is not None):
            self.clock = self._group_clock(self.clock)
        self.store = TwoTierTaskStore(
            cache_capacity, warm_dir, fault_plan=fault_plan, warm_shards=warm_shards,
            device=self.device, clock=self.clock,
            warm_writer=group == 1 or mesh.coords[serve_axis(mesh)] == 0,
            spilled=self._group_spilled if group > 1 else None)
        self.query_slo_us = query_slo_us
        self.max_queue = max_queue
        self.deadline_us = deadline_us
        # EWMA of measured adapt-dispatch time; a zero-duration reading (a
        # fake clock that was not advanced) is ignored
        self._adapt_cost_est_us: Optional[float] = adapt_cost_hint_us
        self.kernel_backend = dispatch.resolve_backend(kernel_backend, self.device)

        def _adapt_fn(weights, batch):
            with dispatch.use_backend(self.kernel_backend):
                return learner.adapt_batch(serving_params(weights), batch,
                                           self.lite)

        def _predict_fn(weights, states, qx):
            with dispatch.use_backend(self.kernel_backend):
                return learner.predict_batch(serving_params(weights),
                                             states, qx)

        self._adapt = BucketedStepCache(_adapt_fn)
        self._predict = BucketedStepCache(_predict_fn)
        self._queue: "collections.deque[EpisodicRequest]" = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        # the (n_slots, ...) predict-side stack of an unchanged live cohort
        self._stacked_states: Optional[tuple] = None
        self._adapt_lat_us: List[float] = []
        self._query_lat_us: List[float] = []
        self.tasks_adapted = 0
        self.queries_served = 0
        self.slo_preemptions = 0
        self.steps = 0
        self.rejections = 0
        self.deadline_abandoned = 0
        self.failed_requests = 0
        self.adapt_dispatches = 0
        self.predict_dispatches = 0

    # -- a serving group's agreement -------------------------------------------

    def _group_scalar(self, value, dtype) -> torch.Tensor:
        """``value`` as the serving group's index 0 holds it, on every rank
        (on the card for NCCL, on the host for gloo)."""
        dev = self.device if self.mesh.backend == "nccl" else "cpu"
        return self.mesh.broadcast(torch.tensor([value], dtype=dtype, device=dev),
                                   serve_axis(self.mesh))

    def _group_clock(self, base: Callable[[], float]) -> Callable[[], float]:
        """``base`` as the group's ``serve`` index 0 reads it, on every rank."""
        return lambda: float(self._group_scalar(base(), torch.float64).item())

    def _group_spilled(self, ok: bool) -> bool:
        """Whether the group's warm writer's spill landed, on every rank."""
        return bool(self._group_scalar(1 if ok else 0, torch.int32).item())

    # -- scheduling ----------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def submit(self, req: EpisodicRequest) -> bool:
        """Enqueue ``req`` (stamps ``t_enqueue``); admission is FIFO in
        ``step``.  Over ``max_queue`` the request is rejected instead
        (returns False, ``req.rejected`` set, nothing queued is displaced)
        with ``retry_after_us`` = the adapt waves queued ahead of it at the
        EWMA adapt cost (0 before any estimate)."""
        if req.t_enqueue is None:
            req.t_enqueue = self.clock()
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            req.rejected = True
            est = self._adapt_cost_est_us or 0.0
            req.retry_after_us = math.ceil(
                (len(self._queue) + 1) / self.n_slots) * est
            self.rejections += 1
            return False
        self._queue.append(req)
        return True

    def add_request(self, req: EpisodicRequest) -> bool:
        """Place ``req`` in a free slot now; False when every slot is live
        or its uid is (offer it again after a step)."""
        if req.t_enqueue is None:
            req.t_enqueue = self.clock()
        return self._try_admit(req)

    def _try_admit(self, req: EpisodicRequest) -> bool:
        """Admit ``req`` into a free slot; False defers (no free slot, or its
        uid is live).  A support-less request whose stored state is
        quarantined at the read fails terminally (consumed, no slot)."""
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
        if state is None and req.support_x is None:
            req.failed = True
            req.done = True
            req.t_done = self.clock()
            self.failed_requests += 1
            return True
        req.cache_hit = state is not None
        req.t_admit = self.clock()
        self._slots[self._free_slot()] = _Slot(
            req=req, state=state,
            stream=iter_query_chunks(req.query_x, self.query_chunk))
        return True

    def _admit_from_queue(self) -> None:
        while self._queue and self._try_admit(self._queue[0]):
            self._queue.popleft()

    def _earliest_query_deadline_us(self) -> Optional[float]:
        """Earliest SLO deadline over the live adapted lanes (the lanes a
        deferred adapt wave would help; lanes awaiting adaptation need it)."""
        if self.query_slo_us is None:
            return None
        deadlines = [s.req.t_enqueue * 1e6 + self.query_slo_us
                     for s in self._slots
                     if s is not None and s.state is not None]
        return min(deadlines) if deadlines else None

    def _adapt_wave_preempted(self, now: float) -> bool:
        """Defer the pending adapt wave iff a live lane's deadline is still
        ahead but would pass during the estimated adapt dispatch."""
        if self._adapt_cost_est_us is None:
            return False
        dmin = self._earliest_query_deadline_us()
        if dmin is None:
            return False
        now_us = now * 1e6
        return now_us < dmin <= now_us + self._adapt_cost_est_us

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the two batched dispatches ------------------------------------------

    def _adapt_pending(self) -> None:
        """One ``adapt_batch`` dispatch per support bucket among the slots
        awaiting adaptation, padded to ``n_slots`` lanes.  A task's pad cap
        follows its own support size, so its state does not depend on its
        co-tenants.  The EWMA times the dispatch to the end of its work."""
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
            batch = collate_task_batch(tasks, support_size=cap, query_size=1)
            t0 = self.clock()
            states = self._adapt(self._weights, batch.to(self.device))
            self._sync()
            t1 = self.clock()
            self.adapt_dispatches += 1
            dt_us = (t1 - t0) * 1e6
            if dt_us > 0:
                self._adapt_cost_est_us = (
                    dt_us if self._adapt_cost_est_us is None
                    else 0.7 * self._adapt_cost_est_us + 0.3 * dt_us)
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
            if s is None or s.state is None:      # awaiting (deferred) adapt
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
        out = self._predict(self._weights, stacked,
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

    def _abandon_hopeless(self) -> None:
        """With ``deadline_us``: drop each queued request, and retire each
        lane still awaiting adaptation, whose deadline passed before its
        first logit.  A request already streaming logits runs to the end."""
        if self.deadline_us is None:
            return
        now_us = self.clock() * 1e6

        def hopeless(r: EpisodicRequest) -> bool:
            return (r.t_first_logit is None
                    and now_us > r.t_enqueue * 1e6 + self.deadline_us)

        kept = collections.deque()
        for r in self._queue:
            if hopeless(r):
                r.abandoned = True
                r.done = True
                r.t_done = now_us / 1e6
                self.deadline_abandoned += 1
            else:
                kept.append(r)
        self._queue = kept
        for i, s in enumerate(self._slots):
            if s is not None and hopeless(s.req):
                s.req.abandoned = True
                self.deadline_abandoned += 1
                self._retire(i)

    def step(self) -> int:
        """Abandon hopeless requests, admit from the queue, adapt the
        pending tasks unless the SLO scheduler defers the wave, serve one
        query chunk per live task.  Returns the number of queries served."""
        self._abandon_hopeless()
        self._admit_from_queue()
        if any(s is not None and s.state is None for s in self._slots):
            if self._adapt_wave_preempted(self.clock()):
                self.slo_preemptions += 1
            else:
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

    def drain_unfinished(self) -> List[EpisodicRequest]:
        """Remove and return every request this engine still owes logits,
        live lanes first (slot order is admission order), then the queue in
        FIFO order, leaving the engine empty.  The replica-failover hook:
        when a replica group dies, the router drains its engine and
        re-routes the requests to the survivors (a spilled state
        rehydrates there from the warm tier; the rest re-adapts)."""
        out: List[EpisodicRequest] = []
        for i, s in enumerate(self._slots):
            if s is not None:
                out.append(s.req)
                self._slots[i] = None
        out.extend(self._queue)
        self._queue.clear()
        self._stacked_states = None
        return out

    @property
    def busy(self) -> bool:
        """True while any request is queued or live in a slot."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Counters and nearest-rank latency percentiles (us): adapt is
        enqueue -> state ready (cold requests only), query is enqueue ->
        first logit.  ``cache_*`` / ``hit_rate`` are the L1's; ``spills`` /
        ``rehydrates`` the warm tier's traffic and ``spill_mean_us`` /
        ``rehydrate_mean_us`` its mean time a state.  Degradation:
        ``quarantined``, ``spill_errors`` (> 0: the store went L1-only),
        ``rejections``, ``deadline_abandoned``, ``failed_requests``.
        ``*_compiles`` count the distinct dispatch shapes, ``*_dispatches``
        the dispatches."""
        st = self.store
        l1 = st.l1
        lookups = l1.hits + l1.misses
        return dict(
            tasks_adapted=self.tasks_adapted,
            queries_served=self.queries_served,
            steps=self.steps,
            queue_depth=len(self._queue),
            cache_hits=l1.hits,
            cache_misses=l1.misses,
            hit_rate=l1.hits / lookups if lookups else 0.0,
            evictions=l1.evictions,
            overwrites=l1.overwrites,
            spills=st.spills,
            rehydrates=st.rehydrates,
            rescan_hits=st.rescan_hits,
            quarantined=st.quarantined,
            spill_errors=st.spill_errors,
            rejections=self.rejections,
            deadline_abandoned=self.deadline_abandoned,
            failed_requests=self.failed_requests,
            slo_preemptions=self.slo_preemptions,
            adapt_cost_est_us=(self._adapt_cost_est_us
                               if self._adapt_cost_est_us is not None else 0.0),
            adapt_p50_us=_pctl(self._adapt_lat_us, 50),
            adapt_p99_us=_pctl(self._adapt_lat_us, 99),
            query_p50_us=_pctl(self._query_lat_us, 50),
            query_p99_us=_pctl(self._query_lat_us, 99),
            adapt_compiles=self._adapt.compile_count,
            predict_compiles=self._predict.compile_count,
            adapt_dispatches=self.adapt_dispatches,
            predict_dispatches=self.predict_dispatches,
            spill_mean_us=st.spill_s / st.spills * 1e6 if st.spills else 0.0,
            rehydrate_mean_us=(st.rehydrate_s / st.rehydrates * 1e6
                               if st.rehydrates else 0.0),
            param_bytes_resident=self._param_bytes["resident_bytes"],
            param_bytes_fp32=self._param_bytes["fp32_bytes"],
            frozen_param_bytes_resident=self._param_bytes["frozen_resident_bytes"],
            frozen_param_bytes_fp32=self._param_bytes["frozen_fp32_bytes"],
        )
