"""Background batch lookahead for the training loop and the per-shape step
cache (the JAX package's ``repro/train/pipeline.py``: ``Prefetcher`` and
``BucketedStepCache``).

A worker thread evaluates the deterministic ``batch_at(step)`` stream in
order, moves each batch to the device with ``put``, and pushes it into a
bounded queue, so host collation overlaps the device's work on the previous
step.  The consumer side is strictly sequential (``get(step)`` checks the
step), which keeps checkpoint resume exact: the thread only evaluates ahead
the same pure function the synchronous loop would call.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Optional

Tree = Any

_DONE = object()        # worker finished the requested range
_FAILED = object()      # worker raised; error in Prefetcher._err


class Prefetcher:
    """Background lookahead over ``batch_at(step)`` for steps [start, stop).

    ``depth`` bounds the batches in flight.  ``put`` moves a batch to the
    device (None: batches are used as built).  A failing ``batch_at`` is
    retried up to ``retries`` times with exponential backoff
    (``backoff_s * 2**attempt``; 0 = no wait); only an error that outlives
    every retry is raised, from ``get``.  ``retries_used`` counts the
    retries spent.  Always ``close()``."""

    def __init__(self, batch_at: Callable[[int], Tree], start: int,
                 stop: int, depth: int = 2,
                 put: Optional[Callable[[Tree], Tree]] = None,
                 retries: int = 0, backoff_s: float = 0.05):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop_evt = threading.Event()
        self._err: Optional[BaseException] = None
        self._next = start
        self._batch_at = batch_at
        self._put_fn = put
        self._retries = retries
        self._backoff_s = backoff_s
        self.retries_used = 0
        self._thread = threading.Thread(
            target=self._worker, args=(start, stop), daemon=True,
            name="batch-prefetcher")
        self._thread.start()

    def _enqueue(self, item) -> bool:
        while not self._stop_evt.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _fetch(self, s: int) -> Tree:
        """``batch_at(s)`` with bounded exponential-backoff retry; the wait
        uses the stop event so ``close()`` interrupts a backoff."""
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                return self._batch_at(s)
            except Exception:
                if attempt == self._retries or self._stop_evt.is_set():
                    raise
                self.retries_used += 1
                if delay > 0:
                    self._stop_evt.wait(delay)
                    delay *= 2

    def _worker(self, start: int, stop: int) -> None:
        try:
            for s in range(start, stop):
                if self._stop_evt.is_set():
                    return
                batch = self._fetch(s)
                if self._put_fn is not None:
                    batch = self._put_fn(batch)
                if not self._enqueue((s, batch)):
                    return
            self._enqueue(_DONE)
        except BaseException as e:  # noqa: BLE001 — delivered via get()
            self._err = e
            self._enqueue(_FAILED)

    def get(self, step: int) -> Tree:
        """The next batch; blocks until the worker has it."""
        if step != self._next:
            raise ValueError(f"prefetcher is sequential: expected step "
                             f"{self._next}, got {step}")
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._err is not None:
                    raise self._err
                if not self._thread.is_alive():
                    raise RuntimeError("prefetcher thread died without "
                                       "delivering a batch")
        if item is _FAILED:
            raise self._err
        if item is _DONE:
            raise ValueError(f"prefetcher exhausted before step {step}")
        s, batch = item
        if s != step:
            raise RuntimeError(f"prefetcher delivered step {s} for {step}")
        self._next += 1
        return batch

    def close(self) -> None:
        self._stop_evt.set()
        try:                      # unblock a worker stuck on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def _shape_key(tree: Tree) -> tuple:
    """Hashable (structure, shapes, dtypes) of ``tree``: containers and
    dataclasses by type and field, tensors and arrays by shape and dtype,
    other leaves (ints, strings) by type, as a traced program would key
    them."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _shape_key(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_shape_key(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__,) + tuple(
            (f.name, _shape_key(getattr(tree, f.name)))
            for f in dataclasses.fields(tree))
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return (tuple(tree.shape), str(tree.dtype))
    return (type(tree).__name__,)


class BucketedStepCache:
    """A step-like callable keyed per (structure, shapes, dtypes) of its
    arguments, with the JAX package's exact ``compile_count``: how many
    distinct keys it has been called with.  A flat count over a ragged
    stream is the bucketing policy working.  Eager PyTorch compiles
    nothing, so every key runs the same ``step_fn``; the key is where a
    per-shape CUDA graph would be captured."""

    def __init__(self, step_fn: Callable):
        self._fn = step_fn
        self._seen: Dict[tuple, int] = {}

    @property
    def compile_count(self) -> int:
        return len(self._seen)

    def __call__(self, *args):
        key = _shape_key(args)
        self._seen[key] = self._seen.get(key, 0) + 1
        return self._fn(*args)
