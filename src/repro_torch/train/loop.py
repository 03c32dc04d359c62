"""Fault-tolerant training loop (the JAX package's ``repro/train/loop.py``,
one device, eager PyTorch).

* The step is a function of (state, batch) and ``batch_at`` a pure
  function of the step, so a restart from any committed checkpoint
  replays exactly (checkpoints: :mod:`repro_torch.train.checkpoint`).
* ``prefetch=k`` builds batches on a background thread
  (:class:`repro_torch.train.pipeline.Prefetcher`) and the loop stops
  synchronising every step: it waits for the device only at the first and
  last step, at log and checkpoint boundaries, and every ``max_span``
  steps, and spreads a span's wall time evenly over its steps, so
  ``TrainResult.throughput()`` reports tasks per second, not enqueue
  latency.
* Non-finite updates: steps report ``metrics['nonfinite']``; more than
  ``max_nonfinite`` consecutive skips restore the latest committed
  checkpoint and replay (at most ``max_rollbacks`` times), else
  :class:`DivergenceError`.
* Transient data faults: ``batch_at`` failures retry with bounded
  exponential backoff (``data_retries`` / ``data_backoff_s``), in the
  prefetcher's worker or inline here.
* Graceful preemption: a :class:`repro_torch.faults.PreemptionSignal`
  (``preempt=``, set by SIGTERM or a ``train.preempt`` fault) is polled at
  every step boundary; the loop flushes a checkpoint at the current step
  and raises :class:`PreemptedError`; the resumed run replays exactly.
* All timing reads the injectable ``clock`` (default ``time.time``); a
  ``train.straggler`` fault advances it, so straggler detection is
  testable with a fake clock and no sleeps.
* Under a data-parallel mesh every rank runs the loop: the skip and
  rollback decisions rest on the step's metrics, which the ranks agree on
  (:func:`repro_torch.core.episodic_train.make_batched_meta_train_step`),
  the sync points are the same on every rank, ``agree`` makes the
  preemption verdict every rank's, and ``ckpt`` is a
  :class:`repro_torch.train.checkpoint.MeshCheckpointManager` (rank 0
  writes, every rank reads); ``log`` is None on every rank but one.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.faults.plan import TRAIN_PREEMPT, TRAIN_STRAGGLER, advance_clock
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.pipeline import Prefetcher

Tree = Any


class PreemptedError(RuntimeError):
    """Graceful preemption: a checkpoint at ``step`` was flushed before
    raising, so rerunning the same command resumes exactly.  Launchers exit
    75 (EX_TEMPFAIL) on this."""

    def __init__(self, step: int, flushed: bool):
        self.step = step
        self.flushed = flushed
        where = f"checkpoint flushed at step {step}" if flushed else \
            "no checkpoint manager — progress since start is lost"
        super().__init__(f"preempted at step {step} ({where})")


class DivergenceError(RuntimeError):
    """More than ``max_nonfinite`` consecutive non-finite (skipped) steps
    and no rollback budget or checkpoint left to recover with."""


class _Diverged(Exception):
    """Internal: consecutive-skip budget exceeded at ``step``."""

    def __init__(self, step: int):
        self.step = step


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ratio x the EWMA."""

    alpha: float = 0.1
    ratio: float = 3.0
    ewma: Optional[float] = None
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.ratio * self.ewma
        if slow:
            self.flagged.append(step)
        # slow steps do not poison the EWMA
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(dt, self.ratio * self.ewma)
        return slow


@dataclasses.dataclass
class TrainResult:
    state: Tree
    step: int
    metrics_history: List[Dict]
    straggler_steps: List[int]
    resumed_from: Optional[int]
    step_times: List[float] = dataclasses.field(default_factory=list)
    nonfinite_steps: List[int] = dataclasses.field(default_factory=list)
    rollbacks: int = 0
    data_retries: int = 0

    def throughput(self, items_per_step: int = 1, skip: int = 1) -> float:
        """items/s over the run, without the first ``skip`` steps (the
        first step is always a span of its own, so ``skip=1`` drops the
        warm-up: cuDNN autotuning, the kernels' first load)."""
        times = self.step_times[skip:] or self.step_times
        if not times:
            return 0.0
        return items_per_step * len(times) / sum(times)


def _block(state: Tree) -> None:
    """Wait for the device that holds the state."""
    leaf = tree_leaves(state)[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def train(state: Tree,
          train_step: Callable,
          batch_at: Callable[[int], Dict],
          num_steps: int,
          *,
          ckpt: Optional[CheckpointManager] = None,
          ckpt_every: int = 50,
          state_template: Optional[Tree] = None,
          preemption_hook: Optional[Callable[[int], None]] = None,
          log_every: int = 0,
          prefetch: int = 0,
          donate: bool = False,
          batch_put: Optional[Callable] = None,
          max_span: int = 64,
          fault_plan=None,
          preempt=None,
          max_nonfinite: int = 8,
          max_rollbacks: int = 1,
          data_retries: int = 2,
          data_backoff_s: float = 0.05,
          clock: Optional[Callable[[], float]] = None,
          agree: Optional[Callable[[bool], bool]] = None,
          log: Optional[Callable[[str], None]] = functools.partial(print, flush=True)
          ) -> TrainResult:
    """Run (and resume) training.  ``batch_at(step)`` must be deterministic
    in ``step``; with checkpointed state that makes restarts exact.

    ``prefetch > 0`` builds batches ``prefetch`` steps ahead on a thread
    (``batch_put`` moves each to the device there) and synchronises only at
    span boundaries, bounded by ``max_span``; within a span the straggler
    monitor sees the span-average step time and non-finite skips are
    detected at the span's end.  ``donate`` is accepted for the JAX
    loop's signature and does nothing here: whether a step reuses its
    state's buffers is the step's own contract.  The LM step
    (:func:`repro_torch.train.step.make_train_step`) updates params and
    optimizer state in place, the counterpart of the JAX loop's donated
    buffers; the episodic step returns new tensors.

    ``fault_plan`` injects faults at the documented sites; ``preempt`` is a
    :class:`repro_torch.faults.PreemptionSignal`; ``max_nonfinite`` bounds
    consecutive skipped steps before a rollback (``max_rollbacks`` of
    them, needing ``ckpt`` and ``state_template``) or
    :class:`DivergenceError`; ``data_retries`` / ``data_backoff_s`` bound
    the transient-data retry; ``clock`` replaces ``time.time``.  ``agree``
    (a mesh's ``any_rank``) turns this rank's preemption verdict into every
    rank's; ``log`` prints the step and rollback lines (None: silent)."""
    del donate
    _clock = clock if clock is not None else time.time
    if fault_plan is not None:
        batch_at = fault_plan.wrap_batch_at(batch_at)

    start = 0
    resumed_from = None
    if ckpt is not None and state_template is not None:
        restored = ckpt.restore_latest(state_template)
        if restored is not None:
            start, state, _ = restored
            resumed_from = start
    base_start = start
    monitor = StragglerMonitor()
    history: List[Dict] = []
    step_times: List[float] = []
    nonfinite_steps: List[int] = []
    consecutive_nonfinite = 0
    rollbacks_done = 0
    retries_spent = 0

    def fetch_sync(s: int):
        """Sync-mode ``batch_at`` with the prefetcher's bounded-backoff
        retry; backoff goes through ``advance_clock``."""
        nonlocal retries_spent
        delay = data_backoff_s
        for attempt in range(data_retries + 1):
            try:
                b = batch_at(s)
                return batch_put(b) if batch_put is not None else b
            except Exception:
                if attempt == data_retries:
                    raise
                retries_spent += 1
                if delay > 0:
                    advance_clock(_clock, delay)
                    delay *= 2

    def run_from(attempt_start: int, state: Tree) -> Tree:
        """Steps [attempt_start, num_steps); raises :class:`_Diverged` when
        the consecutive-skip budget blows."""
        nonlocal consecutive_nonfinite, retries_spent
        pf = None
        source = fetch_sync
        if prefetch > 0 and attempt_start < num_steps:
            pf = Prefetcher(batch_at, attempt_start, num_steps,
                            depth=prefetch, put=batch_put,
                            retries=data_retries, backoff_s=data_backoff_s)
            source = pf.get
        try:
            pending: List[tuple] = []    # (step, metrics) run, not yet read
            span_t0: Optional[float] = None
            span_start = attempt_start
            for step in range(attempt_start, num_steps):
                if preemption_hook is not None:
                    preemption_hook(step)    # may raise (simulated SIGTERM)
                preempted = preempt is not None and preempt.requested
                if fault_plan is not None and \
                        fault_plan.fire(TRAIN_PREEMPT, step) is not None:
                    preempted = True
                if agree is not None:
                    preempted = agree(preempted)
                if preempted:
                    # the state holds steps up to step-1: flush a checkpoint
                    # AT step so the rerun resumes right here
                    if ckpt is not None:
                        ckpt.save(step, state)
                    raise PreemptedError(step, flushed=ckpt is not None)
                if span_t0 is None:
                    span_t0 = _clock()
                    span_start = step
                state, metrics = train_step(state, source(step))
                if fault_plan is not None:
                    spec = fault_plan.fire(TRAIN_STRAGGLER, step)
                    if spec is not None:
                        advance_clock(_clock, float(spec.payload or 1.0))
                pending.append((step, metrics))
                sync = (prefetch == 0 or step == attempt_start
                        or step == num_steps - 1
                        or (log_every and step % log_every == 0)
                        or (ckpt is not None and (step + 1) % ckpt_every == 0)
                        or len(pending) >= max(max_span, 1))
                if sync:
                    _block(state)
                    per = (_clock() - span_t0) / (step - span_start + 1)
                    diverged_at = None
                    for s, m in pending:
                        step_times.append(per)
                        monitor.observe(s, per)
                        fm = {k: float(v) for k, v in m.items()}
                        history.append(fm)
                        if fm.get("nonfinite", 0.0) >= 0.5:
                            nonfinite_steps.append(s)
                            consecutive_nonfinite += 1
                            if consecutive_nonfinite > max_nonfinite and \
                                    diverged_at is None:
                                diverged_at = s
                        else:
                            consecutive_nonfinite = 0
                    pending.clear()
                    span_t0 = None
                    if diverged_at is not None:
                        raise _Diverged(diverged_at)
                    if log is not None and log_every and step % log_every == 0:
                        log(f"step {step}: {history[-1]}")
                if ckpt is not None and (step + 1) % ckpt_every == 0:
                    ckpt.save(step + 1, state)
            return state
        finally:
            if pf is not None:
                retries_spent += pf.retries_used
                pf.close()

    attempt_start = start
    while True:
        try:
            state = run_from(attempt_start, state)
            break
        except _Diverged as d:
            can_roll = (ckpt is not None and state_template is not None
                        and rollbacks_done < max_rollbacks)
            restored = ckpt.restore_latest(state_template) if can_roll else None
            if restored is None:
                raise DivergenceError(
                    f"{consecutive_nonfinite} consecutive non-finite steps "
                    f"(> max_nonfinite={max_nonfinite}) ending at step "
                    f"{d.step}; rollbacks used {rollbacks_done}/"
                    f"{max_rollbacks}" + (
                        "" if ckpt is not None and state_template is not None
                        else " and no checkpoint manager/template to roll "
                             "back with")) from None
            r, state, _ = restored
            rollbacks_done += 1
            consecutive_nonfinite = 0
            # rewind the bookkeeping to the restore point; the replayed
            # steps record their entries again
            del history[r - base_start:]
            del step_times[r - base_start:]
            nonfinite_steps[:] = [s for s in nonfinite_steps if s < r]
            monitor.flagged[:] = [s for s in monitor.flagged if s < r]
            if log is not None:
                log(f"divergence at step {d.step}: rolled back to committed "
                    f"checkpoint at step {r} (rollback {rollbacks_done}/{max_rollbacks})")
            attempt_start = r

    if ckpt is not None:
        ckpt.save(num_steps, state)
    return TrainResult(state=state, step=num_steps, metrics_history=history,
                       straggler_steps=monitor.flagged,
                       resumed_from=resumed_from, step_times=step_times,
                       nonfinite_steps=nonfinite_steps,
                       rollbacks=rollbacks_done, data_retries=retries_spent)
