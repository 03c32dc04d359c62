"""Deterministic fault-injection plans: the port's copy of the JAX
package's ``repro/faults/plan.py``, for the sites that the training loop,
the checkpointer, the serving warm tier and the replica router fire.

A :class:`FaultPlan` is a seeded, fully deterministic schedule of
:class:`FaultSpec` triggers ``(site, at, kind)`` that the fault-tolerant
components accept by injection (``train(fault_plan=...)``,
``CheckpointManager(fault_plan=...)``,
``EpisodicServeEngine(fault_plan=...)``), so every failure mode they claim
to survive reproduces in a test without monkeypatching, timing or real
signals.

==========================  ================================================
``data.nan``                poison the step's batch with NaN (every float
                            array or tensor) — drives the non-finite guard
``data.transient``          raise :class:`TransientDataError` from
                            ``batch_at`` — drives prefetcher/loop retry
``train.preempt``           graceful preemption at a step: the loop flushes
                            a checkpoint and raises ``PreemptedError``
``train.straggler``         make a step slow by ``payload`` seconds
                            (advances an injectable clock)
``ckpt.pre_commit``         kill (raise :class:`InjectedKill`) after the
                            checkpoint tmp write, before the COMMIT marker
``ckpt.pre_replace``        kill after COMMIT, before the atomic
                            ``os.replace`` publish
``warm.corrupt``            truncate a uid's just-published warm-tier npz to
                            ``payload`` bytes (default 16) — the read
                            quarantines it
``warm.vanish``             remove the warm directory before a spill — the
                            store degrades to L1-only
``replica.dead``            a serving replica group dies mid-run: the
                            replica router quarantines it and re-routes its
                            unfinished requests to the surviving replicas
                            (spilled states rehydrate there bit-exactly,
                            the rest re-adapts or fails terminally)
==========================  ================================================

``at`` is the step, the task uid at the warm sites, or the replica index
at ``replica.dead`` (``None`` matches any); ``count`` bounds how many times
a spec fires; every firing is recorded in ``plan.fired``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_NAN = "data.nan"
DATA_TRANSIENT = "data.transient"
TRAIN_PREEMPT = "train.preempt"
TRAIN_STRAGGLER = "train.straggler"
CKPT_PRE_COMMIT = "ckpt.pre_commit"
CKPT_PRE_REPLACE = "ckpt.pre_replace"
WARM_CORRUPT = "warm.corrupt"
WARM_VANISH = "warm.vanish"
REPLICA_DEAD = "replica.dead"

ALL_SITES = (DATA_NAN, DATA_TRANSIENT, TRAIN_PREEMPT, TRAIN_STRAGGLER,
             CKPT_PRE_COMMIT, CKPT_PRE_REPLACE, WARM_CORRUPT, WARM_VANISH,
             REPLICA_DEAD)

# every FaultSpec.site must be one of these (checked at construction), and
# every injection point names its site by the constants above (the lint
# rule fault-site-registry refuses string literals there)
FAULT_SITES = frozenset(ALL_SITES)


class TransientDataError(RuntimeError):
    """A retryable data-source failure (the injected stand-in for a flaky
    loader / filesystem / network read)."""


class InjectedKill(RuntimeError):
    """Simulated process death at a precise point (e.g. between a
    checkpoint's tmp write and its atomic publish); what is on disk is
    what a real crash would leave."""


@dataclasses.dataclass
class FaultSpec:
    """One trigger: fire ``kind`` at ``site`` when the site's index equals
    ``at`` (``None`` = any index), at most ``count`` times."""

    site: str
    at: Optional[int] = None
    kind: str = "error"
    payload: Any = None
    count: int = 1
    remaining: int = dataclasses.field(default=-1)

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}: every site must be "
                f"declared in repro_torch/faults/plan.py (FAULT_SITES) and "
                f"referenced by its constant — known sites: "
                f"{sorted(FAULT_SITES)}")
        if self.remaining < 0:
            self.remaining = self.count


def _poison(a):
    """NaN in place of every floating array or tensor of a batch (dicts,
    lists, tuples and dataclasses such as TaskBatch are walked)."""
    if isinstance(a, torch.Tensor):
        return torch.full_like(a, float("nan")) if a.is_floating_point() else a
    if isinstance(a, np.ndarray):
        return np.full_like(a, np.nan) if np.issubdtype(a.dtype, np.inexact) else a
    if isinstance(a, dict):
        return {k: _poison(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_poison(v) for v in a)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.replace(a, **{f.name: _poison(getattr(a, f.name))
                                         for f in dataclasses.fields(a)})
    return a


class FaultPlan:
    """A deterministic schedule of :class:`FaultSpec` triggers.

    ``fire(site, at)`` returns the first matching spec with firings left
    (decrementing it) or ``None``; ``fired`` records ``(site, at, kind)``
    per firing."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self.fired: List[Tuple[str, Optional[int], str]] = []

    @classmethod
    def single(cls, site: str, at: Optional[int] = None, kind: str = "error",
               payload: Any = None, count: int = 1) -> "FaultPlan":
        return cls([FaultSpec(site=site, at=at, kind=kind, payload=payload,
                              count=count)])

    @classmethod
    def seeded(cls, seed: int, site: str, num_steps: int, rate: float,
               kind: str = "error", payload: Any = None,
               count: int = 1) -> "FaultPlan":
        """Each step in ``range(num_steps)`` gets a trigger with probability
        ``rate``, drawn from ``np.random.default_rng(seed)``: the same seed
        gives the same schedule (the JAX package's, draw for draw)."""
        rng = np.random.default_rng(seed)
        steps = np.nonzero(rng.random(num_steps) < rate)[0]
        return cls([FaultSpec(site=site, at=int(s), kind=kind,
                              payload=payload, count=count) for s in steps])

    def extend(self, other: "FaultPlan") -> "FaultPlan":
        """Merge another plan's specs into this one (one ``fired`` log)."""
        self.specs.extend(other.specs)
        return self

    def fire(self, site: str, at: Optional[int] = None) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.site != site or spec.remaining <= 0:
                continue
            if spec.at is not None and at is not None and spec.at != at:
                continue
            spec.remaining -= 1
            self.fired.append((site, at, spec.kind))
            return spec
        return None

    def fired_count(self, site: Optional[str] = None) -> int:
        """Firings so far, of ``site`` or of every site."""
        if site is None:
            return len(self.fired)
        return sum(1 for s, _, _ in self.fired if s == site)

    def wrap_batch_at(self, batch_at: Callable[[int], Any]
                      ) -> Callable[[int], Any]:
        """Wrap a deterministic ``batch_at(step)`` with the data sites:
        ``data.transient`` raises (each call fires again, so a retry
        consumes one firing per attempt), ``data.nan`` poisons every float
        array or tensor of the batch with NaN."""
        def wrapped(step: int):
            if self.fire(DATA_TRANSIENT, step) is not None:
                raise TransientDataError(
                    f"injected transient data-source failure at step {step}")
            batch = batch_at(step)
            if self.fire(DATA_NAN, step) is not None:
                batch = _poison(batch)
            return batch

        return wrapped


def advance_clock(clock: Callable[[], float], dt: float) -> None:
    """Make ``dt`` seconds pass on an injectable clock: a test's fake clock
    (anything with ``.advance``) advances without sleeping; a wall clock
    sleeps for real (the launcher path)."""
    if hasattr(clock, "advance"):
        clock.advance(dt)
    else:
        import time
        # lint: allow(clock-discipline): the wall-clock half of the
        # injectable-clock contract itself — launchers land here, tests
        # always inject a fake clock and never reach this branch
        time.sleep(dt)
