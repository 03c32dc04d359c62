"""Fault injection for the training and serving runtime
(:mod:`repro_torch.faults.plan`) and :class:`PreemptionSignal`, the
production half of graceful preemption: the launcher installs it on
SIGTERM; the loop polls it at each step boundary, flushes a checkpoint and raises ``PreemptedError`` (the same
path a ``train.preempt`` fault takes)."""
from __future__ import annotations

import signal as _signal
from typing import Optional, Sequence

from repro_torch.faults.plan import (ALL_SITES, CKPT_PRE_COMMIT,
                                     CKPT_PRE_REPLACE, DATA_NAN,
                                     DATA_TRANSIENT, FAULT_SITES,
                                     REPLICA_DEAD, TRAIN_PREEMPT, TRAIN_STRAGGLER,
                                     WARM_CORRUPT, WARM_VANISH, FaultPlan,
                                     FaultSpec, InjectedKill,
                                     TransientDataError, advance_clock)

__all__ = [
    "ALL_SITES", "CKPT_PRE_COMMIT", "CKPT_PRE_REPLACE", "DATA_NAN",
    "DATA_TRANSIENT", "FAULT_SITES", "REPLICA_DEAD", "TRAIN_PREEMPT", "TRAIN_STRAGGLER",
    "WARM_CORRUPT", "WARM_VANISH",
    "FaultPlan", "FaultSpec", "InjectedKill", "TransientDataError",
    "advance_clock", "PreemptionSignal",
]


class PreemptionSignal:
    """Cooperative preemption flag for the training loop: ``install()``
    sets it on real signals (SIGTERM by default); tests call
    ``request()``."""

    def __init__(self):
        self.requested = False

    def request(self, *_args) -> None:
        self.requested = True

    def install(self, signals: Optional[Sequence[int]] = None
                ) -> "PreemptionSignal":
        for sig in (signals if signals is not None else (_signal.SIGTERM,)):
            _signal.signal(sig, self.request)
        return self
