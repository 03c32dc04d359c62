"""Faults planted under the timed path, for the check's own tests and for
reading a fault's numbers on the chip (``bench/control.py``)."""
from __future__ import annotations


def unchanged_state(step):
    """A training step that returns its state unchanged."""
    def faulty(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return faulty


def half_batch(step):
    """A training step that leaves out the second half of the batch's tasks
    and takes the mean over the rest."""
    def faulty(state, batch):
        from repro_torch.core.episodic_train import take_tasks
        t = batch["tasks"].num_tasks // 2
        return step(state, dict(batch, tasks=take_tasks(batch["tasks"], 0, t),
                                scores=batch["scores"][:t]))
    return faulty
