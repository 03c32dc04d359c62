"""Episodic task containers.

A task is a support set to adapt on and a query set, over ``way`` classes
with task-local labels.  A :class:`TaskBatch` holds T tasks padded to one
shape, with float validity masks (1 real, 0 padding) and padded support
labels of -1.  Leaves are numpy arrays on the host; :meth:`TaskBatch.to`
moves them to a torch device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_map

Tree = Any


@dataclasses.dataclass
class Task:
    """One task: support_x (N, ...), support_y (N,), query_x (M, ...),
    query_y (M,), optional (N,)/(M,) validity masks."""

    support_x: Any
    support_y: Any
    query_x: Any
    query_y: Any
    way: int = 5
    support_mask: Optional[Any] = None
    query_mask: Optional[Any] = None

    @property
    def n_support(self) -> int:
        return self.support_x.shape[0]

    @property
    def n_query(self) -> int:
        return self.query_x.shape[0]


@dataclasses.dataclass
class TaskBatch:
    """T tasks stacked on a leading task axis:
    support_x (T, N, ...), support_y (T, N), support_mask (T, N),
    query_x (T, M, ...), query_y (T, M), query_mask (T, M)."""

    support_x: Any
    support_y: Any
    query_x: Any
    query_y: Any
    support_mask: Any
    query_mask: Any
    way: int = 5

    @property
    def num_tasks(self) -> int:
        return self.support_x.shape[0]

    def task(self, i: int) -> Task:
        """Task ``i``, its padding and masks included."""
        return Task(self.support_x[i], self.support_y[i], self.query_x[i],
                    self.query_y[i], way=self.way, support_mask=self.support_mask[i],
                    query_mask=self.query_mask[i])

    def to(self, device) -> "TaskBatch":
        """Tensors on ``device``: labels as int64, masks as float32, and
        inputs by kind: integer inputs (token ids) as int64, floating ones
        (images) as float32."""
        def conv(a, dtype=None):
            a = np.asarray(a)
            if dtype is None:
                dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
            return torch.tensor(a, dtype=dtype, device=device)
        f32, i64 = torch.float32, torch.int64
        return TaskBatch(support_x=conv(self.support_x),
                         support_y=conv(self.support_y, i64),
                         query_x=conv(self.query_x),
                         query_y=conv(self.query_y, i64),
                         support_mask=conv(self.support_mask, f32),
                         query_mask=conv(self.query_mask, f32), way=self.way)


def validate_task(task: Task) -> None:
    """Host-side invariant checks (used by tests and the data pipeline)."""
    if task.support_x.shape[0] != task.support_y.shape[0]:
        raise ValueError("support len mismatch")
    if task.query_x.shape[0] != task.query_y.shape[0]:
        raise ValueError("query len mismatch")


def validate_task_batch(batch: TaskBatch) -> None:
    t = batch.support_x.shape[0]
    for leaf in (batch.support_y, batch.support_mask, batch.query_x,
                 batch.query_y, batch.query_mask):
        if leaf.shape[0] != t:
            raise ValueError("task-axis length mismatch")
    if tuple(batch.support_mask.shape) != tuple(batch.support_y.shape):
        raise ValueError("support mask and labels differ in shape")
    if tuple(batch.query_mask.shape) != tuple(batch.query_y.shape):
        raise ValueError("query mask and labels differ in shape")


def query_batches(task: Task, batch_size: int):
    """Split a task's query set (tensors) into ceil(M / batch_size) padded
    batches and a per-example weight (Algorithm 1's outer loop): returns
    (query_x (B, Mb, ...), query_y (B, Mb), weight (B, Mb)).  An existing
    ``task.query_mask`` (collator padding) folds into the weights."""
    m = task.query_x.shape[0]
    b = -(-m // batch_size)
    pad = b * batch_size - m

    def _pad(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    qx = _pad(task.query_x).reshape((b, batch_size) + tuple(task.query_x.shape[1:]))
    qy = _pad(task.query_y).reshape(b, batch_size)
    w = (torch.arange(b * batch_size, device=qx.device) < m).to(
        torch.float32).reshape(b, batch_size)
    if task.query_mask is not None:
        w = w * _pad(task.query_mask).reshape(b, batch_size)
    return qx, qy, w


def stack_task_states(states) -> Tree:
    """Stack single-task states into a task-state batch (leading task axis);
    the inverse of :func:`index_task_state`."""
    return tree_map(lambda *ls: torch.stack(ls), *states)


def index_task_state(states: Tree, i: int) -> Tree:
    """Member ``i`` of a task-state batch, as its own copy (so a cached state
    does not keep the whole batch alive)."""
    return tree_map(lambda a: a[i].clone(), states)
