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

    def to(self, device) -> "TaskBatch":
        """Tensors on ``device``: floats as float32, labels as int64."""
        def conv(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)
        f32, i64 = torch.float32, torch.int64
        return TaskBatch(support_x=conv(self.support_x, f32),
                         support_y=conv(self.support_y, i64),
                         query_x=conv(self.query_x, f32),
                         query_y=conv(self.query_y, i64),
                         support_mask=conv(self.support_mask, f32),
                         query_mask=conv(self.query_mask, f32), way=self.way)


def stack_task_states(states) -> Tree:
    """Stack single-task states into a task-state batch (leading task axis);
    the inverse of :func:`index_task_state`."""
    return tree_map(lambda *ls: torch.stack(ls), *states)


def index_task_state(states: Tree, i: int) -> Tree:
    """Member ``i`` of a task-state batch, as its own copy (so a cached state
    does not keep the whole batch alive)."""
    return tree_map(lambda a: a[i].clone(), states)
