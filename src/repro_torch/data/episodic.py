"""Host-side episodic data: shape buckets, collation, query chunking and the
numpy synthetic image-task source.

All of it is numpy and bit-identical with the functions of the same names in
the JAX package's ``data/episodic.py``: the same seed gives the same tasks,
the same bucket plan and the same padded batches.

Image tasks: each class is a low-frequency pattern under heavy pixel noise;
``augment`` adds a random crop, a horizontal flip and per-image
standardization, all vectorized over the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.episodic import Task, TaskBatch


def bucket_size(n: int, multiple: int = 8) -> int:
    """Round n up to the next bucket boundary (at least ``multiple``)."""
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def plan_buckets(sizes: Sequence[int], max_buckets: int = 4,
                 multiple: int = 8) -> Tuple[int, ...]:
    """At most ``max_buckets`` ascending pad caps covering ``max(sizes)``:
    every size rounds up to a candidate cap, then the cap whose merge into
    the next adds the least padding (weighted by its count) is merged until
    few enough remain."""
    if not sizes:
        raise ValueError("plan_buckets needs a non-empty size histogram")
    if max_buckets < 1:
        raise ValueError(f"max_buckets={max_buckets} must be >= 1")
    hist: dict = {}
    for s in sizes:
        cap = bucket_size(s, multiple)
        hist[cap] = hist.get(cap, 0) + 1
    caps = sorted(hist)
    counts = [hist[c] for c in caps]
    while len(caps) > max_buckets:
        costs = [(caps[i + 1] - caps[i]) * counts[i]
                 for i in range(len(caps) - 1)]
        i = costs.index(min(costs))
        counts[i + 1] += counts[i]
        del caps[i], counts[i]
    return tuple(caps)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest planned bucket that fits ``n``; overflow raises (the plan's
    histogram is stale)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds every planned bucket {tuple(buckets)}; "
                     f"re-plan buckets from a fresh stream histogram")


def collate_task_batch(tasks: Sequence[Task],
                       support_size: Optional[int] = None,
                       query_size: Optional[int] = None,
                       bucket_multiple: int = 0) -> TaskBatch:
    """Stack ragged tasks into one :class:`TaskBatch` of numpy arrays.

    Rows are right-padded to the batch max, an explicit size (used exactly;
    overflow raises) or the max rounded to ``bucket_multiple``.  Padded
    support labels are -1, padded query labels 0; masks mark real rows.
    """
    if not tasks:
        raise ValueError("collate_task_batch needs at least one task")
    way = tasks[0].way
    if any(t.way != way for t in tasks):
        raise ValueError("all tasks in a batch must share `way`")

    def target(actual: int, explicit: Optional[int], kind: str) -> int:
        if explicit is not None:
            if actual > explicit:
                raise ValueError(f"task {kind} size {actual} exceeds bucket "
                                 f"{kind}_size={explicit}")
            return explicit
        return bucket_size(actual, bucket_multiple) if bucket_multiple else actual

    n = target(max(t.n_support for t in tasks), support_size, "support")
    m = target(max(t.n_query for t in tasks), query_size, "query")

    def pad_rows(a, rows: int, fill) -> np.ndarray:
        a = np.asarray(a)
        cfg = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, cfg, constant_values=fill)

    def mask_rows(real: int, rows: int) -> np.ndarray:
        return (np.arange(rows) < real).astype(np.float32)

    return TaskBatch(
        support_x=np.stack([pad_rows(t.support_x, n, 0) for t in tasks]),
        support_y=np.stack([pad_rows(t.support_y, n, -1) for t in tasks]),
        support_mask=np.stack([mask_rows(t.n_support, n) for t in tasks]),
        query_x=np.stack([pad_rows(t.query_x, m, 0) for t in tasks]),
        query_y=np.stack([pad_rows(t.query_y, m, 0) for t in tasks]),
        query_mask=np.stack([mask_rows(t.n_query, m) for t in tasks]),
        way=way,
    )


def iter_query_chunks(query_x: np.ndarray, chunk: int
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Split a query stream into fixed-shape ``(chunk, ...)`` pieces:
    yields ``(padded_chunk, mask, n_real)``, the tail zero-padded."""
    if chunk < 1:
        raise ValueError(f"query chunk must be >= 1, got {chunk}")
    q = np.asarray(query_x)
    for s in range(0, q.shape[0], chunk):
        piece = q[s:s + chunk]
        n = piece.shape[0]
        if n < chunk:
            piece = np.pad(piece,
                           [(0, chunk - n)] + [(0, 0)] * (piece.ndim - 1))
        yield piece, (np.arange(chunk) < n).astype(np.float32), n


@dataclasses.dataclass(frozen=True)
class HostEpisodicConfig:
    """Host (numpy) episodic image stream; ``augment`` adds random crop
    (from ``image_size + crop_pad``), horizontal flip and per-image
    standardization."""

    way: int = 5
    shot: int = 10
    query_per_class: int = 10
    image_size: int = 32
    channels: int = 3
    class_sep: float = 0.5
    noise: float = 1.5
    augment: bool = True
    crop_pad: int = 4


def host_task_batch_at(seed: int, cfg: HostEpisodicConfig,
                       tasks_per_step: int, step: int) -> TaskBatch:
    """Deterministic host batch for ``step``: a pure function of
    (seed, cfg, step), from ``np.random.SeedSequence([seed, step])``.
    Images are NHWC float32."""
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, step])))
    t, way, c = tasks_per_step, cfg.way, cfg.channels
    per = cfg.shot + cfg.query_per_class
    big = cfg.image_size + (cfg.crop_pad if cfg.augment else 0)
    base = rng.standard_normal(
        (t, way, (big + 1) // 2, (big + 1) // 2, c)).astype(np.float32)
    base = base.repeat(2, axis=2).repeat(2, axis=3)[:, :, :big, :big]
    base *= cfg.class_sep / np.sqrt((base ** 2).mean() + 1e-8)
    noise = cfg.noise * rng.standard_normal(
        (t, way, per, big, big, c)).astype(np.float32)
    x = (base[:, :, None] + noise).reshape(t * way * per, big, big, c)
    if cfg.augment:
        m, img = x.shape[0], cfg.image_size
        oy = rng.integers(0, cfg.crop_pad + 1, m)
        ox = rng.integers(0, cfg.crop_pad + 1, m)
        iy = oy[:, None] + np.arange(img)
        ix = ox[:, None] + np.arange(img)
        x = x[np.arange(m)[:, None, None], iy[:, :, None], ix[:, None, :]]
        flip = rng.integers(0, 2, m).astype(bool)
        x[flip] = x[flip, :, ::-1]
        mu = x.mean(axis=(1, 2), keepdims=True)
        sd = x.std(axis=(1, 2), keepdims=True) + 1e-6
        x = (x - mu) / sd
    img = cfg.image_size
    x = x.reshape(t, way, per, img, img, c)
    sx = np.ascontiguousarray(
        x[:, :, :cfg.shot].reshape(t, way * cfg.shot, img, img, c))
    qx = np.ascontiguousarray(
        x[:, :, cfg.shot:].reshape(t, way * cfg.query_per_class, img, img, c))
    sy = np.tile(np.repeat(np.arange(way), cfg.shot), (t, 1)).astype(np.int32)
    qy = np.tile(np.repeat(np.arange(way), cfg.query_per_class),
                 (t, 1)).astype(np.int32)
    ones = lambda y: np.ones(y.shape, np.float32)
    return TaskBatch(support_x=sx, support_y=sy, query_x=qx, query_y=qy,
                     support_mask=ones(sy), query_mask=ones(qy), way=way)
