"""Episodic data: shape buckets, collation, query chunking, two synthetic
image-task sources and a token-task source for the episodic LM.

The host half (buckets, collation, chunking, ``host_task_batch_at``) is
numpy and bit-identical with the functions of the same names in the JAX
package's ``data/episodic.py``: the same seed gives the same tasks, the
same bucket plan and the same padded batches.

The device half (``EpisodicImageConfig``, ``sample_image_task``,
``image_task_stream``, ``sample_image_task_batch``, ``task_batch_at``)
draws the JAX package's on-device task family on a torch device from a
``torch.Generator`` there.  ``jax.random`` cannot be reproduced, so it
keeps the contract, not the bits: a batch is a pure function of (seed,
cfg, tasks, step), the generator seeded with a splitmix64 hash of (seed,
step).

The token source (``EpisodicTokenConfig``, ``sample_token_task``,
``token_task_batch_at``) is the JAX package's ``sample_token_task`` on a
torch device, its contract kept the same way: each class a unigram
distribution over the vocabulary, every sequence drawn from its class's.

Image tasks: each class is a low-frequency pattern under heavy pixel noise.
The host source upsamples it 2x by repetition; ``augment`` adds a random
crop, a horizontal flip and per-image standardization, all vectorized over
the batch.  The device source upsamples a (h/4, w/4) pattern bilinearly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.episodic import Task, TaskBatch
from repro_torch.core.lite import _GOLDEN, _mix64


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


def collate_with_buckets(tasks: Sequence[Task], support_buckets: Sequence[int],
                         query_buckets: Sequence[int]) -> TaskBatch:
    """Collate against planned buckets: the pad targets are the smallest
    support and query caps that cover the batch's largest task, so a stream
    lands on at most ``len(support_buckets) * len(query_buckets)`` shapes."""
    return collate_task_batch(
        tasks,
        support_size=bucket_for(max(t.n_support for t in tasks), support_buckets),
        query_size=bucket_for(max(t.n_query for t in tasks), query_buckets))


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


# ---------------------------------------------------------------------------
# the on-device sampler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpisodicImageConfig:
    way: int = 5
    shot: int = 10                   # support examples per class
    query_per_class: int = 10
    image_size: int = 32
    channels: int = 3
    class_sep: float = 0.5           # RMS of the class patterns
    noise: float = 1.5               # std of the per-example pixel noise


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from splitmix64 of (seed, step), so
    any step's draws can be rebuilt alone."""
    with np.errstate(over="ignore"):
        h = _mix64(np.array([seed], np.uint64) * np.uint64(_GOLDEN) + np.uint64(step))
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(h[0] >> np.uint64(1)))    # manual_seed takes < 2**63
    return gen


def upsample_patterns(base: torch.Tensor, size: int) -> torch.Tensor:
    """(..., h, w, C) NHWC -> (..., size, size, C): bilinear, half-pixel
    centres, no antialiasing (``jax.image.resize(..., "linear")`` when
    upsampling)."""
    lead, (h, w, c) = base.shape[:-3], base.shape[-3:]
    x = base.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1).reshape(lead + (size, size, c))


def sample_image_task_batch(gen: torch.Generator, cfg: EpisodicImageConfig,
                            num_tasks: int) -> TaskBatch:
    """``num_tasks`` tasks of one shape on ``gen``'s device, NHWC float32,
    all-ones masks.  Each task: a (way, h/4, w/4, C) normal pattern per
    class, upsampled bilinearly and scaled to RMS ``class_sep`` over the
    task; every example its class pattern plus ``noise`` * N(0, 1); the
    support rows in a random order, the queries class by class."""
    t, way, size, c = num_tasks, cfg.way, cfg.image_size, cfg.channels
    dev = gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    base = upsample_patterns(normal(t, way, size // 4, size // 4, c), size)
    rms = torch.sqrt(torch.mean(base ** 2, dim=(1, 2, 3, 4), keepdim=True) + 1e-8)
    base = cfg.class_sep * base / rms

    def draw(per):
        x = base[:, :, None] + cfg.noise * normal(t, way, per, size, size, c)
        y = torch.arange(way, device=dev).repeat_interleave(per).expand(t, -1)
        return x.reshape(t, way * per, size, size, c), y

    sx, sy = draw(cfg.shot)
    qx, qy = draw(cfg.query_per_class)
    perm = torch.argsort(torch.rand(sy.shape, generator=gen, device=dev), dim=1)
    lanes = torch.arange(t, device=dev)[:, None]
    ones = lambda y: torch.ones(y.shape, device=dev)  # noqa: E731
    return TaskBatch(support_x=sx[lanes, perm], support_y=sy[lanes, perm],
                     query_x=qx, query_y=qy.contiguous(), support_mask=ones(sy),
                     query_mask=ones(qy), way=way)


def sample_image_task(gen: torch.Generator, cfg: EpisodicImageConfig) -> Task:
    """One task of :func:`sample_image_task_batch`'s family."""
    return sample_image_task_batch(gen, cfg, 1).task(0)


def image_task_stream(seed: int, cfg: EpisodicImageConfig,
                      device="cuda") -> Iterator[Task]:
    """Task i of the stream from ``step_generator(seed, i, device)``."""
    i = 0
    while True:
        yield sample_image_task(step_generator(seed, i, device), cfg)
        i += 1


def task_batch_at(seed: int, cfg: EpisodicImageConfig, tasks_per_step: int,
                  step: int, device="cuda") -> TaskBatch:
    """Step ``step``'s batch on ``device``: a pure function of (seed, cfg,
    tasks_per_step, step), the restart contract of
    :mod:`repro_torch.train.loop`."""
    return sample_image_task_batch(step_generator(seed, step, device), cfg,
                                   tasks_per_step)


# ---------------------------------------------------------------------------
# token tasks (the episodic LM)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpisodicTokenConfig:
    way: int = 5
    shot: int = 8
    query_per_class: int = 8
    seq_len: int = 64
    vocab: int = 256
    concentration: float = 0.3       # lower = more distinct class unigrams


def sample_token_task_batch(gen: torch.Generator, cfg: EpisodicTokenConfig,
                            num_tasks: int) -> TaskBatch:
    """``num_tasks`` token tasks on ``gen``'s device: ids (T, N, seq_len)
    and (T, M, seq_len) int64, labels int64, all-ones masks.  Each task: a
    class's unigram logits N(0, 1) / ``concentration`` over the vocab,
    every token of a class's sequences a categorical draw from them; the
    support rows in a random order, the queries class by class (the JAX
    package's ``sample_token_task``)."""
    t, way, seq = num_tasks, cfg.way, cfg.seq_len
    dev = gen.device
    logits = torch.randn((t * way, cfg.vocab), generator=gen, device=dev) / cfg.concentration
    probs = torch.softmax(logits, dim=-1)

    def draw(per):
        ids = torch.multinomial(probs, per * seq, replacement=True, generator=gen)
        y = torch.arange(way, device=dev).repeat_interleave(per).expand(t, -1)
        return ids.reshape(t, way * per, seq), y

    sx, sy = draw(cfg.shot)
    qx, qy = draw(cfg.query_per_class)
    perm = torch.argsort(torch.rand(sy.shape, generator=gen, device=dev), dim=1)
    lanes = torch.arange(t, device=dev)[:, None]
    ones = lambda y: torch.ones(y.shape, device=dev)  # noqa: E731
    return TaskBatch(support_x=sx[lanes, perm], support_y=sy[lanes, perm],
                     query_x=qx, query_y=qy.contiguous(), support_mask=ones(sy),
                     query_mask=ones(qy), way=way)


def sample_token_task(gen: torch.Generator, cfg: EpisodicTokenConfig) -> Task:
    """One task of :func:`sample_token_task_batch`'s family."""
    return sample_token_task_batch(gen, cfg, 1).task(0)


def token_task_batch_at(seed: int, cfg: EpisodicTokenConfig, tasks_per_step: int,
                        step: int, device="cuda") -> TaskBatch:
    """Step ``step``'s T token tasks on ``device``: a pure function of
    (seed, cfg, tasks_per_step, step)."""
    return sample_token_task_batch(step_generator(seed, step, device), cfg,
                                   tasks_per_step)
