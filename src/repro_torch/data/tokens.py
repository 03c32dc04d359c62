"""Synthetic LM token pipeline (the JAX package's ``repro/data/tokens.py``):
next-token-predictable streams (orderful Markov chains), so losses fall in
smoke training runs, and a per-step generator layout, so a restart
reproduces the exact token stream.

Batches are numpy, drawn from ``np.random.default_rng((seed, step))``, and
bit-equal to the JAX package's for every (config, step).
:func:`batch_to_device` (and :class:`Prefetcher`, on its thread) moves a
batch to a torch device, token ids as int64.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int = 256
    seq_len: int = 128
    global_batch: int = 8
    branching: int = 4               # Markov out-degree (predictability)
    seed: int = 0


class TokenPipeline:
    """Deterministic function of (config, step): restart-exact."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._next = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, cfg.branching)).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        tok = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
        tok[:, 0] = rng.integers(0, cfg.vocab, cfg.global_batch)
        for t in range(1, cfg.seq_len):
            branch = rng.integers(0, cfg.branching, cfg.global_batch)
            tok[:, t] = self._next[tok[:, t - 1], branch]
        return dict(tokens=tok)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def require_tokens_only(cfg) -> None:
    """Raise ``ValueError`` for a model whose loss reads more than tokens:
    whisper's (the ``encdec`` family) needs ``frontend_embeds`` beside them,
    which this pipeline does not yield.  The JAX package's LM launcher has
    no whisper path either (ROADMAP R6); whisper trains through
    ``make_train_step`` on a batch that carries its frames."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the token pipeline yields no frontend_embeds, which the "
            f"encoder-decoder's loss reads (ROADMAP R6); train it through "
            f"make_train_step on batches that carry its frames")


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as torch tensors on ``device``; integer arrays (token
    ids) become int64, the index dtype of the port's embedding lookup."""
    return {k: torch.from_numpy(np.asarray(v)).to(
        device=device, dtype=torch.int64 if np.issubdtype(v.dtype, np.integer) else None)
        for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of an iterator of batches, each moved to
    ``device`` on the thread (None: left as it is).  ``close()`` stops the
    thread."""

    def __init__(self, it: Iterator, depth: int = 2, device=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = device
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="token-prefetcher")
        self._thread.start()

    def _run(self) -> None:
        for item in self._it:
            if self._device is not None:
                item = batch_to_device(item, self._device)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set():
                return

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
