"""The port's own copy of the JAX package's ``MetaTrainConfig``
(``repro/configs/base.py``), with the same construction-time checks.

Two differences: ``kernel_backend`` takes the port's backends
(``naive | ref | cuda | auto``) and defaults to ``auto``, which is the
hand-written kernels on a CUDA device (the JAX package defaults to
``ref`` because its kernels run in interpret mode off the TPU); and the
multi-device knobs (``dp_shards``, ``dcn_shards``, ``grad_reduce=
'compressed'``) raise, because multi-GPU training is not ported (ROADMAP
A12).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.dispatch import BACKENDS


@dataclasses.dataclass(frozen=True)
class MetaTrainConfig:
    """Task-batched LITE meta-training knobs (repro_torch.core.episodic_train).

    tasks_per_step: tasks whose gradients are averaged into ONE optimizer
      step (1 reproduces paper Algorithm 1).
    dp_shards, dcn_shards, grad_reduce: the JAX package's data-parallel
      knobs; only 1, 1 and 'pmean' are accepted until A12.
    accum_steps: sequential gradient-accumulation chunks of the tasks per
      optimizer step, so tasks_per_step can exceed what one pass holds.
      Divisibility (tasks_per_step % (dp_shards * dcn_shards *
      accum_steps)) is checked here at construction time.
    lite_h, lite_chunk, lite_dtype: the LiteSpec of every aggregation site
      (H size, complement chunk, complement compute dtype; None = fp32).
    lr, max_grad_norm: AdamW's (peak) learning rate and the global-norm
      clip.
    schedule: LR schedule name (None = constant ``lr``; 'cosine' | 'wsd'
      over warmup_steps / total_steps, repro_torch.optim.schedules).
    prefetch: background batch lookahead depth of the train loop (0 =
      synchronous).  donate: accepted for the JAX launcher's flag; eager
      PyTorch has no buffer donation, so it changes nothing.
    kernel_backend: repro_torch.kernels.dispatch backend of the class sums,
      Simple CNAPs second moments and Mahalanobis head, bound per step.
    skip_nonfinite: a NaN/inf gradient leaves params and optimizer state
      bit-identical (metrics['nonfinite'] reports it); the loop bounds how
      many consecutive skips count as divergence.
    """

    tasks_per_step: int = 8
    dp_shards: int = 1
    dcn_shards: int = 1
    grad_reduce: str = "pmean"       # 'pmean' | 'compressed'
    accum_steps: int = 1
    lite_h: int = 8
    lite_chunk: Optional[int] = None
    lite_dtype: Optional[str] = None
    lr: float = 1e-3
    max_grad_norm: float = 10.0
    schedule: Optional[str] = None
    warmup_steps: int = 0
    total_steps: int = 0
    prefetch: int = 2
    donate: bool = True
    kernel_backend: str = "auto"
    skip_nonfinite: bool = True

    def __post_init__(self):
        if self.grad_reduce not in ("pmean", "compressed"):
            raise ValueError(
                f"grad_reduce={self.grad_reduce!r} (want 'pmean' or "
                f"'compressed')")
        if self.grad_reduce == "compressed" and self.dcn_shards < 2:
            raise ValueError(
                "grad_reduce='compressed' compresses CROSS-HOST traffic; "
                f"with dcn_shards={self.dcn_shards} there is none to "
                "compress and gradients would be quantized for a "
                "singleton reduction — set dcn_shards >= 2 (or keep "
                "grad_reduce='pmean')")
        for name in ("dp_shards", "dcn_shards", "accum_steps",
                     "tasks_per_step"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        denom = self.dp_shards * self.dcn_shards * self.accum_steps
        if self.tasks_per_step % denom:
            raise ValueError(
                f"tasks_per_step={self.tasks_per_step} must be divisible by "
                f"dp_shards*dcn_shards*accum_steps = {self.dp_shards}*"
                f"{self.dcn_shards}*{self.accum_steps} = {denom} (every "
                f"shard scans accum_steps equal task chunks)")
        if self.kernel_backend not in BACKENDS:
            raise ValueError(f"kernel_backend={self.kernel_backend!r} (want one "
                             f"of {BACKENDS})")
        if self.dp_shards > 1 or self.dcn_shards > 1 or \
                self.grad_reduce == "compressed":
            raise ValueError(
                f"dp_shards={self.dp_shards}, dcn_shards={self.dcn_shards}, "
                f"grad_reduce={self.grad_reduce!r}: multi-GPU is not ported "
                f"(ROADMAP A12); train on one device")
