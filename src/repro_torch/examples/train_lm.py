"""End-to-end LM training example, the port of the JAX package's
``examples/train_lm.py``: a reduced member of the arch's family
(:func:`scaled_100m`) trained for a few hundred steps through the
production substrate: the token pipeline, AdamW and a cosine schedule,
global-norm clipping, atomic checkpoints with auto-resume and straggler
monitoring.

    python -m repro_torch.examples.train_lm --arch minitron-4b --steps 300

It runs on ``--device`` (default ``cuda``: the arch's kernels, flash
attention on every attention layer, ssd_chunk on every SSD chunk; it
raises without a card unless ``--device cpu`` is given).  ``--full``
trains the full assigned config on that one device instead: gemma2-2b's
fp32 params, gradients and AdamW state (41.8 GB) fit an 80 GB card,
minitron-4b's (81.6 GB) do not.  ``--arch whisper-base`` is refused, as
by the training launcher: its loss reads frames the token pipeline does
not yield (ROADMAP R6).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.tokens import (TokenPipeline, TokenPipelineConfig, batch_to_device,
                                     require_tokens_only)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.serve.episodic import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import train
from repro_torch.train.step import adamw_for, make_init_state, make_train_step


def scaled_100m(arch: str):
    """A reduced member of the arch's family (the JAX example's shape)."""
    cfg = get_smoke_config(arch)
    return dataclasses.replace(
        cfg, n_layers=max(cfg.n_layers, 4), d_model=256,
        d_ff=cfg.d_ff * 4 if cfg.d_ff else 0, vocab=8192, max_seq=2048)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="minitron-4b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="defaults to repro_torch_lm_ckpt_<config> in the temporary "
                         "directory")
    ap.add_argument("--full", action="store_true",
                    help="the full assigned config, on the one device")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs without a GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else scaled_100m(args.arch)
    require_tokens_only(cfg)
    device = resolve_device(args.device)
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab} device={device}", flush=True)

    init = make_init_state(cfg, adamw_for(cfg))
    schedule = functools.partial(cosine_schedule, peak=3e-4, warmup_steps=20,
                                 total_steps=args.steps)
    step = make_train_step(cfg, adamw_for(cfg), schedule=schedule)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, branching=4))

    def batch_at(s):
        return batch_to_device(pipe.batch_at(s), device)

    ckpt = CheckpointManager(args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_lm_ckpt_{cfg.name}"), keep=3)
    state = init(torch.Generator(device=device).manual_seed(0), device)
    result = train(state, step, batch_at, args.steps, ckpt=ckpt, ckpt_every=100,
                   state_template=state, log_every=25)
    if result.resumed_from is not None:
        print(f"(resumed from checkpointed step {result.resumed_from})")
    if not result.metrics_history:
        print(f"nothing to do: checkpoint already at step {result.step}")
        return
    print(f"final loss: {result.metrics_history[-1]['loss']:.4f} "
          f"(first: {result.metrics_history[0]['loss']:.4f})", flush=True)
    if result.straggler_steps:
        print(f"straggler steps flagged: {result.straggler_steps}")


if __name__ == "__main__":
    main()
