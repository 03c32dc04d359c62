"""Quickstart: meta-train Simple CNAPs with LITE on synthetic episodic
image tasks, then adapt to a new task at test time with ONE forward pass.
The port of the JAX package's ``examples/quickstart.py``, step for step.

    python -m repro_torch.examples.quickstart [--device cpu] [--steps 60]

It runs on ``--device`` (default ``cuda``: the episodic kernels, the
Mahalanobis head among them; it raises without a card unless ``--device
cpu`` is given, which runs their plain versions).  The draws come from
``torch.Generator`` seeds where the JAX example splits ``jax.random``
keys, so the numbers differ from its run.  ``--steps`` scales the run for
a quick check: that many meta-training steps (60 by default, as the
reference), and a third as many task-batched steps (20).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.episodic_train import make_batched_meta_train_step
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.episodic import (EpisodicImageConfig, sample_image_task_batch,
                                       step_generator, task_batch_at)
from repro_torch.examples.episodic_lm import make_meta_step
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.episodic import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60,
                    help="meta-training steps (the task-batched phase runs a third as many)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. backbone + meta-learner (the paper's headline instantiation)
    backbone = make_conv_backbone(ConvBackboneConfig(widths=(16, 32), feature_dim=64))
    learner = make_learner(
        MetaLearnerConfig(kind="simple_cnaps", way=5),
        backbone,
        SetEncoderConfig(kind="conv", conv_blocks=2, conv_width=16, task_dim=32),
    )
    params = learner.init(torch.Generator(device=device).manual_seed(0), device)

    # 2. LITE: forward the WHOLE support set, back-prop only |H|=8 of 50
    lite = LiteSpec(h=8, chunk_size=16)
    task_cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=24)
    n_support = task_cfg.way * task_cfg.shot
    # the meta-loss gradient, clipped to global norm 10, then SGD at 1e-3
    meta_step = make_meta_step(learner, lite)
    losses, accs = [], []
    for step in range(args.steps):
        gen = step_generator(1, step, device)
        task = sample_image_task_batch(gen, task_cfg, 1)
        scores = torch.rand((1, n_support), generator=gen, device=device)
        params, loss, acc = meta_step(params, task, scores)
        losses.append(float(loss))
        accs.append(float(acc))
        if step % 10 == 0:
            print(f"step {step:3d}  meta-loss {losses[-1]:7.3f}  query-acc {accs[-1]:.2f}",
                  flush=True)

    # 3. meta-test: ONE forward pass of the support set adapts the model
    held = []
    for i in range(10):
        t = sample_image_task_batch(step_generator(2, i, device), task_cfg, 1)
        state = learner.adapt_batch(params, t)                      # 1F
        pred = learner.predict_batch(params, state, t.query_x).argmax(dim=-1)
        held.append(float((pred == t.query_y).float().mean()))
    heldout = sum(held) / len(held)
    print(f"\nheld-out task accuracy: {heldout:.3f} (adaptation = single forward pass)",
          flush=True)

    # 4. scale it: the TASK-BATCHED engine, many tasks per optimizer step
    # (the task axis batched, per-task H draws, one AdamW update; pass
    # mesh=make_dp_mesh(n) to shard the task axis across ranks)
    adamw = AdamWConfig(weight_decay=0.0)
    opt_state = adamw_init(params, adamw)
    batched_step = make_batched_meta_train_step(learner, lite, adamw=adamw, lr=1e-3)
    batched = []
    for step in range(max(1, args.steps // 3)):
        batch = task_batch_at(3, task_cfg, 8, step, device)        # 8 tasks/step
        scores = torch.rand((8, n_support), generator=step_generator(4, step, device),
                            device=device)
        params, opt_state, metrics = batched_step(params, opt_state, batch, scores)
        batched.append((float(metrics["loss"]), float(metrics["accuracy"])))
        if step % 5 == 0:
            print(f"batched step {step:3d}  loss {batched[-1][0]:7.3f}  "
                  f"acc {batched[-1][1]:.2f}", flush=True)
    return dict(losses=losses, accuracies=accs, heldout=held, batched=batched)


if __name__ == "__main__":
    main()
