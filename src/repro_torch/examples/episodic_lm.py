"""The paper's technique wrapped around an LM architecture: episodic
meta-training (ProtoNets or Simple CNAPs + LITE) where the support and
query examples are token sequences and FiLM modulates the residual stream
after every layer.  The port of the JAX package's
``examples/episodic_lm.py``, flag for flag:

    python -m repro_torch.examples.episodic_lm --arch minitron-4b [--device cpu]

It runs the arch's smoke config on ``--device`` (default ``cuda``: the
hand-written kernels, flash attention or, for mamba2-780m, ssd_chunk
inside its autograd Function; it raises without a card unless
``--device cpu`` is given).  Each step takes
one token task (4-way, 8 shot, 6 queries a class, 48 tokens), the
meta-loss gradient over the leaves the loss reaches, a global-norm clip at
10 and plain SGD at 1e-3; then the held-out accuracy over 10 tasks through
``adapt_batch`` and ``predict_batch``.  ``chip_smoke.py`` (phase 5c) runs
:func:`make_meta_step` and :func:`heldout_accuracy` at minitron-4b's full
width.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.common.tree import tree_leaves, tree_rebuild
from repro_torch.core.episodic import TaskBatch
from repro_torch.core.episodic_train import make_reached_meta_grads
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearner
from repro_torch.optim.clip import clip_by_global_norm

Tree = Any
ARCHS = ("minitron-4b", "qwen2-72b", "gemma2-2b", "mamba2-780m")
LR = 1e-3
MAX_GRAD_NORM = 10.0


def make_meta_step(learner: MetaLearner, lite: LiteSpec) -> Callable:
    """The example's step: ``step(params, batch, scores) -> (params, loss,
    accuracy)``.  The gradient of the leaves the loss reaches
    (:func:`~repro_torch.core.episodic_train.make_reached_meta_grads`),
    clipped to global norm MAX_GRAD_NORM, then ``p - LR * g``; a leaf
    the loss does not reach (the CNAPs family's frozen backbone) gets no
    gradient buffer and is returned as it is, which is exactly the JAX
    example's ``p - lr * 0`` (a zero gradient adds nothing to the norm).
    At minitron-4b's width that zero gradient would be 20.4 GB of fp32."""
    grads_fn = make_reached_meta_grads(learner, lite)

    def step(params: Tree, batch: TaskBatch, scores: torch.Tensor):
        loss, acc, grads = grads_fn(params, batch, scores)
        reached = [g for g in grads if g is not None]
        clipped = iter(clip_by_global_norm(reached, MAX_GRAD_NORM)[0])
        new = [p if g is None else (p - LR * next(clipped)).detach()
               for p, g in zip(tree_leaves(params), grads)]
        return tree_rebuild(params, new), loss, acc

    return step


def heldout_accuracy(learner: MetaLearner, params: Tree, batch: TaskBatch):
    """Adapt to each task of ``batch`` (exact, forward only) and classify
    its queries: (logits (T, M, way), mean accuracy)."""
    states = learner.adapt_batch(params, batch)
    logits = learner.predict_batch(params, states, batch.query_x)
    acc = (logits.argmax(dim=-1) == batch.query_y).float().mean()
    return logits, acc


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.lite import index_scores
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.data.episodic import EpisodicTokenConfig, token_task_batch_at
    from repro_torch.models.lm_backbone import make_lm_backbone
    from repro_torch.serve.episodic import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="minitron-4b")
    ap.add_argument("--kind", choices=["protonets", "simple_cnaps"],
                    default="simple_cnaps")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--h", type=int, default=8, help="|H| back-propagated")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    backbone = make_lm_backbone(cfg)
    task_cfg = EpisodicTokenConfig(way=4, shot=8, query_per_class=6, seq_len=48,
                                   vocab=cfg.vocab)
    learner = make_learner(MetaLearnerConfig(kind=args.kind, way=4), backbone,
                           SetEncoderConfig(kind="tokens", in_channels=cfg.vocab,
                                            task_dim=32))
    params = learner.init(torch.Generator(device=device).manual_seed(0), device)
    step = make_meta_step(learner, LiteSpec(h=args.h, chunk_size=8))
    n_support = task_cfg.way * task_cfg.shot
    print(f"episodic {args.kind}+LITE over {cfg.name}: N={n_support} support "
          f"sequences, |H|={args.h} back-propagated, device={device.type}", flush=True)

    for s in range(args.steps):
        batch = token_task_batch_at(1, task_cfg, 1, s, device)
        scores = index_scores(1, s, [0], n_support, device)
        params, loss, acc = step(params, batch, scores)
        if s % 10 == 0:
            print(f"step {s:3d}  loss {float(loss):8.4f}  acc {float(acc):.2f}",
                  flush=True)

    _, acc = heldout_accuracy(learner, params, token_task_batch_at(5, task_cfg, 10, 0,
                                                                   device))
    print(f"held-out episodic accuracy over {cfg.name}: {float(acc):.3f}", flush=True)


if __name__ == "__main__":
    main()
