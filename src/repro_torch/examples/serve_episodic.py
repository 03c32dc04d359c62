"""Episodic serving example, the port of the JAX package's
``examples/serve_episodic.py``: adapt-many-tasks personalization.

Each request is one user's episode: a support set (their labelled
examples) and a query stream (what they want classified).  The engine
adapts newly seen tasks in one batched, LITE-chunked, forward-only
dispatch, keeps the adapted state by user id (a repeat visitor skips
adaptation), and answers the queries of every live task in one dispatch a
step.

    python -m repro_torch.examples.serve_episodic --learner protonets

``--replicas R`` serves the same traffic through the replica router
(:class:`repro_torch.serve.replica.ReplicatedServeEngine`): R engines, each
with its own copy of the weights and its own L1 state cache, requests
routed by a stable uid hash.  Here the replicas share ``--device``; one
process a rank, each replica a group of ranks with a serving layout, is
the serving launcher under ``torchrun``
(``python -m repro_torch.launch.serve --episodic --replicas R``).

    python -m repro_torch.examples.serve_episodic --replicas 2

It runs on ``--device`` (default ``cuda``, the episodic kernels on every
adaptation and query dispatch; it raises without a card unless ``--device
cpu`` is given).  Tasks come from the numpy host sampler, so they differ
from the JAX example's ``jax.random`` draws.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.serve.episodic import (EpisodicRequest, EpisodicServeEngine,
                                        resolve_device)


def main(argv: Optional[Sequence[str]] = None, clock=time.perf_counter) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--learner", default="protonets",
                    choices=["protonets", "cnaps", "simple_cnaps", "fomaml",
                             "finetuner"])
    ap.add_argument("--users", type=int, default=6)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--shot", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through the replica-aware router: uid-hash "
                         "routing over N engines, each with its own weight "
                         "copy and L1 cache (default: 1, a single engine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs without a GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    backbone = make_conv_backbone(ConvBackboneConfig(widths=(8, 16), feature_dim=32))
    learner = make_learner(
        MetaLearnerConfig(kind=args.learner, way=5), backbone,
        SetEncoderConfig(kind="conv", conv_blocks=1, conv_width=8, task_dim=16))
    params = learner.init(torch.Generator().manual_seed(0), device)

    # traffic: a cold wave (every user's first visit, support attached),
    # then a warm wave revisiting users round-robin without their support
    # sets: the engine serves them from the task-state cache
    cfg = HostEpisodicConfig(way=5, shot=args.shot, query_per_class=3, image_size=16)
    tasks = host_task_batch_at(0, cfg, args.users, 0)
    cold = [EpisodicRequest(uid=u, support_x=tasks.support_x[u],
                            support_y=tasks.support_y[u], query_x=tasks.query_x[u])
            for u in range(args.users)]
    warm = [EpisodicRequest(uid=i % args.users, query_x=tasks.query_x[i % args.users])
            for i in range(max(args.requests - args.users, 0))]

    engine_kw = dict(lite=LiteSpec(exact=True, chunk_size=16),   # O(chunk) adapt memory
                     n_slots=4, query_chunk=8, support_buckets=(64,),
                     cache_capacity=args.users, device=device)
    if args.replicas > 1:
        from repro_torch.serve.replica import ReplicatedServeEngine
        engine = ReplicatedServeEngine(learner, params, replicas=args.replicas, **engine_kw)
    else:
        engine = EpisodicServeEngine(learner, params, **engine_kw)
    t0 = clock()
    engine.run_to_completion(cold)
    engine.run_to_completion(warm)
    dt = clock() - t0

    reqs = cold + warm
    if not all(r.done for r in reqs):
        raise RuntimeError("the engine left requests unserved")
    s = engine.stats()
    print(f"{args.learner}: served {len(reqs)} requests ({s['queries_served']} queries) "
          f"in {dt:.2f}s on device={device}")
    print(f"  adapted {s['tasks_adapted']} tasks, cache hit-rate {s['hit_rate']:.2f}, "
          f"compiles adapt={s['adapt_compiles']} predict={s['predict_compiles']}")
    print(f"  adapt latency p50/p99 {s['adapt_p50_us']:.0f}/{s['adapt_p99_us']:.0f} us, "
          f"first-logit p50/p99 {s['query_p50_us']:.0f}/{s['query_p99_us']:.0f} us "
          f"(set warm_dir= to spill evicted states to disk instead of re-adapting)")
    if args.replicas > 1:
        for i, p in enumerate(s["per_replica"]):
            print(f"  replica {i}: adapted={p['tasks_adapted']:.0f} "
                  f"queries={p['queries_served']:.0f} hit_rate={p['hit_rate']:.2f}")
    for r in reqs[: args.users + 2]:
        print(f"  uid={r.uid} cache_hit={r.cache_hit} preds={r.predictions().tolist()}")
    return s


if __name__ == "__main__":
    main()
