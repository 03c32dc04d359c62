"""Serving launcher for the PyTorch port: LM token decode (the default)
and episodic personalization (``--episodic``).

LM token decode, continuous batching over the KV-cache API
(:class:`repro_torch.serve.engine.ServeEngine`), on the smoke config of
``--arch`` (a transformer: dense GQA, or MoE / MLA as kimi-k2-1t-a32b and
deepseek-v2-236b; mamba2-780m; the zamba2-7b hybrid; the whisper-base
encoder-decoder, prefilled on zero frames as the JAX engine does) with
random weights from ``--seed``:

    python -m repro_torch.launch.serve --arch minitron-4b --requests 8 \
        --slots 4 --max-new 16

Prompts are ``--prompt-len`` tokens drawn from numpy's generator seeded
with 0, as the JAX launcher draws them.  On a card every GQA prefill layer
(zamba2's shared block and whisper's encoder, bidirectional, too) runs
the flash attention kernel, every MoE expert projection, in prefill and
decode, the gmm kernel, and every SSD chunk of a mamba2 or zamba2 prefill
the ssd_chunk kernel (``--kernel-backend auto``).

Episodic serving:

    python -m repro_torch.launch.serve --episodic --learner simple_cnaps \
        --serve-quant int8 --requests 8 --slots 4 --cache-capacity 2 \
        --warm-dir /tmp/warm_states --query-slo-us 50000

Each request is a support set to adapt on and a query stream to answer;
``--repeat-frac`` of the requests revisit earlier users (store hits).  The
task-state store is an L1 LRU of ``--cache-capacity`` states over an
optional ``--warm-dir`` disk tier: evicted states spill there and repeat
users rehydrate bit-exactly instead of re-adapting.  ``--query-slo-us``
lets near-deadline query chunks preempt an adapt wave (costed from
``--adapt-cost-hint-us`` until measured), ``--max-queue`` bounds the
admission queue and ``--deadline-us`` abandons requests still without
logits past it.  The model is the JAX launcher's smoke size (conv backbone
widths (16, 32), feature_dim 64; conv set encoder 2 blocks of width 16,
task_dim 32) with random weights from ``--seed``.  Traffic comes from the
numpy host sampler ``repro_torch.data.episodic.host_task_batch_at``, so it
differs from the JAX launcher's (which samples with ``jax.random``).  Runs
on ``--device`` (default ``cuda``; pass ``--device cpu`` to run without a
GPU).  ``--learner`` takes every kind: fomaml serves in fp32 (it freezes no
weights), finetuner with ``--serve-quant int8`` runs its frozen head
through the int8 matmul kernel.

``--replicas R`` serves through the replica router
(:class:`repro_torch.serve.replica.ReplicatedServeEngine`): uid-hash
routing over R engines, each with its own L1 and a copy of the weights,
the warm directory in ``--warm-shards`` uid-hash subdirs.  In one process
the replicas share ``--device``.  Under ``torchrun`` each of the W ranks is
one process, the replicas groups of d = W / R ranks
(:func:`repro_torch.launch.mesh.make_replica_mesh`), and
``--serve-layout`` places the weights on each group: ``weight_stationary``
keeps a K-slice of every 2-D product weight on each rank and sums the
partial products, ``training`` gathers every split leaf before a dispatch,
``replicated`` moves nothing, ``auto`` scores the three on one group's
predict dispatch over a probe batch
(:func:`repro_torch.roofline.analysis.choose_replica_serving_layout`) and
resolves to ``none`` on a group of one rank.  ``--dist-backend`` picks NCCL
(the default on ``cuda``, one rank a card) or gloo (ranks may share a
card).  Every rank serves the same request stream; rank 0 prints::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --episodic --replicas 2 \
        --serve-layout auto --serve-quant int8 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch


def build_requests(n_requests: int, repeat_frac: float, shot: int,
                   query_per_class: int, image_size: int, seed: int):
    """``n_users`` cold requests (one task each, from one host batch), then
    repeat requests drawn over those users; returns (cold, warm)."""
    from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
    from repro_torch.serve.episodic import EpisodicRequest

    n_users = min(n_requests, max(1, round(n_requests * (1.0 - repeat_frac))))
    cfg = HostEpisodicConfig(way=5, shot=shot, query_per_class=query_per_class,
                             image_size=image_size)
    batch = host_task_batch_at(seed, cfg, n_users, 0)

    def request_for(uid):
        return EpisodicRequest(uid=uid, support_x=batch.support_x[uid],
                               support_y=batch.support_y[uid],
                               query_x=batch.query_x[uid], way=cfg.way)

    rng = np.random.default_rng(seed)
    cold = [request_for(u) for u in range(n_users)]
    warm = [request_for(int(rng.integers(0, n_users)))
            for _ in range(n_requests - n_users)]
    return cold, warm


def run_episodic(args, clock: Callable[[], float] = time.monotonic) -> dict:
    """Episodic serving; under torchrun (a world of several ranks) on a
    replica mesh of the world, torn down at the end."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_distributed, make_replica_mesh,
                                         world_size)
    from repro_torch.serve.episodic import resolve_device

    if args.replicas < 1:
        raise ValueError(f"--replicas must be >= 1, got {args.replicas}")
    world = world_size()
    if world == 1:
        return _run_episodic(args, clock, None, resolve_device(args.device))
    if world % args.replicas:
        raise ValueError(f"--replicas {args.replicas} does not divide the world of "
                         f"{world} ranks: start a multiple of it (--nproc-per-node)")
    device = init_distributed(args.device, backend=args.dist_backend)
    try:
        mesh = make_replica_mesh(args.replicas, world // args.replicas)
        return _run_episodic(args, clock, mesh, device)
    finally:
        dist.destroy_process_group()


def _probe_layout(args, learner, params, lite, buckets, mesh, device, backend):
    """``--serve-layout auto`` on a group of several ranks: the layouts
    scored on one group's predict dispatch over two probe tasks."""
    from repro_torch.core.episodic import Task
    from repro_torch.data.episodic import (HostEpisodicConfig, collate_task_batch,
                                           host_task_batch_at)
    from repro_torch.kernels import dispatch
    from repro_torch.roofline.analysis import choose_replica_serving_layout
    from repro_torch.serve.quant_params import quantize_frozen, serving_params

    sw = quantize_frozen(learner, params, args.serve_quant)
    cfg = HostEpisodicConfig(way=5, shot=args.shot, query_per_class=4,
                             image_size=args.image_size)
    b = host_task_batch_at(args.seed + 1, cfg, 2, 0)
    tasks = [Task(support_x=b.support_x[i], support_y=b.support_y[i],
                  query_x=b.query_x[i], query_y=b.query_y[i], way=5) for i in range(2)]
    batch = collate_task_batch(tasks, support_size=max(buckets),
                               query_size=b.query_x.shape[1]).to(device)
    with dispatch.use_backend(backend):
        states = learner.adapt_batch(serving_params(sw), batch, lite)

    def predict(w, st, qx):
        with dispatch.use_backend(backend):
            return learner.predict_batch(serving_params(w), st, qx)

    return choose_replica_serving_layout(predict, sw, (states, batch.query_x), mesh)


def _run_episodic(args, clock, mesh, device) -> dict:
    from repro_torch.core.lite import LiteSpec
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.data.episodic import plan_buckets
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import serve_axis
    from repro_torch.models.conv_backbone import (ConvBackboneConfig,
                                                  make_conv_backbone)
    from repro_torch.serve.episodic import EpisodicServeEngine
    from repro_torch.serve.replica import ReplicatedServeEngine

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    backbone = make_conv_backbone(ConvBackboneConfig(widths=(16, 32),
                                                     feature_dim=64))
    learner = make_learner(
        MetaLearnerConfig(kind=args.learner, way=5), backbone,
        SetEncoderConfig(kind="conv", conv_blocks=2, conv_width=16, task_dim=32))
    params = learner.init(torch.Generator().manual_seed(args.seed), device)
    lite = LiteSpec(exact=True, chunk_size=args.lite_chunk,
                    compute_dtype=args.lite_dtype)
    cold, warm = build_requests(args.requests, args.repeat_frac, args.shot, 4,
                                args.image_size, args.seed)
    reqs = cold + warm
    buckets = plan_buckets([r.support_x.shape[0] for r in reqs], max_buckets=2)
    # the layout: a named one is placed as it is; auto scores the three on
    # one group of several ranks and is nothing to place on a group of one
    group = mesh.shape[serve_axis(mesh)] if mesh is not None else 1
    serve_layout, layout_rows = args.serve_layout, None
    if serve_layout == "auto" and group > 1:
        pick = _probe_layout(args, learner, params, lite, buckets, mesh, device,
                             dispatch.resolve_backend(args.kernel_backend, device))
        serve_layout, layout_rows = pick["choice"], pick["rows"]
    elif serve_layout == "auto":
        serve_layout = "none"
    engine_kw = dict(
        lite=lite, n_slots=args.slots, query_chunk=args.query_chunk,
        support_buckets=buckets, kernel_backend=args.kernel_backend,
        cache_capacity=args.cache_capacity, warm_dir=args.warm_dir,
        query_slo_us=args.query_slo_us, adapt_cost_hint_us=args.adapt_cost_hint_us,
        max_queue=args.max_queue, deadline_us=args.deadline_us,
        serve_quant=args.serve_quant, device=device,
        serve_layout=None if serve_layout == "none" else serve_layout)
    if args.replicas > 1:
        engine = ReplicatedServeEngine(learner, params, replicas=args.replicas,
                                       mesh=mesh, warm_shards=args.warm_shards, **engine_kw)
    else:
        engine = EpisodicServeEngine(learner, params, mesh=mesh,
                                     warm_shards=args.warm_shards or 1, **engine_kw)
    # cold wave first, so every repeat finds its user's state cached
    t0 = clock()
    engine.run_to_completion(cold)
    engine.run_to_completion(warm)
    dt = max(clock() - t0, 1e-9)
    s = engine.stats()
    # every request ends served or as a counted degradation (rejected,
    # abandoned past its deadline, failed on a quarantined state)
    if not all(r.done or r.rejected for r in reqs):
        raise RuntimeError("engine finished with requests in no terminal state")
    backend = dispatch.resolve_backend(args.kernel_backend, device)
    world = 1 if mesh is None else mesh.size
    say(f"episodic serve: learner={args.learner} {len(reqs)} requests "
        f"({len(cold)} distinct users) in {dt:.2f}s on {args.slots} slots, "
        f"device={device} backend={backend} world={world}")
    say(f"  tasks adapted {s['tasks_adapted']} ({s['tasks_adapted']/dt:.1f}/s), "
          f"queries {s['queries_served']} ({s['queries_served']/dt:.1f}/s), "
          f"cache hit-rate {s['hit_rate']:.2f}, "
          f"compiles adapt={s['adapt_compiles']} "
          f"predict={s['predict_compiles']}")
    say(f"  latency: adapt p50/p99 {s['adapt_p50_us']:.0f}/"
          f"{s['adapt_p99_us']:.0f} us, query (first logit) p50/p99 "
          f"{s['query_p50_us']:.0f}/{s['query_p99_us']:.0f} us; "
          f"store: evictions={s['evictions']} spills={s['spills']} "
          f"rehydrates={s['rehydrates']} (mean spill "
          f"{s['spill_mean_us']:.0f} us, rehydrate "
          f"{s['rehydrate_mean_us']:.0f} us), "
          f"slo_preemptions={s['slo_preemptions']}")
    say(f"  degradation: quarantined={s['quarantined']} "
          f"spill_errors={s['spill_errors']} "
          f"rejections={s['rejections']} "
          f"deadline_abandoned={s['deadline_abandoned']} "
          f"failed_requests={s['failed_requests']}")
    say(f"  weights: quant={args.serve_quant} layout={serve_layout} resident "
        f"{s['param_bytes_resident']} B (fp32 {s['param_bytes_fp32']} B; "
        f"frozen slice {s['frozen_param_bytes_resident']} / "
        f"{s['frozen_param_bytes_fp32']} B)")
    if layout_rows is not None:
        for lo, r in layout_rows.items():
            say(f"    layout {lo:18s} wire={r['wire_bytes']:12.0f} B "
                f"bottleneck={r['bottleneck']}")
    if args.replicas > 1:
        say(f"  replicas: {s['live_replicas']}/{s['n_replicas']} live, "
            f"failovers={s['replica_failovers']} rerouted={s['rerouted_requests']}")
        for i, p in enumerate(s["per_replica"]):
            say(f"    replica {i}: adapted={p['tasks_adapted']:.0f} "
                f"queries={p['queries_served']:.0f} hit_rate={p['hit_rate']:.2f} "
                f"compiles adapt={p['adapt_compiles']:.0f} "
                f"predict={p['predict_compiles']:.0f}")
    for r in reqs[:4]:
        say(f"  req uid={r.uid}: cache_hit={r.cache_hit} "
            f"preds={r.predictions()[:8].tolist()}")
    return s


def run_lm(args, clock: Callable[[], float] = time.monotonic) -> dict:
    """The JAX launcher's LM path: ``--requests`` prompts through the
    continuous-batching engine on the smoke config of ``--arch``."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.episodic import resolve_device

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    api = get_api(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed), cfg)
    engine = ServeEngine(cfg, params, n_slots=args.slots,
                         max_seq=args.prompt_len + args.max_new + 8,
                         kernel_backend=args.kernel_backend)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new, temperature=args.temperature)
            for i in range(args.requests)]
    t0 = clock()
    engine.run_to_completion(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = max(clock() - t0, 1e-9)
    n_tok = sum(len(r.out_tokens) for r in reqs)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.name} ({cfg.family} cache): {len(reqs)} requests, "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s on device={device} "
          f"({name}), backend={args.kernel_backend})")
    for r in reqs[:4]:
        print(f"  req {r.uid}: {r.prompt.tolist()} -> {r.out_tokens}")
    if not all(r.done for r in reqs):
        raise RuntimeError("engine finished with requests unserved")
    return dict(requests=len(reqs), tokens=n_tok, seconds=dt)


def main(argv: Optional[List[str]] = None,
         clock: Callable[[], float] = time.monotonic) -> dict:
    from repro_torch.configs.registry import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="minitron-4b",
                    help="LM decode: the architecture whose smoke config serves")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--episodic", action="store_true",
                    help="adapt-many-tasks personalization serving (default: "
                         "LM token decode)")
    ap.add_argument("--learner", default="protonets",
                    choices=["protonets", "cnaps", "simple_cnaps", "fomaml",
                             "finetuner"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--shot", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=24)
    ap.add_argument("--query-chunk", type=int, default=8)
    ap.add_argument("--repeat-frac", type=float, default=0.5,
                    help="fraction of requests from repeat users (cache hits)")
    ap.add_argument("--lite-chunk", type=int, default=32,
                    help="serve-time adaptation chunk size")
    ap.add_argument("--lite-dtype", choices=["bfloat16", "float16"],
                    default=None, help="serve-time adaptation compute dtype")
    ap.add_argument("--cache-capacity", type=int, default=64,
                    help="L1 task-state LRU capacity (resident adapted "
                         "states); evictions spill to --warm-dir when set")
    ap.add_argument("--warm-dir", default=None,
                    help="disk warm tier for evicted task states, rehydrated "
                         "bit-exactly on a repeat uid instead of re-adapting "
                         "(default: off, evictions discard)")
    ap.add_argument("--warm-shards", type=int, default=None,
                    help="uid-hash shard subdirs under --warm-dir (default: "
                         "8 with --replicas > 1, else none, the files at its "
                         "root; keep it fixed across deployments of the same "
                         "warm root: resizing --replicas re-routes uids but "
                         "never moves their warm files)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas (repro_torch.serve.replica): each "
                         "replica owns a full copy of the serving weights on "
                         "its own group of ranks (world / replicas under "
                         "torchrun, make_replica_mesh) and its own L1 state "
                         "cache; requests route by stable uid hash, the "
                         "shared --warm-dir is partitioned into uid-hash "
                         "shard subdirs, and no dispatch's collective ever "
                         "crosses a group (default: 1, a single engine)")
    ap.add_argument("--serve-layout",
                    choices=["auto", "none", "training", "weight_stationary",
                             "replicated"],
                    default="none",
                    help="serving weight placement on a replica's group of "
                         "ranks: auto = run the predict dispatch under every "
                         "candidate on one group and pick the least largest "
                         "roofline term (repro_torch.roofline.analysis."
                         "choose_serving_layout), weight_stationary = keep a "
                         "K-slice of each matmul weight on each rank (small-"
                         "batch serving moves partial products, not gathered "
                         "weights), training = the weight-gathered train "
                         "placement, replicated = every rank holds all "
                         "weights (default: none, nothing placed)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend under torchrun: nccl "
                         "(default on cuda, one rank a card) or gloo (default "
                         "on cpu; on cuda ranks may share a card).  The JAX "
                         "launcher has no such flag: JAX has no backend to "
                         "choose")
    ap.add_argument("--query-slo-us", type=float, default=None,
                    help="per-request first-logit SLO in microseconds: a "
                         "pending adapt wave is deferred when it would push "
                         "a live lane's queries past this deadline")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue: a submit over the bound "
                         "is rejected with a retry-after estimate (EWMA adapt "
                         "cost) (default: unbounded)")
    ap.add_argument("--deadline-us", type=float, default=None,
                    help="per-request deadline from enqueue: a request still "
                         "without logits past it is abandoned and its lane or "
                         "queue place freed (default: off)")
    ap.add_argument("--adapt-cost-hint-us", type=float, default=None,
                    help="seed of the EWMA adapt-dispatch cost the SLO "
                         "scheduler plans with (measured thereafter)")
    ap.add_argument("--serve-quant", choices=["none", "int8"], default="none",
                    help="store the learner's frozen backbone in blockwise "
                         "int8; the head runs through the int8_matmul kernel")
    ap.add_argument("--kernel-backend", choices=["auto", "cuda", "ref", "naive"],
                    default="auto",
                    help="kernel backend (the episodic aggregation kernels; "
                         "the LM prefill's flash attention, gmm and ssd_chunk): auto = the CUDA "
                         "kernels on a GPU, ref on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs without a GPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.episodic:
        return run_lm(args, clock=clock)
    return run_episodic(args, clock=clock)


if __name__ == "__main__":
    main()
