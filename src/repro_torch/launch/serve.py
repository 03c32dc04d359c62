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
through the int8 matmul kernel.  Not ported: ``--replicas`` and
``--serve-layout`` (ROADMAP A12).
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
    from repro_torch.core.lite import LiteSpec
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.data.episodic import plan_buckets
    from repro_torch.models.conv_backbone import (ConvBackboneConfig,
                                                  make_conv_backbone)
    from repro_torch.serve.episodic import EpisodicServeEngine, resolve_device

    device = resolve_device(args.device)
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
    engine = EpisodicServeEngine(
        learner, params, lite=lite, n_slots=args.slots,
        query_chunk=args.query_chunk, support_buckets=buckets,
        kernel_backend=args.kernel_backend,
        cache_capacity=args.cache_capacity, warm_dir=args.warm_dir,
        warm_shards=args.warm_shards or 1, query_slo_us=args.query_slo_us,
        adapt_cost_hint_us=args.adapt_cost_hint_us, max_queue=args.max_queue,
        deadline_us=args.deadline_us, serve_quant=args.serve_quant,
        device=device)
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
    print(f"episodic serve: learner={args.learner} {len(reqs)} requests "
          f"({len(cold)} distinct users) in {dt:.2f}s on {args.slots} slots, "
          f"device={device} backend={engine.kernel_backend}")
    print(f"  tasks adapted {s['tasks_adapted']} ({s['tasks_adapted']/dt:.1f}/s), "
          f"queries {s['queries_served']} ({s['queries_served']/dt:.1f}/s), "
          f"cache hit-rate {s['hit_rate']:.2f}, "
          f"compiles adapt={s['adapt_compiles']} "
          f"predict={s['predict_compiles']}")
    print(f"  latency: adapt p50/p99 {s['adapt_p50_us']:.0f}/"
          f"{s['adapt_p99_us']:.0f} us, query (first logit) p50/p99 "
          f"{s['query_p50_us']:.0f}/{s['query_p99_us']:.0f} us; "
          f"store: evictions={s['evictions']} spills={s['spills']} "
          f"rehydrates={s['rehydrates']} (mean spill "
          f"{s['spill_mean_us']:.0f} us, rehydrate "
          f"{s['rehydrate_mean_us']:.0f} us), "
          f"slo_preemptions={s['slo_preemptions']}")
    print(f"  degradation: quarantined={s['quarantined']} "
          f"spill_errors={s['spill_errors']} "
          f"rejections={s['rejections']} "
          f"deadline_abandoned={s['deadline_abandoned']} "
          f"failed_requests={s['failed_requests']}")
    print(f"  weights: quant={args.serve_quant} resident "
          f"{s['param_bytes_resident']} B (fp32 {s['param_bytes_fp32']} B; "
          f"frozen slice {s['frozen_param_bytes_resident']} / "
          f"{s['frozen_param_bytes_fp32']} B)")
    for r in reqs[:4]:
        print(f"  req uid={r.uid}: cache_hit={r.cache_hit} "
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
                         "none, the files at its root)")
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
