"""Training launcher for the PyTorch port (the JAX package's
``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gemma2-2b --steps 200 \\
        --batch 8 --seq 128 --ckpt-dir /tmp/ck

LM training (the default): the arch's smoke config (``--full`` prints the
JAX launcher's warning and runs the smoke config too, since the
production mesh is multi-GPU work, ROADMAP A12 part 2) with random weights from
seed 0, AdamW in the config's state dtype, a cosine schedule (or
``--schedule wsd``) from ``--peak-lr``, batches from
:class:`repro_torch.data.tokens.TokenPipeline` (seed 0), through the
fault-tolerant loop with checkpoints and resume.  The step updates the
state in place (:func:`repro_torch.train.step.make_train_step`).
``--arch whisper-base`` is refused before any state is built: whisper's
loss reads frame embeddings, which the token pipeline does not yield, and
the JAX launcher has no whisper path either (ROADMAP R6).

    python -m repro_torch.launch.train --episodic --steps 100 \\
        --tasks-per-step 8 --learner simple_cnaps --schedule cosine

``--episodic``: task-batched LITE meta-training (:mod:`repro_torch.core.episodic_train`)
through the fault-tolerant loop (:mod:`repro_torch.train.loop`) with
checkpoints and resume, at the JAX launcher's episodic smoke size (conv
backbone widths (16, 32), feature_dim 64; conv set encoder 2 blocks of
width 16, task_dim 32; way 5, shot 10, 6 queries a class) with random
weights from seed 0.  Tasks come, as in the JAX launcher, from
``--data-source device`` (the default: the on-device sampler
``task_batch_at``, drawn on ``--device`` from a generator seeded by
(17, step)) or ``--data-source host`` (the numpy host sampler
``host_task_batch_at``, bit-identical with the JAX package's), and each
task's H subset from a counter-based hash of (23, step, task, example).
Both run on ``--device`` (default ``cuda``; it raises without a card
unless ``--device cpu`` is given) with ``--kernel-backend auto``, the
hand-written kernels on the card (flash attention on every GQA layer of
the LM and on zamba2's shared block, the gmm kernel on every MoE layer's
experts, the ssd_chunk kernel on every SSD chunk of mamba2 and zamba2,
forward and backward).  A preempted run exits 75 after flushing a checkpoint.

Data-parallel meta-training runs one process a rank under ``torchrun``:

    python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.train \\
        --episodic --tasks-per-step 32 --dp-shards 8
    torchrun --nnodes 2 --nproc-per-node 8 ... -m repro_torch.launch.train \\
        --episodic --tasks-per-step 32 --dp-shards 8 --dcn-shards 2 --grad-reduce compressed

``--dp-shards`` x ``--dcn-shards`` must equal the world size.  The task axis
is sharded over a 1-D ``data`` mesh, or over ``(dcn, data)`` where
``--dcn-shards`` > 1 or the reduction is compressed
(:mod:`repro_torch.launch.mesh`); ``--dist-backend`` picks NCCL (the default
on ``cuda``, one rank a card) or gloo (the default on ``cpu``; on ``cuda``
several ranks may share a card).  Rank 0 prints and writes the checkpoints;
every rank reads them, and a compressed run's directory ends in
``_ef<dcn>``.  The LM path (no ``--episodic``) stays on one card.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

# EX_TEMPFAIL: a preempted run flushed a checkpoint; rerunning the same
# command resumes exactly
EXIT_PREEMPTED = 75


def _fault_summary(result) -> str:
    return (f"nonfinite_skips={len(result.nonfinite_steps)} "
            f"rollbacks={result.rollbacks} "
            f"data_retries={result.data_retries} "
            f"stragglers={result.straggler_steps}")


def _finish_preempted(e) -> None:
    print(f"preempted: {e} — rerun to resume", flush=True)
    sys.exit(EXIT_PREEMPTED)


def run_lm(args) -> None:
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.tokens import (TokenPipeline, TokenPipelineConfig, batch_to_device,
                                         require_tokens_only)
    from repro_torch.faults import PreemptionSignal
    from repro_torch.kernels import dispatch
    from repro_torch.optim.schedules import schedule_for
    from repro_torch.serve.episodic import resolve_device
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import PreemptedError, train
    from repro_torch.train.step import adamw_for, make_init_state, make_train_step

    cfg = get_smoke_config(args.arch)
    require_tokens_only(cfg)
    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.full:
        print(f"[warn] --full needs >=256 devices (have {n_dev}); running the smoke "
              f"config on one device", flush=True)
    print(f"arch={cfg.name} devices={n_dev} device={device}", flush=True)

    init = make_init_state(cfg, adamw_for(cfg))
    sched = schedule_for(args.schedule or "cosine", args.peak_lr,
                         max(args.steps // 50, 1), args.steps)
    step = make_train_step(cfg, adamw_for(cfg), schedule=sched)
    state = init(torch.Generator(device=device).manual_seed(0), device)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                             global_batch=args.batch))

    def batch_at(s):
        return batch_to_device(pipe.batch_at(s), device)

    ckpt = CheckpointManager(args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_train_ckpt_{cfg.name}"), keep=3)
    preempt = PreemptionSignal().install()
    try:
        with dispatch.use_backend(args.kernel_backend):
            result = train(state, step, batch_at, args.steps, ckpt=ckpt,
                           ckpt_every=args.ckpt_every, state_template=state,
                           log_every=25, preempt=preempt,
                           max_nonfinite=args.max_nonfinite_skips,
                           data_retries=args.data_retries)
    except PreemptedError as e:
        _finish_preempted(e)
    if not result.metrics_history:
        print(f"nothing to do: checkpoint already at step {result.step} "
              f"(resumed_from={result.resumed_from})")
        return
    print(f"done at step {result.step}; "
          f"loss {result.metrics_history[0]['loss']:.4f} -> "
          f"{result.metrics_history[-1]['loss']:.4f}; "
          f"resumed_from={result.resumed_from}; "
          f"{_fault_summary(result)} device={device}", flush=True)


def run_episodic(args) -> None:
    import torch.distributed as dist

    from repro_torch.configs.base import MetaTrainConfig
    from repro_torch.launch.mesh import (check_world, init_distributed, make_dp_mesh,
                                         make_two_level_dp_mesh)
    from repro_torch.serve.episodic import resolve_device

    meta = MetaTrainConfig(tasks_per_step=args.tasks_per_step,
                           dp_shards=args.dp_shards, dcn_shards=args.dcn_shards,
                           grad_reduce=args.grad_reduce,
                           accum_steps=args.accum_steps, lr=args.peak_lr,
                           schedule=args.schedule,
                           warmup_steps=max(args.steps // 50, 1),
                           total_steps=args.steps, lite_dtype=args.lite_dtype,
                           prefetch=args.prefetch, donate=not args.no_donate,
                           kernel_backend=args.kernel_backend)
    two_level = meta.dcn_shards > 1 or meta.grad_reduce == "compressed"
    shards = meta.dp_shards * meta.dcn_shards
    check_world(shards, f"dp_shards*dcn_shards = {meta.dp_shards}*{meta.dcn_shards}")
    mesh = None
    if two_level or shards > 1:
        device = init_distributed(args.device, backend=args.dist_backend)
        try:
            mesh = make_two_level_dp_mesh(meta.dcn_shards, meta.dp_shards) if two_level \
                else make_dp_mesh(meta.dp_shards)
            _run_episodic(args, meta, mesh, device)
        finally:
            dist.destroy_process_group()
    else:
        _run_episodic(args, meta, None, resolve_device(args.device))


def _run_episodic(args, meta, mesh, device) -> None:
    from repro_torch.core.lite import LiteSpec
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.data.episodic import (EpisodicImageConfig, HostEpisodicConfig,
                                           host_task_batch_at, task_batch_at)
    from repro_torch.faults import PreemptionSignal
    from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import CheckpointManager, MeshCheckpointManager
    from repro_torch.train.loop import PreemptedError, train
    from repro_torch.train.step import make_episodic_init_state, make_episodic_train_step

    lead = mesh is None or mesh.rank == 0
    say = (lambda msg: print(msg, flush=True)) if lead else None
    world = 1 if mesh is None else mesh.size
    backend = "none" if mesh is None else mesh.backend
    if lead:
        print(f"episodic meta-training: learner={args.learner} "
              f"tasks_per_step={meta.tasks_per_step} dp_shards={meta.dp_shards} "
              f"dcn_shards={meta.dcn_shards} grad_reduce={meta.grad_reduce} "
              f"accum_steps={meta.accum_steps} "
              f"schedule={meta.schedule or 'constant'} "
              f"prefetch={meta.prefetch} donate={meta.donate} "
              f"lite_dtype={meta.lite_dtype or 'float32'} "
              f"world={world} backend={backend} data_source={args.data_source} "
              f"kernel_backend={meta.kernel_backend} device={device}", flush=True)

    backbone = make_conv_backbone(ConvBackboneConfig(widths=(16, 32), feature_dim=64))
    learner = make_learner(MetaLearnerConfig(kind=args.learner, way=5), backbone,
                           SetEncoderConfig(kind="conv", conv_blocks=2, conv_width=16,
                                            task_dim=32))
    lite = LiteSpec(h=meta.lite_h, chunk_size=meta.lite_chunk,
                    compute_dtype=meta.lite_dtype)
    adamw = AdamWConfig(weight_decay=0.0)
    state = make_episodic_init_state(learner, adamw, meta)(
        torch.Generator().manual_seed(0), device)
    step = make_episodic_train_step(learner, lite, meta, adamw, mesh=mesh)
    # every rank draws all T tasks of the step (the samplers are pure
    # functions of it) and the step keeps the rank's block of the task axis,
    # as the JAX launcher's batch_put with a task sharding does

    if args.data_source == "host":
        hcfg = HostEpisodicConfig(way=5, shot=10, query_per_class=6,
                                  image_size=args.image_size)

        def batch_at(s):
            return dict(tasks=host_task_batch_at(17, hcfg, meta.tasks_per_step, s),
                        key=(23, s))

        def batch_put(b):
            return dict(b, tasks=b["tasks"].to(device))
    else:     # drawn on the device: nothing to move
        tcfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6,
                                   image_size=args.image_size)

        def batch_at(s):
            return dict(tasks=task_batch_at(17, tcfg, meta.tasks_per_step, s, device),
                        key=(23, s))

        batch_put = None

    # a distinct default directory per state template: a compressed run's
    # holds opt['ef'] with (dcn, ...) leaves, and a checkpoint restores only
    # into its own template
    suffix = f"_ef{meta.dcn_shards}" if meta.grad_reduce == "compressed" else ""
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_train_ckpt_episodic_{args.learner}{suffix}")
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    if mesh is not None:
        ckpt = MeshCheckpointManager(ckpt, mesh)
    preempt = PreemptionSignal().install()
    try:
        result = train(state, step, batch_at, args.steps, ckpt=ckpt,
                       ckpt_every=args.ckpt_every, state_template=state,
                       log_every=max(args.steps // 10, 1),
                       prefetch=meta.prefetch, donate=meta.donate,
                       batch_put=batch_put, preempt=preempt,
                       max_nonfinite=args.max_nonfinite_skips,
                       data_retries=args.data_retries,
                       agree=None if mesh is None else mesh.any_rank, log=say)
    except PreemptedError as e:
        if not lead:
            sys.exit(EXIT_PREEMPTED)
        _finish_preempted(e)
    if not lead:
        return
    if not result.metrics_history:
        print(f"nothing to do: checkpoint already at step {result.step} "
              f"(resumed_from={result.resumed_from})")
        return
    print(f"done at step {result.step}; resumed_from={result.resumed_from}; "
          f"loss {result.metrics_history[0]['loss']:.4f} -> "
          f"{result.metrics_history[-1]['loss']:.4f}; "
          f"accuracy {result.metrics_history[-1]['accuracy']:.3f}; "
          f"throughput {result.throughput(meta.tasks_per_step):.1f} tasks/s; "
          f"{_fault_summary(result)} world={world} backend={backend} device={device}",
          flush=True)


def main(argv=None) -> None:
    from repro_torch.configs.registry import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="minitron-4b",
                    help="LM to train (the transformers, dense, MoE and MLA, "
                         "mamba2 and the zamba2 hybrid; whisper's loss reads "
                         "frames the token pipeline does not yield, so it is "
                         "refused, ROADMAP R6)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default=None,
                    help="LR schedule (LM default cosine; --episodic default "
                         "constant --peak-lr)")
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="defaults to repro_torch_train_ckpt_<arch> (LM) or "
                         "repro_torch_train_ckpt_episodic_<learner> "
                         "(--episodic) in the temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--pods", type=int, default=1,
                    help="pods of the production mesh, read with --full on "
                         ">= 256 devices only (ROADMAP A12 part 2)")
    ap.add_argument("--full", action="store_true",
                    help="full assigned config on the production mesh; with "
                         "fewer than 256 devices it warns and runs the smoke "
                         "config")
    ap.add_argument("--episodic", action="store_true",
                    help="task-batched LITE meta-training workload")
    ap.add_argument("--learner", default="protonets",
                    choices=["protonets", "cnaps", "simple_cnaps"])
    ap.add_argument("--tasks-per-step", type=int, default=8)
    ap.add_argument("--dp-shards", type=int, default=1,
                    help="--episodic: ranks of the data-parallel 'data' axis (a "
                         "node's cards); dp x dcn must be torchrun's world size")
    ap.add_argument("--dcn-shards", type=int, default=1,
                    help="--episodic: ranks of the node-level 'dcn' axis; > 1 "
                         "builds the two-level (dcn, data) mesh")
    ap.add_argument("--grad-reduce", choices=["pmean", "compressed"],
                    default="pmean",
                    help="--episodic: the cross-node (dcn) gradient reduction, "
                         "exact pmean or int8 error feedback (needs "
                         "--dcn-shards >= 2)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend of a data-parallel run: nccl "
                         "(default on cuda, one rank a card) or gloo (default on "
                         "cpu; on cuda ranks may share a card).  The JAX launcher "
                         "has no such flag: JAX has no backend to choose")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="sequential gradient-accumulation chunks of the tasks "
                         "per optimizer step")
    ap.add_argument("--image-size", type=int, default=24)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="background batch lookahead depth (0 = sync loop)")
    ap.add_argument("--data-source", choices=["device", "host"], default="device",
                    help="episodic task stream: the sampler on --device, or the "
                         "numpy host sampler (collation the prefetcher overlaps "
                         "with the device's work)")
    ap.add_argument("--no-donate", action="store_true",
                    help="accepted for the JAX launcher's flag; eager PyTorch "
                         "donates no buffers, so it changes nothing")
    ap.add_argument("--lite-dtype", choices=["bfloat16", "float16"], default=None,
                    help="LITE no-grad complement compute dtype (default fp32)")
    ap.add_argument("--max-nonfinite-skips", type=int, default=8,
                    help="consecutive NaN/inf-skipped steps tolerated before a "
                         "rollback to the last checkpoint (then DivergenceError)")
    ap.add_argument("--data-retries", type=int, default=2,
                    help="bounded exponential-backoff retries of a failing "
                         "batch source")
    ap.add_argument("--kernel-backend", choices=["auto", "cuda", "ref", "naive"],
                    default="auto",
                    help="kernel backend (repro_torch.kernels.dispatch) of the "
                         "episodic aggregation kernels and of the LM's flash "
                         "attention, gmm and ssd_chunk: auto = the hand-written CUDA kernels on a "
                         "GPU and ref on the CPU.  The JAX launcher defaults to "
                         "ref because its Pallas kernels run in interpret mode "
                         "off the TPU; here the kernels are the main path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs without a GPU)")
    args = ap.parse_args(argv)
    if args.episodic:
        run_episodic(args)
    else:
        run_lm(args)


if __name__ == "__main__":
    main()
