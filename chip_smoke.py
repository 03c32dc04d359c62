"""Drive the PyTorch port's episodic serving and training paths, its
episodic LM meta-training, its LM training (on one card and over a (data,
model) mesh of ranks sharing it) and its LM decode serving
(dense, MoE and MLA transformers, the mamba2 SSM, the zamba2 hybrid and
the whisper encoder-decoder; on one card and over a (data, model) mesh of
ranks sharing it) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit, and the torch / CUDA versions;
1b. the roofline of ``repro_torch.roofline``: the H100's data-sheet peaks
   beside the card's own total memory, the 40 (arch x shape) cells' bounds
   (and their train cells on the production meshes of 256 and 512 chips)
   (derived from the peaks, not measured), and the abstract specs of
   ``repro_torch.launch.specs`` against real tensors on the card: for
   whisper-base, mamba2-780m and gemma2-2b at full width and depth, ``init``
   in fp32 on the card must give, leaf for leaf, the shapes and dtypes of
   ``abstract_params_for`` and raise ``torch.cuda.memory_allocated`` by 4
   bytes a param of ``param_counts`` within 1 %, and ``init_cache`` at 4
   slots of 2048 positions those of ``abstract_cache_for``;
1c. the dry run (``python -m repro_torch.launch.dryrun``) of every shape
   on the production meshes (256 and 512 fake ranks): the sharded LM train
   step, ``api.prefill`` and ``api.decode_step`` on placed params and
   caches; five host processes at the lowest priority, no card visible,
   started here and checked with the deferred checks at the end: every
   admitted cell ``ok`` (20 ``train_4k``, 44 ``prefill_32k`` /
   ``decode_32k`` / ``long_500k``), its payloads equal to
   ``roofline.lm_step_payloads`` (whisper-base's ``train_4k`` on ``single``
   pure data parallel: FLOPs a chip within 10 % of 1/16 of the trace with
   16 rows a chip) or
   ``roofline.lm_serve_payloads``; deepseek-v2's ``prefill_32k`` on
   ``single`` at least 3x fewer wire bytes than under ``--variant
   baseline`` (a fifth process); prints ``format_markdown(load_table(..))``
   of each mesh and each cell's FLOPs a chip beside the analytic mesh
   row's, with the ratio;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged and wide ones (the Mahalanobis head and
   the int8 matmul on every path of their planners, the head's "stream"
   route at F 2304, 3072 and 8192; B1-B3 at the episodic LM's shapes, F
   3072), by the error of each output row against
   that row's largest value, and time the kernel, the plain version and
   (where one exists) a single PyTorch library call; then plant faults in
   the Mahalanobis head (one cluster rank's rows of Sinv zeroed), the
   class second moment (two class columns of w swapped) and the int8
   matmul (one K group's rows of q zeroed; the scales of two quantisation
   blocks swapped) and fail unless the same check flags each;
4. serve full-width Simple CNAPs (224 x 224 images, int8 frozen backbone)
   through ``EpisodicServeEngine.run_to_completion`` on the kernels, count
   each kernel's launches (and fail unless every Mahalanobis launch took
   the bulk copy and every int8 matmul launch the 16-byte copies), and
   hold the logits and adapted states against
   the same engine on the plain ``ref`` backend; profile one more run of
   that path (device busy time, idle share, top ops by device time); then a
   shorter ProtoNets pass, read the same way;
4b. the rest of serving at phase 4's width: 12 users and then their 12
   repeats (support attached, uid order) through an L1 of 2 over a disk
   warm tier, failing unless every repeat rehydrates (12 rehydrates, 12
   adaptations), each rehydrated state is bit-equal to a copy taken at its
   adaptation and each repeat's logits are within 1e-6 of max|logit| of the
   cold wave's, and the same traffic with no warm tier, in turns (tasks/s,
   first-logit p50/p99, mean spill and rehydrate ms); one FOMAML state
   spilled and rehydrated, timed against its re-adaptation; the traffic
   again with new users submitted between steps, with the SLO at 1.5x and
   3x the measured adapt wave and without, in turns; a queue of 2 against 8 submits (6
   rejections, each with a retry-after); a 1 us deadline (every queued
   request abandoned); ``warm.corrupt`` (quarantine, re-adaptation to a
   cold engine's logits) and ``warm.vanish`` (one spill error, serving
   goes on); and ``python -m repro_torch.launch.serve --episodic`` with a
   warm directory, an SLO, a bounded queue and a deadline as a
   subprocess, whose ``store:`` line must show spills and rehydrates;
4c. multi-replica serving at phase 4's width (Simple CNAPs, int8
   backbone, 224 px, 6 users and 2 support-less repeats from the device
   sampler, cuDNN deterministic): (a) in this process, 2 replicas of the
   router (``repro_torch.serve.replica``) bit-equal to the solo engine, B1-B4
   counted on that run, and a ``replica.dead`` failover over a warm
   directory whose rerouted repeats rehydrate bit-equal to their first
   logits; then ranks as subprocesses (``python chip_smoke.py
   --serve-rank <nccl1|gloo4> <dir>``): (b) one rank on NCCL, the router on
   a (1, 1) replica mesh under each serving layout bit-equal to the solo
   engine; (c) 4 ranks on gloo sharing the card as 2 replicas x 2, under
   each layout: logits within ``LOGIT_TOL`` of (a)'s solo engine, both ranks
   of a group the same, B1-B4 on every rank, B4 at K 128 on "cp16" under
   ``weight_stationary``, one engine step's payloads equal to
   ``roofline.serving_payloads``, no collective outside ``serve`` and the
   host group; one rank's partial product dropped from the all-reduce
   under ``weight_stationary``, which the gate must flag; ``replica.dead``
   on group 1 rerouted and rehydrated bit-equal; the layout chooser's rows
   on one group; (d) ``python -m torch.distributed.run --nproc-per-node 4
   -m repro_torch.launch.serve --episodic --replicas 2 --serve-layout auto
   --serve-quant int8`` on gloo, which must exit 0 and print its replicas;
4d. the contract cells of ``repro_torch.lint.contracts`` on the card:
   ``replica_2x2`` and ``int8_ws`` on 4 gloo ranks sharing it,
   ``compile_flat``, and ``lite_outer`` at full width (phase 5's Simple
   CNAPs, 256 features, 224 px, 8 tasks, LITE h 8), none of which may give
   a finding, B1-B4 launched by them (``contracts`` in the kernels line);
   each cell's readings and the largest (.., F, F) tensor recorded; then
   each cell with its violation planted (the ranks, ``python chip_smoke.py
   --contract-rank ...``, run each rank cell again with a host-group
   collective in the audited dispatch and an fp32 copy handed to it; the
   bucket padding off; the per-example outer product), each of which must
   give a finding;
5. LITE episodic meta-training on the kernels, at the same full width
   (224 x 224 images, 8 tasks a step from the host sampler, 5-way 10-shot
   with 6 queries a class, h 8, chunks of 16, random weights): one step of
   Simple CNAPs and one of ProtoNets on the ``cuda`` backend against
   ``ref`` from the same params, tasks and H scores (loss, each gradient
   leaf against that leaf's max|ref|, the params after one AdamW update;
   the CPU tests' tolerances), failing unless B1 (both learners), B2 and
   B3 (Simple CNAPs) launched inside the differentiated step and unless
   every leaf the reference trains gets a gradient; then the same check
   must flag three faults planted in the kernels' backwards (B1's dx
   zeroed for one class, B2's g + g^T dropped, B3's dmu sign flipped);
   three Simple CNAPs steps through ``train()`` (loss, ms per step, tasks/s
   without the first step, peak memory; launches counted on exactly that
   run) and one more step profiled (device time by kind of kernel, idle
   share); the peak memory of a LITE step against an exact step on the
   same two tasks, which must be lower; and ``python -m
   repro_torch.launch.train --episodic --data-source host`` on the card
   as a subprocess, which must exit 0;
5b. the rest of single-device meta-training, at the same width: one
   batch of the on-device sampler timed, drawn twice for one step (must be
   bit-equal) and once for the next (must differ), its class patterns' RMS
   and noise std within 5 % of the config's; five Simple CNAPs steps
   through ``train()`` on it (B1-B3 launched in each) and one profiled
   step, beside phase 5's host-sampler loop; Algorithm 1's per-task step
   with query_batch 0 and 8 on one task (params within phase 5's
   tolerance of each other, the peak memory of each, B1-B3 launched), and
   ``run_looped_baseline`` over 8 tasks against one batched step of them;
   the Fig. 4 experiment (LITE, h 8, 16, 32, 4 draws) on ``cuda`` against
   ``ref`` (within 5e-2, B1-B3 launched); one meta-train step of FOMAML
   and of FineTuner (ms, peak memory), each served through the engine
   against ``ref`` as in phase 4, FineTuner's int8 head failing unless B4
   launched; one int8-state AdamW update against the fp32 state's; and
   the launcher at its defaults (the device sampler);
5c. episodic LM meta-training: Simple CNAPs with the ``tokens`` set
   encoder over minitron-4b at full width and 16 of its 32 layers (cut
   to keep the whole run within its time; random weights drawn
   on the card from seed 0, fp32 params, bf16 compute, every block
   checkpointed), 2 token tasks a step (5-way, 8 shot, 2 queries a class,
   256 tokens, vocab 256000), LITE h 8, chunks of 8: one step on the
   kernels against ``ref`` in bf16 and in fp32 compute from the same
   params, tasks and H scores, failing unless the kernel path's loss and
   worst gradient leaf (``enc`` and ``film_gen``) are within ``LM_GATE``
   times the bf16 ``ref`` run's own error against the fp32 run, every leaf
   the reference trains gets a gradient, B5 launched on "wgmma" in the
   forward (the H pass, the complement chunks, the queries) and in the
   backward (the checkpoints' recompute), its backward kernel (K5b) on
   "wgmma" once a layer but the first of each differentiated pass (dq and
   dk / dv each time; the first layer's q, k, v need no gradient) and
   nothing else in the backward, and B1-B3 (B3 on its "stream" route) in
   the differentiated step; two faults planted on the outputs of B5's
   backward kernel (dv of the last kv head zeroed, dq's sign flipped past
   S/2) that the same gate must flag;
   three steps through the example's step (loss, ms a step, tasks/s
   without the first, launches counted on exactly that run) and one
   profiled step; the peak memory of a LITE step against an exact step,
   which must be lower; ``adapt_batch`` and ``predict_batch`` on two
   held-out tasks gated the same way on the logits; ProtoNets at 4 layers
   (every weight trained) gated the same way, on tasks of concentration
   1.0 (a gate fails outright where the fp32 run's loss or gradient is
   exactly 0); B5 at the step's shapes
   against its plain version and SDPA; and ``python -m
   repro_torch.examples.episodic_lm --steps 2`` on the card as a
   subprocess, which must exit 0;
5d. LM training of gemma2-2b at full width on 8 of its 26 layers (fp32
   params and AdamW state, bf16 compute, every block checkpointed, loss
   chunks of 512; random weights drawn on the card from seed 0) on the
   token pipeline (vocab 256000, B 2, S 4608, branching 4, seed 0): one
   step's loss and gradient on the kernels, on ``ref`` in bf16 and on
   ``ref`` in fp32 compute (the pipeline's batch with each sequence's
   first 512 tokens repeated, so that what the window hides is coherent),
   failing unless the kernel path's loss and worst leaf are within
   ``LM_GATE`` times the bf16 ``ref`` run's own error, every leaf gets a
   gradient, B5 launched once a layer in the forward and once in the
   checkpoints' recompute, all on "wgmma", with the window on the local
   layers and none on the global ones, its backward kernel on "wgmma" once
   a layer, and nothing else launched; a second identical step on the
   kernels that must give the same bits; three faults planted on the
   outputs of B5's backward kernel (phase 5c's two, and the kernel called
   with the window dropped) that the gate must flag; two steps of
   ``make_train_step``
   through ``train()`` (losses, ms a step, tokens/s without the first,
   peak memory beside ``roofline.state_bytes`` of fp32 params, gradients and AdamW
   state; launches counted on exactly that run) and one profiled step
   (device time by kind, idle share, B5's share) beside the step's FLOP
   bound; one step of minitron-4b at full width and depth with int8 AdamW
   state at 2 x 2048 (ms, peak memory, a finite loss); ``remat_policy``
   "dots" against "none" at gemma2-2b's width and 2 layers within the
   same gate, with B5's launches under each; B5 at the step's shapes
   against its plain version; and ``python -m repro_torch.launch.train
   --arch gemma2-2b --steps 6 --batch 2 --seq 32`` (rerun on its
   checkpoint directory, which must have nothing to do), ``python -m
   repro_torch.examples.train_lm --steps 4`` and ``python -m
   repro_torch.examples.serve_lm --requests 2`` on the card as
   subprocesses, which must exit 0;
5e. training through MoE and MLA: LM training of deepseek-v2-236b at full
   width and 1 of its 60 layers as published (bf16 params and AdamW
   state, bf16 compute, every block checkpointed, loss chunks of 512;
   random weights drawn on the card from seed 0, each leaf cast to bf16 as
   it is drawn) on the token pipeline (B 2, S 2048: a capacity of 200
   slots an expert): one step's loss and gradient on the kernels, on
   ``ref`` in bf16 and on ``ref`` in fp32 compute from the same bf16
   weights, every routing recorded, failing unless the kernel path's loss
   and worst leaf are within ``LM_GATE`` times the bf16 ``ref`` run's own
   error, B7 launched on "wgmma" 3 times a layer in the forward, 3 in the
   checkpoints' recompute, 3 dx and 3 dw products, and nothing else, the
   recompute routed as the forward did, and a second identical step gave
   the same bits; two faults planted in B7's backward (expert e+1's dw
   written to expert e; dx zeroed on the last expert's slots) that the
   gate must flag; three steps of ``make_train_step`` through ``train()``
   (losses, ms a step, tokens/s, peak memory beside the 40.2 GB of bf16
   params, gradients and AdamW state, which must fit the card; launches
   counted on exactly that run) and one profiled step beside the step's
   bound; B7 at the step's shapes (the forward, dx on w^T and dw on x^T,
   both transposed views of the stored tensors as the backward hands them,
   K = 200) against its plain version, beside ``torch.bmm`` on the same
   views and the bytes bound; then Simple CNAPs over deepseek-v2 at full width and 2 of its 60
   layers (18.0 GB of frozen bf16 trunk), phase 5c's tasks and gate, B7's
   launches by role (no dw: a dw product fails the phase) and B1-B3's,
   three steps through the example's step; and ``python -m
   repro_torch.launch.train --arch deepseek-v2-236b --steps 3`` (smoke
   config) on the card as a subprocess, which must exit 0;
5f. training through the SSM and hybrid models: LM training of
   mamba2-780m at full width on 24 of its 48 layers (fp32 params and
   AdamW state, bf16 compute, every block checkpointed, loss chunks of
   512; random weights drawn on the card from seed 0) on the token
   pipeline (B 2, S 4096): one step's loss and gradient on the kernels,
   on ``ref`` in bf16 and on ``ref`` in fp32 compute, failing unless the
   kernel path's loss and worst leaf are within ``LM_GATE`` times the
   bf16 ``ref`` run's own error, B6 launched on "wgmma" once a layer in
   the forward and once in the checkpoints' recompute, its backward
   kernel (K6b) on "wgmma" once a layer, and nothing else, and a second
   identical step gave the same bits; a fault planted on the output of
   B6's backward kernel (dt's gradient zeroed for head 0) that the gate
   must flag; two steps of ``make_train_step`` through ``train()``
   (losses, ms a step, tokens/s, peak memory; launches counted on exactly
   that run) and one profiled step beside the step's bound; zamba2-7b at
   full width on 12 of its 81 layers (two shared sites, B 2, S 2048) the
   same way, B5 once a site in the forward on "wgmma" (its head dim 112
   runs the 128-wide tensor-core kernel) and its backward kernel once a
   site on "wgmma", without the fault; Simple CNAPs and ProtoNets (``tokens``
   encoder) over mamba2-780m at full width (Simple CNAPs at full depth,
   ProtoNets, which trains every weight, at 12 of 48 layers), phase 5c's tasks
   and gate, B6 once a layer a pass (inside its Function where the trunk
   is trained, ProtoNets' recompute too) and B1-B3 at F 1536; B6 and B5
   at the steps' shapes against their plain versions; and ``python -m
   repro_torch.launch.train --arch mamba2-780m --steps 3`` (smoke config)
   on the card as a subprocess, which must exit 0;
5g. data-parallel LITE meta-training of phase 5's Simple CNAPs (224 px,
   5-way 10-shot, 6 queries a class, h 8, chunks of 16, T 8 from the
   device sampler, seed 0), the ranks as subprocesses of this one (which
   holds no process group), cuDNN and cuBLAS deterministic in them: (a)
   one rank on NCCL, the (1, 1) mesh's ``pmean`` step bit-equal to the
   ``mesh=None`` step and its ``compressed`` step bit-equal to quantize,
   dequantize and sum on one card (NCCL's init, all-reduce and int8
   all-gather on the card); (b) 4 ranks of a 2 x 2 mesh on gloo, each
   with its own CUDA context on the one card (NCCL refuses two ranks on a
   card), T 2 each: the ``pmean`` step against (a)'s ``mesh=None`` step,
   ``accum_steps`` 2 against 1 and ``compressed`` against the composition
   on one card, with phase 5's Simple CNAPs tolerances on the loss, each
   gradient leaf (AdamW's first moment after one update) and the params;
   every rank's state bit-equal to rank 0's; B1-B3 launched on every
   rank; the collectives the same with and without accumulation; the
   payload each rank handed them equal to ``roofline.dp_payloads``; a non-zero
   residual; a NaN planted in rank 3's tasks skipped by every rank, state
   bit-equal; each rank's step ms and peak memory (4 ranks sharing one
   card: not a scaling figure) beside ``dp_collective_ms`` at 2 x 2
   (derived from the link rates, not measured); (c) ``python -m
   torch.distributed.run --standalone --nproc-per-node 4 -m
   repro_torch.launch.train --episodic`` at 2 x 2, compressed, accum 2,
   on gloo: exit 0 with ``world=4``, then "nothing to do" on the same
   directory, and on NCCL a refusal that names the cause (deferred);
5h. LM parallelism over a (data, model) mesh, the ranks gloo
   subprocesses sharing the card, after the one-device reference in this
   process (each data shard alone, saved to host files, the card then
   freed): (a) deepseek-v2-236b's MoE layer at published width (E 160, D
   5120, F 1536, top 6, 2 shared experts; drawn in bf16 from seed 11, each
   rank's E/m experts cut as drawn), T 2 x 1024 tokens, on 4 ranks as
   (data 2, model 2), ``moe_ffn_sharded`` in the 'hidden' and 'seq'
   layouts: each rank's block of y within 1e-5 of max|y| of ``moe_ffn`` on
   its data shard (fp32 operands, the same bf16-representable inputs) and
   its aux within 1e-6, bf16 within ``LM_GATE`` times the one-device bf16
   run's error against fp32, B7 three times a call on the rank's E/m
   experts, a dropped reduce-scatter caught; (b) the sharded step
   (``make_mesh_grads``, ``make_train_step(mesh=)``, the state drawn
   sharded): at the smoke config on the same 2 x 2, the gathered gradient
   against the mean of one-process steps on each data shard (fp32 compute
   routed as the kernel path, and bf16) within ``LM_GATE``, a factor of m
   planted on the model gather's VJP caught; deepseek-v2 at full width on
   1 layer as phase 5e (bf16 params and state, B 1 x S 2048) on 2 ranks as
   (data 1, model 2), 4 ranks of it passing 80 GB (``PERF.md``), each leaf
   held block by block against the same block of the one-device
   reference, B7 on the rank's 80 experts by role (3 forward, 3
   recompute, 3 dx, 3 dw); (c) each step's counted payloads equal to
   ``roofline.lm_step_payloads``; B7 at the step's shapes on E 80 beside E
   160 against its plain version and ``torch.bmm``; (d) deferred: one
   NCCL rank, the (1, 1) test mesh's step bit-equal to the step without a
   mesh, and ``torchrun --nproc-per-node 4 -m repro_torch.launch.train
   --arch deepseek-v2-236b --full`` on gloo (the warning, the (4, 1) test
   mesh, exit 0);
6. drive the LM-side kernel entry point ``repro_torch.kernels.ops`` once
   at published widths (flash attention of gemma2-2b's local and global
   layers, of minitron-4b, of zamba2-7b's head dim 112 and of
   phi-3-vision's 96, kimi-k2's expert matmul, mamba2-780m's SSD chunks in
   fp32 and in bf16), count each kernel's launches and fail unless every
   main call of gmm, flash attention and ssd_chunk took the tensor-core
   route ("wgmma"), then hold every output, and ragged shapes on both
   routes (gmm's also on the backward's transposed views of x and w),
   against the plain versions and time kernel, plain
   version and library call, as phase 3 does; then plant faults in flash
   attention at S 8192 (late rows zeroed, the wrong kv head, the window
   halved or one key block short) and in ssd_chunk at the mamba2-780m shape
   (A one head off, the last 32 dt of each chunk zeroed, y rows past Q/2
   zeroed, every other chunk's states zeroed) and fail unless the same
   check flags each; then hold the two backward kernels against their
   closed forms at every path shape that trains through them (B5's at
   gemma2-2b's local and global layers, minitron-4b's H pass and queries,
   whisper-base's encoder and decoder, zamba2-7b's shared block; B6's at
   mamba2-780m's and zamba2-7b's steps, against an fp64 evaluation of
   the closed form, and a chunk of Q 100) and at ragged shapes on both
   routes, time each beside its bound, its closed form and, where there
   is no softcap, SDPA's backward (``torch.autograd.grad`` through it,
   its forward timed apart and subtracted), and fail unless every path
   shape took "wgmma";
6b. LM decode serving (``repro_torch.serve.engine.ServeEngine``) of
   minitron-4b at full width and 8 of its 32 layers (cut to keep the
   whole run within its time), random weights drawn on the card
   from seed 0, bf16 compute, 4 slots: 8 requests (prompts 1024 x 4, then
   512, 2048, 512, 2048, so the first cohort decodes stacked and the
   second slot by slot), 16 new tokens each, failing unless every layer of
   every prefill launched flash attention (B5) on "wgmma" and nothing
   else launched (tokens/s, peak memory); the same traffic through the
   engine on ``ref`` (greedy), and teacher-forced on ``ref``'s tokens
   through the kernel path and through ``ref`` in fp32 compute (TF32
   off), failing unless the kernel path's logits (prefill and decode) are
   within ``LM_GATE`` times the bf16 ``ref`` run's own error against the
   fp32 run; prefill ms at 512, 1024 and 2048 tokens on the kernels and on
   ``ref`` in turns, the first-token latency, a decode step at 4 slots and
   at 1 beside their bounds, one profiled prefill and decode step (B5's
   share, idle share); then gemma2-2b (head dim 256, softcap 50, window
   4096) with prompts of 4608 and 1024 tokens the same way, and a planted
   fault (local and global windows swapped) that the gate must flag; B5
   at the prefill shapes against its plain version and beside SDPA; and
   ``python -m repro_torch.launch.serve`` (LM, smoke config) on the card
   as a subprocess, which must exit 0;
6c. LM decode serving of the MoE transformers at full published width:
   kimi-k2-1t-a32b (GQA + MoE, 384 experts top-8, 1 of its 61 layers) and
   deepseek-v2-236b (MLA + MoE, 160 experts top-6, 2 of its 60 layers),
   random weights drawn on the card from seed 0 with every leaf cast to
   bf16 as it is drawn, bf16 compute, through ``ServeEngine`` at 2 slots:
   4 requests (prompts 1024, 1024, then 512 and 2048, so one cohort
   decodes stacked and one ragged), 8 new tokens each, failing unless the
   gmm kernel (B7) launched on "wgmma" three times per layer per
   ``prefill`` and per ``decode_step`` call of the engine, flash attention
   (B5) on "wgmma" once per kimi-k2 prefill layer, and nothing else
   (tokens/s, peak memory); the same traffic through ``ref`` in bf16
   (greedy), and teacher-forced through the kernel path and through
   ``ref`` in fp32 compute from the same bf16 weights, every routing
   recorded: the gate of phase 6b on the logits rows whose token the three
   runs route to the same experts at every layer (the rest counted and
   printed, at least ``MOE_MIN_READ`` of the rows read), and a planted B7
   fault (expert e computed with expert e+1's weights) that it must flag
   on kimi-k2; prefill ms at 1024 tokens and a decode step at 2 slots
   beside bounds that read every expert's weights once, one profile of
   each; B7 on the inputs the path gave it (the gate and down projections
   at C 32 / 56 and the gate at C 8) against its plain version, timed
   beside ``torch.bmm`` in turns and beside the bytes bound; and ``python
   -m repro_torch.launch.serve --arch deepseek-v2-236b`` (smoke config) on
   the card as a subprocess, which must exit 0;
6d. LM decode serving of the SSM and hybrid models at full width:
   mamba2-780m (24 of 48 layers, 4 slots, prompts 1024 x 4 then 1000 and
   2048, 8 new tokens) and zamba2-7b (28 of 81 layers: 24 mamba, 4 sites
   of the shared block; 2 slots, prompts 1024, 1024, then 512 and 2048, 8
   new tokens), random weights drawn on the card from seed 0, bf16
   compute, through ``ServeEngine``, failing unless every ``prefill``
   launched B6 on "wgmma" once a mamba layer and B5 on "wgmma" once a
   shared site (head dim 112), no ``decode_step
   launched anything, and nothing else launched (tokens/s, peak memory);
   the same traffic through ``ref`` (greedy) and teacher-forced through
   the kernel path and ``ref`` in fp32 compute: phase 6b's gate on the
   logits and on the SSM states each prefill leaves in the cache, and a
   fault planted in B6 on mamba2-780m (every other chunk's states
   zeroed) that the gate must flag; prefill ms at 1024 and 2048 tokens on
   the kernels and on ``ref`` in turns and a decode step beside their
   bounds, one profiled prefill and decode step each (B6's share, idle
   share); B6 at the prefill shapes and B5 at zamba2's against their
   plain versions (B5 beside SDPA); and ``python -m
   repro_torch.launch.serve --arch mamba2-780m`` and ``--arch zamba2-7b``
   (smoke configs) on the card as subprocesses, which must exit 0;
6e. whisper-base at full width and depth (6 encoder and 6 decoder
   layers, d_model 512, 8 heads of 64, 1500 frames, vocab 51865; random
   weights drawn on the card from seed 0, fp32 params, bf16 compute).
   Served through ``ServeEngine`` at 4 slots (prompts 64 x 4, then 32 and
   128, 32 new tokens each; the engine's zero frames, as the reference
   feeds them), failing unless every ``prefill`` launched B5 on "wgmma" 12
   times (6 bidirectional at S 1500, then 6 causal at the prompt's
   length), no ``decode_step`` launched anything, and nothing else
   launched (tokens/s, peak memory); the gate of phase 6b with the model
   API driven directly on seeded random frames (zero frames make every
   encoder state exactly 0 and would hide any encoder fault): ``ref`` in
   bf16 (greedy), the kernel path and ``ref`` in fp32 compute
   teacher-forced on its tokens, held on the logits and on each layer's
   cross k and v, and a planted fault (the encoder's B5 launched causal)
   that it must flag; prefill ms at 64 and 128 tokens on the kernels and
   on ``ref`` in turns, the first-token latency and a decode step at 4
   slots beside their bounds, one profiled prefill and decode step (B5's
   share, idle share).  Trained through ``make_train_step`` (every block
   checkpointed) on the token pipeline's tokens (B 8, S 448, whisper's
   text context) and seeded random frames (8, 1500, 512): one step on the
   kernels, on ``ref`` in bf16 and in fp32 compute, phase 5f's gate (every
   leaf against its own bf16 error), failing unless B5 launched 12 times
   in the forward and 12 in the checkpoints' recompute (6 bidirectional
   each), all on "wgmma", its backward kernel 12 times on "wgmma", and
   nothing else; a fault planted on B5's backward kernel (called with the
   causal mask on the encoder's attention) that the gate must flag; two steps through ``train()`` (losses, ms a step, tokens/s,
   peak memory; launches counted on exactly that run) and one profiled
   step beside the step's FLOP bound.  B5 at the path's shapes
   (bidirectional at (1, 1500) and (8, 1500), causal at the prompt lengths
   and at (8, 448)) against its plain version and beside SDPA; and
   ``python -m repro_torch.launch.serve --arch whisper-base`` and ``python
   -m repro_torch.examples.serve_lm --arch whisper-base`` (smoke config)
   on the card as subprocesses, which must exit 0;
6f. LM prefill and decode over a (data 2, model 2) mesh of 4 gloo ranks
   sharing the card (``python chip_smoke.py --lm-rank serve4 <dir>``), at
   full width: gemma2-2b at 6 of its 26 layers, 3 local and 3 global
   (prompts of 4608, the first 512 tokens one token; its 4 kv heads put the
   cache's sequence over model), deepseek-v2 at 1 layer (prompts of 1024;
   MLA's latent over the sequence, B7 on a rank's 80 of 160 experts) and
   mamba2-780m at 24 of 48
   (prompts of 2048; the SSM's heads and the conv's channels over model),
   2 rows (one a data rank), params drawn as the one-device init's blocks
   (``init_sharded``) with the bf16 runs' weights (``compute_params``, the
   vocab tables in bf16 too): the prefill under ``use_mesh`` on the
   kernels, then 4 decode steps (deepseek-v2: 2) from the bf16 reference's
   cache placed by ``place_lm_cache``.  Each rank's logits rows and prefill
   cache blocks are gated against a one-process fp32-compute ``ref`` run on
   its row at LM_GATE times the bf16 ``ref`` run's own error (deepseek-v2:
   the rows whose token every run routes alike); the payloads of a prefill
   and a decode step must equal ``roofline.lm_serve_payloads``, the cache
   layouts ``SERVE_MESH_SPECS``, B5, B7 and B6 must launch in the prefills;
   a planted fault (the first sequence block's partial dropped from every
   merge) must fail gemma2-2b's gate on every rank; prints each rank's
   prefill and decode ms (ranks time-slicing one card beside the deferred
   checks: no scaling figure), peak memory and stages.  The references run
   in this process while the ranks start; the ranks' passes run with the
   deferred checks (a rank's passes run at gloo's rate, about 1.6 GB/s over
   the 4 ranks: every pass gathers every layer); and the quickstart (``python -m
   repro_torch.examples.quickstart``) on the card as a subprocess, which
   must exit 0 and print the reference's lines;
7. run the phases' subprocesses (the launchers and examples that phases
   4b, 4c, 5, 5b, 5c, 5d, 5e, 5f, 5g, 6b, 6c, 6d, 6e and 6f name, and 6f's
   ranks), all at once after every timed reading, each of which must exit 0
   and print what its phase expects;
8. print the ``kernels`` JSON line, the card line and, last, the result.

In the ``kernels`` line, ``ms`` is the mean time of back-to-back wrapper
calls (the wrapper's host work included; timed in turns with the library
call, where there is one), ``device_ms`` the profiler's
device time of one call (summed over the kernels a call launches; where
the profiler reads it below the bound or not at all, the time between CUDA
events on each side of one call queued behind a sleep kernel, and
``device_timer`` says which),
``library_device_ms`` the same for the library call, and ``bound_ms`` the
larger of the bytes over the HBM rate and the FLOPs, counted once, over the
peak rate of the units that do them (fp32 for the episodic kernels and the
"simt" routes, bf16 tensor cores for the "wgmma" routes) at the main path's
shape (``repro_torch.roofline.bound_ms``: every peak, bound and state
reckoning of the script is the package's, ``repro_torch.roofline``); a
timed case whose call or device time reads below its bound fails the run.
``route`` says how the kernel is written (CUDA C++), ``routes`` which of
its own routes each main case took, and ``main_cases`` gives every main
case's numbers where a kernel has more than one.  ``launches`` counts the
launches of the path that runs the kernel: the Simple CNAPs serving path
for the episodic kernels, LM serving of minitron-4b (phase 6b) for flash
attention, LM serving of kimi-k2 (phase 6c) for gmm, LM serving of
mamba2-780m (phase 6d) for ssd_chunk (``ops_launches``,
``lm_serve_gemma2_launches``, ``lm_serve_kimi_launches``,
``lm_serve_deepseek_launches``, ``lm_serve_zamba2_launches``,
``lm_serve_whisper_launches`` and ``lm_whisper_train_launches`` give the
other counts, ``lm_prefill_cases`` flash attention's numbers at the
prefill shapes, ``lm_zamba2_cases`` its numbers at zamba2-7b's head dim
112, ``lm_whisper_cases`` its numbers at whisper-base's shapes (phase
6e), ``lm_moe_cases`` gmm's at phase 6c's and ``lm_ssm_cases``
ssd_chunk's at phases 6d's and 5f's shapes);
``train_launches`` those of B1-B3 in the three training-loop steps of phase
5, of flash attention in the three steps of phase 5c, of gmm in the
three LM training steps of phase 5e and of ssd_chunk in the two
mamba2-780m steps of phase 5f (``lm_ssm_train_zamba2_launches`` and
``lm_ssm_episodic_launches`` its launches in zamba2-7b's steps and in the
episodic Simple CNAPs step's forward; ``lm_train_launches`` B1-B3's in
phase 5c; ``lm_train_cases`` flash attention's numbers at phase 5c's
shapes), ``lm_moe_episodic_launches`` gmm's in the three episodic steps
of phase 5e, ``lm_moe_train_cases`` gmm's numbers at phase 5e's shapes,
forward and backward, ``lm_ep_cases`` its numbers at a rank's E/m experts
and at all E (phase 5h), ``lm_mesh_launches`` its launches in phase 5h's
full-width sharded step on rank 0, and ``lm_pretrain_launches`` flash
attention's in the two steps of phase 5d (``lm_pretrain_cases`` its
numbers at phase 5d's shapes).  The two backward kernels have rows of
their own, ``flash_attention_bwd`` (B5's) and ``ssd_chunk_bwd`` (B6's):
``replaces`` names the TPU kernel whose gradient they compute (it has
none of its own), ``launches`` counts those of the LM training steps of
phase 5d (gemma2-2b) and 5f (mamba2-780m), ``train_launches`` those of
phase 5c's and 5f's steps, and ``main_cases`` the numbers at the path
shapes of phase 6's last check.  ``chiprun_out/chip_smoke.json`` holds every reading, the training
phases' under ``paths``, and every path's launches under ``launches``:
``serve_warm`` (phase 4b's warm-tier run), ``serve_replica`` (phase 4c (a)'s
router run; every rank's counts are under ``paths``; in the ``kernels``
line as ``serve_replica_launches``), ``contracts`` (phase 4d's cells, this
process and its 4 ranks summed; ``contracts_launches``), ``train_device`` (the
device-sampler loop), ``algo1`` (the two per-task steps), ``fig4``,
``fomaml`` and ``finetuner`` (their serving runs), ``lm_train`` (phase
5c's three steps), ``lm_pretrain`` (phase 5d's two steps), ``lm_moe_train`` and
``lm_moe_episodic`` (phase 5e's), ``lm_ssm_train``, ``lm_ssm_train_zamba2``
and ``lm_ssm_episodic`` (phase 5f's), ``dp_train`` (rank 0's ``pmean`` step
of phase 5g (b); every rank's counts are under ``paths``), ``lm_mesh`` (rank
0's sharded step of phase 5h (b) at full width), ``lm_serve_mesh`` (phase
6f's prefills and decode steps, every rank's summed; in the ``kernels``
line as ``lm_serve_mesh_launches``), ``lm_serve`` and
``lm_serve_gemma2``
(phase 6b's counted engine runs), ``lm_serve_kimi`` and
``lm_serve_deepseek`` (phase 6c's), ``lm_serve_mamba2`` and
``lm_serve_zamba2`` (phase 6d's), ``lm_serve_whisper`` and
``lm_whisper_train`` (phase 6e's engine run and two steps).

It imports no JAX.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# ``python chip_smoke.py --serve-ms SRC OUT`` and ``--kernel-ms SRC OUT``
# time the package under SRC (another checkout's ``src``: serve_ms_main,
# kernel_ms_main); every other run, this one's
sys.path.insert(0, str(pathlib.Path(sys.argv[2]).resolve()
                       if sys.argv[1:2] in (["--serve-ms"], ["--kernel-ms"]) else ROOT / "src"))

# the H100's peaks and the paths' bounds are the package's
from repro_torch.roofline import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S,  # noqa: E402
                                  attn_pairs, bound_ms, lm_bounds, moe_bounds,
                                  moe_train_bound, pretrain_bound, ssm_bounds, ssm_shape,
                                  ssm_train_bound, state_bytes, whisper_bounds,
                                  whisper_train_bound)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def mark(what: str) -> None:
    """Print the seconds since the script started beside ``what``."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


# the subprocess checks that the phases queue, run together after every
# timed reading (their processes would share the card with it)
DEFERRED = []


def defer(out: dict, key: str, fn, *args) -> None:
    """Queue ``fn(*args)``, a subprocess check, for :func:`run_deferred`,
    which stores its result as ``out[key]``."""
    DEFERRED.append((out, key, fn, args))


def run_deferred() -> None:
    """Run the queued subprocess checks at once, a thread each; each fails
    the run as it would alone, and every one is waited for."""
    import concurrent.futures
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(DEFERRED)) as pool:
        futs = [(out, key, pool.submit(fn, *args)) for out, key, fn, args in DEFERRED]
        for out, key, fut in futs:
            out[key] = fut.result()
    print(f"subprocesses: {len(DEFERRED)} checks at once in {time.perf_counter() - t0:.1f} s",
          flush=True)
    DEFERRED.clear()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _mean_ms(fn, iters: int) -> float:
    """Mean time of ``iters`` back-to-back calls, from CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 50, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    return statistics.median(_mean_ms(fn, iters) for _ in range(reps))


def time_pair_ms(fa, fb, iters: int = 50, reps: int = 7):
    """``time_ms`` of two functions taken in turns (a b, b a, a b, ...), so
    that a drift of the host's load between the two readings, which moves
    a small kernel's call time by tens of percent, falls on both alike."""
    import torch
    fa()
    fb()
    torch.cuda.synchronize()
    ta, tb = [], []
    for r in range(reps):
        for f, t in ((fa, ta), (fb, tb)) if r % 2 == 0 else ((fb, tb), (fa, ta)):
            t.append(_mean_ms(f, iters))
    return statistics.median(ta), statistics.median(tb)


def _dev_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile(fn, n: int = 1, raw: bool = False):
    """Run ``fn`` ``n`` times under torch.profiler; returns the rows by name
    (key_averages) or, with ``raw``, every event.  CUDA activity only:
    every reading here is of the device's rows, and without the CPU ops a
    step of 19 k launches is read in 3 s, not 9, with the same busy time."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof.events() if raw else prof.key_averages()


def _per_call_ms(fn, n: int, keep, tries: int = 3):
    """Device ms of one call of ``fn``, from ``n`` profiled calls: for each
    kernel (or copy) on the card whose name ``keep`` accepts, the median
    time of its launches times its launches per call (their count over n,
    at least 1).  Medians and counts per name, and up to ``tries``
    profiles, because the profiler has been seen to drop a launch of a
    long kernel, to add one, or to record none of a call's."""
    from torch.autograd import DeviceType
    for _ in range(tries):
        times = {}
        for e in profile(fn, n, raw=True):
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0 and keep(e.name):
                times.setdefault(e.name, []).append(_dev_us(e))
        if times:
            return sum(statistics.median(t) * max(1, round(len(t) / n))
                       for t in times.values()) / 1e3
    return None


# cycles of the sleep kernel that holds the stream while a call is queued
# behind it (about 1.1 ms at the H100's 1.755 GHz boost clock)
SLEEP_CYCLES = 2_000_000


def event_device_ms(fn, n: int = 10) -> float:
    """Device time of one call of ``fn`` from CUDA events recorded on each
    side of it, while a sleep kernel queued just before holds the stream so
    that the events time the call's kernels and not the host's work to
    launch them: the median over ``n`` calls.  It counts every kernel the
    call launches and any gap between them, so it can read above the
    profiler's time of one kernel but never below the card's own."""
    import torch
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        got.append(start.elapsed_time(end))
    return statistics.median(got)


def kernel_device_ms(fn, symbol: str, n: int = 50, floor: float = 0.0):
    """(device time of one call of ``fn`` spent in the kernels whose names
    contain ``symbol`` (a call may launch more than one), the timer that
    read it): the profiler's; where it reads below ``floor`` (the least time
    the card could take) or sees no launch, the CUDA events' of
    :func:`event_device_ms` (the profiler has read flash attention at S
    8192 at half its time in three profiles in a row, and none of it in
    others)."""
    got = _per_call_ms(fn, n, lambda name: symbol in name)
    if got is not None and got >= floor:
        return got, "profiler"
    ev = event_device_ms(fn)
    print(f"    the profiler read {got} ms, below the bound {floor:.5f} ms or nothing; "
          f"CUDA events around one call read {ev:.5f} ms, which is kept", flush=True)
    return ev, "events"


def call_device_ms(fn, n: int = 50):
    """Device time of one call of ``fn``, summed over every kernel and copy
    it ran on the card (a library call may launch several); None if the
    profiler saw none."""
    return _per_call_ms(fn, n, lambda name: True)


def row_err(got, want, floor: float = 0.0) -> float:
    """The largest error of a row: max|got - want| over each row (the last
    axis; a 1-D tensor is one row) over that row's max|want|.  A row whose
    values are small beside the rest of the tensor (late rows of causal
    attention, which average thousands of keys) is held to its own scale;
    with ``floor``, to no less than ``floor`` times the tensor's max|want|
    (a gradient row whose true value is 0, as dq of the first query of
    causal attention, which sees one key, is left by the fp32 sums with
    rounding noise alone)."""
    g, w = got.float(), want.float()
    if w.dim() > 1:
        g, w = g.reshape(-1, w.shape[-1]), w.reshape(-1, w.shape[-1])
    err = (g - w).abs().amax(dim=-1)
    scale = w.abs().amax(dim=-1).clamp_min(max(1e-30, floor * float(w.abs().max())))
    return float((err / scale).max())


def global_err(got, want) -> float:
    """max|got - want| over the whole tensor's max|want|."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def unaligned(t):
    """A contiguous copy of ``t`` whose base is one element past a 16-byte
    boundary, which neither TMA nor a bulk copy can read."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_kernels(specs, counted=None):
    """Hold every case of every kernel against its plain version, by the
    per-row error of each output within the case's tolerance, and time the
    main cases: kernel, plain version and library call from CUDA events,
    the kernel's device time from the profiler (or, where that reads below
    the bound or nothing, from CUDA events: :func:`kernel_device_ms`).  A
    case with an ``oracle`` is held against it in place of the plain
    version (which is still the one timed).
    ``counted`` maps
    (kernel, case index) to the outputs of a counted run of that case,
    which are then checked in place of a fresh call.  Returns the rows of
    the ``kernels`` line; each carries its first main case's times."""
    import torch
    counted = counted or {}
    rows = {}
    for spec in specs:
        name = spec["name"]
        row = dict(name=name, route="cuda", source=spec["source"],
                   replaces=spec["replaces"], max_abs_err=0.0, max_row_err=0.0,
                   max_global_err=0.0, cases=[])
        for i, c in enumerate(spec["cases"]):
            args, kw, tol = c["args"], c.get("kw", {}), c["tol"]
            got = counted.pop((name, i), None)
            got = got if got is not None else _as_tuple(c["fn"](*args, **kw))
            torch.cuda.synchronize()
            want = _as_tuple(c.get("oracle", c["plain"])(*args, **kw))
            err_abs = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
            err_row = max(row_err(a, b, c.get("row_floor", 0.0)) for a, b in zip(got, want))
            err_glob = max(global_err(a, b) for a, b in zip(got, want))
            ok = (all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(got, want))
                  and all(bool(torch.isfinite(a).all()) for a in got) and err_row <= tol)
            route = f"route={c['route']} " if "route" in c else ""
            print(f"kernel {name:20s} {c['label']:58s} {route}max_abs_err={err_abs:.3e} "
                  f"row_err={err_row:.3e} tol={tol:.0e} (global {err_glob:.3e}) "
                  + (f"against fp64 (the fp32 plain version's row_err "
                     f"{c['plain_row_err_vs_fp64']:.3e}) " if "oracle" in c else "")
                  + f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} [{c['label']}] disagrees with its plain version")
            row["max_abs_err"] = max(row["max_abs_err"], err_abs)
            row["max_row_err"] = max(row["max_row_err"], err_row)
            row["max_global_err"] = max(row["max_global_err"], err_glob)
            del got, want
            if c["main"]:
                kern = lambda: c["fn"](*args, **kw)
                it, reps = c["iters"]
                b_ms, b_by = bound_ms(c["bytes"], c["flops"], c["peak"])
                lib = (lambda: c["lib"](*args)) if c["lib"] else None
                k_ms, lib_ms = time_pair_ms(kern, lib, it, reps) if lib else \
                    (time_ms(kern, it, reps), None)
                lib_dev = call_device_ms(lib, n=it) if lib else None
                if lib and c.get("lib_minus"):    # a backward: its forward timed apart
                    fwd_ms = time_ms(c["lib_minus"], it, reps)
                    fwd_dev = call_device_ms(c["lib_minus"], n=it)
                    lib_ms -= fwd_ms
                    lib_dev = lib_dev - fwd_dev if lib_dev and fwd_dev else None
                t = dict(shape=c["label"], route=c.get("route"), ms=k_ms,
                         plain_ms=time_ms(lambda: c["plain"](*args, **kw), it, reps),
                         library_ms=lib_ms, library=c.get("lib_note"),
                         library_device_ms=lib_dev,
                         bound_ms=b_ms, bound_by=b_by, bytes=c["bytes"], flops=c["flops"])
                t["device_ms"], t["device_timer"] = kernel_device_ms(
                    kern, c.get("symbol", spec["symbol"]), n=it, floor=b_ms)
                lib_vs = (f", call {t['ms'] / t['library_ms']:.2f}x the library's"
                          if lib else "")
                print(f"  time {c['label']}: kernel {t['ms']:.4f} ms per call (device "
                      f"{t['device_ms']} ms per call, {t['device_timer']}), plain {t['plain_ms']:.4f} ms, "
                      f"library {t['library_ms']} ms (device {t['library_device_ms']} ms"
                      f"{'; ' + t['library'] if t['library'] else ''}), "
                      f"bound {b_ms:.5f} ms ({b_by}); "
                      f"{c['flops'] / t['ms'] / 1e9:.3f} TFLOP/s{lib_vs}", flush=True)
                # the bound is the least time the card could take: a kernel
                # that reads faster has a wrong bound (or a wrong timer)
                if min(t["ms"], t["device_ms"] or math.inf) < b_ms:
                    fail(f"{name} [{c['label']}]: call {t['ms']:.5f} ms or device "
                         f"{t['device_ms']} ms is below its bound {b_ms:.5f} ms")
                row["cases"].append(t)
            torch.cuda.empty_cache()
        row.update({k: row["cases"][0][k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "library_device_ms", "device_ms",
            "device_timer", "bound_ms", "bound_by")})
        row["routes"] = [t["route"] or "simt" for t in row["cases"]]
        rows[name] = row
    return rows


# ---------------------------------------------------------------------------
# phase 1b: the roofline, and the abstract specs against real tensors
# ---------------------------------------------------------------------------

ROOFLINE_MODELS = ("whisper-base", "mamba2-780m", "gemma2-2b")
ROOFLINE_CACHE = (4, 2048)          # slots, positions
ROOFLINE_MEMORY_TOL = 0.01


def _specs(tree) -> dict:
    """{path: (shape, dtype)} of a tree's tensors, {path: value} of the rest
    (a cache's ``len``)."""
    from repro_torch.common.tree import tree_paths
    return {p: (tuple(t.shape), t.dtype) if hasattr(t, "shape") else t
            for p, t in tree_paths(tree).items()}


def _spec_mismatch(got: dict, want: dict) -> list:
    return [(p, got.get(p), want.get(p)) for p in sorted(set(got) | set(want))
            if got.get(p) != want.get(p)]


def abstract_against_real(arch: str, dev) -> dict:
    """One model of phase 1b: ``init`` in fp32 on the card against
    ``abstract_params_for`` (leaf for leaf, and the rise of the allocated
    bytes against 4 bytes a param of ``param_counts``), then ``init_cache``
    against ``abstract_cache_for``; each freed before the next."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import abstract_cache_for, abstract_params_for
    from repro_torch.models.registry import get_api
    from repro_torch.roofline import param_counts
    cfg = get_config(arch)
    if cfg.param_dtype != "float32":
        fail(f"phase 1b: {arch} draws its params in {cfg.param_dtype}, not fp32")
    api = get_api(cfg)
    want = _specs(abstract_params_for(cfg))
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize(dev)
    rise = torch.cuda.memory_allocated(dev) - before
    bad = _spec_mismatch(_specs(params), want)
    if bad or not all(t.is_cuda for t in tree_leaves(params)):
        fail(f"phase 1b: {arch}'s params on the card against abstract_params_for: {bad[:5]}")
    n = param_counts(cfg)["total"]
    err = abs(rise - 4 * n) / (4 * n)
    del params
    slots, positions = ROOFLINE_CACHE
    cache = _specs(api.init_cache(cfg, slots, positions, dev))
    bad_cache = _spec_mismatch(cache, _specs(abstract_cache_for(
        cfg, ShapeSpec("phase 1b", positions, slots, "decode"))))
    torch.cuda.empty_cache()
    print(f"  {arch}: {len(want)} param leaves on the card equal abstract_params_for's "
          f"in shape and dtype; memory_allocated rose {rise} B against 4 x {n:.0f} params "
          f"= {4 * n:.0f} B ({100 * err:.4f} %); init_cache({slots}, {positions}): "
          f"{len(cache)} leaves, {len(bad_cache)} differ from abstract_cache_for", flush=True)
    if err > ROOFLINE_MEMORY_TOL:
        fail(f"phase 1b: {arch}'s params took {rise} B on the card, {100 * err:.3f} % off "
             f"4 bytes a param of param_counts ({n:.0f})")
    if bad_cache:
        fail(f"phase 1b: {arch}'s cache on the card against abstract_cache_for: "
             f"{bad_cache[:5]} (of {sorted(cache)})")
    return dict(arch=arch, leaves=len(want), params=n, allocated_rise=rise,
                reckoned=4 * n, rel_err=err, cache_leaves=len(cache))


def run_roofline(dev, card: str) -> dict:
    """Phase 1b: the card beside the package's peaks, the 40-cell table,
    and the abstract specs against real tensors on the card."""
    import torch
    from repro_torch import roofline as R
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    peaks = dict(bf16_flops=R.BF16_FLOPS, fp16_flops=R.FP16_FLOPS, fp8_flops=R.FP8_FLOPS,
                 int8_ops=R.INT8_OPS, tf32_flops=R.TF32_FLOPS, fp32_flops=R.FP32_FLOPS,
                 hbm_bytes_per_s=R.HBM_BYTES_PER_S, hbm_bytes=R.HBM_BYTES)
    print(f"roofline: card {card}; the H100 SXM data sheet's peaks at 700 W "
          f"(repro_torch.roofline.constants): {peaks}; the card's total_memory {total} B "
          f"beside HBM_BYTES {R.HBM_BYTES:.0f} B", flush=True)
    rows = R.cell_rows()
    if len(rows) != 40:
        fail(f"phase 1b: cell_rows gave {len(rows)} cells, not 40 (10 archs x 4 shapes)")
    print("roofline: the 40 (arch x shape) cells on one H100, bounds derived from the data "
          "sheet's peaks (not measured):", flush=True)
    print(R.format_markdown(rows), flush=True)
    mesh_rows = {}
    for mesh, shape in R.PRODUCTION_MESHES.items():
        mesh_rows[mesh] = R.cell_rows(mesh)
        print(f"roofline: the same cells on the production mesh {shape} (train, prefill and "
              f"decode), per chip, derived (NVLink for a model group within a node, "
              f"InfiniBand otherwise), not measured:", flush=True)
        print(R.format_markdown(mesh_rows[mesh]), flush=True)
    models = [abstract_against_real(arch, dev) for arch in ROOFLINE_MODELS]
    out = dict(peaks=peaks, total_memory=total, cells=rows, mesh_cells=mesh_rows,
               models=models, seconds=time.perf_counter() - t_phase)
    print(f"phase 1b: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """The episodic kernels' specs: name, source, replaced TPU kernel,
    device symbol and cases.  A case holds label, fn, plain, lib (or None),
    args, tol (per-row, see :func:`row_err`), main (timed), iters
    (back-to-back calls, repetitions), bytes, flops and peak."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import mahalanobis as md
    from repro_torch.kernels import segment_pool as sp
    from repro_torch.optim.quant import dequantize, quantize

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    def onehot(t, b, c, pad_rows):
        y = torch.randint(0, c, (t, b), generator=g)
        w = torch.nn.functional.one_hot(y, c).float()
        if pad_rows:
            w[:, -pad_rows:] = 0.0          # collator padding: zero-weight rows
        return w.to(dev)

    def case(label, fn, plain, lib, args, nbytes, flops, main=None):
        # fp32 sums in other orders, whatever the input dtype
        return dict(label=label, fn=fn, plain=plain, lib=lib, args=args, tol=1e-5,
                    main=label.startswith("main") if main is None else main,
                    iters=(50, 7), bytes=nbytes, flops=flops, peak=FP32_FLOPS)

    def seg_case(label, t, b, f, c, dtype=torch.float32, pad=0, main=None):
        x, w = randn(t, b, f, dtype=dtype), onehot(t, b, c, pad)
        nbytes = x.numel() * x.element_size() + w.numel() * 4 + t * c * f * 4
        return case(label, sp.segment_pool_weighted, sp.segment_pool_weighted_plain,
                    lambda x, w: torch.bmm(w.transpose(1, 2), x.float()), (x, w),
                    nbytes, 2.0 * t * b * c * f, main)

    def sm_case(label, t, b, f, c, dtype=torch.float32, pad=0, main=None):
        x, w = randn(t, b, f, dtype=dtype), onehot(t, b, c, pad)
        nbytes = x.numel() * x.element_size() + w.numel() * 4 + t * c * f * f * 4
        return case(label, sp.class_second_moment, sp.class_second_moment_plain,
                    lambda x, w: torch.einsum("tbc,tbi,tbj->tcij", w, x.float(), x.float()),
                    (x, w), nbytes, 2.0 * t * c * b * f * f, main)

    def routed(c, plan, route):
        # the case's route, as the planner picks it; a case written for one
        # route fails the run if the planner sends it down another
        if route is not None and plan.route != route:
            fail(f"{c['label']}: the planner picked route {plan.route}, not {route}")
        return c | dict(route=plan.route)

    def md_case(label, t, m, c, f, offset=False, route=None, main=None):
        q, mu = randn(t, m, f), randn(t, c, f)
        a = randn(t, c, f, f) / math.sqrt(f)
        sinv = a @ a.transpose(-1, -2) + torch.eye(f, device=dev)
        del a
        if offset:
            sinv = unaligned(sinv)
        nbytes = 4 * (q.numel() + mu.numel() + sinv.numel() + t * m * c)
        # library yardstick: one einsum on the difference q - mu computed
        # beforehand, so it does less than the kernel, which forms it
        diff = (q[:, :, None, :] - mu[:, None, :, :]).contiguous()
        lib = lambda q, mu, sinv: torch.einsum("tmcf,tcfg,tmcg->tmc", diff, sinv, diff)
        return routed(case(label, md.mahalanobis, md.mahalanobis_plain, lib, (q, mu, sinv),
                           nbytes, 2.0 * t * c * m * f * f + 3.0 * t * c * m * f, main),
                      md.mahalanobis_plan(m, f, sinv.data_ptr() % 16 == 0), route) | dict(
                          lib_note="einsum on q - mu formed beforehand: less work")

    def im_case(label, m, k, n, offset=False, route=None, main=None):
        x = randn(m, k)
        if offset:
            x = unaligned(x)
        qs = quantize(randn(k, n) / math.sqrt(k))
        q, s = qs["q"].contiguous(), qs["scale"].contiguous()
        nbytes = 4 * x.numel() + q.numel() + 4 * s.numel() + 4 * m * n
        # library yardstick: one torch.mm on the fp32 weight dequantized
        # beforehand, so it does less than the kernel (no dequantisation)
        # and reads four times the weight's bytes
        w = dequantize(dict(q=q, scale=s, n=n))
        lib = lambda x, q, s: torch.mm(x, w)
        return routed(case(label, im.int8_matmul, im.int8_matmul_plain, lib, (x, q, s),
                           nbytes, 2.0 * m * k * n, main),
                      im.int8_matmul_plan(m, k, n, x.data_ptr() % 16 == 0), route) | dict(
                          lib_note="torch.mm on the weight dequantized beforehand: no "
                                   "dequantisation, 4x the weight bytes")

    src = "src/repro_torch/kernels/csrc/"
    spec = lambda name, source, replaces, symbol, cases: dict(
        name=name, source=src + source, replaces=replaces, symbol=symbol, cases=cases)
    return [
        spec("segment_sum", "segment_pool.cu", "src/repro/kernels/segment_pool.py:55",
             "segment_sum_kernel", [
                 seg_case("main T4 B32 F256 C5", 4, 32, 256, 5),
                 seg_case("ragged T3 B37 F200 C5 bf16 pad5", 3, 37, 200, 5, torch.bfloat16, 5),
                 seg_case("ragged T2 B21 F72 C5 fp16 pad3", 2, 21, 72, 5, torch.float16, 3),
                 # the episodic LM's shapes at minitron-4b's d_model (phase
                 # 5c): an H pass or a complement chunk, an adaptation
                 seg_case("lm T2 B8 F3072 C5", 2, 8, 3072, 5, main=True),
                 seg_case("lm T2 B40 F3072 C5", 2, 40, 3072, 5, main=True)]),
        spec("class_second_moment", "segment_pool.cu", "src/repro/kernels/segment_pool.py:112",
             "second_moment_kernel", [
                 sm_case("main T4 B32 F256 C5", 4, 32, 256, 5),
                 sm_case("ragged T3 B37 F200 C5 bf16 pad5", 3, 37, 200, 5, torch.bfloat16, 5),
                 sm_case("ragged T2 B21 F72 C5 fp16 pad3", 2, 21, 72, 5, torch.float16, 3),
                 sm_case("wide T4 B32 F512 C5", 4, 32, 512, 5),
                 sm_case("lm T2 B8 F3072 C5", 2, 8, 3072, 5, main=True),
                 sm_case("lm T2 B40 F3072 C5", 2, 40, 3072, 5, main=True)]),
        # the planner's paths: one bulk copy a block; 4-byte cp.async by
        # every thread where F % 4 != 0 or Sinv is misaligned; several query
        # tiles; two streaming stages at F 640; past F 2048 the stream route
        # at the d_model of gemma2-2b (2304), minitron-4b (3072) and
        # qwen2-72b (8192), timed, and with 4-byte copies at F % 4 != 0
        spec("mahalanobis", "mahalanobis.cu", "src/repro/kernels/mahalanobis.py:29",
             "mahalanobis", [
                 md_case("main T4 M8 C5 F256", 4, 8, 5, 256),
                 md_case("ragged T3 M13 C5 F200", 3, 13, 5, 200),
                 md_case("wide T4 M8 C5 F512", 4, 8, 5, 512),
                 md_case("tiles T2 M130 C5 F256", 2, 130, 5, 256),
                 md_case("ragged T3 M8 C5 F250 (F % 4: threads)", 3, 8, 5, 250),
                 md_case("ragged T2 M8 C5 F256 Sinv unaligned (threads)", 2, 8, 5, 256,
                         offset=True),
                 md_case("wide T1 M8 C5 F640 (two stages)", 1, 8, 5, 640),
                 md_case("stream T1 M8 C2 F2304", 1, 8, 2, 2304, route="stream", main=True),
                 md_case("stream T1 M8 C2 F3072", 1, 8, 2, 3072, route="stream", main=True),
                 md_case("stream T1 M8 C2 F8192", 1, 8, 2, 8192, route="stream", main=True),
                 md_case("stream T1 M13 C2 F2306 (F % 4: 4-byte copies)", 1, 13, 2, 2306,
                         route="stream"),
                 md_case("lm T2 M10 C5 F3072 (stream)", 2, 10, 5, 3072, route="stream",
                         main=True)]),
        # the adapt chunk (M 128) and the query dispatch (M 32) of the
        # serving path, timed; ragged shapes on both copy paths
        spec("int8_matmul", "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:50",
             "int8_matmul_kernel", [
                 im_case("main M128 K256 N256", 128, 256, 256, route="cp16"),
                 im_case("query M32 K256 N256", 32, 256, 256, route="cp16", main=True),
                 # a rank's K-slice under the weight_stationary layout on a
                 # group of 2 (phase 4c): the query dispatch and an adapt chunk
                 im_case("kslice M32 K128 N256", 32, 128, 256, route="cp16", main=True),
                 im_case("kslice M128 K128 N256", 128, 128, 256, route="cp16", main=True),
                 im_case("ragged M50 K200 N300 (N % 16: cp4)", 50, 200, 300, route="cp4"),
                 im_case("ragged M50 K130 N300 (K % 4: cp4)", 50, 130, 300, route="cp4"),
                 im_case("ragged M50 K200 N320", 50, 200, 320, route="cp16"),
                 im_case("ragged M32 K256 N256 x unaligned (cp4)", 32, 256, 256, offset=True,
                         route="cp4")]),
    ]


# ---------------------------------------------------------------------------
# phase 4: the main path through EpisodicServeEngine
# ---------------------------------------------------------------------------

IMAGE_SIZE = 224
# gate for the kernel path (explicit inverse + Mahalanobis kernel) against
# the ref path (Cholesky solves) on the same engine inputs, relative to
# max|logit|.  On the CPU the two paths of this configuration (32 px images,
# three seeds) differ by at most 3.4e-6; the gate leaves room for cuSOLVER's
# inverse and the GPU's other summation orders.
LOGIT_TOL = 1e-3
STATE_TOL = 1e-4        # mu: fp32 sums of the same features in two orders
# the adapted state each kind's check reads: class means, prototypes, the
# fitted head, the adapted head
STATE_PART = {"simple_cnaps": lambda s: s["mu"], "protonets": lambda s: s,
              "finetuner": lambda s: s["w"], "fomaml": lambda s: s["head"]["w"]}


def build_model(kind: str, dev):
    import torch
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
    learner = make_learner(MetaLearnerConfig(kind=kind, way=5),
                           make_conv_backbone(ConvBackboneConfig()),
                           SetEncoderConfig())
    params = learner.init(torch.Generator().manual_seed(0), dev)
    return learner, params


def serve(learner, params, reqs, backend, dev, clock):
    """Cold wave, then warm wave, through a fresh engine; returns (engine,
    seconds, the served requests)."""
    import torch
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import plan_buckets
    from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
    cold, warm = reqs
    copy = lambda rs: [EpisodicRequest(uid=r.uid, support_x=r.support_x,
                                       support_y=r.support_y, query_x=r.query_x)
                       for r in rs]
    cold, warm = copy(cold), copy(warm)
    engine = EpisodicServeEngine(
        learner, params, lite=LiteSpec(exact=True, chunk_size=32), n_slots=4,
        query_chunk=8,
        support_buckets=plan_buckets([r.support_x.shape[0] for r in cold + warm]),
        serve_quant="int8", kernel_backend=backend, clock=clock, device=dev)
    torch.cuda.synchronize()
    t0 = clock()
    engine.run_to_completion(cold)
    engine.run_to_completion(warm)
    torch.cuda.synchronize()
    dt = clock() - t0
    if not all(r.done for r in cold + warm):
        fail(f"{backend} engine left requests unserved")
    return engine, dt, cold + warm


def trace_path(learner, params, reqs, dev, clock, wall_s: float, top: int = 12):
    """One more kernel-path engine run under torch.profiler: device busy
    time (sum of the device-side events' time), its idle share against ``wall_s`` (the
    same run's wall time without the profiler, whose own overhead inflates
    the profiled wall), and the top ops by device time."""
    t0 = clock()
    rows = profile(lambda: serve(learner, params, reqs, "cuda", dev, clock))
    wall_ms = (clock() - t0) * 1e3
    from torch.autograd import DeviceType
    # device-side rows only (kernels, copies): the host's rows (the CUDA
    # runtime's calls) carry no device time of their own
    dev_rows = sorted((r for r in rows if r.device_type == DeviceType.CUDA
                       and _dev_us(r) > 0), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(r) for r in dev_rows) / 1e3
    idle = 1 - busy_ms / (wall_s * 1e3)
    print(f"  trace: device busy {busy_ms:.1f} ms of an unprofiled wall "
          f"{wall_s * 1e3:.1f} ms (idle share {idle:.3f}); profiled wall "
          f"{wall_ms:.1f} ms", flush=True)
    table = [dict(op=r.key[:90], count=r.count, device_ms=_dev_us(r) / 1e3)
             for r in dev_rows]
    for r in table[:top]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<5d} {r['op']}", flush=True)
    return dict(profiled_wall_ms=wall_ms, busy_ms=busy_ms, idle_share=idle,
                top=table[:40])


def run_path(kind: str, n_requests: int, dev, launches, trace: bool = False):
    """Drive ``kind`` through the engine on the kernels (counts read from
    exactly that run), then on ``ref``; hold logits and states together."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import build_requests
    clock = time.perf_counter
    learner, params = build_model(kind, dev)
    reqs = build_requests(n_requests, 0.5, 10, 10, IMAGE_SIZE, seed=0)
    warm_up = build_requests(2, 0.0, 10, 10, IMAGE_SIZE, seed=1)
    serve(learner, params, warm_up, "cuda", dev, clock)  # cuDNN / allocator warm-up
    serve(learner, params, warm_up, "ref", dev, clock)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    eng, dt, got = serve(learner, params, reqs, "cuda", dev, clock)
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    ref, dt_ref, want = serve(learner, params, reqs, "ref", dev, clock)
    s, sr = eng.stats(), ref.stats()
    print(f"path {kind}: {len(got)} requests, 224x224, int8 backbone, "
          f"launches {counts}, adapt dispatches {s['adapt_dispatches']}, "
          f"query dispatches {s['predict_dispatches']}", flush=True)
    print(f"  cuda: {dt:.4f} s, tasks/s {s['tasks_adapted'] / dt:.3f}, queries/s "
          f"{s['queries_served'] / dt:.2f}, adapt p50/p99 {s['adapt_p50_us']:.0f}/"
          f"{s['adapt_p99_us']:.0f} us, first-logit p50/p99 {s['query_p50_us']:.0f}/"
          f"{s['query_p99_us']:.0f} us, hit rate {s['hit_rate']:.2f}, peak "
          f"memory {peak} B", flush=True)
    print(f"  ref:  {dt_ref:.4f} s, tasks/s {sr['tasks_adapted'] / dt_ref:.3f}, "
          f"queries/s {sr['queries_served'] / dt_ref:.2f}", flush=True)
    for k in ("tasks_adapted", "queries_served", "hit_rate"):
        if s[k] != sr[k]:
            fail(f"{kind}: {k} differs between cuda ({s[k]}) and ref ({sr[k]})")
    worst, agree, n_conf = 0.0, 0, 0
    for r, q in zip(got, want):
        a, b = r.all_logits(), q.all_logits()
        if a.shape != (r.n_queries, 5) or not np.isfinite(a).all():
            fail(f"{kind} uid {r.uid}: logits of shape {a.shape}, finite="
                 f"{bool(np.isfinite(a).all())}")
        scale = np.abs(b).max()
        worst = max(worst, float(np.abs(a - b).max() / scale))
        top2 = np.sort(b, axis=-1)[:, -2:]
        conf = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL * scale
        n_conf += int(conf.sum())
        agree += int((a.argmax(-1) == b.argmax(-1))[conf].sum())
    state_err = 0.0
    part = STATE_PART[kind]
    for uid in {r.uid for r in got}:
        a, b = part(eng.store.l1.peek(uid)), part(ref.store.l1.peek(uid))
        state_err = max(state_err, float((a - b).abs().max() / b.abs().max()))
    print(f"  cuda vs ref: logits rel err {worst:.3e} (tol {LOGIT_TOL:.0e}), "
          f"argmax agree {agree}/{n_conf} confident queries, state rel err "
          f"{state_err:.3e} (tol {STATE_TOL:.0e})", flush=True)
    if worst > LOGIT_TOL or agree != n_conf or state_err > STATE_TOL:
        fail(f"{kind}: the kernel path disagrees with the ref path")
    launches[kind] = counts
    traced = trace_path(learner, params, reqs, dev, clock, dt) if trace else None
    return dict(kind=kind, trace=traced, seconds=dt, tasks_per_s=s["tasks_adapted"] / dt,
                queries_per_s=s["queries_served"] / dt, peak_bytes=peak,
                adapt_p50_us=s["adapt_p50_us"], adapt_p99_us=s["adapt_p99_us"],
                query_p50_us=s["query_p50_us"], query_p99_us=s["query_p99_us"],
                logits_rel_err=worst, launches=counts,
                adapt_dispatches=s["adapt_dispatches"],
                predict_dispatches=s["predict_dispatches"])


# ---------------------------------------------------------------------------
# phase 4b: the rest of serving (warm tier, SLO, backpressure, deadlines,
# the warm tier's faults, the launcher)
# ---------------------------------------------------------------------------

WARM_USERS = 12
WARM_LOGIT_TOL = 1e-6   # a rehydrated state is the adapted state's bits


def warm_traffic(dev):
    """``WARM_USERS`` tasks (way 5, shot 10, 10 queries a class) from the
    device sampler, on the host as the engine takes them; ``make(uids,
    support)`` builds fresh requests over them."""
    from repro_torch.data.episodic import EpisodicImageConfig, task_batch_at
    from repro_torch.serve.episodic import EpisodicRequest
    cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=10, image_size=IMAGE_SIZE)
    b = task_batch_at(23, cfg, WARM_USERS, 0, dev)
    sx, sy, qx = (b.support_x.cpu().numpy(), b.support_y.cpu().numpy(),
                  b.query_x.cpu().numpy())

    def make(uids, support=True):
        return [EpisodicRequest(uid=u, support_x=sx[u] if support else None,
                                support_y=sy[u] if support else None,
                                query_x=qx[u]) for u in uids]
    return make


def warm_engine(learner, params, dev, **kw):
    """Phase 4's engine (the kernels, 4 lanes, chunks of 32, 8 queries a
    dispatch, int8 backbone) with ``kw`` on top."""
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import plan_buckets
    from repro_torch.serve.episodic import EpisodicServeEngine
    kw.setdefault("serve_quant", "int8")
    return EpisodicServeEngine(learner, params, lite=LiteSpec(exact=True, chunk_size=32),
                               n_slots=4, query_chunk=8, support_buckets=plan_buckets([50]),
                               kernel_backend="cuda", clock=time.perf_counter,
                               device=dev, **kw)


def _tree_bytes(tree) -> int:
    from repro_torch.common.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _bit_equal(a, b) -> bool:
    import torch
    from repro_torch.common.tree import tree_paths
    pa, pb = tree_paths(a), tree_paths(b)
    return list(pa) == list(pb) and all(
        pa[k].dtype == pb[k].dtype and pa[k].device == pb[k].device
        and torch.equal(pa[k], pb[k]) for k in pa)


def store_breakdown(state, dev, tmp, reps: int = 5):
    """Median ms of each part of one spill and one rehydrate of ``state``:
    the copy to the host, the npz encoding (into memory), the whole
    ``save_array_tree`` (encoding, write, fsync), the checked read and the
    copy back to the card."""
    import io
    import numpy as np
    import torch
    from repro_torch.bridge import to_jax_layout
    from repro_torch.common.tree import tree_map, tree_to
    from repro_torch.train.checkpoint import (encode_array_tree, load_array_tree,
                                              save_array_tree)
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    host = tree_map(lambda t: t.cpu(), state)
    parts = {"to_host": lambda: tree_map(lambda t: t.cpu(), state),
             "encode": lambda: np.savez(io.BytesIO(),
                                        **encode_array_tree(to_jax_layout(host))[0]),
             "save_fsync": lambda: save_array_tree(tmp / "x.npz", host),
             "load_crc": lambda: load_array_tree(tmp / "x.npz", meta, verify=True),
             "to_device": lambda: tree_to(host, dev)}
    tmp.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    print("  one spill and rehydrate, median ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()) + f" ({_tree_bytes(state)} B)", flush=True)
    return out


def warm_tier_run(learner, params, dev, make, warm_dir, launches):
    """Item 1: 12 cold users, then their 12 repeats (support attached) in
    uid order through an L1 of 2, each repeat a rehydrate whose state must
    be the adapted state's bits and whose logits the cold wave's; and the
    same traffic with no warm tier, in turns (warm, none, none, warm, each
    warm run on a fresh directory).  Launches counted on the first run."""
    import numpy as np
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.kernels import _build
    uids = list(range(WARM_USERS))
    out = {"warm": [], "none": []}
    for i, mode in enumerate(("warm", "none", "none", "warm")):
        eng = warm_engine(learner, params, dev, cache_capacity=2,
                          warm_dir=warm_dir / str(i) if mode == "warm" else None)
        adapted, restored = {}, {}
        put, get = eng.store.put, eng.store.get

        def put_copy(uid, st, put=put, adapted=adapted):
            adapted.setdefault(uid, tree_map(lambda t: t.clone(), st))
            put(uid, st)

        def get_seen(uid, get=get, store=eng.store, restored=restored):
            before = store.rehydrates
            st = get(uid)
            if store.rehydrates > before:
                restored[uid] = st
            return st

        eng.store.put, eng.store.get = put_copy, get_seen
        cold, repeat = make(uids), make(uids)
        torch.cuda.synchronize()
        _build.launches.reset()
        t0 = time.perf_counter()
        eng.run_to_completion(cold)
        eng.run_to_completion(repeat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            launches["serve_warm"] = _build.launches.snapshot()
        s = eng.stats()
        rel = max(float(np.abs(r.all_logits() - c.all_logits()).max()
                        / np.abs(c.all_logits()).max()) for c, r in zip(cold, repeat))
        row = dict(seconds=dt, tasks_per_s=2 * WARM_USERS / dt,
                   tasks_adapted=s["tasks_adapted"], rehydrates=s["rehydrates"],
                   spills=s["spills"], query_p50_us=s["query_p50_us"],
                   query_p99_us=s["query_p99_us"], spill_ms=s["spill_mean_us"] / 1e3,
                   rehydrate_ms=s["rehydrate_mean_us"] / 1e3,
                   adapt_wave_ms=s["adapt_cost_est_us"] / 1e3,
                   repeat_logits_rel=rel, adapt_compiles=s["adapt_compiles"],
                   predict_compiles=s["predict_compiles"])
        print(f"serve_warm {mode}: {2 * WARM_USERS} requests ({WARM_USERS} users, then "
              f"their repeats) in {dt:.4f} s, tasks/s {row['tasks_per_s']:.3f}, adapted "
              f"{s['tasks_adapted']}, rehydrates {s['rehydrates']}, spills {s['spills']}, "
              f"first-logit p50/p99 {s['query_p50_us']:.0f}/{s['query_p99_us']:.0f} us, "
              f"mean spill {row['spill_ms']:.3f} ms, rehydrate {row['rehydrate_ms']:.3f} ms, "
              f"adapt wave (EWMA) {row['adapt_wave_ms']:.2f} ms, repeat vs cold logits "
              f"{rel:.3e}", flush=True)
        if not all(r.done for r in cold + repeat):
            fail(f"serve_warm {mode}: requests left unserved")
        if mode == "warm":
            same = [u for u in uids if u in restored and _bit_equal(restored[u], adapted[u])]
            print(f"  rehydrated states bit-equal to the adapted ones: {len(same)}/"
                  f"{WARM_USERS}; launches {_build.launches.snapshot()}", flush=True)
            if s["rehydrates"] != WARM_USERS or s["tasks_adapted"] != WARM_USERS:
                fail(f"serve_warm: {s['rehydrates']} rehydrates and {s['tasks_adapted']} "
                     f"adaptations (want {WARM_USERS} each)")
            if len(same) != WARM_USERS or not all(r.cache_hit for r in repeat):
                fail("serve_warm: a rehydrated state differs from its adapted state")
            if rel > WARM_LOGIT_TOL:
                fail(f"serve_warm: repeat logits {rel:.3e} of max|logit| from the cold "
                     f"wave's (tol {WARM_LOGIT_TOL:.0e})")
            _need("serve_warm", launches["serve_warm"],
                  ("segment_sum", "class_second_moment", "mahalanobis", "int8_matmul"))
            if i == 0:
                out["breakdown"] = store_breakdown(adapted[0], dev, warm_dir / "breakdown")
        elif s["tasks_adapted"] != 2 * WARM_USERS or s["rehydrates"] != 0:
            fail(f"serve_warm without a warm tier: {s['tasks_adapted']} adaptations")
        out[mode].append(row)
    return out


def fomaml_warm_check(dev, make, warm_dir):
    """Item 2: one FOMAML state (a whole backbone) spilled and rehydrated
    through a store of capacity 1, timed against its re-adaptation."""
    import numpy as np
    import torch
    from repro_torch.core.episodic import Task, index_task_state
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import collate_task_batch, plan_buckets
    from repro_torch.kernels import dispatch
    from repro_torch.serve.episodic import TwoTierTaskStore
    learner, params = build_model("fomaml", dev)
    reqs = make([0, 1])
    states, adapt_ms = [], []
    for r in reqs + reqs[:1]:                    # the last a timed re-adaptation
        task = Task(support_x=r.support_x, support_y=r.support_y,
                    query_x=np.zeros_like(r.query_x[:1]), query_y=np.zeros(1, np.int32))
        batch = collate_task_batch([task], support_size=plan_buckets([50])[0],
                                   query_size=1).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dispatch.use_backend("cuda"):
            st = learner.adapt_batch(params, batch, LiteSpec(exact=True, chunk_size=32))
        torch.cuda.synchronize()
        adapt_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(index_task_state(st, 0))
    store = TwoTierTaskStore(1, warm_dir=warm_dir, device=dev, clock=time.perf_counter)
    store.put(0, states[0])
    store.put(1, states[1])                      # spills 0
    for i in range(4):                           # each get rehydrates, spills the other
        back = store.get(i % 2)
        torch.cuda.synchronize()
        if back is None or not _bit_equal(back, states[i % 2]):
            fail("fomaml warm tier: a rehydrated state differs from the adapted one")
    nbytes = _tree_bytes(states[0])
    row = dict(state_bytes=nbytes, readapt_ms=adapt_ms[-1],
               spill_ms=store.spill_s / store.spills * 1e3,
               rehydrate_ms=store.rehydrate_s / store.rehydrates * 1e3,
               spills=store.spills, rehydrates=store.rehydrates)
    print(f"serve_warm fomaml: state {nbytes} B; re-adapt {adapt_ms[-1]:.2f} ms (first "
          f"{adapt_ms[0]:.2f}), rehydrate {row['rehydrate_ms']:.3f} ms, spill "
          f"{row['spill_ms']:.3f} ms (means of {store.rehydrates} and {store.spills})",
          flush=True)
    if row["rehydrate_ms"] >= row["readapt_ms"]:
        fail("fomaml warm tier: rehydrating costs no less than re-adapting")
    return row


def scheduling_check(learner, params, dev, make, wave_ms, warm_root):
    """Item 3: the item-1 traffic with new users submitted between steps
    while lanes stream, with the SLO at 1.5x item 1's adapt wave, at 3x
    and without, twice each in turns (none, 1.5x, 3x, 3x, 1.5x, none); a
    queue of 2 against 8 submits; a 1 us deadline."""
    uids = list(range(WARM_USERS))
    slos = {"no_slo": None, "slo_1.5x": 1.5 * wave_ms * 1e3, "slo_3x": 3 * wave_ms * 1e3}
    out = {name: dict(slo_us=slo, runs=[]) for name, slo in slos.items()}
    for rep, order in enumerate((list(slos), list(slos)[::-1])):
        for name in order:
            eng = warm_engine(learner, params, dev, cache_capacity=2,
                              query_slo_us=slos[name], adapt_cost_hint_us=wave_ms * 1e3,
                              warm_dir=warm_root / f"{name}_{rep}")
            # two users first, then one more request each step, so new users
            # are admitted beside lanes that stream
            pending = make(uids) + make(uids)
            reqs = list(pending)
            for r in pending[:2]:
                eng.submit(r)
            pending = pending[2:]
            while eng.busy or pending:
                eng.step()
                if pending:
                    eng.submit(pending.pop(0))
            s = eng.stats()
            if not all(r.done for r in reqs):
                fail(f"serve_warm {name}: requests left unserved")
            run = dict(slo_preemptions=s["slo_preemptions"], query_p50_us=s["query_p50_us"],
                       query_p99_us=s["query_p99_us"], tasks_adapted=s["tasks_adapted"],
                       rehydrates=s["rehydrates"])
            out[name]["runs"].append(run)
            slo = slos[name]
            print(f"serve_warm {name}: SLO {slo if slo is None else round(slo)} us, "
                  f"preemptions {s['slo_preemptions']}, first-logit p50/p99 "
                  f"{s['query_p50_us']:.0f}/{s['query_p99_us']:.0f} us, adapted "
                  f"{s['tasks_adapted']}, rehydrates {s['rehydrates']}", flush=True)
    if any(r["slo_preemptions"] for r in out["no_slo"]["runs"]):
        fail("serve_warm: an engine without an SLO preempted an adapt wave")

    eng = warm_engine(learner, params, dev, max_queue=2, adapt_cost_hint_us=wave_ms * 1e3)
    reqs = make(range(8))
    taken = [eng.submit(r) for r in reqs]
    eng.run_to_completion([])
    rejected = [r for r in reqs if r.rejected]
    print(f"serve_warm max_queue=2: {sum(taken)} queued, {len(rejected)} rejected, "
          f"retry_after_us {[round(r.retry_after_us) for r in rejected]}", flush=True)
    if len(rejected) != 6 or eng.stats()["rejections"] != 6 or \
            not all(r.retry_after_us and r.retry_after_us > 0 for r in rejected) or \
            not all(r.done and r.served == r.n_queries for r in reqs if not r.rejected):
        fail("serve_warm: the bounded queue did not reject 6 of 8 with a retry-after")
    out["max_queue"] = dict(queued=sum(taken), rejected=len(rejected),
                            retry_after_us=[r.retry_after_us for r in rejected])

    eng = warm_engine(learner, params, dev, deadline_us=1.0)
    late = make(range(8))
    for r in late:
        eng.submit(r)
    eng.run_to_completion([])
    s = eng.stats()
    print(f"serve_warm deadline_us=1: {s['deadline_abandoned']} of {len(late)} abandoned, "
          f"adapted {s['tasks_adapted']}", flush=True)
    if s["deadline_abandoned"] != len(late) or not all(r.abandoned and r.done for r in late):
        fail("serve_warm: a 1 us deadline did not abandon every queued request")
    out["deadline"] = dict(abandoned=s["deadline_abandoned"], tasks_adapted=s["tasks_adapted"])
    return out


def warm_faults_check(learner, params, dev, make, warm_root):
    """Item 4: ``warm.corrupt`` on uid 0 must quarantine it and its repeat
    re-adapt to a cold engine's logits; ``warm.vanish`` must cost one spill
    error while serving goes on."""
    import numpy as np
    from repro_torch.faults import WARM_CORRUPT, WARM_VANISH, FaultPlan
    plan = FaultPlan.single(WARM_CORRUPT, at=0)
    eng = warm_engine(learner, params, dev, cache_capacity=2, fault_plan=plan,
                      warm_dir=warm_root / "corrupt")
    eng.run_to_completion(make([0, 1, 2]))       # uid 0 spilled, then truncated
    (repeat,) = eng.run_to_completion(make([0]))
    (ref,) = warm_engine(learner, params, dev).run_to_completion(make([0]))
    s = corrupt = eng.stats()
    rel = float(np.abs(repeat.all_logits() - ref.all_logits()).max()
                / np.abs(ref.all_logits()).max())
    print(f"serve_warm warm.corrupt: fired {plan.fired_count(WARM_CORRUPT)}, quarantined "
          f"{s['quarantined']}, repeat cache_hit {repeat.cache_hit}, adapted "
          f"{s['tasks_adapted']}, logits vs a cold engine {rel:.3e} (tol {LOGIT_TOL:.0e})",
          flush=True)
    if plan.fired_count(WARM_CORRUPT) != 1 or s["quarantined"] != 1 or repeat.cache_hit \
            or s["tasks_adapted"] != 4 or not repeat.done or rel > LOGIT_TOL:
        fail("serve_warm: the corrupt warm entry was not quarantined and re-adapted")
    plan = FaultPlan.single(WARM_VANISH)
    eng = warm_engine(learner, params, dev, cache_capacity=2, fault_plan=plan,
                      warm_dir=warm_root / "vanish")
    reqs = eng.run_to_completion(make([0, 1, 2, 3]) + make([0], support=True))
    s = eng.stats()
    print(f"serve_warm warm.vanish: spill_errors {s['spill_errors']}, spills {s['spills']}, "
          f"served {sum(r.done for r in reqs)}/{len(reqs)}", flush=True)
    if s["spill_errors"] != 1 or not all(r.done for r in reqs) or s["rehydrates"] != 0:
        fail("serve_warm: the vanished warm directory was not survived as one spill error")
    return dict(corrupt=dict(quarantined=corrupt["quarantined"], logits_rel=rel),
                vanish=dict(spill_errors=s["spill_errors"]))


def run_serve_launcher(slo_us):
    """``python -m repro_torch.launch.serve --episodic`` with a warm
    directory of its own, an L1 of 2, an SLO, a bounded queue and a
    deadline, on the card as a subprocess; its ``store:`` line must show
    spills and rehydrates."""
    import re
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_warm_") as warm_dir:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--episodic", "--learner",
               "simple_cnaps", "--serve-quant", "int8", "--requests", "16",
               "--warm-dir", warm_dir, "--cache-capacity", "2",
               "--query-slo-us", str(slo_us), "--max-queue", "64", "--deadline-us", "1e8"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        secs = time.perf_counter() - t0
    m = re.search(r"spills=(\d+) rehydrates=(\d+)", proc.stdout)
    store = [l.strip() for l in proc.stdout.splitlines() if "store:" in l]
    print(f"serve launcher: exit {proc.returncode} in {secs:.1f} s; "
          f"{store[-1] if store else proc.stdout[-500:]}", flush=True)
    if proc.returncode != 0 or not m or int(m[1]) < 1 or int(m[2]) < 1 \
            or "device=cuda" not in proc.stdout:
        fail(f"the serving launcher failed (exit {proc.returncode}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return dict(cmd=cmd[1:], exit=proc.returncode, seconds=secs, spills=int(m[1]),
                rehydrates=int(m[2]))


def run_serve_warm(dev, launches):
    """Phase 4b at phase 4's width (Simple CNAPs, int8 backbone, 224 px):
    the warm tier, FOMAML's state, the scheduler, the warm faults and the
    launcher, each failing the run unless its check holds."""
    import pathlib as _pl
    import tempfile
    t0 = time.perf_counter()
    learner, params = build_model("simple_cnaps", dev)
    make = warm_traffic(dev)
    out = dict(kind="serve_warm")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_warm_") as tmp:
        root = _pl.Path(tmp)
        out["tier"] = warm_tier_run(learner, params, dev, make, root / "tier", launches)
        wave_ms = out["tier"]["warm"][0]["adapt_wave_ms"]
        out["fomaml"] = fomaml_warm_check(dev, make, root / "fomaml")
        out["scheduling"] = scheduling_check(learner, params, dev, make, wave_ms, root)
        out["faults"] = warm_faults_check(learner, params, dev, make, root)
        defer(out, "launcher", run_serve_launcher, round(1.5 * wave_ms * 1e3))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 4b: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4c: multi-replica serving and the serving layouts
# ---------------------------------------------------------------------------

REPLICA_UIDS = (0, 1, 2, 3, 4, 5)        # homed on both of 2 replicas
REPLICA_REPEATS = (0, 1)
REPLICA_RANK_TIMEOUT = 400.0
REPLICA_LAYOUTS = ("training", "weight_stationary", "replicated")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN picks deterministic algorithms inside, as it did before after."""
    import torch
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was


def replica_model(dev):
    """Phase 4's Simple CNAPs (seed 0), phase 4b's traffic maker, and phase
    4b's engine keywords."""
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import plan_buckets
    learner, params = build_model("simple_cnaps", dev)
    kw = dict(lite=LiteSpec(exact=True, chunk_size=32), n_slots=4, query_chunk=8,
              support_buckets=plan_buckets([50]), kernel_backend="cuda",
              clock=time.perf_counter, device=dev, serve_quant="int8")
    return learner, params, warm_traffic(dev), kw


def replica_requests(make):
    return make(REPLICA_UIDS) + make(REPLICA_REPEATS, support=False)


def _logits_err(got, want) -> float:
    """max |got - want| over max |want| of each request, the largest."""
    import numpy as np
    return max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))


def _same_bits(got, want) -> bool:
    import numpy as np
    return len(got) == len(want) and all(a.shape == b.shape and np.array_equal(a, b)
                                         for a, b in zip(got, want))


def _failover_uids():
    """Three uids of the 12 users homed on replica 1 of 2, and one more to
    evict the last of them from its L1 of 1."""
    from repro_torch.serve.replica import uid_replica
    ones = [u for u in range(WARM_USERS) if uid_replica(u, 2) == 1]
    return ones[:3], ones[3]


def replica_failover(learner, params, make, kw, warm_dir, mesh=None, layout=None):
    """The JAX package's failover test at full width: three users homed on
    replica 1 spill (an L1 of 1), ``replica.dead`` fires at 1, their
    support-less repeats reroute to replica 0 and rehydrate there.  Returns
    the counters and whether every repeat's logits are its first run's
    bits."""
    from repro_torch.faults import REPLICA_DEAD, FaultPlan
    from repro_torch.serve.replica import ReplicatedServeEngine
    u1, evict = _failover_uids()
    router = ReplicatedServeEngine(learner, params, replicas=2, mesh=mesh, warm_dir=warm_dir,
                                   serve_layout=layout, **dict(kw, cache_capacity=1))
    first = router.run_to_completion(make(u1))
    router.run_to_completion(make([evict]))
    router.fault_plan = FaultPlan.single(REPLICA_DEAD, at=1)
    repeats = router.run_to_completion(make(u1, support=False))
    s = router.stats()
    return dict(replica_failovers=s["replica_failovers"], live=s["live_replicas"],
                rerouted=s["rerouted_requests"], failover_failed=s["failover_failed"],
                rehydrates=s["rehydrates"], tasks_adapted=s["tasks_adapted"],
                served=all(r.done and not r.failed for r in repeats),
                bit_equal=_same_bits([r.all_logits() for r in repeats],
                                     [r.all_logits() for r in first]),
                fired=[list(f) for f in router.fault_plan.fired])


def failover_ok(f, n: int = 3) -> bool:
    return (f["replica_failovers"] == 1 and f["live"] == 1 and f["rerouted"] == n
            and f["failover_failed"] == 0 and f["served"] and f["bit_equal"]
            and f["tasks_adapted"] == n + 1 and f["rehydrates"] >= n)


def serve_rank_nccl1(out_dir):
    """Phase 4c (b), one rank on NCCL: the router on a (1, 1) replica mesh
    under each layout, bit-equal to the solo engine in this process."""
    from repro_torch.kernels import _build
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_replica_mesh
    from repro_torch.serve.episodic import EpisodicServeEngine
    from repro_torch.serve.replica import ReplicatedServeEngine
    dev = init_distributed("cuda", backend="nccl", init_method=os.environ["RANKS_INIT_METHOD"])
    mesh = make_replica_mesh(1, 1)
    learner, params, make, kw = replica_model(dev)
    solo = EpisodicServeEngine(learner, params, **kw).run_to_completion(replica_requests(make))
    want = [r.all_logits() for r in solo]
    out = dict(backend=mesh.backend, device=str(dev))
    for layout in REPLICA_LAYOUTS:
        router = ReplicatedServeEngine(learner, params, replicas=1, mesh=mesh,
                                       serve_layout=layout, **kw)
        _build.launches.reset()
        collectives.counter.reset()
        got = router.run_to_completion(replica_requests(make))
        out[layout] = dict(bit_equal=_same_bits([r.all_logits() for r in got], want),
                           launches=_build.launches.snapshot(),
                           collectives=collectives.counter.snapshot())
    return out


def serve_rank_gloo4(out_dir):
    """Phase 4c (c), one of 4 ranks on gloo sharing the card as 2 replicas x
    2: the router under each layout against (a)'s solo logits, the two
    ranks of a group, B1-B4 and B4's K, one engine step's payloads, a
    dropped partial product, ``replica.dead`` on group 1, the chooser."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.core.episodic import stack_task_states
    from repro_torch.kernels import _build, dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_replica_mesh
    from repro_torch.roofline import choose_replica_serving_layout, serving_payloads
    from repro_torch.serve import quant_params
    from repro_torch.serve.episodic import EpisodicServeEngine
    from repro_torch.serve.replica import ReplicatedServeEngine
    dev = init_distributed("cuda", backend="gloo", init_method=os.environ["RANKS_INIT_METHOD"])
    mesh = make_replica_mesh(2, 2)
    own = mesh.coords["replica"]
    learner, params, make, kw = replica_model(dev)
    with np.load(os.path.join(out_dir, "solo.npz")) as z:
        want = [z[str(i)] for i in range(len(z.files))]
    ks = []
    plain = dispatch._im.int8_matmul

    def recorded(x, q, scale):
        ks.append(int(x.shape[1]))
        return plain(x, q, scale)

    dispatch._im.int8_matmul = recorded
    out = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev), backend=mesh.backend)

    def run(layout):
        router = ReplicatedServeEngine(learner, params, replicas=2, mesh=mesh,
                                       serve_layout=layout, **kw)
        reqs = replica_requests(make)
        for r in reqs:
            router.submit(r)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        while router.busy:
            router.step()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        mine = b"".join(r.all_logits().tobytes() for i, r in enumerate(reqs)
                        if router._home[i] == own)
        router.sync_results()
        return [r.all_logits() for r in reqs], hashlib.sha256(mine).hexdigest()[:16], ms

    sw = quant_params.quantize_frozen(learner, params, "int8")
    cap = kw["support_buckets"][-1]
    for layout in REPLICA_LAYOUTS:
        _build.launches.reset()
        collectives.counter.reset()
        ks.clear()
        got, digest, ms = run(layout)
        row = dict(err=_logits_err(got, want), own_digest=digest, ms=ms,
                   launches=_build.launches.snapshot(), ks=sorted(set(ks)),
                   collectives=collectives.counter.snapshot(),
                   finite=all(bool(np.isfinite(g).all()) for g in got))
        # one step of a group's engine: one adapt and one predict dispatch
        eng = EpisodicServeEngine(learner, params, mesh=mesh, serve_layout=layout, **kw)
        for r in make(REPLICA_UIDS[:kw["n_slots"]]):
            eng.submit(r)
        collectives.counter.reset()
        eng.step()
        payload = collectives.counter.payload()
        expect = serving_payloads(sw, layout, 2, kw["n_slots"], cap, dispatch="adapt", way=5,
                                  chunk=kw["lite"].chunk_size)
        for k, v in serving_payloads(sw, layout, 2, kw["n_slots"], kw["query_chunk"]).items():
            expect[k] = expect.get(k, 0) + v
        row.update(payload=payload, want_payload=expect,
                   dispatches=[eng.adapt_dispatches, eng.predict_dispatches])
        out[layout] = row
    # a planted fault: group 0's rank 1 drops its partial product from the sum
    summed = quant_params._sum_over_group

    def dropped(mesh_, axis, t):
        if mesh_.coords == {"replica": 0, "serve": 1}:
            t.zero_()
        return summed(mesh_, axis, t)

    quant_params._sum_over_group = dropped
    try:
        got, _, _ = run("weight_stationary")
    finally:
        quant_params._sum_over_group = summed
    out["planted"] = dict(err=_logits_err(got, want))
    dispatch._im.int8_matmul = plain
    out["failover"] = replica_failover(learner, params, make, kw,
                                       os.path.join(out_dir, "warm"), mesh=mesh)
    # the chooser on group 0, over two adapted tasks' first query chunk
    probe = EpisodicServeEngine(learner, params, **kw)
    probe.run_to_completion(make(REPLICA_UIDS[:2]))
    states = stack_task_states([probe.store.l1.peek(u) for u in REPLICA_UIDS[:2]])
    qx = torch.stack([torch.from_numpy(r.query_x[:kw["query_chunk"]])
                      for r in make(REPLICA_UIDS[:2])]).to(dev)

    def predict(w, st, q):
        with dispatch.use_backend("cuda"):
            return learner.predict_batch(quant_params.serving_params(w), st, q)

    pick = choose_replica_serving_layout(predict, sw, (states, qx), mesh)
    out["chooser"] = dict(choice=pick["choice"],
                          per_replica_wire_bytes=pick["per_replica_wire_bytes"],
                          rows={k: {c: v[c] for c in ("wire_bytes", "collective_count",
                                                      "t_compute", "t_memory",
                                                      "t_collective", "bottleneck", "score")}
                                for k, v in pick["rows"].items()})
    return out


def serve_rank_main(which: str, out_dir: str) -> int:
    """One rank of phase 4c, run as ``python chip_smoke.py --serve-rank
    <nccl1|gloo4> <dir>`` with the rank's environment; writes its reading
    to ``<dir>/<which>_rank<r>.json``."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False      # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    with deterministic_cudnn():
        out = {"nccl1": serve_rank_nccl1, "gloo4": serve_rank_gloo4}[which](out_dir)
    with open(os.path.join(out_dir, f"{which}_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def serve_ranks(which: str, world: int, tmp):
    """Run the ranks of ``which`` and return their readings, rank order."""
    from repro_torch.launch.local_ranks import RanksFailed, run_ranks
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **DP_ENV}
    t0 = time.perf_counter()
    try:
        run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--serve-rank", which,
                   str(tmp)], world, os.path.join(tmp, f"store_{which}"), env=env, cwd=ROOT,
                  timeout=REPLICA_RANK_TIMEOUT)
    except RanksFailed as e:
        fail(f"phase 4c {which}: {e}")
    secs = time.perf_counter() - t0
    return [json.loads(pathlib.Path(tmp, f"{which}_rank{r}.json").read_text())
            for r in range(world)], secs


def run_replica_launcher():
    """``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve
    --episodic --replicas 2 --serve-layout auto --serve-quant int8`` on gloo
    on the card: it must exit 0 and print world=4, the layout rows and
    both replicas."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replica_launcher_") as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", "-m", "repro_torch.launch.serve", "--episodic",
               "--learner", "simple_cnaps", "--serve-quant", "int8", "--replicas", "2",
               "--serve-layout", "auto", "--dist-backend", "gloo", "--requests", "16",
               "--warm-dir", tmp, "--cache-capacity", "2"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        secs = time.perf_counter() - t0
    said = proc.stdout
    lines = [l.strip() for l in said.splitlines()
             if "layout=" in l or "replicas:" in l or "layout " in l]
    print(f"replica launcher (torchrun, 4 ranks, gloo, --replicas 2 --serve-layout auto): "
          f"exit {proc.returncode} in {secs:.1f} s; {' | '.join(lines)}", flush=True)
    if proc.returncode != 0 or "world=4" not in said or "replicas: 2/2 live" not in said \
            or "device=cuda" not in said or "layout weight_stationary" not in said:
        fail(f"the replica launcher failed (exit {proc.returncode}):\n{said[-2000:]}\n"
             f"{proc.stderr[-2000:]}")
    return dict(cmd=cmd[1:], exit=proc.returncode, seconds=secs, lines=lines)


def run_serve_replica(dev, launches):
    """Phase 4c, with cuDNN deterministic (the later phases' timings keep
    its settings as they were)."""
    with deterministic_cudnn():
        return _run_serve_replica(dev, launches)


def _run_serve_replica(dev, launches):
    """Phase 4c: (a) the router in this process; (b) one NCCL rank; (c) 4
    gloo ranks as 2 replicas x 2; (d) the launcher under torchrun,
    deferred."""
    import tempfile
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve.episodic import EpisodicServeEngine
    from repro_torch.serve.replica import ReplicatedServeEngine
    t_phase = time.perf_counter()
    learner, params, make, kw = replica_model(dev)
    out = dict(kind="serve_replica", users=len(REPLICA_UIDS), repeats=len(REPLICA_REPEATS))
    solo = EpisodicServeEngine(learner, params, **kw).run_to_completion(replica_requests(make))
    want = [r.all_logits() for r in solo]
    _build.launches.reset()
    router = ReplicatedServeEngine(learner, params, replicas=2, **kw)
    got = router.run_to_completion(replica_requests(make))
    counts = _build.launches.snapshot()
    s = router.stats()
    bit_equal = _same_bits([r.all_logits() for r in got], want)
    print(f"replica (a) 2 replicas in one process: logits bit-equal to the solo engine: "
          f"{bit_equal}; adapted {s['tasks_adapted']}, per replica "
          f"{[p['tasks_adapted'] for p in s['per_replica']]}; launches {counts}", flush=True)
    if not bit_equal or s["tasks_adapted"] != len(REPLICA_UIDS):
        fail("phase 4c (a): the router is not bit-equal to the solo engine")
    _need("replica (a) router", counts,
          ("segment_sum", "class_second_moment", "mahalanobis", "int8_matmul"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replica_") as tmp:
        fo = replica_failover(learner, params, make, kw, os.path.join(tmp, "warm_a"))
        print(f"replica (a) replica.dead at 1 over a warm directory: {fo}", flush=True)
        if not failover_ok(fo):
            fail(f"phase 4c (a): the failover did not reroute and rehydrate bit-equal: {fo}")
        np.savez(os.path.join(tmp, "solo.npz"), **{str(i): w for i, w in enumerate(want)})
        del learner, params, router, solo
        (b,), secs_b = serve_ranks("nccl1", 1, tmp)
        c, secs_c = serve_ranks("gloo4", 4, tmp)
    out.update(a=dict(bit_equal=bit_equal, launches=counts, failover=fo), nccl1=b, gloo4=c,
               seconds_b=secs_b, seconds_c=secs_c)
    for layout in REPLICA_LAYOUTS:
        r = b[layout]
        print(f"replica (b) 1 rank on {b['backend']} ({b['device']}), {layout}: bit-equal to "
              f"the solo engine {r['bit_equal']}; collectives {r['collectives']}", flush=True)
        if not r["bit_equal"]:
            fail(f"phase 4c (b): the NCCL world of 1 under {layout} is not bit-equal")
        _need(f"replica (b) {layout}", r["launches"],
              ("segment_sum", "class_second_moment", "mahalanobis", "int8_matmul"))
    for r in c:
        tag = f"replica (c) rank {r['rank']} {r['coords']}"
        for layout in REPLICA_LAYOUTS:
            row = r[layout]
            _need(f"{tag} {layout}", row["launches"],
                  ("segment_sum", "class_second_moment", "mahalanobis", "int8_matmul"))
            if row["err"] > LOGIT_TOL or not row["finite"]:
                fail(f"{tag} {layout}: logits rel err {row['err']:.3e} against (a)'s solo "
                     f"engine (tol {LOGIT_TOL:.0e})")
            peer = c[r["rank"] ^ 1][layout]
            if row["own_digest"] != peer["own_digest"]:
                fail(f"{tag} {layout}: its group's two ranks hold different logits")
            if row["launches"].get("int8_matmul/cp16", 0) != row["launches"]["int8_matmul"]:
                fail(f"{tag} {layout}: int8 matmul launches off the 16-byte copies: "
                     f"{row['launches']}")
            want_k = [128] if layout == "weight_stationary" else [256]
            if row["ks"] != want_k:
                fail(f"{tag} {layout}: B4 ran at K {row['ks']}, not {want_k}")
            if row["payload"] != row["want_payload"] or row["dispatches"] != [1, 1]:
                fail(f"{tag} {layout}: payload {row['payload']} B in dispatches "
                     f"{row['dispatches']}, serving_payloads says {row['want_payload']} B")
            if any(not (k.endswith("/serve") or k.endswith("/host"))
                   for k in row["collectives"]):
                fail(f"{tag} {layout}: a collective outside serve and host: "
                     f"{row['collectives']}")
        print(f"{tag} on {r['device']} ({r['backend']}): "
              + "; ".join(f"{lo} err {r[lo]['err']:.3e}, {r[lo]['ms']:.1f} ms, payload "
                          f"{r[lo]['payload']} B, B4 K {r[lo]['ks']}"
                          for lo in REPLICA_LAYOUTS)
              + f"; planted dropped partial err {r['planted']['err']:.3e}", flush=True)
        if r["planted"]["err"] <= LOGIT_TOL:
            fail(f"{tag}: a partial product dropped from weight_stationary's all-reduce "
                 f"passed the gate ({r['planted']['err']:.3e})")
        if not failover_ok(r["failover"]):
            fail(f"{tag}: replica.dead on group 1: {r['failover']}")
    pick = c[0]["chooser"]
    if any(x["chooser"] != pick for x in c):
        fail("phase 4c (c): the ranks disagree on the chooser's result")
    rows = pick["rows"]
    best = min(v["score"] for v in rows.values())
    if rows["replicated"]["wire_bytes"] != 0 or not (
            0 < rows["weight_stationary"]["wire_bytes"] < rows["training"]["wire_bytes"]) \
            or pick["choice"] != next(lo for lo in REPLICA_LAYOUTS
                                      if rows[lo]["score"] == best):
        fail(f"phase 4c (c): the chooser's rows break its rule: {pick}")
    print(f"replica (c) chooser on group 0: choice {pick['choice']}, per-replica wire "
          f"{pick['per_replica_wire_bytes']} B; rows "
          + "; ".join(f"{lo} wire {v['wire_bytes']:.0f} B, compute {v['t_compute'] * 1e3:.4f} "
                      f"ms, memory {v['t_memory'] * 1e3:.4f} ms, collective "
                      f"{v['t_collective'] * 1e3:.5f} ms ({v['bottleneck']})"
                      for lo, v in rows.items())
          + " (derived from the data-sheet rates, not measured)", flush=True)
    print(f"replica (c) these times are of 4 ranks sharing one H100 over gloo (host-staged), "
          f"not a scaling figure; ranks took {secs_c:.1f} s with their processes' start, "
          f"(b) {secs_b:.1f} s", flush=True)
    launches["serve_replica"] = counts
    defer(out, "launcher", run_replica_launcher)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 4c: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4d: the contract cells on the running program
# ---------------------------------------------------------------------------

CONTRACT_KERNELS = ("segment_sum", "class_second_moment", "mahalanobis", "int8_matmul")


@contextlib.contextmanager
def _planted_rank_violations():
    """A collective on the host group (the world's 4 ranks) inside every
    weight-stationary partial sum, and ``serving_params`` handing the
    dispatch every quantized leaf dequantized to fp32."""
    import dataclasses
    from repro_torch.bridge import HWIO_TO_OIHW
    from repro_torch.common.linear import KSlice
    from repro_torch.optim.quant import dequantize, is_quantized
    from repro_torch.serve import quant_params as qp
    sum_over_group, serving_params = qp._sum_over_group, qp.serving_params

    def wide(mesh, axis, t):
        mesh.any_rank(False)
        return sum_over_group(mesh, axis, t)

    def fp32_copy(sw):
        def visit(path, leaf):
            if isinstance(leaf, KSlice) and is_quantized(leaf.local):
                return dataclasses.replace(leaf, local=dequantize(leaf.local))
            if is_quantized(leaf):
                w = dequantize(leaf)
                return w.permute(*HWIO_TO_OIHW).contiguous() if w.dim() == 4 else w
            return leaf
        return qp._walk(qp.serving_view(sw), visit)

    qp._sum_over_group, qp.serving_params = wide, fp32_copy
    try:
        yield
    finally:
        qp._sum_over_group, qp.serving_params = sum_over_group, serving_params


def contract_rank(argv) -> int:
    """One rank of phase 4d's rank cells, run as ``python chip_smoke.py
    --contract-rank <device> <dir> <cell>...``: each cell as
    ``contracts.rank_main`` runs it, then again with the violations of
    :func:`_planted_rank_violations`, its findings kept in the readings as
    ``planted/<cell>`` (one launch of the ranks for both)."""
    from repro_torch.kernels import _build
    from repro_torch.lint import contracts

    def with_plant(name, cell):
        def run(dev, report):
            msgs = cell(dev, report)
            counts = _build.launches.snapshot()
            with _planted_rank_violations():
                report[f"planted/{name}"] = cell(dev, {})
            _build.launches.reset()                 # the planted run's launches do not count
            _build.launches._counts.update(counts)
            return msgs
        return run

    for name in contracts.RANK_CELLS:
        contracts.CELLS[name] = with_plant(name, contracts.CELLS[name])
    return contracts.rank_main(list(argv))


def _per_example_second_moment(f, weights, accum_dtype=None, backend=None):
    """The class second moment through the per-example (T, B, F, F) outer
    product: what ``lite_outer`` must flag."""
    import torch
    return torch.einsum("tbc,tbij->tcij", weights.to(f.dtype),
                        torch.einsum("tbi,tbj->tbij", f, f))


def _planted_contracts(C, report):
    """Each cell with its violation planted: {cell: findings}; the rank
    cells' came back with their readings (:func:`contract_rank`)."""
    from repro_torch.kernels import dispatch
    from repro_torch.serve import episodic
    caught = {name: report.pop(f"planted/{name}") for name in C.RANK_CELLS}
    bucket_for = episodic.bucket_for
    episodic.bucket_for = lambda n, buckets: n
    try:
        caught["compile_flat"] = [f.message for f in C.run_cells(["compile_flat"], "cuda")]
    finally:
        episodic.bucket_for = bucket_for
    second_moment = dispatch.class_second_moment
    dispatch.class_second_moment = _per_example_second_moment
    try:
        caught["lite_outer"] = [f.message for f in C.run_cells(["lite_outer"], "cuda",
                                                               C.LITE_OUTER_FULL)]
    finally:
        dispatch.class_second_moment = second_moment
    return caught


def run_contracts(dev, launches):
    """Phase 4d: the four contract cells of ``repro_torch.lint.contracts``
    on the card (``lite_outer`` at full width: phase 5's Simple CNAPs, 256
    features, 224 px, 8 tasks, LITE h 8; the rank cells on 4 gloo ranks
    sharing it), none of which may give a finding, B1-B4 launched by them;
    then each cell with its violation planted, each of which must."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.lint import contracts as C
    t_phase = time.perf_counter()
    report = {}
    torch.cuda.synchronize()
    _build.launches.reset()
    worker = C.worker_argv
    C.worker_argv = lambda: [sys.executable, str(ROOT / "chip_smoke.py"), "--contract-rank"]
    try:
        findings = C.run_cells(None, "cuda", C.LITE_OUTER_FULL, report=report)
    finally:
        C.worker_argv = worker
    torch.cuda.synchronize()
    counts = _build.launches.snapshot()
    for k, v in report.pop("rank_launches", {}).items():
        counts[k] = counts.get(k, 0) + v
    for f in findings:
        print(f"contracts: {f.format()}", flush=True)
    if findings:
        fail(f"phase 4d: {len(findings)} contract finding(s) on the card")
    lite = report["lite_outer"]
    print(f"contracts: no finding in {list(C.CELLS)} on the card; replica_2x2 widths "
          f"{report['replica_2x2']['widths']}, payload {report['replica_2x2']['payload']}; "
          f"int8_ws payloads {report['int8_ws']['payload']}, handed {report['int8_ws']['handed']}"
          f", frozen {report['int8_ws']['param_bytes']['frozen_resident_bytes']} B of "
          f"{report['int8_ws']['param_bytes']['frozen_fp32_bytes']} fp32; compile_flat "
          f"{report['compile_flat']}; lite_outer at full width: the largest (.., F, F) "
          f"tensor {lite['largest']} of {lite['recorded']} recorded, budget "
          f"{lite['budget']}; launches {counts}", flush=True)
    _need("phase 4d contract cells", counts, CONTRACT_KERNELS)
    t_clean = time.perf_counter() - t_phase
    caught = _planted_contracts(C, report)
    for name, msgs in caught.items():
        print(f"contracts: planted {name}: {len(msgs)} finding(s): {msgs[:2]}", flush=True)
        if not msgs:
            fail(f"phase 4d: the violation planted in {name} gave no finding")
    if not any("all_reduce/host ran on a group of 4" in m for m in caught["replica_2x2"]):
        fail(f"phase 4d: replica_2x2 did not name the host-group collective: "
             f"{caught['replica_2x2']}")
    if not any("no int8 leaf" in m for m in caught["int8_ws"]):
        fail(f"phase 4d: int8_ws did not flag the fp32 copy: {caught['int8_ws']}")
    launches["contracts"] = counts
    out = dict(kind="contracts", report=report, launches=counts, planted=caught,
               seconds=time.perf_counter() - t_phase)
    print(f"phase 4d: {out['seconds']:.1f} s ({t_clean:.1f} s the cells and the ranks' "
          f"planted cells, the rest the planted compile_flat and lite_outer)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 1c: the dry run of the sharded LM train step on fake worlds
# ---------------------------------------------------------------------------

DRYRUN_MESHES = ("single", "multi")
# every shape of each arch in one process a mesh: kimi-k2 and deepseek-v2
# (kimi-k2's train cell traced in 81-95 s, deepseek-v2's in 27 s, their
# prefill and decode cells in 10-30 s each), and the other eight; a fifth
# process traces deepseek-v2's prefill_32k on ``single`` under the
# ``baseline`` variant
DRYRUN_SPLIT = (("kimi-k2-1t-a32b", "deepseek-v2-236b"),
                ("phi-3-vision-4.2b", "mamba2-780m", "minicpm-2b", "minitron-4b", "qwen2-72b",
                 "gemma2-2b", "zamba2-7b", "whisper-base"))
DRYRUN_BASELINE = ("deepseek-v2-236b", "prefill_32k", "single")
DRYRUN_TIMEOUT = 900.0
DRYRUN_PROCS = []
# whisper-base's train_4k on single traced with 16 rows a chip, replicated
# over model, as it was before the dry run read tp_enabled=False
DRYRUN_WHISPER_REPLICATED = 5.3242e13


def _stop_dryrun() -> None:
    for proc, _, _ in DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_dryrun() -> list:
    """Phase 1c's five host processes (``python -m repro_torch.launch.dryrun
    --mesh <m> --arch ... --force``, every shape of each mesh's archs in
    the two groups of ``DRYRUN_SPLIT``, and ``DRYRUN_BASELINE`` under
    ``--variant baseline``), started now so that they run beside the card's
    phases, at the lowest priority, so that the phases' host threads keep
    their cores; no card is visible to them."""
    import atexit
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    atexit.register(_stop_dryrun)
    runs = [(f"{mesh}_{i}", ["--mesh", mesh] + [a for arch in archs for a in ("--arch", arch)])
            for mesh in DRYRUN_MESHES for i, archs in enumerate(DRYRUN_SPLIT)]
    arch, shape, mesh = DRYRUN_BASELINE
    runs.append(("baseline", ["--arch", arch, "--shape", shape, "--mesh", mesh, "--variant",
                              "baseline"]))
    for name, args in runs:
        out, log = out_dir / f"{name}.json", out_dir / f"{name}.log"
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(out), "--force"]
            + args, cwd=ROOT, env=env, stdout=open(log, "w"), stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(19))
        DRYRUN_PROCS.append((proc, out, log))
    return DRYRUN_PROCS


def check_dryrun(procs) -> dict:
    """Phase 1c's check, deferred: every admitted cell of every shape on both
    meshes recorded ``ok``, a train cell's payloads equal to
    ``roofline.lm_step_payloads`` (under the batch axes the record names:
    whisper-base's ``train_4k`` on ``single`` pure data parallel), a
    prefill or decode cell's to ``roofline.lm_serve_payloads``;
    deepseek-v2's prefill_32k on ``single`` handing its collectives at
    least 3x fewer wire bytes than under ``baseline``; prints
    ``format_markdown(load_table(..))`` and each cell's FLOPs a chip beside
    the analytic mesh row's."""
    from repro_torch import roofline as R
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
    t0 = time.perf_counter()
    merged, baseline = {}, None
    for proc, out, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - T_START)))
        except subprocess.TimeoutExpired:
            _stop_dryrun()
            fail(f"phase 1c: the dry run ({out.name}) ran past {DRYRUN_TIMEOUT:.0f} s")
        said = pathlib.Path(log).read_text()
        if rc != 0:
            fail(f"phase 1c: the dry run ({out.name}) exited {rc}: {said[-3000:]}")
        recs = json.loads(out.read_text())
        if out.name == "baseline.json":
            baseline = recs["/".join(DRYRUN_BASELINE)]
        else:
            merged.update(recs)
        print(f"dry run ({out.name}) ended {said.strip().splitlines()[-1]}", flush=True)
    path = ROOT / "build" / "dryrun" / "both.json"
    path.write_text(json.dumps(merged, indent=1))
    cells, lines = [], []
    for mesh in DRYRUN_MESHES:
        sizes = R.PRODUCTION_MESHES[mesh]
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in SHAPES:
                key = f"{arch}/{shape.name}/{mesh}"
                rec = merged.get(key)
                if not cell_supported(arch, shape.name)[0]:
                    if rec is None or rec.get("status") != "skipped":
                        fail(f"phase 1c: {key}: {rec and rec.get('status')}, not skipped")
                    continue
                if rec is None or rec.get("status") != "ok":
                    fail(f"phase 1c: {key}: {rec and rec.get('status')}")
                b, s = shape.global_batch, shape.seq_len
                if shape.kind == "train":
                    bax = tuple(rec["batch_axes"]) if rec.get("batch_axes") else None
                    want = R.lm_step_payloads(cfg, sizes, b, s, batch_axes=bax)
                else:
                    want = R.lm_serve_payloads(cfg, sizes, b, s, shape.kind)
                if rec["collectives"] != want:
                    fail(f"phase 1c: {key}: payloads {rec['collectives']} against the "
                         f"roofline's {want}")
                row = R.analyze_cell(arch, shape.name, mesh)
                analytic = row["model_flops"] / row["chips"] / row["useful_ratio"]
                ratio = rec["flops_per_device"] / analytic
                bmm = rec["flops_by_op"].get("aten.bmm", 0) / max(rec["flops_per_device"], 1)
                cells.append(dict(key=key, program=rec["flops_per_device"], analytic=analytic,
                                  ratio=ratio, bmm_share=bmm, trace_s=rec["trace_s"],
                                  bytes=rec["bytes_per_device"],
                                  state=rec["state_bytes_per_device"],
                                  wire=R.collective_wire_bytes(rec["collectives"], sizes)))
                lines.append(f"| {arch} | {shape.name} | {mesh} | {rec['flops_per_device']:.4e} "
                             f"| {analytic:.4e} | {ratio:.4f} | {bmm:.3f} | "
                             f"{rec['state_bytes_per_device']:.4e} | {rec['trace_s']:.1f} |")
    whisper = merged["whisper-base/train_4k/single"]
    w_ratio = whisper["flops_per_device"] / (DRYRUN_WHISPER_REPLICATED / 16)
    print(f"dry run: whisper-base/train_4k/single batch over {whisper['batch_axes']}, "
          f"{whisper['flops_per_device']:.4e} FLOPs a chip, {w_ratio:.4f} of 1/16 of the "
          f"replicated {DRYRUN_WHISPER_REPLICATED:.4e}; collectives "
          f"{sorted(whisper['collectives'])}", flush=True)
    if abs(w_ratio - 1) > 0.1 or whisper["batch_axes"] != ["data", "model"]:
        fail(f"phase 1c: whisper-base/train_4k/single is not pure data parallel: {w_ratio}")
    sizes = R.PRODUCTION_MESHES[DRYRUN_BASELINE[2]]
    opt = merged["/".join(DRYRUN_BASELINE)]
    wires = {v: R.collective_wire_bytes(r["collectives"], sizes)
             for v, r in (("baseline", baseline), ("optimized", opt))}
    print(f"dry run: {'/'.join(DRYRUN_BASELINE)} collective wire bytes, optimized "
          f"{wires['optimized']:.4e} against baseline {wires['baseline']:.4e} "
          f"({wires['baseline'] / wires['optimized']:.2f}x; want at least 3x); payloads "
          f"baseline {baseline['collectives']}, optimized {opt['collectives']}", flush=True)
    if not wires["optimized"] * 3 < wires["baseline"]:
        fail(f"phase 1c: the expert-parallel MoE moves {wires}, not 3x under the baseline")
    for mesh in DRYRUN_MESHES:
        print(f"dry run ({mesh}, {R.PRODUCTION_MESHES[mesh]}): the roofline of one rank's "
              f"traced step (FLOPs and payloads counted on the program, bytes its eager "
              f"unfused traffic, the ref backend, on the host), derived, not measured:",
              flush=True)
        print(R.format_markdown(R.load_table(path, mesh)), flush=True)
    print("dry run: FLOPs a chip, the program's against the analytic mesh row's "
          "(cell_rows(mesh)):\n| arch | shape | mesh | program | analytic | ratio | bmm share | "
          "state B a chip | trace s |\n|---|---|---|---|---|---|---|---|---|\n"
          + "\n".join(lines), flush=True)
    print(f"phase 1c: {len(cells)} cells, payloads equal to the roofline's; waited "
          f"{time.perf_counter() - t0:.1f} s at the end", flush=True)
    return dict(cells=cells, baseline_wire=wires, whisper_ratio=w_ratio)


# ---------------------------------------------------------------------------
# phase 5: LITE episodic meta-training on the kernels
# ---------------------------------------------------------------------------

TRAIN_TASKS = 8                              # tasks_per_step
TRAIN_LITE = dict(h=8, chunk_size=16)
TRAIN_STEPS = 5
# phase 5's loop on the numpy host sampler, each 224 px batch about 8 s of
# host time: 3 steps (5 before phase 5h; the device sampler's loop of 5b
# keeps TRAIN_STEPS)
HOST_LOOP_STEPS = 3
# the CPU tests' tolerances (tests/test_torch_train_learners.py and
# test_torch_train_step.py), each relative to the leaf's max|ref|: the
# kernel path against the plain path on the same card
TRAIN_TOL = {"protonets": dict(loss=1e-4, grad=1e-4, params=1e-4),
             "simple_cnaps": dict(loss=4e-3, grad=5e-2, params=5e-2)}


@functools.lru_cache(maxsize=None)
def host_train_batch(t: int, step: int):
    """Step ``step``'s T tasks from the host sampler, the JAX launcher's task
    shape (5-way, 10 shot, 6 queries a class), in host memory.  A pure
    function of its arguments, so drawn once for all the callers that ask
    again (a 224 px batch of T 8 takes about 7 s); ``__wrapped__`` draws
    afresh where the draw is timed."""
    from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
    cfg = HostEpisodicConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
    return host_task_batch_at(17, cfg, t, step)


def train_batch(t: int, step: int, dev):
    """:func:`host_train_batch` on ``dev``."""
    return host_train_batch(t, step).to(dev)


def meta_grads(learner, params, batch, scores, backend, lite=None):
    """(loss, accuracy, grads) of the task-mean LITE loss on ``backend``."""
    from repro_torch.core.episodic_train import make_batched_meta_grads
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import dispatch
    with dispatch.use_backend(backend):
        return make_batched_meta_grads(learner, LiteSpec(**(lite or TRAIN_LITE)))(
            params, batch, scores)


def leaf_errors(got, want):
    """{path: max|got - want| / max|want|}; a leaf whose reference is zero
    everywhere reads its own max|got| (which must then be zero too)."""
    from repro_torch.common.tree import tree_paths
    g, w = tree_paths(got), tree_paths(want)
    out = {}
    for k, b in w.items():
        a, scale = g[k].float(), float(b.abs().max())
        out[k] = float((a - b.float()).abs().max()) / scale if scale > 0 else \
            float(a.abs().max())
    return out


def one_update(params, grads):
    """The train step's update on given grads: global-norm clip, AdamW from
    a fresh state (MetaTrainConfig's lr and clip)."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.clip import clip_by_global_norm
    cfg = AdamWConfig(weight_decay=0.0)
    clipped, _ = clip_by_global_norm(grads, 10.0)
    return adamw_update(params, clipped, adamw_init(params, cfg), 1e-3, cfg)[0]


def update_errors(params, g_got, g_want, grad_tol: float):
    """The params after one update from each gradient: the worst leaf's
    max|difference| over its max|param|, over the elements whose reference
    gradient exceeds ``grad_tol`` of its leaf's largest.  AdamW's first
    update is about lr * sign(g), so an element whose gradient is below the
    gradient check's own resolution may move by lr either way; those are
    counted and left out.  Returns (error, elements left out)."""
    from repro_torch.common.tree import tree_paths
    a, b = tree_paths(one_update(params, g_got)), tree_paths(one_update(params, g_want))
    gw = tree_paths(g_want)
    worst, left_out = 0.0, 0
    for k, pw in b.items():
        g = gw[k].float().abs()
        keep = g > grad_tol * float(g.max())
        left_out += int((~keep).sum()) - int((g == 0).sum())
        if keep.any():
            diff = float((a[k].float() - pw.float()).abs()[keep].max())
            worst = max(worst, diff / max(float(pw.abs().max()), 1e-30))
    return worst, left_out


def grad_check(kind, got, want):
    """Hold (loss, grads) of the kernel path to the plain path's: the worst
    leaf's error, and the leaves the reference trains that come out all
    zero.  Returns the reading; ``ok`` says whether it passes."""
    tol = TRAIN_TOL[kind]
    errs = leaf_errors(got[2], want[2])
    from repro_torch.common.tree import tree_paths
    ref = tree_paths(want[2])
    dead = [k for k, b in ref.items() if float(b.abs().max()) > 0
            and float(tree_paths(got[2])[k].abs().max()) == 0]
    worst = max(errs, key=errs.get)
    loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    ok = loss_err <= tol["loss"] and errs[worst] <= tol["grad"] and not dead
    return dict(loss=float(got[0]), ref_loss=float(want[0]), loss_err=loss_err,
                grad_err=errs[worst], worst_leaf=worst, dead_leaves=dead, ok=ok,
                leaf_errors=errs)


def _sync(batch):
    import torch
    if batch.support_x.is_cuda:
        torch.cuda.synchronize(batch.support_x.device)


def train_parity(kind, learner, params, batch, scores):
    """One LITE step's loss and gradients on the kernels (counts read from
    exactly that step) and on ``ref``, from the same params, tasks and
    scores, then one clipped AdamW update from each; returns the reading and
    both results."""
    from repro_torch.kernels import _build
    meta_grads(learner, params, batch, scores, "cuda")       # cuDNN / allocator warm-up
    _sync(batch)
    _build.launches.reset()
    got = meta_grads(learner, params, batch, scores, "cuda")
    _sync(batch)
    counts = _build.launches.snapshot()
    want = meta_grads(learner, params, batch, scores, "ref")
    r = grad_check(kind, got, want)
    p_err, unresolved = update_errors(params, got[2], want[2], TRAIN_TOL[kind]["grad"])
    r.update(params_err=p_err, params_unresolved=unresolved, launches=counts)
    r["ok"] = r["ok"] and r["params_err"] <= TRAIN_TOL[kind]["params"]
    print(f"train {kind}: T {batch.num_tasks}, loss cuda {r['loss']:.6f} ref "
          f"{r['ref_loss']:.6f} (rel {r['loss_err']:.3e}), accuracy {float(got[1]):.3f}, "
          f"grad err {r['grad_err']:.3e} (worst leaf {r['worst_leaf']}), params err "
          f"after AdamW {r['params_err']:.3e} ({unresolved} elements of unresolved "
          f"sign left out), tol {TRAIN_TOL[kind]}, zero leaves "
          f"{r['dead_leaves']}, launches {counts}", flush=True)
    for k, e in r["leaf_errors"].items():
        print(f"    grad {k:36s} {e:.3e}", flush=True)
    del r["leaf_errors"]
    return r, got, want


@contextlib.contextmanager
def planted_backward(fn_cls, backward):
    """``fn_cls.backward`` replaced by ``backward`` for the block: autograd
    looks the backward up on the class at each call."""
    orig = fn_cls.__dict__["backward"]
    fn_cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn_cls.backward = orig


def _b1_class0_dx_zeroed(ctx, g):
    import torch
    x, w = ctx.saved_tensors
    g = g.float().clone()
    g[:, 0] = 0.0
    return (torch.einsum("tbc,tck->tbk", w.float(), g).to(x.dtype),
            torch.einsum("tbk,tck->tbc", x.float(), g))


def _b2_unsymmetrised(ctx, g):
    import torch
    f, w = ctx.saved_tensors
    f32, w, g = f.float(), w.float(), g.float()
    df = torch.einsum("tbc,tbci->tbi", w, torch.einsum("tcij,tbj->tbci", g, f32))
    return df.to(f.dtype), torch.einsum("tbi,tbci->tbc", f32,
                                        torch.einsum("tcij,tbj->tbci", g, f32))


def _b3_dmu_sign_flipped(ctx, g):
    import torch
    q, mu, sinv = ctx.saved_tensors
    g = g.float()
    diff = q[:, :, None, :] - mu[:, None, :, :]
    u = torch.einsum("tcij,tmcj->tmci", sinv + sinv.transpose(-1, -2), diff)
    gu = g[..., None] * u
    return gu.sum(dim=2), gu.sum(dim=1), torch.einsum("tmc,tmci,tmcj->tcij", g, diff, diff)


def train_planted_faults(runs):
    """Faults planted in the kernels' backwards, each of which the step's
    gradient check must flag: B1's dx zeroed for class 0 (ProtoNets), B2's
    g + g^T symmetrisation dropped and B3's dmu sign flipped (Simple
    CNAPs).  ``runs[kind]`` is (learner, params, batch, scores, ref
    result)."""
    from repro_torch.kernels import dispatch
    readings = []
    for label, kind, fn_cls, backward in (
            ("segment_sum: dx zeroed for class 0", "protonets", dispatch._SegmentSum,
             _b1_class0_dx_zeroed),
            ("class_second_moment: g + g^T symmetrisation dropped", "simple_cnaps",
             dispatch._SecondMoment, _b2_unsymmetrised),
            ("mahalanobis: dmu sign flipped", "simple_cnaps", dispatch._Mahalanobis,
             _b3_dmu_sign_flipped)):
        learner, params, batch, scores, want = runs[kind]
        with planted_backward(fn_cls, backward):
            got = meta_grads(learner, params, batch, scores, "cuda")
        r = grad_check(kind, got, want)
        caught = not r["ok"]
        print(f"planted backward fault {label:52s} grad err {r['grad_err']:.3e} "
              f"(worst leaf {r['worst_leaf']}) tol {TRAIN_TOL[kind]['grad']:.0e} "
              f"{'caught' if caught else 'MISSED'}", flush=True)
        if not caught:
            fail(f"the training gradient check misses the planted fault: {label}")
        readings.append(dict(fault=label, grad_err=r["grad_err"], worst_leaf=r["worst_leaf"],
                             loss_err=r["loss_err"], tol=TRAIN_TOL[kind]["grad"]))
    return readings


def train_loop_run(learner, params, dev, steps: int, tasks: int, ckpt_dir,
                   source: str = "host"):
    """``steps`` steps of the fault-tolerant loop on the kernels, tasks from
    the numpy host sampler or (``source="device"``) the sampler on the
    card; returns the TrainResult."""
    from repro_torch.configs.base import MetaTrainConfig
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import (EpisodicImageConfig, HostEpisodicConfig,
                                           host_task_batch_at, task_batch_at)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_episodic_train_step
    adamw = AdamWConfig(weight_decay=0.0)
    meta = MetaTrainConfig(tasks_per_step=tasks, lite_h=TRAIN_LITE["h"],
                           lite_chunk=TRAIN_LITE["chunk_size"], kernel_backend="cuda")
    step = make_episodic_train_step(learner, LiteSpec(**TRAIN_LITE), meta, adamw)
    state = dict(params=params, opt=adamw_init(params, adamw))
    if source == "device":
        dcfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
        batch_at = lambda s: dict(tasks=task_batch_at(17, dcfg, tasks, s, dev), key=(0, s))
        put = None
    else:
        cfg = HostEpisodicConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
        batch_at = lambda s: dict(tasks=host_task_batch_at(17, cfg, tasks, s), key=(0, s))
        put = lambda b: dict(b, tasks=b["tasks"].to(dev))
    return train(state, step, batch_at, steps, ckpt=CheckpointManager(ckpt_dir, keep=2),
                 ckpt_every=steps, state_template=state, prefetch=2, batch_put=put)


def step_memory(kind, dev, lite):
    """Peak device bytes of one LITE step (``lite``) of ``kind`` on the
    kernels, T 2, after a warm-up step."""
    import torch
    from repro_torch.core.lite import index_scores
    learner, params = build_model(kind, dev)
    batch = train_batch(2, 0, dev)
    scores = index_scores(0, 0, range(2), batch.support_y.shape[1], dev)
    meta_grads(learner, params, batch, scores, "cuda", lite)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = meta_grads(learner, params, batch, scores, "cuda", lite)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del out, learner, params, batch
    torch.cuda.empty_cache()
    return peak, base


TRAIN_CATEGORIES = (   # device kernel name -> what it is, first match wins
    ("B1 segment_sum", ("segment_sum_kernel",)),
    ("B2 class_second_moment", ("second_moment_kernel",)),
    ("B3 mahalanobis", ("mahalanobis",)),
    ("cuSOLVER (Cholesky, inverse)", ("potrf", "potri", "trsm", "trtri", "cusolver",
                                      "lauum", "syrk", "getrf")),
    ("max-pool", ("pool",)),
    # cuDNN's kernels, its NCHW <-> NHWC layout transforms among them
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "fft",
                              "wgrad", "dgrad", "fprop", "nchw", "nhwc")),
    ("GEMMs (einsum, matmul)", ("gemm", "cutlass", "gemv", "dot_kernel", "splitk")),
    ("reductions", ("reduce",)),
    ("copies", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def device_breakdown(fn, categories, header, top: int):
    """One call of ``fn`` under torch.profiler: device busy ms, the device
    time and launches by category (``categories``: name -> substrings of
    a kernel's name, first match wins), and the kernels by device time;
    ``header(busy)`` is printed before the categories and the ``top``
    kernels."""
    from torch.autograd import DeviceType
    rows = profile(fn)
    dev_rows = sorted((r for r in rows if r.device_type == DeviceType.CUDA
                       and _dev_us(r) > 0), key=_dev_us, reverse=True)
    busy = sum(_dev_us(r) for r in dev_rows) / 1e3
    cats = {}
    for r in dev_rows:
        name = r.key.lower()
        cat = next((c for c, keys in categories if any(k in name for k in keys)), "other")
        c = cats.setdefault(cat, dict(device_ms=0.0, launches=0))
        c["device_ms"] += _dev_us(r) / 1e3
        c["launches"] += r.count
    print(header(busy, cats), flush=True)
    for c, v in sorted(cats.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"    {v['device_ms']:9.3f} ms  {100 * v['device_ms'] / busy:5.1f} %  "
              f"x{v['launches']:<5d} {c}", flush=True)
    table = [dict(op=r.key[:90], count=r.count, device_ms=_dev_us(r) / 1e3)
             for r in dev_rows]
    for r in table[:top]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<5d} {r['op']}", flush=True)
    return busy, cats, table


def trace_train_step(step, state, batch, wall_ms: float, top: int = 15):
    """One training step under torch.profiler: device busy time by
    category, the idle share against ``wall_ms`` (the unprofiled step
    time), B1-B3's device time, and the top kernels."""
    busy, cats, table = device_breakdown(
        lambda: step(state, batch), TRAIN_CATEGORIES,
        lambda busy, _: f"  train trace: device busy {busy:.2f} ms of an unprofiled step "
                        f"of {wall_ms:.2f} ms (idle share {1 - busy / wall_ms:.3f})", top)
    return dict(busy_ms=busy, step_wall_ms=wall_ms, idle_share=1 - busy / wall_ms,
                categories=cats, top=table[:40])


def run_training(dev, launches):
    """Phase 5: LITE meta-training on the kernels.  One step of Simple CNAPs
    and of ProtoNets on ``cuda`` against ``ref`` (gradients, and params after
    AdamW); planted backward faults; three Simple CNAPs steps through
    ``train()`` (launch counts set to 0 just before and read just after:
    the training path's counts); one profiled step; the peak memory of a
    LITE step against an exact one; the launcher as a subprocess."""
    import tempfile
    import torch
    from repro_torch.core.lite import LiteSpec, index_scores
    from repro_torch.kernels import _build
    out = dict(kind="train", tasks_per_step=TRAIN_TASKS, lite=TRAIN_LITE,
               image_size=IMAGE_SIZE)
    runs = {}
    for kind in ("simple_cnaps", "protonets"):
        learner, params = build_model(kind, dev)
        batch = train_batch(TRAIN_TASKS, 0, dev)
        scores = index_scores(0, 0, range(TRAIN_TASKS), batch.support_y.shape[1], dev)
        r, got, want = train_parity(kind, learner, params, batch, scores)
        if not r["ok"]:
            fail(f"train {kind}: the kernel path's step disagrees with the ref path's")
        need = ("segment_sum",) + (("class_second_moment", "mahalanobis")
                                   if kind == "simple_cnaps" else ())
        for k in need:
            if r["launches"].get(k, 0) < 1:
                fail(f"train {kind}: kernel {k} was not launched in the differentiated "
                     f"step: {r['launches']}")
        out[f"parity_{kind}"] = r
        runs[kind] = (learner, params, batch, scores, want)
        del got
    out["planted_backward_faults"] = train_planted_faults(runs)
    runs.clear()
    torch.cuda.empty_cache()

    learner, params = build_model("simple_cnaps", dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        torch.cuda.synchronize(dev)
        _build.launches.reset()
        res = train_loop_run(learner, params, dev, HOST_LOOP_STEPS, TRAIN_TASKS, ckpt_dir)
        torch.cuda.synchronize(dev)
        counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in res.metrics_history]
    ms = [1e3 * t for t in res.step_times]
    print(f"train loop simple_cnaps: {HOST_LOOP_STEPS} steps of T {TRAIN_TASKS} at "
          f"{IMAGE_SIZE} px, losses {losses}, ms per step {ms}, tasks/s "
          f"{res.throughput(TRAIN_TASKS, skip=1):.3f} (first step excluded), peak "
          f"memory {peak} B, launches {counts}", flush=True)
    if len(losses) != HOST_LOOP_STEPS or not all(math.isfinite(x) for x in losses) \
            or res.nonfinite_steps or res.rollbacks:
        fail(f"train loop: losses {losses}, skipped steps {res.nonfinite_steps}, "
             f"rollbacks {res.rollbacks}")
    for k in ("segment_sum", "class_second_moment", "mahalanobis"):
        if counts.get(k, 0) < HOST_LOOP_STEPS:
            fail(f"train loop: kernel {k} launched {counts.get(k, 0)} times in "
                 f"{HOST_LOOP_STEPS} steps: {counts}")
    launches["train"] = counts
    out.update(losses=losses, step_ms=ms, tasks_per_s=res.throughput(TRAIN_TASKS, skip=1),
               peak_bytes=peak, launches=counts, steps=HOST_LOOP_STEPS)

    # one more step, timed and then profiled, on the loop's final state
    from repro_torch.configs.base import MetaTrainConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_episodic_train_step
    step = make_episodic_train_step(learner, LiteSpec(**TRAIN_LITE), MetaTrainConfig(
        tasks_per_step=TRAIN_TASKS, kernel_backend="cuda"), AdamWConfig(weight_decay=0.0))
    t0 = time.perf_counter()
    batch = dict(tasks=host_train_batch.__wrapped__(TRAIN_TASKS, HOST_LOOP_STEPS).to(dev),
                 key=(0, HOST_LOOP_STEPS))
    torch.cuda.synchronize(dev)
    out["host_batch_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"  one batch from the host sampler (T {TRAIN_TASKS}, {IMAGE_SIZE} px), moved to "
          f"the card: {out['host_batch_ms']:.1f} ms", flush=True)
    step(res.state, batch)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step(res.state, batch)
    torch.cuda.synchronize(dev)
    out["trace"] = trace_train_step(step, res.state, batch,
                                    (time.perf_counter() - t0) * 1e3)
    del res, step, batch, learner, params
    torch.cuda.empty_cache()

    mem = {}
    for kind in ("simple_cnaps", "protonets"):
        lite_peak, base = step_memory(kind, dev, TRAIN_LITE)
        exact_peak, _ = step_memory(kind, dev, dict(exact=True))
        mem[kind] = dict(lite_peak_bytes=lite_peak, exact_peak_bytes=exact_peak,
                         base_bytes=base)
        print(f"train memory {kind}, T 2: peak of a LITE step (h {TRAIN_LITE['h']}, "
              f"chunk {TRAIN_LITE['chunk_size']}) {lite_peak} B, of an exact step "
              f"{exact_peak} B ({lite_peak / exact_peak:.3f}x); {base} B held before "
              f"the step", flush=True)
        if not lite_peak < exact_peak:
            fail(f"train memory {kind}: LITE's peak {lite_peak} B is not below the exact "
                 f"step's {exact_peak} B")
    out["memory"] = mem

    defer(out, "launcher", run_launcher, ["--data-source", "host"])
    return out


def run_launcher(extra, expect: str = "device=cuda"):
    """``python -m repro_torch.launch.train --episodic`` (3 steps of 2
    tasks, ``extra`` flags) on the card as a subprocess, which must exit 0
    and print ``expect`` and ``device=cuda``; returns its reading."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launcher_") as ckpt_dir:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--episodic", "--steps",
               "3", "--tasks-per-step", "2", *extra, "--ckpt-dir", ckpt_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        secs = time.perf_counter() - t0
    summary = [l for l in proc.stdout.splitlines() if l.startswith("done at step")]
    print(f"train launcher: {' '.join(cmd[1:4] + extra)} ... exit {proc.returncode} in "
          f"{secs:.1f} s; {summary[-1] if summary else proc.stdout[-500:]}", flush=True)
    if proc.returncode != 0 or not summary or "device=cuda" not in proc.stdout \
            or expect not in proc.stdout:
        fail(f"the training launcher failed (exit {proc.returncode}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return dict(cmd=cmd[1:4] + extra, exit=proc.returncode, seconds=secs,
                summary=summary[-1])


# ---------------------------------------------------------------------------
# phase 5b: the rest of single-device meta-training
# ---------------------------------------------------------------------------

FIG4_H = (8, 16, 32)
FIG4_DRAWS = 4
FIG4_TOL = 5e-2
# one update from a fresh state reads no quantized moment, so the int8
# state's params are the fp32 state's to rounding: the CPU test's params
# tolerance (tests/test_torch_sampler_ckpt.py)
INT8_PARAMS_TOL = 1e-6


def _counted(fn):
    """(fn's result, the kernel launches it made, its synchronised ms)."""
    import torch
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.launches.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launches.snapshot(), (time.perf_counter() - t0) * 1e3


def _need(what, counts, kernels, at_least=1):
    for k in kernels:
        if counts.get(k, 0) < at_least:
            fail(f"{what}: kernel {k} launched {counts.get(k, 0)} times (want at least "
                 f"{at_least}): {counts}")


def _peak(fn, dev):
    """(fn's result, the peak device bytes while it ran)."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev)


def max_leaf_err(got, want) -> float:
    return max(leaf_errors(got, want).values())


def device_sampler_check(dev, host_loop):
    """One device batch timed, drawn twice for the same step (bit-equal)
    and once for the next (different); its class patterns' RMS and noise
    std held to the config's; five Simple CNAPs ``train()`` steps on it
    (launches counted on exactly that run) and one profiled step, beside
    phase 5's loop on the host sampler."""
    import tempfile
    import torch
    from repro_torch.configs.base import MetaTrainConfig
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import EpisodicImageConfig, task_batch_at
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_episodic_train_step
    cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
    fields = ("support_x", "support_y", "query_x", "query_y", "support_mask", "query_mask")
    task_batch_at(17, cfg, TRAIN_TASKS, 0, dev)                       # warm-up
    times = []
    for _ in range(5):
        b, _, ms = _counted(lambda: task_batch_at(17, cfg, TRAIN_TASKS, 0, dev))
        times.append(ms)
    again = task_batch_at(17, cfg, TRAIN_TASKS, 0, dev)
    same = all(torch.equal(getattr(b, f), getattr(again, f)) for f in fields)
    differs = not torch.equal(b.support_x, task_batch_at(17, cfg, TRAIN_TASKS, 1, dev).support_x)
    order = torch.argsort(b.support_y, dim=1, stable=True)
    x = torch.stack([b.support_x[t, order[t]] for t in range(TRAIN_TASKS)]).reshape(
        TRAIN_TASKS, cfg.way, cfg.shot, *b.support_x.shape[2:]).double()
    mean = x.mean(dim=2)
    noise_sd = float(torch.sqrt(((x - mean[:, :, None]) ** 2).sum() /
                                (x.numel() - mean.numel())))
    sep = float(torch.sqrt(torch.mean(mean ** 2) - cfg.noise ** 2 / cfg.shot))
    del x, mean, again
    batch_ms = statistics.median(times)
    print(f"device sampler: one batch of T {TRAIN_TASKS} at {IMAGE_SIZE} px {batch_ms:.3f} ms "
          f"(median of 5: {[round(t, 3) for t in times]}; host sampler "
          f"{host_loop['host_batch_ms']:.1f} ms, phase 5); same step bit-equal {same}, next step differs {differs}; class "
          f"pattern RMS {sep:.4f} (class_sep {cfg.class_sep}), noise std {noise_sd:.4f} "
          f"(noise {cfg.noise})", flush=True)
    if not (same and differs):
        fail("device sampler: a batch is not a pure function of its step")
    if abs(sep - cfg.class_sep) > 0.05 * cfg.class_sep or \
            abs(noise_sd - cfg.noise) > 0.05 * cfg.noise:
        fail(f"device sampler: statistics off: pattern RMS {sep}, noise std {noise_sd}")

    learner, params = build_model("simple_cnaps", dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        res, counts, _ = _counted(lambda: train_loop_run(
            learner, params, dev, TRAIN_STEPS, TRAIN_TASKS, ckpt_dir, source="device"))
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in res.metrics_history]
    ms = [1e3 * t for t in res.step_times]
    tps = res.throughput(TRAIN_TASKS, skip=1)
    print(f"train loop simple_cnaps on the device sampler: {TRAIN_STEPS} steps of T "
          f"{TRAIN_TASKS}, losses {losses}, ms per step {ms}, tasks/s {tps:.3f} (first step "
          f"excluded; host sampler, phase 5: {host_loop['tasks_per_s']:.3f} tasks/s, ms per "
          f"step {host_loop['step_ms']}), peak memory {peak} B, launches {counts}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses) \
            or res.nonfinite_steps or res.rollbacks:
        fail(f"device-sampler loop: losses {losses}, skipped {res.nonfinite_steps}")
    _need("device-sampler loop", counts, ("segment_sum", "class_second_moment",
                                          "mahalanobis"), TRAIN_STEPS)
    step = make_episodic_train_step(learner, LiteSpec(**TRAIN_LITE), MetaTrainConfig(
        tasks_per_step=TRAIN_TASKS, kernel_backend="cuda"), AdamWConfig(weight_decay=0.0))
    batch = dict(tasks=task_batch_at(17, cfg, TRAIN_TASKS, TRAIN_STEPS, dev),
                 key=(0, TRAIN_STEPS))
    step(res.state, batch)
    _, _, wall = _counted(lambda: step(res.state, batch))
    trace = trace_train_step(step, res.state, batch, wall)
    return dict(batch_ms=batch_ms, batch_ms_all=times, deterministic=same,
                next_step_differs=differs, pattern_rms=sep, noise_std=noise_sd,
                losses=losses, step_ms=ms, tasks_per_s=tps, peak_bytes=peak,
                launches=counts, trace=trace,
                host_sampler=dict(batch_ms=host_loop["host_batch_ms"],
                                  step_ms=host_loop["step_ms"],
                                  tasks_per_s=host_loop["tasks_per_s"]))


def algorithm1_check(dev, launches):
    """Paper Algorithm 1's per-task step with query_batch 0 and 8 on one
    task and its scores (params held together, peak memory of each), then
    the looped baseline over 8 tasks against one batched step of them."""
    import torch
    from repro_torch.core.episodic_train import (make_batched_meta_train_step,
                                                 make_meta_train_step, run_looped_baseline)
    from repro_torch.core.lite import LiteSpec, index_scores
    from repro_torch.data.episodic import EpisodicImageConfig, task_batch_at
    from repro_torch.kernels import dispatch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
    adamw = AdamWConfig(weight_decay=0.0)
    lite = LiteSpec(**TRAIN_LITE)
    learner, params = build_model("simple_cnaps", dev)
    batch = task_batch_at(17, cfg, TRAIN_TASKS, 0, dev)
    task = batch.task(0)
    scores = index_scores(0, 0, [0], task.support_y.shape[0], dev)[0]
    out, counts_all = dict(), {}
    with dispatch.use_backend("cuda"):
        for qb in (0, 8):
            step = make_meta_train_step(learner, lite, query_batch=qb, adamw=adamw)
            step(params, adamw_init(params, adamw), task, scores)             # warm-up
            (res, counts, ms), peak = _peak(lambda: _counted(lambda: step(
                params, adamw_init(params, adamw), task, scores)), dev)
            out[qb] = dict(params=res[0], loss=float(res[2]["loss"]), ms=ms, peak_bytes=peak,
                           launches=counts)
            for k, v in counts.items():
                counts_all[k] = counts_all.get(k, 0) + v
        err = max_leaf_err(out[8].pop("params"), out[0].pop("params"))
        loss_err = abs(out[8]["loss"] - out[0]["loss"]) / abs(out[0]["loss"])
        tol = TRAIN_TOL["simple_cnaps"]
        print(f"algorithm 1 simple_cnaps, one task (N 50, M 30): query_batch 0: loss "
              f"{out[0]['loss']:.6f}, {out[0]['ms']:.2f} ms, peak {out[0]['peak_bytes']} B; "
              f"query_batch 8: loss {out[8]['loss']:.6f}, {out[8]['ms']:.2f} ms, peak "
              f"{out[8]['peak_bytes']} B; loss rel {loss_err:.3e}, params err {err:.3e} (tol "
              f"{tol['params']:.0e}); launches {counts_all}", flush=True)
        if err > tol["params"] or loss_err > tol["loss"]:
            fail("algorithm 1: query micro-batches disagree with the single pass")
        _need("algorithm 1 step", counts_all, ("segment_sum", "class_second_moment",
                                              "mahalanobis"))
        launches["algo1"] = counts_all

        tasks = [batch.task(i) for i in range(TRAIN_TASKS)]
        looped = lambda: run_looped_baseline(learner, lite, params, adamw_init(params, adamw),
                                             tasks, (0, 0), adamw=adamw)
        bscores = index_scores(0, 0, range(TRAIN_TASKS), batch.support_y.shape[1], dev)
        bstep = make_batched_meta_train_step(learner, lite, adamw=adamw)
        batched = lambda: bstep(params, adamw_init(params, adamw), batch, bscores)
        looped()
        batched()
        _, _, loop_ms = _counted(looped)
        _, _, batch_ms = _counted(batched)
    print(f"algorithm 1 looped baseline: {TRAIN_TASKS} per-task steps {loop_ms:.2f} ms "
          f"({TRAIN_TASKS / loop_ms * 1e3:.3f} tasks/s); one batched step of the same "
          f"{TRAIN_TASKS} tasks {batch_ms:.2f} ms ({TRAIN_TASKS / batch_ms * 1e3:.3f} tasks/s)",
          flush=True)
    out.update(params_err=err, loss_err=loss_err, launches=counts_all, looped_ms=loop_ms,
               batched_ms=batch_ms)
    return out


def fig4_check(dev, launches):
    """``gradient_experiment`` for Simple CNAPs on the first set-encoder
    conv at h 8, 16 and 32, 4 draws of the LITE estimator, on ``cuda``
    (launches counted) and on ``ref`` with the same draws.  Not the
    subsampled one: at these widths its class covariances, N/H times a
    few examples' outer products less the square of their scaled mean, are
    not positive definite, and both packages' Cholesky returns NaN
    (ROADMAP R5)."""
    from repro_torch.core.diagnostics import gradient_experiment
    from repro_torch.data.episodic import EpisodicImageConfig, task_batch_at
    from repro_torch.kernels import dispatch
    cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
    learner, params = build_model("simple_cnaps", dev)
    batch = task_batch_at(17, cfg, 1, 0, dev)
    run = lambda: gradient_experiment(learner.meta_loss, params, batch, FIG4_H, FIG4_DRAWS,
                                      seed=3,
                                      param_filter=lambda p: p["enc"]["blocks"][0]["w"])
    res = {}
    for backend in ("cuda", "ref"):
        with dispatch.use_backend(backend):
            run()                                                    # warm-up
            res[backend], counts, ms = _counted(run)
        res[backend]["ms"] = ms
        if backend == "cuda":
            launches["fig4"] = counts
    worst = 0.0
    for h in FIG4_H:
        for m in ("rmse", "bias_mse"):
            a, b = res["cuda"]["lite"][h][m], res["ref"]["lite"][h][m]
            worst = max(worst, abs(a - b) / abs(b) if math.isfinite(a + b) else math.inf)
    norm_err = abs(res["cuda"]["exact_norm"] - res["ref"]["exact_norm"]) / res["ref"]["exact_norm"]
    print(f"fig 4 simple_cnaps, enc/blocks/0/w, h {FIG4_H}, {FIG4_DRAWS} draws: cuda "
          f"{res['cuda']['ms']:.1f} ms, ref {res['ref']['ms']:.1f} ms; exact norm "
          f"{res['cuda']['exact_norm']:.6e} (rel {norm_err:.3e}); worst rmse/bias_mse rel "
          f"{worst:.3e} (tol {FIG4_TOL:.0e}); launches {launches['fig4']}", flush=True)
    print("    lite " + "; ".join(
        f"h {h}: rmse {res['cuda']['lite'][h]['rmse']:.4e} bias_mse "
        f"{res['cuda']['lite'][h]['bias_mse']:.4e}" for h in FIG4_H), flush=True)
    if not worst <= FIG4_TOL or not norm_err <= FIG4_TOL:
        fail("fig 4: the cuda backend's estimator statistics disagree with ref's")
    _need("fig 4", launches["fig4"], ("segment_sum", "class_second_moment", "mahalanobis"))
    return dict(cuda=res["cuda"], ref=res["ref"], worst_rel=worst, exact_norm_rel=norm_err,
                launches=launches["fig4"])


def baselines_check(dev, launches):
    """FOMAML and FineTuner: one meta-train step of T 8 each on ``cuda``
    (ms, peak memory), then each served through the engine against
    ``ref``; FineTuner's int8 frozen backbone must launch B4."""
    from repro_torch.core.episodic_train import make_batched_meta_train_step
    from repro_torch.core.lite import LiteSpec, index_scores
    from repro_torch.data.episodic import EpisodicImageConfig, task_batch_at
    from repro_torch.kernels import dispatch
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
    batch = task_batch_at(17, cfg, TRAIN_TASKS, 0, dev)
    scores = index_scores(0, 0, range(TRAIN_TASKS), batch.support_y.shape[1], dev)
    adamw = AdamWConfig(weight_decay=0.0)
    out = {}
    for kind in ("fomaml", "finetuner"):
        learner, params = build_model(kind, dev)
        step = make_batched_meta_train_step(learner, LiteSpec(**TRAIN_LITE), adamw=adamw)
        go = lambda: step(params, adamw_init(params, adamw), batch, scores)
        with dispatch.use_backend("cuda"):
            go()                                                             # warm-up
            (res, _, ms), peak = _peak(lambda: _counted(go), dev)
        loss = float(res[2]["loss"])
        print(f"train {kind}: one step of T {TRAIN_TASKS} at {IMAGE_SIZE} px {ms:.2f} ms, "
              f"loss {loss:.6f}, accuracy {float(res[2]['accuracy']):.3f}, peak {peak} B",
              flush=True)
        if not math.isfinite(loss) or float(res[2]["nonfinite"]) != 0.0:
            fail(f"train {kind}: a non-finite step")
        del res, learner, params
        out[kind] = dict(train_step_ms=ms, train_peak_bytes=peak, loss=loss,
                         serve=run_path(kind, 8, dev, launches))
    _need("finetuner served int8", launches["finetuner"], ("int8_matmul",))
    return out


def int8_adamw_check(dev):
    """One AdamW update of the Simple CNAPs params with int8 state against
    fp32 state from the same gradients: params, the quantized moments
    against the fp32 ones (within one quantisation step), state bytes."""
    import torch
    from repro_torch.common.tree import tree_leaves, tree_paths
    from repro_torch.core.lite import index_scores
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.bridge import HWIO_TO_OIHW
    from repro_torch.optim.quant import BLOCK, dequantize, dequantize_log, is_quantized
    learner, params = build_model("simple_cnaps", dev)
    batch = train_batch(2, 0, dev)
    grads = meta_grads(learner, params, batch, index_scores(
        0, 0, range(2), batch.support_y.shape[1], dev), "cuda")[2]
    res = {}
    for dt in ("float32", "int8"):
        cfg = AdamWConfig(weight_decay=0.1, state_dtype=dt)
        res[dt] = adamw_update(params, grads, adamw_init(params, cfg), 1e-3, cfg)
    p_err = max_leaf_err(res["int8"][0], res["float32"][0])
    worst = {"mu": 0.0, "nu": 0.0}
    for part, deq in (("mu", dequantize), ("nu", dequantize_log)):
        want = tree_paths(res["float32"][1][part])
        leaves = tree_leaves(res["int8"][1][part], is_leaf=is_quantized)
        for (k, w), qs in zip(want.items(), leaves):
            x = deq(qs)
            step = qs["scale"].repeat_interleave(BLOCK, dim=-1)[..., :qs["n"]]
            if w.dim() == 4:                  # the state is HWIO, the moments OIHW
                x, step = x.permute(*HWIO_TO_OIHW), step.permute(*HWIO_TO_OIHW)
            if part == "mu":
                d = (x - w).abs() / step
            else:          # the log domain, where nu's codes live
                live = (w > 1.5e-12) & (x > 0)      # 0 is the floor's code
                d = ((x.clamp_min(1e-30).log() - w.clamp_min(1e-30).log()).abs() / step)[live]
            worst[part] = max(worst[part], float(d.max()) if d.numel() else 0.0)
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                              if torch.is_tensor(t))
    b32 = nbytes([res["float32"][1]["mu"], res["float32"][1]["nu"]])
    b8 = nbytes([res["int8"][1]["mu"], res["int8"][1]["nu"]])
    print(f"int8 AdamW simple_cnaps: params after one update vs fp32 state {p_err:.3e} (tol "
          f"{INT8_PARAMS_TOL:.0e}); moments within {worst['mu']:.3f} (mu) and "
          f"{worst['nu']:.3f} (nu, log domain) quantisation steps; state {b8} B against "
          f"{b32} B fp32 ({b8 / b32:.3f}x)", flush=True)
    if p_err > INT8_PARAMS_TOL or max(worst.values()) > 1.0:
        fail("int8 AdamW: the update or its state disagrees with fp32 state's")
    return dict(params_err=p_err, state_steps=worst, state_bytes=b8, fp32_state_bytes=b32)


def run_training_rest(dev, launches, host_loop):
    """Phase 5b: the device sampler and its loop, Algorithm 1, the Fig. 4
    experiment, FOMAML and FineTuner, the int8 AdamW state and the
    launcher at its defaults, each with its launches under its own key."""
    import torch
    out = dict(kind="train_rest")
    out["sampler"] = device_sampler_check(dev, host_loop)
    launches["train_device"] = out["sampler"]["launches"]
    torch.cuda.empty_cache()
    out["algorithm1"] = algorithm1_check(dev, launches)
    torch.cuda.empty_cache()
    out["fig4"] = fig4_check(dev, launches)
    torch.cuda.empty_cache()
    out["baselines"] = baselines_check(dev, launches)
    torch.cuda.empty_cache()
    out["int8_adamw"] = int8_adamw_check(dev)
    torch.cuda.empty_cache()
    defer(out, "launcher", run_launcher, [], "data_source=device")
    return out


# ---------------------------------------------------------------------------
# phase 5c: episodic LM meta-training, LITE over minitron-4b
# ---------------------------------------------------------------------------

LM_TRAIN_TASKS = 2                           # tasks a step
# minitron-4b's 32 layers cut to 16, so that the whole script stays within
# its time (at 8 the gate no longer sees the planted dq fault)
LM_TRAIN_LAYERS = 16
LM_TRAIN_LITE = dict(h=8, chunk_size=8)
LM_TRAIN_STEPS = 3
LM_PROTO_LAYERS = 4                          # ProtoNets trains every weight: cut depth
# ProtoNets' logits are squared distances of 3072-wide features: at the
# sampler's concentration 0.3 its margins on these tasks exceed fp32's
# resolution, its loss and gradient come out exactly 0 and the gate would
# hold nothing, so its tasks' class unigrams are flatter
LM_PROTO_CONCENTRATION = 1.0
# the example's task family (5-way, 8 shot, 2 queries a class) at a
# realistic sequence length over the full vocab
LM_TASK = dict(way=5, shot=8, query_per_class=2, seq_len=256)
LM_TRAIN_CATEGORIES = (   # device kernel name -> what it is, first match wins
    ("B5 backward", ("flash_bwd",)),
    ("B5 flash_attention", ("flash_attention",)),
    ("B1 segment_sum", ("segment_sum_kernel",)),
    ("B2 class_second_moment", ("second_moment_kernel",)),
    ("B3 mahalanobis", ("mahalanobis",)),
    ("cuSOLVER (Cholesky, inverse)", ("potrf", "potri", "trsm", "trtri", "cusolver",
                                      "lauum", "syrk", "getrf")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "gemv", "xmma", "splitk", "dot_kernel")),
    ("reductions", ("reduce", "softmax", "norm")),
    ("copies", ("memcpy", "memset", "copy", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "scatter")),
)


def lm_learner(kind, cfg):
    """Phase 5c's learner of ``kind`` over the LM backbone of ``cfg``, with
    the example's ``tokens`` set encoder (task_dim 32)."""
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.models.lm_backbone import make_lm_backbone
    return make_learner(MetaLearnerConfig(kind=kind, way=LM_TASK["way"]),
                        make_lm_backbone(cfg),
                        SetEncoderConfig(kind="tokens", in_channels=cfg.vocab, task_dim=32))


def lm_tasks(cfg, tasks: int, step: int, dev, seed: int = 0, **kw):
    """(TaskBatch, H scores) of ``step``: token tasks on the card (LM_TASK,
    updated by ``kw``) and the counter-based H draw of (seed, step, task,
    example)."""
    from repro_torch.core.lite import index_scores
    from repro_torch.data.episodic import EpisodicTokenConfig, token_task_batch_at
    batch = token_task_batch_at(seed, EpisodicTokenConfig(vocab=cfg.vocab, **LM_TASK, **kw),
                                tasks, step, dev)
    return batch, index_scores(seed, step, range(tasks), batch.support_y.shape[1], dev)


def lm_grads(learner, params, batch, scores, backend, lite=None):
    """One step's (loss, accuracy, {path: gradient or None}, launches) on
    ``backend``: ``make_reached_meta_grads``' gradient over the leaves the
    loss reaches, written out here so that the launch counts of the
    meta-loss (forward) and of the backward read apart."""
    import torch
    from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import _build, dispatch
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with dispatch.use_backend(backend), torch.enable_grad():
        torch.cuda.synchronize()
        _build.launches.reset()
        losses, aux = learner.meta_loss(live, batch, scores,
                                        LiteSpec(**(lite or LM_TRAIN_LITE)))
        loss = losses.mean()
        torch.cuda.synchronize()
        fwd = _build.launches.snapshot()
        grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
        torch.cuda.synchronize()
        total = _build.launches.snapshot()
    bwd = {k: n - fwd.get(k, 0) for k, n in total.items() if n - fwd.get(k, 0)}
    return (float(loss.detach()), float(aux["accuracy"].mean()),
            dict(zip(tree_paths(params), grads)), dict(forward=fwd, backward=bwd))


def lm_grad_errs(got, want, prefixes, device=None):
    """(loss error, {leaf: error}) of run ``got`` against run ``want``: the
    loss's relative error, and each leaf's max|got - want| over its
    max|want| for the leaves under ``prefixes``.  Fails if a leaf that
    ``want`` trains (a non-zero gradient) gets none in ``got``.  With
    ``device``, each pair of leaves is moved there (from the host) to be
    compared."""
    loss_err = abs(got[0] - want[0]) / max(abs(want[0]), 1e-30)
    errs = {}
    for k, w in want[2].items():
        g = got[2][k]
        if not k.startswith(prefixes) or w is None:
            if g is not None and k.startswith(prefixes):
                fail(f"leaf {k}: a gradient where the reference has none")
            continue
        if device is not None and g is not None:
            g, w = g.to(device), w.to(device)
        scale = float(w.abs().max())
        if g is None or (scale > 0 and float(g.abs().max()) == 0):
            fail(f"leaf {k}: the reference trains it, this run gives it no gradient")
        errs[k] = float((g.float() - w.float()).abs().max()) / max(scale, 1e-30)
    return loss_err, errs


def lm_train_gate(label: str, runs, prefixes, fault: bool = False, ref16_errs=None,
                  per_leaf: bool = False, device=None, got_errs=None):
    """Phase 6b's gate on a training step: run ``got`` (the kernel path, or a
    planted fault's run) against the fp32-compute ``ref32`` run, at LM_GATE
    times the bf16 ``ref16`` run's own error (or ``ref16_errs``, that
    run's :func:`lm_grad_errs` taken before), for the loss and for the
    worst gradient leaf under ``prefixes``; with ``per_leaf``, for every
    leaf against its own bf16 error too.  A fault must fail it.  ``got_errs``:
    ``got``'s :func:`lm_grad_errs` taken before (block by block on the ranks
    that hold it), the fp32 run's gradient then checked where it was
    written."""
    if runs["ref32"][0] == 0 or (got_errs is None and not any(
            w is not None and float(w.abs().max()) > 0 for k, w in runs["ref32"][2].items()
            if k.startswith(prefixes))):
        fail(f"{label}: the fp32 run's loss or gradient is exactly 0 (a saturated "
             f"softmax): the gate would hold nothing")
    l_ref, e_ref = ref16_errs or lm_grad_errs(runs["ref16"], runs["ref32"], prefixes)
    l_got, e_got = got_errs or lm_grad_errs(runs["got"], runs["ref32"], prefixes, device)
    worst_ref, worst_got = max(e_ref.values()), max(e_got.values())
    worst_leaf = max(e_got, key=e_got.get)
    over = sum(e_got[k] > LM_GATE * e_ref[k] for k in e_got)
    passed = l_got <= LM_GATE * l_ref and worst_got <= LM_GATE * worst_ref \
        and not (per_leaf and over)
    print(f"  {label}: vs fp32 ref, loss err {l_got:.3e} (gate {LM_GATE * l_ref:.3e}), worst "
          f"leaf err {worst_got:.3e} at {worst_leaf} (gate {LM_GATE * worst_ref:.3e} = "
          f"{LM_GATE}x bf16 ref's {worst_ref:.3e}, {len(e_got)} leaves, {over} of them past "
          f"{LM_GATE}x their own bf16 ref error{', which the gate reads' if per_leaf else ''}) "
          f"{('MISSED' if passed else 'caught') if fault else ('ok' if passed else 'FAIL')}",
          flush=True)
    if passed == fault:
        fail(f"{label}: " + ("the gate misses the planted fault" if fault else
                             "the kernel path is outside its gate"))
    return dict(loss_err=l_got, ref16_loss_err=l_ref, worst_leaf_err=worst_got,
                worst_leaf=worst_leaf, ref16_worst_leaf_err=worst_ref,
                leaves=len(e_got), leaves_past_own_ratio=over, passed=passed,
                leaf_errors=e_got, ref16_leaf_errors=e_ref)


@contextlib.contextmanager
def planted_kernel(module, name: str, make):
    """``module.name`` (a kernel wrapper) replaced for the block by
    ``make(original)``: the Functions look their kernels up on the module at
    each call, so a fault planted there spoils what the backward runs."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def b5_backward_faults():
    """(label, make) of the two faults planted on the outputs of B5's
    backward kernel (``flash_attention_gqa_bwd``), each for
    :func:`planted_kernel`: dv of the last kv head zeroed, and dq's sign
    flipped for the rows past S/2."""
    def dv_last_kv_head_zeroed(kernel):
        def run(*a, **kw):
            dq, dk, dv = kernel(*a, **kw)
            if dv is not None:
                dv[:, :, -1] = 0
            return dq, dk, dv
        return run

    def dq_sign_flipped_late(kernel):
        def run(*a, **kw):
            dq, dk, dv = kernel(*a, **kw)
            if dq is not None:
                dq[:, dq.shape[1] // 2:] *= -1
            return dq, dk, dv
        return run

    return (("B5 backward kernel: dv of the last kv head zeroed", dv_last_kv_head_zeroed),
            ("B5 backward kernel: dq's sign flipped past S/2", dq_sign_flipped_late))


def b5_roles(launches):
    """B5's launches of a differentiated pass by role: the forward kernel in
    the forward and in the checkpoints' recompute, the backward kernel
    (K5b) and its products dq and dk / dv, and how many of each kernel's
    launches took the tensor cores."""
    fwd, bwd = launches["forward"], launches["backward"]
    return dict(forward=fwd.get("flash_attention", 0), recompute=bwd.get("flash_attention", 0),
                backward=bwd.get("flash_attention_bwd", 0),
                dq=bwd.get("flash_attention_bwd/dq", 0), dkv=bwd.get("flash_attention_bwd/dkv", 0),
                wgmma=fwd.get("flash_attention/wgmma", 0) + bwd.get("flash_attention/wgmma", 0),
                bwd_wgmma=bwd.get("flash_attention_bwd/wgmma", 0))


def b5_bwd_want(n: int) -> dict:
    """The counts of ``n`` calls of B5's backward kernel on the tensor
    cores, each computing dq and dk / dv."""
    return {"flash_attention_bwd": n, "flash_attention_bwd/wgmma": n,
            "flash_attention_bwd/dq": n, "flash_attention_bwd/dkv": n} if n else {}


def lm_parity(kind, cfg, params, batch, scores, prefixes, plant: bool = False):
    """One LITE step of ``kind`` on the kernels (counted) against ``ref`` in
    bf16 and in fp32 compute from the same params, tasks and H scores,
    through the gate; with ``plant``, the two faults planted on the outputs
    of B5's backward kernel, which the same gate must flag."""
    import dataclasses
    from repro_torch.kernels import flash_attention as _fa
    learner = lm_learner(kind, cfg)
    lm_grads(learner, params, batch, scores, "cuda")            # allocator, cuBLAS
    runs = dict(got=lm_grads(learner, params, batch, scores, "cuda"),
                ref16=lm_grads(learner, params, batch, scores, "ref"),
                ref32=lm_grads(lm_learner(kind, dataclasses.replace(
                    cfg, compute_dtype="float32")), params, batch, scores, "ref"))
    launches = runs["got"][3]
    print(f"train lm {kind}: {cfg.name}, {cfg.n_layers} layers, T {batch.num_tasks}, loss "
          f"cuda {runs['got'][0]:.6g} ref {runs['ref16'][0]:.6g} fp32 {runs['ref32'][0]:.6g}, "
          f"accuracy {runs['got'][1]:.3f}; launches forward {launches['forward']}, "
          f"backward {launches['backward']}", flush=True)
    out = dict(loss=runs["got"][0], ref16_loss=runs["ref16"][0], ref32_loss=runs["ref32"][0],
               accuracy=runs["got"][1], launches=launches,
               gate=lm_train_gate(f"{cfg.name} {kind} LITE step", runs, prefixes))
    if plant:
        out["planted_faults"] = []
        for label, make in b5_backward_faults():
            with planted_kernel(_fa, "flash_attention_gqa_bwd", make):
                got = lm_grads(learner, params, batch, scores, "cuda")
            r = lm_train_gate(f"planted fault: {label}", {**runs, "got": got}, prefixes,
                              fault=True)
            out["planted_faults"].append(dict(fault=label, **{
                k: v for k, v in r.items() if not k.endswith("leaf_errors")}))
    return out


def lm_train_loop(learner, params, cfg, dev):
    """LM_TRAIN_STEPS steps through the example's step on the kernels (the
    launch counts set to 0 just before and read just after), then one
    step timed and one profiled."""
    import torch
    from repro_torch.core.lite import LiteSpec
    from repro_torch.examples.episodic_lm import make_meta_step
    from repro_torch.kernels import _build
    step = make_meta_step(learner, LiteSpec(**LM_TRAIN_LITE))
    data = [lm_tasks(cfg, LM_TRAIN_TASKS, s, dev) for s in range(LM_TRAIN_STEPS + 1)]
    losses, ms = [], []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    for s in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, loss, _ = step(params, *data[s])
        losses.append(float(loss))               # reads the loss back: synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(dev)
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    tasks_per_s = LM_TRAIN_TASKS * (LM_TRAIN_STEPS - 1) / (sum(ms[1:]) / 1e3)
    print(f"train lm loop: {LM_TRAIN_STEPS} steps of T {LM_TRAIN_TASKS}, losses {losses}, ms "
          f"per step {ms}, tasks/s {tasks_per_s:.3f} (first step excluded), peak memory "
          f"{peak} B, launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"train lm loop: losses {losses}")
    _need("train lm loop", counts, ("flash_attention", "segment_sum", "class_second_moment",
                                    "mahalanobis"), LM_TRAIN_STEPS)
    wall = _counted(lambda: step(params, *data[-1]))[2]
    busy, cats, table = device_breakdown(
        lambda: step(params, *data[-1]), LM_TRAIN_CATEGORIES,
        lambda busy, _: f"  train lm trace: device busy {busy:.2f} ms of an unprofiled step "
                        f"of {wall:.2f} ms (idle share {1 - busy / wall:.3f})", 15)
    return params, dict(losses=losses, step_ms=ms, tasks_per_s=tasks_per_s, peak_bytes=peak,
                        launches=counts, trace=dict(busy_ms=busy, step_wall_ms=wall,
                                                    idle_share=1 - busy / wall,
                                                    categories=cats, top=table[:40]))


def lm_memory(learner, params, batch, scores, dev):
    """Peak device bytes of a LITE step and of an exact step (h = N) on the
    same tasks, each after a warm-up step; LITE's must be lower."""
    import torch
    from repro_torch.core.lite import LiteSpec
    from repro_torch.core.episodic_train import make_reached_meta_grads
    out = {}
    for name, lite in (("lite", LiteSpec(**LM_TRAIN_LITE)), ("exact", LiteSpec(exact=True))):
        grads_fn = make_reached_meta_grads(learner, lite)
        grads_fn(params, batch, scores)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        res, peak = _peak(lambda: grads_fn(params, batch, scores), dev)
        del res
        out[name] = dict(peak_bytes=peak, base_bytes=base)
    ratio = out["lite"]["peak_bytes"] / out["exact"]["peak_bytes"]
    print(f"train lm memory, T {batch.num_tasks}: peak of a LITE step (h "
          f"{LM_TRAIN_LITE['h']}, chunk {LM_TRAIN_LITE['chunk_size']}) "
          f"{out['lite']['peak_bytes']} B, of an exact step {out['exact']['peak_bytes']} B "
          f"({ratio:.3f}x); {out['lite']['base_bytes']} B held before the step", flush=True)
    if not out["lite"]["peak_bytes"] < out["exact"]["peak_bytes"]:
        fail("train lm memory: LITE's peak is not below the exact step's")
    return dict(out, ratio=ratio)


def lm_serving(cfg, params, dev):
    """``adapt_batch`` and ``predict_batch`` on two held-out tasks on the
    kernels (counted) against ``ref`` in bf16 and in fp32 compute: the
    logits within LM_GATE times the bf16 ref's own error, relative to
    max|logit|."""
    import dataclasses
    from repro_torch.examples.episodic_lm import heldout_accuracy
    from repro_torch.kernels import dispatch
    batch, _ = lm_tasks(cfg, 2, 0, dev, seed=5)
    runs = {}
    for name, c, backend in (("got", cfg, "cuda"), ("ref16", cfg, "ref"),
                             ("ref32", dataclasses.replace(cfg, compute_dtype="float32"),
                              "ref")):
        learner = lm_learner("simple_cnaps", c)
        with dispatch.use_backend(backend):
            (logits, acc), counts, ms = _counted(lambda: heldout_accuracy(learner, params,
                                                                         batch))
        runs[name] = (logits.float(), float(acc), counts, ms)
    e_got = global_err(runs["got"][0], runs["ref32"][0])
    e_ref = global_err(runs["ref16"][0], runs["ref32"][0])
    passed = e_got <= LM_GATE * e_ref
    counts = runs["got"][2]
    print(f"serve lm: adapt + predict, 2 held-out tasks, {runs['got'][3]:.1f} ms on the kernels "
          f"({runs['ref16'][3]:.1f} on ref), accuracy {runs['got'][1]:.3f}; logits vs fp32 ref "
          f"{e_got:.3e} (gate {LM_GATE * e_ref:.3e} = {LM_GATE}x bf16 ref's {e_ref:.3e}) "
          f"{'ok' if passed else 'FAIL'}; launches {counts}", flush=True)
    if not passed:
        fail("serve lm: the kernel path's logits are outside their gate")
    _need("serve lm", counts, ("flash_attention", "segment_sum", "class_second_moment",
                               "mahalanobis"))
    return dict(ms=runs["got"][3], ref_ms=runs["ref16"][3], accuracy=runs["got"][1],
                err_vs_fp32=e_got, ref16_err_vs_fp32=e_ref, gate=LM_GATE * e_ref,
                launches=counts)


def lm_train_kernel_specs(dev):
    """B5 at phase 5c's shapes (the H pass: 16 sequences; the queries: 20;
    256 tokens), as :func:`check_kernels` takes them, beside SDPA."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(6)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    n_h = LM_TRAIN_TASKS * LM_TRAIN_LITE["h"]
    n_q = LM_TRAIN_TASKS * LM_TASK["way"] * LM_TASK["query_per_class"]
    s = LM_TASK["seq_len"]
    return [dict(name="flash_attention", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:89",
                 symbol="flash_attention_wgmma_kernel", cases=[
        flash_case(randn, f"minitron-4b LITE H pass B{n_h} S{s} Hq24 Hkv8 D128 causal", n_h,
                   s, 24, 8, 128, torch.bfloat16, main=True, lib=True, iters=(20, 5),
                   causal=True),
        flash_case(randn, f"minitron-4b queries B{n_q} S{s} Hq24 Hkv8 D128 causal", n_q, s,
                   24, 8, 128, torch.bfloat16, main=True, lib=True, iters=(20, 5),
                   causal=True)])]


def run_lm_train(dev, launches):
    """Phase 5c: LITE meta-training of Simple CNAPs over minitron-4b at full
    width and LM_TRAIN_LAYERS layers (random weights drawn on the card from seed 0, fp32
    params, bf16 compute, blocks checkpointed), ProtoNets at LM_PROTO_LAYERS
    layers, the serving side and the example as a subprocess."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("minitron-4b"), n_layers=LM_TRAIN_LAYERS)
    if cfg.remat_policy != "nothing" or cfg.compute_dtype != "bfloat16":
        fail(f"{cfg.name}: expected remat_policy 'nothing' and bf16 compute")
    n_layers = cfg.n_layers
    learner = lm_learner("simple_cnaps", cfg)
    params = learner.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch, scores = lm_tasks(cfg, LM_TRAIN_TASKS, 0, dev)
    out = dict(kind="lm_train", arch=cfg.name, tasks_per_step=LM_TRAIN_TASKS,
               lite=LM_TRAIN_LITE, task=LM_TASK, vocab=cfg.vocab)

    r = lm_parity("simple_cnaps", cfg, params, batch, scores, ("enc/", "film_gen/"),
                  plant=True)
    fwd, bwd = r["launches"]["forward"], r["launches"]["backward"]
    n_comp = LM_TASK["way"] * LM_TASK["shot"] - LM_TRAIN_LITE["h"]
    chunks = -(-n_comp // LM_TRAIN_LITE["chunk_size"])
    want_fwd, want_bwd = (chunks + 2) * n_layers, 2 * n_layers   # H, chunks, queries
    # the backward kernel: FiLM modulates a block's output, so the first
    # layer's q, k and v come from the frozen embedding alone and nothing
    # asks for their gradient; every later layer's, in the H pass and the
    # queries
    want_k5b = 2 * (n_layers - 1)
    roles = b5_roles(r["launches"])
    want = dict(forward=want_fwd, recompute=want_bwd, backward=want_k5b, dq=want_k5b,
                dkv=want_k5b, wgmma=want_fwd + want_bwd, bwd_wgmma=want_k5b)
    print(f"  train lm: B5 launches by role {roles}", flush=True)
    if roles != want:
        fail(f"train lm: B5 launches forward {fwd}, backward {bwd}, by role {roles}; want "
             f"{want}: {want_fwd} in the forward (the H pass, {chunks} complement chunks, "
             f"the queries), {want_bwd} in the backward (the checkpoints' recompute of the H "
             f"pass and the queries) all on wgmma, and {want_k5b} of the backward kernel "
             f"(dq and dk / dv each; none for the first layer) on wgmma")
    _need("train lm forward", fwd, ("segment_sum", "class_second_moment", "mahalanobis"))
    if fwd.get("mahalanobis/stream") != fwd.get("mahalanobis"):
        fail(f"train lm: the Mahalanobis head did not take the stream route: {fwd}")
    if any(not k.startswith("flash_attention") for k in bwd):
        fail(f"train lm: the backward launched more than B5's recompute and backward kernel: "
             f"{bwd}")
    out["parity_simple_cnaps"] = r
    torch.cuda.empty_cache()
    mark("5c: Simple CNAPs parity and planted faults done")

    params, out["loop"] = lm_train_loop(learner, params, cfg, dev)
    launches["lm_train"] = out["loop"]["launches"]
    out["memory"] = lm_memory(learner, params, batch, scores, dev)
    torch.cuda.empty_cache()
    mark("5c: loop and memory done")
    out["serving"] = lm_serving(cfg, params, dev)
    del learner, params
    torch.cuda.empty_cache()
    mark("5c: serving done")

    cfg4 = dataclasses.replace(cfg, n_layers=LM_PROTO_LAYERS)
    p4 = lm_learner("protonets", cfg4).init(torch.Generator(device=dev).manual_seed(0), dev)
    batch, scores = lm_tasks(cfg, LM_TRAIN_TASKS, 0, dev,
                             concentration=LM_PROTO_CONCENTRATION)
    out["parity_protonets"] = lm_parity("protonets", cfg4, p4, batch, scores, ("bb/",))
    del p4
    torch.cuda.empty_cache()
    mark("5c: ProtoNets parity done")

    b5 = check_kernels(lm_train_kernel_specs(dev))["flash_attention"]
    out["kernel_cases"], out["kernel_max_abs_err"] = b5["cases"], b5["max_abs_err"]
    defer(out, "example", run_episodic_lm_example)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5c: {out['seconds']:.1f} s", flush=True)
    return out


def run_episodic_lm_example():
    """``python -m repro_torch.examples.episodic_lm --steps 2`` on the card
    as a subprocess, which must exit 0 on ``device=cuda``."""
    cmd = [sys.executable, "-m", "repro_torch.examples.episodic_lm", "--steps", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stdout[-300:]]
    print(f"episodic LM example: {' '.join(cmd[1:])} exit {proc.returncode} in {secs:.1f} s; "
          f"{tail[0]}", flush=True)
    if proc.returncode != 0 or "device=cuda" not in proc.stdout:
        fail(f"the episodic LM example failed (exit {proc.returncode}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return dict(cmd=cmd[1:], exit=proc.returncode, seconds=secs, line=tail[0])


# ---------------------------------------------------------------------------
# phase 5d: LM training of gemma2-2b at full width
# ---------------------------------------------------------------------------

PRETRAIN_BATCH = 2
# past gemma2-2b's window of 4096 (the local layers mask keys) and 9 loss
# chunks of 512
PRETRAIN_SEQ = 4608
# 2 steps through ``train()`` in phases 5d, 5f and 6e (3 before phase 5h):
# tokens/s reads the second
PRETRAIN_STEPS = 2
# gemma2-2b in phase 5d at 8 of its 26 layers (4 local, 4 global; all 26
# before phase 5h, 13 before phase 6f), cut for the whole script's time
PRETRAIN_LAYERS = 8
# the parity step's sequences keep their first PRETRAIN_HIDDEN tokens at
# their first token, so that what the window hides from the last positions
# is coherent (phase 6b's reason): on the pipeline's tokens as drawn, a
# backward that drops the window left the worst leaf at half the gate
# (attention at initialisation is nearly uniform); with the prefix it
# reads 4x the gate
PRETRAIN_HIDDEN = 512
PRETRAIN_MINITRON_SEQ = 2048
PRETRAIN_DOTS_LAYERS = 2
PRETRAIN_GATE_PREFIXES = ("",)          # the gate reads every leaf


def pretrain_batch(cfg, step: int, dev, seq: int = PRETRAIN_SEQ, hidden: int = 0):
    """The token pipeline's batch of ``step`` (vocab, ``seq``, batch
    PRETRAIN_BATCH, branching 4, seed 0) on ``dev``; with ``hidden``, each
    sequence's first ``hidden`` tokens set to its first."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig, batch_to_device
    b = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=PRETRAIN_BATCH, branching=4,
                                          seed=0)).batch_at(step)
    if hidden:
        b["tokens"][:, :hidden] = b["tokens"][:, :1]
    return batch_to_device(b, dev)


@contextlib.contextmanager
def recorded_flash(calls, read=lambda q, kw: kw.get("window")):
    """Every flash attention launch in the block appends ``read(q, its
    keyword arguments)`` to ``calls``: by default its window (None:
    global)."""
    from repro_torch.kernels import flash_attention as fa
    orig = fa.flash_attention_gqa

    def rec(q, k, v, **kw):
        calls.append(read(q, kw))
        return orig(q, k, v, **kw)

    fa.flash_attention_gqa = rec
    try:
        yield
    finally:
        fa.flash_attention_gqa = orig


def pretrain_grads(cfg, params, batch, backend):
    """The LM loss and its gradient over every leaf on ``backend``, through
    ``api.loss`` as ``make_train_step`` calls it: (loss, None, {path:
    gradient}, launches and windows of the forward and of the backward)."""
    import torch
    from repro_torch.common.tree import tree_leaves, tree_paths, tree_rebuild
    from repro_torch.kernels import _build, dispatch
    from repro_torch.models.registry import get_api
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    windows = []
    with dispatch.use_backend(backend), torch.enable_grad(), recorded_flash(windows):
        torch.cuda.synchronize()
        _build.launches.reset()
        loss, _ = get_api(cfg).loss(tree_rebuild(params, live), batch, cfg, backend=None)
        torch.cuda.synchronize()
        fwd, n_fwd = _build.launches.snapshot(), len(windows)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        total = _build.launches.snapshot()
    bwd = {k: n - fwd.get(k, 0) for k, n in total.items() if n - fwd.get(k, 0)}
    return (float(loss.detach()), None, dict(zip(tree_paths(params), grads)),
            dict(forward=fwd, backward=bwd, windows=(windows[:n_fwd], windows[n_fwd:])))


def pretrain_gate(label: str, got, ref32, ref16_errs, fault: bool = False,
                  per_leaf: bool = False):
    """:func:`lm_train_gate` over every leaf, the bf16 ``ref`` run's errors
    taken before (its gradient, 10.5 GB at gemma2-2b, is not kept)."""
    r = lm_train_gate(label, dict(got=got, ref32=ref32), PRETRAIN_GATE_PREFIXES, fault,
                      ref16_errs, per_leaf)
    return {k: v for k, v in r.items() if not k.endswith("leaf_errors")}


def b5_window_dropped():
    """(label, make): B5's backward kernel called with the window dropped,
    the local layers differentiated as global ones (for
    :func:`planted_kernel`)."""
    def window_dropped(kernel):
        return lambda *a, **kw: kernel(*a, **{**kw, "window": None})

    return "B5 backward kernel: the window dropped (local layers as global)", window_dropped


def check_pretrain_launches(label, cfg, r, want_fwd: int, want_bwd: int, seq: int,
                            want_k5b: int = None):
    """Fail unless B5 launched ``want_fwd`` times in the forward and
    ``want_bwd`` in the backward (the recompute), all on "wgmma", its
    backward kernel ``want_k5b`` times (default ``want_fwd``: every layer's
    attention is differentiated) on "wgmma", dq and dk / dv each time,
    nothing else launched, and the forward's windows were the config's layer
    by layer (the local window on the even layers, none on the odd; a window
    of at least ``seq`` keys is none), the checkpoints' recompute the same
    in reverse."""
    from repro_torch.models.transformer import layer_windows
    want = {part: {k: n for k in ("flash_attention", "flash_attention/wgmma")} if n else {}
            for part, n in (("forward", want_fwd), ("backward", want_bwd))}
    want["backward"] |= b5_bwd_want(want_fwd if want_k5b is None else want_k5b)
    got = {part: r[part] for part in ("forward", "backward")}
    if got != want:
        fail(f"{label}: launches {got}; want {want} (B5 on wgmma, its backward kernel on "
             f"wgmma, and nothing else)")
    layer = [w if w < seq else None for w in layer_windows(cfg)]
    for part, calls, order in zip(("forward", "backward"), r["windows"], (1, -1)):
        if calls and calls != layer[::order]:
            fail(f"{label}: B5's windows in the {part} {calls}; want {layer[::order]}")


def pretrain_parity(cfg, dev, hidden: int):
    """One step's loss and gradient on the kernels, on ``ref`` in bf16 and on
    ``ref`` in fp32 compute, from the same params (drawn on the card from
    seed 0) and the pipeline's batch 0 (its first ``hidden`` tokens
    repeated), through the gate; the same step again on the kernels, which
    must give the same bits; then the three faults planted on B5's backward
    kernel, which the gate must flag."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.models.registry import get_api
    params = get_api(cfg).init(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = pretrain_batch(cfg, 0, dev, hidden=hidden)
    first = pretrain_grads(cfg, params, batch, "cuda")      # allocator, cuBLAS; the bits
    ref32 = pretrain_grads(dataclasses.replace(cfg, compute_dtype="float32"), params, batch,
                           "ref")
    ref16 = pretrain_grads(cfg, params, batch, "ref")
    ref16_errs = lm_grad_errs(ref16, ref32, PRETRAIN_GATE_PREFIXES)
    ref16_loss = ref16[0]
    del ref16
    mark("5d: ref runs done")
    got = pretrain_grads(cfg, params, batch, "cuda")
    same = got[0] == first[0] and all(equal_bits(got[2][k], first[2][k]) for k in got[2])
    del first
    n = cfg.n_layers
    check_pretrain_launches(f"{cfg.name} step", cfg, got[3], n, n, PRETRAIN_SEQ)
    print(f"pretrain {cfg.name}: {n} layers, B {PRETRAIN_BATCH} S {PRETRAIN_SEQ} (first "
          f"{hidden} tokens repeated), loss cuda {got[0]:.6g} ref {ref16_loss:.6g} fp32 "
          f"{ref32[0]:.6g}; launches forward {got[3]['forward']}, backward "
          f"{got[3]['backward']}; windows a pass {got[3]['windows'][0][:2]}...; a second "
          f"identical step bit-equal: {same}", flush=True)
    if not same:
        fail(f"{cfg.name}: two identical steps on the kernels gave different bits")
    out = dict(hidden=hidden, loss=got[0], ref16_loss=ref16_loss, ref32_loss=ref32[0],
               bit_equal=same, launches={k: got[3][k] for k in ("forward", "backward")},
               gate=pretrain_gate(f"{cfg.name} LM step", got, ref32, ref16_errs))
    del got
    out["planted_faults"] = []
    for label, make in (*b5_backward_faults(), b5_window_dropped()):
        with planted_kernel(_fa, "flash_attention_gqa_bwd", make):
            bad = pretrain_grads(cfg, params, batch, "cuda")
        r = pretrain_gate(f"planted fault: {label}", bad, ref32, ref16_errs, fault=True)
        out["planted_faults"].append(dict(fault=label, **r))
        del bad
    del ref32, params
    torch.cuda.empty_cache()
    return out


def pretrain_loop(cfg, dev, seq: int = PRETRAIN_SEQ, want=None, categories=None,
                  label: str = "pretrain", batch_at=None, batch_size: int = PRETRAIN_BATCH):
    """PRETRAIN_STEPS steps of ``make_train_step`` through ``train()`` from
    ``make_init_state`` (seed 0) on the pipeline's batches of ``seq``
    tokens (or ``batch_at(step)``'s, of ``batch_size`` sequences), no
    checkpoint, the launch counts set to 0 just before and read just
    after, which must be ``want`` (default: B5 on "wgmma" in the forward
    and the checkpoints' recompute of every layer, its backward kernel on
    "wgmma" once a layer, and nothing else); then
    one step timed and one profiled (device time by ``categories``,
    default LM_CATEGORIES)."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.train.loop import train
    from repro_torch.train.step import adamw_for, make_init_state, make_train_step
    state = make_init_state(cfg, adamw_for(cfg))(torch.Generator(device=dev).manual_seed(0),
                                                 dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    held = torch.cuda.memory_allocated(dev)
    step = make_train_step(cfg, adamw_for(cfg))
    batch_at = batch_at or (lambda s: pretrain_batch(cfg, s, dev, seq))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    result = train(state, step, batch_at, PRETRAIN_STEPS, log_every=1)
    torch.cuda.synchronize(dev)
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in result.metrics_history]
    ms = [t * 1e3 for t in result.step_times]
    tokens = batch_size * seq
    tok_s = tokens * (len(ms) - 1) / (sum(ms[1:]) / 1e3)
    reckoned = state_bytes(n_params, cfg.opt_state_dtype, cfg.param_dtype)
    print(f"{label} loop: {cfg.name}, {PRETRAIN_STEPS} steps of B {batch_size} S "
          f"{seq}, losses {losses}, ms per step {ms}, {tok_s:.1f} tokens/s (first "
          f"step excluded), peak memory {peak} B against {reckoned} B reckoned for fp32 "
          f"params, grads and AdamW state ({n_params} params; {held} B held before the "
          f"loop), launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in losses) or any(
            m["nonfinite"] for m in result.metrics_history):
        fail(f"{label} loop: losses {losses}, metrics {result.metrics_history}")
    n = PRETRAIN_STEPS * 2 * cfg.n_layers
    if want is None:
        want = {"flash_attention": n, "flash_attention/wgmma": n} | b5_bwd_want(n // 2)
    if counts != want:
        fail(f"{label} loop: launches {counts}; want {want} ({PRETRAIN_STEPS} steps: the "
             f"forward, the checkpoints' recompute and the backward kernels) and nothing "
             f"else")
    batch = batch_at(PRETRAIN_STEPS)
    wall = _counted(lambda: step(state, batch))[2]
    busy, cats, table = device_breakdown(
        lambda: step(state, batch), categories or LM_CATEGORIES,
        lambda busy, _: f"  {label} trace: device busy {busy:.2f} ms of an unprofiled step "
                        f"of {wall:.2f} ms (idle share {1 - busy / wall:.3f})", 15)
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=ms, tokens_per_s=tok_s, peak_bytes=peak,
                reckoned_bytes=reckoned, params=n_params, held_bytes=held, launches=counts,
                trace=dict(busy_ms=busy, step_wall_ms=wall, idle_share=1 - busy / wall,
                           categories=cats, top=table[:40]))


def pretrain_minitron(dev):
    """minitron-4b at full width and depth with int8 AdamW state (its only
    change): one step at PRETRAIN_BATCH x PRETRAIN_MINITRON_SEQ after a
    warm-up step, its ms and peak memory; the loss must be finite."""
    import dataclasses
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.train.step import adamw_for, make_init_state, make_train_step
    cfg = dataclasses.replace(get_config("minitron-4b"), opt_state_dtype="int8")
    state = make_init_state(cfg, adamw_for(cfg))(torch.Generator(device=dev).manual_seed(0),
                                                 dev)
    held = torch.cuda.memory_allocated(dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    step = make_train_step(cfg, adamw_for(cfg))
    batches = [pretrain_batch(cfg, s, dev, seq=PRETRAIN_MINITRON_SEQ) for s in range(2)]
    step(state, batches[0])
    (_, metrics), peak = _peak(lambda: step(state, batches[1]), dev)
    loss = float(metrics["loss"])
    wall = _counted(lambda: step(state, batches[1]))[2]
    print(f"pretrain minitron-4b (int8 AdamW state): {n_params} params, B {PRETRAIN_BATCH} S "
          f"{PRETRAIN_MINITRON_SEQ}, loss {loss:.6g}, a step {wall:.1f} ms, peak memory "
          f"{peak} B ({held} B held: fp32 params and int8 state)", flush=True)
    if not math.isfinite(loss) or float(metrics["nonfinite"]):
        fail(f"pretrain minitron-4b: loss {loss}, metrics {metrics}")
    del state, step, batches
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, opt_state_dtype="int8", params=n_params, loss=loss,
                step_ms=wall, peak_bytes=peak, held_bytes=held)


def pretrain_dots(cfg, dev):
    """At ``cfg``'s width and PRETRAIN_DOTS_LAYERS layers: the gradient under
    ``remat_policy`` "dots" against "none" on the kernels, within LM_GATE
    times the bf16 ``ref`` run's own error against an fp32 run, and B5's
    launches under each (none: forward only; dots: and the recompute)."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api
    c = dataclasses.replace(cfg, n_layers=PRETRAIN_DOTS_LAYERS, remat_policy="none")
    params = get_api(c).init(torch.Generator(device=dev).manual_seed(0), c)
    batch = pretrain_batch(c, 0, dev, hidden=PRETRAIN_HIDDEN)
    ref32 = pretrain_grads(dataclasses.replace(c, compute_dtype="float32"), params, batch,
                           "ref")
    ref16_errs = lm_grad_errs(pretrain_grads(c, params, batch, "ref"), ref32,
                              PRETRAIN_GATE_PREFIXES)
    none = pretrain_grads(c, params, batch, "cuda")
    dots = pretrain_grads(dataclasses.replace(c, remat_policy="dots"), params, batch, "cuda")
    n = c.n_layers
    check_pretrain_launches("remat none", c, none[3], n, 0, PRETRAIN_SEQ, want_k5b=n)
    check_pretrain_launches("remat dots", c, dots[3], n, n, PRETRAIN_SEQ)
    l_ref, e_ref = ref16_errs
    l_got, e_got = lm_grad_errs(dots, none, PRETRAIN_GATE_PREFIXES)
    worst = max(e_got.values())
    passed = l_got <= LM_GATE * l_ref and worst <= LM_GATE * max(e_ref.values())
    print(f"  remat dots vs none, {n} layers: loss err {l_got:.3e}, worst leaf err {worst:.3e} "
          f"(gate {LM_GATE * l_ref:.3e} / {LM_GATE * max(e_ref.values()):.3e}); B5 launches "
          f"none {none[3]['forward']} / {none[3]['backward']}, dots {dots[3]['forward']} / "
          f"{dots[3]['backward']} {'ok' if passed else 'FAIL'}", flush=True)
    if not passed:
        fail("remat dots: its gradient is outside the bf16 gate of remat none's")
    launches_of = {k: {p: r[3][p] for p in ("forward", "backward")}
                   for k, r in (("none", none), ("dots", dots))}
    del params, ref32, none, dots
    torch.cuda.empty_cache()
    return dict(layers=n, loss_err=l_got, worst_leaf_err=worst, gate_loss=LM_GATE * l_ref,
                gate_leaf=LM_GATE * max(e_ref.values()), launches=launches_of, passed=passed)


PRETRAIN_SUBPROCESSES = (
    # (the commands run one after the other in one directory, what the
    # last line of each must hold)
    ((["-m", "repro_torch.launch.train", "--arch", "gemma2-2b", "--steps", "6", "--batch",
       "2", "--seq", "32"], "device=cuda"),
     (["-m", "repro_torch.launch.train", "--arch", "gemma2-2b", "--steps", "6", "--batch",
       "2", "--seq", "32"], "nothing to do")),
    ((["-m", "repro_torch.examples.train_lm", "--steps", "4"], "final loss"),),
    ((["-m", "repro_torch.examples.serve_lm", "--requests", "2"], "all requests complete"),),
)


def run_chain(chain, tmp):
    """The commands of ``chain`` in turn, with ``tmp`` as their temporary
    directory (the launchers' default checkpoint directories); returns the
    readings, failing on a non-zero exit or a last line without its
    expected text."""
    out = []
    for args, expect in chain:
        cmd = [sys.executable, *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                   "TMPDIR": tmp})
        secs = time.perf_counter() - t0
        line = (proc.stdout.strip().splitlines() or [""])[-1]
        print(f"  {' '.join(args[1:])}: exit {proc.returncode} in {secs:.1f} s; {line}",
              flush=True)
        if proc.returncode != 0 or expect not in line or "device=cuda" not in proc.stdout:
            fail(f"{' '.join(args[1:])} (exit {proc.returncode}; want {expect!r} in its last "
                 f"line and device=cuda):\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        out.append(dict(cmd=args, exit=proc.returncode, seconds=secs, line=line))
    return out


def pretrain_subprocesses():
    """The LM launcher (then rerun on its checkpoint directory, which must
    resume with nothing to do) and both examples as subprocesses on the
    card, the three chains at once, each in a temporary directory of its
    own."""
    import concurrent.futures
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        dirs = [tempfile.mkdtemp(dir=root) for _ in PRETRAIN_SUBPROCESSES]
        with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
            futs = [pool.submit(run_chain, chain, d)
                    for chain, d in zip(PRETRAIN_SUBPROCESSES, dirs)]
            return [f.result() for f in futs]


def pretrain_kernel_specs(dev):
    """B5 at the step's shapes (B 2, S 4608, 8 / 4 heads of 256, softcap
    50; the local layers' window 4096 and the global layers'), as
    :func:`check_kernels` takes them; SDPA has no softcap, so no library
    call."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    b, s = PRETRAIN_BATCH, PRETRAIN_SEQ
    return [dict(name="flash_attention", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:89",
                 symbol="flash_attention_wgmma_kernel", cases=[
        flash_case(randn, f"gemma2-2b local B{b} S{s} Hq8 Hkv4 D256 window4096 cap50", b, s,
                   8, 4, 256, torch.bfloat16, main=True, iters=(10, 5), causal=True,
                   window=4096, softcap=50.0),
        flash_case(randn, f"gemma2-2b global B{b} S{s} Hq8 Hkv4 D256 cap50", b, s, 8, 4, 256,
                   torch.bfloat16, main=True, iters=(10, 5), causal=True, softcap=50.0)])]


def run_lm_pretrain(dev, launches):
    """Phase 5d: LM training of gemma2-2b at full width on PRETRAIN_LAYERS
    of its 26 layers (fp32 params and AdamW state, bf16 compute, every block
    checkpointed, loss chunks of 512; random weights drawn on the card
    from seed 0) on the token pipeline at B 2, S 4608; minitron-4b with
    int8 state; remat "dots" against "none"; the launchers as
    subprocesses; B5 at the step's shapes."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=PRETRAIN_LAYERS)
    if (cfg.remat_policy, cfg.compute_dtype, cfg.param_dtype, cfg.opt_state_dtype,
            cfg.loss_chunk) != ("nothing", "bfloat16", "float32", "float32", 512):
        fail(f"{cfg.name}: expected remat 'nothing', bf16 compute, fp32 params and state, "
             f"loss chunks of 512")
    out = dict(kind="lm_pretrain", arch=cfg.name, batch=PRETRAIN_BATCH, seq=PRETRAIN_SEQ)
    out["parity"] = pretrain_parity(cfg, dev, PRETRAIN_HIDDEN)
    mark("5d: parity and planted faults done")
    out["loop"] = pretrain_loop(cfg, dev)
    mark("5d: loop done")
    launches["lm_pretrain"] = out["loop"]["launches"]
    bound, bf16, f32 = pretrain_bound(cfg, PRETRAIN_BATCH, PRETRAIN_SEQ)
    step_ms = statistics.median(out["loop"]["step_ms"][1:])
    out["bound"] = dict(ms=bound, bf16_flops=bf16, f32_flops=f32,
                        share=bound / step_ms)
    print(f"pretrain bound: {bf16:.4g} bf16 FLOPs at {BF16_FLOPS:.4g}/s + {f32:.4g} f32 "
          f"FLOPs (the unembed) at {FP32_FLOPS:.4g}/s = {bound:.1f} ms a step; the loop's "
          f"median step {step_ms:.1f} ms ({100 * bound / step_ms:.1f} % of the bound's "
          f"rate)", flush=True)
    out["minitron_int8"] = pretrain_minitron(dev)
    mark("5d: minitron-4b done")
    out["dots"] = pretrain_dots(cfg, dev)
    mark("5d: dots done")
    b5 = check_kernels(pretrain_kernel_specs(dev))["flash_attention"]
    out["kernel_cases"], out["kernel_max_abs_err"] = b5["cases"], b5["max_abs_err"]
    cats = out["loop"]["trace"]["categories"]
    b5_ms = cats.get("B5 flash_attention", {}).get("device_ms", 0.0)
    out["b5_share"] = b5_ms / out["loop"]["trace"]["busy_ms"]
    print(f"pretrain B5: {b5_ms:.2f} ms of a step's device time "
          f"({100 * out['b5_share']:.1f} %)", flush=True)
    defer(out, "subprocesses", pretrain_subprocesses)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5d: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5e: training through MoE and MLA: deepseek-v2 at full width
# ---------------------------------------------------------------------------

MOE_TRAIN_ARCH = "deepseek-v2-236b"
# 1 of its 60 layers: 5.02 G params (experts 3.77 G, shared experts 0.047 G,
# MLA 0.149 G, embedding and head 1.05 G) at 8 bytes a param (bf16 params,
# gradients, AdamW mu and nu) are 40.2 GB, and the MLA transcription's
# (B, 128, S, S) fp32 scores come on top
MOE_TRAIN_LAYERS = 1
# B PRETRAIN_BATCH (2) x S 2048: 4096 tokens, a capacity of 200 slots an
# expert (int(4096 * 6 * 1.25 / 160) + 1 = 193, rounded up to 8s)
MOE_TRAIN_SEQ = 2048
MOE_TRAIN_STEPS = 3
# the episodic LM over 2 of its 60 layers: an 18.0 GB frozen bf16 trunk,
# on tasks of phase 5c's ProtoNets concentration (its reason: at 0.3 wide
# features can solve a task with margins past fp32's resolution, a loss and
# gradient of exactly 0, and the gate would hold nothing)
MOE_EPISODIC_LAYERS = 2
MOE_TRAIN_GATE_PREFIXES = ("",)          # the gate reads every leaf


@contextlib.contextmanager
def counted_gmm_products(products: dict):
    """Count into ``products`` the products that B7's backward
    (``dispatch._GMM``) computes in the block, ``dx`` and ``dw``: with
    the launches of a pass, they tell the recompute's launches from the
    backward's own, and a dw on a frozen weight from a dx."""
    from repro_torch.kernels import dispatch
    backward = dispatch._GMM.backward

    def counted(ctx, g):
        dx, dw = backward(ctx, g)
        products["dx"] = products.get("dx", 0) + (dx is not None)
        products["dw"] = products.get("dw", 0) + (dw is not None)
        return dx, dw

    with planted_backward(dispatch._GMM, counted):
        yield


def b7_roles(launches, products):
    """B7's launches of a differentiated pass by role: the forward's, the
    checkpoints' recompute, dx and dw (the backward's launches less its
    products)."""
    fwd, bwd = launches["forward"], launches["backward"]
    dx, dw = products.get("dx", 0), products.get("dw", 0)
    return dict(forward=fwd.get("gmm", 0), recompute=bwd.get("gmm", 0) - dx - dw, dx=dx,
                dw=dw, wgmma=fwd.get("gmm/wgmma", 0) + bwd.get("gmm/wgmma", 0),
                total=fwd.get("gmm", 0) + bwd.get("gmm", 0))


def check_b7_roles(label, launches, products, want, forward_too=()):
    """Fail unless B7's launches by role are ``want``, all on "wgmma", and
    nothing else launched but, in the forward, the kernels ``forward_too``."""
    roles = b7_roles(launches, products)
    other = [k for part in ("forward", "backward") for k in launches[part]
             if not k.startswith("gmm") and not (part == "forward" and
                                                 k.startswith(forward_too))]
    print(f"  {label}: B7 launches forward {roles['forward']}, recompute "
          f"{roles['recompute']}, dx {roles['dx']}, dw {roles['dw']} ({roles['wgmma']} of "
          f"{roles['total']} on wgmma); want {want}", flush=True)
    if {k: roles[k] for k in want} != want or roles["wgmma"] != roles["total"] or other:
        fail(f"{label}: B7 launches {roles} (want {want}, all on wgmma) and {other} "
             f"besides; launches {launches}")
    return roles


@contextlib.contextmanager
def forced_routes(ids: list):
    """The MoE router's expert ids replaced, call by call in order, by
    ``ids`` (another run's, (T, k) each); its weights are its own
    probabilities at those ids, renormalised, and its aux loss reads those
    ids: a run in another precision then sends every token to the experts
    the recorded run sent it to."""
    import torch
    from repro_torch.models import moe as M
    orig, it = M.router_probs, iter(ids)

    def router(p, x, cfg):
        _, _, probs = orig(p, x, cfg)
        top_i = next(it)
        top_p = torch.gather(probs, 1, top_i)
        return top_p / top_p.sum(dim=-1, keepdim=True), top_i, probs

    M.router_probs = router
    try:
        yield
    finally:
        M.router_probs = orig


def forward_routes(cfg, params, batch, backend):
    """The expert ids (T, k) of every router call of one forward of the
    loss on ``backend``, without grad."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.registry import get_api
    timeline = []
    with torch.no_grad(), dispatch.use_backend(backend), recording_routes(timeline):
        get_api(cfg).loss(params, batch, cfg, backend=None)
    return [ids for _, ids in timeline]


def moe_train_grads(cfg, params, batch, backend, force=None):
    """:func:`pretrain_grads` of the MoE model with every router call's
    routing recorded and B7's backward products counted; ``force``: the
    expert ids to route by (:func:`forced_routes`).  Returns (loss, None,
    {path: gradient}, launches, each call's kept experts, products, each
    call's expert ids)."""
    timeline, products = [], {}
    with (forced_routes(force) if force is not None else contextlib.nullcontext()), \
            recording_routes(timeline), counted_gmm_products(products):
        r = pretrain_grads(cfg, params, batch, backend)
    ids = [i for _, i in timeline]
    return (*r, [kept_experts(i, cfg) for i in ids], products, ids)


def b7_backward_faults():
    """(label, backward) of the two faults planted in B7's backward, each
    the Function's own backward with its result spoilt: expert e+1's dw
    written to expert e (the last expert keeps its own), and dx zeroed on
    the last expert's slots."""
    import torch
    from repro_torch.kernels import dispatch
    backward = dispatch._GMM.backward

    def dw_shifted(ctx, g):
        dx, dw = backward(ctx, g)
        return dx, (None if dw is None else torch.cat([dw[1:], dw[-1:]]))

    def dx_last_expert_zeroed(ctx, g):
        dx, dw = backward(ctx, g)
        if dx is not None:
            dx = dx.clone()
            dx[-1] = 0
        return dx, dw

    return (("B7 backward: dw of expert e+1 written to expert e", dw_shifted),
            ("B7 backward: dx zeroed on the last expert's slots", dx_last_expert_zeroed))


def equal_bits(a, b) -> bool:
    """Whether two tensors (or two Nones) hold the same bits."""
    import torch
    if a is None or b is None:
        return a is b
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


def moe_train_parity(cfg, dev):
    """One step's loss and gradient on the kernels, on ``ref`` in bf16 and on
    ``ref`` in fp32 compute, from the same bf16 params (drawn on the card
    from seed 0, each leaf cast as it is drawn) and the pipeline's batch 0,
    through the gate, every routing recorded; the same step again on the
    kernels, which must give the same bits; then the two faults planted in
    B7's backward, which the gate must flag."""
    import dataclasses
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as TT
    params = TT.init_transformer(torch.Generator(device=dev).manual_seed(0), cfg,
                                 at_param_dtype=True)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = pretrain_batch(cfg, 0, dev, seq=MOE_TRAIN_SEQ)
    moe_train_grads(cfg, params, batch, "cuda")             # allocator, cuBLAS
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    n = cfg.n_layers
    # the fp32 run routes as the kernel path does (the backward recomputes
    # the layers last first); its own routing is only counted
    routed = forward_routes(cfg, params, batch, "cuda")
    own32 = [kept_experts(ids, cfg) for ids in forward_routes(cfg32, params, batch, "ref")]
    ref32 = moe_train_grads(cfg32, params, batch, "ref", force=routed + routed[::-1])
    mark("5e: fp32 ref run done")
    ref16 = moe_train_grads(cfg, params, batch, "ref")
    ref16_errs = lm_grad_errs(ref16, ref32, MOE_TRAIN_GATE_PREFIXES)
    ref16_loss, ref16_routes = ref16[0], ref16[4]
    del ref16
    torch.cuda.reset_peak_memory_stats(dev)
    got = moe_train_grads(cfg, params, batch, "cuda")
    step_peak = torch.cuda.max_memory_allocated(dev)
    roles = check_b7_roles(f"{cfg.name} step", got[3], got[5],
                           dict(forward=3 * n, recompute=3 * n, dx=3 * n, dw=3 * n))
    if len(got[6]) != 2 * n or not all(map(equal_bits, got[6], routed + routed[::-1])):
        fail(f"{cfg.name}: the step's forward or its checkpoints' recompute routed otherwise "
             f"than a forward without grad ({len(got[6])} router calls)")
    routes = dict(got=got[4][:n], ref16=ref16_routes[:n], ref32=own32)
    tokens = sum(x.shape[0] for x in routes["got"])
    differ = {f"{a}/{b}": sum(int((x != y).any(dim=1).sum()) for x, y in zip(routes[a], routes[b]))
              for a, b in itertools.combinations(routes, 2)}
    kept = sum(int((x >= 0).sum()) for x in routes["got"])
    print(f"moe train {cfg.name}: {n} layer(s), B {PRETRAIN_BATCH} S {MOE_TRAIN_SEQ}, {n_params} "
          f"params; loss cuda {got[0]:.6g} ref {ref16_loss:.6g} fp32 {ref32[0]:.6g}; "
          f"launches forward {got[3]['forward']}, backward {got[3]['backward']}, products "
          f"{got[5]}; peak of the kernel path's step (params and gradients, no AdamW state) "
          f"{step_peak} B; routings: {tokens} (token, layer) pairs, {kept} of "
          f"{tokens * cfg.moe.top_k} routes kept; left to themselves the runs route "
          f"differently on {differ}.  The fp32 run is given the kernel path's expert ids "
          f"(its own weights at them), so the gate reads every leaf whole, the routed "
          f"experts' too: unforced, a token routed otherwise moves a whole token's share "
          f"of dw from one expert to another, beyond any rounding",
          flush=True)
    gate = lm_train_gate(f"{cfg.name} LM step", dict(got=got, ref32=ref32),
                         MOE_TRAIN_GATE_PREFIXES, ref16_errs=ref16_errs)
    experts = {k: (e, gate["ref16_leaf_errors"][k]) for k, e in gate["leaf_errors"].items()
               if "/ffn/w_" in k and "/shared/" not in k}
    for k, (e, e_ref) in experts.items():
        print(f"    routed experts {k}: {e:.3e} (bf16 ref {e_ref:.3e})", flush=True)
    out = dict(params=n_params, loss=got[0], ref16_loss=ref16_loss, ref32_loss=ref32[0],
               launches={k: got[3][k] for k in ("forward", "backward")}, b7_roles=roles,
               step_peak_bytes=step_peak, routings=dict(pairs=tokens, kept=kept, differ=differ),
               expert_leaf_errors=experts,
               gate={k: v for k, v in gate.items() if not k.endswith("leaf_errors")})
    again = moe_train_grads(cfg, params, batch, "cuda")
    unequal = [k for k, g in got[2].items() if not equal_bits(g, again[2][k])]
    same_routes = all(map(equal_bits, got[4], again[4]))
    print(f"  bits: a second step on the kernels, loss {'equal' if again[0] == got[0] else 'NOT equal'}, "
          f"routings {'equal' if same_routes else 'NOT equal'}, {len(got[2]) - len(unequal)} of "
          f"{len(got[2])} gradient leaves bit-equal{': ' + str(unequal) if unequal else ''}",
          flush=True)
    if unequal or again[0] != got[0] or not same_routes:
        fail(f"{cfg.name}: two identical steps differ (loss, routing or the leaves {unequal})")
    out["bits_equal"] = True
    del again, got
    torch.cuda.empty_cache()
    mark("5e: gate and bits done")
    out["planted_faults"] = []
    for label, fn in b7_backward_faults():
        with planted_backward(dispatch._GMM, fn):
            bad = moe_train_grads(cfg, params, batch, "cuda")
        r = lm_train_gate(f"planted fault: {label}", dict(got=bad, ref32=ref32),
                          MOE_TRAIN_GATE_PREFIXES, fault=True, ref16_errs=ref16_errs)
        out["planted_faults"].append(dict(fault=label, **{
            k: v for k, v in r.items() if not k.endswith("leaf_errors")}))
        del bad
    del ref32, params
    torch.cuda.empty_cache()
    return out


def moe_train_loop(cfg, dev):
    """MOE_TRAIN_STEPS steps of ``make_train_step`` through ``train()`` from
    ``make_init_state`` (seed 0: the parity's weights) on the pipeline's
    batches, no checkpoint, the launch counts set to 0 just before and read
    just after; then one step timed and one profiled."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.train.loop import train
    from repro_torch.train.step import adamw_for, make_init_state, make_train_step
    state = make_init_state(cfg, adamw_for(cfg))(torch.Generator(device=dev).manual_seed(0),
                                                 dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    held = torch.cuda.memory_allocated(dev)
    step = make_train_step(cfg, adamw_for(cfg))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    result = train(state, step, lambda s: pretrain_batch(cfg, s, dev, seq=MOE_TRAIN_SEQ),
                   MOE_TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize(dev)
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in result.metrics_history]
    ms = [t * 1e3 for t in result.step_times]
    tokens = PRETRAIN_BATCH * MOE_TRAIN_SEQ
    tok_s = tokens * (len(ms) - 1) / (sum(ms[1:]) / 1e3)
    reckoned = state_bytes(n_params, cfg.opt_state_dtype, cfg.param_dtype)
    print(f"moe train loop: {cfg.name}, {MOE_TRAIN_STEPS} steps of B {PRETRAIN_BATCH} S "
          f"{MOE_TRAIN_SEQ}, losses {losses}, ms per step {ms}, {tok_s:.1f} tokens/s (first "
          f"step excluded), peak memory {peak} B against {reckoned} B reckoned for bf16 "
          f"params, grads and AdamW state ({n_params} params; {held} B held before the "
          f"loop), launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in losses) or any(
            m["nonfinite"] for m in result.metrics_history):
        fail(f"moe train loop: losses {losses}, metrics {result.metrics_history}")
    n = MOE_TRAIN_STEPS * 12 * cfg.n_layers
    if counts != {"gmm": n, "gmm/wgmma": n}:
        fail(f"moe train loop: launches {counts}; want B7 {n} times on wgmma (the forward, "
             f"the checkpoints' recompute, dx and dw of 3 projections, {cfg.n_layers} "
             f"layer(s) a step) and nothing else")
    if peak >= 80e9:
        fail(f"moe train loop: peak memory {peak} B does not fit the 80 GB card")
    batch = pretrain_batch(cfg, MOE_TRAIN_STEPS, dev, seq=MOE_TRAIN_SEQ)
    wall = _counted(lambda: step(state, batch))[2]
    busy, cats, table = device_breakdown(
        lambda: step(state, batch), MOE_CATEGORIES,
        lambda busy, _: f"  moe train trace: device busy {busy:.2f} ms of an unprofiled step "
                        f"of {wall:.2f} ms (idle share {1 - busy / wall:.3f})", 15)
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=ms, tokens_per_s=tok_s, peak_bytes=peak,
                reckoned_bytes=reckoned, params=n_params, held_bytes=held, launches=counts,
                trace=dict(busy_ms=busy, step_wall_ms=wall, idle_share=1 - busy / wall,
                           categories=cats, top=table[:40]))


def moe_train_kernel_specs(cfg, dev):
    """B7 at the training step's shapes (E 160, C 200, D 5120, F 1536): the
    forward (and the recompute) x @ w, dx = g w^T and dw = x^T g (K = C =
    200, not a multiple of B7's 64-deep slab), on the transposed views of
    the stored w and x that the Function hands the kernel (no copy),
    against its plain version, timed beside ``torch.bmm`` on the same views
    and the bytes bound."""
    import torch
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    g = torch.Generator(device=dev).manual_seed(9)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    c = M.capacity(PRETRAIN_BATCH * MOE_TRAIN_SEQ, cfg.moe)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    w = randn(e, d, f, scale=d ** -0.5)
    x, dout = randn(e, c, d), randn(e, c, f)
    w_t, x_t = w.transpose(1, 2), x.transpose(1, 2)      # views, as _GMM.backward hands them
    cases = []
    for label, a, b in (("forward x @ w", x, w), ("dx = g @ w^T", dout, w_t),
                        ("dw = x^T @ g", x_t, dout)):
        ee, m, k = a.shape
        n = b.shape[2]
        cases.append(dict(
            label=f"deepseek train {label} E{ee} M{m} K{k} N{n}", fn=ops.gmm,
            plain=gm.gmm_plain, lib=torch.bmm, route=gm.gmm_route(a, b), args=(a, b),
            tol=OPS_TOL["gmm"]["bfloat16"], main=True, iters=(3, 3),
            bytes=a.element_size() * (ee * m * k + ee * k * n + ee * m * n),
            flops=2.0 * ee * m * k * n, peak=BF16_FLOPS))
    return [dict(name="gmm", source="src/repro_torch/kernels/csrc/gmm.cu",
                 replaces="src/repro/kernels/gmm.py:37", symbol="gmm_wgmma_kernel",
                 cases=cases)]


def moe_episodic(dev, launches):
    """Simple CNAPs (``tokens`` encoder) over deepseek-v2 at full width and
    MOE_EPISODIC_LAYERS layers, the trunk frozen in bf16 as drawn: one LITE
    step on the kernels gated against ``ref`` in bf16 and in fp32 compute
    (phase 5c's gate), B7's launches by role (forward, the recompute, dx;
    a dw fails the phase) and B1-B3's; then LM_TRAIN_STEPS steps through
    the example's step, the launch counts set to 0 just before and read
    just after."""
    import dataclasses
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.core.lite import LiteSpec
    from repro_torch.examples.episodic_lm import make_meta_step
    from repro_torch.kernels import _build
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_EPISODIC_LAYERS)
    learner = lm_learner("simple_cnaps", cfg)
    params = learner.init(torch.Generator(device=dev).manual_seed(0), dev)
    trunk = tree_leaves(params["bb"])
    if {t.dtype for t in trunk} != {torch.bfloat16}:
        fail(f"{cfg.name}: the trunk is not drawn in bf16: {({t.dtype for t in trunk})}")
    trunk_bytes = sum(t.numel() * t.element_size() for t in trunk)
    batch, scores = lm_tasks(cfg, LM_TRAIN_TASKS, 0, dev, concentration=LM_PROTO_CONCENTRATION)
    lm_grads(learner, params, batch, scores, "cuda")            # allocator, cuBLAS
    products, timeline, timeline16 = {}, [], []
    with counted_gmm_products(products), recording_routes(timeline):
        got = lm_grads(learner, params, batch, scores, "cuda")
    with recording_routes(timeline16):
        ref16 = lm_grads(learner, params, batch, scores, "ref")
    # the fp32 run routes as the kernel path does, call by call (phase 5e's
    # LM step says why)
    with forced_routes([ids for _, ids in timeline]):
        ref32 = lm_grads(lm_learner("simple_cnaps", dataclasses.replace(
            cfg, compute_dtype="float32")), params, batch, scores, "ref")
    runs = dict(got=got, ref16=ref16, ref32=ref32)
    differ = sum(int((kept_experts(a, cfg) != kept_experts(b, cfg)).any(dim=1).sum())
                 for (_, a), (_, b) in zip(timeline, timeline16))
    pairs = sum(ids.shape[0] for _, ids in timeline)
    del timeline, timeline16
    n = cfg.n_layers
    n_comp = LM_TASK["way"] * LM_TASK["shot"] - LM_TRAIN_LITE["h"]
    passes = -(-n_comp // LM_TRAIN_LITE["chunk_size"]) + 2     # H, chunks, queries
    # the first layer's MoE input needs no gradient (frozen embedding and
    # attention; FiLM comes after the FFN residual): dx from the second on
    want = dict(forward=3 * n * passes, recompute=3 * n * 2, dx=3 * (n - 1) * 2, dw=0)
    print(f"train lm moe: {cfg.name}, {n} layers ({trunk_bytes} B of frozen bf16 trunk), T "
          f"{batch.num_tasks}, loss cuda {got[0]:.6g} ref {runs['ref16'][0]:.6g} fp32 "
          f"{runs['ref32'][0]:.6g} (routed as the kernel path), accuracy {got[1]:.3f}; "
          f"launches forward {got[3]['forward']}, backward {got[3]['backward']}; products "
          f"{products}; the kernel path and bf16 ref route {differ} of {pairs} (token, layer) "
          f"pairs differently", flush=True)
    roles = check_b7_roles(f"{cfg.name} simple_cnaps LITE step", got[3], products, want,
                           forward_too=("segment_sum", "class_second_moment", "mahalanobis"))
    _need("train lm moe forward", got[3]["forward"],
          ("segment_sum", "class_second_moment", "mahalanobis"))
    out = dict(arch=cfg.name, layers=n, trunk_bytes=trunk_bytes, loss=got[0],
               ref16_loss=runs["ref16"][0], ref32_loss=runs["ref32"][0], accuracy=got[1],
               launches=got[3], b7_roles=roles, routings=dict(pairs=pairs, differ=differ),
               gate={k: v for k, v in lm_train_gate(
                   f"{cfg.name} simple_cnaps LITE step", runs, ("enc/", "film_gen/")).items()
                   if not k.endswith("leaf_errors")})
    del runs, got
    torch.cuda.empty_cache()
    mark("5e: episodic gate done")

    step = make_meta_step(learner, LiteSpec(**LM_TRAIN_LITE))
    data = [lm_tasks(cfg, LM_TRAIN_TASKS, s, dev, concentration=LM_PROTO_CONCENTRATION)
            for s in range(LM_TRAIN_STEPS)]
    losses, ms, products = [], [], {}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    with counted_gmm_products(products):
        for s in range(LM_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, loss, _ = step(params, *data[s])
            losses.append(float(loss))           # reads the loss back: synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize(dev)
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    tasks_per_s = LM_TRAIN_TASKS * (LM_TRAIN_STEPS - 1) / (sum(ms[1:]) / 1e3)
    n_b7 = LM_TRAIN_STEPS * sum(want.values())
    print(f"train lm moe loop: {LM_TRAIN_STEPS} steps of T {LM_TRAIN_TASKS}, losses {losses}, "
          f"ms per step {ms}, tasks/s {tasks_per_s:.3f} (first step excluded), peak memory "
          f"{peak} B, launches {counts}, B7 products {products}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"train lm moe loop: losses {losses}")
    if counts.get("gmm") != n_b7 or counts.get("gmm/wgmma") != n_b7 or products.get("dw"):
        fail(f"train lm moe loop: B7 launches {counts}, products {products}; want {n_b7} on "
             f"wgmma ({want} a step) and no dw")
    _need("train lm moe loop", counts, ("segment_sum", "class_second_moment", "mahalanobis"),
          LM_TRAIN_STEPS)
    launches["lm_moe_episodic"] = counts
    out.update(loop=dict(losses=losses, step_ms=ms, tasks_per_s=tasks_per_s, peak_bytes=peak,
                         launches=counts, products=products))
    del learner, params, data, step
    torch.cuda.empty_cache()
    return out


def run_moe_train_launcher():
    """``python -m repro_torch.launch.train --arch deepseek-v2-236b --steps
    3`` (its smoke config: MLA and MoE) on the card as a subprocess, which
    must exit 0 on ``device=cuda``."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return run_chain([(["-m", "repro_torch.launch.train", "--arch", MOE_TRAIN_ARCH,
                            "--steps", "3"], "device=cuda")], tmp)


def run_moe_train(dev, launches):
    """Phase 5e: training through MoE and MLA.  LM training of deepseek-v2
    at full width and MOE_TRAIN_LAYERS layer(s) as published (bf16 params
    and AdamW state, bf16 compute, every block checkpointed, loss chunks of
    512; random weights drawn on the card from seed 0) at B 2 x S 2048; B7
    at the step's shapes, forward and backward; the episodic LM over
    MOE_EPISODIC_LAYERS layers; the launcher as a subprocess."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS)
    if (cfg.remat_policy, cfg.compute_dtype, cfg.param_dtype, cfg.opt_state_dtype,
            cfg.loss_chunk) != ("nothing", "bfloat16", "bfloat16", "bfloat16", 512):
        fail(f"{cfg.name}: expected remat 'nothing', bf16 compute, params and AdamW state, "
             f"loss chunks of 512")
    out = dict(kind="lm_moe_train", arch=cfg.name, layers=cfg.n_layers, batch=PRETRAIN_BATCH,
               seq=MOE_TRAIN_SEQ)
    out["parity"] = moe_train_parity(cfg, dev)
    mark("5e: parity and planted faults done")
    out["loop"] = moe_train_loop(cfg, dev)
    launches["lm_moe_train"] = out["loop"]["launches"]
    mark("5e: loop done")
    kept = out["parity"]["routings"]["kept"]
    bound, by, bf16, f32, nbytes = moe_train_bound(cfg, PRETRAIN_BATCH, MOE_TRAIN_SEQ, kept,
                                                   out["loop"]["params"])
    step_ms = statistics.median(out["loop"]["step_ms"][1:])
    out["bound"] = dict(ms=bound, by=by, bf16_flops=bf16, f32_flops=f32, bytes=nbytes,
                        share=bound / step_ms)
    print(f"moe train bound: {bf16:.4g} bf16 FLOPs at {BF16_FLOPS:.4g}/s + {f32:.4g} f32 FLOPs "
          f"(MLA's transcription, the router, the unembed) at {FP32_FLOPS:.4g}/s, {nbytes:.4g} "
          f"B of state: {bound:.1f} ms a step ({by}); the loop's median step {step_ms:.1f} ms "
          f"({100 * bound / step_ms:.1f} % of the bound's rate)", flush=True)
    specs = moe_train_kernel_specs(cfg, dev)
    row = check_kernels(specs)["gmm"]
    if any(t["route"] != "wgmma" for t in row["cases"]):
        fail(f"{cfg.name}: B7 at the training step's shapes took routes {row['routes']}")
    out["kernel_cases"], out["kernel_max_abs_err"] = row["cases"], row["max_abs_err"]
    cats = out["loop"]["trace"]["categories"]
    b7_ms = cats.get("B7 gmm", {}).get("device_ms", 0.0)
    out["b7_share"] = b7_ms / out["loop"]["trace"]["busy_ms"]
    print(f"moe train B7: {b7_ms:.2f} ms of a step's device time "
          f"({100 * out['b7_share']:.1f} %)", flush=True)
    del specs, row
    torch.cuda.empty_cache()
    mark("5e: B7 cases done")
    out["episodic"] = moe_episodic(dev, launches)
    mark("5e: episodic loop done")
    defer(out, "launcher", run_moe_train_launcher)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5e: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5f: training through the SSM and hybrid models
# ---------------------------------------------------------------------------

# mamba2-780m at full width and depth: B 2 x S 4096 (16 chunks of 256 a
# sequence), fp32 params and AdamW state (12.5 GB)
SSM_TRAIN_SEQ = 4096
# zamba2-7b at full width on 12 of its 81 layers: 2 groups of 5 mamba layers
# and the shared block (so its gradient sums two sites), then 2 tail mamba
# layers.  Full depth would need 16 B a param for 5.62 G params, 90 GB
ZAMBA_TRAIN_LAYERS = 12
SSM_TRAIN_LAYERS = 24            # mamba2-780m in phase 5f (all 48 before phase 5h)
ZAMBA_TRAIN_SEQ = 2048
def ssm_bwd_want(cfg, passes: int = 1):
    """The backward kernels' launches of ``passes`` differentiated passes:
    B6's (K6b) on "wgmma" once a mamba layer, B5's (K5b) on "wgmma" once a
    shared site, dq and dk / dv each time."""
    nm, sites, _ = ssm_shape(cfg)
    return {"ssd_chunk_bwd": passes * nm, "ssd_chunk_bwd/wgmma": passes * nm} \
        | b5_bwd_want(passes * sites)


def ssm_steps_want(cfg, dev, steps: int):
    """The launches of ``steps`` training steps: each step's forward, its
    checkpoints' recompute (:func:`ssm_want`) and its backward kernels
    (:func:`ssm_bwd_want`)."""
    fwd, rec = ssm_want(cfg, dev, steps), ssm_want(cfg, dev, steps, recompute=True)
    return {k: fwd.get(k, 0) + rec.get(k, 0) for k in fwd} | ssm_bwd_want(cfg, steps)


def b6_dt_head_zeroed(nh: int):
    """(label, make): B6's backward kernel (``ssd_chunk_bwd``) with dt's
    gradient zeroed for head 0 of every chunk (G is (b, nc, h) flattened,
    h = ``nh``), for :func:`planted_kernel`."""
    def dt_head_zeroed(kernel):
        def run(*a, **kw):
            gx, gdt, *rest = kernel(*a, **kw)
            gdt.view(-1, nh, gdt.shape[-1])[:, 0] = 0
            return (gx, gdt, *rest)
        return run

    return "B6 backward kernel: dt's gradient zeroed for head 0", dt_head_zeroed


def ssm_check_step(label, cfg, r, dev):
    """Fail unless one step's forward launched B6 on "wgmma" once a mamba
    layer and B5 once a shared site, the backward B6 once a mamba layer
    (the checkpoints' recompute) and the backward kernels (K6b once a mamba
    layer, K5b once a shared site), and nothing else."""
    want = dict(forward=ssm_want(cfg, dev),
                backward=ssm_want(cfg, dev, recompute=True) | ssm_bwd_want(cfg))
    got = {part: r[part] for part in ("forward", "backward")}
    if got != want:
        fail(f"{label}: launches {got}; want {want}")


def ssm_train_parity(cfg, dev, seq: int, plant: bool):
    """One step's loss and gradient on the kernels, on ``ref`` in bf16 and on
    ``ref`` in fp32 compute, from the same params (drawn on the card from
    seed 0) and the pipeline's batch 0, through the gate read leaf by leaf
    too (at mamba2-780m's 48 layers the embedding's bf16 gradient is 0.10
    of its max from the fp32 run's, which sets the worst-leaf gate wider
    than a fault in one head's dt moves ``dt_bias``); the same step again
    on the kernels, which must give the same bits; with ``plant``, the
    fault planted on B6's backward kernel, which the gate must flag."""
    import dataclasses
    import torch
    from repro_torch.kernels import ssd_scan as _ssd
    from repro_torch.models.registry import get_api
    params = get_api(cfg).init(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = pretrain_batch(cfg, 0, dev, seq)
    ref32 = pretrain_grads(dataclasses.replace(cfg, compute_dtype="float32"), params, batch,
                           "ref")
    ref16 = pretrain_grads(cfg, params, batch, "ref")
    ref16_errs = lm_grad_errs(ref16, ref32, PRETRAIN_GATE_PREFIXES)
    ref16_loss = ref16[0]
    del ref16
    got = pretrain_grads(cfg, params, batch, "cuda")
    ssm_check_step(f"{cfg.name} step", cfg, got[3], dev)
    again = pretrain_grads(cfg, params, batch, "cuda")
    same = got[0] == again[0] and all(equal_bits(got[2][k], again[2][k]) for k in got[2])
    del again
    nm, sites, _ = ssm_shape(cfg)
    print(f"train ssm {cfg.name}: {cfg.n_layers} layers ({nm} mamba, {sites} shared sites), "
          f"B {PRETRAIN_BATCH} S {seq}, loss cuda {got[0]:.6g} ref {ref16_loss:.6g} fp32 "
          f"{ref32[0]:.6g}; launches forward {got[3]['forward']}, backward "
          f"{got[3]['backward']}; a second identical step bit-equal: {same}", flush=True)
    if not same:
        fail(f"{cfg.name}: two identical steps on the kernels gave different bits")
    out = dict(loss=got[0], ref16_loss=ref16_loss, ref32_loss=ref32[0], bit_equal=same,
               launches={k: got[3][k] for k in ("forward", "backward")},
               gate=pretrain_gate(f"{cfg.name} LM step", got, ref32, ref16_errs,
                                  per_leaf=True))
    del got
    if plant:
        label, make = b6_dt_head_zeroed(cfg.ssm.n_heads(cfg.d_model))
        with planted_kernel(_ssd, "ssd_chunk_bwd", make):
            bad = pretrain_grads(cfg, params, batch, "cuda")
        out["planted_fault"] = dict(fault=label, **pretrain_gate(
            f"planted fault: {label}", bad, ref32, ref16_errs, fault=True, per_leaf=True))
        del bad
    del ref32, params
    torch.cuda.empty_cache()
    return out


SSM_PROTO_LAYERS = 12          # ProtoNets over mamba2-780m (48 before phase 5h)


def ssm_episodic(dev, launches):
    """Simple CNAPs and ProtoNets (``tokens`` set encoder) over mamba2-780m
    at full width, Simple CNAPs at full depth and ProtoNets at
    SSM_PROTO_LAYERS, phase 5c's tasks and gate (ProtoNets' tasks at
    concentration LM_PROTO_CONCENTRATION), LITE h 8: one step each on the
    kernels against ``ref`` in bf16 and in fp32 compute.  B6 runs once a
    layer for each pass of the forward (the H pass, the no-grad complement
    chunks, the queries): inside its autograd Function where the trunk is
    trained (ProtoNets, whose checkpoints' recompute runs it again for the
    H pass and the queries), as the bare wrapper where nothing in the trunk
    needs grad (the complement; Simple CNAPs' frozen trunk, FiLM'd only at
    its final states).  B1-B3 at F 1536."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    full = get_config("mamba2-780m")
    n_comp = LM_TASK["way"] * LM_TASK["shot"] - LM_TRAIN_LITE["h"]
    passes = -(-n_comp // LM_TRAIN_LITE["chunk_size"]) + 2      # H, chunks, queries
    out = {}
    for kind, prefixes, kernels in (
            ("simple_cnaps", ("enc/", "film_gen/"),
             ("segment_sum", "class_second_moment", "mahalanobis")),
            ("protonets", ("bb/",), ("segment_sum",))):
        # ProtoNets trains every weight of the trunk: SSM_PROTO_LAYERS of them
        cfg = dataclasses.replace(full, n_layers=SSM_PROTO_LAYERS) if kind == "protonets" \
            else full
        n = cfg.n_layers
        learner = lm_learner(kind, cfg)
        params = learner.init(torch.Generator(device=dev).manual_seed(0), dev)
        kw = dict(concentration=LM_PROTO_CONCENTRATION) if kind == "protonets" else {}
        batch, scores = lm_tasks(cfg, LM_TRAIN_TASKS, 0, dev, **kw)
        r = lm_parity(kind, cfg, params, batch, scores, prefixes)
        fwd, bwd = r["launches"]["forward"], r["launches"]["backward"]
        n_bwd = 2 * n if kind == "protonets" else 0
        want = (passes * n, n_bwd)
        got = tuple((part.get("ssd_chunk", 0), part.get("ssd_chunk/wgmma", 0)) for part in
                    (fwd, bwd))
        k6b = (bwd.get("ssd_chunk_bwd", 0), bwd.get("ssd_chunk_bwd/wgmma", 0))
        if got != tuple((w, w) for w in want) or k6b != (n_bwd, n_bwd) or any(
                not k.startswith("ssd_chunk") for k in bwd):
            fail(f"train ssm {kind}: launches forward {fwd}, backward {bwd}; want B6 on "
                 f"wgmma {want[0]} times in the forward ({passes} passes of {n} layers) and "
                 f"{want[1]} in the backward, its backward kernel on wgmma {n_bwd} times, and "
                 f"nothing else there")
        _need(f"train ssm {kind} forward", fwd, kernels)
        out[kind] = r
        del learner, params, batch, scores
        torch.cuda.empty_cache()
        mark(f"5f: episodic {kind} done")
    launches["lm_ssm_episodic"] = out["simple_cnaps"]["launches"]["forward"]
    return out


def run_ssm_train_launcher():
    """``python -m repro_torch.launch.train --arch mamba2-780m --steps 3``
    (its smoke config) on the card as a subprocess, which must exit 0 on
    ``device=cuda``."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return run_chain([(["-m", "repro_torch.launch.train", "--arch", "mamba2-780m",
                            "--steps", "3"], "device=cuda")], tmp)


def ssm_train_loop(cfg, dev, seq: int, label: str):
    """:func:`pretrain_loop` for an SSM or hybrid config, with its launches
    and categories, beside the step's bound: the forward's FLOPs three
    times (the recompute not counted) at the bf16 peak, the fp32 unembed at
    the fp32 rate."""
    r = pretrain_loop(cfg, dev, seq, want=ssm_steps_want(cfg, dev, PRETRAIN_STEPS),
                      categories=SSM_CATEGORIES, label=label)
    bound, bf16, f32 = ssm_train_bound(cfg, PRETRAIN_BATCH, seq)
    step_ms = statistics.median(r["step_ms"][1:])
    b6 = r["trace"]["categories"].get("B6 ssd_chunk", {}).get("device_ms", 0.0)
    r.update(bound=dict(ms=bound, bf16_flops=bf16, f32_flops=f32, share=bound / step_ms),
             b6_ms=b6, b6_share=b6 / max(r["trace"]["busy_ms"], 1e-9))
    print(f"{label} bound: {bf16:.4g} bf16 FLOPs + {f32:.4g} f32 FLOPs = {bound:.1f} ms a "
          f"step; the loop's median step {step_ms:.1f} ms ({100 * bound / step_ms:.1f} % of "
          f"the bound's rate); B6 {b6:.2f} ms of a step's device time "
          f"({100 * r['b6_share']:.1f} %)", flush=True)
    return r


def run_ssm_train(dev, launches):
    """Phase 5f: training through the SSM and hybrid models.  LM training of
    mamba2-780m at full width on SSM_TRAIN_LAYERS of its 48 layers (fp32 params and
    AdamW state, bf16 compute, every block checkpointed, loss chunks of
    512; random weights drawn on the card from seed 0) at B 2 x S 4096;
    zamba2-7b at full width on ZAMBA_TRAIN_LAYERS layers at B 2 x S 2048;
    the episodic LM over mamba2-780m; B6 and B5 at the steps' shapes; the
    launcher as a subprocess."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=SSM_TRAIN_LAYERS)
    zcfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=ZAMBA_TRAIN_LAYERS)
    for c in (cfg, zcfg):
        if (c.remat_policy, c.compute_dtype, c.param_dtype, c.opt_state_dtype,
                c.loss_chunk) != ("nothing", "bfloat16", "float32", "float32", 512):
            fail(f"{c.name}: expected remat 'nothing', bf16 compute, fp32 params and AdamW "
                 f"state, loss chunks of 512")
    out = dict(kind="lm_ssm_train", arch=cfg.name, batch=PRETRAIN_BATCH, seq=SSM_TRAIN_SEQ)
    out["parity"] = ssm_train_parity(cfg, dev, SSM_TRAIN_SEQ, plant=True)
    mark("5f: mamba2-780m parity and planted fault done")
    out["loop"] = ssm_train_loop(cfg, dev, SSM_TRAIN_SEQ, "train ssm")
    launches["lm_ssm_train"] = out["loop"]["launches"]
    mark("5f: mamba2-780m loop done")
    out["zamba2"] = dict(layers=zcfg.n_layers, seq=ZAMBA_TRAIN_SEQ,
                         parity=ssm_train_parity(zcfg, dev, ZAMBA_TRAIN_SEQ, plant=False))
    mark("5f: zamba2-7b parity done")
    out["zamba2"]["loop"] = ssm_train_loop(zcfg, dev, ZAMBA_TRAIN_SEQ, "train hybrid")
    launches["lm_ssm_train_zamba2"] = out["zamba2"]["loop"]["launches"]
    mark("5f: zamba2-7b loop done")
    out["episodic"] = ssm_episodic(dev, launches)
    b = PRETRAIN_BATCH
    rows = check_kernels(ssm_path_specs(dev, [
        (f"mamba2-780m train B{b} S{SSM_TRAIN_SEQ} G{b * SSM_TRAIN_SEQ // 256 * 48} Q256 P64 "
         f"N128 fp32", b * SSM_TRAIN_SEQ // 256 * 48, 64, 128),
        (f"zamba2-7b train B{b} S{ZAMBA_TRAIN_SEQ} G{b * ZAMBA_TRAIN_SEQ // 256 * 112} Q256 "
         f"P64 N64 fp32", b * ZAMBA_TRAIN_SEQ // 256 * 112, 64, 64)],
        [(f"zamba2-7b train B{b} S{ZAMBA_TRAIN_SEQ} Hq32 Hkv32 D112 causal", b,
          ZAMBA_TRAIN_SEQ)]))
    if any(r != "wgmma" for r in rows["ssd_chunk"]["routes"]):
        fail(f"B6 at the training steps' shapes took routes {rows['ssd_chunk']['routes']}")
    if any(r != "wgmma" for r in rows["flash_attention"]["routes"]):
        fail(f"B5 at zamba2's training shapes took routes {rows['flash_attention']['routes']}")
    out["ssd_kernel"], out["flash_kernel"] = rows["ssd_chunk"], rows["flash_attention"]
    torch.cuda.empty_cache()
    defer(out, "launcher", run_ssm_train_launcher)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5f: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5g: data-parallel meta-training, one process a rank
# ---------------------------------------------------------------------------

DP_TOL = TRAIN_TOL["simple_cnaps"]
DP_RANK_TIMEOUT = 400.0
# cuDNN and cuBLAS pick deterministic algorithms in the ranks, so that one
# step computed twice, or by two processes, is bit-equal
DP_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def dp_setup(dev):
    """Phase 5's full-width Simple CNAPs (seed 0) and a T 8 batch of its task
    shape from the device sampler (seed 17, step 0), H scores of (0, 0)."""
    import torch
    from repro_torch.core.lite import index_scores
    from repro_torch.data.episodic import EpisodicImageConfig, task_batch_at
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    learner, params = build_model("simple_cnaps", dev)
    cfg = EpisodicImageConfig(way=5, shot=10, query_per_class=6, image_size=IMAGE_SIZE)
    batch = task_batch_at(17, cfg, TRAIN_TASKS, 0, dev)
    scores = index_scores(0, 0, range(TRAIN_TASKS), batch.support_y.shape[1], dev)
    return learner, params, batch, scores


def dp_step(learner, mesh, **kw):
    """The task-batched step on the kernels (backend ``cuda``), phase 5's
    LITE, AdamW without weight decay."""
    from repro_torch.core.episodic_train import make_batched_meta_train_step
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import dispatch
    from repro_torch.optim.adamw import AdamWConfig
    inner = make_batched_meta_train_step(learner, LiteSpec(**TRAIN_LITE),
                                         adamw=AdamWConfig(weight_decay=0.0), mesh=mesh, **kw)

    def step(*args):
        with dispatch.use_backend("cuda"):
            return inner(*args)

    return step


def _timed(fn, dev):
    """(fn's result, its synchronised ms, the kernel launches it made)."""
    import torch
    from repro_torch.kernels import _build
    torch.cuda.synchronize(dev)
    _build.launches.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3, _build.launches.snapshot()


def dp_errors(got, ref):
    """(params, opt, metrics) of a step against ``ref``'s, each relative: the
    loss; each gradient leaf, read as AdamW's first moment after one update
    from a fresh state (mu = (1 - b1) g), against its leaf's max; the params,
    over the elements whose reference gradient exceeds the gradient
    tolerance of its leaf's largest (as phase 5's ``update_errors``)."""
    from repro_torch.common.tree import tree_paths
    p, o, m = got
    rp, ro, rm = ref
    loss = abs(float(m["loss"]) - float(rm["loss"])) / abs(float(rm["loss"]))
    gm, rmu = tree_paths(o["mu"]), tree_paths(ro["mu"])
    grad = max(float((gm[k] - v).abs().max()) / float(v.abs().max()) if float(v.abs().max()) > 0
               else float(gm[k].abs().max()) for k, v in rmu.items())
    pp, rpp = tree_paths(p), tree_paths(rp)
    params = 0.0
    for k, v in rpp.items():
        g = rmu[k].abs()
        keep = g > DP_TOL["grad"] * float(g.max())
        if keep.any():
            params = max(params, float((pp[k] - v).abs()[keep].max()) /
                         max(float(v.abs().max()), 1e-30))
    ok = loss <= DP_TOL["loss"] and grad <= DP_TOL["grad"] and params <= DP_TOL["params"]
    return dict(loss_err=loss, grad_err=grad, params_err=params, ok=ok)


def _digest(tree) -> str:
    """A hash of every leaf's bytes, to show two ranks hold the same state."""
    import hashlib
    import torch
    from repro_torch.common.tree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def dp_rank_nccl1(out_dir):
    """Phase 5g (a), one rank on NCCL: the (1, 1) mesh's ``pmean`` step
    bit-equal to the ``mesh=None`` step; its ``compressed`` step bit-equal
    to quantize, dequantize and sum on one card."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.core.episodic_train import init_ef_state, make_batched_meta_grads
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_two_level_dp_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.clip import clip_by_global_norm
    from repro_torch.optim.compress import ef_compress, zeros_error
    dev = init_distributed("cuda", backend="nccl", init_method=os.environ["RANKS_INIT_METHOD"])
    mesh = make_two_level_dp_mesh(1, 1)
    learner, params, batch, scores = dp_setup(dev)
    cfg = AdamWConfig(weight_decay=0.0)
    opt = adamw_init(params, cfg)
    single = dp_step(learner, None)
    single(params, opt, batch, scores)                     # cuDNN / allocator warm-up
    ref, ms_single, _ = _timed(lambda: single(params, opt, batch, scores), dev)
    pmean = dp_step(learner, mesh)
    pmean(params, opt, batch, scores)                      # NCCL's communicators start
    collectives.counter.reset()
    got, ms_mesh, counts = _timed(lambda: pmean(params, opt, batch, scores), dev)
    coll = collectives.counter.snapshot()
    pmean_equal = _bit_equal(got[0], ref[0]) and _bit_equal(got[1], ref[1]) and \
        torch.equal(got[2]["loss"], ref[2]["loss"])
    opt_c = dict(opt, ef=init_ef_state(params, 1))
    collectives.counter.reset()
    pc, oc, mc = dp_step(learner, mesh, grad_reduce="compressed")(params, opt_c, batch, scores)
    coll_c = collectives.counter.snapshot()
    with dispatch.use_backend("cuda"):
        _, _, g = make_batched_meta_grads(learner, LiteSpec(**TRAIN_LITE))(params, batch, scores)
    g_hat, err = ef_compress(g, zeros_error(g))
    g_hat, _ = clip_by_global_norm(tree_map(lambda x: x / 1, g_hat), 10.0)
    pw, _ = adamw_update(params, g_hat, opt, 1e-3, cfg)
    comp_equal = _bit_equal(pc, pw) and _bit_equal(tree_map(lambda e: e[0], oc["ef"]), err)
    torch.save(dict(params=ref[0], opt=ref[1], metrics=ref[2]),
               os.path.join(out_dir, "single.pt"))
    return dict(backend=mesh.backend, device=str(dev), pmean_bit_equal=pmean_equal,
                compressed_bit_equal=comp_equal, loss=float(ref[2]["loss"]),
                single_ms=ms_single, mesh_ms=ms_mesh, launches=counts, collectives=coll,
                collectives_compressed=coll_c)


def dp_rank_gloo4(out_dir):
    """Phase 5g (b), one of 4 ranks of a 2 x 2 mesh on gloo, every rank on
    the one card: the ``pmean`` step against (a)'s ``mesh=None`` step,
    ``accum_steps`` 2 against 1, ``compressed`` against the composition
    (rank 0), the launches and collectives of each, a NaN in rank 3's tasks."""
    import dataclasses
    import torch
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.core.episodic_train import (init_ef_state, make_batched_meta_grads,
                                                 take_tasks)
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_two_level_dp_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.clip import clip_by_global_norm
    from repro_torch.optim.compress import compressed_scale_bytes, ef_compress, zeros_error
    from repro_torch.roofline import dp_payloads
    dev = init_distributed("cuda", backend="gloo", init_method=os.environ["RANKS_INIT_METHOD"])
    mesh = make_two_level_dp_mesh(2, 2)
    learner, params, batch, scores = dp_setup(dev)
    cfg = AdamWConfig(weight_decay=0.0)
    opt = adamw_init(params, cfg)
    single = torch.load(os.path.join(out_dir, "single.pt"), map_location=dev)
    ref = (single["params"], single["opt"], single["metrics"])
    pbytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    out = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev), backend=mesh.backend)

    def run(name, fn, want_payload):
        collectives.counter.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        res, ms, counts = _timed(fn, dev)
        out[name] = dict(ms=ms, launches=counts, collectives=collectives.counter.snapshot(),
                         payload=collectives.counter.payload(), want_payload=want_payload,
                         peak_bytes=torch.cuda.max_memory_allocated(dev),
                         # the residual is each dcn row's own
                         digest=_digest((res[0], {k: v for k, v in res[1].items() if k != "ef"})))
        return res

    pmean = dp_step(learner, mesh)
    pmean(params, opt, batch, scores)                      # cuDNN / allocator warm-up
    got = run("pmean", lambda: pmean(params, opt, batch, scores), dp_payloads(pbytes))
    out["pmean"]["vs_single"] = dp_errors(got, ref)
    acc2 = run("accum2", lambda: dp_step(learner, mesh, accum_steps=2)(params, opt, batch, scores),
               dp_payloads(pbytes))
    out["accum2"]["vs_accum1"] = dp_errors(acc2, got)
    opt_c = dict(opt, ef=init_ef_state(params, 2))
    comp = dp_step(learner, mesh, grad_reduce="compressed")
    pc, oc, mc = run("compressed", lambda: comp(params, opt_c, batch, scores),
                     dp_payloads(pbytes, "compressed", compressed_scale_bytes(params)))
    out["compressed"]["ef_l1"] = sum(float(e.abs().sum()) for e in tree_leaves(oc["ef"]))
    if mesh.rank == 0:
        # the composition on one card: each shard's gradient, the mean over
        # data, ef_compress on each dcn row, the sum over dcn / 2, clip, AdamW
        grads = make_batched_meta_grads(learner, LiteSpec(**TRAIN_LITE))
        with dispatch.use_backend("cuda"):
            shard = [grads(params, take_tasks(batch, 2 * r, 2 * r + 2),
                           scores[2 * r:2 * r + 2])[2] for r in range(4)]
        rows = [tree_map(lambda a, b: (a + b) / 2, shard[2 * c], shard[2 * c + 1])
                for c in range(2)]
        hats = [ef_compress(r, zeros_error(r))[0] for r in rows]
        g, _ = clip_by_global_norm(tree_map(lambda a, b: (a + b) / 2, *hats), 10.0)
        pw, ow = adamw_update(params, g, opt, 1e-3, cfg)
        out["compressed"]["vs_composition"] = dp_errors((pc, oc, mc), (pw, ow, mc))
        out["compressed"]["composition_bit_equal"] = _bit_equal(pc, pw)
    bad = dataclasses.replace(batch, support_x=batch.support_x.clone())
    bad.support_x[6:8] = float("nan")                     # rank 3's two tasks only
    skips = {}
    for name, fn, state in (("pmean", pmean, got[:2]), ("compressed", comp, (pc, oc))):
        p2, o2, m2 = fn(*state, bad, scores)
        skips[name] = dict(nonfinite=float(m2["nonfinite"]),
                           same=_bit_equal(p2, state[0]) and _bit_equal(o2, state[1]))
    out["nan_skip"] = skips
    return out


def dp_rank_main(which: str, out_dir: str) -> int:
    """One rank of phase 5g, run as ``python chip_smoke.py --dp-rank
    <nccl1|gloo4> <dir>`` with the rank's environment
    (:func:`repro_torch.launch.local_ranks.run_ranks`); writes its reading
    to ``<dir>/<which>_rank<r>.json``."""
    import torch.distributed as dist
    out = {"nccl1": dp_rank_nccl1, "gloo4": dp_rank_gloo4}[which](out_dir)
    with open(os.path.join(out_dir, f"{which}_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def dp_ranks(which: str, world: int, tmp):
    """Run the ranks of ``which`` and return their readings, rank order."""
    from repro_torch.launch.local_ranks import RanksFailed, run_ranks
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **DP_ENV}
    t0 = time.perf_counter()
    try:
        run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", which, str(tmp)],
                  world, os.path.join(tmp, f"store_{which}"), env=env, cwd=ROOT,
                  timeout=DP_RANK_TIMEOUT)
    except RanksFailed as e:
        fail(f"phase 5g {which}: {e}")
    secs = time.perf_counter() - t0
    return [json.loads(pathlib.Path(tmp, f"{which}_rank{r}.json").read_text())
            for r in range(world)], secs


DP_LAUNCHER_ARGS = ["--episodic", "--steps", "3", "--tasks-per-step", "8", "--dp-shards", "2",
                    "--dcn-shards", "2", "--grad-reduce", "compressed", "--accum-steps", "2",
                    "--device", "cuda"]


def _dp_launch(extra, ckpt_dir):
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "4", "-m", "repro_torch.launch.train"] + DP_LAUNCHER_ARGS + ["--ckpt-dir", ckpt_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(base + extra, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    return dict(exit=proc.returncode, seconds=time.perf_counter() - t0,
                stdout=proc.stdout[-1500:], stderr=proc.stderr[-1500:],
                said=proc.stdout + proc.stderr)


def run_dp_launcher():
    """``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train
    --episodic`` at 2 x 2 with the compressed reduction and accumulation on
    gloo on the card: it must exit 0 and print ``world=4``; again on the same
    directory, "nothing to do"."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_launcher_") as tmp:
        runs = {name: _dp_launch(["--dist-backend", "gloo"], tmp) for name in ("train", "resume")}
    done = [l for l in runs["train"]["stdout"].splitlines() if l.startswith("done at step")]
    print(f"dp launcher (torchrun, 4 ranks, gloo, 2 x 2 compressed, accum 2): exit "
          f"{runs['train']['exit']} in {runs['train']['seconds']:.1f} s; "
          f"{done[-1] if done else runs['train']['stdout'][-400:]}; rerun exit "
          f"{runs['resume']['exit']}", flush=True)
    if runs["train"]["exit"] != 0 or not done or "world=4 backend=gloo" not in done[-1]:
        fail(f"the dp launcher failed: {runs['train']}")
    if runs["resume"]["exit"] != 0 or "nothing to do" not in runs["resume"]["stdout"]:
        fail(f"the dp launcher's rerun did not resume: {runs['resume']}")
    return {k: {kk: vv for kk, vv in v.items() if kk != "said"} for k, v in runs.items()}


def run_dp_launcher_nccl():
    """The same launcher on NCCL, with 4 ranks on one card: it must refuse
    with the mesh's message and not train."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_launcher_nccl_") as tmp:
        run = _dp_launch(["--dist-backend", "nccl"], tmp)
    print(f"dp launcher on nccl, 4 ranks on one card: exit {run['exit']} in "
          f"{run['seconds']:.1f} s", flush=True)
    if run["exit"] == 0 or "NCCL takes one rank a card" not in run["said"] \
            or "done at step" in run["said"]:
        fail(f"the dp launcher on NCCL with 4 ranks on one card did not refuse: {run}")
    return {k: v for k, v in run.items() if k != "said"}


def run_dp_train(dev, launches):
    """Phase 5g: data-parallel LITE meta-training of phase 5's Simple CNAPs,
    the ranks in subprocesses (this process holds no process group).  (a)
    one rank on NCCL; (b) 4 ranks on gloo sharing the card; (c) the
    launcher under torchrun, deferred."""
    import tempfile
    from repro_torch.common.tree import tree_leaves
    from repro_torch.optim.compress import compressed_scale_bytes
    from repro_torch.roofline import dp_collective_ms, dp_wire_bytes
    t_phase = time.perf_counter()
    out = dict(kind="dp_train", tasks_per_step=TRAIN_TASKS, image_size=IMAGE_SIZE,
               lite=TRAIN_LITE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        (a,), secs_a = dp_ranks("nccl1", 1, tmp)
        print(f"dp (a) 1 rank on {a['backend']} ({a['device']}), (1, 1) mesh: pmean step "
              f"bit-equal to the mesh=None step: {a['pmean_bit_equal']}; compressed step "
              f"bit-equal to quantize, dequantize, sum on one card: "
              f"{a['compressed_bit_equal']}; loss {a['loss']:.6f}; step ms {a['single_ms']:.1f} "
              f"(mesh=None), {a['mesh_ms']:.1f} (mesh); collectives {a['collectives']}, "
              f"compressed {a['collectives_compressed']}; launches {a['launches']}; "
              f"{secs_a:.1f} s with the process's start", flush=True)
        if not (a["pmean_bit_equal"] and a["compressed_bit_equal"]):
            fail(f"phase 5g (a): the NCCL world of 1 is not bit-equal to one process: {a}")
        _need("dp (a) NCCL pmean step", a["launches"],
              ("segment_sum", "class_second_moment", "mahalanobis"))
        b, secs_b = dp_ranks("gloo4", 4, tmp)
    out.update(nccl1=a, gloo4=b, seconds_a=secs_a, seconds_b=secs_b)
    r0 = b[0]
    for r in b:
        tag = f"dp (b) rank {r['rank']} {r['coords']}"
        for name in ("pmean", "accum2", "compressed"):
            _need(f"{tag} {name} step", r[name]["launches"],
                  ("segment_sum", "class_second_moment", "mahalanobis"))
            if r[name]["payload"] != r[name]["want_payload"]:
                fail(f"{tag} {name}: payload {r[name]['payload']} B, dp_payloads says "
                     f"{r[name]['want_payload']} B")
            if r[name]["digest"] != r0[name]["digest"]:
                fail(f"{tag} {name}: state differs from rank 0's")
        if r["pmean"]["collectives"] != r["accum2"]["collectives"]:
            fail(f"{tag}: collectives {r['pmean']['collectives']} at accum 1, "
                 f"{r['accum2']['collectives']} at accum 2")
        for name, key in (("pmean", "vs_single"), ("accum2", "vs_accum1")):
            if not r[name][key]["ok"]:
                fail(f"{tag} {name} {key}: {r[name][key]} (tolerance {DP_TOL})")
        if not r["compressed"]["ef_l1"] > 0:
            fail(f"{tag}: the error-feedback residual is zero")
        for name, s in r["nan_skip"].items():
            if s != dict(nonfinite=1.0, same=True):
                fail(f"{tag}: a NaN in rank 3's tasks, {name} step: {s}")
    if not r0["compressed"]["vs_composition"]["ok"]:
        fail(f"dp (b) compressed against the composition: {r0['compressed']['vs_composition']}")
    for r in b:
        print(f"dp (b) rank {r['rank']} {r['coords']} on {r['device']} ({r['backend']}): "
              f"pmean {r['pmean']['ms']:.1f} ms, peak {r['pmean']['peak_bytes']} B; accum 2 "
              f"{r['accum2']['ms']:.1f} ms; compressed {r['compressed']['ms']:.1f} ms; "
              f"launches {r['pmean']['launches']}; collectives {r['pmean']['collectives']} "
              f"(compressed {r['compressed']['collectives']}); payload {r['pmean']['payload']} B "
              f"(compressed {r['compressed']['payload']} B) = dp_payloads; NaN skip "
              f"{r['nan_skip']}", flush=True)
    print(f"dp (b) these times are of 4 ranks sharing one H100 over gloo (host-staged), not "
          f"a scaling figure.  Against (a)'s mesh=None step: {r0['pmean']['vs_single']}; "
          f"accum 2 against 1: {r0['accum2']['vs_accum1']}; compressed against the "
          f"composition: {r0['compressed']['vs_composition']} (bit-equal "
          f"{r0['compressed']['composition_bit_equal']}); residual L1 "
          f"{r0['compressed']['ef_l1']:.6g}", flush=True)
    _, params = build_model("simple_cnaps", dev)
    pbytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    scale_bytes = compressed_scale_bytes(params)
    del params
    derived = {g: dp_collective_ms(pbytes, 2, 2, g, scale_bytes)
               for g in ("pmean", "compressed")}
    out["derived_collective_ms"] = derived
    out["wire_bytes"] = {g: dp_wire_bytes(pbytes, 2, 2, g, scale_bytes)
                         for g in ("pmean", "compressed")}
    print(f"dp 2 x 2 collectives a step at the links' rates (derived from NVLink 4's 450 GB/s "
          f"and InfiniBand NDR's 50 GB/s each way, not measured): pmean "
          f"{derived['pmean']:.3f} ms, compressed {derived['compressed']:.3f} ms for "
          f"{pbytes} B of fp32 params; wire bytes a rank derived from the payloads by the "
          f"ring all-reduce and all-gather factors: {out['wire_bytes']}", flush=True)
    launches["dp_train"] = r0["pmean"]["launches"]
    defer(out, "launcher", run_dp_launcher)
    defer(out, "launcher_nccl", run_dp_launcher_nccl)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5g: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5h: LM parallelism over a (data, model) mesh
# ---------------------------------------------------------------------------

LM_MESH_ARCH = "deepseek-v2-236b"
LM_MESH_TOKENS = 1024            # (a): a data shard's tokens, T = 2 x 1024
LM_MESH_SEQ = 2048               # (b) at full width: B 1 x S 2048 on (data 1, model 2)
LM_MESH_SMOKE = (4, 64)          # (b) on 2 x 2: the smoke config, B 4 x S 64
LM_MESH_EP_TOL = 1e-5            # (a) fp32: of max|y|, only the partial sums' order differs
LM_MESH_AUX_TOL = 1e-6           # (a) fp32: relative
LM_MESH_RANK_TIMEOUT = 400.0
LM_MESH_LAYOUTS = ("hidden", "seq")


def ep_moe_params(dev, mesh=None):
    """deepseek-v2's MoE layer at published width (E 160, D 5120, F 1536,
    top 6, 2 shared experts), drawn in bf16 on the card from seed 11; with
    ``mesh``, this rank's E/m experts, each leaf cut as it is drawn."""
    import torch
    from repro_torch.common.init import drawn_as
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    from repro_torch.sharding.ctx import P
    from repro_torch.sharding.place import init_sharded
    cfg = get_config(LM_MESH_ARCH)

    def draw(g, d):
        with drawn_as(torch.bfloat16):
            return M.init_moe(g, cfg.d_model, cfg.moe, d)

    gen = torch.Generator(device=dev).manual_seed(11)
    if mesh is None:
        return cfg, draw(gen, dev)
    bank = P("model", None, None)
    specs = dict(router=P(None, None), w_gate=bank, w_up=bank, w_down=bank,
                 shared=dict(w_gate=P(None, None), w_up=P(None, None), w_down=P(None, None)))
    return cfg, init_sharded(draw, gen, dev, specs, mesh)


def ep_tokens(cfg, dev):
    """(2 x LM_MESH_TOKENS, D) bf16 tokens from seed 12, drawn on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(12)
    return torch.randn((2 * LM_MESH_TOKENS, cfg.d_model), generator=g,
                       device=dev).to(torch.bfloat16)


def ep_block(t, coords, shape, layout):
    """A rank's block of (T, D) tokens: its data shard's rows, then its
    model block of them ('hidden': columns, 'seq': rows)."""
    nd, nm = shape["data"], shape["model"]
    di, mi = coords["data"], coords["model"]
    t = t[di * t.shape[0] // nd:(di + 1) * t.shape[0] // nd]
    if layout == "hidden":
        return t[:, mi * t.shape[1] // nm:(mi + 1) * t.shape[1] // nm]
    return t[mi * t.shape[0] // nm:(mi + 1) * t.shape[0] // nm]


def mesh_smoke_cfg():
    from repro_torch.configs.registry import get_smoke_config
    return get_smoke_config(LM_MESH_ARCH)


def full_mesh_cfg():
    """deepseek-v2 at full width on MOE_TRAIN_LAYERS layer(s), as phase 5e."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(LM_MESH_ARCH), n_layers=MOE_TRAIN_LAYERS)


def full_mesh_batch(cfg, dev):
    """The token pipeline's batch 0 of phase 5e, its first row: B 1 x S
    LM_MESH_SEQ."""
    return {k: v[:1] for k, v in pretrain_batch(cfg, 0, dev, seq=LM_MESH_SEQ).items()}


def mesh_smoke_batch(cfg, dev):
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig, batch_to_device
    b, s = LM_MESH_SMOKE
    return batch_to_device(TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, branching=4, seed=0)).batch_at(0), dev)


def shard_mean_grads(cfg, params, batch, backend, shards, force=None):
    """The mean over ``shards`` data shards of one process's loss and
    gradient on each shard alone (:func:`moe_train_grads`); ``force``: each
    shard's expert ids to route by."""
    rows = batch["tokens"].shape[0] // shards
    runs = [moe_train_grads(cfg, params, {k: v[i * rows:(i + 1) * rows] for k, v in
                                          batch.items()}, backend,
                            force=None if force is None else force[i])
            for i in range(shards)]
    grads = {k: None if runs[0][2][k] is None else
             sum(r[2][k].float() for r in runs) / shards for k in runs[0][2]}
    return sum(r[0] for r in runs) / shards, None, grads


def lm_mesh_reference(dev, tmp):
    """One process, before the ranks: (a)'s one-device ``moe_ffn`` on each
    data shard in fp32 and bf16 (the same bf16-representable inputs), and
    (b)'s smoke step on each data shard alone (fp32 compute routed as the
    kernel path, bf16), saved to host files; B7 at the full-width step's
    E/m slice beside the whole bank; then the card is freed."""
    import torch
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TT
    cfg, p16 = ep_moe_params(dev)
    x16 = ep_tokens(cfg, dev)
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in p16.items()}
    ref = dict(y32=[], y16=[], aux32=[], aux16=[], err16=[])
    for d in range(2):
        xs = x16[d * LM_MESH_TOKENS:(d + 1) * LM_MESH_TOKENS]
        y32, a32 = M.moe_ffn(p32, xs.float(), cfg.moe, backend="cuda")
        y16, a16 = M.moe_ffn(p16, xs, cfg.moe, backend="cuda")
        ref["y32"].append(y32.cpu())
        ref["y16"].append(y16.cpu())
        ref["aux32"].append(float(a32))
        ref["aux16"].append(float(a16))
        ref["err16"].append(global_err(y16, y32))
    torch.save(ref, os.path.join(tmp, "ep_ref.pt"))
    mark("5h: (a) reference done")
    # B7 at (b)'s full-width step shapes: a rank's E/m experts beside all E
    g = torch.Generator(device=dev).manual_seed(13)
    c = M.capacity(LM_MESH_SEQ, cfg.moe)
    cases = []
    for e in (cfg.moe.n_experts // 2, cfg.moe.n_experts):
        a = (torch.randn(e, c, cfg.d_model, generator=g, device=dev)).to(torch.bfloat16)
        w = p16["w_gate"][:e]
        cases.append(dict(
            label=f"deepseek EP forward x @ w E{e} M{c} K{cfg.d_model} N{cfg.moe.d_ff}",
            fn=ops.gmm, plain=gm.gmm_plain, lib=torch.bmm, route=gm.gmm_route(a, w),
            args=(a, w), tol=OPS_TOL["gmm"]["bfloat16"], main=True, iters=(5, 3),
            bytes=2 * (e * c * cfg.d_model + e * cfg.d_model * cfg.moe.d_ff
                       + e * c * cfg.moe.d_ff),
            flops=2.0 * e * c * cfg.d_model * cfg.moe.d_ff, peak=BF16_FLOPS))
    row = check_kernels([dict(name="gmm", source="src/repro_torch/kernels/csrc/gmm.cu",
                              replaces="src/repro/kernels/gmm.py:37",
                              symbol="gmm_wgmma_kernel", cases=cases)])["gmm"]
    del p16, p32, x16, cases
    torch.cuda.empty_cache()
    mark("5h: B7 cases done")
    # (b) on 2 x 2 at the smoke config: each data shard alone
    import dataclasses
    scfg = mesh_smoke_cfg()
    params = TT.init_transformer(torch.Generator(device=dev).manual_seed(0), scfg,
                                 at_param_dtype=True)
    batch = mesh_smoke_batch(scfg, dev)
    rows = batch["tokens"].shape[0] // 2
    routed = [forward_routes(scfg, params, {k: v[i * rows:(i + 1) * rows]
                                            for k, v in batch.items()}, "cuda")
              for i in range(2)]
    cfg32 = dataclasses.replace(scfg, compute_dtype="float32")
    ref32 = shard_mean_grads(cfg32, params, batch, "ref", 2, force=routed)
    ref16 = shard_mean_grads(scfg, params, batch, "ref", 2)
    torch.save(dict(ref32=(ref32[0], None, {k: v.cpu() for k, v in ref32[2].items()}),
                    ref16_errs=lm_grad_errs(ref16, ref32, ("",))),
               os.path.join(tmp, "smoke_ref.pt"))
    del params, ref32, ref16
    torch.cuda.empty_cache()
    # (b) at full width on (data 1, model 2): one device on the whole batch,
    # fp32 compute routed as the kernel path, and bf16 on ref
    cfg = full_mesh_cfg()
    params = TT.init_transformer(torch.Generator(device=dev).manual_seed(0), cfg,
                                 at_param_dtype=True)
    batch = full_mesh_batch(cfg, dev)
    routed = forward_routes(cfg, params, batch, "cuda")
    ref32 = moe_train_grads(dataclasses.replace(cfg, compute_dtype="float32"), params, batch,
                            "ref", force=routed + routed[::-1])
    ref32 = (ref32[0], None, {k: v.cpu() for k, v in ref32[2].items()})
    ref16 = moe_train_grads(cfg, params, batch, "ref")
    del params
    ref16_errs = lm_grad_errs(ref16, ref32, ("",), dev)
    del ref16
    torch.cuda.empty_cache()
    mark("5h: (b) full-width reference done")
    if not any(float(w.abs().max()) > 0 for w in ref32[2].values() if w is not None):
        fail("phase 5h (b): the fp32 run's gradient is exactly 0: the gate would hold nothing")
    torch.save(dict(ref32=ref32, ref16_errs=ref16_errs), os.path.join(tmp, "full_ref.pt"))
    del ref32
    return row


def _planted_model_factor():
    """The model axis's gather VJP scaled by the axis's size (the gradient
    summed over model where each rank holds the whole): the gate must flag
    it."""
    from repro_torch.launch import mesh as MM
    backward = MM._AllGather.backward

    def scaled(ctx, g):
        out = backward(ctx, g)
        mesh, axes, _, vjp = ctx.args
        return (out[0] * mesh.size_of(axes) if vjp == "slice" else out[0],) + out[1:]

    return planted_backward(MM._AllGather, scaled)


def _dropped_reduce_scatter():
    """The EP body's reduce-scatter over model (``moe.reduce_scatter``)
    replaced by this rank's block of its own partial sum: the other ranks'
    experts go missing."""
    from repro_torch.launch.mesh import local_block
    from repro_torch.models import moe as M
    orig = M.reduce_scatter

    @contextlib.contextmanager
    def planted():
        M.reduce_scatter = lambda t, mesh, axes, dim=0: local_block(t, mesh, axes, dim)
        try:
            yield
        finally:
            M.reduce_scatter = orig

    return planted()


@contextlib.contextmanager
def counted_gmm_forwards(counts: dict):
    """Count into ``counts`` B7's autograd Function's forwards in the block:
    ``forward`` those on this thread, ``recompute`` those a checkpoint's
    recompute runs on the backward's thread (on the card, autograd runs the
    backward on a thread of its own)."""
    import threading
    from repro_torch.kernels import dispatch
    orig = dispatch._GMM.__dict__["forward"]
    main = threading.get_ident()

    def counted(ctx, x, w):
        key = "forward" if threading.get_ident() == main else "recompute"
        counts[key] = counts.get(key, 0) + 1
        return orig.__func__(ctx, x, w)

    dispatch._GMM.forward = staticmethod(counted)
    try:
        yield
    finally:
        dispatch._GMM.forward = orig


def sharded_grads(grads_of, state, batch, dev):
    """The sharded loss and this rank's gradient blocks on the kernels:
    (loss, {path: block}, launches, products): B7's backward products and
    its forwards by thread (:func:`counted_gmm_forwards`), the seconds."""
    import torch
    from repro_torch.kernels import _build, dispatch
    products = {}
    torch.cuda.synchronize(dev)
    _build.launches.reset()
    t0 = time.perf_counter()
    with dispatch.use_backend("cuda"), counted_gmm_products(products), \
            counted_gmm_forwards(products):
        loss, _, grads = grads_of(state["params"], batch)
    torch.cuda.synchronize(dev)
    products["grads_s"] = time.perf_counter() - t0
    return float(loss), grads, _build.launches.snapshot(), products


def gathered_grads(grads_of, state, batch, specs, mesh, dev):
    """:func:`sharded_grads`, each leaf then gathered whole onto the host
    (every rank joins): (loss, None, {path: gradient}, launches,
    products)."""
    from repro_torch.sharding.place import gather_leaf, spec_paths
    at = spec_paths(specs["params"])
    loss, grads, launches, products = sharded_grads(grads_of, state, batch, dev)
    whole = {}
    for k in list(grads):
        g = gather_leaf(grads.pop(k), at[k], mesh)
        whole[k] = g.cpu()
        del g
    return loss, None, whole, launches, products


def lm_rank_ep4(out_dir):
    """Phase 5h (a) and (b) at the smoke config, one of 4 gloo ranks sharing
    the card as (data 2, model 2)."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_mesh_for
    from repro_torch.models import moe as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import lm_step_payloads
    from repro_torch.train.step import (lm_state_specs, make_mesh_grads,
                                        make_sharded_init_state, make_train_step)
    dev = init_distributed("cuda", backend="gloo", init_method=os.environ["RANKS_INIT_METHOD"])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_for((2, 2), ("data", "model"))
    out = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev), backend=mesh.backend)
    # (a) the MoE layer at published width, expert-parallel
    cfg, p16 = ep_moe_params(dev, mesh)
    x16 = ep_tokens(cfg, dev)
    ref = torch.load(os.path.join(out_dir, "ep_ref.pt"))
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in p16.items()}
    di = mesh.coords["data"]
    out["ep"] = {}
    for layout in LM_MESH_LAYOUTS:
        for dt, p in (("float32", p32), ("bfloat16", p16)):
            x = ep_block(x16, mesh.coords, mesh.shape, layout)
            x = x.float() if dt == "float32" else x
            collectives.counter.reset()
            (y, aux), launches, ms = _counted(
                lambda: M.moe_ffn_sharded(p, x.contiguous(), cfg.moe, mesh, layout,
                                          backend="cuda"))
            want = ep_block(ref["y32"][di].to(dev), dict(data=0, model=mesh.coords["model"]),
                            dict(data=1, model=2), layout)
            scale = float(ref["y32"][di].abs().max())
            err = float((y.float() - want).abs().max()) / scale
            aux_want = sum(ref["aux32" if dt == "float32" else "aux16"]) / 2
            out["ep"][f"{layout}/{dt}"] = dict(
                err=err, aux=float(aux), aux_want=aux_want,
                aux_err=abs(float(aux) - aux_want) / abs(aux_want), ms=ms, launches=launches,
                collectives=collectives.counter.snapshot(),
                payload=collectives.counter.payload(), err16=ref["err16"][di])
    x = ep_block(x16, mesh.coords, mesh.shape, "hidden").float().contiguous()
    with _dropped_reduce_scatter():
        y, _ = M.moe_ffn_sharded(p32, x, cfg.moe, mesh, "hidden", backend="cuda")
    want = ep_block(ref["y32"][di].to(dev), dict(data=0, model=mesh.coords["model"]),
                    dict(data=1, model=2), "hidden")
    out["ep_planted"] = float((y.float() - want).abs().max()) / float(ref["y32"][di].abs().max())
    del p16, p32, x16, ref, y, x, want
    torch.cuda.empty_cache()
    # (b) the smoke config's step on 2 x 2
    scfg = mesh_smoke_cfg()
    adam = AdamWConfig(state_dtype=scfg.opt_state_dtype)
    _, specs = lm_state_specs(scfg, adam, mesh)
    state = make_sharded_init_state(scfg, adam, mesh)(torch.Generator(device=dev).manual_seed(0),
                                                       dev)
    batch = mesh_smoke_batch(scfg, dev)
    sref = torch.load(os.path.join(out_dir, "smoke_ref.pt"))
    grads_of = make_mesh_grads(scfg, adam, mesh)
    got = gathered_grads(grads_of, state, batch, specs, mesh, dev)
    with _planted_model_factor():
        bad = gathered_grads(grads_of, state, batch, specs, mesh, dev)
    if mesh.rank == 0:
        gate = lm_train_gate("5h (b) smoke 2 x 2 step", dict(got=got, ref32=sref["ref32"]),
                             ("",), ref16_errs=sref["ref16_errs"])
        planted = lm_train_gate("5h (b) planted fault: the model gather's VJP x m",
                                dict(got=bad, ref32=sref["ref32"]), ("",), fault=True,
                                ref16_errs=sref["ref16_errs"])
        out["smoke_gate"] = {k: v for k, v in gate.items() if not k.endswith("leaf_errors")}
        out["smoke_planted"] = {k: v for k, v in planted.items()
                                if not k.endswith("leaf_errors")}
    step = make_train_step(scfg, adam, mesh=mesh)
    collectives.counter.reset()
    _build.launches.reset()
    with dispatch.use_backend("cuda"):
        _, m = step(state, batch)
    out["smoke_step"] = dict(loss=float(m["loss"]), nonfinite=float(m["nonfinite"]),
                             launches=_build.launches.snapshot(),
                             payload=collectives.counter.payload(),
                             want_payload=lm_step_payloads(scfg, mesh.shape, *LM_MESH_SMOKE,
                                                           state_dtype=adam.state_dtype))
    return out


def lm_rank_step2(out_dir):
    """Phase 5h (b) at full width, one of 2 gloo ranks sharing the card as
    (data 1, model 2): deepseek-v2 at 1 layer, bf16 params and AdamW state,
    B 1 x S 2048; the sharded gradient gathered leaf by leaf and held by
    rank 0 against the one-device reference (read from the host file the
    main process wrote before the ranks started); one step's payloads and
    launches."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_mesh_for
    from repro_torch.roofline import lm_step_payloads, mesh_state_bytes
    from repro_torch.sharding.place import shard_leaf, spec_paths
    from repro_torch.train.step import (adamw_for, lm_state_specs, make_mesh_grads,
                                        make_sharded_init_state, make_train_step)
    dev = init_distributed("cuda", backend="gloo", init_method=os.environ["RANKS_INIT_METHOD"])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_for((1, 2), ("data", "model"))
    cfg = full_mesh_cfg()
    adam = adamw_for(cfg)
    lead = mesh.rank == 0
    t0 = time.perf_counter()
    times = {}
    out = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev), backend=mesh.backend,
               reckoned_state_bytes=mesh_state_bytes(cfg, mesh.shape), seconds=times)
    _, specs = lm_state_specs(cfg, adam, mesh)
    state = make_sharded_init_state(cfg, adam, mesh)(torch.Generator(device=dev).manual_seed(0),
                                                      dev)
    out["held_bytes"] = torch.cuda.memory_allocated(dev)
    times["init"] = time.perf_counter() - t0
    batch = full_mesh_batch(cfg, dev)
    loss, blocks, launches, products = sharded_grads(make_mesh_grads(cfg, adam, mesh), state,
                                                     batch, dev)
    out["b7_launches"], out["b7_products"] = launches, products
    times["grads"] = time.perf_counter() - t0
    # each leaf's error from the blocks: every rank its block against the same
    # block of the reference, the maxima over the ranks (the gathered leaf's)
    ref = torch.load(os.path.join(out_dir, "full_ref.pt"), mmap=True)
    at = spec_paths(specs["params"])
    keys = list(blocks)
    maxima = torch.stack([torch.stack([
        (g.float() - w.float()).abs().max(), w.float().abs().max(), g.float().abs().max()])
        for k, g in blocks.items()
        for w in (shard_leaf(ref["ref32"][2][k], at[k], mesh).to(dev),)])
    del blocks
    maxima = -mesh.all_reduce(-maxima, "model", op="min")
    errs = {}
    for k, (diff, scale, gmax) in zip(keys, maxima.tolist()):
        if scale > 0 and gmax == 0:
            fail(f"phase 5h (b): leaf {k}: the reference trains it, the mesh gives it none")
        errs[k] = diff / max(scale, 1e-30)
    times["errors"] = time.perf_counter() - t0
    step = make_train_step(cfg, adam, mesh=mesh)
    collectives.counter.reset()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    t1 = time.perf_counter()
    with dispatch.use_backend("cuda"):
        _, m = step(state, batch)
    torch.cuda.synchronize(dev)
    out["step"] = dict(ms=(time.perf_counter() - t1) * 1e3, loss=float(m["loss"]),
                       nonfinite=float(m["nonfinite"]), launches=_build.launches.snapshot(),
                       payload=collectives.counter.payload(),
                       want_payload=lm_step_payloads(cfg, mesh.shape, 1, LM_MESH_SEQ,
                                                     state_dtype=adam.state_dtype),
                       peak_bytes=torch.cuda.max_memory_allocated(dev))
    times["step"] = time.perf_counter() - t0
    del state, step
    torch.cuda.empty_cache()
    if lead:
        l_got = abs(loss - ref["ref32"][0]) / max(abs(ref["ref32"][0]), 1e-30)
        gate = lm_train_gate("5h (b) deepseek-v2 1 layer (1, 2) step",
                             dict(got=(loss, None, None), ref32=ref["ref32"]), ("",),
                             ref16_errs=ref["ref16_errs"], got_errs=(l_got, errs))
        out["gate"] = {k: v for k, v in gate.items() if not k.endswith("leaf_errors")}
        out["losses"] = dict(got=loss, ref32=ref["ref32"][0])
    return out


def lm_rank_nccl1(out_dir):
    """Phase 5h (d), one rank on NCCL: the smoke config's step on the (1, 1)
    test mesh bit-equal to the step without a mesh."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_init_state, make_sharded_init_state, make_train_step
    dev = init_distributed("cuda", backend="nccl", init_method=os.environ["RANKS_INIT_METHOD"])
    mesh = make_test_mesh()
    cfg = mesh_smoke_cfg()
    adam = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    batch = mesh_smoke_batch(cfg, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    one = make_init_state(cfg, adam)(gen(), dev)
    sharded = make_sharded_init_state(cfg, adam, mesh)(gen(), dev)
    with dispatch.use_backend("cuda"):
        _, m1 = make_train_step(cfg, adam)(one, batch)
        _, m2 = make_train_step(cfg, adam, mesh=mesh)(sharded, batch)
    return dict(backend=mesh.backend, device=str(dev), mesh=mesh.shape,
                bit_equal=_bit_equal(one, sharded) and bool(m1["loss"] == m2["loss"]),
                loss=float(m1["loss"]))


def lm_rank_main(which: str, out_dir: str) -> int:
    """One rank of phase 5h, run as ``python chip_smoke.py --lm-rank
    <ep4|step2|nccl1> <dir>``; writes its reading to
    ``<dir>/<which>_rank<r>.json``."""
    import torch.distributed as dist
    out = {"ep4": lm_rank_ep4, "step2": lm_rank_step2, "nccl1": lm_rank_nccl1,
           "serve4": lm_rank_serve4}[which](out_dir)
    with open(os.path.join(out_dir, f"{which}_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def lm_ranks(which: str, world: int, tmp):
    """Run the ranks of ``which`` and return their readings, rank order."""
    from repro_torch.launch.local_ranks import RanksFailed, run_ranks
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **DP_ENV}
    t0 = time.perf_counter()
    try:
        run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--lm-rank", which, str(tmp)],
                  world, os.path.join(tmp, f"store_{which}"), env=env, cwd=ROOT,
                  timeout=LM_MESH_RANK_TIMEOUT)
    except RanksFailed as e:
        fail(f"phase 5h {which}: {e}")
    secs = time.perf_counter() - t0
    return [json.loads(pathlib.Path(tmp, f"{which}_rank{r}.json").read_text())
            for r in range(world)], secs


def run_lm_mesh_nccl1():
    """(d) one NCCL rank, deferred: the (1, 1) mesh's step bit-equal."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_nccl1_") as tmp:
        (a,), secs = lm_ranks("nccl1", 1, tmp)
    print(f"lm mesh (d) 1 rank on {a['backend']} ({a['device']}), mesh {a['mesh']}: the "
          f"smoke step bit-equal to the step without a mesh: {a['bit_equal']}; loss "
          f"{a['loss']:.6f}; {secs:.1f} s", flush=True)
    if not a["bit_equal"]:
        fail(f"phase 5h (d): the NCCL world of 1 is not bit-equal to one process: {a}")
    return dict(a, seconds=secs)


def run_lm_mesh_launcher():
    """(d) ``torchrun --standalone --nproc-per-node 4 -m
    repro_torch.launch.train --arch deepseek-v2-236b --full`` on gloo,
    deferred: the smoke config on the (4, 1) test mesh, the reference's
    warning printed, rank 0's lines once."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_launcher_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--arch",
             LM_MESH_ARCH, "--full", "--steps", "2", "--batch", "4", "--seq", "64",
             "--device", "cuda", "--dist-backend", "gloo", "--ckpt-dir", tmp],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    done = [l for l in lines if l.startswith("done at step")]
    print(f"lm mesh launcher (torchrun, 4 ranks, gloo, --full): exit {proc.returncode} in "
          f"{secs:.1f} s; {[l for l in lines if l.startswith(('[warn]', 'arch='))]}; "
          f"{done[-1] if done else proc.stdout[-400:]}", flush=True)
    if proc.returncode != 0 or len(done) != 1 \
            or "[warn] --full needs >=256 devices (have 4)" not in proc.stdout \
            or "mesh={'data': 4, 'model': 1} backend=gloo" not in proc.stdout:
        fail(f"the LM launcher under torchrun failed: {proc.stdout[-1500:]} "
             f"{proc.stderr[-1500:]}")
    return dict(exit=proc.returncode, seconds=secs, stdout=proc.stdout[-1500:])


def run_lm_mesh(dev, launches):
    """Phase 5h: LM parallelism.  The one-device reference first, in this
    process, then the card freed; (a) and (b) at the smoke config on 4 gloo
    ranks as (data 2, model 2); (b) at full width on 2 gloo ranks as (data
    1, model 2); (c) the payloads against the roofline's; (d) deferred."""
    import tempfile
    import torch
    t_phase = time.perf_counter()
    out = dict(kind="lm_mesh", arch=LM_MESH_ARCH, tokens=2 * LM_MESH_TOKENS,
               seq=LM_MESH_SEQ, smoke=LM_MESH_SMOKE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_mesh_") as tmp:
        row = lm_mesh_reference(dev, tmp)
        mark("5h: one-device reference done")
        ep4, secs4 = lm_ranks("ep4", 4, tmp)
        mark("5h: 2 x 2 ranks done")
        step2, secs2 = lm_ranks("step2", 2, tmp)
        mark("5h: (1, 2) ranks done")
    out.update(ep4=ep4, step2=step2, seconds_ep4=secs4, seconds_step2=secs2,
               kernel_cases=row["cases"], kernel_max_abs_err=row["max_abs_err"])
    # (a) each rank's block against the shard's moe_ffn
    for r in ep4:
        for key, e in r["ep"].items():
            layout, dt = key.split("/")
            ok = e["err"] <= (LM_MESH_EP_TOL if dt == "float32" else LM_GATE * e["err16"])
            ok = ok and (dt != "float32" or e["aux_err"] <= LM_MESH_AUX_TOL)
            print(f"lm mesh (a) rank {r['rank']} {r['coords']} {layout} {dt}: y err "
                  f"{e['err']:.3e} of max|y| (tol "
                  f"{LM_MESH_EP_TOL if dt == 'float32' else LM_GATE * e['err16']:.3e}), aux "
                  f"{e['aux']:.7g} vs {e['aux_want']:.7g} ({e['aux_err']:.2e}), {e['ms']:.1f} "
                  f"ms, launches {e['launches']}, collectives {e['collectives']}", flush=True)
            if not ok:
                fail(f"phase 5h (a) rank {r['rank']} {key}: {e}")
            if e["launches"].get("gmm", 0) != 3:
                fail(f"phase 5h (a) rank {r['rank']} {key}: B7 launches {e['launches']}, "
                     f"want 3 (the three projections of the rank's experts)")
        print(f"lm mesh (a) rank {r['rank']}: a dropped reduce-scatter reads "
              f"{r['ep_planted']:.3e} of max|y| {'caught' if r['ep_planted'] > LM_MESH_EP_TOL else 'MISSED'}",
              flush=True)
        if not r["ep_planted"] > LM_MESH_EP_TOL:
            fail("phase 5h (a): the dropped reduce-scatter was not caught")
    r0 = ep4[0]
    if not (r0["smoke_gate"]["passed"] and not r0["smoke_planted"]["passed"]):
        fail(f"phase 5h (b) smoke: gate {r0['smoke_gate']}, planted {r0['smoke_planted']}")
    s0 = step2[0]
    for label, g in (("(b) smoke 2 x 2", r0["smoke_gate"]),
                     ("(b) smoke 2 x 2, planted: the model gather's VJP x m", r0["smoke_planted"]),
                     ("(b) full width (1, 2)", s0["gate"])):
        print(f"lm mesh {label}: loss err {g['loss_err']:.3e} (bf16 ref {g['ref16_loss_err']:.3e}), "
              f"worst leaf {g['worst_leaf_err']:.3e} at {g['worst_leaf']} (bf16 ref "
              f"{g['ref16_worst_leaf_err']:.3e}), {g['leaves']} leaves: "
              f"{'passed' if g['passed'] else 'flagged'}", flush=True)
    if not s0["gate"]["passed"]:
        fail(f"phase 5h (b) full width: gate {s0['gate']}")
    # (c) payloads, and the launches of the full-width step
    for r in ep4 + step2:
        st = r.get("smoke_step") or r["step"]
        if st["payload"] != st["want_payload"] or st["nonfinite"]:
            fail(f"phase 5h (c) rank {r['rank']}: payload {st['payload']}, the roofline's "
                 f"{st['want_payload']}, nonfinite {st['nonfinite']}")
    p, l = s0["b7_products"], s0["b7_launches"]
    roles = {k: p.get(k, 0) for k in ("forward", "recompute", "dx", "dw")}
    print(f"lm mesh (b) B7 launches by role on rank 0's E/m experts: {roles}, "
          f"{l.get('gmm/wgmma', 0)} of {l.get('gmm', 0)} on wgmma; the gradient in "
          f"{p['grads_s']:.1f} s; each leaf held block by block against the same block of "
          f"the reference, the leaf's error the largest over the ranks", flush=True)
    if roles != dict(forward=3, recompute=3, dx=3, dw=3) or l != {"gmm": 12, "gmm/wgmma": 12}:
        fail(f"phase 5h (b): B7 launches {l}, by role {roles}; want 3 of each, all on wgmma, "
             f"and nothing else")
    out["b7_roles"] = roles
    for r in step2:
        n = 12 * MOE_TRAIN_LAYERS
        if r["step"]["launches"] != {"gmm": n, "gmm/wgmma": n}:
            fail(f"phase 5h (b) rank {r['rank']}: the step's launches {r['step']['launches']}, "
                 f"want B7 {n} times on wgmma and nothing else")
        print(f"lm mesh (b) rank {r['rank']} {r['coords']}: step {r['step']['ms']:.1f} ms, loss "
              f"{r['step']['loss']:.6f}, peak {r['step']['peak_bytes']} B, state held "
              f"{r['held_bytes']} B (params and AdamW state; roofline.mesh_state_bytes, which "
              f"counts the gradients too, {r['reckoned_state_bytes']} B), "
              f"payload {r['step']['payload']} = lm_step_payloads; seconds into the rank "
              f"{r['seconds']}", flush=True)
    launches["lm_mesh"] = s0["step"]["launches"]
    e80, e160 = row["cases"]
    print(f"lm mesh B7: E 80 (a rank's experts at model 2) {e80['device_ms']} ms device, "
          f"E 160 {e160['device_ms']} ms device, bound {e80['bound_ms']:.4f} / "
          f"{e160['bound_ms']:.4f} ms.  These runs share one card between the ranks: no "
          f"scaling figure", flush=True)
    defer(out, "nccl1", run_lm_mesh_nccl1)
    defer(out, "launcher", run_lm_mesh_launcher)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5h: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6: the LM-side kernel entry point repro_torch.kernels.ops
# ---------------------------------------------------------------------------

# per-row tolerances against the plain versions (see row_err): fp32 sums in
# other orders; a bf16 output may differ by one bf16 rounding where the fp32
# sums straddle a rounding boundary, at most 2^-7 = 7.8e-3 of its row's
# largest value (fp16: 2^-10); ssd_chunk's outputs are fp32 whatever its
# inputs, and exp amplifies the other summation order of torch.cumsum in
# its plain version
OPS_TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 1e-2, "float16": 2e-3},
           "gmm": {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3},
           "ssd_chunk": {"float32": 1e-4, "bfloat16": 1e-4, "float16": 1e-4}}


def flash_case(randn, label, b, s, hq, hkv, d, dtype, main=False, lib=False,
               offset=False, iters=(3, 3), **kw):
    """A case of flash attention through ``ops.flash_attention_gqa`` on q (b,
    s, hq, d) and k, v (b, s, hkv, d) drawn by ``randn``, as
    :func:`check_kernels` takes it; ``lib`` times SDPA beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q, k, v = randn(b, s, hq, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype), \
        randn(b, s, hkv, d, dtype=dtype)
    if offset:
        q, k, v = unaligned(q), unaligned(k), unaligned(v)
    esz = q.element_size()
    sdpa = (lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=kw["causal"], enable_gqa=True)) if lib else None
    return dict(label=label, fn=ops.flash_attention_gqa, route=fa.flash_route(q, k, v),
                plain=fa.flash_attention_gqa_plain, lib=sdpa, args=(q, k, v),
                kw=kw, tol=OPS_TOL["flash_attention"][str(dtype).split(".")[1]],
                main=main, iters=iters,
                bytes=esz * (2 * b * s * hq * d + 2 * b * s * hkv * d),
                flops=4.0 * d * b * hq * attn_pairs(s, kw["causal"], kw.get("window")),
                peak=BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)


def ssd_case(g, dev, label, gg, q, p, n, dtype=None, main=False, offset=False,
             iters=(3, 3)):
    """A case of ssd_chunk through ``ops.ssd_chunk`` on G = ``gg`` chunks of
    ``q`` steps, P ``p``, N ``n``, drawn on the CPU generator ``g`` (dt and A
    in Mamba-2's initialisation ranges: dt log-uniform in [1e-3, 1e-1], A =
    -uniform(1, 16)), as :func:`check_kernels` takes it.  The work is
    counted once (not the split passes of the "wgmma" route), at the rate
    of the units that do it: bf16 tensor cores or fp32."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    dtype = dtype or torch.float32
    u = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    dt = torch.exp(math.log(1e-3) + u(gg, q) * math.log(100.0)).to(dev, dtype)
    A = (-(1.0 + 15.0 * u(gg))).to(dev, dtype)
    x, B, C = (torch.randn(gg, q, k, generator=g).to(dev, dtype) for k in (p, n, n))
    if offset:
        x = unaligned(x)
    pairs = q * (q + 1) // 2
    esz = x.element_size()
    route = ssd.ssd_route(x, dt, A, B, C)
    return dict(label=label, fn=ops.ssd_chunk, plain=ssd.ssd_chunk_plain, lib=None,
                route=route, symbol="ssd_wgmma" if route == "wgmma" else "ssd_chunk_kernel",
                args=(x, dt, A, B, C),
                tol=OPS_TOL["ssd_chunk"][str(dtype).split(".")[1]], main=main, iters=iters,
                bytes=esz * gg * (q * p + q + 1 + 2 * q * n) + 4 * gg * (q * p + q + 1 + p * n),
                flops=gg * (2.0 * pairs * (n + p) + 2.0 * q * p * n),
                peak=BF16_FLOPS if route == "wgmma" else FP32_FLOPS)


def ops_cases(dev):
    """The LM-side kernels' specs, as :func:`kernel_cases` gives them; ``fn``
    goes through repro_torch.kernels.ops, and the main cases are the ones
    driven on the counted ops path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import ops

    g = torch.Generator(device="cpu").manual_seed(1)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device=dev, dtype=dtype)

    flash = lambda *a, **kw: flash_case(randn, *a, **kw)

    def flash_bh(label, bh, s, d, **kw):
        q, k, v = (randn(bh, s, d) for _ in range(3))
        return dict(label=label, fn=ops.flash_attention, plain=fa.flash_attention_plain,
                    route=fa.flash_route(q, k, v), lib=None, args=(q, k, v), kw=kw,
                    tol=OPS_TOL["flash_attention"]["float32"], main=False,
                    bytes=4 * 4 * bh * s * d,
                    flops=4.0 * d * bh * attn_pairs(s, kw["causal"], kw.get("window")),
                    peak=FP32_FLOPS)

    def gmm(label, e, c, d, f, dtype, main=False, offset=False, views=""):
        """``views``: "x" and / or "w" come as transposed views of stored
        (E, D, C) and (E, F, D) tensors, as B7's backward hands them."""
        x = randn(e, d, c, dtype=dtype).transpose(1, 2) if "x" in views else \
            randn(e, c, d, dtype=dtype)
        w = randn(e, f, d, dtype=dtype, scale=d ** -0.5).transpose(1, 2) if "w" in views \
            else randn(e, d, f, dtype=dtype, scale=d ** -0.5)
        if offset:
            x, w = unaligned(x), unaligned(w)
        esz = x.element_size()
        return dict(label=label, fn=ops.gmm, plain=gm.gmm_plain, lib=torch.bmm,
                    route=gm.gmm_route(x, w),
                    args=(x, w), tol=OPS_TOL["gmm"][str(dtype).split(".")[1]],
                    main=main, iters=(3, 3),
                    bytes=esz * (e * c * d + e * d * f + e * c * f),
                    flops=2.0 * e * c * d * f,
                    peak=BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)

    ssd = functools.partial(ssd_case, g, dev)

    src = "src/repro_torch/kernels/csrc/"
    spec = lambda name, source, replaces, symbol, cases: dict(
        name=name, source=src + source, replaces=replaces, symbol=symbol, cases=cases)
    return [
        # gemma2-2b: 8 query heads over 4 kv heads, head_dim 256, softcap 50,
        # local layers window 4096; minitron-4b: 24 over 8, head_dim 128.  The
        # bf16 / fp16 cases at head dims 64, 96, 112, 128 and 256 take the
        # "wgmma" route, the fp32, other head dims and unaligned ones "simt"
        spec("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:89", "flash_attention_wgmma_kernel", [
            flash("minitron-4b B1 S8192 Hq24 Hkv8 D128 causal", 1, 8192, 24, 8, 128,
                  torch.bfloat16, main=True, lib=True, causal=True),
            flash("gemma2-2b global B1 S8192 Hq8 Hkv4 D256 causal cap50", 1, 8192, 8, 4,
                  256, torch.bfloat16, main=True, causal=True, softcap=50.0),
            flash("gemma2-2b local B1 S8192 Hq8 Hkv4 D256 window4096 cap50", 1, 8192, 8,
                  4, 256, torch.bfloat16, main=True, causal=True, window=4096,
                  softcap=50.0),
            # zamba2-7b's shared block, 32 heads of 112, and phi-3-vision's
            # 32 of 96: the 128-wide tensor-core kernel on zero-filled columns
            flash("zamba2-7b B1 S1024 Hq32 Hkv32 D112 causal", 1, 1024, 32, 32, 112,
                  torch.bfloat16, main=True, lib=True, causal=True),
            flash("phi-3-vision B1 S2048 Hq32 Hkv32 D96 causal", 1, 2048, 32, 32, 96,
                  torch.bfloat16, main=True, lib=True, causal=True),
            *(flash_bh(f"ragged BH2 S100 D32 causal={c} window={w} cap={cap}", 2, 100,
                       32, causal=c, window=w, softcap=cap)
              for c, w, cap in ((True, None, None), (False, None, None), (True, 24, None),
                                (True, None, 50.0), (True, 24, 30.0))),
            flash("ragged B2 S200 Hq4 Hkv2 D256 window64 cap50", 2, 200, 4, 2, 256,
                  torch.bfloat16, causal=True, window=64, softcap=50.0),
            flash("ragged B1 S77 Hq3 Hkv1 D80 non-causal", 1, 77, 3, 1, 80,
                  torch.float32, causal=False),
            flash("ragged B1 S130 Hq2 Hkv2 D64 fp16 window100", 1, 130, 2, 2, 64,
                  torch.float16, causal=True, window=100),
            flash("ragged B2 S200 Hq4 Hkv2 D128 cap30", 2, 200, 4, 2, 128, torch.bfloat16,
                  causal=True, softcap=30.0),
            flash("ragged B2 S200 Hq4 Hkv2 D128 non-causal window50", 2, 200, 4, 2, 128,
                  torch.bfloat16, causal=False, window=50),
            flash("ragged B1 S200 Hq4 Hkv1 D256 fp16 window100 cap50", 1, 200, 4, 1, 256,
                  torch.float16, causal=True, window=100, softcap=50.0),
            flash("ragged B2 S200 Hq4 Hkv2 D112 window64 cap30", 2, 200, 4, 2, 112,
                  torch.bfloat16, causal=True, window=64, softcap=30.0),
            flash("ragged B1 S130 Hq3 Hkv1 D96 fp16 non-causal", 1, 130, 3, 1, 96,
                  torch.float16, causal=False),
            flash("ragged B1 S77 Hq2 Hkv1 D112 fp32 (simt)", 1, 77, 2, 1, 112,
                  torch.float32, causal=True, window=30),
            flash("ragged B1 S77 Hq2 Hkv1 D80 bf16 (head dim: simt)", 1, 77, 2, 1, 80,
                  torch.bfloat16, causal=True),
            flash("ragged B1 S100 Hq2 Hkv1 D128 bf16 unaligned (simt)", 1, 100, 2, 1, 128,
                  torch.bfloat16, offset=True, causal=True, window=40)]),
        # kimi-k2: 8 of its experts, 512 tokens each, d_model 7168, expert
        # hidden 2048
        spec("gmm", "gmm.cu", "src/repro/kernels/gmm.py:37", "gmm_wgmma_kernel", [
            gmm("kimi-k2 E8 C512 D7168 F2048", 8, 512, 7168, 2048, torch.bfloat16,
                main=True),
            gmm("ragged E2 C130 D200 F300", 2, 130, 200, 300, torch.float32),
            gmm("ragged E2 C130 D200 F300", 2, 130, 200, 300, torch.bfloat16),
            gmm("ragged E3 C33 D70 F45", 3, 33, 70, 45, torch.float16),
            gmm("ragged E3 C130 D200 F264", 3, 130, 200, 264, torch.bfloat16),
            gmm("ragged E2 C77 D136 F72", 2, 77, 136, 72, torch.float16),
            gmm("ragged E2 C64 D128 F128 unaligned (simt)", 2, 64, 128, 128,
                torch.bfloat16, offset=True),
            # the backward's transposed views: w^T (dx), x^T (dw), both
            gmm("ragged E2 C70 D128 F136 w^T view", 2, 70, 128, 136, torch.bfloat16,
                views="w"),
            gmm("ragged E2 C136 D70 F136 x^T view", 2, 136, 70, 136, torch.bfloat16,
                views="x"),
            gmm("ragged E3 C72 D136 F200 x^T and w^T views fp16", 3, 72, 136, 200,
                torch.float16, views="xw"),
            gmm("ragged E2 C70 D128 F136 x^T view (C 70: simt)", 2, 70, 128, 136,
                torch.bfloat16, views="x"),
            gmm("ragged E2 C70 D128 F136 x^T and w^T views fp32 (simt)", 2, 70, 128, 136,
                torch.float32, views="xw")]),
        # mamba2-780m: 48 heads of 64 x 128 state, chunk 256, batch 1 x 8192
        # tokens = 32 chunks; fp32, and bf16 (the model's compute dtype).
        # P and N multiples of 16 (P <= 64, N <= 128) take the "wgmma"
        # route; other widths and unaligned bases the "simt" route
        spec("ssd_chunk", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:56",
             "ssd_wgmma", [
            ssd("mamba2-780m G1536 Q256 P64 N128", 48 * 32, 256, 64, 128, main=True),
            ssd("mamba2-780m G1536 Q256 P64 N128 bf16", 48 * 32, 256, 64, 128,
                     torch.bfloat16, main=True),
            ssd("ragged G6 Q32 P16 N8", 6, 32, 16, 8),
            ssd("ragged G3 Q50 P24 N12", 3, 50, 24, 12),
            ssd("ragged G4 Q64 P32 N16 bf16", 4, 64, 32, 16, torch.bfloat16),
            ssd("ragged G5 Q100 P32 N32", 5, 100, 32, 32),
            ssd("ragged G5 Q100 P16 N16 bf16", 5, 100, 16, 16, torch.bfloat16),
            ssd("ragged G4 Q100 P16 N32 fp16", 4, 100, 16, 32, torch.float16),
            ssd("ragged G3 Q130 P64 N128 bf16", 3, 130, 64, 128, torch.bfloat16),
            ssd("ragged G2 Q70 P64 N256 bf16 (N: simt)", 2, 70, 64, 256, torch.bfloat16),
            ssd("ragged G3 Q200 P48 N80", 3, 200, 48, 80),
            ssd("ragged G3 Q100 P24 N32 bf16 (P: simt)", 3, 100, 24, 32,
                     torch.bfloat16),
            ssd("ragged G3 Q100 P32 N32 unaligned (simt)", 3, 100, 32, 32,
                     offset=True)]),
    ]


def read_faults(planted):
    """Hold each planted fault (label, got, want, tol) to the per-row check,
    which must flag it; returns the readings, with the whole-tensor measure
    beside them."""
    import torch
    readings = []
    for label, got, want, tol in planted:
        got, want = _as_tuple(got), _as_tuple(want)
        r = dict(fault=label, row_err=max(row_err(a, b) for a, b in zip(got, want)),
                 global_err=max(global_err(a, b) for a, b in zip(got, want)), tol=tol)
        caught = r["row_err"] > tol
        print(f"planted fault {label:52s} row_err={r['row_err']:.3e} "
              f"(global {r['global_err']:.3e}) tol={tol:.0e} "
              f"{'caught' if caught else 'MISSED'}", flush=True)
        if not caught:
            fail(f"the per-row check misses the planted fault: {label}")
        readings.append(r)
    planted.clear()
    torch.cuda.empty_cache()
    return readings


def check_episodic_faults(specs):
    """Faults planted in the Mahalanobis head, the class second moment and
    the int8 matmul at their main shapes, each against the plain version on
    the intact inputs: the kernel fed a Sinv whose rows of one cluster
    rank's slice are zeroed, w with two class columns swapped, q whose K
    rows of the last K group of a block are zeroed, and the scales of
    quantisation blocks 0 and 1 swapped."""
    from repro_torch.kernels.int8_matmul import GROUPS, int8_matmul_plan
    from repro_torch.kernels.mahalanobis import mahalanobis_plan
    by = {spec["name"]: spec["cases"][0] for spec in specs}
    md, sm, im = by["mahalanobis"], by["class_second_moment"], by["int8_matmul"]
    q, mu, sinv = md["args"]
    plan = mahalanobis_plan(q.shape[1], q.shape[2], True)
    rank = min(3, plan.k - 1)
    i0, i1 = rank * plan.rows, min(q.shape[2], (rank + 1) * plan.rows)
    cut = sinv.clone()
    cut[:, :, i0:i1] = 0
    x, w = sm["args"]
    swapped = w.clone()
    swapped[..., [0, 1]] = w[..., [1, 0]]
    x8, q8, s8 = im["args"]
    step = int8_matmul_plan(*x8.shape, q8.shape[1], True).chunk // GROUPS
    k0, k1 = (GROUPS - 1) * step, min(q8.shape[0], GROUPS * step)
    q_cut = q8.clone()
    q_cut[k0:k1] = 0
    s_swapped = s8[:, [1, 0] + list(range(2, s8.shape[1]))].contiguous()
    want8 = im["plain"](x8, q8, s8)
    return read_faults([
        (f"mahalanobis: Sinv rows {i0}-{i1 - 1} (rank {rank}'s slice) zeroed",
         md["fn"](q, mu, cut), md["plain"](q, mu, sinv), md["tol"]),
        ("class_second_moment: w class columns 0 and 1 swapped",
         sm["fn"](x, swapped), sm["plain"](x, w), sm["tol"]),
        (f"int8_matmul: q rows {k0}-{k1 - 1} (K group {GROUPS - 1}'s) zeroed",
         im["fn"](x8, q_cut, s8), want8, im["tol"]),
        ("int8_matmul: scales of quantisation blocks 0 and 1 swapped",
         im["fn"](x8, q8, s_swapped), want8, im["tol"])])


def check_planted_faults(flash, ssd):
    """Faults planted in flash attention at S 8192 and in ssd_chunk at the
    mamba2-780m shape (fp32), each of which the per-row check must flag:
    late rows zeroed, the kv head read one off, the sliding window halved or
    one key block short; A read one head off, the last 32 dt of each chunk
    zeroed, y rows past Q/2 zeroed, the states of every other chunk zeroed.
    An SSD fault reads as the worst of its four outputs.  Returns their
    readings, with the whole-tensor measure beside them."""
    mini, local = flash["cases"][0], flash["cases"][2]
    q, k, v = mini["args"]
    want = mini["plain"](q, k, v, **mini["kw"])
    late = mini["fn"](q, k, v, **mini["kw"])
    late[:, q.shape[1] // 2:] = 0
    planted = [("minitron-4b: rows past S/2 zeroed", late, want, mini["tol"]),
               ("minitron-4b: kv head read one off",
                mini["fn"](q, k.roll(1, dims=2), v.roll(1, dims=2), **mini["kw"]), want,
                mini["tol"])]
    q, k, v = local["args"]
    kw = local["kw"]
    want = local["plain"](q, k, v, **kw)
    planted += [(f"gemma2-2b local: window {kw['window']} halved",
                 local["fn"](q, k, v, **{**kw, "window": kw["window"] // 2}), want,
                 local["tol"]),
                ("gemma2-2b local: window one 64-key block short",
                 local["fn"](q, k, v, **{**kw, "window": kw["window"] - 64}), want,
                 local["tol"])]
    mamba = ssd["cases"][0]
    x, dt, A, B, C = mamba["args"]
    want = mamba["plain"](x, dt, A, B, C)
    dt_short = dt.clone()
    dt_short[:, -32:] = 0
    y_late = mamba["fn"](x, dt, A, B, C)
    y_late[0][:, x.shape[1] // 2:] = 0
    st_gap = mamba["fn"](x, dt, A, B, C)
    st_gap[1][::2] = 0
    planted += [("mamba2-780m: A read one head off", mamba["fn"](x, dt, A.roll(1), B, C),
                 want, mamba["tol"]),
                ("mamba2-780m: last 32 dt of each chunk zeroed",
                 mamba["fn"](x, dt_short, A, B, C), want, mamba["tol"]),
                ("mamba2-780m: y rows past Q/2 zeroed", y_late, want, mamba["tol"]),
                ("mamba2-780m: states of every other chunk zeroed", st_gap, want,
                 mamba["tol"])]
    return read_faults(planted)


# the backward kernels against their closed forms, per row (row_err): B5's
# dq, dk, dv are bf16 sums over up to S keys of dS (rounded to bf16 by the
# kernel, 2^-9 relative, not by the plain version) times k or q, then
# rounded to bf16 (2^-8); fp32 as the forward's.  A row of B5's gradients
# is held to at least BWD_ROW_FLOOR of its tensor's max: dq of a query that
# sees one key is 0 (dP = Delta), and the two sides' fp32 sums leave
# different noise there.  B6's fp32 path shapes are held against an fp64
# evaluation of the closed form (bwd_fp64_held)
BWD_TOL = {"flash_attention_bwd": {"float32": 2e-5, "bfloat16": 3e-2, "float16": 1e-2},
           "ssd_chunk_bwd": 1e-4}
BWD_ROW_FLOOR = 1e-2


def flash_bwd_case(randn, label, b, s, hq, hkv, d, dtype, main=False, lib=False,
                   iters=(3, 3), **kw):
    """A case of B5's backward kernel (``flash_attention_gqa_bwd``) on q (b,
    s, hq, d), k, v (b, s, hkv, d) and a cotangent drawn by ``randn``, from
    the forward kernel's output and lse, as :func:`check_kernels` takes it;
    ``lib`` times SDPA's backward beside it (``torch.autograd.grad``
    through ``F.scaled_dot_product_attention``, its forward timed apart and
    subtracted)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline import flash_bwd_work
    q, k, v, do = (randn(b, s, h, d, dtype=dtype) for h in (hq, hkv, hkv, hq))
    o, lse = fa.flash_attention_gqa(q, k, v, with_lse=True, **kw)
    nbytes, flops = flash_bwd_work(b, s, hq, hkv, d, q.element_size(), kw["causal"],
                                   kw.get("window"))
    case = dict(label=label, fn=fa.flash_attention_gqa_bwd,
                plain=fa.flash_attention_gqa_bwd_plain, route=fa.flash_bwd_route(q, k, v, do),
                lib=None, args=(q, k, v, o, lse, do), kw=kw,
                tol=BWD_TOL["flash_attention_bwd"][str(dtype).split(".")[1]],
                row_floor=BWD_ROW_FLOOR, main=main, iters=iters, bytes=nbytes, flops=flops,
                peak=BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
    if lib:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=kw["causal"],
                                                  enable_gqa=True)

        case |= dict(lib=lambda *_: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                     lib_minus=sdpa, lib_note="SDPA's backward through torch.autograd.grad, "
                                              "its forward timed apart and subtracted")
    return case


def ssd_bwd_case(g, dev, label, gg, q, p, n, dtype=None, main=False, cots=(1, 1, 1, 1),
                 iters=(3, 3)):
    """A case of B6's backward kernel (``ssd_chunk_bwd``) on :func:`ssd_case`'s
    inputs and fp32 cotangents of its four outputs (those of ``cots``; the
    others None), as :func:`check_kernels` takes it.  The work counted
    once, at the rate of the units that do it."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.roofline import ssd_bwd_work
    fwd = ssd_case(g, dev, label, gg, q, p, n, dtype)
    x, dt, A, B, C = fwd["args"]
    shapes = ((gg, q, p), (gg, p, n), (gg,), (gg, q))
    cot = [torch.randn(*sh, generator=g).to(dev) if on else None
           for sh, on in zip(shapes, cots)]
    route = ssd.ssd_bwd_route(x, dt, A, B, C)
    nbytes, flops = ssd_bwd_work(gg, q, p, n, x.element_size(), tuple(map(bool, cots)))
    return dict(label=label, fn=ssd.ssd_chunk_bwd, plain=ssd.ssd_chunk_bwd_plain, lib=None,
                route=route, args=(x, dt, A, B, C, *cot), tol=BWD_TOL["ssd_chunk_bwd"],
                main=main, iters=iters, bytes=nbytes, flops=flops,
                peak=BF16_FLOPS if route == "wgmma" else FP32_FLOPS)


def bwd_fp64_held(case):
    """A B6 backward case held against the closed form evaluated in fp64 (its
    outputs cast to fp32), at LM_GATE times the fp32 plain version's own
    per-row error against it (at least the case's tolerance), as
    :func:`fp64_held` holds the forward."""
    from repro_torch.kernels import ssd_scan as ssd
    args64 = [a.double() if a is not None else None for a in case["args"]]
    want = tuple(t.float() for t in ssd.ssd_chunk_bwd_plain(*args64))
    own = max(row_err(a, b) for a, b in zip(case["plain"](*case["args"]), want))
    return case | dict(oracle=lambda *a: want, tol=max(case["tol"], LM_GATE * own),
                       plain_row_err_vs_fp64=own)


def backward_kernel_specs(dev):
    """The two backward kernels at every path shape that trains through
    them, and at ragged shapes on both routes, as :func:`check_kernels`
    takes them: B5's (K5b) at gemma2-2b's step (phase 5d), minitron-4b's
    LITE H pass and queries (5c), whisper-base's encoder and decoder (6e)
    and zamba2-7b's shared block (5f), bf16, beside SDPA's backward where
    there is no softcap, and at ragged shapes (among them the tensor-core
    route's hardest tile edges: D 256 causal with a window at S 333, and
    fp16 D 64 bidirectional at S 1493); B6's (K6b) at mamba2-780m's and
    zamba2-7b's steps (5f), fp32 operands, held against fp64, and on a chunk
    whose Q is not a multiple of 64."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(10)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    fl = functools.partial(flash_bwd_case, randn)
    sb = functools.partial(ssd_bwd_case, g, dev)
    b, s = PRETRAIN_BATCH, PRETRAIN_SEQ
    n_h = LM_TRAIN_TASKS * LM_TRAIN_LITE["h"]
    n_q = LM_TRAIN_TASKS * LM_TASK["way"] * LM_TASK["query_per_class"]
    sq, bt, ws = LM_TASK["seq_len"], WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ
    src = "src/repro_torch/kernels/csrc/"
    return [
        dict(name="flash_attention_bwd", source=src + "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:89", symbol="flash_bwd", cases=[
            fl(f"gemma2-2b local B{b} S{s} Hq8 Hkv4 D256 window4096 cap50", b, s, 8, 4, 256,
               bf, main=True, causal=True, window=4096, softcap=50.0),
            fl(f"gemma2-2b global B{b} S{s} Hq8 Hkv4 D256 cap50", b, s, 8, 4, 256, bf,
               main=True, causal=True, softcap=50.0),
            fl(f"minitron-4b LITE H pass B{n_h} S{sq} Hq24 Hkv8 D128 causal", n_h, sq, 24, 8,
               128, bf, main=True, lib=True, iters=(10, 5), causal=True),
            fl(f"minitron-4b queries B{n_q} S{sq} Hq24 Hkv8 D128 causal", n_q, sq, 24, 8, 128,
               bf, main=True, lib=True, iters=(10, 5), causal=True),
            fl(f"whisper-base encoder train B{bt} S1500 Hq8 Hkv8 D64 non-causal", bt, 1500, 8,
               8, 64, bf, main=True, lib=True, iters=(10, 5), causal=False),
            fl(f"whisper-base decoder train B{bt} S{ws} Hq8 Hkv8 D64 causal", bt, ws, 8, 8, 64,
               bf, main=True, lib=True, iters=(10, 5), causal=True),
            fl(f"zamba2-7b train B{b} S{ZAMBA_TRAIN_SEQ} Hq32 Hkv32 D112 causal", b,
               ZAMBA_TRAIN_SEQ, 32, 32, 112, bf, main=True, lib=True, iters=(5, 3),
               causal=True),
            fl("ragged B2 S130 Hq2 Hkv1 D96 window30 non-causal", 2, 130, 2, 1, 96, bf,
               causal=False, window=30),
            fl("ragged B1 S333 Hq4 Hkv2 D256 window100 causal", 1, 333, 4, 2, 256, bf,
               causal=True, window=100),
            fl("ragged B2 S1493 Hq4 Hkv4 D64 fp16 non-causal", 2, 1493, 4, 4, 64, f16,
               causal=False),
            fl("ragged B2 S100 Hq4 Hkv2 D128 fp16 causal", 2, 100, 4, 2, 128, f16,
               causal=True),
            fl("ragged B2 S77 Hq4 Hkv2 D64 fp32 cap5 (simt)", 2, 77, 4, 2, 64, f32,
               causal=True, softcap=5.0),
            fl("ragged B2 S77 Hq4 Hkv2 D40 non-causal (simt)", 2, 77, 4, 2, 40, bf,
               causal=False)]),
        dict(name="ssd_chunk_bwd", source=src + "ssd_scan_bwd.cu",
             replaces="src/repro/kernels/ssd_scan.py:56", symbol="ssd_bwd", cases=[
            bwd_fp64_held(sb(f"mamba2-780m train G{b * SSM_TRAIN_SEQ // 256 * 48} Q256 P64 "
                             f"N128 fp32", b * SSM_TRAIN_SEQ // 256 * 48, 256, 64, 128,
                             main=True)),
            bwd_fp64_held(sb(f"zamba2-7b train G{b * ZAMBA_TRAIN_SEQ // 256 * 112} Q256 P64 "
                             f"N64 fp32", b * ZAMBA_TRAIN_SEQ // 256 * 112, 256, 64, 64,
                             main=True)),
            bwd_fp64_held(sb("ragged G96 Q100 P64 N128 fp32", 96, 100, 64, 128)),
            sb("ragged G8 Q128 P64 N128 bf16, gy alone", 8, 128, 64, 128, bf,
               cots=(1, 0, 0, 0)),
            sb("ragged G8 Q64 P32 N32 fp32, no gy", 8, 64, 32, 32, cots=(0, 1, 1, 1)),
            sb("ragged G4 Q50 P20 N12 fp32 (simt)", 4, 50, 20, 12),
            sb("ragged G3 Q600 P16 N16 fp32 (Q: simt)", 3, 600, 16, 16)]),
    ]


def run_ops_path(dev, launches):
    """Drive repro_torch.kernels.ops once on every main shape with the
    launch counts set to 0 just before and read just after; then hold each
    output, and the ragged shapes, against the plain versions and time the
    main shapes; then check that planted faults are caught.  Returns the
    kernels' rows and the planted faults' readings."""
    import torch
    from repro_torch.kernels import _build
    specs = ops_cases(dev)
    mains = [(spec["name"], i, c) for spec in specs
             for i, c in enumerate(spec["cases"]) if c["main"]]
    torch.cuda.synchronize()
    _build.launches.reset()
    outs = {(name, i): _as_tuple(c["fn"](*c["args"], **c.get("kw", {}))) for name, i, c in mains}
    torch.cuda.synchronize()
    counts = _build.launches.snapshot()
    launches["ops"] = counts
    print(f"path ops: {len(mains)} calls through repro_torch.kernels.ops at published "
          f"widths, launches {counts}", flush=True)
    for name in ("flash_attention", "gmm", "ssd_chunk"):   # the tensor-core kernels
        n_main = sum(1 for n, _, _ in mains if n == name)
        routes = [c["route"] for n, _, c in mains if n == name]
        if routes != ["wgmma"] * n_main or counts.get(f"{name}/wgmma", 0) != n_main:
            fail(f"{name}: the main calls took routes {routes}, launches {counts}; "
                 f"all {n_main} must take the tensor-core route (wgmma)")
    rows = check_kernels(specs, counted=outs)
    return rows, check_planted_faults(specs[0], specs[2])


# ---------------------------------------------------------------------------
# phase 6b: LM decode serving of the dense GQA transformers
# ---------------------------------------------------------------------------

LM_SLOTS = 4
LM_MAX_NEW = 16
LM_SERVE_LAYERS = 8         # minitron-4b's 32 cut to 8 (16 before phase 6f)
# wave 1: four prompts of one length decode as one stacked cohort; wave 2:
# ragged lengths, which decode slot by slot
LM_PROMPTS = (1024, 1024, 1024, 1024, 512, 2048, 512, 2048)
LM_PREFILL_LENGTHS = (512, 1024, 2048)
LM_DECODE_POS = 1024
# the kernel path's logits may be at most LM_GATE times as far from an
# fp32-compute ref run (TF32 off) as the bf16 ref run is: both bf16 runs
# share the weights' rounding to bf16, which dominates their error, and
# differ only in attention's roundings of P (normalised and rounded to bf16
# in ref, un-normalised in the kernel's registers)
LM_GATE = 2.0
# gemma2-2b: one prompt past the 4096-token window, one inside it.  The long
# prompt's first GEMMA_HIDDEN tokens are one token repeated, so what the
# window hides from the last positions is coherent and a wrong window moves
# the logits well past rounding (random tokens there would average out)
GEMMA_PROMPTS = (4608, 1024)
GEMMA_HIDDEN = 512
GEMMA_MAX_NEW = 8
LM_CATEGORIES = (   # device kernel name -> what it is, first match wins
    ("B5 backward", ("flash_bwd",)),
    ("B5 flash_attention", ("flash_attention",)),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "gemv", "xmma", "splitk", "dot_kernel")),
    ("reductions", ("reduce", "softmax", "norm")),
    ("copies", ("memcpy", "memset", "copy", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index")),
)


def lm_requests(cfg, lengths, max_new: int, seed: int, hidden: int = 0):
    """One request of each prompt length, tokens from numpy's generator; a
    prompt longer than ``hidden`` has its first ``hidden`` tokens set to
    its first token."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lengths):
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        if hidden and n > hidden:
            prompt[:hidden] = prompt[0]
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
    return reqs


def lm_engine(cfg, params, backend: str, slots: int, max_seq: int, record=None,
              forced=None, timeline=None):
    """A ``ServeEngine``; with ``record``, one whose sampler keeps every
    logits row it samples from (true vocab, under the request's uid) and,
    with ``forced``, emits the given tokens in place of its own (teacher
    forcing), so two runs decode the same token streams; with ``timeline``,
    it appends ("sample", uid) there at each sample."""
    from repro_torch.serve.engine import ServeEngine

    class Recorded(ServeEngine):
        def _sample(self, logits, req):
            record.setdefault(req.uid, []).append(logits[0, :cfg.vocab].float())
            if timeline is not None:
                timeline.append(("sample", req.uid))
            if forced is not None:
                return [forced[req.uid][len(req.out_tokens)]]
            return super()._sample(logits, req)

    cls = ServeEngine if record is None else Recorded
    return cls(cfg, params, n_slots=slots, max_seq=max_seq, kernel_backend=backend)


def lm_errs(got, want, skip=frozenset()):
    """(prefill, decode) error: the largest over requests of max|got - want|
    of a logits row over that row's max|want|; row 0 of a request is its
    prefill's, the rest its decode steps'.  Rows (uid, j) in ``skip`` are
    not read."""
    pre, dec = 0.0, 0.0
    for uid, rows in want.items():
        if len(got[uid]) != len(rows):
            fail(f"request {uid}: {len(got[uid])} logits rows against {len(rows)}")
        for j, (g, w) in enumerate(zip(got[uid], rows)):
            if not bool(g.isfinite().all()):
                fail(f"request {uid}: non-finite logits at step {j}")
            if (uid, j) in skip:
                continue
            e = global_err(g, w)
            pre, dec = (max(pre, e), dec) if j == 0 else (pre, max(dec, e))
    return pre, dec


def lm_gate(label: str, runs, fault: bool = False, skip=frozenset(), run: str = "got",
            states: bool = False, states_name: str = "prefill SSM states"):
    """Hold ``run`` (the kernel path ``got``, or a planted fault's run)
    against ``ref32`` at LM_GATE times the error of ``ref16``, on every
    logits row but those in ``skip`` and, with ``states``, on the
    per-layer tensors each prefill left in ``runs["states"]`` (read by
    :func:`ssm_state_err`; ``states_name`` names them): the SSM states (at
    random initialisation the SSD is about 1 % of each mixer's output
    beside its D skip, under bf16's rounding of their sum, so a fault
    inside B6 barely moves the logits, while the states are B6's own
    product) or whisper's cross k and v (the encoder's only way to the
    logits); returns the readings.  A fault must fail the gate."""
    def errs(a, b):
        e = lm_errs(runs[a], runs[b], skip)
        return e + (ssm_state_err(runs["states"][a], runs["states"][b]),) if states else e

    e_ref, e_got, e_pair = errs("ref16", "ref32"), errs(run, "ref32"), errs(run, "ref16")
    limit = [LM_GATE * e for e in e_ref]
    passed = all(g <= lim for g, lim in zip(e_got, limit))
    show = lambda es: "/".join(f"{e:.3e}" for e in es)  # noqa: E731
    print(f"  {label}: vs fp32 ref, prefill/decode logits"
          f"{' / ' + states_name if states else ''} err {show(e_got)} (gate "
          f"{show(limit)} = {LM_GATE}x bf16 ref's {show(e_ref)}); vs bf16 ref "
          f"{show(e_pair)} "
          f"{('MISSED' if passed else 'caught') if fault else ('ok' if passed else 'FAIL')}",
          flush=True)
    if passed == fault:
        fail(f"{label}: " + ("the gate misses the planted fault" if fault else
                             "the kernel path is outside its gate"))
    return dict(err_vs_fp32=e_got, ref16_err_vs_fp32=e_ref, err_vs_ref16=e_pair,
                gate=limit, passed=passed)


def recording_states(engine, store: list):
    """``engine`` with each ``prefill``'s SSM states (the cache's ``ssm``
    leaf, fp32) appended to ``store``, in the order of the calls."""
    import dataclasses
    prefill = engine.api.prefill

    def call(*a, **kw):
        logits, cache = prefill(*a, **kw)
        store.append(cache["ssm"].clone())
        return logits, cache

    engine.api = dataclasses.replace(engine.api, prefill=call)
    return engine


def lm_runs(cfg, params32, params16, reqs, slots, max_seq, fault=None, states=False):
    """The traffic ``reqs()`` through recorded engines: ``ref`` in the
    compute dtype (greedy; its tokens are forced on the others), the kernel
    path, ``ref`` in fp32 compute and, given ``fault`` (a context manager
    that plants one), the kernel path with the fault.  With ``states``,
    each run's prefill SSM states go to ``runs["states"][run]``."""
    import dataclasses
    runs = {"ref16": {}, "states": {}}

    def engine(name, *args, **kw):
        eng = lm_engine(*args, record=runs[name], **kw)
        return recording_states(eng, runs["states"].setdefault(name, [])) if states else eng

    ref_reqs = reqs()
    engine("ref16", cfg, params16, "ref", slots, max_seq).run_to_completion(ref_reqs)
    forced = {r.uid: r.out_tokens for r in ref_reqs}
    runs["got"] = {}
    engine("got", cfg, params16, "cuda", slots, max_seq, forced=forced).run_to_completion(reqs())
    runs["ref32"] = {}
    engine("ref32", dataclasses.replace(cfg, compute_dtype="float32"), params32, "ref", slots,
           max_seq, forced=forced).run_to_completion(reqs())
    if fault is not None:
        runs["fault"] = {}
        with fault():
            engine("fault", cfg, params16, "cuda", slots, max_seq,
                   forced=forced).run_to_completion(reqs())
    return runs


def lm_counted(cfg, params16, reqs, slots, max_seq, dev):
    """One plain engine run on the kernels with the launch counts set to 0
    just before and read just after; (requests, counts, wall s, peak B)."""
    import torch
    from repro_torch.kernels import _build
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    t0 = time.perf_counter()
    served = lm_engine(cfg, params16, "cuda", slots, max_seq).run_to_completion(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    n_prefill = len(reqs) * cfg.n_layers
    if counts != {"flash_attention": n_prefill, "flash_attention/wgmma": n_prefill}:
        fail(f"{cfg.name}: launches {counts}; every layer of each of the {len(reqs)} "
             f"prefills must launch B5 on the wgmma route ({n_prefill}) and nothing else")
    for r in served:
        if not r.done or len(r.out_tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"{cfg.name} request {r.uid}: done={r.done}, tokens {r.out_tokens}")
    return served, counts, wall, peak


def trace_lm(fn, wall_ms: float, label: str, top: int = 8, categories=LM_CATEGORIES,
             kernel: str = "B5 flash_attention"):
    """One call of ``fn`` under torch.profiler: device busy time by kind of
    kernel (``categories``), ``kernel``'s share of it, the idle share
    against ``wall_ms`` (the unprofiled call), and the top kernels."""
    kern = lambda cats: cats.get(kernel, {}).get("device_ms", 0.0)
    busy, cats, table = device_breakdown(
        fn, categories,
        lambda busy, cats: f"  trace {label}: device busy {busy:.3f} ms of an unprofiled "
                           f"{wall_ms:.3f} ms (idle share {1 - busy / wall_ms:.3f}); "
                           f"{kernel.split()[0]} {kern(cats):.3f} ms = "
                           f"{100 * kern(cats) / max(busy, 1e-9):.1f} % of busy", top)
    return dict(busy_ms=busy, wall_ms=wall_ms, idle_share=1 - busy / wall_ms, kernel=kernel,
                kernel_ms=kern(cats), kernel_share=kern(cats) / max(busy, 1e-9),
                categories=cats, top=table[:20])


def lm_timings(cfg, params16, dev):
    """Prefill ms by prompt length on the kernels and on ``ref`` in turns,
    the first-token latency (``add_request``: prefill, splice, first
    sample), a decode step at LM_SLOTS slots and at 1 beside their bounds,
    and one profiled prefill and decode step."""
    import torch
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    out = dict(prefill={}, decode={})
    for n in LM_PREFILL_LENGTHS:
        batch = dict(tokens=torch.randint(0, cfg.vocab, (1, n), generator=g, device=dev))
        k_ms, r_ms = time_pair_ms(lambda: api.prefill(params16, batch, cfg, backend="cuda"),
                                  lambda: api.prefill(params16, batch, cfg, backend="ref"),
                                  iters=3, reps=3)
        eng = lm_engine(cfg, params16, "cuda", 1, n + 8)
        ftl = []
        for r in lm_requests(cfg, (n,) * 3, 1, seed=4):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            eng.add_request(r)            # a budget of 1: the slot frees at once
            ftl.append((time.perf_counter() - t0) * 1e3)
        (b_ms, b_by), _ = lm_bounds(cfg, n, 1, n)
        out["prefill"][n] = dict(ms=k_ms, ref_ms=r_ms, first_token_ms=statistics.median(ftl),
                                 bound_ms=b_ms, bound_by=b_by)
        print(f"  prefill S{n}: {k_ms:.3f} ms on the kernels, {r_ms:.3f} ms on ref, "
              f"first token {statistics.median(ftl):.3f} ms; bound {b_ms:.3f} ms ({b_by})",
              flush=True)
    for b in (LM_SLOTS, 1):
        cache = api.init_cache(cfg, b, LM_DECODE_POS + 8, dev)
        cache["len"] = LM_DECODE_POS
        toks = torch.zeros((b, 1), dtype=torch.long, device=dev)
        ms = time_ms(lambda: api.decode_step(params16, cache, toks, cfg), iters=10, reps=3)
        _, (b_ms, b_by) = lm_bounds(cfg, 1, b, LM_DECODE_POS + 1)
        out["decode"][b] = dict(ms=ms, tokens_per_s=b * 1e3 / ms, bound_ms=b_ms,
                                bound_by=b_by, pos=LM_DECODE_POS)
        print(f"  decode step at {b} slot(s), position {LM_DECODE_POS}: {ms:.3f} ms "
              f"({b * 1e3 / ms:.1f} tokens/s); bound {b_ms:.3f} ms ({b_by})", flush=True)
    n = LM_PREFILL_LENGTHS[1]
    batch = dict(tokens=torch.randint(0, cfg.vocab, (1, n), generator=g, device=dev))
    out["trace_prefill"] = trace_lm(lambda: api.prefill(params16, batch, cfg, backend="cuda"),
                                    out["prefill"][n]["ms"], f"prefill S{n}")
    cache = api.init_cache(cfg, LM_SLOTS, LM_DECODE_POS + 8, dev)
    cache["len"] = LM_DECODE_POS
    toks = torch.zeros((LM_SLOTS, 1), dtype=torch.long, device=dev)
    out["trace_decode"] = trace_lm(lambda: api.decode_step(params16, cache, toks, cfg),
                                   out["decode"][LM_SLOTS]["ms"],
                                   f"decode step at {LM_SLOTS} slots")
    return out


@contextlib.contextmanager
def swapped_windows():
    """The planted fault: local and global layers' windows swapped."""
    from repro_torch.models import transformer as TT
    orig = TT.layer_windows
    TT.layer_windows = lambda cfg: [cfg.sliding_window if w == TT.GLOBAL_WINDOW
                                    else TT.GLOBAL_WINDOW for w in orig(cfg)]
    try:
        yield
    finally:
        TT.layer_windows = orig


def prefill_kernel_specs(dev):
    """B5 at the prefill shapes of this phase's traffic, as
    :func:`check_kernels` takes them: against its plain version, timed
    beside SDPA in turns (minitron-4b; SDPA has no softcap, so none beside
    gemma2-2b's)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    bf = torch.bfloat16
    return [dict(name="flash_attention", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:89",
                 symbol="flash_attention_wgmma_kernel", cases=[
        *(flash_case(randn, f"minitron-4b prefill B1 S{n} Hq24 Hkv8 D128 causal", 1, n, 24,
                     8, 128, bf, main=True, lib=True, iters=(20, 5), causal=True)
          for n in LM_PREFILL_LENGTHS),
        flash_case(randn, "gemma2-2b local prefill B1 S4608 Hq8 Hkv4 D256 window4096 cap50",
                   1, 4608, 8, 4, 256, bf, main=True, iters=(10, 5), causal=True,
                   window=4096, softcap=50.0)])]


def run_lm_serve(dev, launches):
    """Phase 6b: LM decode serving of minitron-4b (LM_SERVE_LAYERS layers)
    and gemma2-2b (every layer) at full width on random weights drawn on the
    card, bf16 compute."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TT
    t_phase = time.perf_counter()
    out = dict(kind="lm_serve")

    cfg = dataclasses.replace(get_config("minitron-4b"), n_layers=LM_SERVE_LAYERS)
    params = TT.init_transformer(torch.Generator(device=dev).manual_seed(0), cfg)
    p16 = TT.compute_params(params, cfg)
    max_seq = max(LM_PROMPTS) + LM_MAX_NEW + 8
    for backend in ("cuda", "ref"):         # cuBLAS handles, allocator
        lm_engine(cfg, p16, backend, 1, 128).run_to_completion(
            lm_requests(cfg, (64,), 2, seed=1))
    served, counts, wall, peak = lm_counted(cfg, p16, lm_requests(
        cfg, LM_PROMPTS, LM_MAX_NEW, seed=0), LM_SLOTS, max_seq, dev)
    launches["lm_serve"] = counts
    mark("6b: minitron-4b counted run done")
    n_tok = sum(len(r.out_tokens) for r in served)
    print(f"path lm_serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), "
          f"{len(served)} requests "
          f"(prompts {LM_PROMPTS}), {n_tok} tokens in {wall:.3f} s on {LM_SLOTS} slots: "
          f"{n_tok / wall:.1f} tokens/s, peak memory {peak} B, launches {counts}",
          flush=True)
    runs = lm_runs(cfg, params, p16, lambda: lm_requests(cfg, LM_PROMPTS, LM_MAX_NEW,
                                                         seed=0), LM_SLOTS, max_seq)
    gate = lm_gate(f"{cfg.name} kernel path", runs)
    del runs
    mark("6b: minitron-4b gate done")
    timings = lm_timings(cfg, p16, dev)
    mark("6b: minitron-4b timings done")
    out["minitron"] = dict(requests=len(served), tokens=n_tok, seconds=wall,
                           tokens_per_s=n_tok / wall, peak_bytes=peak, launches=counts,
                           gate=gate, **timings)
    del params, p16
    torch.cuda.empty_cache()

    gcfg = get_config("gemma2-2b")
    gparams = TT.init_transformer(torch.Generator(device=dev).manual_seed(0), gcfg)
    g16 = TT.compute_params(gparams, gcfg)
    gmax = max(GEMMA_PROMPTS) + GEMMA_MAX_NEW + 8
    greqs = lambda: lm_requests(gcfg, GEMMA_PROMPTS, GEMMA_MAX_NEW, seed=3,
                                hidden=GEMMA_HIDDEN)
    served, gcounts, gwall, gpeak = lm_counted(gcfg, g16, greqs(), 2, gmax, dev)
    launches["lm_serve_gemma2"] = gcounts
    print(f"path lm_serve_gemma2: {gcfg.name} ({gcfg.n_layers} layers, head dim "
          f"{gcfg.attention.head_dim}, softcap {gcfg.attention.attn_softcap}, window "
          f"{gcfg.sliding_window}), "
          f"prompts {GEMMA_PROMPTS}, {sum(len(r.out_tokens) for r in served)} tokens in "
          f"{gwall:.3f} s, peak memory {gpeak} B, launches {gcounts}", flush=True)
    runs = lm_runs(gcfg, gparams, g16, greqs, 2, gmax, fault=swapped_windows)
    ggate = lm_gate(f"{gcfg.name} kernel path", runs)
    fault = lm_gate(f"{gcfg.name} planted fault: local and global windows swapped", runs,
                    fault=True, run="fault")
    out["gemma2"] = dict(seconds=gwall, peak_bytes=gpeak, launches=gcounts, gate=ggate,
                         planted_fault=fault)
    mark("6b: gemma2-2b done")
    del runs, gparams, g16
    torch.cuda.empty_cache()

    out["prefill_kernel"] = check_kernels(prefill_kernel_specs(dev))["flash_attention"]
    defer(out, "launcher", run_lm_serve_launcher)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 6b: {out['seconds']:.1f} s", flush=True)
    return out


def run_lm_serve_launcher(extra=()):
    """``python -m repro_torch.launch.serve`` (LM, smoke config; ``extra``
    arguments, such as another ``--arch``) on the card as a subprocess,
    which must exit 0 and print its tokens/s line on ``device=cuda``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "4", "--slots",
           "2", "--max-new", "8", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    secs = time.perf_counter() - t0
    line = next((l for l in proc.stdout.splitlines() if "tok/s" in l), proc.stdout[-500:])
    print(f"serve launcher (LM): {' '.join(cmd[1:])} exit {proc.returncode} in {secs:.1f} s; "
          f"{line}", flush=True)
    if proc.returncode != 0 or "device=cuda" not in line:
        fail(f"the LM serving launcher failed (exit {proc.returncode}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return dict(cmd=cmd[1:], exit=proc.returncode, seconds=secs, line=line)


# ---------------------------------------------------------------------------
# phase 6c: LM decode serving of the MoE and MLA transformers
# ---------------------------------------------------------------------------

# (arch, layers kept): full published width, depth cut to fit one card
# (kimi-k2: 33.8 GB of bf16 experts a layer) and the run's time
MOE_MODELS = (("kimi-k2-1t-a32b", 1), ("deepseek-v2-236b", 2))
MOE_SLOTS = 2
MOE_MAX_NEW = 8
# wave 1: two prompts of one length decode as one stacked cohort; wave 2:
# ragged lengths, which decode slot by slot
MOE_PROMPTS = (1024, 1024, 512, 2048)
MOE_PREFILL = 1024
MOE_DECODE_POS = 1024
# the gate reads at least this share of the logits rows: the rest are rows
# whose token the three runs route to different experts (see moe_gate)
MOE_MIN_READ = 0.5
MOE_CATEGORIES = (("B7 gmm", ("gmm",)),) + LM_CATEGORIES


def moe_model(arch: str, layers: int, dev):
    """The config at full width and ``layers`` layers, and its params drawn
    on the card from seed 0, every leaf in the config's bf16 param dtype as
    it is drawn (the fp32 draws of one kimi-k2 layer's experts alone would
    not fit)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = TT.init_transformer(torch.Generator(device=dev).manual_seed(0), cfg,
                                 at_param_dtype=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return cfg, params


def moe_reqs(cfg):
    return lm_requests(cfg, MOE_PROMPTS, MOE_MAX_NEW, seed=0)


def moe_counted(cfg, params, dev):
    """One engine run on the kernels with the launch counts set to 0 just
    before and read just after, the engine's model calls counted: B7 must
    have launched on "wgmma" three times per layer per ``prefill`` and per
    ``decode_step`` call, B5 on "wgmma" once per GQA prefill layer, and
    nothing else.  Returns (requests, counts, calls, wall s, peak B)."""
    import torch
    from repro_torch.kernels import _build
    record = []
    eng = launches_by_call(lm_engine(cfg, params, "cuda", MOE_SLOTS,
                                     max(MOE_PROMPTS) + MOE_MAX_NEW + 8), record)
    reqs = moe_reqs(cfg)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    t0 = time.perf_counter()
    eng.run_to_completion(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    calls = engine_calls(record)
    n_gmm = 3 * cfg.n_layers * (calls["prefill"] + calls["decode_step"])
    want = {"gmm": n_gmm, "gmm/wgmma": n_gmm}
    if cfg.attention.kind == "gqa":
        n_fa = cfg.n_layers * calls["prefill"]
        want |= {"flash_attention": n_fa, "flash_attention/wgmma": n_fa}
    if counts != want or calls.get("prefill") != len(MOE_PROMPTS):
        fail(f"{cfg.name}: launches {counts} over engine calls {calls}; want {want}")
    for r in reqs:
        if not r.done or len(r.out_tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"{cfg.name} request {r.uid}: done={r.done}, tokens {r.out_tokens}")
    return reqs, counts, calls, wall, peak


@contextlib.contextmanager
def recording_routes(timeline: list):
    """Append ("route", expert ids (T, k)) to ``timeline`` at every call of
    the MoE router, in call order."""
    from repro_torch.models import moe as M
    orig = M.router_probs

    def router(p, x, cfg):
        out = orig(p, x, cfg)
        timeline.append(("route", out[1]))
        return out

    M.router_probs = router
    try:
        yield
    finally:
        M.router_probs = orig


def kept_experts(ids, cfg):
    """(T, k) expert ids -> (T, k) on the host: each token's experts that
    keep it within capacity (the stable sort of ``moe_ffn``), sorted, -1
    where a slot was dropped."""
    import torch
    from repro_torch.models import moe as M
    t, k = ids.shape
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=cfg.moe.n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(t * k, device=ids.device) - starts[flat[order]]
    keep = (rank < M.capacity(t, cfg.moe)).reshape(t, k)
    return torch.where(keep, ids, -1).sort(dim=1).values.cpu()


def routings(timeline: list, cfg):
    """The timeline of one engine run -> (per route call, the kept experts of
    each token; per sampled logits row (uid, j) in sample order, the index
    of its token in each of the calls that made it).  A call's tokens are
    sampled from in order, one row each (decode), or only its last token
    (a prefill)."""
    calls, rows, seen, i = [], [], {}, 0
    while i < len(timeline):
        group = []
        while i < len(timeline) and timeline[i][0] == "route":
            group.append(len(calls))
            calls.append(kept_experts(timeline[i][1], cfg))
            i += 1
        uids = []
        while i < len(timeline) and timeline[i][0] == "sample":
            uids.append(timeline[i][1])
            i += 1
        t = calls[group[0]].shape[0]
        for n, uid in enumerate(uids):
            j = seen.get(uid, 0)
            seen[uid] = j + 1
            rows.append(((uid, j), [(c, n if len(uids) == t else t - 1) for c in group]))
    return calls, rows


def moe_runs(cfg, params, fault=None):
    """The traffic through recorded engines with every routing recorded:
    ``ref`` in bf16 (greedy; its tokens are forced on the others), the
    kernel path, ``ref`` in fp32 compute from the same bf16 weights (the
    fp32 masters do not fit: ``compute_params`` does not widen them, each
    layer casts its weight to fp32 at the call) and, given ``fault``, the
    kernel path with it.  Returns the logits runs, the routing runs and
    each run's peak memory."""
    import dataclasses
    import torch
    max_seq = max(MOE_PROMPTS) + MOE_MAX_NEW + 8
    runs, routes, peaks = {}, {}, {}
    forced = None
    plan = [("ref16", cfg, "ref", None), ("got", cfg, "cuda", None),
            ("ref32", dataclasses.replace(cfg, compute_dtype="float32"), "ref", None)]
    if fault is not None:
        plan.append(("fault", cfg, "cuda", fault))
    for name, c, backend, ctx in plan:
        runs[name], timeline = {}, []
        reqs = moe_reqs(cfg)
        # the previous run's cached blocks released: the fp32 run casts a
        # whole expert bank at once (21 GB at kimi-k2's width), and phase
        # 6f's idle ranks hold their contexts on the card meanwhile
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with recording_routes(timeline), (ctx() if ctx else contextlib.nullcontext()):
            lm_engine(c, params, backend, MOE_SLOTS, max_seq, record=runs[name],
                      forced=forced, timeline=timeline).run_to_completion(reqs)
        peaks[name] = torch.cuda.max_memory_allocated()
        routes[name] = routings(timeline, cfg)
        if forced is None:
            forced = {r.uid: r.out_tokens for r in reqs}
        mark(f"6c: {cfg.name} {name} run done (peak memory {peaks[name]} B)")
    return runs, routes, peaks


def route_disagreements(routes, names=("ref16", "got", "ref32")):
    """(the (token, layer) routings on which each pair of runs disagrees,
    out of how many; the logits rows whose token any two of ``names`` route
    differently at some layer)."""
    import torch
    calls = {n: routes[n][0] for n in names}
    if len({len(c) for c in calls.values()}) != 1:
        fail(f"the runs made different numbers of router calls: "
             f"{ {n: len(c) for n, c in calls.items()} }")
    total = sum(c.shape[0] for c in calls[names[0]])
    differ = {f"{a}/{b}": sum(int((x != y).any(dim=1).sum())
                              for x, y in zip(calls[a], calls[b]))
              for a, b in itertools.combinations(names, 2)}
    skip = set()
    for row, where in routes[names[0]][1]:
        for c, t in where:
            if any(not torch.equal(calls[n][c][t], calls[names[0]][c][t]) for n in names):
                skip.add(row)
    return dict(tokens_x_layers=total, differ=differ), frozenset(skip)


def moe_gate(cfg, runs, routes, fault: bool):
    """Phase 6b's gate on the logits rows whose token all three runs route
    alike at every layer.  A near-tied k-th expert can flip between bf16
    and fp32 roundings; a flipped expert moves that token's output by a
    whole expert's share, so such a row is not a reading of rounding and
    is left out, counted and printed.  (An earlier token's flip reaches a
    later one only through deepseek-v2's second layer's attention, diluted
    over the prompt.)  The gate fails if it reads under MOE_MIN_READ of
    the rows, or no prefill row."""
    disagree, skip = route_disagreements(routes)
    n_rows = sum(len(r) for r in runs["ref32"].values())
    read = n_rows - len(skip)
    print(f"  {cfg.name} routings: {disagree['tokens_x_layers']} (token, layer) pairs; "
          f"runs disagree on {disagree['differ']}; the gate reads {read} of {n_rows} logits "
          f"rows (left out: {sorted(skip)})", flush=True)
    if read < MOE_MIN_READ * n_rows or all((uid, 0) in skip for uid in runs["ref32"]):
        fail(f"{cfg.name}: the gate reads {read} of {n_rows} rows")
    out = dict(routings=disagree, rows=n_rows, rows_read=read, rows_left_out=sorted(skip),
               gate=lm_gate(f"{cfg.name} kernel path", runs, skip=skip))
    if fault:
        f_dis, _ = route_disagreements(routes, ("got", "fault"))
        out["planted_fault"] = lm_gate(
            f"{cfg.name} planted fault: B7 reads expert e+1's weights for expert e", runs,
            fault=True, skip=skip, run="fault")
        out["planted_fault"]["routings"] = f_dis
    return out


@contextlib.contextmanager
def gmm_replaced(make):
    """The gmm wrapper that ``moe_ffn`` calls (through ``dispatch.gmm``)
    replaced by ``make(wrapper)`` for the scope."""
    from repro_torch.kernels import gmm as gm
    orig = gm.gmm
    gm.gmm = make(orig)
    try:
        yield
    finally:
        gm.gmm = orig


def gmm_expert_shifted():
    """The planted B7 fault: expert e multiplied by expert e+1's weights
    (the last expert by its own), two launches of the kernel a call."""
    import torch
    return gmm_replaced(lambda gmm: lambda x, w: torch.cat([gmm(x[:-1], w[1:]),
                                                           gmm(x[-1:], w[-1:])]))


def captured_gmm(store: list):
    """Append (x, w) of every gmm call to ``store``."""
    return gmm_replaced(lambda gmm: lambda x, w: (store.append((x, w)), gmm(x, w))[1])


def moe_timings(cfg, params, dev):
    """Prefill ms at MOE_PREFILL tokens, a decode step at MOE_SLOTS slots
    (position MOE_DECODE_POS), each beside its bound, one profile of each;
    and the gmm inputs of both calls' first layer, for the kernel check."""
    import torch
    from repro_torch.models import transformer as TT
    g = torch.Generator(device=dev).manual_seed(2)
    batch = dict(tokens=torch.randint(0, cfg.vocab, (1, MOE_PREFILL), generator=g, device=dev))
    cache = TT.init_cache(cfg, MOE_SLOTS, MOE_DECODE_POS + 8, dev)
    cache["len"] = MOE_DECODE_POS
    toks = torch.randint(0, cfg.vocab, (MOE_SLOTS, 1), generator=g, device=dev)
    prefill = lambda: TT.prefill(params, batch, cfg, backend="cuda")
    decode = lambda: TT.decode_step(params, cache, toks, cfg, backend="cuda")
    (p_bound, p_by), (d_bound, d_by) = moe_bounds(cfg, MOE_PREFILL, MOE_SLOTS,
                                                  MOE_DECODE_POS + 1)
    p_ms = time_ms(prefill, iters=3, reps=3)
    d_ms = time_ms(decode, iters=5, reps=3)
    out = dict(prefill=dict(s=MOE_PREFILL, ms=p_ms, bound_ms=p_bound, bound_by=p_by,
                            tokens_per_s=MOE_PREFILL * 1e3 / p_ms),
               decode=dict(slots=MOE_SLOTS, pos=MOE_DECODE_POS, ms=d_ms, bound_ms=d_bound,
                           bound_by=d_by, tokens_per_s=MOE_SLOTS * 1e3 / d_ms))
    print(f"  {cfg.name} prefill S{MOE_PREFILL}: {p_ms:.3f} ms (bound {p_bound:.3f} ms, "
          f"{p_by}); decode step at {MOE_SLOTS} slots, position {MOE_DECODE_POS}: {d_ms:.3f} "
          f"ms, {MOE_SLOTS * 1e3 / d_ms:.1f} tokens/s (bound {d_bound:.3f} ms, {d_by})",
          flush=True)
    out["trace_prefill"] = trace_lm(prefill, p_ms, f"{cfg.name} prefill S{MOE_PREFILL}",
                                    categories=MOE_CATEGORIES, kernel="B7 gmm")
    out["trace_decode"] = trace_lm(decode, d_ms, f"{cfg.name} decode at {MOE_SLOTS} slots",
                                   categories=MOE_CATEGORIES, kernel="B7 gmm")
    inputs = []
    with captured_gmm(inputs):
        prefill()
        n = len(inputs)
        decode()
    torch.cuda.synchronize(dev)
    # the first layer's gate and down projections of each call
    return out, dict(prefill_gate=inputs[0], prefill_down=inputs[2], decode_gate=inputs[n])


def moe_gmm_cases(name, inputs):
    """B7 at the path's shapes, the inputs the path gave it (weights are the
    model's), as :func:`check_kernels` takes them: against its plain
    version, timed beside ``torch.bmm`` in turns and beside the bytes
    bound."""
    import torch
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import ops
    cases = []
    for label, (x, w) in inputs.items():
        e, c, d = x.shape
        f = w.shape[2]
        cases.append(dict(
            label=f"{name} {label} E{e} C{c} D{d} F{f}", fn=ops.gmm, plain=gm.gmm_plain,
            lib=torch.bmm, route=gm.gmm_route(x, w), args=(x, w),
            tol=OPS_TOL["gmm"]["bfloat16"], main=True, iters=(3, 3),
            bytes=x.element_size() * (e * c * d + e * d * f + e * c * f),
            flops=2.0 * e * c * d * f, peak=BF16_FLOPS))
    return cases


def run_moe_serve(dev, launches):
    """Phase 6c: LM decode serving of kimi-k2 (GQA + MoE, one layer) and
    deepseek-v2 (MLA + MoE, two layers) at full width on random bf16
    weights drawn on the card, through ``ServeEngine`` at MOE_SLOTS slots."""
    import torch
    t_phase = time.perf_counter()
    out = dict(kind="lm_serve_moe")
    for arch, layers in MOE_MODELS:
        cfg, params = moe_model(arch, layers, dev)
        key = arch.split("-")[0]
        resident = torch.cuda.memory_allocated(dev)
        mark(f"6c: {cfg.name} drawn ({layers} layer(s), {resident} B resident)")
        for backend in ("cuda", "ref"):     # cuBLAS handles, allocator
            lm_engine(cfg, params, backend, 1, 80).run_to_completion(
                lm_requests(cfg, (64,), 2, seed=1))
        reqs, counts, calls, wall, peak = moe_counted(cfg, params, dev)
        launches[f"lm_serve_{key}"] = counts
        n_tok = sum(len(r.out_tokens) for r in reqs)
        print(f"path lm_serve_{key}: {cfg.name} ({layers} of its layers, d_model "
              f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
              f"{cfg.attention.kind}), prompts {MOE_PROMPTS}, {n_tok} tokens in {wall:.3f} s "
              f"on {MOE_SLOTS} slots: {n_tok / wall:.1f} tokens/s; engine calls {calls}; "
              f"launches {counts}; peak memory {peak} B ({resident} B resident)", flush=True)
        mark(f"6c: {cfg.name} counted run done")
        runs, routes, run_peaks = moe_runs(cfg, params,
                                           fault=gmm_expert_shifted if key == "kimi" else None)
        gate = moe_gate(cfg, runs, routes, fault=key == "kimi")
        del runs, routes
        torch.cuda.empty_cache()
        timings, inputs = moe_timings(cfg, params, dev)
        mark(f"6c: {cfg.name} gate and timings done")
        spec = [dict(name="gmm", source="src/repro_torch/kernels/csrc/gmm.cu",
                     replaces="src/repro/kernels/gmm.py:37", symbol="gmm_wgmma_kernel",
                     cases=moe_gmm_cases(key, inputs))]
        row = check_kernels(spec)["gmm"]
        if any(t["route"] != "wgmma" for t in row["cases"]):
            fail(f"{cfg.name}: B7 at the path's shapes took routes {row['routes']}")
        out[key] = dict(layers=layers, requests=len(reqs), tokens=n_tok, seconds=wall,
                        tokens_per_s=n_tok / wall, peak_bytes=peak, resident_bytes=resident,
                        launches=counts, engine_calls=calls, kernel=row, run_peaks=run_peaks,
                        **gate, **timings)
        mark(f"6c: {cfg.name} done")
        del params, inputs, spec, row
        torch.cuda.empty_cache()
    out["gmm_cases"] = [c for k in ("kimi", "deepseek") for c in out[k]["kernel"]["cases"]]
    out["gmm_max_abs_err"] = max(out[k]["kernel"]["max_abs_err"] for k in ("kimi", "deepseek"))
    defer(out, "launcher", run_moe_serve_launcher)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 6c: {out['seconds']:.1f} s", flush=True)
    return out


def run_moe_serve_launcher():
    """``python -m repro_torch.launch.serve --arch deepseek-v2-236b`` (its
    smoke config: MLA and MoE) on the card as a subprocess, which must exit
    0 and print its tokens/s line on ``device=cuda``."""
    return run_lm_serve_launcher(["--arch", "deepseek-v2-236b"])


# ---------------------------------------------------------------------------
# phase 6d: LM decode serving of the SSM and hybrid models
# ---------------------------------------------------------------------------

# (arch, slots, prompts, new tokens), each at full width and depth.
# mamba2-780m: four prompts of one length decode as one stacked cohort,
# then 1000 (a ragged last chunk: the zero-padded tail) and 2048 slot by
# slot; zamba2-7b (5.62 G params, 22.5 GB in fp32 and 11 GB of bf16 compute
# copies): a stacked pair, then 512 and 2048
# (arch, slots, prompts, new tokens, layers): mamba2-780m decodes 8 new
# tokens a request (16 before phase 5h) at 24 of its 48 layers (48 before
# phase 6f), zamba2-7b serves 28 of its 81 layers (24 mamba, 4 shared
# sites; all 81 before phase 5h, 42 before phase 6f)
SSM_SERVE = (("mamba2-780m", 4, (1024, 1024, 1024, 1024, 1000, 2048), 8, 24),
             ("zamba2-7b", 2, (1024, 1024, 512, 2048), 8, 28))
SSM_PREFILL_LENGTHS = (1024, 2048)
SSM_DECODE_POS = 1024
SSM_CATEGORIES = (("B6 backward", ("ssd_bwd",)),
                  ("B6 ssd_chunk", ("ssd_wgmma", "ssd_chunk_kernel"))) + LM_CATEGORIES


def hybrid_flash_route(cfg, dev) -> str:
    """The route ``flash_route`` picks for the shared block's attention (bf16
    q, k, v of the config's heads; zamba2-7b's head dim 112 takes "wgmma",
    the 128-wide kernel on zero-filled columns)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_route
    a = cfg.attention
    t = torch.empty((1, 8, a.n_heads, a.head_dim), dtype=torch.bfloat16, device=dev)
    return flash_route(t, t, t)


def ssm_want(cfg, dev, passes: int = 1, recompute: bool = False):
    """The launches of ``passes`` full-sequence forwards (a prefill, or a
    training forward): B6 on "wgmma" once a mamba layer, B5 on "wgmma" once
    a shared site (the run fails if ``flash_route`` would send the shared
    block's attention elsewhere); with ``recompute``, those of the
    checkpoints' recompute, which runs the mamba blocks only."""
    nm, sites, _ = ssm_shape(cfg)
    n = passes * nm
    want = {"ssd_chunk": n, "ssd_chunk/wgmma": n}
    if sites and not recompute:
        route = hybrid_flash_route(cfg, dev)
        if route != "wgmma":
            fail(f"{cfg.name}: B5 at head dim {cfg.attention.head_dim} routes to {route}, "
                 f"not wgmma")
        want |= {"flash_attention": passes * sites, "flash_attention/wgmma": passes * sites}
    return want


def launches_by_call(engine, record: list):
    """``engine`` with its model API's ``prefill`` and ``decode_step``
    appending (name, the kernel launches of that call) to ``record``."""
    import dataclasses
    from repro_torch.kernels import _build
    api = engine.api

    def counted(name, fn):
        def call(*a, **kw):
            before = _build.launches.snapshot()
            out = fn(*a, **kw)
            after = _build.launches.snapshot()
            record.append((name, {k: n - before.get(k, 0) for k, n in after.items()
                                  if n - before.get(k, 0)}))
            return out
        return call

    engine.api = dataclasses.replace(api, prefill=counted("prefill", api.prefill),
                                     decode_step=counted("decode_step", api.decode_step))
    return engine


def engine_calls(record) -> dict:
    """The number of ``prefill`` and ``decode_step`` calls in a
    :func:`launches_by_call` record."""
    return {n: sum(1 for c, _ in record if c == n) for n in ("prefill", "decode_step")}


def engine_counted(cfg, params16, reqs, slots, max_seq, dev, want, passes=None):
    """One engine run on the kernels with the launch counts set to 0 just
    before and read just after, each model call's launches recorded: every
    ``prefill`` must have launched ``want``, no ``decode_step`` anything,
    and nothing else; with ``passes``, B5's launches, each as
    :func:`causal_and_length` reads it, must be ``passes`` in order.
    Returns (counts, calls, wall s, peak B)."""
    import torch
    from repro_torch.kernels import _build
    record, flash = [], []
    eng = launches_by_call(lm_engine(cfg, params16, "cuda", slots, max_seq), record)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.launches.reset()
    t0 = time.perf_counter()
    with recorded_flash(flash, causal_and_length):
        eng.run_to_completion(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _build.launches.snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    calls = engine_calls(record)
    bad = [(c, got) for c, got in record if got != (want if c == "prefill" else {})]
    total = {k: n * len(reqs) for k, n in want.items()}
    if bad or calls["prefill"] != len(reqs) or counts != total or \
            (passes is not None and flash != passes):
        fail(f"{cfg.name}: launches {counts} over engine calls {calls}; want {want} a "
             f"prefill and none a decode step ({len(bad)} calls differ, first "
             f"{bad[:2]}; B5's (causal, S) {flash[:14]}..., want {(passes or [])[:14]}...)")
    for r in reqs:
        if not r.done or len(r.out_tokens) != r.max_new_tokens or \
                not all(0 <= t < cfg.vocab for t in r.out_tokens):
            fail(f"{cfg.name} request {r.uid}: done={r.done}, tokens {r.out_tokens}")
    return counts, calls, wall, peak


def ssm_timings(cfg, params16, slots: int, dev):
    """Prefill ms at SSM_PREFILL_LENGTHS on the kernels and on ``ref`` in
    turns, a decode step at ``slots`` slots beside their bounds, and one
    profiled prefill (at the first length) and decode step: B6's share of
    the device time and the idle share."""
    import torch
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    out = dict(prefill={})
    for n in SSM_PREFILL_LENGTHS:
        batch = dict(tokens=torch.randint(0, cfg.vocab, (1, n), generator=g, device=dev))
        k_ms, r_ms = time_pair_ms(lambda: api.prefill(params16, batch, cfg, backend="cuda"),
                                  lambda: api.prefill(params16, batch, cfg, backend="ref"),
                                  iters=2, reps=3)
        (b_ms, b_by), _ = ssm_bounds(cfg, n, 1, n)
        out["prefill"][n] = dict(ms=k_ms, ref_ms=r_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"  {cfg.name} prefill S{n}: {k_ms:.3f} ms on the kernels, {r_ms:.3f} ms on ref; "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    cache = api.init_cache(cfg, slots, SSM_DECODE_POS + 8, dev)
    cache["len"] = SSM_DECODE_POS
    toks = torch.zeros((slots, 1), dtype=torch.long, device=dev)
    # the cache is written in place at position len: each call rewrites the same one
    ms = time_ms(lambda: api.decode_step(params16, dict(cache), toks, cfg), iters=5, reps=3)
    _, (b_ms, b_by) = ssm_bounds(cfg, 1, slots, SSM_DECODE_POS + 1)
    out["decode"] = dict(slots=slots, ms=ms, tokens_per_s=slots * 1e3 / ms, bound_ms=b_ms,
                         bound_by=b_by, pos=SSM_DECODE_POS)
    print(f"  {cfg.name} decode step at {slots} slots, position {SSM_DECODE_POS}: {ms:.3f} ms "
          f"({slots * 1e3 / ms:.1f} tokens/s); bound {b_ms:.4f} ms ({b_by})", flush=True)
    n = SSM_PREFILL_LENGTHS[0]
    batch = dict(tokens=torch.randint(0, cfg.vocab, (1, n), generator=g, device=dev))
    out["trace_prefill"] = trace_lm(lambda: api.prefill(params16, batch, cfg, backend="cuda"),
                                    out["prefill"][n]["ms"], f"{cfg.name} prefill S{n}",
                                    categories=SSM_CATEGORIES, kernel="B6 ssd_chunk")
    out["trace_decode"] = trace_lm(lambda: api.decode_step(params16, dict(cache), toks, cfg),
                                   ms, f"{cfg.name} decode step at {slots} slots",
                                   categories=SSM_CATEGORIES, kernel="B6 ssd_chunk")
    return out


@contextlib.contextmanager
def ssd_states_gap():
    """The planted fault: B6's chunk states of every other chunk (every
    other G) zeroed in each of its outputs, phase 6's planted fault on the
    model's path."""
    from repro_torch.kernels import ssd_scan
    orig = ssd_scan.ssd_chunk

    def gap(*args):
        y, st, cd, sd = orig(*args)
        st[::2] = 0
        return y, st, cd, sd

    ssd_scan.ssd_chunk = gap
    try:
        yield
    finally:
        ssd_scan.ssd_chunk = orig


def ssd_chunk_fp64(x, dt, A, B, C):
    """``ssd_chunk_plain``'s arithmetic in fp64, the outputs cast to fp32:
    the oracle of the path-shape cases."""
    import torch
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    dA_cum = torch.cumsum(dt * A[:, None], dim=1)                  # (G, Q)
    pos = torch.arange(x.shape[1], device=x.device)
    mask = pos[:, None] >= pos[None, :]
    seg = dA_cum[:, :, None] - dA_cum[:, None, :]
    L = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    y = torch.einsum("gls,gs,gsp->glp", torch.einsum("gln,gsn->gls", C, B) * L, dt, x)
    st = torch.einsum("gqn,gq,gqp->gpn", B, torch.exp(dA_cum[:, -1:] - dA_cum) * dt, x)
    return tuple(t.float() for t in (y, st, torch.exp(dA_cum[:, -1]), torch.exp(dA_cum)))


def fp64_held(case):
    """A B6 case held against :func:`ssd_chunk_fp64` at LM_GATE times the
    fp32 plain version's own per-row error against it (at least the
    case's tolerance).  At Q 256 the plain version's y rows are 1.7e-4
    to 7.7e-4 from fp64 on Mamba-2's initialisation ranges (exp of a
    difference of two fp32 cumsums of up to 400 in magnitude, then a sum
    that cancels), so a per-row tolerance of 1e-4 against it reads which
    of two fp32 orders a row's draws favour."""
    want = ssd_chunk_fp64(*case["args"])
    own = max(row_err(a, b) for a, b in zip(case["plain"](*case["args"]), want))
    return case | dict(oracle=lambda *a: want, tol=max(case["tol"], LM_GATE * own),
                       plain_row_err_vs_fp64=own)


def ssm_path_specs(dev, shapes, flash_shapes):
    """B6 at the path's shapes (``shapes``: (label, G, P, N); Q 256, fp32
    operands as the models give them; held against fp64,
    :func:`fp64_held`) and B5 at zamba2's (``flash_shapes``: (label, B,
    S); 32 heads of 112, causal, bf16, beside SDPA), as
    :func:`check_kernels` takes them."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    src = "src/repro_torch/kernels/csrc/"
    specs = [dict(name="ssd_chunk", source=src + "ssd_scan.cu",
                  replaces="src/repro/kernels/ssd_scan.py:56", symbol="ssd_wgmma",
                  cases=[fp64_held(ssd_case(g, dev, label, gg, 256, p, n, main=True))
                         for label, gg, p, n in shapes])]
    if flash_shapes:
        specs.append(dict(
            name="flash_attention", source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:89",
            symbol="flash_attention_wgmma_kernel",
            cases=[flash_case(randn, label, b, s, 32, 32, 112, torch.bfloat16, main=True,
                              lib=True, iters=(5, 3), causal=True)
                   for label, b, s in flash_shapes]))
    return specs


def ssm_state_err(got, want) -> float:
    """The largest over prefills and layers of a layer's SSM state error:
    max|got - want| over that layer's states over their max|want|."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.float().flatten(1), w.float().flatten(1)
        err = (g - w).abs().amax(1) / w.abs().amax(1).clamp_min(1e-30)
        worst = max(worst, float(err.max()))
    return worst


def ssm_serve_one(arch, slots, prompts, max_new, layers, dev, launches, fault: bool):
    """One model of phase 6d at ``layers`` layers: the counted engine run,
    the gate (and the planted B6 fault, with ``fault``), the timings."""
    import dataclasses
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_api
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = get_api(cfg).init(torch.Generator(device=dev).manual_seed(0), cfg)
    p16 = get_api(cfg).compute_params(params, cfg)
    nm, sites, h = ssm_shape(cfg)
    max_seq = max(prompts) + max_new + 8
    reqs = lambda: lm_requests(cfg, prompts, max_new, seed=0)  # noqa: E731
    for backend in ("cuda", "ref"):         # cuBLAS handles, allocator
        lm_engine(cfg, p16, backend, 1, 128).run_to_completion(
            lm_requests(cfg, (64,), 2, seed=1))
    served = reqs()
    counts, calls, wall, peak = engine_counted(cfg, p16, served, slots, max_seq, dev,
                                               ssm_want(cfg, dev))
    key = f"lm_serve_{arch.split('-')[0]}"
    launches[key] = counts
    n_tok = sum(len(r.out_tokens) for r in served)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"path {key}: {cfg.name} ({cfg.n_layers} layers: {nm} mamba, {sites} shared sites; "
          f"d_model {cfg.d_model}, {h} SSD heads, {n_params} params), {len(served)} requests "
          f"(prompts {prompts}), {n_tok} tokens in {wall:.3f} s on {slots} slots: "
          f"{n_tok / wall:.1f} tokens/s, peak memory {peak} B, engine calls {calls}, "
          f"launches {counts}", flush=True)
    runs = lm_runs(cfg, params, p16, reqs, slots, max_seq,
                   fault=ssd_states_gap if fault else None, states=True)
    out = dict(arch=cfg.name, layers=cfg.n_layers, mamba_layers=nm, sites=sites,
               params=n_params, requests=len(served), tokens=n_tok, seconds=wall,
               tokens_per_s=n_tok / wall, peak_bytes=peak, launches=counts, calls=calls,
               gate=lm_gate(f"{cfg.name} kernel path", runs, states=True))
    if fault:
        out["planted_fault"] = lm_gate(
            f"{cfg.name} planted fault: B6's states of every other chunk zeroed", runs,
            fault=True, run="fault", states=True)
    del runs
    mark(f"6d: {cfg.name} gate done")
    out.update(ssm_timings(cfg, p16, slots, dev))
    mark(f"6d: {cfg.name} timings done")
    del params, p16
    torch.cuda.empty_cache()
    return out


def run_ssm_serve(dev, launches):
    """Phase 6d: LM decode serving of mamba2-780m and zamba2-7b at full
    width, at SSM_SERVE's depths (random weights drawn on the card from seed 0, bf16
    compute) through ``ServeEngine``; B6 and B5 at the path's shapes; the
    launchers as subprocesses."""
    import torch
    t_phase = time.perf_counter()
    out = dict(kind="lm_serve_ssm")
    for (arch, slots, prompts, max_new, layers), fault in zip(SSM_SERVE, (True, False)):
        out[arch] = ssm_serve_one(arch, slots, prompts, max_new, layers, dev, launches, fault)
    specs = ssm_path_specs(dev, [
        (f"mamba2-780m prefill S{n} G{n // 256 * 48} Q256 P64 N128 fp32", n // 256 * 48, 64, 128)
        for n in SSM_PREFILL_LENGTHS] + [
        (f"zamba2-7b prefill S{n} G{n // 256 * 112} Q256 P64 N64 fp32", n // 256 * 112, 64, 64)
        for n in SSM_PREFILL_LENGTHS],
        [(f"zamba2-7b prefill B1 S{n} Hq32 Hkv32 D112 causal", 1, n)
         for n in SSM_PREFILL_LENGTHS])
    rows = check_kernels(specs)
    if any(r != "wgmma" for r in rows["ssd_chunk"]["routes"]):
        fail(f"B6 at the SSM path's shapes took routes {rows['ssd_chunk']['routes']}")
    if any(r != "wgmma" for r in rows["flash_attention"]["routes"]):
        fail(f"B5 at zamba2's prefill shapes took routes {rows['flash_attention']['routes']}")
    out["ssd_kernel"], out["flash_kernel"] = rows["ssd_chunk"], rows["flash_attention"]
    for arch in ("mamba2-780m", "zamba2-7b"):
        defer(out, f"launcher_{arch}", run_lm_serve_launcher, ["--arch", arch])
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 6d: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6e: whisper, the encoder-decoder, served and trained
# ---------------------------------------------------------------------------

WHISPER_SLOTS = 4
# wave 1: four prompts of one length decode as one stacked cohort; wave 2:
# ragged lengths, which decode slot by slot
WHISPER_PROMPTS = (64, 64, 64, 64, 32, 128)
WHISPER_MAX_NEW = 32
WHISPER_PREFILL_LENGTHS = (64, 128)
WHISPER_DECODE_POS = 96
WHISPER_TRAIN_BATCH = 8
WHISPER_TRAIN_SEQ = 448             # whisper's text context


def whisper_frames(cfg, b: int, seed: int, dev):
    """(b, n_frontend_tokens, d_model) standard normal frame embeddings
    drawn on the card from ``seed``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=g, device=dev)


def causal_and_length(q, kw):
    """What :func:`recorded_flash` keeps of a launch for whisper: (causal,
    S)."""
    return kw.get("causal", True), q.shape[1]


def whisper_pass(cfg, s: int):
    """The (causal, S) of each B5 launch of one forward: every encoder layer
    bidirectional over the frames, then every decoder layer causal over the
    ``s`` tokens."""
    return [(False, cfg.n_frontend_tokens)] * cfg.n_encoder_layers + [(True, s)] * cfg.n_layers


def whisper_gate_batches(cfg, dev):
    """The serving traffic's prompts as the gate drives them, each run of
    equal lengths as one batch, each batch on seeded random frames:
    [(uids, tokens (b, s), frames (b, S_enc, d_model))]."""
    import torch
    reqs = lm_requests(cfg, WHISPER_PROMPTS, WHISPER_MAX_NEW, seed=0)
    out = []
    for _, group in itertools.groupby(reqs, key=lambda r: len(r.prompt)):
        group = list(group)
        toks = torch.tensor([r.prompt.tolist() for r in group], dtype=torch.long, device=dev)
        out.append(([r.uid for r in group], toks,
                    whisper_frames(cfg, len(group), 10 + group[0].uid, dev)))
    return out


def whisper_drive(cfg, params, backend, batches, forced=None):
    """Each batch of :func:`whisper_gate_batches` through ``api.prefill`` on
    ``backend``, spliced into a cache, then ``api.decode_step`` to
    WHISPER_MAX_NEW tokens: teacher-forced on ``forced`` (uid -> tokens),
    else greedy.  Returns (logits rows by uid over the true vocab, tokens
    by uid, [each prefill's cross k, then cross v, fp32])."""
    import torch
    from repro_torch.models.registry import get_api
    from repro_torch.serve.engine import _splice_cache
    api = get_api(cfg)
    rows, tokens, states = {}, {}, []
    with torch.no_grad():
        for uids, toks, frames in batches:
            b, s = toks.shape
            logits, pre = api.prefill(params, dict(tokens=toks, frontend_embeds=frames), cfg,
                                      backend=backend)
            states += [pre["cross_k"].float(), pre["cross_v"].float()]
            cache = _splice_cache(api.init_cache(cfg, b, s + WHISPER_MAX_NEW, toks.device),
                                  pre)
            for j in range(WHISPER_MAX_NEW):
                nxt = (torch.tensor([forced[u][j] for u in uids], device=toks.device)
                       if forced else logits[:, :cfg.vocab].argmax(-1))
                for r, u in enumerate(uids):
                    rows.setdefault(u, []).append(logits[r, :cfg.vocab].float())
                    tokens.setdefault(u, []).append(int(nxt[r]))
                if j + 1 < WHISPER_MAX_NEW:
                    logits, cache = api.decode_step(params, cache, nxt[:, None], cfg,
                                                    backend=backend)
    return rows, tokens, states


@contextlib.contextmanager
def encoder_b5_causal():
    """The planted serving fault: B5 launched causal where the encoder asks
    for bidirectional attention."""
    from repro_torch.kernels import flash_attention as fa
    orig = fa.flash_attention_gqa
    fa.flash_attention_gqa = lambda q, k, v, **kw: orig(q, k, v, **{**kw, "causal": True})
    try:
        yield
    finally:
        fa.flash_attention_gqa = orig


def whisper_serve_gate(cfg, params, p16, dev):
    """Phase 6b's gate, with the API driven directly on seeded random
    frames (the engine's zero frames make every encoder state exactly 0,
    which would hide any fault of the encoder): ``ref`` in bf16 (greedy;
    its tokens forced on the others), the kernel path, ``ref`` in fp32
    compute and the kernel path with the encoder's B5 run causal, held on
    the logits and on each layer's cross k and v."""
    import dataclasses
    batches = whisper_gate_batches(cfg, dev)
    runs = {"states": {}}
    runs["ref16"], forced, runs["states"]["ref16"] = whisper_drive(cfg, p16, "ref", batches)
    runs["got"], _, runs["states"]["got"] = whisper_drive(cfg, p16, "cuda", batches, forced)
    runs["ref32"], _, runs["states"]["ref32"] = whisper_drive(
        dataclasses.replace(cfg, compute_dtype="float32"), params, "ref", batches, forced)
    with encoder_b5_causal():
        runs["fault"], _, runs["states"]["fault"] = whisper_drive(cfg, p16, "cuda", batches,
                                                                  forced)
    kw = dict(states=True, states_name="prefill cross k and v")
    out = dict(frames="random normal, seeded", batches=[len(u) for u, _, _ in batches],
               gate=lm_gate(f"{cfg.name} kernel path", runs, **kw),
               planted_fault=lm_gate(f"{cfg.name} planted fault: the encoder's B5 causal",
                                     runs, fault=True, run="fault", **kw))
    cross = max(float(t.abs().max()) for t in runs["states"]["got"])
    print(f"  {cfg.name} gate: max|cross k, v| {cross:.3f} on random frames", flush=True)
    if not cross > 0:
        fail(f"{cfg.name}: the cross k and v are 0 on random frames")
    return out


def whisper_timings(cfg, p16, dev):
    """Prefill ms by prompt length (random frames) on the kernels and on
    ``ref`` in turns, the first-token latency (``add_request``: prefill on
    zero frames, splice, first sample), a decode step at WHISPER_SLOTS
    slots, each beside its bound, and one profiled prefill and decode
    step (B5's share, idle share)."""
    import torch
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    out = dict(prefill={})
    batches = {}
    for n in WHISPER_PREFILL_LENGTHS:
        batch = batches[n] = dict(
            tokens=torch.randint(0, cfg.vocab, (1, n), generator=g, device=dev),
            frontend_embeds=whisper_frames(cfg, 1, 20 + n, dev))
        k_ms, r_ms = time_pair_ms(lambda: api.prefill(p16, batch, cfg, backend="cuda"),
                                  lambda: api.prefill(p16, batch, cfg, backend="ref"),
                                  iters=5, reps=3)
        eng = lm_engine(cfg, p16, "cuda", 1, n + 8)
        ftl = []
        for r in lm_requests(cfg, (n,) * 3, 1, seed=4):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            eng.add_request(r)            # a budget of 1: the slot frees at once
            ftl.append((time.perf_counter() - t0) * 1e3)
        (b_ms, b_by), _ = whisper_bounds(cfg, n, 1, n)
        out["prefill"][n] = dict(ms=k_ms, ref_ms=r_ms, first_token_ms=statistics.median(ftl),
                                 bound_ms=b_ms, bound_by=b_by)
        print(f"  {cfg.name} prefill S{n} (and {cfg.n_frontend_tokens} frames): {k_ms:.3f} ms "
              f"on the kernels, {r_ms:.3f} ms on ref, first token "
              f"{statistics.median(ftl):.3f} ms; bound {b_ms:.4f} ms ({b_by})", flush=True)
    b = WHISPER_SLOTS
    cache = api.init_cache(cfg, b, WHISPER_DECODE_POS + 8, dev)
    cache["len"] = WHISPER_DECODE_POS
    toks = torch.zeros((b, 1), dtype=torch.long, device=dev)
    # the cache is written in place at position len: each call rewrites the same one
    ms = time_ms(lambda: api.decode_step(p16, dict(cache), toks, cfg), iters=10, reps=3)
    _, (b_ms, b_by) = whisper_bounds(cfg, 1, b, WHISPER_DECODE_POS + 1)
    out["decode"] = dict(slots=b, ms=ms, tokens_per_s=b * 1e3 / ms, bound_ms=b_ms,
                         bound_by=b_by, pos=WHISPER_DECODE_POS)
    print(f"  {cfg.name} decode step at {b} slots, position {WHISPER_DECODE_POS}: {ms:.3f} ms "
          f"({b * 1e3 / ms:.1f} tokens/s); bound {b_ms:.4f} ms ({b_by})", flush=True)
    n = WHISPER_PREFILL_LENGTHS[0]
    out["trace_prefill"] = trace_lm(lambda: api.prefill(p16, batches[n], cfg, backend="cuda"),
                                    out["prefill"][n]["ms"], f"{cfg.name} prefill S{n}")
    out["trace_decode"] = trace_lm(lambda: api.decode_step(p16, dict(cache), toks, cfg), ms,
                                   f"{cfg.name} decode step at {b} slots")
    return out


def whisper_serve(cfg, dev, launches):
    """The serving half of phase 6e: the counted engine run, the gate on
    random frames and its planted fault, the timings."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.models import whisper as TW
    params = TW.init_whisper(torch.Generator(device=dev).manual_seed(0), cfg)
    p16 = TW.compute_params(params, cfg)
    for backend in ("cuda", "ref"):         # cuBLAS handles, allocator
        lm_engine(cfg, p16, backend, 1, 64).run_to_completion(
            lm_requests(cfg, (16,), 2, seed=1))
    reqs = lm_requests(cfg, WHISPER_PROMPTS, WHISPER_MAX_NEW, seed=0)
    n = cfg.n_encoder_layers + cfg.n_layers
    counts, calls, wall, peak = engine_counted(
        cfg, p16, reqs, WHISPER_SLOTS, max(WHISPER_PROMPTS) + WHISPER_MAX_NEW + 8, dev,
        {"flash_attention": n, "flash_attention/wgmma": n},
        [c for r in reqs for c in whisper_pass(cfg, len(r.prompt))])
    launches["lm_serve_whisper"] = counts
    n_tok = sum(len(r.out_tokens) for r in reqs)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"path lm_serve_whisper: {cfg.name} ({cfg.n_encoder_layers} + {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_frontend_tokens} frames, {n_params} params), "
          f"{len(reqs)} requests (prompts {WHISPER_PROMPTS}, zero frames as the engine feeds "
          f"them), {n_tok} tokens in {wall:.3f} s on {WHISPER_SLOTS} slots: "
          f"{n_tok / wall:.1f} tokens/s, peak memory {peak} B, engine calls {calls}, "
          f"launches {counts}", flush=True)
    out = dict(arch=cfg.name, params=n_params, requests=len(reqs), tokens=n_tok,
               seconds=wall, tokens_per_s=n_tok / wall, peak_bytes=peak, launches=counts,
               calls=calls, **whisper_serve_gate(cfg, params, p16, dev))
    mark("6e: whisper-base serving gate done")
    out.update(whisper_timings(cfg, p16, dev))
    del params, p16
    torch.cuda.empty_cache()
    return out


def whisper_train_batch(cfg, step: int, dev):
    """The token pipeline's batch of ``step`` (vocab, WHISPER_TRAIN_SEQ
    tokens, WHISPER_TRAIN_BATCH sequences, branching 4, seed 0) on ``dev``,
    with random frames drawn on the card from seed 1000 + ``step``."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig, batch_to_device
    b = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=WHISPER_TRAIN_SEQ,
                                          global_batch=WHISPER_TRAIN_BATCH, branching=4,
                                          seed=0)).batch_at(step)
    batch = batch_to_device(b, dev)
    batch["frontend_embeds"] = whisper_frames(cfg, WHISPER_TRAIN_BATCH, 1000 + step, dev)
    return batch


def whisper_grads(cfg, params, batch, backend):
    """:func:`pretrain_grads` with each B5 launch's (causal, S) recorded,
    forward and backward, under ``flash``."""
    calls = []
    with recorded_flash(calls, causal_and_length):
        r = pretrain_grads(cfg, params, batch, backend)
    n = len(r[3]["windows"][0])
    r[3]["flash"] = (calls[:n], calls[n:])
    return r


def check_whisper_step(label, cfg, r):
    """Fail unless one step launched B5 on "wgmma" once a layer of each
    stack in the forward (the encoder's bidirectional over the frames, the
    decoder's causal over the tokens) and once a layer in the checkpoints'
    recompute (the decoder's blocks first), its backward kernel on "wgmma"
    once a layer, and nothing else."""
    n = cfg.n_encoder_layers + cfg.n_layers
    want = {"flash_attention": n, "flash_attention/wgmma": n}
    got = {part: r[part] for part in ("forward", "backward")}
    passes = whisper_pass(cfg, WHISPER_TRAIN_SEQ)
    if got != dict(forward=want, backward=want | b5_bwd_want(n)) \
            or r["flash"] != (passes, passes[::-1]):
        fail(f"{label}: launches {got}, B5's (causal, S) {r['flash']}; want {want} in the "
             f"forward and in the backward, as {passes} and its reverse")


def b5_encoder_backward_causal():
    """(label, make): B5's backward kernel called with the causal mask on
    every call, the encoder's attention differentiated as causal (for
    :func:`planted_kernel`)."""
    def encoder_causal(kernel):
        return lambda *a, **kw: kernel(*a, **{**kw, "causal": True})

    return "B5 backward kernel: the encoder's attention masked causally", encoder_causal


def whisper_train_parity(cfg, dev):
    """One step's loss and gradient on the kernels, on ``ref`` in bf16 and on
    ``ref`` in fp32 compute, from the same params (drawn on the card from
    seed 0) and batch 0, through the gate read leaf by leaf; then the fault
    planted on B5's backward kernel, which the gate must flag."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.models.registry import get_api
    params = get_api(cfg).init(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = whisper_train_batch(cfg, 0, dev)
    ref32 = whisper_grads(dataclasses.replace(cfg, compute_dtype="float32"), params, batch,
                          "ref")
    ref16 = whisper_grads(cfg, params, batch, "ref")
    ref16_errs = lm_grad_errs(ref16, ref32, PRETRAIN_GATE_PREFIXES)
    ref16_loss = ref16[0]
    del ref16
    got = whisper_grads(cfg, params, batch, "cuda")
    check_whisper_step(f"{cfg.name} step", cfg, got[3])
    print(f"train whisper {cfg.name}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, B "
          f"{WHISPER_TRAIN_BATCH} S {WHISPER_TRAIN_SEQ} and {cfg.n_frontend_tokens} random "
          f"frames, loss cuda {got[0]:.6g} ref {ref16_loss:.6g} fp32 {ref32[0]:.6g}; "
          f"launches forward {got[3]['forward']}, backward {got[3]['backward']}", flush=True)
    out = dict(loss=got[0], ref16_loss=ref16_loss, ref32_loss=ref32[0],
               launches={k: got[3][k] for k in ("forward", "backward")},
               gate=pretrain_gate(f"{cfg.name} LM step", got, ref32, ref16_errs,
                                  per_leaf=True))
    del got
    label, make = b5_encoder_backward_causal()
    with planted_kernel(_fa, "flash_attention_gqa_bwd", make):
        bad = whisper_grads(cfg, params, batch, "cuda")
    out["planted_fault"] = dict(fault=label, **pretrain_gate(
        f"planted fault: {label}", bad, ref32, ref16_errs, fault=True, per_leaf=True))
    del bad, ref32, params
    torch.cuda.empty_cache()
    return out


def whisper_train_loop(cfg, dev):
    """:func:`pretrain_loop` on :func:`whisper_train_batch`, B5 once a layer
    of each stack in each step's forward and recompute, beside the step's
    bound: the forward's FLOPs three times (the recompute not counted) at
    the bf16 peak, the fp32 unembed at the fp32 rate."""
    n = PRETRAIN_STEPS * 2 * (cfg.n_encoder_layers + cfg.n_layers)
    b, s = WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ
    r = pretrain_loop(cfg, dev, s, want={"flash_attention": n, "flash_attention/wgmma": n}
                      | b5_bwd_want(n // 2),
                      label="train whisper", batch_at=lambda i: whisper_train_batch(cfg, i, dev),
                      batch_size=b)
    bound, bf16, f32 = whisper_train_bound(cfg, b, s)
    step_ms = statistics.median(r["step_ms"][1:])
    b5 = r["trace"]["categories"].get("B5 flash_attention", {}).get("device_ms", 0.0)
    r.update(bound=dict(ms=bound, bf16_flops=bf16, f32_flops=f32, share=bound / step_ms),
             b5_ms=b5, b5_share=b5 / max(r["trace"]["busy_ms"], 1e-9))
    print(f"train whisper bound: {bf16:.4g} bf16 FLOPs + {f32:.4g} f32 FLOPs = {bound:.2f} ms "
          f"a step; the loop's median step {step_ms:.2f} ms ({100 * bound / step_ms:.1f} % "
          f"of the bound's rate); B5 {b5:.2f} ms of a step's device time "
          f"({100 * r['b5_share']:.1f} %)", flush=True)
    return r


def whisper_kernel_specs(dev):
    """B5 at the path's shapes (8 heads of 64, bf16): the encoder's
    bidirectional attention over 1500 frames at a prefill's batch of 1 and
    at the training batch, the decoder's causal attention at the prompt
    lengths and the training length, each against its plain version and
    timed beside SDPA, as :func:`check_kernels` takes them."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(9)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    bf, se, bt = torch.bfloat16, 1500, WHISPER_TRAIN_BATCH
    case = lambda label, b, s, causal: flash_case(  # noqa: E731
        randn, f"whisper-base {label} B{b} S{s} Hq8 Hkv8 D64 "
               f"{'causal' if causal else 'non-causal'}", b, s, 8, 8, 64, bf, main=True,
        lib=True, iters=(20, 5), causal=causal)
    return [dict(name="flash_attention", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:89",
                 symbol="flash_attention_wgmma_kernel", cases=[
        case("encoder", 1, se, False), case("encoder train", bt, se, False),
        *(case("decoder prefill", 1, n, True) for n in sorted(set(WHISPER_PROMPTS))),
        case("decoder train", bt, WHISPER_TRAIN_SEQ, True)])]


def run_whisper_example():
    """``python -m repro_torch.examples.serve_lm --arch whisper-base`` (its
    smoke config) on the card as a subprocess, which must exit 0."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return run_chain([(["-m", "repro_torch.examples.serve_lm", "--arch", "whisper-base",
                            "--requests", "2"], "all requests complete")], tmp)


def run_whisper(dev, launches):
    """Phase 6e: whisper-base at full width and depth (random weights drawn
    on the card from seed 0, fp32 params, bf16 compute): served through
    ``ServeEngine`` and gated on random frames, trained through
    ``make_train_step``; B5 at the path's shapes; the serving launcher and
    example as subprocesses."""
    import torch
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    cfg = get_config("whisper-base")
    if (cfg.remat_policy, cfg.compute_dtype, cfg.param_dtype, cfg.opt_state_dtype,
            cfg.n_frontend_tokens) != ("nothing", "bfloat16", "float32", "float32", 1500):
        fail(f"{cfg.name}: expected remat 'nothing', bf16 compute, fp32 params and AdamW "
             f"state, 1500 frames")
    out = dict(kind="lm_whisper", arch=cfg.name)
    out["serve"] = whisper_serve(cfg, dev, launches)
    mark("6e: whisper-base serving done")
    out["train"] = dict(batch=WHISPER_TRAIN_BATCH, seq=WHISPER_TRAIN_SEQ,
                        parity=whisper_train_parity(cfg, dev))
    mark("6e: whisper-base training parity and planted fault done")
    out["train"]["loop"] = whisper_train_loop(cfg, dev)
    launches["lm_whisper_train"] = out["train"]["loop"]["launches"]
    mark("6e: whisper-base training loop done")
    rows = check_kernels(whisper_kernel_specs(dev))
    if any(r != "wgmma" for r in rows["flash_attention"]["routes"]):
        fail(f"B5 at whisper's shapes took routes {rows['flash_attention']['routes']}")
    out["flash_kernel"] = rows["flash_attention"]
    b5 = out["serve"]["trace_prefill"]
    print(f"phase 6e: B5 {b5['kernel_ms']:.3f} ms = {100 * b5['kernel_share']:.1f} % of a "
          f"prefill's device time", flush=True)
    torch.cuda.empty_cache()
    defer(out, "launcher", run_lm_serve_launcher, ["--arch", "whisper-base"])
    defer(out, "example", run_whisper_example)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 6e: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6f: LM prefill and decode over a (data 2, model 2) mesh of ranks
# ---------------------------------------------------------------------------

# (arch, layers, prompt, decode steps): full width, depth and steps cut for
# the run's time (a pass re-gathers every layer, and gloo moves about 1.6
# GB/s over the 4 ranks sharing the host: a deepseek-v2 decode step takes
# about 9.5 s, a gemma2-2b one 4.3 s at 2 layers and 6.5 s at 13, and the
# passes share the host with the deferred checks); gemma2-2b's 6 layers are
# 3 local and 3 global; B SERVE_MESH_ROWS rows, one a data rank; the planted
# fault's run decodes one step
SERVE_MESH_MODELS = (("gemma2-2b", 6, 4608, 4), ("deepseek-v2-236b", 1, 1024, 2),
                     ("mamba2-780m", 24, 2048, 4))
SERVE_MESH_ROWS = 2
SERVE_MESH_WAIT = 300.0        # a rank's wait for a reference's file
SERVE_MESH_TIMEOUT = 600.0     # the ranks' whole run
SERVE_MESH = {}                # the ranks' processes, logs and directory
# positions past the prompt in the decode cache: an even length, so that the
# sequence still splits over model
SERVE_MESH_ROOM = 8
# the kernels each model's path must launch on every rank
SERVE_MESH_KERNELS = {"gemma2-2b": ("flash_attention",), "deepseek-v2-236b": ("gmm",),
                      "mamba2-780m": ("ssd_chunk",)}
# the cache layouts each model must take: the sequence over model (gemma2's
# 4 kv heads and MLA's latent), the SSM's heads and channels over model
SERVE_MESH_SPECS = {
    "gemma2-2b": {"k": "P(None, 'data', 'model', None, None)",
                  "v": "P(None, 'data', 'model', None, None)"},
    "deepseek-v2-236b": {"ckv": "P(None, 'data', 'model', None)",
                         "krope": "P(None, 'data', 'model', None)"},
    "mamba2-780m": {"conv": "P(None, 'data', 'model', None)",
                    "ssm": "P(None, 'data', 'model', None, None)"}}


def serve_mesh_cfg(arch: str, layers: int):
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), n_layers=layers)


def serve_mesh_inputs(cfg, prompt: int, steps: int = 2):
    """The global batch (SERVE_MESH_ROWS x ``prompt`` tokens; gemma2's first
    GEMMA_HIDDEN tokens of a row one token, as phase 6b's, so the window
    hides something coherent) and the ``steps`` decode tokens of each row,
    on the host."""
    import torch
    g = torch.Generator().manual_seed(21)
    tokens = torch.randint(0, cfg.vocab, (SERVE_MESH_ROWS, prompt), generator=g)
    if cfg.local_global:
        tokens[:, :GEMMA_HIDDEN] = tokens[:, :1]
    return tokens, torch.randint(0, cfg.vocab, (steps, SERVE_MESH_ROWS), generator=g)


def serve_mesh_narrow(api, params, cfg):
    """The bf16 runs' weights: ``compute_params``' (the layers' matmul
    weights in bf16) and the vocab tables in bf16 too (they are the mesh's
    largest gather; both bf16 runs share their rounding)."""
    import torch
    p = api.compute_params(params, cfg)
    return {k: (v.to(torch.bfloat16) if k in ("embed", "lm_head") else v) for k, v in p.items()}


def _spliced(api, cfg, cache, max_seq: int, dev):
    """A one-device prefill's cache in an empty cache of ``max_seq``
    positions (the sequence leaves copied in, the states whole)."""
    full = api.init_cache(cfg, cache[next(k for k in cache if k != "len")].shape[1], max_seq,
                          dev)
    for k, v in cache.items():
        if k == "len":
            full[k] = v
        elif k in ("k", "v", "ckv", "krope"):
            full[k][:, :, :v.shape[2]] = v
        else:
            full[k].copy_(v)
    return full


def serve_mesh_reference(dev, tmp):
    """One process, before the ranks: each model's ``ref`` run in bf16
    (from ``compute_params``' weights) and in fp32 compute, each data
    shard's row alone (an MoE layer's capacity is the shard's, as under the
    mesh): the prefill's logits and cache, then the model's decode steps
    teacher-forced on the same tokens from the prefill's cache spliced into
    one of prompt + SERVE_MESH_ROOM positions, every logits row (true vocab)
    and, for an MoE model, each row's token's kept experts; saved to host
    files (each written under another name, then renamed: a rank waits for
    the name) with the bf16 run's spliced cache, which the ranks place and
    decode from.  Then the card is freed."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api
    for arch, layers, prompt, steps in SERVE_MESH_MODELS:
        cfg = serve_mesh_cfg(arch, layers)
        api = get_api(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(0), cfg, dev,
                          at_param_dtype=True)
        tokens, new = serve_mesh_inputs(cfg, prompt, steps)
        saved = {}
        for name, c, p in (("ref16", cfg, serve_mesh_narrow(api, params, cfg)),
                           ("ref32", dataclasses.replace(cfg, compute_dtype="float32"), params)):
            rows, routes, caches, spliced = {}, {}, [], []
            for d in range(SERVE_MESH_ROWS):
                timeline = []
                with recording_routes(timeline):
                    logits, cache = api.prefill(p, dict(tokens=tokens[d:d + 1].to(dev)), c,
                                                backend="ref")
                    rows[d] = [logits[0, :cfg.vocab].float().cpu()]
                    routes[d] = [kept_experts(timeline[-1][1], cfg)[-1]] if timeline else []
                    caches.append({k: v for k, v in cache.items() if k != "len"})
                    full = _spliced(api, c, cache, prompt + SERVE_MESH_ROOM, dev)
                    if name == "ref16":
                        spliced.append({k: (v.to("cpu", copy=True) if torch.is_tensor(v)
                                            else v) for k, v in full.items()})
                    for t in range(steps):
                        timeline.clear()
                        logits, full = api.decode_step(p, full, new[t, d:d + 1, None].to(dev), c,
                                                       backend="ref")
                        rows[d].append(logits[0, :cfg.vocab].float().cpu())
                        if timeline:
                            routes[d].append(kept_experts(timeline[-1][1], cfg)[0])
                    del full
            saved[name] = dict(rows=rows, routes=routes, cache={
                k: torch.cat([c_[k] for c_ in caches], 1).cpu() for k in caches[0]})
            if name == "ref16":
                saved["spliced"] = {k: (torch.cat([s[k] for s in spliced], 1)
                                        if torch.is_tensor(spliced[0][k]) else spliced[0][k])
                                    for k in spliced[0]}
            del caches
        path = os.path.join(tmp, f"serve4_{arch}.pt")
        torch.save(dict(saved, tokens=tokens, new=new), path + ".part")
        os.replace(path + ".part", path)
        del params, saved
        torch.cuda.empty_cache()
        mark(f"6f: {arch} one-device reference done")


def _block_errs(got: dict, want: dict, specs: dict, mesh) -> float:
    """The worst leaf's error of this rank's cache blocks against the same
    blocks of a whole cache, each over its block's max|want|."""
    from repro_torch.sharding.place import shard_leaf
    worst = 0.0
    for k, spec in specs.items():
        w = shard_leaf(want[k], spec, mesh).to(got[k].device)
        worst = max(worst, global_err(got[k], w))
    return worst


def lm_rank_serve4(out_dir):
    """Phase 6f, one of 4 gloo ranks sharing the card as (data 2, model 2):
    each model's blocks drawn (``init_sharded``, the blocks of the one-device
    init) and narrowed (``compute_params``), the global batch's prefill
    under ``use_mesh`` on the kernels (its logits row and cache blocks
    against the reference's), then the model's decode steps from the
    reference's bf16 cache placed by ``place_lm_cache``; the payloads, the
    launches, each call's ms and the peak memory; for gemma2-2b a planted
    fault (the first sequence block's partial dropped from every merge)."""
    import torch
    from repro_torch.common.tree import tree_paths
    from repro_torch.kernels import _build
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_mesh_for
    from repro_torch.launch.specs import abstract_params_for
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_api
    from repro_torch.roofline import lm_serve_payloads
    from repro_torch.sharding import rules
    from repro_torch.sharding.ctx import use_mesh
    from repro_torch.sharding.place import init_sharded, place_lm_cache, shard_leaf
    t_rank = time.perf_counter()
    dev = init_distributed("cuda", backend="gloo", init_method=os.environ["RANKS_INIT_METHOD"])
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_for((2, 2), ("data", "model"))
    stages = [("mesh", time.perf_counter() - t_rank)]
    out = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev), backend=mesh.backend,
               models={}, stages=stages)
    row = mesh.coords["data"]

    def timed(fn):
        torch.cuda.synchronize(dev)
        collectives.counter.reset()
        _build.launches.reset()
        t0 = time.perf_counter()
        with use_mesh(mesh):
            res = fn()
        torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t0) * 1e3, collectives.counter.payload(), \
            _build.launches.snapshot()

    for arch, layers, prompt, steps in SERVE_MESH_MODELS:
        cfg = serve_mesh_cfg(arch, layers)
        api = get_api(cfg)
        abstract = abstract_params_for(cfg)
        pspecs = rules.sanitize(rules.param_specs(abstract), abstract, mesh)
        blocks = init_sharded(lambda g, d: api.init(g, cfg, d, at_param_dtype=True),
                              torch.Generator(device=dev).manual_seed(0), dev, pspecs, mesh)
        blocks = serve_mesh_narrow(api, blocks, cfg)
        stages.append((f"{arch} blocks", time.perf_counter() - t_rank))
        path = os.path.join(out_dir, f"serve4_{arch}.pt")
        t_wait = time.perf_counter()
        while not os.path.exists(path):
            if os.path.exists(os.path.join(out_dir, "serve4_stop")):
                raise RuntimeError("the main process stopped before phase 6f")
            if time.perf_counter() - t_wait > SERVE_MESH_WAIT:
                raise RuntimeError(f"no {path} after {SERVE_MESH_WAIT:.0f} s")
            time.sleep(0.2)
        stages.append((f"{arch} waited", time.perf_counter() - t_rank))
        ref = torch.load(path, mmap=True)
        stages.append((f"{arch} reference read", time.perf_counter() - t_rank))
        dtypes = {p: str(t.dtype).replace("torch.", "") for p, t in tree_paths(blocks).items()}
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        batch = dict(tokens=ref["tokens"].to(dev))
        timeline = []
        with recording_routes(timeline):
            (logits, cache), pre_ms, pre_pay, pre_launch = timed(
                lambda: api.prefill(blocks, batch, cfg, backend="cuda"))
        stages.append((f"{arch} prefill", time.perf_counter() - t_rank))
        rows = [logits[0, :cfg.vocab].float().cpu()]
        routes = [kept_experts(timeline[-1][1], cfg)[-1]] if timeline else []
        specs = cache["specs"]
        blocks_err = {n: _block_errs(cache, ref[n]["cache"], specs, mesh)
                      for n in ("ref16", "ref32")}
        blocks_err["ref16_vs_ref32"] = _block_errs(
            {k: shard_leaf(ref["ref16"]["cache"][k], specs[k], mesh) for k in specs},
            ref["ref32"]["cache"], specs, mesh)
        del cache, logits
        stages.append((f"{arch} block errors", time.perf_counter() - t_rank))

        def decode(steps):
            mc = place_lm_cache(dict(ref["spliced"]), mesh)
            mc = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in mc.items()}
            got, rts, ms, pay, launch = [], [], [], {}, {}
            for t in range(steps):
                timeline.clear()
                with recording_routes(timeline):
                    (lg, mc), step_ms, pay, step_launch = timed(
                        lambda: api.decode_step(blocks, mc, ref["new"][t, :, None].to(dev),
                                                cfg, backend="cuda"))
                got.append(lg[0, :cfg.vocab].float().cpu())
                if timeline:
                    rts.append(kept_experts(timeline[-1][1], cfg)[0])
                ms.append(step_ms)
                for k, v in step_launch.items():
                    launch[k] = launch.get(k, 0) + v
            return got, rts, ms, pay, launch

        got, rts, dec_ms, dec_pay, dec_launch = decode(steps)
        stages.append((f"{arch} decode", time.perf_counter() - t_rank))
        rows += got
        routes += rts
        peak = torch.cuda.max_memory_allocated(dev)
        res = dict(prefill_ms=pre_ms, decode_ms=dec_ms, peak_bytes=peak, held_bytes=held,
                   prefill_payload=pre_pay, decode_payload=dec_pay,
                   want_prefill=lm_serve_payloads(cfg, mesh.shape, SERVE_MESH_ROWS, prompt,
                                                  "prefill", dtypes),
                   want_decode=lm_serve_payloads(cfg, mesh.shape, SERVE_MESH_ROWS,
                                                 prompt + SERVE_MESH_ROOM, "decode", dtypes),
                   launches_prefill=pre_launch, launches_decode=dec_launch,
                   specs={k: repr(v) for k, v in specs.items()}, blocks_err=blocks_err,
                   routes=[r.tolist() for r in routes], row=row)
        if arch == "gemma2-2b":
            merge = L.merge_partials

            def dropped(m, s, o, mesh_, axes):
                if axes and mesh_.index_of(axes) == 0:
                    m, s, o = torch.full_like(m, float("-inf")), torch.zeros_like(s), \
                        torch.zeros_like(o)
                return merge(m, s, o, mesh_, axes)

            L.merge_partials = dropped
            try:
                res["fault_rows"] = [rows[0]] + decode(1)[0]
            finally:
                L.merge_partials = merge
        torch.save(dict(rows=rows, fault=res.pop("fault_rows", None)),
                   os.path.join(out_dir, f"serve4_{arch}_rank{mesh.rank}_rows.pt"))
        out["models"][arch] = res
        del blocks, ref
        torch.cuda.empty_cache()
        stages.append((f"{arch} done", time.perf_counter() - t_rank))
    return out


def serve_mesh_gate(arch, cfg, ref, ranks, rows_of) -> dict:
    """Each rank's logits rows (its data shard's row: the prefill's and
    decode steps') against the fp32 ``ref`` run's at LM_GATE
    times the bf16 ``ref`` run's own error (:func:`lm_gate`), and its
    prefill's cache blocks likewise; an MoE model's rows read only where
    the three runs keep the row's token on the same experts (phase 6c's
    reason), at least MOE_MIN_READ of the data shards' rows, a prefill row
    among them.  gemma2-2b's planted fault must
    fail the logits gate."""
    gates, skipped = [], {}
    for r in ranks:
        m = r["models"][arch]
        uid = m["row"]
        runs = {n: {uid: ref[n]["rows"][uid]} for n in ("ref16", "ref32")}
        got = rows_of(r["rank"])
        runs["got"] = {uid: got["rows"]}
        skip = set()
        if cfg.moe is not None:
            for j, mine in enumerate(m["routes"]):
                if any(ref[n]["routes"][uid][j].tolist() != mine for n in ("ref16", "ref32")):
                    skip.add((uid, j))
            skipped.setdefault(uid, set()).update(skip)
            n_rows = len(ref["ref32"]["rows"][uid])
            print(f"  {arch} rank {r['rank']}: the gate reads {n_rows - len(skip)} of {n_rows} "
                  f"rows (left out, a routing that differs between the runs: {sorted(skip)})",
                  flush=True)
        g = lm_gate(f"{arch} rank {r['rank']} {r['coords']}", runs, skip=frozenset(skip))
        be = m["blocks_err"]
        ok = be["ref32"] <= LM_GATE * be["ref16_vs_ref32"]
        print(f"  {arch} rank {r['rank']}: prefill cache blocks {m['specs']} vs fp32 ref "
              f"{be['ref32']:.3e} (gate {LM_GATE * be['ref16_vs_ref32']:.3e} = {LM_GATE}x bf16 "
              f"ref's {be['ref16_vs_ref32']:.3e}); vs bf16 ref {be['ref16']:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"phase 6f {arch} rank {r['rank']}: the cache blocks are outside their gate")
        g["blocks"] = be
        if got["fault"] is not None:
            n = len(got["fault"])
            cut = {k: {uid: v[uid][:n]} for k, v in runs.items()}
            cut["fault"] = {uid: got["fault"]}
            g["planted"] = lm_gate(f"{arch} rank {r['rank']} planted fault: the first sequence "
                                   f"block's partial dropped from the merge (prefill and "
                                   f"{n - 1} decode step)", cut, fault=True, run="fault")
        gates.append(g)
    if cfg.moe is not None:
        # over the data shards' rows, as phase 6c reads its requests': at
        # least MOE_MIN_READ of them, a prefill row among them
        n_rows = sum(len(ref["ref32"]["rows"][u]) for u in skipped)
        left = sum(len(v) for v in skipped.values())
        if left > (1 - MOE_MIN_READ) * n_rows or all((u, 0) in v for u, v in skipped.items()):
            fail(f"phase 6f {arch}: the gate reads {n_rows - left} of {n_rows} rows: {skipped}")
    return dict(gates=gates)


def run_quickstart():
    """``python -m repro_torch.examples.quickstart`` at its defaults on the
    card as a subprocess: exit 0 and the reference's lines."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart"], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    held = [ln for ln in lines if ln.startswith("held-out task accuracy:")]
    print(f"quickstart (cuda): exit {proc.returncode} in {secs:.1f} s; "
          f"{[ln for ln in lines if ln.startswith(('step', 'batched'))][-2:]}; "
          f"{held[-1] if held else proc.stdout[-300:]}", flush=True)
    steps = [ln for ln in lines if ln.startswith("step ")]
    if proc.returncode != 0 or len(held) != 1 or len(steps) != 6 \
            or sum(ln.startswith("batched step") for ln in lines) != 4:
        fail(f"the quickstart failed on the card:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return dict(exit=proc.returncode, seconds=secs, heldout=held[0])


def _stop_serve_mesh() -> None:
    """Stop phase 6f's ranks (at exit: a rank waiting for its references
    reads the stop file; any still running is killed) and remove their
    directory."""
    import shutil
    tmp = SERVE_MESH.get("tmp")
    if tmp and os.path.isdir(tmp):
        pathlib.Path(tmp, "serve4_stop").touch()
    for proc, _ in SERVE_MESH.get("procs", []):
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if tmp:
        shutil.rmtree(tmp, ignore_errors=True)


def start_serve_mesh() -> None:
    """Start phase 6f's 4 rank processes (``python chip_smoke.py --lm-rank
    serve4 <dir>``, a ``file://`` store in the directory) now: their
    start-up (imports, the card, the mesh, the first model's blocks) runs
    beside the references, then each waits for a model's reference."""
    import atexit
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_")
    atexit.register(_stop_serve_mesh)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **DP_ENV}
    init = f"file://{tmp}/pg_serve4"
    procs = []
    for r in range(4):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
        e = dict(env, RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="4",
                 RANKS_INIT_METHOD=init)
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--lm-rank", "serve4", tmp], env=e, cwd=ROOT,
                                       stdout=log, stderr=subprocess.STDOUT, text=True), log))
    SERVE_MESH.update(tmp=tmp, procs=procs, t0=time.perf_counter())


def _serve_mesh_wait():
    """The ranks' readings, rank order, once all have exited 0 (a rank that
    fails fails the run, its peers killed)."""
    procs = SERVE_MESH["procs"]
    while any(p.poll() is None for p, _ in procs):
        bad = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.perf_counter() - SERVE_MESH["t0"] > SERVE_MESH_TIMEOUT:
            r = bad[0] if bad else next(r for r, (p, _) in enumerate(procs) if p.poll() is None)
            log = procs[r][1]
            log.seek(0)
            said = log.read()[-4000:]
            _stop_serve_mesh()
            fail(f"phase 6f: rank {r} of 4 failed or ran past {SERVE_MESH_TIMEOUT:.0f} s:\n{said}")
        time.sleep(0.1)
    for r, (p, log) in enumerate(procs):
        if p.returncode != 0:
            log.seek(0)
            fail(f"phase 6f: rank {r} exited {p.returncode}: {log.read()[-4000:]}")
    return [json.loads(pathlib.Path(SERVE_MESH["tmp"], f"serve4_rank{r}.json").read_text())
            for r in range(4)]


def serve_mesh_ranks(out, tmp, launches):
    """Phase 6f's checks, run with the deferred subprocess checks: the ranks
    waited for, then each rank's gate, payloads against
    ``roofline.lm_serve_payloads``, launches, ms and peak memory; the
    ranks' directory is removed after."""
    import torch
    counts = {}
    t0 = time.perf_counter()
    try:
        ranks = _serve_mesh_wait()
        secs = time.perf_counter() - t0
        out.update(seconds_ranks=secs)
        for arch, layers, prompt, steps in SERVE_MESH_MODELS:
            cfg = serve_mesh_cfg(arch, layers)
            ref = torch.load(os.path.join(tmp, f"serve4_{arch}.pt"), mmap=True)
            print(f"lm serve mesh (6f): {arch} at {layers} layers, full width, B "
                  f"{SERVE_MESH_ROWS} x S {prompt}, {steps} decode step(s), on 4 gloo "
                  f"ranks as (data 2, model 2) time-slicing one card beside the deferred "
                  f"subprocess checks (no scaling figure):", flush=True)
            for r in ranks:
                m = r["models"][arch]
                for kind in ("prefill", "decode"):
                    if m[f"{kind}_payload"] != m[f"want_{kind}"]:
                        fail(f"phase 6f {arch} rank {r['rank']}: {kind} payloads "
                             f"{m[f'{kind}_payload']} against lm_serve_payloads "
                             f"{m[f'want_{kind}']}")
                if m["specs"] != SERVE_MESH_SPECS[arch]:
                    fail(f"phase 6f {arch} rank {r['rank']}: cache specs {m['specs']}, want "
                         f"{SERVE_MESH_SPECS[arch]}")
                for k in SERVE_MESH_KERNELS[arch]:
                    if m["launches_prefill"].get(k, 0) < 1:
                        fail(f"phase 6f {arch} rank {r['rank']}: {k} not launched in the "
                             f"prefill: {m['launches_prefill']}")
                for part in ("launches_prefill", "launches_decode"):
                    for k, v in m[part].items():
                        counts[k] = counts.get(k, 0) + v
                print(f"  rank {r['rank']} {r['coords']}: prefill {m['prefill_ms']:.1f} ms, "
                      f"decode {statistics.median(m['decode_ms']):.1f} ms a step (median of "
                      f"{steps}); peak {m['peak_bytes']} B ({m['held_bytes']} B of "
                      f"blocks); launches prefill {m['launches_prefill']}, decode "
                      f"{m['launches_decode']}; payloads = lm_serve_payloads: prefill "
                      f"{m['prefill_payload']}, decode step {m['decode_payload']}", flush=True)
            rows_of = lambda rank: torch.load(  # noqa: E731
                os.path.join(tmp, f"serve4_{arch}_rank{rank}_rows.pt"))
            out[arch] = serve_mesh_gate(arch, cfg, ref, ranks, rows_of)
            del ref
        out["ranks"] = ranks
    finally:
        _stop_serve_mesh()
    launches["lm_serve_mesh"] = counts
    print(f"phase 6f ranks: {secs:.1f} s after phase 6f's references; rank 0's stages (s "
          f"from its start): "
          f"{[(k, round(v, 1)) for k, v in ranks[0]['stages']]}; launches {counts}", flush=True)
    return counts


def run_serve_mesh(dev, launches):
    """Phase 6f: LM prefill and decode over a (data 2, model 2) mesh of 4
    gloo ranks sharing the card.  The ranks start first
    (:func:`start_serve_mesh`; their start-up and first weights overlap the
    references, each rank waiting for a model's reference before its
    prefill); the one-device references in this process, then the card
    freed; the ranks' passes and their checks deferred
    (:func:`serve_mesh_ranks`), with the quickstart."""
    import torch
    t_phase = time.perf_counter()
    out = dict(kind="lm_serve_mesh", mesh=dict(data=2, model=2), rows=SERVE_MESH_ROWS,
               models=[dict(arch=a, layers=n, prompt=p, decode_steps=k)
                       for a, n, p, k in SERVE_MESH_MODELS])
    start_serve_mesh()
    tmp = SERVE_MESH["tmp"]
    serve_mesh_reference(dev, tmp)
    torch.cuda.empty_cache()
    defer(out, "launches", serve_mesh_ranks, out, tmp, launches)
    defer(out, "quickstart", run_quickstart)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 6f: {out['seconds']:.1f} s (the references; the ranks run on with the "
          f"deferred checks)", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of the repo")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    roofline = run_roofline(dev, card)
    mark("phase 1b done")
    dryrun = {}
    defer(dryrun, "cells", check_dryrun, start_dryrun())
    mark("phase 1c started (five host processes, checked with the deferred checks)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    mark("built")
    specs = kernel_cases(dev)
    rows = check_kernels(specs)
    planted = check_episodic_faults(specs)
    del specs
    mark("phase 3 done")
    launches = {}
    summary = [run_path("simple_cnaps", 8, dev, launches, trace=True),
               run_path("protonets", 4, dev, launches)]
    mark("phase 4 done")
    served = launches["simple_cnaps"]
    if served.get("mahalanobis/bulk", 0) != served.get("mahalanobis", 0):
        fail(f"the serving path's Mahalanobis launches did not all take the bulk copy: "
             f"{served}")
    if served.get("int8_matmul/cp16", 0) != served.get("int8_matmul", 0):
        fail(f"the serving path's int8 matmul launches did not all take the 16-byte "
             f"copies: {served}")
    summary.append(run_serve_warm(dev, launches))
    mark("phase 4b done")
    summary.append(run_serve_replica(dev, launches))
    mark("phase 4c done")
    summary.append(run_contracts(dev, launches))
    mark("phase 4d done")
    summary.append(run_training(dev, launches))
    mark("phase 5 done")
    summary.append(run_training_rest(dev, launches, summary[-1]))
    mark("phase 5b done")
    lm_train = run_lm_train(dev, launches)
    summary.append(lm_train)
    mark("phase 5c done")
    lm_pretrain = run_lm_pretrain(dev, launches)
    summary.append(lm_pretrain)
    mark("phase 5d done")
    moe_train = run_moe_train(dev, launches)
    summary.append(moe_train)
    mark("phase 5e done")
    ssm_train = run_ssm_train(dev, launches)
    summary.append(ssm_train)
    mark("phase 5f done")
    summary.append(run_dp_train(dev, launches))
    mark("phase 5g done")
    lm_mesh = run_lm_mesh(dev, launches)
    summary.append(lm_mesh)
    mark("phase 5h done")
    ops_rows, ops_planted = run_ops_path(dev, launches)
    planted += ops_planted
    bwd_rows = check_kernels(backward_kernel_specs(dev))
    for name, route in (("flash_attention_bwd", "wgmma"), ("ssd_chunk_bwd", "wgmma")):
        mains = [t["route"] for t in bwd_rows[name]["cases"]]
        if mains != [route] * len(mains):
            fail(f"{name}: the path shapes took routes {mains}, not {route}")
    torch.cuda.empty_cache()
    mark("phase 6 done")
    lm_serve = run_lm_serve(dev, launches)
    summary.append(lm_serve)
    mark("phase 6b done")
    moe_serve = run_moe_serve(dev, launches)
    summary.append(moe_serve)
    mark("phase 6c done")
    ssm_serve = run_ssm_serve(dev, launches)
    summary.append(ssm_serve)
    mark("phase 6d done")
    whisper = run_whisper(dev, launches)
    summary.append(whisper)
    mark("phase 6e done")
    summary.append(run_serve_mesh(dev, launches))
    mark("phase 6f done")
    run_deferred()
    summary.append(dict(kind="dryrun", **dryrun))
    mark("subprocesses done")
    # each kernel counted on the path that runs it: flash attention on LM
    # serving's prefills, gmm on MoE serving's expert projections (kimi-k2),
    # ssd_chunk on the SSD chunks of mamba2-780m's prefills, the backward
    # kernels on the training steps of gemma2-2b (B5's) and mamba2-780m
    # (B6's)
    path_of = {n: "simple_cnaps" for n in rows} | {n: "ops" for n in ops_rows} \
        | {"flash_attention": "lm_serve", "gmm": "lm_serve_kimi",
           "ssd_chunk": "lm_serve_mamba2", "flash_attention_bwd": "lm_pretrain",
           "ssd_chunk_bwd": "lm_ssm_train"}
    rows |= ops_rows | bwd_rows
    prefill_row = lm_serve["prefill_kernel"]
    rows["gmm"]["lm_moe_cases"] = moe_serve["gmm_cases"]
    rows["gmm"]["lm_moe_train_cases"] = moe_train["kernel_cases"]
    rows["gmm"]["lm_ep_cases"] = lm_mesh["kernel_cases"]
    rows["gmm"]["max_abs_err"] = max(rows["gmm"]["max_abs_err"], moe_serve["gmm_max_abs_err"],
                                     moe_train["kernel_max_abs_err"],
                                     lm_mesh["kernel_max_abs_err"])
    rows["flash_attention"]["lm_prefill_cases"] = prefill_row["cases"]
    rows["flash_attention"]["lm_train_cases"] = lm_train["kernel_cases"]
    rows["flash_attention"]["lm_pretrain_cases"] = lm_pretrain["kernel_cases"]
    rows["flash_attention"]["lm_zamba2_cases"] = (ssm_serve["flash_kernel"]["cases"]
                                                  + ssm_train["flash_kernel"]["cases"])
    rows["flash_attention"]["lm_whisper_cases"] = whisper["flash_kernel"]["cases"]
    rows["flash_attention"]["max_abs_err"] = max(rows["flash_attention"]["max_abs_err"],
                                                 prefill_row["max_abs_err"],
                                                 lm_train["kernel_max_abs_err"],
                                                 lm_pretrain["kernel_max_abs_err"],
                                                 ssm_serve["flash_kernel"]["max_abs_err"],
                                                 ssm_train["flash_kernel"]["max_abs_err"],
                                                 whisper["flash_kernel"]["max_abs_err"])
    rows["ssd_chunk"]["lm_ssm_cases"] = (ssm_serve["ssd_kernel"]["cases"]
                                         + ssm_train["ssd_kernel"]["cases"])
    rows["ssd_chunk"]["max_abs_err"] = max(rows["ssd_chunk"]["max_abs_err"],
                                           ssm_serve["ssd_kernel"]["max_abs_err"],
                                           ssm_train["ssd_kernel"]["max_abs_err"])
    for name, path in path_of.items():
        if launches[path].get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the {path} path")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, roofline=roofline, kernels=rows, paths=summary, launches=launches,
             planted_faults=planted), indent=1))
    # "train_launches": the launches of the episodic kernels in the five
    # steps of the training loop (phase 5), of flash attention in the three
    # steps of phase 5c, of gmm in the three steps of phase 5e's LM
    # training, of ssd_chunk in the three steps of phase 5f's mamba2-780m
    # training; "lm_train_launches" those of B1-B3 in phase 5c.
    # "route" is how the kernel was written (CUDA C++); "routes" the
    # kernel's own route ("wgmma" tensor cores or "simt" CUDA cores) at each
    # main case, and "main_cases" each main case's numbers
    case_keys = ("shape", "route", "ms", "device_ms", "device_timer", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "library_device_ms")
    train_path = {n: "train" for n in launches["train"]} | {"flash_attention": "lm_train",
                                                             "gmm": "lm_moe_train",
                                                             "ssd_chunk": "lm_ssm_train",
                                                             "flash_attention_bwd": "lm_train",
                                                             "ssd_chunk_bwd": "lm_ssm_train"}
    print(json.dumps({"kernels": [
        {k: rows[n][k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[path_of[n]][n]}
        | ({"train_launches": launches[train_path[n]][n]} if n in train_path else {})
        | ({"lm_train_launches": launches["lm_train"][n]}
           if n in launches["lm_train"] and train_path.get(n) != "lm_train" else {})
        | ({f"{p}_launches": launches[p][n] for p in ("ops", "serve_replica", "contracts",
                                                       "lm_serve_gemma2",
                                                       "lm_pretrain", "lm_mesh",
                                                       "lm_serve_mesh",
                                                       "lm_serve_kimi", "lm_serve_deepseek",
                                                       "lm_moe_episodic", "lm_serve_zamba2",
                                                       "lm_ssm_train_zamba2",
                                                       "lm_ssm_episodic", "lm_serve_whisper",
                                                       "lm_whisper_train")
            if p != path_of[n] and n in launches[p]})
        | {k: rows[n][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "library_device_ms",
                                   "device_ms", "device_timer", "routes")}
        | ({"main_cases": [{k: t[k] for k in case_keys} for t in rows[n]["cases"]]}
           if len(rows[n]["cases"]) > 1 else {})
        | ({f"lm_{c}_cases": [{k: t[k] for k in case_keys} for t in rows[n][f"lm_{c}_cases"]]
            for c in ("prefill", "train", "pretrain", "moe", "moe_train", "ep", "ssm", "zamba2",
                      "whisper")
            if f"lm_{c}_cases" in rows[n]})
        for n in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# one-card LM prefill and decode times of a checkout (--serve-ms)
# ---------------------------------------------------------------------------

# (arch, layers, decode slots): phases 6b's and 6d's one-card models at the
# depths they served before phase 6f took their time (16 of minitron-4b's
# 32 layers, all 48 of mamba2-780m's, 42 of zamba2-7b's 81)
SERVE_MS_MODELS = (("minitron-4b", 16, (4, 1)), ("mamba2-780m", 48, (4,)),
                   ("zamba2-7b", 42, (2,)))
SERVE_MS_PREFILL = (1024, 2048)
SERVE_MS_POS = 1024


def serve_ms_main(src: str, out_path: str) -> int:
    """``python chip_smoke.py --serve-ms SRC OUT``: one-card prefill ms (B 1,
    SERVE_MS_PREFILL tokens, the kernels on) and decode-step ms (at position
    SERVE_MS_POS) of SERVE_MS_MODELS, bf16 compute on random weights from
    seed 0, with the ``repro_torch`` under SRC; writes {arch: {layers,
    prefill: {S: ms}, decode: {slots: ms}}} and the card line to OUT.  Run
    it on two checkouts in turns (a b b a) in one call to compare them on
    the same shapes and timer."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_api
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.library()
    out = dict(src=src, card=card_line())
    for arch, layers, slots in SERVE_MS_MODELS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        api = get_api(cfg)
        p16 = api.compute_params(api.init(torch.Generator(device=dev).manual_seed(0), cfg),
                                 cfg)
        g = torch.Generator(device=dev).manual_seed(2)
        row = dict(layers=layers, prefill={}, decode={})
        for n in SERVE_MS_PREFILL:
            batch = dict(tokens=torch.randint(0, cfg.vocab, (1, n), generator=g, device=dev))
            row["prefill"][n] = time_ms(lambda: api.prefill(p16, batch, cfg, backend="cuda"),
                                        iters=3, reps=5)
        for b in slots:
            cache = api.init_cache(cfg, b, SERVE_MS_POS + 8, dev)
            cache["len"] = SERVE_MS_POS
            toks = torch.zeros((b, 1), dtype=torch.long, device=dev)
            # written in place at position len: each call rewrites the same one
            row["decode"][b] = time_ms(lambda: api.decode_step(p16, dict(cache), toks, cfg),
                                       iters=10, reps=5)
        print(f"serve ms {arch} ({layers} layers) under {src}: {row}", flush=True)
        out[arch] = row
        del p16, cache
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


# ---------------------------------------------------------------------------
# B5 and B7 at the shapes their redesigns aimed at, on any checkout
# (--kernel-ms)
# ---------------------------------------------------------------------------

# (label, B, S, heads, head dim): zamba2-7b's shared block (prefill, and the
# training step's B 2) and phi-3-vision's attention, causal, bf16
KERNEL_MS_FLASH = (("zamba2-7b B1 S1024 D112", 1, 1024, 32, 112),
                   ("zamba2-7b B1 S2048 D112", 1, 2048, 32, 112),
                   ("zamba2-7b train B2 S2048 D112", 2, 2048, 32, 112),
                   ("phi-3-vision B1 S2048 D96", 1, 2048, 32, 96))
# (label, E, C, D, F): B7's forward at phase 6c's serving shapes (kimi-k2's
# prefill and decode gate projections, deepseek-v2's prefill gate) and at
# phase 6's kimi-k2 ops shape, beside the training shapes
KERNEL_MS_GMM = (("kimi-k2 gate E384 C32 D7168 F2048", 384, 32, 7168, 2048),
                 ("kimi-k2 decode gate E384 C8 D7168 F2048", 384, 8, 7168, 2048),
                 ("deepseek-v2 gate E160 C56 D5120 F1536", 160, 56, 5120, 1536),
                 ("kimi-k2 ops E8 C512 D7168 F2048", 8, 512, 7168, 2048))


# the two Functions' backwards at phase 5d's and 5f's shapes, and B5's at
# the whisper encoder's (6e) and minitron-4b's H pass (5c): (label, B, S, Hq,
# Hkv, D, keywords) of B5 in bf16, (label, G, P, N) of B6 (Q 256, fp32)
KERNEL_MS_FLASH_BWD = (
    ("gemma2-2b local B2 S4608 D256", 2, 4608, 8, 4, 256,
     dict(causal=True, window=4096, softcap=50.0)),
    ("gemma2-2b global B2 S4608 D256", 2, 4608, 8, 4, 256, dict(causal=True, softcap=50.0)),
    ("zamba2-7b train B2 S2048 D112", 2, 2048, 32, 32, 112, dict(causal=True)),
    ("whisper-base encoder train B8 S1500 D64", 8, 1500, 8, 8, 64, dict(causal=False)),
    ("minitron-4b LITE H pass B16 S256 D128", 16, 256, 24, 8, 128, dict(causal=True)))
KERNEL_MS_SSD_BWD = (("mamba2-780m train G1536 P64 N128", 1536, 64, 128),
                     ("zamba2-7b train G1792 P64 N64", 1792, 64, 64))


def function_backward_ms(forward, inputs, cotangent):
    """The backward alone of an autograd Function's output (``forward()``'s
    output, or each of its outputs, against ``cotangent(output)``): its ms
    a call (CUDA events over back-to-back calls, the graph retained) and
    the memory it allocates above what it was handed (the inputs, the
    saved tensors, the outputs and the cotangents)."""
    import torch
    outs = forward()
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [cotangent(o) for o in outs]
    backward = lambda: torch.autograd.grad(outs, inputs, cots, retain_graph=True)  # noqa: E731
    ms = time_ms(backward, iters=3, reps=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return dict(ms=ms, peak_bytes_above_inputs=peak,
                grads_bytes=sum(t.numel() * t.element_size() for t in grads))


def kernel_ms_main(src: str, out_path: str) -> int:
    """``python chip_smoke.py --kernel-ms SRC OUT``: with the ``repro_torch``
    under SRC, the ms of one call (CUDA events over back-to-back calls) of
    B5 at KERNEL_MS_FLASH through ``ops.flash_attention_gqa`` and its route,
    of B7 at KERNEL_MS_GMM through ``ops.gmm``, and of B7 at deepseek-v2's
    training shapes (E 160, C 200, D 5120, F 1536, bf16) through
    ``dispatch.gmm``: the forward, and the backward of
    its autograd Function alone (dx and dw, and whatever copies the
    Function makes), with the memory the backward allocates above what it
    was handed (``max_memory_allocated``); then the backwards of B5's and
    B6's Functions alone at KERNEL_MS_FLASH_BWD and KERNEL_MS_SSD_BWD, with
    theirs (:func:`function_backward_ms`); writes them and the card line to
    OUT.  Run it on two checkouts in turns (a b b a) in one call."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.build()
    _build.library()
    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    out = dict(src=src, card=card_line(), flash={}, gmm={})
    for label, b, s_len, h, d in KERNEL_MS_FLASH:
        q, k, v = (randn(b, s_len, h, d) for _ in range(3))
        out["flash"][label] = dict(route=fa.flash_route(q, k, v), ms=time_ms(
            lambda: ops.flash_attention_gqa(q, k, v, causal=True), iters=10, reps=5))
        del q, k, v
    for label, e, c, d, f in KERNEL_MS_GMM:
        x, w = randn(e, c, d), randn(e, d, f, scale=d ** -0.5)
        out["gmm"][label] = time_ms(lambda: ops.gmm(x, w), iters=5, reps=5)
        del x, w
    torch.cuda.empty_cache()
    e, c, d, f = 160, 200, 5120, 1536
    x = randn(e, c, d).requires_grad_(True)
    w = randn(e, d, f, scale=d ** -0.5).requires_grad_(True)
    dout = randn(e, c, f)
    with torch.no_grad():
        out["gmm"]["forward_ms"] = time_ms(lambda: dispatch.gmm(x, w, backend="cuda"),
                                           iters=5, reps=5)
    y = dispatch.gmm(x, w, backend="cuda")
    backward = lambda: torch.autograd.grad(y, (x, w), dout, retain_graph=True)  # noqa: E731
    out["gmm"]["backward_ms"] = time_ms(backward, iters=3, reps=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = backward()
    torch.cuda.synchronize()
    out["gmm"]["backward_peak_bytes_above_inputs"] = torch.cuda.max_memory_allocated() - base
    out["gmm"]["grads_bytes"] = sum(t.numel() * t.element_size() for t in grads)
    del x, w, dout, y, grads
    torch.cuda.empty_cache()
    out["flash_backward"], out["ssd_backward"] = {}, {}
    for label, b, s_len, hq, hkv, d, kw in KERNEL_MS_FLASH_BWD:
        q, k, v = (randn(b, s_len, h, d).requires_grad_(True) for h in (hq, hkv, hkv))
        out["flash_backward"][label] = function_backward_ms(
            lambda: dispatch.flash_attention(q, k, v, backend="cuda", **kw), (q, k, v),
            lambda o: randn(*o.shape))
        del q, k, v
    for label, gg, p, n in KERNEL_MS_SSD_BWD:
        gen = torch.Generator(device=dev).manual_seed(11)
        x, B, C = (torch.randn(gg, 256, m, generator=gen, device=dev).requires_grad_(True)
                   for m in (p, n, n))
        dt = (torch.rand(gg, 256, generator=gen, device=dev) * 0.1).requires_grad_(True)
        A = (-1.0 - 15.0 * torch.rand(gg, generator=gen, device=dev)).requires_grad_(True)
        out["ssd_backward"][label] = function_backward_ms(
            lambda: dispatch.ssd_chunk(x, dt, A, B, C, backend="cuda"), (x, dt, A, B, C),
            lambda o: torch.randn(o.shape, generator=gen, device=dev))
        del x, dt, A, B, C
    print(f"kernel ms under {src}: {out}", flush=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-ms"]:
        sys.exit(serve_ms_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--kernel-ms"]:
        sys.exit(kernel_ms_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--serve-rank"]:
        sys.exit(serve_rank_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--lm-rank"]:
        sys.exit(lm_rank_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--contract-rank"]:
        sys.exit(contract_rank(sys.argv[2:]))
    sys.exit(main())
