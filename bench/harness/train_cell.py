"""A training cell: LITE meta-training through ``repro_torch.train.loop.train``
over ``train.step.make_episodic_train_step``.

Set-up draws the weights and a pool of task batches on the device and
builds one training state, drives it through the first ``checked_steps``
steps, each one call of ``train`` on the pool's first batches (its warm-up),
and keeps what the check compares.  The window then calls ``train`` in runs
of ``steps_per_call`` steps on that same state until ``--seconds`` have
passed; each call ends in a synchronise.  Once the window has closed and
its memory has been read, the program's state is freed and the reference
repeats the checked steps.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

from harness import compare, traffic as gen, work
from harness.program import make_learner
from harness.trace import DeviceTrace
from harness.weights import clone_tree, make_weights, paths


class TrainRun:
    def __init__(self, torch, cell, seed: int, device, spans, backend: Optional[str] = None,
                 wrap_step=None, lite_dtype: Optional[str] = None):
        from repro_torch.configs.base import MetaTrainConfig
        from repro_torch.core.episodic import TaskBatch
        from repro_torch.core.lite import LiteSpec
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.train.step import make_episodic_train_step
        self.torch, self.cell, self.seed, self.device, self.spans = torch, cell, seed, device, spans
        self.tracer = DeviceTrace(torch, device)
        tr = cell.traffic
        # the learner's way is the tasks' (the traffic's)
        cfg = dict(cell.config, learner=dict(cell.config["learner"], way=tr["way"]))
        self.cfg, self.tr = cfg, tr
        opt = cfg["optimizer"]
        self.weights = make_weights(torch, cfg, seed, device)
        self.pool = gen.train_batches(torch, tr, cfg["image_size"],
                                      cfg["backbone"]["in_channels"], seed, device)
        self.pool_bytes = sum(t.numel() * t.element_size() for b in self.pool for t in b.values())
        t, n = self.pool[0]["support_y"].shape
        m = self.pool[0]["query_y"].shape[1]
        self.t, self.n, self.m = t, n, m
        ones = lambda k: torch.ones((t, k), device=device)  # noqa: E731
        self.tasks = [TaskBatch(support_x=b["support_x"], support_y=b["support_y"],
                                query_x=b["query_x"], query_y=b["query_y"],
                                support_mask=ones(n), query_mask=ones(m), way=tr["way"])
                      for b in self.pool]
        self.adamw = AdamWConfig(b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                                 weight_decay=opt["weight_decay"])
        meta = MetaTrainConfig(tasks_per_step=t, lite_h=tr["lite_h"], lite_chunk=tr["lite_chunk"],
                               lr=opt["lr"], max_grad_norm=opt["max_grad_norm"],
                               lite_dtype=lite_dtype, prefetch=tr["prefetch"],
                               kernel_backend=backend or cfg["kernel_backend"])
        lite = LiteSpec(h=tr["lite_h"], chunk_size=tr["lite_chunk"], compute_dtype=lite_dtype)
        step = make_episodic_train_step(make_learner(cfg), lite, meta, self.adamw)
        self.step = wrap_step(step) if wrap_step is not None else step
        params = clone_tree(self.weights)
        self.state = dict(params=params, opt=adamw_init(params, self.adamw))
        self.next_step = 0
        self.attempted = self.failed = 0
        self.losses, self.nonfinite = [], []

    def batch_at(self, s: int) -> Dict:
        with self.spans.span("batch_wait"):
            sc = gen.h_scores(self.torch, self.seed, s, (self.t, self.n))
            return dict(tasks=self.tasks[s % len(self.tasks)], scores=sc.to(self.device))

    def call(self, k: int):
        """One call of the loop: ``k`` steps on the state."""
        from repro_torch.train.loop import train
        base = self.next_step
        with self.spans.span("train"):
            res = train(self.state, self.step, lambda s: self.batch_at(base + s), k,
                        prefetch=self.tr["prefetch"], log=None)
        self.state = res.state
        self.next_step += k
        self.attempted += k
        self.failed += len(res.nonfinite_steps)
        self.losses += [m["loss"] for m in res.metrics_history]
        self.nonfinite += [base + s for s in res.nonfinite_steps]
        return res

    def checked_steps(self) -> Dict:
        """The first steps, one call each: the losses, the optimizer's first
        moment after step 1 and the parameters after the last, by path."""
        losses, mu1 = [], None
        for i in range(self.tr["checked_steps"]):
            res = self.call(1)
            losses.append(float(res.metrics_history[0]["loss"]))
            if i == 0:
                mu1 = {p: t.detach().clone() for p, t in paths(self.state["opt"]["mu"]).items()}
        params = {p: t.detach().clone() for p, t in paths(self.state["params"]).items()}
        return dict(losses=losses, mu1=mu1, params=params)

    def window(self, seconds: float, trace: bool) -> Dict:
        k = self.tr["steps_per_call"]
        tracer = self.tracer if trace else None
        traced_from = None
        step_times = []
        first = self.attempted
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracer is not None and traced_from is None and \
                    time.perf_counter() - t0 >= seconds - self.tr["trace_seconds"]:
                tracer.start()
                traced_from = self.attempted
            step_times += self.call(k).step_times
        t1 = time.perf_counter()
        out = dict(window_s=t1 - t0, steps=self.attempted - first, step_times=step_times,
                   tasks=(self.attempted - first) * self.t)
        if tracer is not None:
            tracer.stop()
            out["tracer"] = tracer
            out["trace_tasks"] = (self.attempted - traced_from) * self.t
        return out

    def free_program(self) -> None:
        self.state = self.step = self.tasks = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, lower=None) -> Dict:
        from reference.model import strict_fp32
        from reference.train import run_steps
        k = self.tr["checked_steps"]
        batches = [self.pool[s % len(self.pool)] for s in range(k)]
        scores = [gen.h_scores(self.torch, self.seed, s, (self.t, self.n)) for s in range(k)]
        with strict_fp32():
            return run_steps(self.cfg, self.tr, self.weights, batches, scores, lower)

    def numbers(self, prog: Dict, ref: Dict) -> Dict:
        return compare.train_numbers(prog, ref, paths(self.weights), self.cfg["optimizer"]["b1"])

    def model_flops(self, tasks: int) -> float:
        return tasks * work.train_task_flops(self.cfg, self.n, self.m, self.tr["lite_h"])

    def kernels_bound_s(self, tasks: int) -> float:
        return tasks * work.episodic_kernels_bound_s(self.cfg, self.n)


def as_program_readings(ref: Dict, b1: float) -> Dict:
    """A reference run's result in the program's form (the control in the
    program's place): its first moment after step 1 is (1 - b1) g1."""
    return dict(losses=ref["losses"], mu1={p: (1.0 - b1) * g for p, g in ref["grad1"].items()},
                params=ref["params"])


def run_cell(torch, cell, args, device, spans, t_start: float, **hooks) -> Dict:
    """One run of a training cell: set-up (``setup_s`` from ``t_start``), the
    window, the program freed, the reference; the end-to-end metrics, what
    the per-layer readers read, the numbers compared and lines for standard
    error."""
    run = TrainRun(torch, cell, args.seed, device, spans, **hooks)
    prog = run.checked_steps()
    if args.trace:
        run.tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    pre_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    win = run.window(args.seconds, bool(args.trace))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace = win["tracer"].reduce(spans) if "tracer" in win else None
    run.free_program()
    ref = run.reference()
    numbers = run.numbers(prog, ref)
    e2e = dict(train_tasks_per_s=dict(value=win["tasks"] / win["window_s"], unit="tasks/s"),
               train_peak_gib=dict(value=(peak - run.pool_bytes) / 2 ** 30, unit="GiB"),
               setup_s=dict(value=setup_s, unit="s"))
    ctx = dict(kind="train", cell=cell, window_s=win["window_s"], tasks=win["tasks"],
               step_times=win["step_times"], model_flops=run.model_flops(win["tasks"]),
               trace=trace)
    if trace is not None:
        ctx.update(trace_tasks=win["trace_tasks"],
                   kernels_bound_s=run.kernels_bound_s(win["trace_tasks"]))
    info = [f"train: {win['steps']} steps of {run.t} tasks in {win['window_s']:.3f} s, "
            f"step ms p50 {1e3 * statistics.median(win['step_times']):.2f}, "
            f"setup {setup_s:.2f} s, peak {peak} B (pool {run.pool_bytes} B), "
            f"losses {prog['losses']} / reference {ref['losses']}, "
            f"worst leaves {numbers['grad1_leaf']} / {numbers['change_leaf']}, "
            f"left out {numbers['left_out']}",
            f"train: skipped (non-finite) steps {run.nonfinite}, losses by step "
            f"{[round(x, 4) for x in run.losses]}"]
    return dict(e2e=e2e, ctx=ctx, numbers=numbers, attempted=run.attempted, failed=run.failed,
                peak=max(pre_peak, peak), trace=trace, info=info)
