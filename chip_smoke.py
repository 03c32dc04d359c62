"""Drive the PyTorch port's episodic serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit, and the torch / CUDA versions;
2. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged shape, and time the kernel, the plain
   version and (where one exists) a single PyTorch library call;
4. serve full-width Simple CNAPs (224 x 224 images, int8 frozen backbone)
   through ``EpisodicServeEngine.run_to_completion`` on the kernels, count
   each kernel's launches, and hold the logits and adapted states against
   the same engine on the plain ``ref`` backend; profile one more run of
   that path (device busy time, idle share, top ops by device time); then a
   shorter ProtoNets pass, read the same way;
5. print the ``kernels`` JSON line, the card line and, last, the result.

In the ``kernels`` line, ``ms`` is the mean time of back-to-back wrapper
calls (the wrapper's host work included), ``device_ms`` the profiler's
device time of one launch, and ``bound_ms`` the larger of the bytes over
the HBM rate and the FLOPs over the fp32 rate at the main path's shape.

It imports no JAX.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _dev_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile(fn, n: int = 1):
    """Run ``fn`` ``n`` times under torch.profiler (CPU + CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def kernel_device_ms(fn, symbol: str, n: int = 50):
    """Device time of one launch of the kernel whose name contains
    ``symbol``, from the profiler; None if the profiler saw none."""
    evts = [e for e in profile(fn, n) if symbol in e.key and _dev_us(e) > 0]
    if not evts:
        return None
    return sum(_dev_us(e) for e in evts) / sum(e.count for e in evts) / 1e3


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> float:
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """(name, source, replaces, tol, cases); a case is (label, make_inputs,
    kernel_fn, plain_fn, library_fn or None, bytes, flops)."""
    import torch
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import mahalanobis as md
    from repro_torch.kernels import segment_pool as sp
    from repro_torch.optim.quant import quantize

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device=dev, dtype=dtype)

    def onehot(t, b, c, pad_rows):
        y = torch.randint(0, c, (t, b), generator=g)
        w = torch.nn.functional.one_hot(y, c).float()
        if pad_rows:
            w[:, -pad_rows:] = 0.0          # collator padding: zero-weight rows
        return w.to(dev)

    def seg_case(label, t, b, f, c, dtype=torch.float32, pad=0):
        x, w = randn(t, b, f, dtype=dtype), onehot(t, b, c, pad)
        nbytes = x.numel() * x.element_size() + w.numel() * 4 + t * c * f * 4
        return (label, (x, w), sp.segment_pool_weighted, sp.segment_pool_weighted_plain,
                lambda x, w: torch.bmm(w.transpose(1, 2), x.float()),
                nbytes, 2.0 * t * b * c * f)

    def sm_case(label, t, b, f, c, dtype=torch.float32, pad=0):
        x, w = randn(t, b, f, dtype=dtype), onehot(t, b, c, pad)
        nbytes = x.numel() * x.element_size() + w.numel() * 4 + t * c * f * f * 4
        return (label, (x, w), sp.class_second_moment, sp.class_second_moment_plain,
                lambda x, w: torch.einsum("tbc,tbi,tbj->tcij", w, x.float(), x.float()),
                nbytes, 2.0 * t * c * b * f * f)

    def md_case(label, t, m, c, f):
        q, mu = randn(t, m, f), randn(t, c, f)
        a = randn(t, c, f, f) / math.sqrt(f)
        sinv = a @ a.transpose(-1, -2) + torch.eye(f, device=dev)
        nbytes = 4 * (q.numel() + mu.numel() + sinv.numel() + t * m * c)
        return (label, (q, mu, sinv), md.mahalanobis, md.mahalanobis_plain, None,
                nbytes, 2.0 * t * c * m * f * f + 3.0 * t * c * m * f)

    def im_case(label, m, k, n):
        x = randn(m, k)
        qs = quantize(randn(k, n) / math.sqrt(k))
        q, s = qs["q"].contiguous(), qs["scale"].contiguous()
        nbytes = 4 * x.numel() + q.numel() + 4 * s.numel() + 4 * m * n
        return (label, (x, q, s), im.int8_matmul, im.int8_matmul_plain, None,
                nbytes, 2.0 * m * k * n)

    src = "src/repro_torch/kernels/csrc/"
    # (name, source, replaces, tolerance, device symbol, cases)
    return [
        ("segment_sum", src + "segment_pool.cu", "src/repro/kernels/segment_pool.py:55", 1e-5, "segment_sum_kernel", [
            seg_case("main T4 B32 F256 C5", 4, 32, 256, 5),
            seg_case("ragged T3 B37 F200 C5 bf16 pad5", 3, 37, 200, 5, torch.bfloat16, 5),
            seg_case("ragged T2 B21 F72 C5 fp16 pad3", 2, 21, 72, 5, torch.float16, 3)]),
        ("class_second_moment", src + "segment_pool.cu", "src/repro/kernels/segment_pool.py:112", 1e-5, "second_moment_kernel", [
            sm_case("main T4 B32 F256 C5", 4, 32, 256, 5),
            sm_case("ragged T3 B37 F200 C5 bf16 pad5", 3, 37, 200, 5, torch.bfloat16, 5),
            sm_case("ragged T2 B21 F72 C5 fp16 pad3", 2, 21, 72, 5, torch.float16, 3)]),
        ("mahalanobis", src + "mahalanobis.cu", "src/repro/kernels/mahalanobis.py:29", 1e-5, "mahalanobis_kernel", [
            md_case("main T4 M8 C5 F256", 4, 8, 5, 256),
            md_case("ragged T3 M13 C5 F200", 3, 13, 5, 200)]),
        ("int8_matmul", src + "int8_matmul.cu", "src/repro/kernels/int8_matmul.py:50", 1e-5, "int8_matmul_kernel", [
            im_case("main M128 K256 N256", 128, 256, 256),
            im_case("main M32 K256 N256", 32, 256, 256),
            im_case("ragged M50 K200 N300", 50, 200, 300)]),
    ]


def check_kernels(dev):
    import torch
    rows = {}
    for name, source, replaces, tol, symbol, cases in kernel_cases(dev):
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   tol=tol, max_abs_err=0.0, max_rel_err=0.0)
        for i, (label, args, kern, plain, lib, nbytes, flops) in enumerate(cases):
            got = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err_abs = float((got - want).abs().max())
            err_rel = rel_err(got, want)
            ok = err_rel <= tol and bool(torch.isfinite(got).all())
            print(f"kernel {name:20s} {label:34s} max_abs_err={err_abs:.3e} "
                  f"rel_err={err_rel:.3e} tol={tol:.0e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"{name} [{label}] disagrees with its plain version")
            row["max_abs_err"] = max(row["max_abs_err"], err_abs)
            row["max_rel_err"] = max(row["max_rel_err"], err_rel)
            if i == 0:                        # the main path's shape is timed
                b_ms, b_by = bound_ms(nbytes, flops)
                row.update(
                    shape=label,
                    ms=time_ms(lambda: kern(*args)),
                    plain_ms=time_ms(lambda: plain(*args)),
                    library_ms=time_ms(lambda: lib(*args)) if lib else None,
                    device_ms=kernel_device_ms(lambda: kern(*args), symbol),
                    bound_ms=b_ms, bound_by=b_by)
                print(f"  time {label}: kernel {row['ms']:.4f} ms per call "
                      f"(device {row['device_ms']} ms per launch), plain "
                      f"{row['plain_ms']:.4f} ms, library "
                      f"{row['library_ms'] if lib else None} ms, bound "
                      f"{b_ms:.5f} ms ({b_by})", flush=True)
        rows[name] = row
    return rows


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
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
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
    key = "mu" if kind != "protonets" else None
    for uid in {r.uid for r in got}:
        a, b = eng.store.peek(uid), ref.store.peek(uid)
        a, b = (a[key], b[key]) if key else (a, b)
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

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = check_kernels(dev)
    launches = {}
    summary = [run_path("simple_cnaps", 8, dev, launches, trace=True),
               run_path("protonets", 4, dev, launches)]
    main_counts = launches["simple_cnaps"]
    for name in rows:
        if main_counts.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, kernels=rows, paths=summary), indent=1))
    print(json.dumps({"kernels": [
        {k: rows[n][k] for k in ("name", "route", "source", "replaces")}
        | {"launches": main_counts[n]}
        | {k: rows[n][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "device_ms")}
        for n in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
