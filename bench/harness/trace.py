"""The device trace of a traced slice of the window, reduced to what the
per-layer metrics read: device busy seconds (the union of the kernels'
intervals), device seconds by category of kernel name, and the longest
idle gaps named by the harness span the host was in.

The slice opens and closes with a marker operation launched after a
synchronise, so its first and last device events tie the device's clock
to the host's ``time.perf_counter``.  The category table is
``chip_smoke.py::TRAIN_CATEGORIES``'s (first match wins).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

CATEGORIES = (
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
EPISODIC_KERNELS = ("B1 segment_sum", "B2 class_second_moment", "B3 mahalanobis")


def category(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")


class DeviceTrace:
    """``torch.profiler`` over a slice, CUDA activity only."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None
        self.h0 = self.h1 = None

    def _marker(self) -> float:
        self.torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.torch.ones(7, device=self.device).mul_(3.0)
        self.torch.cuda.synchronize(self.device)
        return t

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        takes seconds (CUPTI's initialisation), which inside the window
        would stall the loop and shift the slice."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self._marker()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.start_s = time.perf_counter() - t
        self.h0 = self._marker()

    def stop(self) -> None:
        self.h1 = self._marker()
        self.prof.stop()

    def reduce(self, spans) -> Optional[Dict]:
        """busy_s, window_s, seconds by category and by kernel name, and the
        ten longest idle gaps named by ``spans`` (a
        :class:`harness.common.Spans`).  None when the trace holds no
        device time."""
        from torch.autograd import DeviceType
        evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in self.prof.events()
                      if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start),
                     key=lambda r: r[0])
        if len(evs) < 3:
            return None
        d0, d1 = evs[0][0], evs[-1][0]        # the two markers' starts (us)
        ratio = (self.h1 - self.h0) / max((d1 - d0) * 1e-6, 1e-9)   # host s a device s
        to_host = lambda us: self.h0 + (us - d0) * 1e-6 * ratio  # noqa: E731
        inner = [r for r in evs[1:-1] if d0 <= r[0] <= d1]
        by_cat: Dict[str, float] = {}
        by_name: Dict[str, float] = {}
        busy, gaps, cur_s, cur_e = 0.0, [], None, None
        for s, e, name in inner:
            e = min(e, d1)
            dur = (e - s) * 1e-6
            c = category(name)
            by_cat[c] = by_cat.get(c, 0.0) + dur
            by_name[name] = by_name.get(name, 0.0) + dur
            if cur_e is None:
                gaps.append((d0, s))
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += (cur_e - cur_s) * 1e-6
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += (cur_e - cur_s) * 1e-6
            gaps.append((cur_e, d1))
        if busy <= 0:
            return None
        window = (d1 - d0) * 1e-6
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[spans.name_at(to_host(0.5 * (a + b))), (b - a) * 1e-6] for a, b in gaps[:10]]
        return dict(busy_s=busy, window_s=window, start_s=self.start_s,
                    host_t0=self.h0, host_t1=self.h1, by_category=by_cat, by_name=by_name,
                    idle_gaps=idle)


def breakdown(trace: Dict) -> Dict:
    """The result line's ``breakdown``: the ten categories with the most
    device time and the ten longest idle gaps, in seconds."""
    ops = sorted(trace["by_category"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=trace["idle_gaps"])


def summary(trace: Dict) -> List[str]:
    """Lines for standard error: busy and window, the categories, and the
    top kernels by name."""
    lines = [f"trace: device busy {trace['busy_s']:.4f} s of {trace['window_s']:.4f} s "
             f"(idle {100 * (1 - trace['busy_s'] / trace['window_s']):.2f} %), the "
             f"profiler's start {1e3 * trace['start_s']:.1f} ms"]
    for k, v in sorted(trace["by_category"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {v:10.5f} s  {k}")
    for k, v in sorted(trace["by_name"].items(), key=lambda kv: -kv[1])[:12]:
        lines.append(f"  {v:10.5f} s  {k[:110]}")
    for name, s in trace["idle_gaps"]:
        lines.append(f"  gap {s * 1e3:9.3f} ms  {name}")
    return lines
