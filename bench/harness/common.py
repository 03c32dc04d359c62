"""What every cell shares: where the checkout is, the caches kept inside it,
the cell's files found by the names in ``BENCHMARK.json``, the host spans,
the check that nothing of JAX was loaded, and the result line.

Importing this module starts nothing: :func:`prepare_environment` sets the
cache directories and puts the checkout's ``src/`` on ``sys.path``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import sys
import threading
import time
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
# every build and kernel cache the program or PyTorch may write, at fixed
# paths inside the checkout (``build/`` is where the port's kernel library
# already goes, ``repro_torch.kernels._build.BUILD_DIR``)
CACHE_DIRS = {
    "TRITON_CACHE_DIR": ROOT / "build" / "triton_cache",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache",
}
# modules that may not be loaded by the process that prints a result,
# compared by their whole top-level name ("repro_torch" is not "repro")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout, no Flax through any
    library, and the program (``src/``) importable."""
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads with its files read."""

    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_file: pathlib.Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell named ``workload``: its configuration file, its traffic
    mix (``bench/traffic/<traffic>.json``), its correctness limits
    (``bench/limits/<workload>.json``) and the metrics it reports."""
    spec = load_json(bench_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)])


def load_reader(metric: str):
    """``read(ctx)`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host spans the harness records around its calls into each layer:
    (name, start, end) on ``time.perf_counter``, any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rows: List[tuple] = []

    def span(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                with spans._lock:
                    spans.rows.append((name, self.t0, time.perf_counter()))
                return False

        return _Span()

    def summary(self) -> str:
        """Count, total, median and largest seconds of each span name."""
        by: Dict[str, List[float]] = {}
        for name, a, b in self.rows:
            by.setdefault(name, []).append(b - a)
        return "; ".join(
            f"{k} x{len(v)} total {sum(v):.3f} s p50 {1e3 * sorted(v)[len(v) // 2]:.2f} ms "
            f"max {1e3 * max(v):.2f} ms" for k, v in sorted(by.items()))

    def name_at(self, t: float) -> str:
        """The shortest span that holds ``t`` (the innermost call), or
        ``"harness"`` where none does."""
        best = None
        for name, a, b in self.rows:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "harness"


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(xs)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def device_info(torch, device, peak_bytes: int, count: int = 1) -> Dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=count,
                    memory_peak_bytes=int(peak_bytes))
    return dict(platform="cpu", kind="cpu", count=count, memory_peak_bytes=int(peak_bytes))


def emit(result: Dict, checks: List[Dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error and as the last key of the result line; then the result
    line as the last line of standard output."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    out = dict(result)
    out["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"]) for c in checks}
    print(json.dumps(out), flush=True)
