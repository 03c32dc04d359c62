"""The port's benchmark: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration file, its
traffic mix and its correctness limits are found by the names in
``BENCHMARK.json``; a mix of ``"kind": k`` runs through
``bench/harness/<k>_cell.py``'s ``run_cell``; the per-layer metrics of a
``--trace 1`` run are read by ``bench/metrics/<metric>.py``.  The run builds the program's state and
warms every shape the cell uses (``setup_s``), measures for ``--seconds``,
checks what the timed path produced against the plain reference under
``bench/reference/``, and prints one JSON line last on standard output
(each compared number beside its limit on standard error before it).  It
exits non-zero, printing no result, without enough CUDA devices, without
the program (``src/repro_torch``), or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from harness import common  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell, ctx):
    out = {}
    for m in cell.per_layer:
        value = common.load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def execute(cell, args, device, **hooks):
    """Run ``cell`` on ``device``: (result line, checks)."""
    import torch
    from harness import compare
    from harness.trace import breakdown, summary
    spans = common.Spans()
    kind = importlib.import_module(f"harness.{cell.traffic['kind']}_cell")
    out = kind.run_cell(torch, cell, args, device, spans, T_START, **hooks)
    ok, checks = compare.checks(out["numbers"], cell.limits)
    numbers = {k: v for k, v in out["numbers"].items() if isinstance(v, (int, float))}
    for line in out["info"] + [f"numbers read: {numbers}", f"spans: {spans.summary()}"]:
        print(line, file=sys.stderr, flush=True)
    if out["trace"] is not None:
        for line in summary(out["trace"]):
            print(line, file=sys.stderr, flush=True)
    result = dict(correct=ok, attempted=out["attempted"], failed=out["failed"])
    if args.trace:
        result["metrics"] = per_layer(cell, out["ctx"])
    else:
        result["metrics"] = {m["name"]: out["e2e"][m["name"]] for m in cell.end_to_end}
    result["device"] = common.device_info(torch, device, out["peak"])
    if args.trace and out["trace"] is not None:
        result["device"].update(busy_s=out["trace"]["busy_s"], window_s=out["trace"]["window_s"])
        result["breakdown"] = breakdown(out["trace"])
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    common.prepare_environment()
    cell = common.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program must be in the checkout)
    device = torch.device("cuda", 0)
    print(f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"device {torch.cuda.get_device_name(device)}", file=sys.stderr, flush=True)
    result, checks = execute(cell, args, device)
    bad = common.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["metrics"].items():
        if not math.isfinite(v["value"]):
            print(f"metric {k} is not finite: {v['value']}", file=sys.stderr)
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
