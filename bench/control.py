"""Readings that set a training cell's correctness limits: the program's
numbers on many seeds (the lower reading); the control's (the reference in
the program's place with its convolutions and linear layers in bfloat16,
one precision below the configuration's float32) and a planted fault's
(half of the batch left out), the upper readings; and the program's own
bfloat16 path (LITE's no-grad complement in bfloat16), read beside them.
One process, no measured window: the checked steps are the readings.

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--controls 3]

Prints one JSON line a reading, then, for every number read (the cell's
limits name those compared), the largest program reading and the smallest
of each other side.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from harness import common  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args()
    common.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from harness import faults
    from harness.train_cell import TrainRun, as_program_readings
    cell = common.load_cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []

    def report(side, seed, numbers):
        row = dict(side=side, seed=seed, **{k: v for k, v in numbers.items()
                                            if isinstance(v, (int, float, str))})
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        sides = [("program", {})]
        if i < args.controls:
            sides += [("program_bf16_path", dict(lite_dtype="bfloat16")),
                      ("fault_half_batch", dict(wrap_step=faults.half_batch))]
        ref = None
        for side, hooks in sides:
            run = TrainRun(torch, cell, seed, device, common.Spans(), **hooks)
            got = run.checked_steps()
            run.free_program()
            ref = ref or run.reference()
            report(side, seed, run.numbers(got, ref))
            if side == "program" and i < args.controls:
                ctl = run.reference(lower=torch.bfloat16)
                report("control", seed, run.numbers(
                    as_program_readings(ctl, cell.config["optimizer"]["b1"]), ref))
            del run
            torch.cuda.empty_cache()
        torch.cuda.empty_cache()
    read = [k for k, v in rows[0].items() if isinstance(v, float)]
    for k in read:
        lo = max(r[k] for r in rows if r["side"] == "program")
        ups = {s: min(r[k] for r in rows if r["side"] == s)
               for s in {r["side"] for r in rows} - {"program"}}
        print(json.dumps(dict(number=k, lower=lo, **{f"upper_{s}": v for s, v in ups.items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
