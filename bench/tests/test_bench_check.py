"""The check that decides ``correct``, driven through a whole run of each
cell cut to 32 px on the CPU (the program on its ``ref`` kernels): sound
runs pass, and every fault the cell can have, planted under the timed
path, and the control (the reference under bfloat16 in the program's
place) fail."""
import time

import pytest
import torch

import run
from harness import faults
from harness.common import load_cell, load_json, ROOT
from tests.small import args, small_cell

CPU = torch.device("cpu")
TRAIN = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]
         if load_cell(w["name"]).traffic["kind"] == "train"]


def _run(workload, seed=5, **hooks):
    run.T_START = time.perf_counter()
    result, checks = run.execute(small_cell(workload), args(workload, seed), CPU,
                                 backend="ref", **hooks)
    return result, {c["name"]: c for c in checks}


@pytest.mark.parametrize("workload", TRAIN)
def test_a_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result) - {"breakdown"} == {"correct", "attempted", "failed", "metrics", "device"}


FAULTS = {"unchanged_state": dict(wrap_step=faults.unchanged_state),
          "half_batch": dict(wrap_step=faults.half_batch),
          # the program's own bfloat16 path: LITE's no-grad complement in bf16
          "bf16_complement": dict(lite_dtype="bfloat16")}


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_faulty_training_step_is_not_correct(workload, fault):
    result, checks = _run(workload, **FAULTS[fault])
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", TRAIN)
def test_the_training_control_is_not_correct(workload):
    """The reference in the program's place, its convolutions and linear
    layers in bfloat16."""
    from harness.compare import checks as judge
    from harness.common import Spans
    from harness.train_cell import TrainRun, as_program_readings
    cell = small_cell(workload)
    r = TrainRun(torch, cell, 5, CPU, Spans(), backend="ref")
    ref = r.reference()
    ctl = as_program_readings(r.reference(lower=torch.bfloat16), cell.config["optimizer"]["b1"])
    ok, rows = judge(r.numbers(ctl, ref), cell.limits)
    assert not ok, rows
