"""The port's quickstart (``python -m repro_torch.examples.quickstart``) on
the CPU at a few steps.  Its draws are ``torch.Generator`` seeds where the
JAX example splits ``jax.random`` keys, so its numbers are not the
reference's: the test holds the contracts, not the numbers.

* in the process: finite meta-losses and batched losses, every accuracy in
  [0, 1], 10 held-out tasks, a third as many batched steps as meta steps;
* as the module a user runs: its printed lines, the reference's.
"""
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import quickstart

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_quickstart_contracts_in_the_process(capsys):
    out = quickstart.main(["--device", "cpu", "--steps", "6"])
    assert len(out["losses"]) == 6 and len(out["batched"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    assert all(0.0 <= a <= 1.0 for a in out["accuracies"])
    assert len(out["heldout"]) == 10 and all(0.0 <= a <= 1.0 for a in out["heldout"])
    assert all(math.isfinite(loss) and 0.0 <= acc <= 1.0 for loss, acc in out["batched"])
    said = capsys.readouterr().out
    assert said.count("meta-loss") == 1 and said.count("batched step") == 1


def test_quickstart_as_a_module_prints_the_reference_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
                          "cpu", "--steps", "12"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split()[1] for ln in steps] == ["0", "10"]
    for ln in steps:
        _, _, _, loss, _, acc = ln.split()
        assert math.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
    held = [ln for ln in lines if ln.startswith("held-out task accuracy:")]
    assert len(held) == 1 and 0.0 <= float(held[0].split()[3]) <= 1.0
    assert "(adaptation = single forward pass)" in held[0]
    assert [ln.split()[2] for ln in lines if ln.startswith("batched step")] == ["0"]
