"""On a CUDA device: one short run of every cell through the command line,
its last line a result with ``correct`` true.  Skipped without a card (the
fixture decides, not the import)."""
import json
import subprocess
import sys

import pytest

from harness.common import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", workload, "--seed",
                          "2147483700", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
