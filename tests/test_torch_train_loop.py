"""The port's fault-tolerant training loop, checkpoints and launcher, on a
small ProtoNets model on the CPU (no JAX: these are the loop's own
contracts, the rows of ROADMAP's fault-tolerance table):

* a kill between a checkpoint's tmp write and its COMMIT marker leaves the
  previous checkpoint, and the rerun resumes from it bit-exactly;
* a preemption flushes a checkpoint and raises ``PreemptedError``; the
  rerun resumes bit-exactly;
* a run of non-finite steps rolls back to the last commit, and raises
  ``DivergenceError`` once the rollbacks are spent;
* transient data errors are retried (sync and prefetched), stragglers are
  flagged on a fake clock;
* checkpoints verify their crc32, keep N, and round-trip bf16;
* ``python -m repro_torch.launch.train --episodic --device cpu`` exits 0.

Bit-exact means ``torch.equal`` on every leaf of params and optimizer
state: the CPU step is deterministic at one thread.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.configs.base import MetaTrainConfig
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
from repro_torch.faults import (CKPT_PRE_COMMIT, DATA_NAN, DATA_TRANSIENT,
                                TRAIN_PREEMPT, TRAIN_STRAGGLER, FaultPlan,
                                FaultSpec, InjectedKill, PreemptionSignal,
                                TransientDataError)
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.checkpoint import ChecksumError, CheckpointManager
from repro_torch.train.loop import DivergenceError, PreemptedError, train
from repro_torch.train.step import make_episodic_init_state, make_episodic_train_step

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T = 2


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01          # every read: 10 ms pass
        return self.t

    def advance(self, dt):
        self.t += dt


def _setup():
    learner = make_learner(MetaLearnerConfig(kind="protonets", way=5),
                           make_conv_backbone(ConvBackboneConfig(widths=(4, 8),
                                                                 feature_dim=16)))
    adamw = AdamWConfig(weight_decay=0.0)
    state = make_episodic_init_state(learner, adamw)(torch.Generator().manual_seed(0), "cpu")
    step = make_episodic_train_step(learner, LiteSpec(h=4, chunk_size=4),
                                    MetaTrainConfig(tasks_per_step=T, lr=1e-2), adamw)
    cfg = HostEpisodicConfig(way=5, shot=2, query_per_class=2, image_size=8)

    def batch_at(s):
        return dict(tasks=host_task_batch_at(17, cfg, T, s), key=(23, s))

    def put(b):
        return dict(b, tasks=b["tasks"].to("cpu"))
    return state, step, batch_at, put


def _run(ckpt_dir, num_steps=6, **kw):
    state, step, batch_at, put = _setup()
    ckpt = CheckpointManager(ckpt_dir, keep=3, fault_plan=kw.pop("ckpt_faults", None))
    return train(state, step, batch_at, num_steps, ckpt=ckpt, ckpt_every=2,
                 state_template=state, batch_put=put, clock=FakeClock(), **kw)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """An uninterrupted six-step run."""
    return _run(tmp_path_factory.mktemp("ref"))


def test_uninterrupted_run(reference):
    assert reference.step == 6 and len(reference.metrics_history) == 6
    assert all(np.isfinite(m["loss"]) and m["nonfinite"] == 0.0
               for m in reference.metrics_history)
    assert int(reference.state["opt"]["count"]) == 6


@pytest.mark.parametrize("prefetch", [0, 2])
def test_kill_at_pre_commit_resumes_bit_exactly(tmp_path, reference, prefetch):
    plan = FaultPlan.single(CKPT_PRE_COMMIT, at=4)
    with pytest.raises(InjectedKill):
        _run(tmp_path, ckpt_faults=plan, prefetch=prefetch)
    ckpt = CheckpointManager(tmp_path)
    assert ckpt.all_steps() == [2]          # step 4's save never committed
    resumed = _run(tmp_path, prefetch=prefetch)
    assert resumed.resumed_from == 2
    assert _equal(resumed.state, reference.state)


def test_preemption_flushes_and_resumes_bit_exactly(tmp_path, reference):
    with pytest.raises(PreemptedError) as e:
        _run(tmp_path, fault_plan=FaultPlan.single(TRAIN_PREEMPT, at=3))
    assert e.value.step == 3 and e.value.flushed
    assert CheckpointManager(tmp_path).latest_step() == 3
    signal = PreemptionSignal()
    signal.request()
    with pytest.raises(PreemptedError):      # a set signal stops at the first boundary
        _run(tmp_path, preempt=signal)
    resumed = _run(tmp_path)
    assert resumed.resumed_from == 3
    assert _equal(resumed.state, reference.state)


def _nan_plan(first, last, count):
    return FaultPlan([FaultSpec(DATA_NAN, at=s, count=count) for s in range(first, last)])


def test_nonfinite_run_rolls_back_then_diverges(tmp_path):
    # steps 3-5 poisoned once each: three skips in a row (> 2) roll back to
    # the step-4 commit, and the replay, past the healed faults, completes
    healed = _run(tmp_path / "a", num_steps=8, fault_plan=_nan_plan(3, 6, 1),
                  max_nonfinite=2)
    assert healed.rollbacks == 1 and healed.nonfinite_steps == [3]
    assert len(healed.metrics_history) == 8
    # poisoned twice each: the replay diverges again, the budget is spent
    with pytest.raises(DivergenceError, match="rollbacks used 1/1"):
        _run(tmp_path / "b", num_steps=8, fault_plan=_nan_plan(3, 8, 2), max_nonfinite=2)


def test_skipped_step_leaves_state_bit_identical(tmp_path):
    state, step, batch_at, put = _setup()
    poisoned = FaultPlan.single(DATA_NAN, at=0).wrap_batch_at(batch_at)(0)
    assert np.isnan(poisoned["tasks"].support_x).all()
    new, metrics = step(state, put(poisoned))
    assert metrics["nonfinite"].item() == 1.0 and _equal(new, state)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_transient_data_errors_retry_then_propagate(tmp_path, prefetch):
    ok = _run(tmp_path / "a", num_steps=3, prefetch=prefetch, data_backoff_s=0.0,
              fault_plan=FaultPlan.single(DATA_TRANSIENT, at=1, count=2))
    assert ok.data_retries == 2 and ok.step == 3
    with pytest.raises(TransientDataError):
        _run(tmp_path / "b", num_steps=3, prefetch=prefetch, data_backoff_s=0.0,
             fault_plan=FaultPlan.single(DATA_TRANSIENT, at=1, count=3))


def test_straggler_is_flagged_on_a_fake_clock(tmp_path):
    result = _run(tmp_path, fault_plan=FaultPlan.single(TRAIN_STRAGGLER, at=4, payload=5.0))
    assert result.straggler_steps == [4]
    assert result.throughput(T) > 0


def test_checkpoint_crc_keep_and_bf16(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    state = dict(w=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                 h=[torch.tensor([1.5, -2.25], dtype=torch.bfloat16)],
                 count=torch.tensor(3, dtype=torch.int32))
    for s in (1, 2, 3):
        ckpt.save(s, state)
    assert ckpt.all_steps() == [2, 3]
    step, back, _ = ckpt.restore_latest(state)
    assert step == 3 and _equal(back, state) and back["h"][0].dtype == torch.bfloat16
    npz = tmp_path / "step_0000000003" / "state.npz"
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["w"] = arrays["w"] + 1.0
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ChecksumError):
        ckpt.restore(3, state)


def test_launcher_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--episodic",
                          "--device", "cpu", "--steps", "2", "--tasks-per-step", "2",
                          "--image-size", "12", "--ckpt-dir", str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done at step 2; resumed_from=None" in out.stdout
    assert "kernel_backend=auto device=cpu" in out.stdout


def test_launcher_refusals(tmp_path):
    from repro_torch.launch.train import main
    # two shards in a world of one process: the mesh's message, naming torchrun
    with pytest.raises(ValueError, match=r"world has 1 rank.*--nproc-per-node 2"):
        main(["--episodic", "--device", "cpu", "--dp-shards", "2",
              "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["--arch", "no-such-arch", "--device", "cpu"])
    if not torch.cuda.is_available():             # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--episodic", "--ckpt-dir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--arch", "gemma2-2b", "--ckpt-dir", str(tmp_path)])   # the LM path
