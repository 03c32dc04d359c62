"""The LM training entry points of the port on the CPU: the launcher's LM
path (``python -m repro_torch.launch.train`` without ``--episodic``), the
two example modules, and a JAX LM checkpoint carried on by the port.

* The launcher, gemma2-smoke at the JAX launcher test's sizes (batch 2,
  32 tokens, checkpoints every 4), 8 steps: exit 0; with its step-8
  checkpoint removed, a rerun resumes from step 4 and writes a step-8
  checkpoint bit-equal to the first (one thread each, so the CPU
  arithmetic is deterministic); a third run has nothing to do.
* ``repro_torch.examples.train_lm`` and ``serve_lm`` run at tiny sizes;
  ``scaled_100m`` is the JAX example's config field for field.
* A JAX LM train state (gemma2-smoke in fp32 compute, 2 jitted steps,
  fp32 or int8 AdamW state) saved by the JAX package's
  ``CheckpointManager`` restores in the port both ways, through
  ``bridge.lm_state_from_numpy`` and through the port's own manager, bit
  for bit, and the port's next step gives the JAX package's next-step
  loss and grad norm within 1e-5 relative (sums in other orders;
  test_torch_lm_train.py's tolerance), also when ``train()`` resumes from
  the checkpoint.
"""
import dataclasses
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.data.tokens import TokenPipeline as JPipe
from repro.data.tokens import TokenPipelineConfig as JPipeCfg
from repro.optim import AdamWConfig as JAdamW
from repro.train import step as JS
from repro.train.checkpoint import CheckpointManager as JCkpt
from repro_torch.bridge import lm_state_from_numpy
from repro_torch.common.tree import tree_paths
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.data.tokens import batch_to_device
from repro_torch.examples import serve_lm, train_lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as TS
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import train

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device",
                          "cpu", "--arch", "gemma2-2b", "--batch", "2", "--seq", "32",
                          "--ckpt-every", "4", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _state_npz(d, step):
    with np.load(pathlib.Path(d) / f"step_{step:010d}" / "state.npz") as f:
        return {k: f[k] for k in f.files}


def test_lm_launcher_runs_and_resumes_exactly(tmp_path):
    out = _launch("--steps", "8", "--ckpt-dir", str(tmp_path))
    assert "arch=gemma2-smoke devices=1 device=cpu" in out
    assert "done at step 8;" in out and "resumed_from=None" in out and "device=cpu" in out
    want = _state_npz(tmp_path, 8)
    shutil.rmtree(tmp_path / f"step_{8:010d}")            # back to the step-4 commit
    out = _launch("--steps", "8", "--ckpt-dir", str(tmp_path))
    assert "done at step 8;" in out and "resumed_from=4" in out
    got = _state_npz(tmp_path, 8)
    assert got.keys() == want.keys() and len(got) > 10
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert "nothing to do: checkpoint already at step 8" in _launch(
        "--steps", "8", "--ckpt-dir", str(tmp_path))


def test_lm_launcher_refuses_unported_families(tmp_path):
    """Whisper is ported, but its loss reads frames the token pipeline does
    not yield: the LM launcher refuses it by name before building any state
    (ROADMAP R6)."""
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="frontend_embeds.*R6"):
        main(["--arch", "whisper-base", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_examples_run(tmp_path, capsys):
    train_lm.main(["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=minitron-smoke layers=4 d_model=256 vocab=8192 device=cpu" in out
    assert "final loss:" in out
    serve_lm.main(["--requests", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving 2 requests on 3 slots (gemma2-smoke, transformer cache) device=cpu" in out
    assert out.count("-> [") == 2 and "all requests complete" in out
    spec = importlib.util.spec_from_file_location("jax_train_lm", ROOT / "examples" /
                                                  "train_lm.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    for arch in ("minitron-4b", "gemma2-2b"):
        assert dataclasses.asdict(train_lm.scaled_100m(arch)) == \
            dataclasses.asdict(jex.scaled_100m(arch))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_jax_checkpoint_trains_on_in_the_port(state_dtype, tmp_path):
    jc = dataclasses.replace(j_smoke("gemma2-2b"), compute_dtype="float32")
    tc = dataclasses.replace(t_smoke("gemma2-2b"), compute_dtype="float32")
    jadam, tadam = JAdamW(state_dtype=state_dtype), AdamWConfig(state_dtype=state_dtype)
    jinit = JS.make_init_state(jc, jadam)
    jstate = jinit(jax.random.key(0))
    jstep = jax.jit(JS.make_train_step(jc, jadam))
    pipe = JPipe(JPipeCfg(vocab=jc.vocab, seq_len=32, global_batch=2))
    jbatch = lambda s: {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}  # noqa: E731
    for s in range(2):
        jstate, _ = jstep(jstate, jbatch(s))
    JCkpt(tmp_path, keep=3).save(2, jstate)
    _, jm = jstep(jstate, jbatch(2))

    _, restored, _ = JCkpt(tmp_path).restore_latest(jax.eval_shape(jinit, jax.random.key(0)))
    bridged = lm_state_from_numpy(jax.tree.map(np.asarray, restored), "cpu")
    template = TS.make_init_state(tc, tadam)(torch.Generator().manual_seed(1), "cpu")
    step_no, mine, _ = CheckpointManager(tmp_path).restore_latest(template)
    assert step_no == 2 and int(mine["opt"]["count"]) == 2
    bridged_at, mine_at = tree_paths(bridged), tree_paths(mine)
    assert bridged_at.keys() == mine_at.keys()
    for k, a in bridged_at.items():
        b = mine_at[k]
        assert (a == b) if not torch.is_tensor(a) else (a.dtype == b.dtype and
                                                        torch.equal(a, b))

    _, tm = TS.make_train_step(tc, tadam)(bridged, batch_to_device(pipe.batch_at(2), "cpu"))
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= TOL * abs(float(jm[k]))
    result = train(template, TS.make_train_step(tc, tadam),
                   lambda s: batch_to_device(pipe.batch_at(s), "cpu"), 3,
                   ckpt=CheckpointManager(tmp_path), state_template=template)
    assert result.resumed_from == 2 and len(result.metrics_history) == 1
    assert result.metrics_history[0]["loss"] == float(tm["loss"])
