"""The port's dry run (``repro_torch.launch.dryrun``) and
``roofline.load_table`` against the port's roofline and the JAX package's
``repro.launch.dryrun._analytic_state_bytes``.

* The smoke configs on a fake world of 4 as (data 2, model 2), one rank's
  sharded step traced on fake tensors: the payloads equal
  ``lm_step_payloads``, the state is ``mesh_state_bytes`` less the
  gradients, and the FLOPs are within ``SMOKE_FLOPS`` of
  ``mesh_step_flops`` (the analytic count leaves out the recomputed loss
  chunks and counts causal pairs where the plain attention computes every
  (query, key) score).
* deepseek-v2 ``train_4k`` at full config on ``single`` (256 fake ranks)
  against ``analyze_cell(..., mesh="single")``: payloads equal, state
  equal less the gradients, FLOPs within ``FULL_FLOPS`` of the mesh row's
  (the remat policy's recompute of every block, 4/3, the plain
  attention's masked half, the MoE capacity buffer's padding).
* The record's state against the reference's ``_analytic_state_bytes`` for
  one dense, one MoE and one SSM arch, computed in a subprocess on 256
  forced host devices through ``jax.eval_shape``, the rules' specs and
  ``sanitize`` (no lowering: the reference's dry run fails there on this
  toolchain).
* ``load_table`` on the records, resume, and the non-zero exit on a failed
  cell.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.roofline import (HBM_BYTES_PER_S, analyze_cell, format_markdown, load_table,
                                  lm_step_collective_s, lm_step_payloads, mesh_state_bytes,
                                  mesh_step_flops, model_flops)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_SHAPE = ShapeSpec("smoke", 32, 4, "train")
SMOKE_FLOPS = (1.0, 1.2)        # program over analytic, smoke configs on (2, 2)
FULL_FLOPS = (1.6, 1.8)         # deepseek-v2 train_4k on single
STATE_ARCHS = ("gemma2-2b", "deepseek-v2-236b", "mamba2-780m")


def _param_block_bytes(cfg, sizes) -> int:
    """One rank's bytes of the params alone (the gradients are their twin)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.roofline.analysis import _MeshShape
    from repro_torch.sharding.ctx import is_spec
    from repro_torch.sharding.place import block_shape
    from repro_torch.train.step import adamw_for, lm_state_specs
    whole, specs = lm_state_specs(cfg, adamw_for(cfg), _MeshShape(sizes))
    total = 0
    for t, s in zip(tree_leaves(whole["params"]), tree_leaves(specs["params"], is_leaf=is_spec)):
        n = 1
        for d in block_shape(t.shape, s, sizes):
            n *= d
        total += n * t.element_size()
    return total


@pytest.fixture(scope="module", autouse=True)
def _no_world_after_the_module():
    """The fake world ends with the module: a later test file in the same
    process reads the default group's world size."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def smoke_mesh():
    dryrun.fake_world(4)
    return M.make_mesh_for((2, 2), ("data", "model"))


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b", "kimi-k2-1t-a32b",
                                  "mamba2-780m", "zamba2-7b", "whisper-base"])
def test_smoke_step_on_a_fake_world_of_4(arch, smoke_mesh):
    cfg = get_smoke_config(arch)
    rec = dryrun.trace_step(cfg, SMOKE_SHAPE, smoke_mesh)
    sizes = smoke_mesh.shape
    assert rec["collectives"] == lm_step_payloads(cfg, sizes, 4, 32)
    assert rec["state_bytes_per_device"] == \
        mesh_state_bytes(cfg, sizes) - _param_block_bytes(cfg, sizes)
    bf16, f32 = mesh_step_flops(cfg, SMOKE_SHAPE, sizes)
    ratio = rec["flops_per_device"] / (bf16 + f32)
    assert SMOKE_FLOPS[0] <= ratio <= SMOKE_FLOPS[1], ratio
    assert sum(rec["flops_by_dtype"].values()) == rec["flops_per_device"]
    assert sum(rec["flops_by_op"].values()) == rec["flops_per_device"]
    # every group a step runs on is an axis of the mesh, or the host group
    assert all(w == (4 if k.endswith("/host") else 2)
               for k, w in rec["collective_widths"].items())
    assert rec["backend"] == "ref" and rec["bytes_per_device"] > 0
    assert rec["scalar_reads"] >= 1            # the finite check read as finite


def test_fake_world_keeps_the_world_it_is_in(smoke_mesh):
    import torch.distributed as dist
    dryrun.fake_world(4)                        # the same world: kept
    assert dist.get_world_size() == 4 and dist.get_backend() == "fake"


@pytest.fixture(scope="module")
def deepseek_record():
    rec = dryrun.run_cell("deepseek-v2-236b", "train_4k", "single",
                          clock=iter(range(0, 100, 7)).__next__)
    dryrun.fake_world(4)                        # leave the module's world as it was
    return rec


def test_production_cell_against_the_mesh_row(deepseek_record):
    rec = deepseek_record
    cfg, sizes = get_config("deepseek-v2-236b"), dict(data=16, model=16)
    row = analyze_cell("deepseek-v2-236b", "train_4k", "single")
    assert rec["status"] == "ok" and rec["chips"] == row["chips"] == 256
    assert rec["mesh_shape"] == sizes and rec["trace_s"] == 7
    assert rec["collectives"] == lm_step_payloads(cfg, sizes, 256, 4096)
    assert lm_step_collective_s(rec["collectives"], sizes) == row["t_collective"]
    assert rec["state_bytes_per_device"] == \
        row["state_bytes_per_device"] - _param_block_bytes(cfg, sizes)
    analytic = row["model_flops"] / row["chips"] / row["useful_ratio"]
    ratio = rec["flops_per_device"] / analytic
    assert FULL_FLOPS[0] <= ratio <= FULL_FLOPS[1], ratio
    assert rec["memory_analysis"] == dryrun.MEMORY_NOTE


REFERENCE_STATE = textwrap.dedent("""
    import json, sys
    import jax
    assert len(jax.devices()) == 256
    from repro.launch.dryrun import _analytic_state_bytes
    from repro.configs.registry import get_config
    from repro.launch.mesh import make_production_mesh
    from repro.sharding import rules
    from repro.train.step import adamw_for, make_init_state
    mesh = make_production_mesh()
    out = {}
    for arch in sys.argv[1:]:
        cfg = get_config(arch)
        state = jax.eval_shape(make_init_state(cfg, adamw_for(cfg)), jax.random.key(0))
        specs = rules.sanitize(dict(params=rules.param_specs(state["params"]),
                                    opt=rules.opt_state_specs(state["opt"])), state, mesh)
        out[arch] = _analytic_state_bytes(state, specs, mesh)
    print(json.dumps(out))
""")


def test_state_bytes_against_the_reference(deepseek_record):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.step import adamw_for, make_sharded_init_state
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    out = subprocess.run([sys.executable, "-c", REFERENCE_STATE, *STATE_ARCHS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    dryrun.fake_world(256)
    try:
        mesh = M.make_production_mesh()
        for arch in STATE_ARCHS:
            if arch == "deepseek-v2-236b":
                got = deepseek_record["state_bytes_per_device"]
            else:
                cfg = get_config(arch)
                init = make_sharded_init_state(cfg, adamw_for(cfg), mesh)
                with FakeTensorMode():
                    got = dryrun._state_bytes(init(torch.Generator(), "cpu"))
            assert got == want[arch], arch
    finally:
        dryrun.fake_world(4)


def test_load_table_reads_the_records(deepseek_record, tmp_path):
    path = tmp_path / "dryrun.json"
    skipped = dryrun.run_cell("deepseek-v2-236b", "prefill_32k", "single")
    assert skipped == dict(arch="deepseek-v2-236b", shape="prefill_32k", mesh="single",
                           chips=256, status="skipped", reason=dryrun.SERVING_SKIP)
    failed = dict(arch="gemma2-2b", shape="train_4k", mesh="single", status="fail", error="x")
    other = dict(deepseek_record, mesh="multi")
    dryrun.write_results(path, {"deepseek-v2-236b/train_4k/single": deepseek_record,
                                "deepseek-v2-236b/prefill_32k/single": skipped,
                                "gemma2-2b/train_4k/single": failed,
                                "deepseek-v2-236b/train_4k/multi": other})
    rows = load_table(path, "single")
    assert [r["shape"] for r in rows] == ["prefill_32k", "train_4k"]
    assert rows[0] == dict(arch="deepseek-v2-236b", shape="prefill_32k", mesh="single",
                           skipped=dryrun.SERVING_SKIP[:60])
    row, want = rows[1], analyze_cell("deepseek-v2-236b", "train_4k", "single")
    assert set(row) == set(want)
    cfg = get_config("deepseek-v2-236b")
    assert row["model_flops"] == model_flops(cfg, "train_4k")
    assert row["model_flops"] / 256 / row["useful_ratio"] == \
        pytest.approx(deepseek_record["flops_per_device"], rel=1e-12)
    assert row["t_collective"] == want["t_collective"]
    assert row["t_memory"] == deepseek_record["bytes_per_device"] / HBM_BYTES_PER_S
    assert row["state_bytes_per_device"] == deepseek_record["state_bytes_per_device"]
    table = format_markdown(rows)
    assert table.count("\n") == 3 and "| deepseek-v2-236b | train_4k |" in table
    assert len(load_table(path, "multi")) == 1


def _fake_cell(calls, fail=()):
    def run_cell(arch, shape, mesh, clock=None):
        calls.append((arch, shape, mesh))
        if arch in fail:
            raise RuntimeError(f"{arch} broke")
        return dict(arch=arch, shape=shape, mesh=mesh, chips=1, status="ok", trace_s=0.0,
                    flops_per_device=1, state_bytes_per_device=1)
    return run_cell


def test_sweep_resumes_and_exits_nonzero_on_a_failed_cell(tmp_path, monkeypatch, capsys):
    out = tmp_path / "d" / "dryrun.json"
    calls = []
    monkeypatch.setattr(dryrun, "run_cell", _fake_cell(calls, fail=("gemma2-2b",)))
    args = ["--arch", "gemma2-2b", "--shape", "train_4k", "--mesh", "single", "--out", str(out)]
    assert dryrun.main(args) == 1
    recs = json.loads(out.read_text())
    assert recs["gemma2-2b/train_4k/single"]["status"] == "fail"
    assert "gemma2-2b broke" in recs["gemma2-2b/train_4k/single"]["error"]
    assert not list(out.parent.glob("*.tmp"))
    # a failed cell is rerun; an ok or skipped one is kept unless --force
    monkeypatch.setattr(dryrun, "run_cell", _fake_cell(calls))
    assert dryrun.main(args) == 0
    assert dryrun.main(args) == 0
    assert calls == [("gemma2-2b", "train_4k", "single")] * 2
    assert dryrun.main(args + ["--force"]) == 0 and len(calls) == 3
    # long_500k: cell_supported refuses gemma2-2b, a skipped record
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "long_500k", "--mesh", "multi",
                        "--out", str(out)]) == 0
    assert json.loads(out.read_text())["gemma2-2b/long_500k/multi"]["status"] == "skipped"
    assert len(calls) == 3
    assert "[skip] gemma2-2b/long_500k/multi" in capsys.readouterr().out


def test_fake_world_refuses_a_real_default_group(tmp_path):
    code = textwrap.dedent(f"""
        import torch.distributed as dist
        from repro_torch.launch import dryrun
        dist.init_process_group("gloo", init_method="file://{tmp_path}/pg", rank=0,
                                world_size=1)
        try:
            dryrun.fake_world(4)
        except RuntimeError as e:
            print("refused:", e)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert "refused: the dry run makes its own fake world" in out.stdout, out.stderr[-2000:]


def test_production_mesh_builds_every_group_on_fake_worlds():
    for world, multi in ((256, False), (512, True)):
        dryrun.fake_world(world)
        mesh = M.make_production_mesh(multi_pod=multi)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        assert mesh.axis_names == axes and mesh.size == world
        assert set(mesh.groups) == set(axes) | ({("pod", "data")} if multi else set())
        assert mesh.host_group is not None
    dryrun.fake_world(4)
