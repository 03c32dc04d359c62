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
from repro_torch.configs.registry import cell_supported
from repro_torch.roofline import (HBM_BYTES_PER_S, analyze_cell, collective_wire_bytes,
                                  format_markdown, lm_serve_payloads, load_table,
                                  lm_step_collective_s, lm_step_payloads, mesh_state_bytes,
                                  mesh_step_flops, model_flops)
from repro_torch.sharding.rules import tp_off_batch_axes

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_SHAPE = ShapeSpec("smoke", 32, 4, "train")
SMOKE_FLOPS = (1.0, 1.2)        # program over analytic, smoke configs on (2, 2)
FULL_FLOPS = (1.6, 1.8)         # deepseek-v2 train_4k on single
# gemma2-2b on single, program over analytic: prefill computes every (q, k)
# score of its 32768 positions where the row counts causal and windowed
# pairs; decode is the row's within its rounding
SERVE_FLOPS = {"prefill_32k": (1.0, 4.0), "decode_32k": (0.9, 1.3)}
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


@pytest.fixture(scope="module")
def deepseek_prefill():
    """deepseek-v2's prefill_32k on ``single`` under both variants."""
    recs = {v: dryrun.run_cell("deepseek-v2-236b", "prefill_32k", "single", variant=v)
            for v in dryrun.VARIANTS}
    dryrun.fake_world(4)
    return recs


def test_load_table_reads_the_records(deepseek_record, deepseek_prefill, tmp_path):
    path = tmp_path / "dryrun.json"
    served = deepseek_prefill["optimized"]
    assert served["status"] == "ok" and served["kind"] == "prefill"
    assert served["variant"] == "optimized" and served["chips"] == 256
    assert served["collectives"] == lm_serve_payloads(get_config("deepseek-v2-236b"),
                                                      dict(data=16, model=16), 32, 32768,
                                                      "prefill")
    reason = cell_supported("gemma2-2b", "long_500k")[1]
    skipped = dict(arch="gemma2-2b", shape="long_500k", mesh="single", status="skipped",
                   reason=reason)
    failed = dict(arch="gemma2-2b", shape="train_4k", mesh="single", status="fail", error="x")
    other = dict(deepseek_record, mesh="multi")
    dryrun.write_results(path, {"deepseek-v2-236b/train_4k/single": deepseek_record,
                                "deepseek-v2-236b/prefill_32k/single": served,
                                "gemma2-2b/long_500k/single": skipped,
                                "gemma2-2b/train_4k/single": failed,
                                "deepseek-v2-236b/train_4k/multi": other})
    rows = load_table(path, "single")
    assert [r["shape"] for r in rows] == ["prefill_32k", "train_4k", "long_500k"]
    assert rows[2] == dict(arch="gemma2-2b", shape="long_500k", mesh="single",
                           skipped=reason[:60])
    prow, pwant = rows[0], analyze_cell("deepseek-v2-236b", "prefill_32k", "single")
    assert set(prow) == set(pwant) and prow["t_collective"] == pwant["t_collective"]
    assert prow["state_bytes_per_device"] == pwant["state_bytes_per_device"] \
        == served["state_bytes_per_device"]
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
    assert table.count("\n") == 4 and "| deepseek-v2-236b | train_4k |" in table
    assert len(load_table(path, "multi")) == 1


def test_optimized_moe_dispatch_moves_a_third_of_the_baseline(deepseek_prefill):
    """The counterpart of the reference's guard on its MoE dispatch
    (``tests/test_distributed.py:142-159``): deepseek-v2's prefill_32k on
    ``single`` hands its collectives at least 3x fewer wire bytes under
    ``optimized`` (expert parallel) than under ``baseline`` (the MoE on
    the global tokens, every expert bank gathered over model)."""
    sizes = dict(data=16, model=16)
    wire = {v: collective_wire_bytes(r["collectives"], sizes)
            for v, r in deepseek_prefill.items()}
    assert wire["optimized"] * 3 < wire["baseline"], wire
    assert "reduce_scatter/model" in deepseek_prefill["optimized"]["collectives"]
    assert "reduce_scatter/model" not in deepseek_prefill["baseline"]["collectives"]


@pytest.fixture(scope="module")
def gemma_serving():
    recs = {s: dryrun.run_cell("gemma2-2b", s, "single") for s in ("prefill_32k", "decode_32k")}
    dryrun.fake_world(4)
    return recs


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cell_against_the_mesh_row(gemma_serving, shape):
    """gemma2-2b's prefill and decode at full config on ``single``: payloads
    equal ``lm_serve_payloads``, the state the mesh row's, FLOPs a chip
    within ``SERVE_FLOPS`` of the mesh row's (the plain attention computes
    every (query, key) score where the row counts causal and windowed
    pairs; decode reads the cache to ``len``)."""
    rec, cfg = gemma_serving[shape], get_config("gemma2-2b")
    sizes = dict(data=16, model=16)
    row = analyze_cell("gemma2-2b", shape, "single")
    b, s = rec["global_batch"], rec["seq_len"]
    assert rec["status"] == "ok" and rec["kind"] == shape.split("_")[0]
    assert rec["collectives"] == lm_serve_payloads(cfg, sizes, b, s, rec["kind"])
    assert lm_step_collective_s(rec["collectives"], sizes) == row["t_collective"]
    assert rec["state_bytes_per_device"] == row["state_bytes_per_device"]
    assert rec["cache_len"] == (s if rec["kind"] == "prefill" else s - 1)
    analytic = row["model_flops"] / row["chips"] / row["useful_ratio"]
    ratio = rec["flops_per_device"] / analytic
    assert SERVE_FLOPS[shape][0] <= ratio <= SERVE_FLOPS[shape][1], ratio
    widths = {k: w for k, w in rec["collective_widths"].items()}
    assert all(w in (16, 256) for w in widths.values()), widths


def test_whisper_train_single_is_pure_data_parallel():
    """whisper-base turns tensor parallelism off and its train_4k batch of
    256 covers the 256-chip mesh: one row a chip, ``model`` stripped from
    every spec, FLOPs a chip 1/16 of the 16-rows-a-chip trace (5.3242e13),
    and the mesh row agrees."""
    from repro_torch.sharding.ctx import entry_names, is_spec
    from repro_torch.train.step import adamw_for, lm_state_specs
    from repro_torch.common.tree import tree_leaves
    rec = dryrun.run_cell("whisper-base", "train_4k", "single")
    dryrun.fake_world(4)
    cfg, sizes = get_config("whisper-base"), dict(data=16, model=16)
    assert rec["batch_axes"] == ["data", "model"]
    assert abs(rec["flops_per_device"] / (5.3242e13 / 16) - 1) <= 0.10
    _, specs = lm_state_specs(cfg, adamw_for(cfg), _Sizes(sizes), ("data", "model"))
    assert not any("model" in entry_names(e) for sp in tree_leaves(specs, is_leaf=is_spec)
                   for e in sp)
    assert rec["collectives"] == lm_step_payloads(cfg, sizes, 256, 4096,
                                                  batch_axes=("data", "model"))
    assert not any(k.startswith("all_gather/model") for k in rec["collectives"])
    row = analyze_cell("whisper-base", "train_4k", "single")
    analytic = row["model_flops"] / row["chips"] / row["useful_ratio"]
    assert 1.0 <= rec["flops_per_device"] / analytic <= 1.6
    assert lm_step_collective_s(rec["collectives"], sizes) == row["t_collective"]
    # multi: 256 rows do not cover 512 chips; tensor parallelism stays on
    assert tp_off_batch_axes(cfg.tp_enabled, 256, dict(pod=2, data=16, model=16)) is None


class _Sizes:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b", "mamba2-780m", "zamba2-7b",
                                  "whisper-base"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smoke_serving_on_a_fake_world_of_4(arch, kind):
    """A smoke config's prefill (4 x 32 prompts) and decode (4 rows against
    a 32-deep cache) on a fake world of 4 as (data 2, model 2): payloads
    equal ``lm_serve_payloads``, the state the params' and cache's blocks.
    The mesh is built here: the module's fixture's groups end with the
    world that an earlier test's production cell left."""
    from repro_torch.roofline import serve_state_bytes
    dryrun.fake_world(4)
    smoke_mesh = M.make_mesh_for((2, 2), ("data", "model"))
    cfg = get_smoke_config(arch)
    shape = ShapeSpec(f"smoke_{kind}", 32, 4, kind)
    rec = dryrun.trace_serve(cfg, shape, smoke_mesh)
    assert rec["collectives"] == lm_serve_payloads(cfg, smoke_mesh.shape, 4, 32, kind)
    assert rec["state_bytes_per_device"] == serve_state_bytes(cfg, smoke_mesh.shape, 4, 32, kind)
    assert rec["flops_per_device"] > 0 and rec["backend"] == "ref"


def _fake_cell(calls, fail=()):
    def run_cell(arch, shape, mesh, clock=None, variant="optimized"):
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
        joint = {("pod", "data"), ("data", "model"), ("pod", "data", "model")} if multi \
            else {("data", "model")}
        assert set(mesh.groups) == set(axes) | joint
        assert mesh.host_group is not None
    dryrun.fake_world(4)
