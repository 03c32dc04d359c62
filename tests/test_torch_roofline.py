"""The port's analytical H100 roofline (``repro_torch.roofline``) and shape
registry against the JAX package's, on the CPU.

* ``param_counts`` (total, active, embed) equals the JAX package's for all
  ten archs at full config, and ``model_flops`` for all 40 (arch x shape)
  cells; ``SHAPES``, ``all_configs`` and ``cell_supported`` equal its own.
  All exact: both count the same tree (the port's abstract params have
  the reference's paths and shapes, ``test_torch_specs.py``).
* Every bound moved out of ``chip_smoke.py`` equals, at every argument set
  the script passes it (the configs at their cut depths, the phases'
  batches and lengths), the output of the parent commit's ``chip_smoke.py``
  function, recorded below as a literal, within a relative 1e-12 (pure
  arithmetic on configs; it came out bit-equal).  The training bounds that
  were written inline (phase 5f's mamba2 / zamba2 step, phase 6e's whisper
  step) are held against the inline expressions' outputs.  Each also agrees
  at its printed precision with the figure PERF.md records for it.
* ``analyze_cell`` has the reference's keys and MODEL_FLOPS; a decode_32k
  cell is bounded by memory and a train_4k cell by compute; long_500k is
  skipped but for the two sub-quadratic archs, with the reference's row;
  ``format_markdown`` prints the reference's table of the same rows.
  A dense cell charges each layer its window, and a dense decode step
  attention over its cache.
* ``state_bytes`` reproduces the state sizes PERF.md states.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.launch.specs import abstract_params_for as j_abstract_params_for
from repro.roofline import analysis as JA
from repro_torch import roofline as R
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ARCHS = treg.ARCH_IDS
CELLS = [(a, s.name) for a in ARCHS for s in tbase.SHAPES]
REL = 1e-12


def _cfg(arch, layers=None):
    cfg = treg.get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


# -- the shape registry -------------------------------------------------------

def test_shapes_equal_the_reference():
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.SHAPES]
    assert sorted(tbase.SHAPES_BY_NAME) == sorted(jbase.SHAPES_BY_NAME)


def test_all_configs_equal_the_reference():
    got, want = treg.all_configs(), jreg.all_configs()
    assert list(got) == list(want)
    for arch in got:
        for g, w in zip(got[arch], want[arch]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), arch


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_supported_equals_the_reference(arch, shape):
    assert treg.cell_supported(arch, shape) == jreg.cell_supported(arch, shape)


# -- parameter counts and MODEL_FLOPS --------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch):
    got = R.param_counts(treg.get_config(arch))
    want = JA.param_counts(jreg.get_config(arch))
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference_in_every_cell(arch):
    for s in tbase.SHAPES:
        assert R.model_flops(treg.get_config(arch), s.name) == \
            JA.model_flops(jreg.get_config(arch), s.name), s.name


# -- the bounds moved out of chip_smoke.py ------------------------------------------

# the routes phase 5e's seeded batch keeps at deepseek-v2's capacity (of
# 2 x 2048 x 6), read from the script's output on the card (H100 80GB
# HBM3, torch 2.11.0+cu128); the routing is data-dependent, so the CPU
# cannot recount it
MOE_KEPT = 20712

# (label, function, arch, layers, args, the parent's output); the arguments
# are those the phases pass: 5d gemma2-2b B 2 x S 4608; 5e deepseek-v2 at 1
# layer, B 2 x S 2048, every route of the batch kept and the routes the
# card's run kept, the params of one layer; 5f mamba2-780m B 2 x S 4096
# and zamba2-7b at 12 layers B 2 x S 2048; 6b minitron-4b at 16 layers, prefills of 512 / 1024 / 2048, decode
# at 4 and 1 slots, position 1024; 6c kimi-k2 at 1 layer and deepseek-v2 at
# 2, prefill 1024, decode at 2 slots; 6d mamba2-780m and zamba2-7b, prefills
# of 1024 / 2048, decode at 4 / 2 slots; 6e whisper-base, prefills of 64 /
# 128, decode at 4 slots, position 96, training B 8 x S 448
PARENT = [
    ("5d", "pretrain_bound", "gemma2-2b", None, (2, 4608),
     (613.6058426820312, 125421194575872.0, 32614907904000.0)),
    ("5e", "moe_train_bound", "deepseek-v2-236b", 1, (2, 2048, 24576, 5020697600),
     (216.40323689673065, "operations", 8305929879552.0, 13936330014720.0,
      60248371200.0)),
    ("5e", "moe_train_bound", "deepseek-v2-236b", 1, (2, 2048, MOE_KEPT, 5020697600),
     (215.8501740204516, "operations", 7758950694912.0, 13936330014720.0,
      60248371200.0)),
    ("5f", "ssm_train_bound", "mamba2-780m", None, (2, 4096),
     (97.27777772302879, 39148761120768.0, 3865470566400.0)),
    ("5f", "ssm_train_bound", "zamba2-7b", 12, (2, 2048),
     (73.70794580004069, 30293134147584.0, 2886218022912.0)),
    ("6e", "whisper_train_bound", "whisper-base", None, (8, 448),
     (12.328189804882001, 3538637291520.0, 586263035904.0)),
    ("5f", "ssm_flops", "mamba2-780m", None, (4096,), 6524793520128.0),
    ("5f", "ssm_flops", "zamba2-7b", 12, (2048,), 5048855691264.0),
    ("6d", "ssm_flops", "mamba2-780m", None, (1024,), 1631198380032.0),
    ("6d", "ssm_flops", "mamba2-780m", None, (2048,), 3262396760064.0),
    ("6d", "ssm_flops", "zamba2-7b", None, (1024,), 16806830931968.0),
    ("6d", "ssm_flops", "zamba2-7b", None, (2048,), 33809082875904.0),
    ("6e", "whisper_fwd_flops", "whisper-base", None, (448,), 147443220480.0),
    ("6e", "whisper_fwd_flops", "whisper-base", None, (64,), 117411741696.0),
    ("6e", "whisper_fwd_flops", "whisper-base", None, (128,), 122291159040.0),
    ("6e", "whisper_fwd_flops", "whisper-base", None, (32,), 114990907392.0),
    ("6b", "lm_bounds", "minitron-4b", 16, (512, 1, 512),
     ((1.9907293611940298, "bytes"), (2.000745609552239, "bytes"))),
    ("6b", "lm_bounds", "minitron-4b", 16, (1024, 1, 1024),
     ((3.7538172609100102, "operations"), (2.0107618579104476, "bytes"))),
    ("6b", "lm_bounds", "minitron-4b", 16, (2048, 1, 2048),
     ((7.71449555944186, "operations"), (2.0307943546268654, "bytes"))),
    ("6b", "lm_bounds", "minitron-4b", 16, (1, 4, 1025),
     ((1.9907293611940298, "bytes"), (2.0709375999999997, "bytes"))),
    ("6b", "lm_bounds", "minitron-4b", 16, (1, 1, 1025),
     ((1.9907293611940298, "bytes"), (2.0107814208955226, "bytes"))),
    ("6c", "moe_bounds", "kimi-k2-1t-a32b", 1, (1024, 2, 1025),
     ((10.904329628656717, "bytes"), (10.906836136119404, "bytes"))),
    ("6c", "moe_bounds", "deepseek-v2-236b", 2, (1024, 2, 1025),
     ((5.055818736716418, "bytes"), (5.057228647164179, "bytes"))),
    ("6d", "ssm_bounds", "mamba2-780m", None, (1024, 1, 1024),
     ((1.6495001682831143, "operations"), (0.5593360047761194, "bytes"))),
    ("6d", "ssm_bounds", "mamba2-780m", None, (2048, 1, 2048),
     ((3.2988413007724975, "operations"), (0.5593360047761194, "bytes"))),
    ("6d", "ssm_bounds", "mamba2-780m", None, (1, 4, 1025),
     ((0.5136906698507463, "bytes"), (0.6962720095522388, "bytes"))),
    ("6d", "ssm_bounds", "zamba2-7b", None, (1024, 1, 1024),
     ((16.99399981091203, "operations"), (3.5622937217910446, "bytes"))),
    ("6d", "ssm_bounds", "zamba2-7b", None, (2048, 1, 2048),
     ((34.18535668041254, "operations"), (3.619261134328358, "bytes"))),
    ("6d", "ssm_bounds", "zamba2-7b", None, (1, 2, 1025),
     ((3.4290532871641792, "bytes"), (3.6956454208955223, "bytes"))),
    ("6e", "whisper_bounds", "whisper-base", None, (64, 1, 64),
     ((0.11877276809706774, "operations"), (0.055192071641791046, "bytes"))),
    ("6e", "whisper_bounds", "whisper-base", None, (128, 1, 128),
     ((0.12370645600808897, "operations"), (0.05542682746268657, "bytes"))),
    ("6e", "whisper_bounds", "whisper-base", None, (1, 4, 97),
     ((0.11396587395753285, "operations"), (0.07288679164179104, "bytes"))),
]

# attn_pairs at the (S, causal, window) of the kernel cases, and bound_ms
# at the peaks the cases pass (fp32, bf16, the fp32 default)
PARENT_PAIRS = [((8192, True, None), 33558528), ((8192, True, 4096), 25167872),
                ((1500, False, None), 2250000), ((4608, True, 4096), 10487808),
                ((4608, True, None), 10619136), ((256, True, None), 32896),
                ((100, False, 40), 8170), ((200, False, 50), 28675),
                ((130, True, 100), 8050), ((77, False, None), 5929)]
PARENT_BOUND_MS = [((1e9, 1e12, 67e12), (14.925373134328359, "operations")),
                   ((1e9, 1e12, 989e12), (1.0111223458038423, "operations")),
                   ((4e6, 1e6), (0.0011940298507462687, "bytes"))]


def _close(got, want):
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_close(g, w) for g, w in zip(got, want))
    if isinstance(want, str):
        return got == want
    return abs(got - want) <= REL * abs(want)


@pytest.mark.parametrize("phase,fn,arch,layers,args,want", PARENT,
                         ids=[f"{p[0]}-{p[1]}-{p[2]}-{p[3]}-{p[4]}" for p in PARENT])
def test_bound_equals_the_parent(phase, fn, arch, layers, args, want):
    got = getattr(R, fn)(_cfg(arch, layers), *args)
    assert _close(got, want), (got, want)


@pytest.mark.parametrize("args,want", PARENT_PAIRS)
def test_attn_pairs_equal_the_parent(args, want):
    assert R.attn_pairs(*args) == want


@pytest.mark.parametrize("args,want", PARENT_BOUND_MS)
def test_bound_ms_equals_the_parent(args, want):
    assert _close(R.bound_ms(*args), want)


def test_moe_train_bound_reads_one_layers_params():
    """Phase 5e passes the params of its one-layer config, as counted."""
    assert R.param_counts(_cfg("deepseek-v2-236b", 1))["total"] == 5020697600


# (the figure as PERF.md prints it, how it is printed, the call)
PERF_FIGURES = [
    ("0.614", lambda: f"{R.pretrain_bound(_cfg('gemma2-2b'), 2, 4608)[0] / 1e3:.3f}"),
    ("215.9", lambda: f"{R.moe_train_bound(_cfg('deepseek-v2-236b', 1), 2, 2048, MOE_KEPT,
                                           5020697600)[0]:.1f}"),
    ("3.75", lambda: f"{R.lm_bounds(_cfg('minitron-4b', 16), 1024, 1, 1024)[0][0]:.2f}"),
    ("2.07", lambda: f"{R.lm_bounds(_cfg('minitron-4b', 16), 1, 4, 1025)[1][0]:.2f}"),
    ("10.90", lambda: f"{R.moe_bounds(_cfg('kimi-k2-1t-a32b', 1), 1024, 2, 1025)[0][0]:.2f}"),
    ("10.91", lambda: f"{R.moe_bounds(_cfg('kimi-k2-1t-a32b', 1), 1024, 2, 1025)[1][0]:.2f}"),
    ("1.65", lambda: f"{R.ssm_bounds(_cfg('mamba2-780m'), 1024, 1, 1024)[0][0]:.2f}"),
    ("0.70", lambda: f"{R.ssm_bounds(_cfg('mamba2-780m'), 1, 4, 1025)[1][0]:.2f}"),
    ("16.99", lambda: f"{R.ssm_bounds(_cfg('zamba2-7b'), 1024, 1, 1024)[0][0]:.2f}"),
    ("3.70", lambda: f"{R.ssm_bounds(_cfg('zamba2-7b'), 1, 2, 1025)[1][0]:.2f}"),
    ("97.3", lambda: f"{R.ssm_train_bound(_cfg('mamba2-780m'), 2, 4096)[0]:.1f}"),
    ("0.119", lambda: f"{R.whisper_bounds(_cfg('whisper-base'), 64, 1, 64)[0][0]:.3f}"),
    ("0.124", lambda: f"{R.whisper_bounds(_cfg('whisper-base'), 128, 1, 128)[0][0]:.3f}"),
    ("0.073", lambda: f"{R.whisper_bounds(_cfg('whisper-base'), 1, 4, 97)[1][0]:.3f}"),
    ("12.33", lambda: f"{R.whisper_train_bound(_cfg('whisper-base'), 8, 448)[0]:.2f}"),
]


@pytest.mark.parametrize("want,printed", PERF_FIGURES, ids=[f[0] for f in PERF_FIGURES])
def test_bound_agrees_with_perf_md(want, printed):
    assert printed() == want


# -- training state ------------------------------------------------------------------

# PERF.md §2, "LM pretrain peak memory": the reckoned state in GB
STATE_GB = [("gemma2-2b", None, "float32", "float32", "41.8"),
            ("minitron-4b", None, "float32", "float32", "81.5"),
            ("minitron-4b", None, "int8", "float32", "51.3"),
            ("deepseek-v2-236b", 1, "bfloat16", "bfloat16", "40.2"),
            ("mamba2-780m", None, "float32", "float32", "12.5"),
            ("zamba2-7b", None, "float32", "float32", "90.0"),
            ("zamba2-7b", 12, "float32", "float32", "17.6")]


@pytest.mark.parametrize("arch,layers,state,param,want", STATE_GB)
def test_state_bytes_reproduce_perf_md(arch, layers, state, param, want):
    n = int(R.param_counts(_cfg(arch, layers))["total"])
    assert f"{R.state_bytes(n, state, param) / 1e9:.1f}" == want


def test_state_bytes_per_param():
    assert R.state_bytes(1000, "float32", "float32") == 16000
    assert R.state_bytes(1000, "bfloat16", "bfloat16") == 8000
    # int8 mu and nu: a byte a value and an fp32 scale a block of 128
    assert R.state_bytes(128, "int8", "float32") == 128 * 8 + 2 * (128 + 4)


def test_constants_are_the_data_sheets():
    assert (R.BF16_FLOPS, R.FP16_FLOPS, R.FP8_FLOPS, R.INT8_OPS, R.TF32_FLOPS,
            R.FP32_FLOPS) == (989e12, 989e12, 1979e12, 1979e12, 495e12, 67e12)
    assert (R.HBM_BYTES_PER_S, R.HBM_BYTES) == (3.35e12, 80e9)


# -- the cells ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    return R.cell_rows()


def test_cell_rows_cover_every_cell_once(rows):
    assert [(r["arch"], r["shape"]) for r in rows] == CELLS
    table = R.format_markdown(rows).splitlines()
    assert len(table) == 2 + len(CELLS)
    for arch, shape in CELLS:
        assert sum(line.startswith(f"| {arch} | {shape} |") for line in table) == 1


def test_format_markdown_is_the_references(rows):
    assert R.format_markdown(rows) == JA.format_markdown(rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_is_memory_bound_and_train_compute_bound(arch, rows):
    by = {(r["arch"], r["shape"]): r for r in rows}
    assert by[arch, "decode_32k"]["bottleneck"] == "memory"
    assert by[arch, "train_4k"]["bottleneck"] == "compute"
    long = by[arch, "long_500k"]
    if arch in ("mamba2-780m", "zamba2-7b"):
        assert "skipped" not in long and long["bottleneck"] == "memory"
    else:
        assert long == dict(arch=arch, shape="long_500k", mesh="single",
                            skipped=jreg.cell_supported(arch, "long_500k")[1][:60])


def test_cell_keys_and_ratios_are_the_references(rows):
    """The reference's analyze_cell on a dry-run record holding this cell's
    FLOPs and bytes gives the same keys, MODEL_FLOPS and useful ratio (its
    times are TPU v5e's and not compared)."""
    for r in rows:
        if "skipped" in r:
            continue
        cfg, shape = treg.get_config(r["arch"]), tbase.SHAPES_BY_NAME[r["shape"]]
        nbytes, bf16, f32 = R.analysis.cell_work(cfg, shape)
        rec = dict(status="ok", arch=r["arch"], shape=r["shape"], mesh="single", chips=1,
                   flops_per_device=bf16 + f32, bytes_per_device=nbytes, collectives={},
                   state_bytes_per_device=r["state_bytes_per_device"])
        want = JA.analyze_cell(rec)
        assert set(r) == set(want)
        assert r["model_flops"] == want["model_flops"]
        assert r["useful_ratio"] == want["useful_ratio"]
        assert r["t_collective"] == 0.0
        assert r["t_memory"] == nbytes / R.HBM_BYTES_PER_S
        assert r["t_compute"] == bf16 / R.BF16_FLOPS + f32 / R.FP32_FLOPS
        assert r["hbm_headroom_gib"] == (80e9 - r["state_bytes_per_device"]) / 2**30


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_state_is_the_reference_params_bytes(arch, rows):
    want = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(j_abstract_params_for(jreg.get_config(arch))))
    got = {(r["arch"], r["shape"]): r for r in rows}[arch, "prefill_32k"]
    assert got["state_bytes_per_device"] == want


def test_train_cells_reckon_the_training_state(rows):
    for r in rows:
        if r["shape"] == "train_4k":
            cfg = treg.get_config(r["arch"])
            n = int(R.param_counts(cfg)["total"])
            assert r["state_bytes_per_device"] == R.state_bytes(n, cfg.opt_state_dtype,
                                                                cfg.param_dtype)


DENSE = [a for a in ARCHS if treg.get_config(a).family == "transformer"
         and treg.get_config(a).moe is None]


def _windows(cfg):
    """Each layer's window, None for a global layer, from the config alone."""
    return [cfg.sliding_window if cfg.local_global and i % 2 == 0 else None
            for i in range(cfg.n_layers)]


def test_dense_prefill_counts_each_layers_window():
    """gemma2-2b's prefill_32k cell charges its 13 sliding-window layers the
    pairs within 4096 keys, not the full causal triangle."""
    cfg, shape = treg.get_config("gemma2-2b"), tbase.SHAPES_BY_NAME["prefill_32k"]
    a, s, b = cfg.attention, shape.seq_len, shape.global_batch
    w = cfg.sliding_window
    local = sum(x is not None for x in _windows(cfg))
    assert (local, w) == (13, 4096)
    full, windowed = s * (s + 1) // 2, w * (w + 1) // 2 + (s - w) * w
    got = R.analysis.cell_work(cfg, shape)[1]
    unwindowed = R.analysis.cell_work(dataclasses.replace(cfg, local_global=False), shape)[1]
    assert unwindowed - got == b * 4.0 * a.head_dim * a.n_heads * local * (full - windowed)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_counts_attention_over_the_cache(arch):
    """A dense decode step's FLOPs hold attention over the cache's keys and
    its bytes the cache's keys and values, each layer's at most its window,
    as the other families' decode steps do."""
    cfg, shape = treg.get_config(arch), tbase.SHAPES_BY_NAME["decode_32k"]
    a, b, k = cfg.attention, shape.global_batch, shape.seq_len
    keys = sum(k if w is None else min(k, w) for w in _windows(cfg))
    (db, df), (db0, df0) = (R.analysis.lm_work(cfg, 1, b, n)[1] for n in (k, 0))
    assert df - df0 == b * 4.0 * a.head_dim * a.n_heads * keys
    assert db - db0 == 2.0 * 2 * b * keys * a.n_kv_heads * a.head_dim
    assert R.analysis.cell_work(cfg, shape) == (db, df, 0.0)


def test_roofline_imports_no_model_code():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import sys; import repro_torch.roofline; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.models')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.strip() == "[]"


# -- the cells on the production LM mesh ----------------------------------------------

MESH_KINDS = {"single": dict(data=16, model=16), "multi": dict(pod=2, data=16, model=16)}


class _Stub:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture(scope="module")
def mesh_rows():
    return {m: R.cell_rows(m) for m in MESH_KINDS}


def test_single_card_rows_are_unchanged_by_the_mesh(rows):
    """``analyze_cell`` without a mesh is the one-card row it was (mesh
    "single", one chip, no collective time)."""
    for r in rows:
        if "skipped" not in r:
            assert (r["mesh"], r["chips"], r["t_collective"]) == ("single", 1, 0.0)
            assert r == R.analyze_cell(r["arch"], r["shape"])


def _block_bytes(state, specs, sizes) -> int:
    """Bytes of one chip's blocks of ``state`` under the reference's
    sanitized ``specs`` (each dim divided by its entry's axis sizes; the
    dry run's ``_analytic_state_bytes``, which is not imported here: that
    module sets process-wide XLA flags on import)."""
    from repro.sharding import rules as J
    total = 0
    flat_s = jax.tree.leaves(state)
    flat_p = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, J.P))
    for a, sp in zip(flat_s, flat_p):
        denom = 1
        for entry in sp:
            for name in (() if entry is None else entry if isinstance(entry, tuple)
                         else (entry,)):
                denom *= sizes[name]
        total += int(np.prod(a.shape)) // denom * np.dtype(a.dtype).itemsize
    return total


def _reference_tp_off(cfg, batch, sizes) -> bool:
    """The reference dry run's ``tp_off`` (``repro/launch/dryrun.py:114-
    135``), inline: that module sets process-wide XLA flags on import."""
    prod = 1
    for ax in ("pod", "data", "model"):
        if ax in sizes and batch % (prod * sizes[ax]) == 0:
            prod *= sizes[ax]
    return not cfg.tp_enabled and prod == int(np.prod(list(sizes.values())))


@pytest.mark.parametrize("mesh", list(MESH_KINDS))
def test_mesh_rows_state_is_the_rules_block_bytes(mesh, mesh_rows):
    """Each train row's state per chip is the sum of its blocks' bytes under
    the reference's sanitized rules, ``model`` stripped where the
    reference's ``tp_enabled=False`` rule strips it (whisper-base on
    ``single``): params and AdamW state (its int8 ``n`` scalars taken out:
    they are Python ints in the port) plus the gradients, blocks of the
    params.  Each prefill and decode row's is its fp32 params' blocks and
    its cache's (the reference's ``_analytic_state_bytes`` of both) under
    ``param_specs`` and ``cache_specs(cache, B, data)``; a prefill's cache
    holds its prompt's positions and a vision frontend's."""
    from repro.models.registry import get_api as j_get_api
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.sharding import rules as J
    from repro.train.step import make_init_state as j_init_state
    stub = _Stub(MESH_KINDS[mesh])
    chips = int(np.prod(list(MESH_KINDS[mesh].values())))
    for r in mesh_rows[mesh]:
        if "skipped" in r:
            assert r["shape"] == "long_500k", r
            continue
        cfg = jreg.get_config(r["arch"])
        shape = jbase.SHAPES_BY_NAME[r["shape"]]
        if r["shape"] != "train_4k":
            params = j_abstract_params_for(cfg)
            seq = shape.seq_len + (cfg.n_frontend_tokens if shape.kind == "prefill"
                                   and cfg.frontend is not None
                                   and cfg.family == "transformer" else 0)
            cache = jax.eval_shape(lambda: j_get_api(cfg).init_cache(cfg, shape.global_batch,
                                                                     seq))
            cache = {k: v for k, v in cache.items() if k != "len"}
            pspecs = J.sanitize(J.param_specs(params), params, stub)
            cspecs = J.sanitize(J.cache_specs(cache, shape.global_batch, stub.shape["data"]),
                                cache, stub)
            want = _block_bytes(params, pspecs, stub.shape) \
                + _block_bytes(cache, cspecs, stub.shape)
            assert r["state_bytes_per_device"] == want, (r["arch"], r["shape"])
            assert r["chips"] == chips and r["t_collective"] > 0
            assert set(r) == set(R.analyze_cell(r["arch"], r["shape"]))
            continue
        state = jax.eval_shape(j_init_state(cfg, JAdamW(state_dtype=cfg.opt_state_dtype)),
                               jax.random.key(0))
        specs = dict(params=J.param_specs(state["params"]),
                     opt=J.opt_state_specs(state["opt"]))
        if _reference_tp_off(cfg, shape.global_batch, stub.shape):
            specs = J.strip_axes(specs)
        specs = J.sanitize(specs, state, stub)
        want = _block_bytes(state, specs, stub.shape) \
            + _block_bytes(state["params"], specs["params"], stub.shape)
        ns = sum(1 for path, _ in jax.tree_util.tree_flatten_with_path(state["opt"])[0]
                 if getattr(path[-1], "key", None) == "n")
        assert r["state_bytes_per_device"] == want - 4 * ns, r["arch"]
        assert r["chips"] == chips and r["mesh"] == mesh
        assert r["t_collective"] > 0
        assert set(r) == set(R.analyze_cell(r["arch"], r["shape"]))


def test_serving_payloads_count_the_decode_merges():
    """A dense decode step's payloads are its prefill's (the same param
    gathers at the same rows) plus each layer's merge of the partial
    softmax over the ranks that split the cache's sequence: gemma2-2b's 4
    kv heads do not split over 16, so its B 128 rows go 8 a data rank and
    its sequence over model, (8 rows, 8 heads, 256 + 2) f32 a layer."""
    cfg = treg.get_config("gemma2-2b")
    sizes = MESH_KINDS["single"]
    pre = R.lm_serve_payloads(cfg, sizes, 128, 32768, "prefill")
    dec = R.lm_serve_payloads(cfg, sizes, 128, 32768, "decode")
    merge = cfg.n_layers * 8 * 8 * (256 + 2) * 4
    assert dec == dict(pre, **{"all_gather/model": pre["all_gather/model"] + merge})
    # the tied embedding is gathered once, for the embedding and the head
    d, v = cfg.d_model, cfg.vocab_padded
    assert pre["all_gather/data"] >= (v // 16) * (d // 16) * 4
    with pytest.raises(ValueError, match="kind="):
        R.lm_serve_payloads(cfg, sizes, 128, 32768, "train")


def test_serving_payloads_by_the_cache_layout():
    """phi-3-vision's 32 kv heads split over model: its decode gathers each
    layer's heads ((4 rows, 2 heads, 96) bf16 on ``multi``), with no merge;
    mamba2-780m's decode gathers each layer's conv outputs and y over model;
    deepseek-v2's MoE runs expert-parallel at prefill (a reduce-scatter over
    model a layer) and in its ``moe_serve_payloads``."""
    phi = treg.get_config("phi-3-vision-4.2b")
    sizes = MESH_KINDS["multi"]
    pre = R.lm_serve_payloads(phi, sizes, 128, 32768, "prefill")
    dec = R.lm_serve_payloads(phi, sizes, 128, 32768, "decode")
    a = phi.attention
    heads = phi.n_layers * 4 * (a.n_heads // 16) * a.head_dim * 2
    assert dec["all_gather/model"] - pre["all_gather/model"] == heads
    mamba = treg.get_config("mamba2-780m")
    pre = R.lm_serve_payloads(mamba, MESH_KINDS["single"], 128, 32768, "prefill")
    dec = R.lm_serve_payloads(mamba, MESH_KINDS["single"], 128, 32768, "decode")
    sc = mamba.ssm
    c = sc.d_inner(mamba.d_model) + 2 * sc.n_groups * sc.d_state
    assert dec["all_gather/model"] - pre["all_gather/model"] == \
        mamba.n_layers * 8 * (c + sc.d_inner(mamba.d_model)) // 16 * 2
    ds = treg.get_config("deepseek-v2-236b")
    got = R.lm_serve_payloads(ds, MESH_KINDS["single"], 32, 32768, "prefill")
    t_loc = 2 * 32768
    moe = R.moe_serve_payloads(ds, MESH_KINDS["single"], t_loc)
    assert moe == {"all_gather/model": 2 * t_loc * ds.d_model * 2 // 16,
                   "reduce_scatter/model": t_loc * ds.d_model * 2,
                   "all_reduce/data": 4, "all_reduce/model": 4}
    assert got["reduce_scatter/model"] == ds.n_layers * moe["reduce_scatter/model"]


def test_mesh_serve_flops_split_the_rows_and_the_experts():
    """A dense prefill's FLOPs a chip are the cell's over the data ranks
    (replicated over model); deepseek-v2's expert projections also split
    over model; long_500k's one row runs whole on every chip."""
    sizes = MESH_KINDS["single"]
    for arch in ("gemma2-2b", "deepseek-v2-236b"):
        cfg = treg.get_config(arch)
        shape = tbase.SHAPES_BY_NAME["prefill_32k"]
        bf16, f32 = R.mesh_serve_flops(cfg, shape, sizes)
        _, whole, _ = R.analysis.cell_work(cfg, shape)
        if cfg.moe is None:
            assert bf16 == whole / 16 and f32 == 0
        else:
            experts = 2.0 * cfg.n_layers * 32 * 32768 * cfg.moe.top_k * 3 * cfg.d_model \
                * cfg.moe.d_ff
            assert bf16 == pytest.approx((whole - experts) / 16 + experts / 256, rel=1e-12)
    cfg = treg.get_config("mamba2-780m")
    shape = tbase.SHAPES_BY_NAME["long_500k"]
    assert R.mesh_serve_flops(cfg, shape, sizes)[0] == R.analysis.cell_work(cfg, shape)[1]


def test_mesh_payloads_count_the_expert_parallel_layer():
    """One MoE layer's payloads at deepseek-v2's width on 16 x 16, 'hidden'
    layout, T_loc tokens: the reference body's gather of the (T_loc, D/m)
    block and reduce-scatter of the (T_loc, D) partial y, forward (twice:
    the remat's recompute) and their VJPs; the boundary pair; the router's
    gradient."""
    cfg = treg.get_config("deepseek-v2-236b")
    t, d, m = 4096, cfg.d_model, 16
    got = R.ep_layer_payloads(cfg, dict(data=16, model=16), t)
    x = t * d * 2
    assert got["reduce_scatter/model"] == 2 * x + x
    assert got["all_gather/model"] == 2 * (x // m) + x // m + 2 * (x // m) + x // m
    assert got["all_reduce/model"] == d * cfg.moe.n_experts * 2 + 2 * 4
    assert got["all_reduce/data"] == 2 * 4


# the backward kernels' work at the training steps' shapes, reckoned by hand:
# gemma2-2b's (B 2, S 4608, 8 / 4 heads of 256, bf16) local layers (window
# 4096: 4096 * 4097 / 2 + 512 * 4096 pairs a head) and global layers (4608 *
# 4609 / 2), 10 * 256 FLOPs a pair; bytes (4 * 2 * 4608 * (8 + 4) * 256) * 2
# + 4 * 2 * 8 * 4608.  mamba2-780m's SSD (G 1536, Q 256, P 64, N 128, fp32):
# a chunk reads 4 * (256 * 64 + 256 + 1 + 2 * 256 * 128) bytes of inputs, 4 *
# (256 * 64 + 64 * 128 + 1 + 256) of cotangents and writes the inputs' size
# again; 2 * 32896 * (3 * 128 + 2 * 64) + 4 * 256 * 64 * 128 FLOPs
@pytest.mark.parametrize("args,want", [
    ((2, 4608, 8, 4, 256, 2, True, 4096),
     (2 * 4 * 2 * 4608 * 12 * 256 + 4 * 2 * 8 * 4608,
      10.0 * 256 * 2 * 8 * (4096 * 4097 // 2 + 512 * 4096))),
    ((2, 4608, 8, 4, 256, 2, True, None),
     (2 * 4 * 2 * 4608 * 12 * 256 + 4 * 2 * 8 * 4608,
      10.0 * 256 * 2 * 8 * (4608 * 4609 // 2))),
    ((8, 1500, 8, 8, 64, 2, False, None),
     (2 * 4 * 8 * 1500 * 16 * 64 + 4 * 8 * 8 * 1500, 10.0 * 64 * 8 * 8 * 1500 * 1500)),
])
def test_flash_bwd_work_by_hand(args, want):
    assert R.flash_bwd_work(*args) == want


def test_ssd_bwd_work_by_hand():
    ins = 4 * (256 * 64 + 256 + 1 + 2 * 256 * 128)
    cots = 4 * (256 * 64 + 64 * 128 + 1 + 256)
    flops = 2.0 * 32896 * (3 * 128 + 2 * 64) + 4.0 * 256 * 64 * 128
    assert R.ssd_bwd_work(1536, 256, 64, 128, 4) == (1536 * (2 * ins + cots), 1536 * flops)
    # gy alone: no state term, gy's bytes only
    nbytes, f = R.ssd_bwd_work(1792, 256, 64, 64, 4, (True, False, False, False))
    assert nbytes == 1792 * (2 * 4 * (256 * 64 + 256 + 1 + 2 * 256 * 64) + 4 * 256 * 64)
    assert f == 1792 * 2.0 * 32896 * (3 * 64 + 2 * 64)
    # the bounds: bytes for the SSD (0.347 ms), operations for gemma2-2b's
    # attention (0.434 and 0.440 ms) at the data sheet's rates
    assert R.bound_ms(*R.ssd_bwd_work(1536, 256, 64, 128, 4), R.BF16_FLOPS)[1] == "bytes"
    ms, by = R.bound_ms(*R.flash_bwd_work(2, 4608, 8, 4, 256, 2, True, 4096), R.BF16_FLOPS)
    assert by == "operations" and abs(ms - 0.4344) < 1e-3
