"""The port's contract cells (``repro_torch.lint.contracts``, ``python -m
repro_torch.lint --contracts``) against the JAX package's
``repro.lint.contracts``.

* The pure checks on passing and failing toy data, and the counter's
  ``widths()``.
* All four cells on the CPU through the CLI (``replica_2x2`` and
  ``int8_ws`` on 4 gloo ranks in one launch): no finding, exit 0.
* Each planted violation makes the CLI exit 1 naming the cell's rule: a
  collective on the 4-rank host group inside the audited dispatch
  (``replica_2x2``) and ``serving_params`` handing out a dequantized fp32
  copy (``int8_ws``), both in one launch of 4 ranks; padding to the bucket
  plan turned off (``compile_flat``); ``dispatch.class_second_moment``
  swapped for an einsum that forms the per-example (T, B, F, F) tensor
  (``lite_outer``).
* Held against the reference on the same configurations: its
  ``cell_compile_flat()`` and ``cell_lite_outer()`` (no 4 devices needed)
  give no finding, and the JAX engine's ``(adapt_compiles,
  predict_compiles)`` on the port's ragged traffic is the port's, (2, 1).
* ``int8_ws`` runs Simple CNAPs at the reference's widths: at those widths
  ProtoNets' int8 backbone (7.9 kB) is smaller than one predict dispatch's
  partial products, so its ``weight_stationary`` payload is above
  ``training``'s (the roofline's figures, asserted here).
"""
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch import collectives
from repro_torch.lint import __main__ as lint_main
from repro_torch.lint import contracts as C

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


# ---------------------------------------------------------------- the pure checks

def test_counter_records_the_widest_group():
    c = collectives.CollectiveCounter()
    c.add("all_reduce", "serve", 8, 2)
    c.add("all_reduce", "serve", 8, 4)
    c.add("barrier", "host", 0, 4)
    c.add("all_gather", "serve", 4)
    assert c.widths() == {"all_reduce/serve": 4, "barrier/host": 4, "all_gather/serve": 1}
    assert c.payload() == {"all_reduce/serve": 16, "barrier/host": 0, "all_gather/serve": 4}
    assert c.snapshot() == {"all_reduce/serve": 2, "barrier/host": 1, "all_gather/serve": 1}
    c.reset()
    assert c.widths() == {} == c.payload()


def test_check_inter_group():
    assert C.check_inter_group({"all_reduce/serve": 2, "all_gather/serve": 2}, 2) == []
    bad = C.check_inter_group({"all_reduce/serve": 2, "all_reduce/host": 4}, 2)
    assert len(bad) == 1 and "all_reduce/host" in bad[0] and "inter-group" in bad[0]
    assert C.check_inter_group({"all_reduce/host": 4}, 4) == []


def test_check_payloads_and_ws_below_training():
    assert C.check_payloads({"a/serve": 4}, {"a/serve": 4}, "x") == []
    assert C.check_payloads({"a/serve": 4}, {"a/serve": 8}, "x")
    assert C.check_payloads({"a/serve": 4, "b/host": 4}, {"a/serve": 4}, "x")
    assert C.check_ws_below_training({"all_reduce/serve": 10}, {"all_gather/serve": 11}) == []
    assert C.check_ws_below_training({"all_reduce/serve": 11}, {"all_gather/serve": 11})


def test_check_compile_flat():
    assert C.check_compile_flat(dict(adapt_compiles=2, predict_compiles=1), 2) == []
    assert len(C.check_compile_flat(dict(adapt_compiles=4, predict_compiles=3), 2)) == 2
    assert len(C.check_compile_flat(dict(adapt_compiles=2, predict_compiles=2), 2)) == 1


def test_find_outer_tensors_and_largest():
    per_example = [("float32", (2, 16, 16, 16))]                   # lead 32
    per_class = [("float32", (2, 3, 16, 16)), ("float32", (2, 16, 16))]
    assert C.find_outer_tensors(per_example, 16, 6)
    assert C.find_outer_tensors(per_class, 16, 6) == []
    # non-square trailing dims and 2-D tensors are not outer blocks
    assert C.find_outer_tensors([("float32", (2, 16, 16, 8)), ("float32", (64, 16, 16)[1:])],
                                16, 6) == []
    # each distinct shape is reported once
    assert len(C.find_outer_tensors(per_example * 3, 16, 6)) == 1
    assert C.largest_outer(per_class + per_example, 16) == ("float32", (2, 16, 16, 16))
    assert C.largest_outer([("float32", (4, 4))], 16) is None


def _learner(kind, quant):
    from repro_torch.serve.quant_params import quantize_frozen
    learner, params = C._learner(kind, 3, (16, 32), 64, dict(conv_blocks=2, conv_width=16,
                                                              task_dim=32), "cpu")
    return learner, quantize_frozen(learner, params, quant)


def test_check_int8_residency():
    from repro_torch.serve.quant_params import (ServingWeights, dequantize_params, param_bytes,
                                                serving_params)
    _, sw = _learner("protonets", "int8")
    handed = C.handed_dtypes(serving_params(sw))
    assert "int8" in handed and "float32" in handed
    assert C.check_int8_residency(sw, param_bytes(sw), handed) == []
    # handed an fp32 copy
    bad = C.check_int8_residency(sw, param_bytes(sw), ["float32"])
    assert len(bad) == 1 and "no int8 leaf" in bad[0]
    # an fp32 frozen slice kept resident (the reference's eager dequantization)
    eager = ServingWeights(tree=dequantize_params(sw), quant_paths=sw.quant_paths,
                           frozen_roots=sw.frozen_roots, mode="none")
    bad = C.check_int8_residency(eager, param_bytes(eager), ["float32"])
    assert any("fp32 copy persists" in m for m in bad) and any("no int8" in m for m in bad)
    # no quantized leaf at all
    _, none = _learner("protonets", "none")
    assert "no quantized leaf" in C.check_int8_residency(none, param_bytes(none), [])[0]


@pytest.mark.parametrize("kind,ws_below", [("protonets", False), ("simple_cnaps", True)])
def test_int8_ws_learner_by_payload(kind, ws_below):
    """At the reference's widths (16, 32) and 2 lanes of 12 queries on 4
    ranks: ProtoNets' weight_stationary all-reduces 6144 B of partial
    products against 1976 B of gathered int8 weights under training;
    Simple CNAPs' training layout also gathers its fp32 set encoder and FiLM
    generator, and weight_stationary is below it."""
    from repro_torch.roofline import serving_payloads
    _, sw = _learner(kind, "int8")
    ws = serving_payloads(sw, "weight_stationary", 4, 2, 12)
    tr = serving_payloads(sw, "training", 4, 2, 12)
    assert ws == {"all_reduce/serve": 2 * 12 * 64 * 4}
    assert (C.check_ws_below_training(ws, tr) == []) == ws_below
    if kind == "protonets":
        assert tr == {"all_gather/serve": 1976}


def test_unknown_cell_and_missing_card():
    with pytest.raises(KeyError, match="unknown contract cell"):
        C.run_cells(["nope"], "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            C.run_cells(["compile_flat"], "cuda")


# ---------------------------------------------------------------- the cells on the CPU

def _cli(capsys, *extra):
    rc = lint_main.main(["--contracts", "--no-ast", "--device", "cpu", *extra])
    out = capsys.readouterr()
    return rc, out.out + out.err


def test_all_cells_pass_through_the_cli(capsys):
    rc, said = _cli(capsys)
    assert rc == 0, said
    assert said.strip() == ""


def test_lite_outer_budget_is_tight():
    """The port's widest (.., F, F) tensor is the per-class covariance, (T,
    C, F, F): its leading elements are exactly the budget."""
    size = C.LITE_OUTER_MINI
    shapes = C.lite_outer_shapes("cpu", size)
    assert C.largest_outer(shapes, size.feature_dim) == \
        ("float32", (size.tasks, size.way, size.feature_dim, size.feature_dim))
    assert C.find_outer_tensors(shapes, size.feature_dim, size.tasks * size.way) == []


# the rank prelude that plants both rank cells' violations: a host-group
# collective inside every weight-stationary partial sum (counted as
# all_reduce/host on the world's 4 ranks), and serving_params handing the
# dispatch every quantized leaf dequantized to fp32
PLANT = textwrap.dedent("""
    import dataclasses, sys
    from repro_torch.common.linear import KSlice
    from repro_torch.optim.quant import dequantize, is_quantized
    from repro_torch.serve import quant_params as qp
    from repro_torch.bridge import HWIO_TO_OIHW
    from repro_torch.lint import contracts

    sum_over_group = qp._sum_over_group

    def wide(mesh, axis, t):
        mesh.any_rank(False)
        return sum_over_group(mesh, axis, t)

    def fp32_copy(sw):
        def visit(path, leaf):
            if isinstance(leaf, KSlice) and is_quantized(leaf.local):
                return dataclasses.replace(leaf, local=dequantize(leaf.local))
            if is_quantized(leaf):
                w = dequantize(leaf)
                return w.permute(*HWIO_TO_OIHW).contiguous() if w.dim() == 4 else w
            return leaf
        return qp._walk(qp.serving_view(sw), visit)

    qp._sum_over_group = wide
    qp.serving_params = fp32_copy
    sys.exit(contracts.rank_main(sys.argv[1:]))
""")


def test_planted_rank_violations_are_caught(capsys, monkeypatch):
    monkeypatch.setattr(C, "worker_argv", lambda: [C.sys.executable, "-c", PLANT])
    rc, said = _cli(capsys, "--cells", "replica_2x2", "--cells", "int8_ws")
    assert rc == 1
    lines = said.splitlines()
    assert any("contract-replica" in l and "all_reduce/host ran on a group of 4" in l
               for l in lines), said
    assert any("contract-int8" in l and "no int8 leaf reaches the predict dispatch" in l
               for l in lines), said


def test_planted_unpadded_buckets_are_caught(capsys, monkeypatch):
    from repro_torch.serve import episodic
    monkeypatch.setattr(episodic, "bucket_for", lambda n, buckets: n)
    rc, said = _cli(capsys, "--cells", "compile_flat")
    assert rc == 1 and "contract-compile-flat" in said and "adapt_compiles=4" in said


def test_planted_per_example_outer_product_is_caught(capsys, monkeypatch):
    from repro_torch.kernels import dispatch

    def per_example(f, weights, accum_dtype=None, backend=None):
        outer = torch.einsum("tbi,tbj->tbij", f, f)                # (T, B, F, F)
        return torch.einsum("tbc,tbij->tcij", weights.to(f.dtype), outer)

    monkeypatch.setattr(dispatch, "class_second_moment", per_example)
    rc, said = _cli(capsys, "--cells", "lite_outer")
    assert rc == 1 and "contract-lite-outer" in said and "[2, 8, 16, 16]" in said


# ---------------------------------------------------------------- against the reference

def test_reference_cells_pass_on_the_same_configurations():
    from repro.lint import contracts as J
    assert J.cell_compile_flat() == []
    assert J.cell_lite_outer() == []


def test_reference_engine_compiles_as_the_port_on_its_traffic():
    """The JAX engine over the port's ``compile_flat`` traffic (the same
    host tasks, NHWC) compiles (2, 1), as the port's engine does."""
    from repro.core.lite import LiteSpec as JLite
    from repro.core.meta_learners import MetaLearnerConfig as JCfg
    from repro.core.meta_learners import make_learner as j_make
    from repro.core.set_encoder import SetEncoderConfig as JSet
    from repro.data.episodic import plan_buckets as j_plan
    from repro.models.conv_backbone import ConvBackboneConfig as JBB
    from repro.models.conv_backbone import make_conv_backbone as j_bb
    from repro.serve.episodic import EpisodicRequest as JReq
    from repro.serve.episodic import EpisodicServeEngine as JEngine
    from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import plan_buckets
    from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
    way = 3
    jl = j_make(JCfg(kind="protonets", way=way), j_bb(JBB(widths=(8,), feature_dim=16)),
                JSet(kind="conv", conv_blocks=1, conv_width=8, task_dim=16))
    buckets = j_plan([way * s for s in C.COMPILE_FLAT_SHOTS[0]], max_buckets=2)
    assert buckets == plan_buckets([way * s for s in C.COMPILE_FLAT_SHOTS[0]], max_buckets=2)
    jeng = JEngine(jl, jl.init(jax.random.key(0)), lite=JLite(exact=True, chunk_size=8),
                   n_slots=1, query_chunk=8, support_buckets=buckets, cache_capacity=16)
    tl, tp = C._learner("protonets", way, (8,), 16, dict(conv_blocks=1, conv_width=8,
                                                         task_dim=16), "cpu")
    teng = EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8), n_slots=1,
                               query_chunk=8, support_buckets=buckets, cache_capacity=16,
                               device="cpu")
    uid = 0
    for shots in C.COMPILE_FLAT_SHOTS:
        for shot in shots:
            b = host_task_batch_at(uid, HostEpisodicConfig(way=way, shot=shot,
                                                           query_per_class=4, image_size=8),
                                   1, 0)
            args = dict(uid=uid, support_x=b.support_x[0], support_y=b.support_y[0],
                        query_x=b.query_x[0], way=way)
            jeng.submit(JReq(**args))
            teng.submit(EpisodicRequest(**args))
            uid += 1
        while jeng.busy:
            jeng.step()
        while teng.busy:
            teng.step()
    jst, tst = jeng.stats(), teng.stats()
    assert (jst["adapt_compiles"], jst["predict_compiles"]) == (2, 1)
    assert (tst["adapt_compiles"], tst["predict_compiles"]) == (2, 1)
    assert np.isfinite(np.asarray(tst["tasks_adapted"]))
