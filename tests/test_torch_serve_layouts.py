"""The serving layouts' rules, placement and chooser of the port
(``repro_torch.roofline.analysis``, ``repro_torch.serve.quant_params``)
against the JAX package's ``repro.roofline.analysis`` and
``repro.serve.quant_params``, and the serving launcher under ``torchrun``.

* The leaf rules: every leaf of the same Simple CNAPs params, fp32 and
  int8 (``quantize_frozen`` of each package), gets the split dim of the
  reference's ``_weight_leaf_spec`` under each layout on groups of 2 and 4,
  a port conv weight (OIHW) read through HWIO; batch operands get
  ``_batch_leaf_spec``'s.
* ``place_serving_weights``: the identity without a mesh or a layout,
  ``auto`` refused, and a rank's shard of an int8 product weight its rows
  of ``q`` and of ``scale`` alike (a stand-in mesh: placement reads only a
  mesh's shape and coordinates).
* The chooser's rows on a stand-in group of 2 in this process (its
  collectives count payloads as ``DPMesh``'s do and sum nothing; the rows
  read only the payloads): ``replicated`` 0 bytes, ``weight_stationary``
  above 0 and, for Simple CNAPs, below ``training``, the choice the least
  largest term, ties to the earlier layout; a dispatch's counted payloads equal
  ``serving_payloads`` for every learner kind.  tests/test_torch_replica.py
  runs the same chooser on gloo ranks.
* The launcher: ``torchrun`` with 4 gloo ranks, ``--replicas 2
  --serve-layout auto --serve-quant int8``.
"""
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.core.meta_learners import MetaLearnerConfig as JCfg
from repro.core.meta_learners import make_learner as j_make
from repro.core.set_encoder import SetEncoderConfig as JSetCfg
from repro.models.conv_backbone import ConvBackboneConfig as JBBCfg
from repro.models.conv_backbone import make_conv_backbone as j_bb
from repro.roofline.analysis import _batch_leaf_spec as j_batch_spec
from repro.roofline.analysis import _weight_leaf_spec as j_weight_spec
from repro.serve.quant_params import quantize_frozen as j_quantize_frozen
from repro_torch.bridge import OIHW_TO_HWIO, params_from_numpy
from repro_torch.core.episodic import stack_task_states
from repro_torch.core.lite import LiteSpec
from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
from repro_torch.core.set_encoder import SetEncoderConfig
from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
from repro_torch.launch import collectives
from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
from repro_torch.roofline import (SERVING_LAYOUTS, batch_shardings, choose_serving_layout,
                                  serving_payloads, serving_shardings, split_dim)
from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
from repro_torch.serve.quant_params import (_spec_paths, place_serving_weights,
                                            quantize_frozen, serving_params)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTHS, FDIM, IMG, WAY = (8, 16), 48, 12, 5
SET_KW = dict(conv_blocks=2, conv_width=8, task_dim=16)


def _models(kind="simple_cnaps"):
    jl = j_make(JCfg(kind=kind, way=WAY), j_bb(JBBCfg(widths=WIDTHS, feature_dim=FDIM)),
                JSetCfg(**SET_KW))
    tl = make_learner(MetaLearnerConfig(kind=kind, way=WAY),
                      make_conv_backbone(ConvBackboneConfig(widths=WIDTHS, feature_dim=FDIM)),
                      SetEncoderConfig(**SET_KW))
    jp = jl.init(jax.random.key(0))
    return jl, jp, tl, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_dims(tree, layout, n):
    """{path: split dim} of the reference's rule over a JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = tuple(j_weight_spec(leaf, layout, "serve", n))
        out[key] = split_dim(spec)
    return out


def _port_dims(tree, layout, n):
    """{path: split dim} of the port's rule, a conv weight's dim in HWIO."""
    specs = _spec_paths(serving_shardings(tree, n, layout))
    flat = _spec_paths(tree)
    out = {}
    for key, spec in specs.items():
        d = split_dim(spec)
        leaf = flat.get(key)
        if d is not None and torch.is_tensor(leaf) and leaf.dim() == 4 \
                and leaf.is_floating_point() and key.rsplit("/", 1)[-1] == "w":
            d = OIHW_TO_HWIO.index(d)             # OIHW dim -> HWIO dim
        out[key] = d
    return out


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("layout", SERVING_LAYOUTS)
def test_weight_leaf_rules_match_reference(layout, n, quant):
    jl, jp, tl, tp = _models()
    jt = j_quantize_frozen(jl, jp, quant).tree
    tt = quantize_frozen(tl, tp, quant).tree
    want = _jax_dims(jt, layout, n)
    got = _port_dims(tt, layout, n)
    assert set(got) == set(want)
    assert got == want
    assert any(d is not None for d in got.values()) == (layout != "replicated")


@pytest.mark.parametrize("layout", SERVING_LAYOUTS)
def test_batch_leaf_rules_match_reference(layout):
    shapes = [(4, 16, 12, 12, 3), (4, 16), (3, 8, 12, 12, 3), (), (6,)]
    for n in (1, 2, 4):
        got = batch_shardings([torch.zeros(s) for s in shapes], n, layout)
        want = [tuple(j_batch_spec(jax.ShapeDtypeStruct(s, np.float32), layout, "serve", n))
                for s in shapes]
        assert list(got) == want


def _stand_in(n, idx):
    return types.SimpleNamespace(shape={"replica": 1, "serve": n},
                                 axis_names=("replica", "serve"),
                                 coords={"replica": 0, "serve": idx})


def test_place_serving_weights_identity_and_auto_refusal():
    _, _, tl, tp = _models()
    sw = quantize_frozen(tl, tp, "int8")
    assert place_serving_weights(sw, None, "weight_stationary") is sw
    assert place_serving_weights(sw, _stand_in(2, 0), None) is sw
    assert place_serving_weights(sw, _stand_in(2, 0), "none") is sw
    with pytest.raises(ValueError, match="resolve serve_layout='auto'"):
        place_serving_weights(sw, _stand_in(2, 0), "auto")
    rep = place_serving_weights(sw, _stand_in(2, 1), "replicated")
    assert rep.splits == () and serving_params(rep) is not None


@pytest.mark.parametrize("n", [2, 4])
def test_int8_product_weight_splits_q_and_scale_on_the_same_rows(n):
    _, _, tl, tp = _models()
    sw = quantize_frozen(tl, tp, "int8")
    head = sw.tree["bb"]["head"]["w"]
    k = head["q"].shape[0]
    for idx in range(n):
        placed = place_serving_weights(sw, _stand_in(n, idx), "weight_stationary")
        local = placed.tree["bb"]["head"]["w"]
        rows = slice(idx * k // n, (idx + 1) * k // n)
        torch.testing.assert_close(local["q"], head["q"][rows], rtol=0, atol=0)
        torch.testing.assert_close(local["scale"], head["scale"][rows], rtol=0, atol=0)
        assert local["q"].is_contiguous() and local["n"] == head["n"]
        assert ("bb/head/w/q", 0, k) in placed.splits
        assert ("bb/head/w/scale", 0, k) in placed.splits
        # a conv weight stays whole under weight_stationary
        assert placed.tree["bb"]["blocks"][0]["w"]["q"].shape == \
            sw.tree["bb"]["blocks"][0]["w"]["q"].shape
        assert placed.products == sw.products


class _Group:
    """A serving group of ``n`` stand-in ranks in this process: its
    collectives count what ``DPMesh``'s hand the counter and return
    stand-in values (a payload is all the chooser reads)."""

    def __init__(self, n):
        self.shape = {"replica": 1, "serve": n}
        self.axis_names = ("replica", "serve")
        self.coords = {"replica": 0, "serve": 0}

    def all_reduce(self, t, axis):
        collectives.counter.add("all_reduce", axis, t.numel() * t.element_size())
        return t

    def all_gather(self, t, axis):
        collectives.counter.add("all_gather", axis, t.numel() * t.element_size())
        return [t] * self.shape[axis]


def _probe(kind, tl, tp):
    eng = EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8), n_slots=2,
                              query_chunk=4, support_buckets=(16,), kernel_backend="ref",
                              device="cpu", serve_quant="int8")
    b = host_task_batch_at(3, HostEpisodicConfig(way=WAY, shot=3, query_per_class=2,
                                                 image_size=IMG), 2, 0)
    eng.run_to_completion([EpisodicRequest(uid=u, support_x=b.support_x[u],
                                           support_y=b.support_y[u], query_x=b.query_x[u])
                           for u in range(2)])
    states = stack_task_states([eng.store.l1.peek(u) for u in range(2)])
    qx = torch.from_numpy(np.ascontiguousarray(b.query_x[:, :4]))
    return states, qx, b


@pytest.mark.parametrize("kind", ["protonets", "simple_cnaps"])
def test_chooser_rows_and_minimum_rule(kind):
    _, _, tl, tp = _models(kind)
    states, qx, _ = _probe(kind, tl, tp)
    sw = quantize_frozen(tl, tp, "int8")
    fn = lambda w, s, q: tl.predict_batch(serving_params(w), s, q)
    out = choose_serving_layout(fn, sw, (states, qx), _Group(2))
    rows = out["rows"]
    assert set(rows) == set(SERVING_LAYOUTS)
    assert rows["replicated"]["wire_bytes"] == 0 and rows["replicated"]["collective_count"] == 0
    assert rows["weight_stationary"]["wire_bytes"] > 0
    if kind == "simple_cnaps":
        # its set encoder and FiLM generator are fp32; a protonets backbone
        # this narrow is a few kB of int8, less than a dispatch's partial
        # products, so gathering it moves fewer bytes there
        assert rows["weight_stationary"]["wire_bytes"] < rows["training"]["wire_bytes"]
    best = min(r["score"] for r in rows.values())
    assert out["choice"] == next(lo for lo in SERVING_LAYOUTS if rows[lo]["score"] == best)
    for lo, r in rows.items():
        assert r["score"] == max(r["t_compute"], r["t_memory"], r["t_collective"])
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["payload"] == serving_payloads(sw, lo, 2, 2, 4)


@pytest.mark.parametrize("kind", ["protonets", "cnaps", "simple_cnaps", "fomaml",
                                  "finetuner"])
@pytest.mark.parametrize("layout", SERVING_LAYOUTS)
def test_dispatch_payloads_of_every_kind(kind, layout):
    """One engine step of 2 lanes (an adapt and a predict dispatch) on a
    stand-in group of 2 hands the collectives what ``serving_payloads``
    says; fomaml's split leaves are all gathered, none is a K-slice."""
    _, _, tl, tp = _models(kind)
    quant = "none" if kind == "fomaml" else "int8"
    eng = EpisodicServeEngine(tl, tp, lite=LiteSpec(exact=True, chunk_size=8), n_slots=2,
                              query_chunk=4, support_buckets=(16,), kernel_backend="ref",
                              device="cpu", serve_quant=quant, serve_layout=layout,
                              mesh=_Group(2))
    b = host_task_batch_at(3, HostEpisodicConfig(way=WAY, shot=3, query_per_class=2,
                                                 image_size=IMG), 2, 0)
    for u in range(2):
        eng.submit(EpisodicRequest(uid=u, support_x=b.support_x[u], support_y=b.support_y[u],
                                   query_x=b.query_x[u]))
    collectives.counter.reset()
    eng.step()
    assert (eng.adapt_dispatches, eng.predict_dispatches) == (1, 1)
    sw = quantize_frozen(tl, tp, quant)
    want = serving_payloads(sw, layout, 2, 2, 16, dispatch="adapt", way=WAY, chunk=8)
    for k, v in serving_payloads(sw, layout, 2, 2, 4).items():
        want[k] = want.get(k, 0) + v
    assert collectives.counter.payload() == want
    if kind == "fomaml" or layout != "weight_stationary":
        assert "all_reduce/serve" not in want
    else:
        assert want["all_reduce/serve"] > 0


def test_launcher_under_torchrun_replicas_and_auto_layout(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
                          "--episodic", "--device", "cpu", "--learner", "simple_cnaps",
                          "--serve-quant", "int8", "--replicas", "2", "--serve-layout",
                          "auto", "--requests", "8", "--shot", "3", "--image-size", "12",
                          "--warm-dir", str(tmp_path / "warm"), "--cache-capacity", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    said = out.stdout
    assert said.count("episodic serve: learner=simple_cnaps 8 requests") == 1   # rank 0
    assert "world=4" in said and "replicas: 2/2 live" in said
    picked = [l for l in said.splitlines() if "weights: quant=int8 layout=" in l]
    assert picked and picked[0].split("layout=")[1].split()[0] in SERVING_LAYOUTS
    for lo in SERVING_LAYOUTS:
        assert f"layout {lo}" in said
    assert "replica 0:" in said and "replica 1:" in said
    wrong = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", "3", "-m", "repro_torch.launch.serve",
                            "--episodic", "--device", "cpu", "--replicas", "2",
                            "--image-size", "12"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert wrong.returncode != 0
    assert "does not divide the world of 3 ranks" in wrong.stdout + wrong.stderr
