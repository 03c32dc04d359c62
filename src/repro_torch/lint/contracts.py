"""Structural contracts on the port's running program, the counterpart of
the JAX package's ``repro/lint/contracts.py``.

The JAX package compiles four miniature programs and reads their
post-SPMD HLO.  The port has no compiled program: each cell runs the same
miniature (the reference's widths, way, shot and image size; tasks from
the numpy host sampler) and reads what the program did: the collectives
counter (:mod:`repro_torch.launch.collectives`: payloads, and the widest
group each ``kind/axis`` ran on), the tree a dispatch is handed, the
engine's compile counters, and every floating tensor an op returned or
autograd saved.  Each budget is the port's own roofline
(:mod:`repro_torch.roofline`), not the JAX package's benchmark CSVs.

``replica_2x2``   one weight-stationary predict dispatch of ProtoNets on
                  each replica group of ``make_replica_mesh(2, 2)``: no
                  ``kind/axis`` ran on a group wider than the serve group's
                  2 ranks, and the payloads equal
                  ``roofline.serving_payloads``.
``int8_ws``       the int8 ProtoNets of widths (16, 32) on a serve group of
                  4 ranks: the ``weight_stationary`` predict payload is
                  strictly below ``training``'s, each equals
                  ``serving_payloads``, and the frozen slice stays int8:
                  every quantized leaf's ``q`` is ``torch.int8``, its
                  resident bytes are at least 3x below fp32, and the
                  dispatch is handed int8 leaves (no fp32 copy of them).
``compile_flat``  a two-bucket ragged engine over two waves of fresh uids:
                  ``adapt_compiles == len(buckets)`` and
                  ``predict_compiles == 1``.
``lite_outer``    Simple CNAPs under a ``LiteSpec``, through ``adapt_batch``
                  and ``meta_loss`` with its backward: no floating (.., F,
                  F) tensor that an op returns or autograd saves has more
                  than ``tasks * way`` leading elements.

The ``lite_outer`` budget is ``tasks * way``, one per-class covariance a
tensor: the port forms the class and task covariances as separate tensors
((T, C, F, F) and (T, F, F)), where XLA stacks the pair into one (T, 2, C,
F, F) tensor and the JAX package's budget is ``2 * tasks * way`` for that.
A per-example (T, B, F, F) outer product is over either budget at any
chunk wider than the way.

The pure ``check_*`` helpers take data (stats, widths, recorded shapes),
so tests drive their pass and fail paths without running a program.  The
``cell_*`` functions run the programs: ``compile_flat`` and ``lite_outer``
in this process, ``replica_2x2`` and ``int8_ws`` on the 4 ranks of one
``torch.distributed`` world, which :func:`run_cells` starts as gloo
processes (:func:`repro_torch.launch.local_ranks.run_ranks`), as the JAX
package's CLI re-executes itself on 4 host devices.  On ``cuda`` every
rank shares the card and turns TF32 off itself.

    PYTHONPATH=src python -m repro_torch.lint --contracts --device cpu
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import shutil
import sys
import tempfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.lint.engine import Finding

RANK_CELLS = ("replica_2x2", "int8_ws")
WORLD = 4
RANK_TIMEOUT = 400.0
CELL_RULES = {
    "replica_2x2": "contract-replica",
    "int8_ws": "contract-int8",
    "compile_flat": "contract-compile-flat",
    "lite_outer": "contract-lite-outer",
}
INT8_RESIDENCY = 3          # the frozen slice's resident bytes at least this far below fp32


# ---------------------------------------------------------------- pure checks

def check_inter_group(widths: Dict[str, int], group_size: int) -> List[str]:
    """No ``kind/axis`` may have run on a group wider than one replica
    group: a wider one means weights or state crossed groups."""
    return [f"{key} ran on a group of {w} ranks but the replica group is {group_size} "
            f"wide: an inter-group collective breaks replica isolation"
            for key, w in sorted(widths.items()) if w > group_size]


def check_payloads(got: Dict[str, int], want: Dict[str, int], label: str) -> List[str]:
    """The payloads a dispatch handed its collectives must equal the
    roofline's, ``kind/axis`` for ``kind/axis``."""
    if got == want:
        return []
    return [f"{label}: payloads {dict(sorted(got.items()))} differ from "
            f"roofline.serving_payloads {dict(sorted(want.items()))}"]


def check_ws_below_training(ws: Dict[str, int], training: Dict[str, int]) -> List[str]:
    a, b = sum(ws.values()), sum(training.values())
    if a < b:
        return []
    return [f"weight_stationary payload {a} B is not strictly below the training "
            f"layout's {b} B: the layout's reason to exist (move activations, not "
            f"gathered weights) no longer holds"]


def check_compile_flat(stats: Dict, n_buckets: int) -> List[str]:
    """Compile counters track the bucket plan, not the traffic."""
    out = []
    if stats["adapt_compiles"] != n_buckets:
        out.append(f"adapt_compiles={stats['adapt_compiles']} after ragged traffic over "
                   f"{n_buckets} bucket(s): expected exactly {n_buckets}, one shape a "
                   f"planned bucket, flat across waves")
    if stats["predict_compiles"] != 1:
        out.append(f"predict_compiles={stats['predict_compiles']}: the query dispatch "
                   f"must have one shape (chunks padded alike; the task state does not "
                   f"depend on the bucket)")
    return out


def find_outer_tensors(shapes: Iterable[Tuple[str, Sequence[int]]], feature_dim: int,
                       max_leading: int) -> List[str]:
    """The floating ``(dtype, shape)`` records shaped (.., F, F) with more
    than ``max_leading`` leading elements, each distinct one once."""
    out, seen = [], set()
    for dtype, shape in shapes:
        shape = tuple(int(d) for d in shape)
        if len(shape) < 3 or shape[-1] != feature_dim or shape[-2] != feature_dim:
            continue
        lead = math.prod(shape[:-2])
        if lead > max_leading and (dtype, shape) not in seen:
            seen.add((dtype, shape))
            out.append(f"{dtype}{list(shape)} ({lead} blocks of {feature_dim} x "
                       f"{feature_dim}; the per-class budget is {max_leading}): a "
                       f"per-example outer-product tensor escaped the LITE chunking")
    return out


def largest_outer(shapes: Iterable[Tuple[str, Sequence[int]]], feature_dim: int):
    """The recorded (.., F, F) shape with the most leading elements, or None."""
    best = None
    for dtype, shape in shapes:
        shape = tuple(int(d) for d in shape)
        if len(shape) >= 3 and shape[-2:] == (feature_dim, feature_dim):
            if best is None or math.prod(shape[:-2]) > math.prod(best[1][:-2]):
                best = (dtype, shape)
    return best


def check_int8_residency(sw, bytes_report: Dict, handed_dtypes: Iterable[str]) -> List[str]:
    """The int8 frozen slice stays int8: quantized leaves store ``q`` as
    int8, their resident bytes are at least :data:`INT8_RESIDENCY` x below
    fp32, and the predict dispatch is handed int8 leaves (``handed_dtypes``:
    the dtypes of the tree ``serving_params`` gave it), not an fp32 copy."""
    from repro_torch.optim.quant import is_quantized
    from repro_torch.serve.quant_params import _walk
    if not sw.quant_paths:
        return ["the serving weights hold no quantized leaf: the int8 cell was built "
                "without quantize_frozen(mode='int8')"]
    out = []
    if "int8" not in set(handed_dtypes):
        out.append("no int8 leaf reaches the predict dispatch: it is handed a "
                   "dequantized (fp32) copy of the frozen slice")
    bad = []

    def visit(path, leaf):
        if is_quantized(leaf) and leaf["q"].dtype != torch.int8:
            bad.append(f"{path} stores q as {leaf['q'].dtype}")
        return leaf

    _walk(sw.tree, visit)
    out += [f"quantized leaf {b}, not int8" for b in bad[:1]]
    froz, froz32 = bytes_report["frozen_resident_bytes"], bytes_report["frozen_fp32_bytes"]
    if froz * INT8_RESIDENCY > froz32:
        out.append(f"frozen slice resident bytes {froz} are not >= {INT8_RESIDENCY}x below "
                   f"their fp32 equivalent {froz32}: an fp32 copy persists beside the int8")
    return out


# ---------------------------------------------------------------- recording

def handed_dtypes(tree) -> List[str]:
    """The dtype of every tensor of a dispatch's params tree (a quantized
    leaf's ``q``, a K-slice's local part), as ``str(dtype)`` without
    ``torch.``."""
    from repro_torch.common.linear import KSlice
    from repro_torch.optim.quant import is_quantized
    from repro_torch.serve.quant_params import _walk
    out = []

    def visit(path, leaf):
        if isinstance(leaf, KSlice):
            leaf = leaf.local
        if is_quantized(leaf):
            leaf = leaf["q"]
        if isinstance(leaf, torch.Tensor):
            out.append(str(leaf.dtype).replace("torch.", ""))
        return leaf

    _walk(tree, visit)
    return out


class TensorRecorder(TorchDispatchMode):
    """Records the (dtype, shape) of every floating tensor an op returns
    (a kernel wrapper's ``torch.empty`` output included); with
    :meth:`saved` also of every tensor autograd keeps for a backward."""

    def __init__(self):
        super().__init__()
        self.shapes: List[Tuple[str, Tuple[int, ...]]] = []

    def _note(self, t) -> None:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            self.shapes.append((str(t.dtype).replace("torch.", ""), tuple(t.shape)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            self._note(t)
        return out

    def saved(self):
        """``saved_tensors_hooks`` that record what autograd saves."""
        def pack(t):
            self._note(t)
            return t
        return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


# ---------------------------------------------------------------- the miniatures

def _learner(kind: str, way: int, widths, feature_dim: int, set_kw: Dict, device):
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
    learner = make_learner(MetaLearnerConfig(kind=kind, way=way),
                           make_conv_backbone(ConvBackboneConfig(widths=widths,
                                                                 feature_dim=feature_dim)),
                           SetEncoderConfig(kind="conv", **set_kw))
    return learner, learner.init(torch.Generator().manual_seed(0), device)


def _tasks(seed: int, way: int, shot: int, query: int, image: int, tasks: int, device):
    from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at
    cfg = HostEpisodicConfig(way=way, shot=shot, query_per_class=query, image_size=image)
    return host_task_batch_at(seed, cfg, tasks, 0).to(device)


def _serving_params(sw):
    """The tree the predict dispatch is handed (looked up on the module at
    each call, so a replaced ``serving_params`` is the one recorded)."""
    from repro_torch.serve import quant_params
    return quant_params.serving_params(sw)


def _predict(learner, sw, states, qx, backend: str):
    """One predict dispatch on placed weights: (logits, handed dtypes)."""
    from repro_torch.kernels import dispatch
    with dispatch.use_backend(backend):
        tree = _serving_params(sw)
        return learner.predict_batch(tree, states, qx), handed_dtypes(tree)


def _note(report: Optional[Dict], name: str, **reading) -> None:
    if report is not None:
        report[name] = reading


def cell_replica_2x2(device, report: Optional[Dict] = None) -> List[str]:
    """Needs a world of 4 ranks (:func:`run_cells` starts it).  Every
    replica group runs one weight-stationary predict dispatch on its own
    placed weights; the counter is reset around it on every rank."""
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.roofline import serving_payloads
    from repro_torch.serve.quant_params import (dequantize_params, place_serving_weights,
                                                quantize_frozen)
    way, shot, query, image = 5, 4, 4, 12
    learner, params = _learner("protonets", way, (8,), 16,
                               dict(conv_blocks=1, conv_width=8, task_dim=16), device)
    batch = _tasks(0, way, shot, query, image, 2, device)
    backend = dispatch.resolve_backend(None, torch.device(device))
    mesh = make_replica_mesh(2, 2)
    sw = quantize_frozen(learner, params, "none")
    with dispatch.use_backend(backend):
        states = learner.adapt_batch(dequantize_params(sw), batch,
                                     LiteSpec(exact=True, chunk_size=32))
    placed = place_serving_weights(sw, mesh, "weight_stationary")
    collectives.counter.reset()
    _predict(learner, placed, states, batch.query_x, backend)
    lanes, rows = batch.query_x.shape[:2]
    widths, got = collectives.counter.widths(), collectives.counter.payload()
    want = serving_payloads(sw, "weight_stationary", 2, lanes, rows)
    _note(report, "replica_2x2", widths=widths, payload=got, want_payload=want)
    return check_inter_group(widths, 2) + check_payloads(
        got, want, "replica_2x2 weight_stationary predict")


def cell_int8_ws(device, report: Optional[Dict] = None) -> List[str]:
    """Needs a world of 4 ranks: one serve group of all 4.  The learner is
    Simple CNAPs at the reference's widths and set encoder: ProtoNets' int8
    backbone at these widths (7.9 kB) is smaller than one predict
    dispatch's partial products, so its ``weight_stationary`` payload is
    above ``training``'s (6144 B against 1976 B), which says nothing of the
    layout at a serving size; Simple CNAPs' ``training`` layout also
    gathers its fp32 set encoder and FiLM generator."""
    from repro_torch.core.lite import LiteSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.roofline import serving_payloads
    from repro_torch.serve.quant_params import (dequantize_params, param_bytes,
                                                place_serving_weights, quantize_frozen)
    learner, params = _learner("simple_cnaps", 3, (16, 32), 64,
                               dict(conv_blocks=2, conv_width=16, task_dim=32), device)
    batch = _tasks(100, 3, 5, 4, 8, 2, device)
    backend = dispatch.resolve_backend(None, torch.device(device))
    mesh = make_replica_mesh(1, WORLD)
    sw = quantize_frozen(learner, params, "int8")
    with dispatch.use_backend(backend):
        states = learner.adapt_batch(dequantize_params(sw), batch,
                                     LiteSpec(exact=True, chunk_size=8))
    lanes, rows = batch.query_x.shape[:2]
    got, msgs, handed = {}, [], []
    for layout in ("weight_stationary", "training"):
        placed = place_serving_weights(sw, mesh, layout)
        collectives.counter.reset()
        _, dtypes = _predict(learner, placed, states, batch.query_x, backend)
        got[layout] = collectives.counter.payload()
        if layout == "weight_stationary":
            handed = dtypes
        msgs += check_payloads(got[layout], serving_payloads(sw, layout, WORLD, lanes, rows),
                               f"int8_ws {layout} predict")
    nbytes = param_bytes(sw)
    _note(report, "int8_ws", payload=got, handed=sorted(set(handed)), param_bytes=nbytes)
    msgs += check_ws_below_training(got["weight_stationary"], got["training"])
    return msgs + check_int8_residency(sw, nbytes, handed)


COMPILE_FLAT_SHOTS = ((2, 5), (1, 4))      # each wave's shots; all four fit the two buckets


def cell_compile_flat(device, report: Optional[Dict] = None) -> List[str]:
    """The reference's engine (ProtoNets, 3-way, one slot, query chunk 8,
    buckets planned from shots 2 and 5) over two waves of fresh uids; the
    second wave's shots (1 and 4) fall into the same two buckets, so the
    traffic has four support sizes and the plan two shapes."""
    from repro_torch.core.lite import LiteSpec
    from repro_torch.data.episodic import HostEpisodicConfig, host_task_batch_at, plan_buckets
    from repro_torch.serve.episodic import EpisodicRequest, EpisodicServeEngine
    way = 3
    learner, params = _learner("protonets", way, (8,), 16,
                               dict(conv_blocks=1, conv_width=8, task_dim=16), device)
    buckets = plan_buckets([way * s for s in COMPILE_FLAT_SHOTS[0]], max_buckets=2)
    engine = EpisodicServeEngine(learner, params, lite=LiteSpec(exact=True, chunk_size=8),
                                 n_slots=1, query_chunk=8, support_buckets=buckets,
                                 cache_capacity=16, device=device)
    uid = 0
    for shots in COMPILE_FLAT_SHOTS:
        for shot in shots:
            b = host_task_batch_at(uid, HostEpisodicConfig(way=way, shot=shot,
                                                           query_per_class=4, image_size=8),
                                   1, 0)
            engine.submit(EpisodicRequest(uid=uid, support_x=b.support_x[0],
                                          support_y=b.support_y[0], query_x=b.query_x[0],
                                          way=way))
            uid += 1
        while engine.busy:
            engine.step()
    stats = engine.stats()
    _note(report, "compile_flat", buckets=list(buckets),
          adapt_compiles=stats["adapt_compiles"], predict_compiles=stats["predict_compiles"])
    return check_compile_flat(stats, len(buckets))


@dataclasses.dataclass(frozen=True)
class LiteOuterSize:
    """A ``lite_outer`` configuration: the learner's widths and the task
    batch."""

    way: int
    tasks: int
    widths: Tuple[int, ...]
    feature_dim: int
    set_kw: Tuple[Tuple[str, int], ...]
    shot: int
    query: int
    image: int
    adapt_lite: Tuple[Tuple[str, object], ...]
    train_lite: Tuple[Tuple[str, object], ...]


# the reference's miniature; the same learner at phase 5's full width (the
# default Simple CNAPs: 256 features, 224 px, 8 tasks a step, LITE h 8)
LITE_OUTER_MINI = LiteOuterSize(
    way=3, tasks=2, widths=(8,), feature_dim=16,
    set_kw=(("conv_blocks", 1), ("conv_width", 8), ("task_dim", 16)), shot=5, query=4,
    image=8, adapt_lite=(("exact", True), ("chunk_size", 8)),
    train_lite=(("h", 4), ("chunk_size", 8)))
LITE_OUTER_FULL = LiteOuterSize(
    way=5, tasks=8, widths=(32, 64, 128, 256), feature_dim=256, set_kw=(), shot=10,
    query=6, image=224, adapt_lite=(("exact", True), ("chunk_size", 16)),
    train_lite=(("h", 8), ("chunk_size", 16)))


def lite_outer_shapes(device, size: LiteOuterSize = LITE_OUTER_MINI):
    """Run Simple CNAPs' ``adapt_batch`` and ``meta_loss`` with its backward
    under a :class:`TensorRecorder`; returns the recorded shapes."""
    from repro_torch.common.tree import tree_leaves, tree_rebuild
    from repro_torch.core.lite import LiteSpec, index_scores
    from repro_torch.core.meta_learners import MetaLearnerConfig, make_learner
    from repro_torch.core.set_encoder import SetEncoderConfig
    from repro_torch.kernels import dispatch
    from repro_torch.models.conv_backbone import ConvBackboneConfig, make_conv_backbone
    learner = make_learner(
        MetaLearnerConfig(kind="simple_cnaps", way=size.way),
        make_conv_backbone(ConvBackboneConfig(widths=size.widths,
                                              feature_dim=size.feature_dim)),
        SetEncoderConfig(kind="conv", **dict(size.set_kw)))
    params = learner.init(torch.Generator().manual_seed(0), device)
    batch = _tasks(10, size.way, size.shot, size.query, size.image, size.tasks, device)
    backend = dispatch.resolve_backend(None, torch.device(device))
    scores = index_scores(0, 0, range(size.tasks), batch.support_x.shape[1], device)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    rec = TensorRecorder()
    with dispatch.use_backend(backend), rec:
        learner.adapt_batch(params, batch, LiteSpec(**dict(size.adapt_lite)))
        with torch.enable_grad(), rec.saved():
            loss, _ = learner.meta_loss(tree_rebuild(params, live), batch, scores,
                                        LiteSpec(**dict(size.train_lite)))
            torch.autograd.grad(loss.mean(), live, allow_unused=True)
    return rec.shapes


def cell_lite_outer(device, report: Optional[Dict] = None,
                    size: LiteOuterSize = LITE_OUTER_MINI) -> List[str]:
    shapes = lite_outer_shapes(device, size)
    budget = size.tasks * size.way
    _note(report, "lite_outer", largest=largest_outer(shapes, size.feature_dim),
          budget=budget, feature_dim=size.feature_dim, recorded=len(shapes))
    return find_outer_tensors(shapes, size.feature_dim, budget)


CELLS: Dict[str, Callable] = {
    "replica_2x2": cell_replica_2x2,
    "int8_ws": cell_int8_ws,
    "compile_flat": cell_compile_flat,
    "lite_outer": cell_lite_outer,
}


# ---------------------------------------------------------------- running them

def worker_argv() -> List[str]:
    """The command each rank of the rank cells runs (:func:`rank_main`)."""
    return [sys.executable, "-m", "repro_torch.lint.contracts"]


def rank_main(argv: Optional[List[str]] = None) -> int:
    """One rank of the rank cells: ``<device> <out_dir> <cell>...``; writes
    its messages and readings by cell, and its kernel launches on
    ``cuda``, to ``out_dir/rank<r>.json``."""
    from repro_torch.launch.mesh import init_distributed
    argv = sys.argv[1:] if argv is None else argv
    device, out_dir, names = argv[0], pathlib.Path(argv[1]), argv[2:]
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(device, backend="gloo",
                           init_method=os.environ["RANKS_INIT_METHOD"])
    launches: Dict[str, int] = {}
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.launches.reset()
    report: Dict = {}
    out = {name: CELLS[name](dev, report) for name in names}
    if dev.type == "cuda":
        launches = _build.launches.snapshot()
    rank = int(os.environ["RANK"])
    (out_dir / f"rank{rank}.json").write_text(json.dumps(dict(messages=out, report=report,
                                                              launches=launches)))
    return 0


def _run_rank_cells(names: List[str], device: str, report: Dict) -> Dict[str, List[str]]:
    """The rank cells on :data:`WORLD` gloo ranks of this host, in one
    launch; a message is kept once however many ranks report it.  Rank
    0's readings go into ``report`` by cell, and every rank's kernel
    launches, summed, under ``rank_launches``."""
    from repro_torch.launch.local_ranks import run_ranks
    tmp = tempfile.mkdtemp(prefix="contracts_")
    try:
        src = str(pathlib.Path(__file__).resolve().parents[2])
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                                              if p))
        run_ranks(worker_argv() + [device, tmp] + names, WORLD, tmp, env=env,
                  timeout=RANK_TIMEOUT)
        out: Dict[str, List[str]] = {n: [] for n in names}
        launches = report.setdefault("rank_launches", {})
        for r in range(WORLD):
            got = json.loads((pathlib.Path(tmp) / f"rank{r}.json").read_text())
            for n in names:
                out[n] += [m for m in got["messages"][n] if m not in out[n]]
            if r == 0:
                report.update(got["report"])
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_cells(names: Optional[Sequence[str]] = None, device="cuda",
              lite_size: LiteOuterSize = LITE_OUTER_MINI,
              report: Optional[Dict] = None) -> List[Finding]:
    """The findings of the named cells (all four by default) on
    ``device``; the rank cells run in one launch of :data:`WORLD` ranks.
    ``report``, if given, receives each cell's readings by name and, under
    ``rank_launches``, the rank processes' kernel launches on ``cuda`` (the
    cells of this process count in ``kernels._build.launches``)."""
    names = list(names) if names else list(CELLS)
    unknown = set(names) - set(CELLS)
    if unknown:
        raise KeyError(f"unknown contract cell(s) {sorted(unknown)}; known: {sorted(CELLS)}")
    device = str(device)
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("device cuda: torch.cuda.is_available() is false; give "
                           "--device cpu to run the cells on the CPU")
    report = {} if report is None else report
    ranked = [n for n in names if n in RANK_CELLS]
    msgs = _run_rank_cells(ranked, device, report) if ranked else {}
    for name in names:
        if name == "lite_outer":
            msgs[name] = cell_lite_outer(device, report, lite_size)
        elif name not in RANK_CELLS:
            msgs[name] = CELLS[name](device, report)
    return [Finding(path=f"contracts/{name}", line=0, rule=CELL_RULES[name], message=m)
            for name in names for m in msgs[name]]


if __name__ == "__main__":
    sys.exit(rank_main())
