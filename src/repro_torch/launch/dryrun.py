"""Dry run of the sharded LM train step, prefill and decode step on the
production mesh: one rank's step traced on fake tensors in a fake world of
256 (``single``: data 16 x model 16) or 512 (``multi``: pod 2 x data 16 x
model 16) ranks, the counterpart of the JAX package's
``repro/launch/dryrun.py``, which lowers and compiles each cell on 512
placeholder devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape prefill_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v2-236b --shape prefill_32k --mesh single --variant baseline

The port has no compiled program to read, so it runs the program: one
process joins ``torch.distributed``'s ``fake`` backend as rank 0 of the
world (every collective returns at once and moves nothing), builds the
mesh with :func:`repro_torch.launch.mesh.make_production_mesh`, and runs,
under ``FakeTensorMode``, which allocates nothing:

* a train cell: one :func:`repro_torch.train.step.make_train_step` step
  (``mesh=``) over :func:`repro_torch.train.step.make_sharded_init_state`'s
  state on the global batch of :func:`repro_torch.launch.specs.
  batch_specs_for`; a config with ``tp_enabled=False`` whose global batch
  covers the mesh (:func:`repro_torch.sharding.rules.tp_off_batch_axes`,
  the reference's rule) runs pure data parallel, the batch over those axes
  and ``model`` stripped from every spec (whisper-base's ``train_4k`` on
  ``single``, one row a chip);
* a prefill cell: ``api.prefill`` of the global batch under ``use_mesh``
  on fp32 params placed as :func:`repro_torch.sharding.place.
  lm_serve_layout` places them (:mod:`repro_torch.sharding.serve`);
* a decode cell: ``api.decode_step`` of one token a row on the same
  params and a cache of ``seq_len`` positions placed the same way, at
  ``len = seq_len - 1`` (the port's decode reads the positions up to
  ``len``; the reference's masked decode reads the whole cache).

``--variant`` is the reference's (``VARIANTS`` / ``apply_variant``):
``baseline`` turns ``moe_shard_map`` off (the MoE layers run on the global
tokens, :func:`repro_torch.models.moe.moe_ffn_global`), keeps tensor
parallelism and the activations' layout on ``model``; its
``attn_head_constraints=False`` has no effect here: it is a hint to GSPMD
where to lay out the heads, and eager code lays out every tensor itself.
The kernel backend is ``ref``: a hand-written kernel cannot run on a fake
tensor.  A cell's record holds what one rank of that step does:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count, the recomputed blocks (activation checkpoints: the loss chunks,
  a remat policy's blocks) included; ``flops_by_dtype`` the same counts by
  the dtype of each op's result, ``flops_by_op`` by op;
* ``bytes_per_device``: the bytes of every op's tensor operands and
  results, summed: the eager, unfused traffic, an upper bound on what a
  fused program moves, not a measurement;
* ``collectives``: the payload the step hands each ``kind/axis``
  (:mod:`repro_torch.launch.collectives`), with ``collective_calls`` and
  ``collective_widths``;
* ``state_bytes_per_device``: a train cell's params and AdamW state, the
  JAX package's ``_analytic_state_bytes`` (no gradients); a prefill or
  decode cell's params and cache (``cache_bytes_per_device``: the cache
  decode reads, or prefill writes);
* ``trace_s``: the trace's seconds on the injectable ``clock``.

The JAX record's ``memory_analysis`` has no counterpart: fake tensors
allocate nothing, so the record says so in ``memory_analysis`` and holds no
figure.  Two reads of data have no data to read on fake tensors and take
the value a healthy step gives them: a scalar read (``.item()``, ``bool``:
the step's finite check) reads as true, or 0 for a number; and
``torch.bincount`` of expert ids gives ``minlength`` counts, since every id
lies below the expert count.

Records are keyed ``arch/shape/mesh`` in one JSON file (default
``build/dryrun.json``), each written as a tmp file then ``os.replace``, so
an interrupted sweep resumes where it stopped (``--force`` reruns what is
there); a cell that fails is recorded and rerun next time, and the command
exits 1.  :func:`repro_torch.roofline.analysis.load_table` reads the
records.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, all_configs, cell_supported

DEFAULT_OUT = pathlib.Path("build/dryrun.json")
MESH_WORLDS = {"single": 256, "multi": 512}
VARIANTS = {
    # the reference's GSPMD-only lowering, the baseline of its perf section
    "baseline": dict(moe_shard_map=False, attn_head_constraints=False, tp_enabled=True),
    # production defaults
    "optimized": dict(),
}
MEMORY_NOTE = "no counterpart: fake tensors allocate nothing"
FLOPS_NOTE = "FlopCounterMode over one rank's traced step, recomputed blocks included"
BYTES_NOTE = "eager unfused traffic: every op's tensor operands and results"


class StepTrace(TorchDispatchMode):
    """Sums the bytes of every op's tensor operands and results, the FLOPs
    of each op FlopCounterMode counts by the dtype of its result, and
    answers the reads of data that fake tensors cannot give (the module
    docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.scalar_reads = 0
        self.flops_by_dtype: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        aten = torch.ops.aten
        if func is aten._local_scalar_dense.default:
            self.scalar_reads += 1
            t = args[0]
            return True if t.dtype == torch.bool else (0.0 if t.is_floating_point() else 0)
        if func is aten.bincount.default:
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            out = torch.zeros(n, dtype=torch.int64, device=args[0].device)
        else:
            out = func(*args, **kwargs)
        self.ops += 1
        results = _tensors(out, [])
        self.bytes += sum(t.numel() * t.element_size()
                          for t in _tensors((args, kwargs), results[:]))
        packet = func._overloadpacket
        if packet in flop_registry:
            key = str(results[0].dtype).replace("torch.", "")
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0) + int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        return out


def _tensors(x, out: list) -> list:
    """The tensors of a nest of tuples, lists and dicts, appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def fake_world(world: int) -> None:
    """Make this process rank 0 of a ``fake`` world of ``world`` ranks (the
    one it is already in, if that is one; another fake world is left
    first).  A real default group is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run makes its own fake world; this process is "
                               f"already in a {dist.get_backend()} world")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _state_bytes(state) -> int:
    from repro_torch.common.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))


def _trace(run: Callable) -> Dict:
    """``run()`` under ``FlopCounterMode`` and :class:`StepTrace` on the
    ``ref`` backend, the collective counter reset first: the record's
    numbers (module docstring) less the state and the time."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import dispatch
    from repro_torch.launch import collectives
    collectives.counter.reset()
    flops, trace = FlopCounterMode(display=False), StepTrace()
    with dispatch.use_backend("ref"), flops, trace:
        run()
    return dict(backend="ref",
                flops_per_device=int(flops.get_total_flops()), flops_note=FLOPS_NOTE,
                flops_by_dtype=trace.flops_by_dtype,
                flops_by_op={str(k): int(v) for k, v in
                             flops.get_flop_counts().get("Global", {}).items()},
                bytes_per_device=int(trace.bytes), bytes_note=BYTES_NOTE, ops=trace.ops,
                scalar_reads=trace.scalar_reads,
                collectives=collectives.counter.payload(),
                collective_calls=collectives.counter.snapshot(),
                collective_widths=collectives.counter.widths(), memory_analysis=MEMORY_NOTE)


def _fake_batch(cfg, shape) -> Dict:
    from repro_torch.launch.specs import batch_specs_for
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in batch_specs_for(cfg, shape).items()}


def trace_step(cfg, shape, mesh, clock: Callable[[], float] = time.monotonic,
               batch_axes=None) -> Dict:
    """One rank's sharded train step of ``cfg`` on ``shape``'s global batch
    over ``mesh`` (a mesh of a fake world), traced on fake tensors: the
    record's numbers (module docstring) without its keys.  ``batch_axes``:
    the step's (:func:`repro_torch.train.step.make_train_step`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.step import adamw_for, make_sharded_init_state, make_train_step
    adamw = adamw_for(cfg)
    init = make_sharded_init_state(cfg, adamw, mesh, batch_axes)
    step = make_train_step(cfg, adamw, mesh=mesh, batch_axes=batch_axes)
    t0 = clock()
    with FakeTensorMode():
        state = init(torch.Generator(), "cpu")
        state_bytes = _state_bytes(state)
        batch = _fake_batch(cfg, shape)
        rec = _trace(lambda: step(state, batch))
    return dict(rec, trace_s=clock() - t0, state_bytes_per_device=state_bytes)


def trace_serve(cfg, shape, mesh, clock: Callable[[], float] = time.monotonic) -> Dict:
    """One rank's ``api.prefill`` (a prefill shape: the global batch of
    ``shape``) or ``api.decode_step`` (a decode shape: one token a row
    against a cache of ``shape.seq_len`` positions at ``len = seq_len -
    1``: the port's decode reads the positions up to ``len``, the
    reference's masked decode reads the whole cache) over ``mesh`` (a mesh
    of a fake world) under ``use_mesh``, on fake blocks of fp32 params (as
    ``api.init`` draws them) placed by :func:`repro_torch.sharding.place.
    lm_serve_layout`: the record's numbers without its keys; the state is
    the params' blocks and the cache's (the one decode reads, the one
    prefill writes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.common.tree import tree_map
    from repro_torch.models.registry import get_api
    from repro_torch.roofline.analysis import serve_cache_layout
    from repro_torch.sharding.ctx import is_spec, use_mesh
    from repro_torch.sharding.place import block_shape, lm_serve_layout
    api = get_api(cfg)
    b, s = shape.global_batch, shape.seq_len
    sizes = dict(mesh.shape)
    whole, pspecs = lm_serve_layout(cfg, sizes)
    shapes, specs = serve_cache_layout(cfg, sizes, b, s, shape.kind)[:2]
    out = {}
    t0 = clock()
    with FakeTensorMode():
        params = tree_map(lambda t, sp: torch.empty(block_shape(t.shape, sp, sizes),
                                                    dtype=t.dtype), whole, pspecs,
                          is_leaf=lambda x: is_spec(x) or torch.is_tensor(x))
        batch = _fake_batch(cfg, shape)
        if shape.kind == "prefill":
            def run():
                with use_mesh(mesh):
                    out["cache"] = api.prefill(params, batch, cfg, backend=None)[1]
        else:
            cache = {k: torch.zeros(block_shape(sh, specs[k], sizes),
                                    dtype=torch.float32 if k == "ssm"
                                    else getattr(torch, cfg.compute_dtype))
                     for k, sh in shapes.items()}
            out["cache"] = dict(cache, len=s - 1, specs=specs)

            def run():
                with use_mesh(mesh):
                    api.decode_step(params, out["cache"], batch["tokens"], cfg, backend=None)
        rec = _trace(run)
        cache_bytes = _state_bytes({k: v for k, v in out["cache"].items() if k in shapes})
        state_bytes = _state_bytes(params) + cache_bytes
    return dict(rec, trace_s=clock() - t0, state_bytes_per_device=state_bytes,
                cache_bytes_per_device=cache_bytes,
                cache_len=s if shape.kind == "prefill" else s - 1)


def apply_variant(cfg, variant: str):
    """``cfg`` under one of :data:`VARIANTS` (the reference's
    ``apply_variant``): ``baseline`` also keeps tensor parallelism on and
    the activations' layout on ``model`` whatever the config says."""
    import dataclasses
    over = dict(VARIANTS[variant])
    if variant == "baseline":
        over["tp_enabled"] = True
        over["shard_activations_model"] = True
    return dataclasses.replace(cfg, **over) if over else cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             clock: Callable[[], float] = time.monotonic, variant: str = "optimized") -> Dict:
    """The record of one (arch, shape, mesh) cell at the arch's full config
    under ``variant``: a train cell's sharded step (pure data parallel
    where the config turns tensor parallelism off and the batch covers the
    mesh, :func:`repro_torch.sharding.rules.tp_off_batch_axes`), a prefill
    or decode cell's ``api.prefill`` / ``api.decode_step`` on placed params
    and cache."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import shape_by_name
    from repro_torch.sharding.rules import tp_off_batch_axes
    shape = shape_by_name(shape_name)
    row = dict(arch=arch, shape=shape_name, mesh=mesh_kind, chips=MESH_WORLDS[mesh_kind],
               variant=variant)
    cfg = apply_variant(all_configs()[arch][0], variant)
    fake_world(MESH_WORLDS[mesh_kind])
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    bax = tp_off_batch_axes(cfg.tp_enabled, shape.global_batch, mesh.shape)
    row.update(status="ok", mesh_shape=dict(mesh.shape), global_batch=shape.global_batch,
               seq_len=shape.seq_len, kind=shape.kind)
    if shape.kind == "train":
        return dict(row, batch_axes=list(bax) if bax else None,
                    **trace_step(cfg, shape, mesh, clock, bax))
    if bax is not None:
        raise ValueError(f"{arch}/{shape_name}: tp_enabled=False over the whole mesh has no "
                         f"serving layout in the port")
    return dict(row, **trace_serve(cfg, shape, mesh, clock))


def load_results(path: pathlib.Path) -> Dict:
    path = pathlib.Path(path)
    return json.loads(path.read_text()) if path.exists() else {}


def write_results(path: pathlib.Path, results: Dict) -> None:
    """The whole record file, as a tmp file then ``os.replace``."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(results, indent=1, sort_keys=True))
    os.replace(tmp, path)


def sweep(archs: List[str], shapes: List[str], meshes: List[str], out: pathlib.Path,
          force: bool = False, clock: Callable[[], float] = time.monotonic,
          variant: str = "optimized") -> int:
    """Record every cell of ``archs`` x ``shapes`` x ``meshes`` under
    ``variant`` into ``out`` (resuming: a cell already ``ok`` or
    ``skipped`` is kept unless ``force``); returns the number of cells that
    failed in this run."""
    results = load_results(out)
    n_fail, t0 = 0, clock()
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                key = f"{arch}/{shape}/{mesh_kind}"
                if not force and results.get(key, {}).get("status") in ("ok", "skipped"):
                    continue
                ok, reason = cell_supported(arch, shape)
                if not ok:
                    rec = dict(arch=arch, shape=shape, mesh=mesh_kind, status="skipped",
                               reason=reason)
                else:
                    try:
                        rec = run_cell(arch, shape, mesh_kind, clock, variant)
                    except Exception as e:  # noqa: BLE001 - recorded, and the run exits 1
                        n_fail += 1
                        rec = dict(arch=arch, shape=shape, mesh=mesh_kind, status="fail",
                                   error=str(e)[-2000:], tb=traceback.format_exc()[-4000:])
                results[key] = rec
                write_results(out, results)
                if rec["status"] == "ok":
                    print(f"[ ok ] {key}: trace {rec['trace_s']:.1f} s, flops/dev "
                        f"{rec['flops_per_device']:.4e}, state bytes/dev "
                        f"{rec['state_bytes_per_device']:.4e}", flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {key}: {rec['reason']}", flush=True)
                else:
                    print(f"[FAIL] {key}: {rec['error'].splitlines()[-1] if rec['error'] else ''}",
                        flush=True)
    print(f"done: {len(results)} cells in {out}, {n_fail} failed in this run, "
        f"{clock() - t0:.1f} s", flush=True)
    return n_fail


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="trace one rank's sharded LM train step, prefill or decode step on a "
                    "fake production world and record its FLOPs, bytes, collective payloads "
                    "and state")
    ap.add_argument("--arch", choices=list(ARCH_IDS) + ["all"], action="append",
                    help="an arch to record (repeatable; default all)")
    ap.add_argument("--shape", choices=[s.name for s in SHAPES] + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true", help="rerun cells already recorded")
    ap.add_argument("--variant", choices=list(VARIANTS), default="optimized",
                    help="baseline: the MoE on the global tokens (no expert parallelism), "
                         "tensor parallelism on (default: optimized, the configs as they are)")
    args = ap.parse_args(argv)
    archs = list(ARCH_IDS) if not args.arch or "all" in args.arch else args.arch
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    return 1 if sweep(archs, shapes, meshes, args.out, args.force, variant=args.variant) else 0


if __name__ == "__main__":
    sys.exit(main())
