"""Checkpoint manager: atomic per-step directories, keep-N retention,
resume from the latest COMMITTED step (the JAX package's
``repro/train/checkpoint.py`` format).

A step directory holds ``state.npz`` (path-keyed flat tree, ``params/bb/
blocks/0/w`` style; bfloat16 leaves stored as uint16 views, numpy having no
bf16), ``meta.json`` (step, the dtype sidecar, ``extra``, and a crc32 of
the encoded leaves) and a ``COMMIT`` marker written last.  A save goes to a
``.tmp_step_*`` sibling and is published by ``os.replace``, so a death
mid-save leaves nothing that resume would trust.  Restore takes a template
tree (the initial state serves) whose leaves give each tensor's dtype and
device; it checks the crc32 where the directory has one.

The leaves are stored in the JAX package's layout
(:func:`repro_torch.bridge.to_jax_layout`): conv weights and their
``mu``/``nu`` HWIO, int8 ``{q, scale, n}`` state as it is.  A step
directory written by either package restores in the other.

:class:`MeshCheckpointManager` is the same directory under a
data-parallel mesh: rank 0 writes, every rank reads.

:func:`save_array_tree` / :func:`load_array_tree` write and read one
self-describing npz per tree (the dtype sidecar and the crc32 ride inside
it as ``__dtypes__`` and ``__crc32__``), byte for byte the JAX package's
format; the serving warm tier spills adapted task states through them.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import (EF_HWIO_TO_OIHW, HWIO_TO_OIHW, is_conv_weight,
                                is_stacked_conv_weight, to_jax_layout)
from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
from repro_torch.faults.plan import CKPT_PRE_COMMIT, CKPT_PRE_REPLACE, InjectedKill
from repro_torch.optim.quant import is_quantized

Tree = Any
_BF16 = "bfloat16"


class ChecksumError(RuntimeError):
    """The stored crc32 does not match the bytes on disk: the checkpoint was
    corrupted after its publish."""


def _unflatten(template: Tree, leaf_at, prefix: str = "",
               in_quantized: bool = False) -> Tree:
    """``template`` rebuilt with ``leaf_at(path, like, in_quantized)`` at
    every leaf; ``in_quantized`` marks the parts of a ``{q, scale, n}``
    leaf, which keep the stored layout."""
    if isinstance(template, dict):
        inner = in_quantized or is_quantized(template)
        return {k: _unflatten(v, leaf_at, f"{prefix}/{k}" if prefix else str(k), inner)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaf_at, f"{prefix}/{i}" if prefix else str(i), in_quantized)
            for i, v in enumerate(template))
    return leaf_at(prefix, template, in_quantized)


def encode_array_tree(tree: Tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Path-keyed numpy arrays and their dtype sidecar."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for k, v in tree_paths(tree).items():
        t = torch.as_tensor(v).detach().cpu()
        if t.dtype == torch.bfloat16:
            dtypes[k] = _BF16
            arrays[k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[k] = t.numpy()
            dtypes[k] = str(arrays[k].dtype)
    return arrays, dtypes


def _tree_crc32(arrays: Dict[str, np.ndarray], dtypes: Dict[str, str]) -> int:
    """CRC32 over the dtype sidecar and the encoded leaves in sorted key
    order."""
    crc = zlib.crc32(json.dumps(dtypes, sort_keys=True).encode())
    for k in sorted(arrays):
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _decode(path: str, arr: np.ndarray, dtype_str: str, like, in_quantized: bool):
    """The stored leaf at ``path`` in the dtype, device and layout of
    ``like``; a python scalar (a quantized leaf's ``n``) comes back as one.
    A shape that is not the template's raises."""
    if not torch.is_tensor(like):
        return type(like)(arr.item())
    if dtype_str == _BF16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if not in_quantized and is_conv_weight(like, path.rsplit("/", 1)[-1]):
        t = t.permute(*HWIO_TO_OIHW)
    elif not in_quantized and is_stacked_conv_weight(like, path):
        t = t.permute(*EF_HWIO_TO_OIHW)
    if t.shape != like.shape:
        raise ValueError(f"checkpoint leaf {path}: shape {tuple(t.shape)} in the port's "
                         f"layout, the template's {tuple(like.shape)}")
    # a template leaf on the meta device (shape and dtype only) decodes
    # onto the host
    device = "cpu" if like.is_meta else like.device
    return t.to(dtype=like.dtype, device=device).contiguous()


def save_array_tree(file, tree: Tree) -> None:
    """One self-describing npz: the leaves in the JAX package's layout,
    path-keyed, a ``__dtypes__`` json member and a ``__crc32__`` of the
    whole content, fsynced before return.  Atomic publish (tmp +
    ``os.replace``) is the caller's job."""
    arrays, dtypes = encode_array_tree(to_jax_layout(tree))
    crc = _tree_crc32(arrays, dtypes)
    # lint: allow(atomic-publish): atomicity is this function's documented
    # caller contract — the warm tier's put hands in a tmp path and
    # publishes it with os.replace
    with open(file, "wb") as f:
        np.savez(f, __dtypes__=np.asarray(json.dumps(dtypes)),
                 __crc32__=np.uint32(crc), **arrays)
        f.flush()
        os.fsync(f.fileno())


def load_array_tree(file, template: Tree, verify: bool = False) -> Tree:
    """A :func:`save_array_tree` npz (either package's) in ``template``'s
    structure, each leaf in its template leaf's dtype, device and the
    port's layout; a template leaf on the meta device gives a CPU tensor.
    ``verify=True`` recomputes the crc32 and raises :class:`ChecksumError`
    on a mismatch (a file without ``__crc32__`` passes); a truncated file
    fails earlier, inside ``np.load``."""
    with np.load(file) as data:
        arrays = {k: data[k] for k in data.files}
    dtypes = json.loads(str(arrays.pop("__dtypes__")))
    stored = arrays.pop("__crc32__", None)
    if verify and stored is not None:
        crc = _tree_crc32(arrays, dtypes)
        if crc != int(stored):
            raise ChecksumError(f"{file}: content crc32 {crc:#010x} != stored "
                                f"{int(stored):#010x}")
    return _unflatten(template, lambda k, like, inq: _decode(
        k, arrays[k], dtypes.get(k, ""), like, inq))


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 fault_plan=None):
        """``fault_plan`` (:class:`repro_torch.faults.FaultPlan`) injects
        kills at ``ckpt.pre_commit`` and ``ckpt.pre_replace`` inside
        ``save``, so tests show that a death mid-save leaves the previous
        committed checkpoint restorable."""
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._fault_plan = fault_plan

    def _maybe_kill(self, site: str, step: int) -> None:
        if self._fault_plan is not None and \
                self._fault_plan.fire(site, step) is not None:
            raise InjectedKill(f"killed at {site} while saving step {step}")

    def save(self, step: int, state: Tree, extra: Optional[Dict] = None
             ) -> pathlib.Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays, dtypes = encode_array_tree(to_jax_layout(state))
        with open(tmp / "state.npz", "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        meta = dict(step=step, dtypes=dtypes, extra=extra or {},
                    crc32=_tree_crc32(arrays, dtypes))
        (tmp / "meta.json").write_text(json.dumps(meta))
        self._maybe_kill(CKPT_PRE_COMMIT, step)
        (tmp / "COMMIT").write_text("ok")
        self._maybe_kill(CKPT_PRE_REPLACE, step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)           # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in sorted(self.dir.glob("step_*"))
                if (p / "COMMIT").exists()]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Tree) -> Tuple[Tree, Dict]:
        """The state at ``step`` in ``template``'s structure, each leaf in
        its template leaf's dtype and device; raises
        :class:`ChecksumError` if the stored crc32 does not match."""
        d = self.dir / f"step_{step:010d}"
        if not (d / "COMMIT").exists():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        meta = json.loads((d / "meta.json").read_text())
        with np.load(d / "state.npz") as data:
            arrays = {k: data[k] for k in data.files}
        crc = _tree_crc32(arrays, meta["dtypes"])
        if "crc32" in meta and crc != meta["crc32"]:
            raise ChecksumError(f"{d}: content crc32 {crc:#010x} != stored "
                                f"{meta['crc32']:#010x}")
        state = _unflatten(template, lambda k, like, inq: _decode(
            k, arrays[k], meta["dtypes"].get(k, ""), like, inq))
        return state, meta["extra"]

    def restore_latest(self, template: Tree):
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, template)
        return step, state, extra


def ef_specs(state: Tree, mesh) -> Tree:
    """The spec tree of a data-parallel meta-training state
    (:mod:`repro_torch.train.elastic`): every leaf replicated but the
    error-feedback residual ``opt['ef']``, split on its leading axis over
    the outer (``dcn``) axis of the two-level ``mesh``."""
    dcn_axis = mesh.axis_names[0]

    def walk(tree, in_ef):
        if isinstance(tree, dict):
            return {k: walk(v, in_ef or (k == "ef")) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, in_ef) for v in tree)
        return (dcn_axis,) + (None,) * (tree.dim() - 1) if in_ef else None

    return walk(state, False) if "ef" in state.get("opt", {}) else \
        tree_map(lambda _: None, state)


class MeshCheckpointManager:
    """A :class:`CheckpointManager` shared by the ranks of a data-parallel
    mesh (:class:`repro_torch.launch.mesh.DPMesh`).

    Only rank 0 writes.  Before it writes, the ranks that hold distinct
    ``opt['ef']`` rows (``data`` index 0) all-gather them over their
    ``dcn`` group, so the file holds the JAX package's whole ``(dcn, ...)``
    leaf and stays topology-free.  A barrier follows every save, so every
    rank then reads the same committed steps; each restores the whole
    state and keeps its own ``ef`` row.  Every rank must call ``save``
    together (the training loop does: its decisions rest on the metrics,
    which the ranks agree on)."""

    def __init__(self, inner: CheckpointManager, mesh):
        self.inner = inner
        self.mesh = mesh
        # a two-level mesh is (dcn, data): the ef rows split over its outer axis
        *outer, self.data_axis = mesh.axis_names
        self.dcn_axis = outer[0] if outer else None

    def _own_rows(self, state: Tree) -> Tree:
        """``state`` with each ``ef`` leaf cut to this rank's row."""
        if "ef" not in state.get("opt", {}):
            return state
        n = self.mesh.shape.get(self.dcn_axis, 1)
        i = self.mesh.coords.get(self.dcn_axis, 0)
        ef = tree_map(lambda e: e[i:i + 1] if e.shape[0] == n and n > 1 else e,
                      state["opt"]["ef"])
        return dict(state, opt=dict(state["opt"], ef=ef))

    def save(self, step: int, state: Tree, extra: Optional[Dict] = None):
        from repro_torch.train.elastic import gather_state
        path = None
        if self.mesh.coords[self.data_axis] == 0:
            local = self._own_rows(state)
            host = gather_state(local, self.mesh, ef_specs(local, self.mesh))
            if self.mesh.rank == 0:
                path = self.inner.save(step, tree_map(torch.from_numpy, host), extra)
        self.mesh.barrier()
        return path


    def restore(self, step: int, template: Tree) -> Tuple[Tree, Dict]:
        """The whole state at ``step`` (``template``'s ``ef`` leaves may be
        the whole ``(dcn, ...)`` leaf or one row), with this rank's ``ef``
        row."""
        if "ef" in template.get("opt", {}):
            n = self.mesh.shape.get(self.dcn_axis, 1)
            ef = tree_map(lambda e: torch.empty((n,) + tuple(e.shape[1:]), dtype=e.dtype,
                                                device="meta"), template["opt"]["ef"])
            template = dict(template, opt=dict(template["opt"], ef=ef))
        state, extra = self.inner.restore(step, template)
        if "ef" in state.get("opt", {}):
            dev = tree_leaves(state["params"])[0].device
            state["opt"]["ef"] = tree_map(lambda e: e.to(dev), state["opt"]["ef"])
        return self._own_rows(state), extra

    def restore_latest(self, template: Tree):
        step = self.inner.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, template)
        return step, state, extra


class ShardedCheckpointManager:
    """A :class:`CheckpointManager` shared by the ranks of an LM mesh whose
    state rests as blocks (:func:`repro_torch.train.step.
    make_sharded_init_state`).  A checkpoint holds whole leaves in the
    single-device layout, so one written on one mesh restores on another
    (and on one device): every rank joins the all-gathers of each leaf in
    turn, rank 0 keeps it on the host and writes; every rank reads the
    whole state and keeps its blocks.  ``whole`` is the state's whole tree
    on ``meta`` and ``specs`` its spec tree for ``mesh``
    (:func:`repro_torch.train.step.lm_state_specs`).  Every rank must call
    ``save`` together, as the training loop does."""

    def __init__(self, inner: CheckpointManager, mesh, whole: Tree, specs: Tree):
        self.inner = inner
        self.mesh = mesh
        self.whole = whole
        self.specs = specs

    def save(self, step: int, state: Tree, extra: Optional[Dict] = None):
        from repro_torch.sharding.place import gather_tree
        host = gather_tree(state, self.specs, self.mesh, device="cpu")
        path = self.inner.save(step, host, extra) if self.mesh.rank == 0 else None
        self.mesh.barrier()
        return path

    def restore(self, step: int, template: Tree) -> Tuple[Tree, Dict]:
        """The state at ``step`` as this rank's blocks, on the device of
        ``template``'s leaves."""
        from repro_torch.sharding.place import shard_tree
        state, extra = self.inner.restore(step, self.whole)
        dev = tree_leaves(template["params"])[0].device
        state = shard_tree(state, self.specs, self.mesh)
        return tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t, state), extra

    def restore_latest(self, template: Tree):
        step = self.inner.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, template)
        return step, state, extra
