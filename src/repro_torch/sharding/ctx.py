"""Partition specs and the active mesh (the JAX package's
``repro/sharding/ctx.py``).

A spec is :class:`P`, a tuple with one entry a dim: None (whole), a mesh
axis name, or a tuple of names (the dim split over their product, the
first name outermost).  :func:`_sanitize` drops every entry whose names
the mesh lacks or whose product does not divide the dim, so one set of
rules serves the (n, 1) test mesh, 16 x 16 and 2 x 16 x 16.  A mesh here
is anything with a ``shape`` dict of axis sizes: a
:class:`repro_torch.launch.mesh.DPMesh`, or a stub in the tests.

:func:`use_mesh` / :func:`active_mesh` are the counterpart of the
reference's ``with mesh:`` and ``_active_mesh()``: model code that has a
sharded path (``transformer.moe_dispatch``) reads the mesh from here, and
runs on one device where none is active.  The reference's ``constrain``
has no counterpart: it hints GSPMD where to lay out an intermediate, and
eager PyTorch code lays out every tensor explicitly.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.common.tree import tree_map


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), "model")``;
    an entry of one name in a tuple is that name, as JAX's
    ``PartitionSpec`` reads it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def entry_names(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, outermost first (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _sanitize(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """``spec`` with each entry whose names the mesh lacks, or whose product
    does not divide its dim, dropped to None; a kept entry of one name is
    that name."""
    sizes = _mesh_axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        names = tuple(n for n in entry_names(entry) if n in sizes)
        if not names:
            out.append(None)
            continue
        total = math.prod(sizes[n] for n in names)
        if i < len(shape) and shape[i] % total == 0:
            out.append(names if len(names) > 1 else names[0])
        else:
            out.append(None)
    return P(*out)


def sanitize_tree(specs, shapes, mesh):
    """:func:`_sanitize` leaf by leaf over a spec tree and the matching tree
    of tensors (``meta`` ones serve) or shaped objects; a leaf without a
    shape (an int8 state's ``n``) counts as 0-dim."""
    return tree_map(lambda s, a: _sanitize(s, tuple(getattr(a, "shape", ())), mesh),
                    specs, shapes, is_leaf=is_spec)


def residual_spec(cfg) -> P:
    """The spec of the (B, S, D) residual stream between blocks, by the
    config's activation policy."""
    if not cfg.shard_activations_model:
        return P("data", None, None)
    if getattr(cfg, "activation_layout", "hidden") == "seq":
        return P("data", "model", None)
    return P("data", None, "model")


_active: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Scope in which :func:`active_mesh` is ``mesh`` (the reference's
    ``with mesh:``)."""
    token = _active.set(mesh)
    try:
        yield mesh
    finally:
        _active.reset(token)


def active_mesh() -> Optional[Any]:
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _active.get()
