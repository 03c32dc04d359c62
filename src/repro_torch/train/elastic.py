"""Elastic scaling: rebuild the mesh for a changed number of ranks and
reshard a topology-free state onto it (the JAX package's
``repro/train/elastic.py``).

Checkpoints hold plain host arrays, so elasticity reduces to:

    state_np  = gather_state(state, mesh, specs)   # topology-free
    new_mesh  = the mesh of the new world
    new_state = reshard(state_np, specs_for(new_mesh, state_np), new_mesh)

A spec is the port's stand-in for a ``PartitionSpec``: a tuple with an axis
name or None for each dim of a leaf, or None for a replicated leaf.  A leaf
split over an axis holds this rank's slice of that dim (the rank's
coordinate along the axis, in equal blocks); a replicated leaf is whole.

A change of world size is a new process group: ``torch.distributed`` does
not change the world inside a group.  :func:`elastic_transition` gathers on
the old mesh, then calls ``new_mesh`` (a zero-argument function) to make
the new world; a rank that leaves gets None from it and returns None, and
a rank that joins passes ``state=None`` and gets the state by broadcast
from rank 0 of the new world.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.tree import tree_map

Tree = Any


def choose_mesh_shape(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) for the live device count; model axis capped at the
    configured TP degree, remainder goes to data."""
    model = 1
    for cand in range(min(model_parallel, n_devices), 0, -1):
        if n_devices % cand == 0:
            model = cand
            break
    return n_devices // model, model


def _split_dims(spec):
    return [] if spec is None else [(d, a) for d, a in enumerate(spec) if a is not None]


def gather_state(state: Tree, mesh=None, specs: Optional[Tree] = None) -> Tree:
    """The state as host numpy, whole: each leaf that ``specs`` splits over a
    mesh axis is all-gathered over that axis's group and its slices joined
    in coordinate order.  Without ``specs`` every leaf is taken as it is."""
    def whole(x, spec=None):
        t = torch.as_tensor(x).detach()
        for d, axis in _split_dims(spec):
            t = torch.cat(mesh.all_gather(t, axis), dim=d)
        return t.cpu().numpy()

    if specs is None:
        return tree_map(whole, state)
    return tree_map(whole, state, specs)


def reshard(state_np: Tree, specs: Tree, mesh, device=None) -> Tree:
    """Host state -> this rank's tensors on ``device`` under ``mesh`` and the
    spec tree: a split leaf gives the rank's slice of each split dim."""
    def put(x, spec):
        t = torch.from_numpy(np.array(x))
        for d, axis in _split_dims(spec):
            n = mesh.shape[axis]
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of size {t.shape[d]} does not split over "
                                 f"{axis!r} of {n} ranks")
            step = t.shape[d] // n
            t = t.narrow(d, mesh.coords[axis] * step, step)
        return t.contiguous().to(device) if device is not None else t.contiguous()

    return tree_map(put, state_np, specs)


def _abstract(host: Tree) -> Tree:
    return tree_map(lambda a: torch.empty(np.shape(a), dtype=torch.from_numpy(
        np.asarray(a)).dtype, device="meta"), host)


def elastic_transition(state: Optional[Tree], old_mesh, new_mesh: Callable,
                       specs_for: Callable, old_specs: Optional[Tree] = None,
                       device=None) -> Optional[Tree]:
    """Gather off the old topology, make the new world, reshard onto it.

    ``state`` is this rank's state on ``old_mesh`` (its split leaves laid
    out by ``old_specs``), or None on a rank that joins.  ``new_mesh()``
    forms the new world and returns its mesh, or None on a rank that
    leaves (which then returns None).  ``specs_for(mesh, abstract_state)``
    gives the new spec tree.  Rank 0 of the new world, which must have
    been a rank of the old one, broadcasts the host state, so a joining
    rank gets it too."""
    host = gather_state(state, old_mesh, old_specs) if state is not None else None
    mesh = new_mesh()
    if mesh is None:
        return None
    host = mesh.broadcast_object(host if mesh.rank == 0 else None, src=0)
    return reshard(host, specs_for(mesh, _abstract(host)), mesh, device)
