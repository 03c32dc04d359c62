"""Sharded state: a rank's blocks of the leaves of a tree under a spec tree
and a mesh (:class:`repro_torch.launch.mesh.DPMesh`), and back.

A leaf split over an entry's axes holds this rank's block of that dim:
equal blocks in the order of the rank's index in the entry's group, the
first axis outermost, so ``FSDP`` = ``("pod", "data")`` flattens (pod,
data) in that order.  An axis of one rank splits nothing.

* :func:`shard_tree` / :func:`gather_tree`: blocks from whole leaves and
  whole leaves from blocks (all-gathers, leaf by leaf);
* :func:`reshard`: a block under one spec from a block under another,
  gathering only the dims whose entries differ;
* :func:`gather_for_use`: the differentiable gather of the sharded LM
  step, each FSDP dim's VJP a reduce-scatter over the data axes, each
  ``model`` dim's this rank's block;
* :func:`init_sharded`: an init function run one leaf at a time, each draw
  cut to this rank's block before the next is drawn, so the blocks equal
  the single-device init's and the peak is the largest leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.common.tree import tree_map
from repro_torch.sharding.ctx import P, entry_names, is_spec
from repro_torch.sharding.rules import map_with_path

Tree = Any


def _split_entries(spec, mesh):
    """(dim, axis names) of each entry of ``spec`` over more than one rank."""
    if spec is None:
        return []
    return [(d, entry_names(e)) for d, e in enumerate(spec)
            if entry_names(e) and mesh.size_of(entry_names(e)) > 1]


def block_shape(shape, spec, mesh_shape: Dict[str, int]):
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for d, e in enumerate(spec or ()):
        n = 1
        for a in entry_names(e):
            n *= mesh_shape[a]
        out[d] //= n
    return tuple(out)


def shard_leaf(t, spec, mesh):
    """This rank's block of the whole leaf ``t`` (a fresh tensor where it is
    cut, ``t`` itself where nothing splits it; a non-tensor as it is)."""
    if not torch.is_tensor(t):
        return t
    out = t
    for d, names in _split_entries(spec, mesh):
        n = mesh.size_of(names)
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of size {out.shape[d]} does not split over "
                             f"{names} of {n} ranks")
        step = out.shape[d] // n
        out = out.narrow(d, mesh.index_of(names) * step, step)
    return out if out.numel() == t.numel() else out.clone()


def gather_leaf(t, spec, mesh):
    """The whole leaf from this rank's block (all-gathers over each split
    dim; every rank of the mesh calls it, in one order)."""
    if not torch.is_tensor(t):
        return t
    for d, names in _split_entries(spec, mesh):
        t = mesh.all_gather_tensor(t, names, d)
    return t.contiguous()


def shard_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    return tree_map(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def gather_tree(tree: Tree, specs: Tree, mesh, device=None) -> Tree:
    """Whole leaves, gathered and (with ``device``) moved one leaf at a
    time, so at most one whole leaf is on the card at once."""
    def whole(t, s):
        out = gather_leaf(t, s, mesh)
        return out.to(device) if device is not None and torch.is_tensor(out) else out
    return tree_map(whole, tree, specs)


def reshard(t: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """A block under spec ``dst`` from this rank's block under ``src``:
    every dim whose entries differ is gathered over ``src``'s axes, then
    cut by ``dst``'s (no communication where they agree)."""
    src = tuple(src or ()) + (None,) * (t.dim() - len(src or ()))
    dst = tuple(dst or ()) + (None,) * (t.dim() - len(dst or ()))
    moved = [d for d in range(t.dim()) if entry_names(src[d]) != entry_names(dst[d])]
    if not moved:
        return t
    for d in moved:
        names = entry_names(src[d])
        if names and mesh.size_of(names) > 1:
            t = mesh.all_gather_tensor(t, names, d)
    cut = False
    for d in moved:
        names = entry_names(dst[d])
        if names and mesh.size_of(names) > 1:
            step = t.shape[d] // mesh.size_of(names)
            t = t.narrow(d, mesh.index_of(names) * step, step)
            cut = True
    # a block cut from a gathered leaf is copied out, so the whole leaf is freed
    return t.clone(memory_format=torch.contiguous_format) if cut else t.contiguous()


def gather_for_use(t: torch.Tensor, spec, mesh, keep_model: bool = False) -> torch.Tensor:
    """The whole leaf from this rank's block, differentiably: the data
    axes' dims first (their VJP a reduce-scatter: each data rank's
    gradient is its shard's, and they add), then ``model``'s (VJP: this
    rank's block, since every model rank computes the same whole
    gradient).  ``keep_model``: leave the model dims split (the expert
    banks of an expert-parallel layer)."""
    from repro_torch.launch.mesh import all_gather
    entries = _split_entries(spec, mesh)
    for d, names in entries:
        if "model" in names and len(names) > 1:
            raise ValueError(f"spec {spec}: a dim split over model and other axes")
        if "model" not in names:
            t = all_gather(t, mesh, names, d, vjp="sum")
    if not keep_model:
        for d, names in entries:
            if names == ("model",):
                t = all_gather(t, mesh, "model", d, vjp="slice")
    return t


def owns_block(spec, mesh) -> bool:
    """Whether this rank is the first of the ranks that hold the same block
    (index 0 on every axis ``spec`` does not split): the global-norm clip
    counts each block's squares there once."""
    named = {a for e in (spec or ()) for a in entry_names(e)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in named)


def init_sharded(init_fn: Callable, gen: torch.Generator, device, specs: Tree, mesh) -> Tree:
    """``init_fn(gen, device)``'s tree as this rank's blocks under ``specs``
    (a spec tree of the whole tree), drawn one leaf at a time: every draw
    of :func:`repro_torch.common.init.normal_init` is cut to its block as
    soon as it is drawn and cast, so the peak is the largest leaf, and
    the blocks are those of cutting the single-device init's tree.  A leaf
    made otherwise (the zeros of norm scales and biases) is cut after.  The
    draws are matched to their leaves by a first run under fake tensors
    (:func:`repro_torch.launch.specs.draw_paths`)."""
    from repro_torch.common.init import draws_kept
    from repro_torch.launch.specs import draw_paths
    by_path = spec_paths(specs)
    paths = draw_paths(init_fn)
    it = iter(paths)
    with draws_kept(lambda t: shard_leaf(t, by_path[next(it)], mesh)):
        tree = init_fn(gen, device)
    cut = set(paths)
    return map_with_path(lambda path, t: t if path in cut else shard_leaf(t, by_path[path], mesh),
                         tree)


def spec_paths(specs: Tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: spec}`` of a spec tree (a spec is a leaf, not a tuple), the
    paths as :func:`repro_torch.common.tree.tree_paths` keys a tree's."""
    if is_spec(specs) or specs is None:
        return {prefix: specs}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for k, v in items:
        out.update(spec_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# the serving placement: an LM's params and cache over a (data, model) mesh
# ---------------------------------------------------------------------------

def lm_serve_layout(cfg, mesh_shape: Dict[str, int]):
    """(the whole params of ``cfg`` on ``meta``, fp32 as ``api.init`` draws
    them, their sanitized spec tree) on a mesh of axis sizes
    ``mesh_shape``: the reference's serving placement of the params
    (``repro/launch/dryrun.py:154-195``, ``rules.param_specs`` then
    ``sanitize``), which :func:`place_lm_params` gives a rank's blocks of.
    The dry run traces on these blocks and the roofline counts them."""
    from repro_torch.launch.specs import abstract_params_for
    from repro_torch.sharding import rules
    from repro_torch.sharding.serve import _Sizes
    params = abstract_params_for(cfg)
    return params, rules.sanitize(rules.param_specs(params), params, _Sizes(mesh_shape))


def place_lm_params(params: Tree, mesh) -> Tree:
    """This rank's blocks of an LM's whole ``params`` under
    ``rules.param_specs``, sanitized for ``mesh``: what ``prefill`` and
    ``decode_step`` take under :func:`repro_torch.sharding.ctx.use_mesh`
    (they gather each layer's leaves as they reach it)."""
    from repro_torch.sharding import rules
    return shard_tree(params, rules.sanitize(rules.param_specs(params), params, mesh), mesh)


def place_lm_cache(cache: Dict, mesh) -> Dict:
    """This rank's blocks of a whole cache (global batch; ``init_cache``'s,
    or a one-device prefill's spliced into a longer one) under the
    sanitized ``rules.cache_specs``
    (:func:`repro_torch.sharding.serve.cache_specs_for`), with ``len`` and
    the specs under ``"specs"``: what ``decode_step`` takes under the
    mesh."""
    from repro_torch.sharding.serve import META_KEYS, cache_specs_for
    shapes = {k: tuple(v.shape) for k, v in cache.items() if k not in META_KEYS}
    specs = cache_specs_for(shapes, next(iter(shapes.values()))[1], mesh.shape)
    return dict({k: shard_leaf(cache[k], specs[k], mesh) for k in shapes}, len=cache["len"],
                specs=specs)


__all__ = ["P", "block_shape", "gather_for_use", "gather_leaf", "gather_tree", "init_sharded",
           "lm_serve_layout", "owns_block", "place_lm_cache", "place_lm_params", "reshard",
           "shard_leaf", "shard_tree"]
