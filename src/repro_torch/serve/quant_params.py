"""Serving-time weight quantization: the frozen slice of a learner's params
in blockwise int8, dequantized at each dispatch.

Which leaves freeze is a property of the learner kind (``FROZEN_SLICES``):
the backbone ``bb`` for every kind but fomaml, whose inner loop rewrites
every leaf, so it freezes nothing and serves in fp32.  Frozen leaves are
stored in the ``{q, scale, n}`` form of :mod:`repro_torch.optim.quant`
(about 4x fewer resident bytes); everything adaptation writes stays fp32.  Leaves on the
backbone's ``quant_native_paths`` (the head matmul) stay int8 even at
dispatch and go to the ``int8_matmul`` kernel.

Conv weights are quantized in the JAX package's HWIO layout, along the
output-channel axis, so that the int8 bits and scales are the JAX package's
own; a quantized 4-D leaf is HWIO, and :func:`dequantize_params` turns it
back into the port's OIHW.

A serving group of several ranks places the weights in a layout of
:data:`repro_torch.roofline.analysis.SERVING_LAYOUTS`
(:func:`place_serving_weights`): each rank keeps its shard of every leaf
the layout splits.  At each dispatch :func:`serving_params` hands the
learner a tree in which a split leaf on the kind's ``PRODUCT_LEAVES`` is a
:class:`repro_torch.common.linear.KSlice` (``weight_stationary``: its
product sums over the group) and every other split leaf is gathered
whole (``training``: all of them, every dispatch).
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.bridge import HWIO_TO_OIHW, OIHW_TO_HWIO
from repro_torch.common.linear import KSlice
from repro_torch.launch.mesh import serve_axis
from repro_torch.optim.quant import dequantize, quantize
from repro_torch.optim.quant import is_quantized as is_quantized_leaf

Tree = Any

SERVE_QUANT_MODES = ("none", "int8")

# learner kind -> top-level param keys that adaptation never writes
FROZEN_SLICES: Dict[str, Tuple[str, ...]] = {
    "protonets": ("bb",),
    "cnaps": ("bb",),
    "simple_cnaps": ("bb",),
    "finetuner": ("bb",),
    "fomaml": (),            # adaptation rewrites every leaf
}

# learner kind -> (path pattern, rows) of the 2-D leaves its dispatches read
# only as the right operand of ``common.linear.matmul``; "bb" stands for the
# backbone's ``product_paths``.  ``rows`` are the product's input rows in an
# adapt dispatch: "chunks" the support rows in LITE chunks (the last chunk
# padded), "support" every support row, "tasks" one a task lane, "classes"
# one a class of a lane; a predict dispatch runs the backbone alone, over the
# query rows.  fomaml has none: its inner SGD differentiates every leaf and
# its adapted state is a copy of them, so a split leaf of it is gathered.
_FILM = (("film_gen/sites/*/w1", "tasks"), ("film_gen/sites/*/w_gamma", "tasks"),
         ("film_gen/sites/*/w_beta", "tasks"))
_ENC = (("enc/head/w", "chunks"), ("enc/w1", "chunks"), ("enc/w2", "chunks"))
PRODUCT_LEAVES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "protonets": (("bb", "chunks"),),
    "cnaps": (("bb", "chunks"),) + _ENC + _FILM + (("head_gen/w1", "classes"),
                                                   ("head_gen/w2", "classes")),
    "simple_cnaps": (("bb", "chunks"),) + _ENC + _FILM,
    "finetuner": (("bb", "support"),),
    "fomaml": (),
}



@dataclasses.dataclass(frozen=True)
class ServingWeights:
    """Params with the frozen slice quantized (or untouched: mode 'none').

    tree: the param tree; quantized leaves are ``{q, scale, n}`` dicts.
    quant_paths: '/'-joined paths of the quantized leaves.
    native_paths: the subset consumed as int8 by the backbone's matmul.
    frozen_roots: the kind's frozen top-level keys.
    mode: 'none' | 'int8'.
    products: (path, rows) of the 2-D leaves read only through
      ``common.linear.matmul`` (``PRODUCT_LEAVES``).
    layout, splits, mesh: set by :func:`place_serving_weights`: the
      layout, (path, dim, rows of the whole leaf along it) of every leaf
      kept as this rank's shard (a quantized leaf's ``q`` and ``scale`` as
      ``path/q`` and ``path/scale``), and the mesh.
    """

    tree: Tree
    quant_paths: Tuple[str, ...] = ()
    native_paths: Tuple[str, ...] = ()
    frozen_roots: Tuple[str, ...] = ()
    mode: str = "none"
    products: Tuple[Tuple[str, str], ...] = ()
    layout: str = "none"
    splits: Tuple[Tuple[str, int, int], ...] = ()
    mesh: Any = None


def _walk(tree: Tree, fn, path: str = "") -> Tree:
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf; quantized
    dicts are leaves."""
    if is_quantized_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _quantizable(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.dim() >= 1)


def _products(learner, params: Tree) -> Tuple[Tuple[str, str], ...]:
    """The kind's ``PRODUCT_LEAVES`` that ``params`` holds, as (path, rows)."""
    patterns = []
    for pat, rows in PRODUCT_LEAVES.get(learner.cfg.kind, ()):
        if pat == "bb":
            patterns += [(f"bb/{p}", rows) for p in learner.backbone.product_paths]
        else:
            patterns.append((pat, rows))
    out = []

    def visit(path, leaf):
        for pat, rows in patterns:
            if fnmatch.fnmatchcase(path, pat) and getattr(leaf, "dim", lambda: 0)() == 2:
                out.append((path, rows))
                break
        return leaf

    _walk(params, visit)
    return tuple(out)


def quantize_frozen(learner, params: Tree, mode: str = "int8") -> ServingWeights:
    """Quantize the frozen slice of ``params`` for serving (mode 'none'
    wraps params untouched)."""
    if mode not in SERVE_QUANT_MODES:
        raise ValueError(f"unknown serve_quant mode {mode!r}; "
                         f"choose from {SERVE_QUANT_MODES}")
    roots = FROZEN_SLICES.get(learner.cfg.kind, ())
    products = _products(learner, params)
    if mode == "none" or not roots:
        return ServingWeights(tree=params, frozen_roots=roots, mode="none",
                              products=products)
    native_rel = set(learner.backbone.quant_native_paths)
    quant_paths, native_paths = [], []

    def visit(path, leaf):
        root, _, rel = path.partition("/")
        if root not in roots or not _quantizable(leaf):
            return leaf
        quant_paths.append(path)
        if rel in native_rel and leaf.dim() == 2:
            native_paths.append(path)
        if leaf.dim() == 4:                    # OIHW -> the JAX HWIO layout
            leaf = leaf.permute(*OIHW_TO_HWIO)
        return quantize(leaf)

    tree = _walk(params, visit)
    return ServingWeights(tree=tree, quant_paths=tuple(quant_paths),
                          native_paths=tuple(native_paths),
                          frozen_roots=roots, mode="int8", products=products)


def dequantize_params(sw: ServingWeights, tree: Optional[Tree] = None) -> Tree:
    """A params tree the learner can consume: quantized leaves of ``tree``
    (default ``sw.tree``) expanded to fp32 (4-D ones back to OIHW), a
    K-slice's rows alike, native-path leaves left int8."""
    tree = sw.tree if tree is None else tree
    if sw.mode == "none":
        return tree
    native = set(sw.native_paths)

    def visit(path, leaf):
        if path in native:
            return leaf
        if isinstance(leaf, KSlice) and is_quantized_leaf(leaf.local):
            return dataclasses.replace(leaf, local=dequantize(leaf.local))
        if not is_quantized_leaf(leaf):
            return leaf
        w = dequantize(leaf)
        return w.permute(*HWIO_TO_OIHW).contiguous() if w.dim() == 4 else w

    return _walk(tree, visit)


def place_serving_weights(sw: ServingWeights, mesh, layout) -> ServingWeights:
    """Place serving weights in a named layout on ``mesh``'s serving group
    (:func:`repro_torch.launch.mesh.make_replica_mesh`, its last axis): this rank keeps its
    shard of every leaf the layout splits
    (:func:`repro_torch.roofline.analysis.serving_shardings`), so the
    weights stay within the group.  ``mesh=None`` or ``layout in (None,
    'none')`` is the identity; ``'auto'`` must be resolved to a name by
    :func:`repro_torch.roofline.analysis.choose_serving_layout` first:
    placement applies a layout, it does not score one.  A quantized leaf's
    ``q`` and ``scale`` split alike, on their rows under
    ``weight_stationary`` (the blocks run along N, so a K-split keeps them
    whole)."""
    if mesh is None or layout in (None, "none"):
        return sw
    if layout == "auto":
        raise ValueError(
            "resolve serve_layout='auto' with "
            "repro_torch.roofline.analysis.choose_serving_layout before placing "
            "the serving weights")
    from repro_torch.roofline.analysis import serving_shardings, split_dim
    axis = serve_axis(mesh)
    n, idx = mesh.shape[axis], mesh.coords[axis]
    specs = _spec_paths(serving_shardings(sw.tree, n, layout, axis))
    splits = []

    def place(path, leaf):
        d = split_dim(specs.get(path, ()))
        if d is None:
            return leaf
        size = leaf.shape[d] // n
        splits.append((path, d, leaf.shape[d]))
        return leaf.narrow(d, idx * size, size).clone(memory_format=torch.contiguous_format)

    def visit(path, leaf):
        if is_quantized_leaf(leaf):
            return dict(leaf, q=place(f"{path}/q", leaf["q"]),
                        scale=place(f"{path}/scale", leaf["scale"]))
        return place(path, leaf) if isinstance(leaf, torch.Tensor) else leaf

    tree = _walk(sw.tree, visit)
    return dataclasses.replace(sw, tree=tree, layout=layout, splits=tuple(splits),
                               mesh=mesh)


def _spec_paths(specs: Tree, path: str = "") -> Dict[str, tuple]:
    """``{path: spec}`` of a spec tree, a quantized leaf's parts as
    ``path/q`` and ``path/scale``."""
    if isinstance(specs, dict):
        return {k: v for key, sub in specs.items()
                for k, v in _spec_paths(sub, f"{path}/{key}" if path else str(key)).items()}
    if isinstance(specs, list):
        return {k: v for i, sub in enumerate(specs)
                for k, v in _spec_paths(sub, f"{path}/{i}" if path else str(i)).items()}
    return {path: specs}


def _sum_over_group(mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """A partial product summed over the serving group (one all-reduce)."""
    return mesh.all_reduce(t, axis)


def serving_view(sw: ServingWeights) -> Tree:
    """The tree a dispatch reads, from placed weights: under
    ``weight_stationary`` a split product leaf is a :class:`KSlice` of this
    rank's rows; every other split leaf is gathered over the group (one
    all-gather a part).  Unplaced weights are their tree."""
    if not sw.splits:
        return sw.tree
    mesh = sw.mesh
    axis = serve_axis(mesh)
    n, idx = mesh.shape[axis], mesh.coords[axis]
    split = {p: d for p, d, _ in sw.splits}
    products = {p for p, _ in sw.products} if sw.layout == "weight_stationary" else set()

    def gather(t, d):
        return torch.cat(mesh.all_gather(t, axis), dim=d)

    def k_slice(local, rows):
        return KSlice(local=local, lo=idx * rows, hi=(idx + 1) * rows, k=rows * n,
                      reduce=lambda t: _sum_over_group(mesh, axis, t))

    def visit(path, leaf):
        if is_quantized_leaf(leaf):
            dq, ds = split.get(f"{path}/q"), split.get(f"{path}/scale")
            if path in products and dq == 0 and ds == 0:
                return k_slice(leaf, leaf["q"].shape[0])
            return dict(leaf, q=leaf["q"] if dq is None else gather(leaf["q"], dq),
                        scale=leaf["scale"] if ds is None else gather(leaf["scale"], ds))
        d = split.get(path)
        if d is None:
            return leaf
        if path in products and d == 0:
            return k_slice(leaf, leaf.shape[0])
        return gather(leaf, d)

    return _walk(sw.tree, visit)


def serving_params(sw: ServingWeights) -> Tree:
    """The params tree a dispatch hands the learner: :func:`serving_view`,
    then :func:`dequantize_params`."""
    return dequantize_params(sw, serving_view(sw))


def param_bytes(sw: ServingWeights) -> Dict[str, int]:
    """Resident parameter bytes of the stored tensors, in total and for the
    frozen slice, beside the fp32 bytes the same leaves would take."""
    tot = tot_fp32 = froz = froz_fp32 = 0

    def visit(path, leaf):
        nonlocal tot, tot_fp32, froz, froz_fp32
        if is_quantized_leaf(leaf):
            q, s = leaf["q"], leaf["scale"]
            nbytes = q.numel() * q.element_size() + s.numel() * s.element_size()
            fp32 = 4 * q.numel()
        elif isinstance(leaf, torch.Tensor):
            nbytes = leaf.numel() * leaf.element_size()
            fp32 = 4 * leaf.numel() if leaf.is_floating_point() else nbytes
        else:
            nbytes = fp32 = 0
        tot += nbytes
        tot_fp32 += fp32
        if path.split("/", 1)[0] in sw.frozen_roots:
            froz += nbytes
            froz_fp32 += fp32
        return leaf

    _walk(sw.tree, visit)
    return dict(resident_bytes=tot, fp32_bytes=tot_fp32,
                frozen_resident_bytes=froz, frozen_fp32_bytes=froz_fp32)
