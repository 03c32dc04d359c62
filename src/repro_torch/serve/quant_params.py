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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import HWIO_TO_OIHW, OIHW_TO_HWIO
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



@dataclasses.dataclass(frozen=True)
class ServingWeights:
    """Params with the frozen slice quantized (or untouched: mode 'none').

    tree: the param tree; quantized leaves are ``{q, scale, n}`` dicts.
    quant_paths: '/'-joined paths of the quantized leaves.
    native_paths: the subset consumed as int8 by the backbone's matmul.
    frozen_roots: the kind's frozen top-level keys.
    mode: 'none' | 'int8'.
    """

    tree: Tree
    quant_paths: Tuple[str, ...] = ()
    native_paths: Tuple[str, ...] = ()
    frozen_roots: Tuple[str, ...] = ()
    mode: str = "none"


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


def quantize_frozen(learner, params: Tree, mode: str = "int8") -> ServingWeights:
    """Quantize the frozen slice of ``params`` for serving (mode 'none'
    wraps params untouched)."""
    if mode not in SERVE_QUANT_MODES:
        raise ValueError(f"unknown serve_quant mode {mode!r}; "
                         f"choose from {SERVE_QUANT_MODES}")
    roots = FROZEN_SLICES.get(learner.cfg.kind, ())
    if mode == "none" or not roots:
        return ServingWeights(tree=params, frozen_roots=roots, mode="none")
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
                          frozen_roots=roots, mode="int8")


def dequantize_params(sw: ServingWeights) -> Tree:
    """A params tree the learner can consume: quantized leaves expanded to
    fp32 (4-D ones back to OIHW), native-path leaves left int8."""
    if sw.mode == "none":
        return sw.tree
    native = set(sw.native_paths)

    def visit(path, leaf):
        if not is_quantized_leaf(leaf) or path in native:
            return leaf
        w = dequantize(leaf)
        return w.permute(*HWIO_TO_OIHW).contiguous() if w.dim() == 4 else w

    return _walk(sw.tree, visit)


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
