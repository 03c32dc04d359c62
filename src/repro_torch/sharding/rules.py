"""Partition rules: map the parameter, optimizer-state, batch and cache
trees to specs (the JAX package's ``repro/sharding/rules.py``, rule for
rule).

  * ``model`` = tensor / expert parallel: attention heads, FFN hidden, the
    MoE expert dim, vocab;
  * ``data`` (and ``pod`` where the mesh has it) = data parallel for the
    batch and for the second parameter dim (FSDP), so no parameter is
    whole on every rank;
  * the rules read a leaf's name and rank; :func:`sanitize` then drops each
    axis the mesh lacks or that does not divide the dim.

An LM leaf has one layout in both packages (only 4-D conv weights change
layout across :mod:`repro_torch.bridge`), so the port's trees take the
reference's rules leaf for leaf.  The trees are nested dicts and lists of
tensors (``meta`` ones serve); a path is its keys joined by ``/``, as the
reference's ``_path_str`` joins them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

from repro_torch.common.tree import tree_map
from repro_torch.sharding.ctx import P, is_spec, sanitize_tree

FSDP = ("pod", "data")   # sanitize drops 'pod' on single-pod meshes


def _pad(spec: Tuple, ndim: int) -> P:
    """Left-pad a trailing-dims spec with None (layer-stack leading dims)."""
    pad = ndim - len(spec)
    return P(*([None] * pad + list(spec)))


def _param_rule(path: str, ndim: int) -> P:
    """Spec for the TRAILING dims implied by the leaf name."""
    name = path.split("/")[-1]

    # embeddings / unembedding: (V, D) — vocab over model, D over data
    if name in ("embed", "lm_head"):
        return _pad((("model",), FSDP), ndim)

    # MoE shared experts: small (D, F_shared), kept off the model axis
    if "shared" in path and name in ("w_gate", "w_up"):
        return _pad((FSDP, None), ndim)
    if "shared" in path and name == "w_down":
        return _pad((None, FSDP), ndim)

    # MoE expert banks: (E, D, F) / (E, F, D) — E over model (EP)
    if "ffn" in path and name in ("w_gate", "w_up") and ndim >= 3:
        return _pad((("model",), FSDP, None), ndim)
    if "ffn" in path and name == "w_down" and ndim >= 3:
        return _pad((("model",), None, FSDP), ndim)
    if name == "router":
        return _pad((FSDP, None), ndim)

    # dense FFN: (D, F) / (F, D)
    if name in ("w_gate", "w_up"):
        return _pad((FSDP, ("model",)), ndim)
    if name == "w_down":
        return _pad((("model",), FSDP), ndim)

    # attention projections
    if name in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b"):
        return _pad((FSDP, ("model",)), ndim)        # out dim = heads
    if name in ("wq_a", "wkv_a"):
        return _pad((FSDP, None), ndim)              # low-rank out is small
    if name == "wo":
        return _pad((("model",), FSDP), ndim)
    if name in ("bq", "bk", "bv"):
        return _pad((("model",),), ndim)

    # mamba
    if name == "in_proj":
        return _pad((FSDP, ("model",)), ndim)
    if name == "out_proj":
        return _pad((("model",), FSDP), ndim)
    if name == "conv_w":
        return _pad((("model",), None), ndim)
    if name in ("conv_b", "gate_norm"):
        return _pad((("model",),), ndim)

    # everything 1-D-ish (norm scales, dt_bias, A_log, D) replicates
    return P(*([None] * ndim))


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def param_specs(abstract_params: Any) -> Any:
    """A spec tree matching ``abstract_params``
    (:func:`repro_torch.launch.specs.abstract_params_for`)."""
    return map_with_path(lambda path, leaf: _param_rule(path, _ndim(leaf)), abstract_params)


def opt_state_specs(abstract_opt: Any, pspecs_example: Any = None) -> Any:
    """The optimizer state mirrors the params: ``mu`` / ``nu`` leaves are
    named as their params; an int8 state's ``q`` and ``scale`` take the rule
    of their parent's name alone (so an expert bank's ``q`` takes the dense
    FFN's rule, as the reference's does), and ``scale``'s blocked last dim
    is left to :func:`sanitize`; ``count`` and ``n`` replicate."""
    del pspecs_example

    def rule(p, leaf):
        name = p.split("/")[-1]
        if name in ("count", "n") or not hasattr(leaf, "shape"):
            return P()
        if name in ("q", "scale"):
            return _param_rule(p.split("/")[-2], _ndim(leaf))
        return _param_rule(p, _ndim(leaf))

    return map_with_path(rule, abstract_opt)


def batch_specs(abstract_batch: Any) -> Any:
    """Batch: leading dim over (pod, data); tokens replicate over model."""
    def rule(_path, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return P()
        return P(*([FSDP] + [None] * (nd - 1)))
    return map_with_path(rule, abstract_batch)


def cache_specs(abstract_cache: Any, batch_size: int, data_size: int,
                model_size: int = 16) -> Any:
    """Decode caches: (L, B, S, H, Dh)-style leaves.

      * batch shards over (pod,)data when divisible; else the sequence axis
        takes the data axis (long-context batch=1 cells);
      * heads shard over model when divisible; otherwise the SEQUENCE axis
        shards over model (sequence-parallel decode).
    """
    big_batch = batch_size % max(data_size, 1) == 0 and batch_size >= data_size

    def rule(path, leaf):
        p = path.split("/")[-1]
        nd = _ndim(leaf)
        if nd == 0:
            return P()
        if p in ("k", "v", "cross_k", "cross_v"):     # (L|G, B, S, H, Dh)
            n_heads = leaf.shape[3]
            b_entry = FSDP if big_batch else None
            s_entry = None if big_batch else FSDP
            if n_heads % model_size == 0:
                return P(None, b_entry, s_entry, "model", None)
            if big_batch:
                return P(None, b_entry, "model", None, None)
            return P(None, None, (FSDP[-1], "model") if s_entry else "model",
                     None, None)
        if p in ("ckv", "krope"):       # (L, B, S, R) — latent: shard S
            b_entry = FSDP if big_batch else None
            return P(None, b_entry, "model" if big_batch else (FSDP[-1], "model"),
                     None)
        if p == "conv":                 # (L, B, C, k-1)
            return P(None, FSDP if big_batch else None, "model", None)
        if p == "ssm":                  # (L, B, H, P, N)
            return P(None, FSDP if big_batch else None, "model", None, None)
        return P(*([None] * nd))

    return map_with_path(rule, abstract_cache)


def sanitize(specs: Any, abstract: Any, mesh) -> Any:
    return sanitize_tree(specs, abstract, mesh)


def tp_off_batch_axes(tp_enabled: bool, global_batch: int, mesh_shape) -> Optional[Tuple[str, ...]]:
    """The reference dry run's ``tp_enabled=False`` rule
    (``repro/launch/dryrun.py:114-135``): walk ``pod``, ``data``, ``model``
    in that order, adding an axis while ``global_batch`` divides by the
    product so far.  Where that product is the whole mesh and the config
    turns tensor parallelism off, the batch splits over those axes (pure
    data parallelism, ``model`` folded into the batch) and ``model`` is
    stripped from every spec (:func:`strip_axes`): the axes are returned.
    Otherwise None: the batch splits over (pod,) data and ``model`` stays."""
    sizes = dict(mesh_shape)
    axes, prod = [], 1
    for ax in ("pod", "data", "model"):
        if ax in sizes and global_batch % (prod * sizes[ax]) == 0:
            axes.append(ax)
            prod *= sizes[ax]
    full_dp = prod == math.prod(sizes.values())
    return tuple(axes) if (not tp_enabled and full_dp and "model" in axes) else None


def strip_axes(specs: Any, axes=("model",)) -> Any:
    """Remove named axes from every spec (``tp_enabled=False``: pure DP /
    FSDP)."""

    def fix(s):
        out = []
        for e in tuple(s):
            if e is None:
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(n for n in e if n not in axes)
                out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
            else:
                out.append(None if e in axes else e)
        return P(*out)

    return tree_map(fix, specs, is_leaf=is_spec)
