"""Carry parameters and optimizer state between the JAX package's layout
and the port's.

The two packages' trees have the same nested dicts, lists and leaf paths.
They differ in one place: a 4-D conv weight is HWIO in the JAX package and
OIHW in the port.  Blockwise-int8 ``{q, scale, n}`` leaves (frozen serving
weights, the int8 AdamW state) are the JAX package's layout in both, their
conv weights HWIO, so they cross as they are.

``params_from_numpy(tree)`` takes a JAX params pytree whose leaves are
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
params; ``opt_state_from_numpy(opt)`` does the same for an AdamW state
``{mu, nu, count}``, ``mu`` and ``nu`` mirroring the params.
``params_to_numpy`` and ``opt_state_to_numpy`` are their inverses, and
:func:`to_jax_layout` the same layout change on tensors, which the
checkpoints store.  With the same weights both packages compute the same
function.

The LM families have no conv weight of that kind: ``lm_params_from_numpy``
carries a JAX LM's params (stacked layers, leading L axis; an MoE layer's
router, (L, E, D, F) experts and nested ``shared`` dict; MLA's latent
projections and norms; mamba2's 3-D depthwise ``conv_w`` (L, c, k);
zamba2's ``mamba`` stack and its ``shared`` block, whose 2-D MLP leaves
share the experts' keys; whisper's ``encoder`` and ``decoder`` stacks, at
most 3-D) across as they are, ``lm_state_from_numpy`` /
``lm_state_to_numpy`` an LM train state ``dict(params, opt)`` (AdamW
``mu`` and ``nu`` in fp32, bf16 or int8 ``{q, scale, n}``, and ``count``)
both ways, and ``lm_cache_from_numpy`` its cache (``k``, ``v`` (L, B, S,
H, D), or MLA's latent ``ckv`` (L, B, S, R) and ``krope`` (L, B, S,
rope); mamba2's ``conv`` (L, B, c, k-1) and fp32 ``ssm`` (L, B, h, p, n);
zamba2's per-site ``k``, ``v`` (G, B, S, H, D) beside its mamba layers'
states; whisper's ``cross_k``, ``cross_v`` (L, B, S_enc, H, D) beside its
``k``, ``v``; ``len`` a Python int in the port).  A meta-learner over an LM backbone
crosses with ``learner_params_from_numpy`` (and back with
``learner_params_to_numpy``): its ``bb`` subtree as an LM tree, the rest
(set encoder, FiLM generator, head generator) as above.  A leaf's rank
alone does not decide: a stacked (L, E, D, F) expert weight is 4-D and not
a conv weight (:func:`is_conv_weight`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.optim.quant import is_quantized

HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


# an MoE layer's stacked (L, E, D, F) experts: 4-D, one layout in both packages
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def is_conv_weight(t, key) -> bool:
    """A leaf whose layout differs between the packages: a 4-D floating
    tensor outside a quantized leaf (HWIO in the JAX package, OIHW here),
    but for an MoE layer's stacked experts (``key`` in EXPERT_KEYS)."""
    return (key not in EXPERT_KEYS and torch.is_tensor(t) and t.dim() == 4
            and t.is_floating_point())


# the error-feedback residual ``opt['ef']`` stacks one copy of the params
# per dcn row on a leading axis: a conv weight there is 5-D, (dcn, O, I, H,
# W) here and (dcn, H, W, I, O) in the JAX package
EF_OIHW_TO_HWIO = (0, 3, 4, 2, 1)
EF_HWIO_TO_OIHW = (0, 4, 3, 1, 2)


def is_stacked_conv_weight(t, path: str) -> bool:
    """A leaf of an ``ef`` subtree (``path`` has an ``ef`` part) that stacks
    conv weights: 5-D floating, its key not an expert's."""
    parts = path.split("/")
    return ("ef" in parts[:-1] and parts[-1] not in EXPERT_KEYS and torch.is_tensor(t)
            and t.dim() == 5 and t.is_floating_point())


def _walk(tree: Any, fn, path: str = "") -> Any:
    """``tree`` rebuilt with ``fn(leaf, path)`` at every leaf, ``path`` the
    leaf's dict keys and list indices joined by "/"; a quantized dict goes
    to ``fn`` whole."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}/{i}") for i, v in enumerate(tree))
    return fn(tree, path)


def _leaf_to_jax_layout(t, path: str) -> Any:
    if is_conv_weight(t, path.rsplit("/", 1)[-1]):
        return t.permute(*OIHW_TO_HWIO).contiguous()
    if is_stacked_conv_weight(t, path):
        return t.permute(*EF_OIHW_TO_HWIO).contiguous()
    return t


def to_jax_layout(tree: Any) -> Any:
    """The port's tree with its conv weights turned OIHW -> HWIO (and the
    stacked ones of an ``ef`` subtree on their trailing four dims)."""
    return _walk(tree, _leaf_to_jax_layout)


def _from_np(a, device) -> Any:
    if isinstance(a, (int, float, bool)) or a is None:
        return a
    a = np.array(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: torch reads its bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_from_numpy(a, path, device) -> Any:
    if is_quantized(a):
        return _lm_leaf_from_numpy(a, device)
    t = _from_np(a, device)
    return t.permute(*HWIO_TO_OIHW).contiguous() \
        if is_conv_weight(t, path.rsplit("/", 1)[-1]) else t


def _to_np(t) -> Any:
    if not torch.is_tensor(t):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                 # numpy has no bf16 of its own
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """JAX-layout numpy params -> port params on ``device``: the card
    unless the caller asks for the CPU."""
    return _walk(tree, lambda a, path: _leaf_from_numpy(a, path, device))


def params_to_numpy(tree: Any) -> Any:
    """Port params -> JAX-layout numpy params (quantized leaves' ``n`` an
    int)."""
    return _walk(to_jax_layout(tree), lambda t, _: _lm_leaf_to_numpy(t))


def opt_state_from_numpy(opt: Any, device="cuda") -> Any:
    """JAX-layout numpy AdamW state ``{mu, nu, count}`` -> the port's."""
    return dict(mu=params_from_numpy(opt["mu"], device),
                nu=params_from_numpy(opt["nu"], device),
                count=torch.from_numpy(np.array(opt["count"])).to(device))


def opt_state_to_numpy(opt: Any) -> Any:
    """The port's AdamW state -> JAX-layout numpy ``{mu, nu, count}``."""
    return dict(mu=params_to_numpy(opt["mu"]), nu=params_to_numpy(opt["nu"]),
                count=_to_np(opt["count"]))


def _lm_leaf_from_numpy(a, device) -> Any:
    if is_quantized(a):
        return dict(q=_from_np(a["q"], device), scale=_from_np(a["scale"], device),
                    n=int(a["n"]) if a.get("n") is not None else int(np.shape(a["q"])[-1]))
    return _from_np(a, device)


def _lm_leaf_to_numpy(t) -> Any:
    return {k: _to_np(v) for k, v in t.items()} if is_quantized(t) else _to_np(t)


def lm_params_from_numpy(tree: Any, device="cuda") -> Any:
    """A JAX LM's numpy params -> the port's on ``device``, leaf by leaf,
    in the same layout."""
    return _walk(tree, lambda a, _: _lm_leaf_from_numpy(a, device))


def lm_state_from_numpy(state: Any, device="cuda") -> Any:
    """A JAX LM train state ``dict(params, opt)`` with numpy leaves (a
    restored checkpoint, or ``jax.tree.map(np.asarray, state)``) -> the
    port's on ``device``, every leaf by its path in the same layout."""
    opt = state["opt"]
    return dict(params=lm_params_from_numpy(state["params"], device),
                opt=dict(mu=lm_params_from_numpy(opt["mu"], device),
                         nu=lm_params_from_numpy(opt["nu"], device),
                         count=torch.from_numpy(np.array(opt["count"])).to(device)))


def lm_state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`lm_state_from_numpy`: numpy leaves in the JAX
    package's layout (quantized leaves' ``n`` an int)."""
    return _walk(state, lambda t, _: _lm_leaf_to_numpy(t))


def lm_cache_from_numpy(cache: Any, device="cuda") -> Any:
    """A JAX LM's numpy cache (GQA's k and v, MLA's ckv and krope, the SSM
    layers' conv and ssm, zamba2's per-site k and v) -> the port's on
    ``device``, every leaf in its dtype and layout."""
    return {k: int(np.asarray(v)) if k == "len" else _from_np(v, device)
            for k, v in cache.items()}


def learner_params_from_numpy(tree: Any, device="cuda") -> Any:
    """A JAX meta-learner's numpy params over an LM backbone -> the port's
    on ``device``: ``bb`` by :func:`lm_params_from_numpy`, every other
    subtree by :func:`params_from_numpy`."""
    return {k: (lm_params_from_numpy if k == "bb" else params_from_numpy)(v, device)
            for k, v in tree.items()}


def learner_params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`learner_params_from_numpy`."""
    return {k: _walk(v, lambda t, _: _to_np(t)) if k == "bb" else params_to_numpy(v)
            for k, v in tree.items()}
