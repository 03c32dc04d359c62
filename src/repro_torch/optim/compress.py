"""Error-feedback int8 gradient compression for the cross-node reduction
(the JAX package's ``repro/optim/compress.py``).

Compression is a gradient transform around the reduction:

    q, new_err = compress(g + err)      # int8 blockwise + residual memory
    g_hat      = decompress(q)          # the value the reduction sums

:func:`compressed_all_reduce` is the reduction over a mesh axis: each leaf
of ``grads + err`` is quantized as it stands, block by block along its last
axis (:func:`repro_torch.optim.quant.quantize`), so the block edges and the
numbers are the JAX package's; a conv weight, OIHW here and HWIO there, is
quantized over its HWIO view, as the int8 AdamW state is
(:mod:`repro_torch.optim.adamw`).  The int8 payloads of every leaf go in
one buffer and their fp32 scales in another, and each buffer crosses the
axis in ONE all-gather, so a step makes two collectives whatever the number
of leaves, about 1.03 bytes an element against 4 for an fp32 all-reduce.
Every rank decodes every rank's part and sums them locally, in rank order,
which equals the sum of the per-rank decoded values.  The carried residual
keeps the long-run quantization bias at zero.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.bridge import HWIO_TO_OIHW, OIHW_TO_HWIO, is_conv_weight
from repro_torch.common.tree import tree_leaves, tree_paths, tree_rebuild
from repro_torch.optim.quant import BLOCK, dequantize, quantize

Tree = Any


def _views(tree: Tree) -> List[Tuple[torch.Tensor, bool]]:
    """Each leaf in the JAX package's layout, and whether it was permuted."""
    out = []
    for path, t in tree_paths(tree).items():
        conv = is_conv_weight(t, path.rsplit("/", 1)[-1])
        out.append((t.permute(*OIHW_TO_HWIO) if conv else t, conv))
    return out


def _back(x: torch.Tensor, conv: bool) -> torch.Tensor:
    return x.permute(*HWIO_TO_OIHW).contiguous() if conv else x


def _quantized(grads: Tree, err: Tree):
    """Per leaf: (q, g_hat, residual, conv), the first three in the JAX
    layout."""
    out = []
    for (g, conv), (e, _) in zip(_views(grads), _views(err)):
        tot = g.to(torch.float32) + e
        q = quantize(tot)
        g_hat = dequantize(q, tot.shape[-1])
        out.append((q, g_hat, tot - g_hat, conv))
    return out


def ef_compress(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """Compress ``grads + err`` to int8 leaf by leaf; returns (g_hat,
    new_err): g_hat is what the reduction sums, new_err = (g + err) - g_hat
    is carried to the next step."""
    parts = _quantized(grads, err)
    return (tree_rebuild(grads, [_back(h, c).to(g.dtype) for (_, h, _, c), g in
                                 zip(parts, tree_leaves(grads))]),
            tree_rebuild(grads, [_back(r, c) for _, _, r, c in parts]))


def zeros_error(grads: Tree) -> Tree:
    return tree_rebuild(grads, [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                for g in tree_leaves(grads)])


def compressed_all_reduce(grads: Tree, mesh, axis: str, err: Tree) -> Tuple[Tree, Tree]:
    """Quantize locally, send only the int8 payloads and the block scales
    over ``axis`` of ``mesh`` (:class:`repro_torch.launch.mesh.DPMesh`), two
    all-gathers in all, decode every rank's part and sum in rank order.
    Returns (the sum of the per-rank decoded values, the new residual)."""
    parts = _quantized(grads, err)
    all_q = mesh.all_gather(torch.cat([q["q"].reshape(-1) for q, *_ in parts]), axis)
    all_s = mesh.all_gather(torch.cat([q["scale"].reshape(-1) for q, *_ in parts]), axis)
    summed = []
    qo = so = 0
    for (q, _, _, conv), g in zip(parts, tree_leaves(grads)):
        nq, ns = q["q"].numel(), q["scale"].numel()
        acc = None
        for rq, rs in zip(all_q, all_s):
            part = dequantize(dict(q=rq[qo:qo + nq].reshape(q["q"].shape),
                                   scale=rs[so:so + ns].reshape(q["scale"].shape)),
                              q["q"].shape[-1])
            acc = part if acc is None else acc + part
        summed.append(_back(acc, conv).to(g.dtype))
        qo, so = qo + nq, so + ns
    return tree_rebuild(grads, summed), tree_rebuild(grads, [_back(r, c)
                                                             for _, _, r, c in parts])


def compressed_scale_bytes(params: Tree) -> int:
    """The fp32 scale bytes of one rank's payload for a gradient shaped as
    ``params``: one scale a 128-block of each leaf's last axis in the JAX
    layout."""
    total = 0
    for v, _ in _views(params):
        shape = tuple(v.shape) or (1,)
        total += (v.numel() // shape[-1]) * -(-shape[-1] // BLOCK) * 4
    return total
