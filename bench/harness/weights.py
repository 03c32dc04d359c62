"""The weights of a configuration, drawn on the device from the seed in one
call and laid out as the port's parameter tree (``bb``), the same tree the
reference reads.

Conv and linear weights are lecun-normal (std 1/sqrt(fan_in)), biases zero:
the port's own initialiser's distributions, not its draws.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

MASK64 = (1 << 64) - 1


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed from ``seed`` and ``parts`` (splitmix64 steps), so that
    every stream of a run (weights, images, H draws, arrivals) is its own."""
    z = seed & MASK64
    for p in (0x5EED,) + tuple(parts):
        z = (z + 0x9E3779B97F4A7C15 + (p & MASK64)) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z >> 1


def leaf_specs(cfg: Dict) -> List[Tuple]:
    """Every leaf of the configuration's tree: (path, shape, std) of the
    conv blocks (OIHW) and the linear head; std 0 is a zero leaf."""
    bb = cfg["backbone"]
    rows, ch = [], bb["in_channels"]
    for i, w in enumerate(bb["widths"]):
        rows.append((f"bb/blocks/{i}/w", (w, ch, 3, 3), 1.0 / math.sqrt(9 * ch)))
        rows.append((f"bb/blocks/{i}/b", (w,), 0.0))
        ch = w
    rows.append(("bb/head/w", (ch, bb["feature_dim"]), 1.0 / math.sqrt(ch)))
    rows.append(("bb/head/b", (bb["feature_dim"],), 0.0))
    return rows


def _insert(tree: Dict, path: str, leaf) -> None:
    """Put ``leaf`` at ``path`` ('/'-joined dict keys; a numeric key is a
    list index)."""
    keys = path.split("/")
    node = tree
    for k, nxt in zip(keys[:-1], keys[1:]):
        if isinstance(node, list):
            k = int(k)
            while len(node) <= k:
                node.append([] if nxt.isdigit() else {})
            node = node[k]
        else:
            node = node.setdefault(k, [] if nxt.isdigit() else {})
    node[keys[-1]] = leaf


def make_weights(torch, cfg: Dict, seed: int, device) -> Dict:
    """The configuration's parameter tree on ``device``: one normal draw
    for every weight together, then views scaled in place."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(shape) for _, shape, std in specs if std > 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: Dict = {}
    at = 0
    for path, shape, std in specs:
        if std > 0:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape).mul_(std)
            at += n
        else:
            leaf = torch.zeros(shape, device=device, dtype=torch.float32)
        _insert(tree, path, leaf)
    return tree


def paths(tree, prefix: str = "") -> Dict[str, object]:
    """``{path: leaf}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, object] = {}
    for k, v in items:
        out.update(paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()
