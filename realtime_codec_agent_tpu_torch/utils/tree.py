"""Param trees: nested dicts and lists of tensors, addressed by dotted paths."""
from __future__ import annotations

from typing import Any, List, Tuple


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf) of every leaf, in insertion order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def tree_map(fn, tree):
    """``fn`` of every leaf; dicts stay dicts, lists and tuples become lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
