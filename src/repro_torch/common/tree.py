"""Path-keyed trees (nested dicts of tensors); mirrors ``repro.common.tree``.

``tree_leaves`` and ``tree_map`` walk dicts in sorted key order, as
``jax.tree`` does, so a sum over leaves adds them in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_paths(tree: Any, prefix: str = "", sep: str = "/") -> dict[str, Any]:
    """Nested dicts/lists -> {'a/b/#0/c': leaf} (lists keyed '#<idx>')."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_paths(v, f"{prefix}{k}{sep}", sep))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_paths(v, f"{prefix}#{i}{sep}", sep))
    else:
        out[prefix[: -len(sep)]] = tree
    return out


def unflatten_paths(flat: dict[str, Any], sep: str = "/") -> Any:
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.startswith("#") for k in node):
            return [node[f"#{i}"] for i in range(len(node))]
        return node

    return listify(root)
