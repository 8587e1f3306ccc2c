"""Path-keyed trees (nested dicts of tensors); mirrors ``repro.common.tree``."""
from __future__ import annotations

from typing import Any


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
