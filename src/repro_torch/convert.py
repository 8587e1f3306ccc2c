"""Carry JAX parameter trees into the port.

The JAX package's trees (UNet and LM params, TALoRA hubs, router) are
nested dicts and lists of arrays keyed exactly as the port's; f32, bf16,
integer and bool leaves carry over bit for bit. The caller hands them over as
numpy (``jax.tree.map(np.asarray, tree)``), so the port never imports JAX;
``from_numpy_tree`` maps every leaf onto ``device`` and keeps the nesting
and the keys as they are, so every leaf keeps its ``/``-path (TALoRA hub
keys are themselves ``/``-joined weight paths such as ``mid.attn/q/w``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.device import resolve_device


def from_numpy_tree(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v, f"{path}#{i}/")
                              for i, v in enumerate(node))
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
            # JAX's bf16 reaches numpy as an extension dtype (kind "V"):
            # carry its bits over as uint16
            bits = torch.from_numpy(np.array(arr).view(np.uint16))
            return bits.view(torch.bfloat16).to(dev)
        if arr.dtype.kind not in "fiub":
            raise TypeError(f"{path[:-1]}: unsupported leaf dtype {arr.dtype}")
        return torch.from_numpy(np.array(arr)).to(dev)

    return conv(tree, "")
