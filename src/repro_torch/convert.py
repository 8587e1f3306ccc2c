"""Carry the JAX package's state into the port, from numpy.

The JAX package's trees (UNet and LM params, TALoRA hubs, router) are
nested dicts and lists of arrays keyed exactly as the port's; f32, bf16,
integer and bool leaves carry over bit for bit. The caller hands them over as
numpy (``jax.tree.map(np.asarray, tree)``), so the port never imports JAX;
``from_numpy_tree`` maps every leaf onto ``device`` and keeps the nesting
and the keys as they are, so every leaf keeps its ``/``-path (TALoRA hub
keys are themselves ``/``-joined weight paths such as ``mid.attn/q/w``).

The pipeline's state comes across the same way: a ``QuantPlan`` with each
site's ``QuantizerParams`` and ``SiteInfo`` (``plan_from_numpy``), a
``CalibrationDB`` (``calibration_db_from_numpy``) and the Adam state
(``adam_state_from_numpy``); TALoRA hubs and the router are trees.
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


def quantizer_params_from_numpy(d, device="cuda"):
    """A quantizer's fields -> ``QuantizerParams`` on ``device``: ``d`` maps
    kind, exp_bits, man_bits, bits, maxval and zero_point (numpy)."""
    from repro_torch.quant.fakequant import QuantizerParams
    dev = resolve_device(device)

    def f32(v):
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)

    return QuantizerParams(int(d["kind"]), int(d["exp_bits"]),
                           int(d["man_bits"]), int(d["bits"]),
                           f32(d["maxval"]), f32(d["zero_point"]))


def plan_from_numpy(d, device="cuda"):
    """A plan as nested mappings -> ``QuantPlan``: ``{"sites": {name: {"qp":
    ..., "is_weight", "is_aal", "mse", "diagnostics"}}, "bits_w",
    "bits_a", "mode"}``, each ``qp`` as ``quantizer_params_from_numpy``
    takes it."""
    from repro_torch.core.msfp import QuantPlan, SiteInfo
    sites = {name: SiteInfo(quantizer_params_from_numpy(s["qp"], device),
                            bool(s["is_weight"]), bool(s["is_aal"]),
                            float(s["mse"]),
                            {k: float(v) for k, v in
                             s.get("diagnostics", {}).items()})
             for name, s in d["sites"].items()}
    return QuantPlan(sites, int(d["bits_w"]), int(d["bits_a"]), str(d["mode"]))


def calibration_db_from_numpy(d):
    """``{"sample_cap": int, "sites": {name: {"samples", "x_min", "x_max",
    "n_seen"}}}`` -> ``CalibrationDB`` (samples stay numpy on the host)."""
    from repro_torch.quant.calibrate import CalibrationDB, SiteStats
    db = CalibrationDB(int(d["sample_cap"]))
    for name, s in d["sites"].items():
        db.sites[name] = SiteStats(np.array(s["samples"], dtype=np.float32),
                                   float(s["x_min"]), float(s["x_max"]),
                                   int(s["n_seen"]))
    return db


def adam_state_from_numpy(d, device="cuda") -> dict:
    """``{"m": tree, "v": tree, "step": int}`` -> the port's Adam state (the
    moments' trees keep their nesting; ``step`` a 0-d int32 tensor)."""
    dev = resolve_device(device)
    return {"m": from_numpy_tree(d["m"], dev),
            "v": from_numpy_tree(d["v"], dev),
            "step": torch.tensor(int(np.asarray(d["step"])), dtype=torch.int32,
                                 device=dev)}
