"""LM serving steps; port of the serving part of ``repro.launch.steps``:
the decode function and the W4 packing of an LM's weights."""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.core.qmodule import pack_weight
from repro_torch.models.lm import LMConfig, decode_step
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams

# Weights quantized for W4 serving (embed/lm_head stay high precision:
# the paper's io-layer convention).
QUANT_WEIGHT_RE = re.compile(
    r"((wq|wk|wv|wo|gate|up|down|in_proj|out_proj)/w|w_gate|w_up|w_down)$")


def dyadic_weights(params):
    """``params`` with every quantizable weight's output columns rescaled to
    absmax 0.75 * 2^-j, each column's largest entry set to exactly that:
    j = n % 4 for output column n, plus g % 3 for layer g of a stacked
    (G, ..., N) weight. Packed by ``quantize_lm_for_serving``, per tensor
    or per channel, every grid scale is then a power of two that differs
    from layer to layer (and, per channel, from column to column), every
    decoded weight and every E2M1-snapped act a short dyadic number, and
    every W4A4 product sums exactly in f32 in any order. Parity checks
    between implementations that sum in different orders use it: on
    generic weights the order of the sums decides FP4 and act-grid ties
    (ROADMAP Queue C)."""
    flat = flatten_paths(params)
    for path, w in flat.items():
        if QUANT_WEIGHT_RE.search(path):
            j = torch.arange(w.shape[-1], device=w.device) % 4
            if w.ndim > 2:
                lead = w.shape[:-2]
                j = j + (torch.arange(math.prod(lead), device=w.device)
                         % 3).reshape(*lead, 1, 1)
            target = (0.75 * torch.exp2(-j.to(torch.float32))).to(w.dtype)
            w = w / w.abs().amax(-2, keepdim=True) * target
            top = w.abs().argmax(-2, keepdim=True)
            top_v = torch.where(w.gather(-2, top) < 0, -target, target)
            flat[path] = w.scatter(-2, top, top_v.expand_as(top).to(w.dtype))
    return unflatten_paths(flat)


def make_decode_fn(cfg: LMConfig, ctx=None):
    """``ctx``: optional ``QuantContext``; a serve-mode context routes the
    packed dense layers through the fused W4A4 kernel (K2)."""

    def serve_step(params, caches, token, pos):
        return decode_step(params, cfg, caches, token, pos, ctx=ctx)

    return serve_step


def quantize_lm_for_serving(params, bits: int = 4, *, searched: bool = False,
                            per_channel: bool = False):
    """Pack the quantizable LM weights to signed E2M1 W4 with absmax scales.

    2D weights get one scale (``per_channel``: one per output column, the
    grid maximum refit per column); stacked (G, ..., N) weights one per
    slice, (G, 1, ..., 1), or per (slice, column), (G, 1, ..., N). The
    bytes, scales and their types are the reference's for bf16 and f32
    leaves (its type promotions are spelled out). ``searched=True`` (the
    LM weights through item 10's MSE search, ``quant/search.py``) is
    ROADMAP Queue A item 12b."""
    if searched:
        raise NotImplementedError("searched LM formats (quant/search.py, "
                                  "ROADMAP Queue A item 10) are item 12b")
    out = {}
    for path, leaf in flatten_paths(params).items():
        if not (QUANT_WEIGHT_RE.search(path) and isinstance(leaf, torch.Tensor)
                and leaf.ndim >= 2 and leaf.shape[-1] % 2 == 0):
            out[path] = leaf
            continue
        a = leaf.abs()
        if leaf.ndim == 2:
            qp = QuantizerParams(KIND_FP_SIGNED, 2, 1, bits,
                                 a.max().to(torch.float32))
            if per_channel:
                absmax = a.max().clamp_min(1e-8)
                col = a.amax(0).clamp_min(1e-8)
                # the reference: bf16 col * f32 ratio promotes to f32
                ratio = qp.maxval / absmax.to(torch.float32)
                qp = dataclasses.replace(qp, maxval=col.to(torch.float32)
                                         * ratio)
        else:
            red = tuple(range(1, leaf.ndim - (1 if per_channel else 0)))
            mv = a.amax(red, keepdim=True).clamp_min(1e-8)
            qp = QuantizerParams(KIND_FP_SIGNED, 2, 1, bits,
                                 mv.to(torch.float32))
        out[path] = pack_weight(leaf, qp)
    return unflatten_paths(out)
