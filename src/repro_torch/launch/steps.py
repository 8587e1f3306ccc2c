"""The LM steps; port of ``repro.launch.steps``: the train step (with
gradient accumulation), the prefill and decode functions, the W4 packing
of an LM's weights, and the dry run's abstract trees and input specs.

``abstract_*`` build the trees on the ``meta`` device: every leaf has
its shape and dtype and no storage, and nothing is drawn, so the 1T
parameters of kimi-k2 take no byte of memory (the reference's
``jax.eval_shape`` trees of ShapeDtypeStructs; ``launch/dryrun.py``).

The train step takes plain tensors or DTensors placed by
``launch/sharding.py:param_shardings`` (inside ``launch/mesh.py:
mesh_scope``); DTensor's propagation computes the sharded step, and two
sites are explicit: each gradient is redistributed to its parameter's
placements (``reduce_grad``: the data-parallel reduction of a partial
sum), and the loss and the metrics are gathered whole (``to_full``)."""
from __future__ import annotations

import dataclasses
import math
import re

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.device import no_tf32
from repro_torch.common.sharding import to_full
from repro_torch.common.tree import (flatten_paths, tree_leaves, tree_map,
                                     unflatten_paths)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.qmodule import (PackedW4, encode_codes,
                                      pack_nibbles, pack_weight)
from repro_torch.models.lm import (LMConfig, cache_specs, decode_step,
                                   forward, init_caches, lm_init, loss_fn)
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.quant.search import search_weight_params

# Weights quantized for W4 serving (embed/lm_head stay high precision:
# the paper's io-layer convention).
QUANT_WEIGHT_RE = re.compile(
    r"((wq|wk|wv|wo|gate|up|down|in_proj|out_proj)/w|w_gate|w_up|w_down)$")


def dyadic_weights(params, shift: int = 0):
    """``params`` with every quantizable weight's output columns rescaled to
    absmax 0.75 * 2^-j, each column's largest entry set to exactly that:
    j = n % 4 for output column n, plus g % 3 for layer g of a stacked
    (G, ..., N) weight, plus ``shift``. Packed by ``quantize_lm_for_serving``, per tensor
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
            j = torch.arange(w.shape[-1], device=w.device) % 4 + shift
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


def reduce_grad(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements: a partial sum over
    the data-parallel ranks is reduced (all-reduce, or reduce-scatter
    onto a shard); a plain gradient as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(params, cfg: LMConfig, batch: dict):
    """(loss, grads): ``loss_fn`` on the batch and its gradient with
    respect to every leaf of ``params`` (the grads in the leaves' dtypes,
    as ``jax.value_and_grad`` gives them, and on their placements)."""
    with torch.enable_grad():
        ps = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(ps, cfg, batch["tokens"], batch.get("extra"))
        grads = torch.autograd.grad(loss, tree_leaves(ps))
    it = iter(grads)
    return (to_full(loss.detach()),
            tree_map(lambda p: reduce_grad(next(it), p), ps))


def make_train_step(cfg: LMConfig, acfg: AdamConfig, *, grad_accum: int = 1):
    """The standard train step: loss, gradient, Adam. ``grad_accum > 1``
    splits the batch into that many microbatches along its first axis and
    sums their gradients in f32, then divides loss and gradients by the
    count, as the reference's scan does. The step (backward included) runs
    with TF32 off: the reference computes in f32."""

    def train_step(params, opt, batch):
        with no_tf32():
            if grad_accum == 1:
                loss, grads = value_and_grad(params, cfg, batch)
            else:
                micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                      *v.shape[1:]) for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
                grads = tree_map(lambda t: torch.zeros_like(
                    t, dtype=torch.float32), params)
                for i in range(grad_accum):
                    li, gi = value_and_grad(
                        params, cfg, {k: v[i] for k, v in micro.items()})
                    loss = loss + li
                    grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                     grads, gi)
                loss = loss / grad_accum
                grads = tree_map(lambda g: g / grad_accum, grads)
            params, opt, metrics = adam_update(grads, opt, params, acfg)
        return params, opt, {"loss": loss, **{k: to_full(v) for k, v
                                              in metrics.items()}}

    return train_step


def make_prefill_step(cfg: LMConfig):
    """Full-sequence logits of a batch (the reference's prefill step: no
    cache is filled). Over W4 packs with no context every packed dense
    site runs K2's weight-only mode."""

    def prefill_step(params, batch):
        with torch.no_grad():
            return forward(params, cfg, batch["tokens"], batch.get("extra"))

    return prefill_step


def make_decode_fn(cfg: LMConfig, ctx=None):
    """``ctx``: optional ``QuantContext``; a serve-mode context routes the
    packed dense layers through the fused W4A4 kernel (K2)."""

    def serve_step(params, caches, token, pos):
        return decode_step(params, cfg, caches, token, pos, ctx=ctx)

    return serve_step


def _pack_stacked(leaf: torch.Tensor, qp: QuantizerParams) -> PackedW4:
    """``pack_weight`` of a stacked (G, ..., K, N) weight under its
    (G, 1, ..., 1) or (G, 1, ..., N) maxvals, encoded one (K, N) slice at
    a time: the bytes are the whole tensor's (the encode is elementwise),
    and the f32 temporaries are a slice's, not the stack's (an expert
    stack of llama4-scout is 2.7 G values a layer)."""
    fmt = qp.fmt
    mv = qp.maxval.to(leaf.device)
    zp = qp.zero_point.to(leaf.device)
    k, n = leaf.shape[-2:]
    packed = torch.empty((*leaf.shape[:-1], n // 2), dtype=torch.uint8,
                         device=leaf.device)
    flat_w = leaf.reshape(-1, k, n)
    flat_mv = mv.expand(*leaf.shape[:-2], *mv.shape[-2:]).reshape(
        -1, *mv.shape[-2:])
    flat_out = packed.view(-1, k, n // 2)
    for i in range(flat_w.shape[0]):
        flat_out[i] = pack_nibbles(encode_codes(flat_w[i], fmt, flat_mv[i],
                                                zp))
    return PackedW4(packed, mv.clone(), torch.broadcast_to(zp, mv.shape)
                    .clone(), fmt.exp_bits, fmt.man_bits, fmt.signed,
                    tuple(leaf.shape))


def quantize_lm_for_serving(params, bits: int = 4, *, searched: bool = True,
                            per_channel: bool = False):
    """Pack the quantizable LM weights to W4.

    A 2D weight gets one scale: with ``searched`` (the default, as the
    reference's) the paper's MSE search (``quant/search.py:
    search_weight_params``, format and maxval), else signed E2M1 at its
    absmax; ``per_channel`` keeps that
    format and refits the grid maximum per output column. Stacked
    (G, ..., N) weights take signed E2M1 absmax scales whatever
    ``searched`` says, as the reference does: one per slice, (G, 1, ...,
    1), or per (slice, column), (G, 1, ..., N). The bytes, scales and
    their types are the reference's for bf16 and f32 leaves (its type
    promotions are spelled out)."""
    out = {}
    for path, leaf in flatten_paths(params).items():
        if not (QUANT_WEIGHT_RE.search(path) and isinstance(leaf, torch.Tensor)
                and leaf.ndim >= 2 and leaf.shape[-1] % 2 == 0):
            out[path] = leaf
            continue
        if leaf.ndim == 2:
            a = leaf.abs()
            if searched:
                qp = search_weight_params(leaf, bits).params
            else:
                qp = QuantizerParams(KIND_FP_SIGNED, 2, 1, bits,
                                     a.max().to(torch.float32))
            if per_channel:
                absmax = a.max().clamp_min(1e-8)
                col = a.amax(0).clamp_min(1e-8)
                # the reference: bf16 col * f32 ratio promotes to f32
                ratio = qp.maxval / absmax.to(torch.float32)
                qp = dataclasses.replace(qp, maxval=col.to(torch.float32)
                                         * ratio)
            out[path] = pack_weight(leaf, qp)
        else:
            red = tuple(range(1, leaf.ndim - (1 if per_channel else 0)))
            mv = leaf.abs().amax(red, keepdim=True).clamp_min(1e-8)
            out[path] = _pack_stacked(leaf, QuantizerParams(
                KIND_FP_SIGNED, 2, 1, bits, mv.to(torch.float32)))
    return unflatten_paths(out)


# ---------------------------------------------------------------------------
# abstract trees (meta tensors) and input specs
# ---------------------------------------------------------------------------


def abstract_params(cfg: LMConfig):
    return lm_init(None, cfg, device="meta")


def abstract_opt(aparams, acfg: AdamConfig):
    return adam_init(aparams, acfg)


def abstract_caches(cfg: LMConfig, batch: int, s_max: int):
    return init_caches(cfg, batch, s_max, device="meta")


def _sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the ShapeDtypeStruct of the reference."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def quantize_abstract(aparams):
    """The quantizable weights replaced by abstract PackedW4 (the W4
    serving form): (..., N/2) uint8 codes, f32 scale and zero-point of
    shape () or, for a stacked (G, ..., N) weight, (G, 1, ..., 1)."""
    out = {}
    for path, leaf in flatten_paths(aparams).items():
        if (QUANT_WEIGHT_RE.search(path) and leaf.ndim >= 2
                and leaf.shape[-1] % 2 == 0):
            lead = leaf.shape[:-2]
            scale_shape = (*lead, 1, 1) if lead else ()
            out[path] = PackedW4(
                packed=_sds((*leaf.shape[:-1], leaf.shape[-1] // 2),
                            torch.uint8),
                scale=_sds(scale_shape, torch.float32),
                zero_point=_sds(scale_shape, torch.float32),
                exp_bits=2, man_bits=1, signed=True, shape=tuple(leaf.shape))
        else:
            out[path] = leaf
    return unflatten_paths(out)


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> dict:
    """Abstract inputs of one dry-run cell: the batch of a train or
    prefill step (with the vlm's image embeddings), or a decode step's
    caches, token and position (an int32 scalar, as the reference's; the
    port's decode takes it as a Python int, ``launch/dryrun.py`` passes
    the last slot)."""
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _sds((gb, s), torch.int32)}
        if cfg.family == "vlm":
            batch["extra"] = _sds((gb, cfg.n_img_tokens, cfg.d_vision),
                                  torch.bfloat16)
        return {"batch": batch}

    def make(spec):
        if isinstance(spec, dict) and "shape" in spec:
            return _sds(spec["shape"], spec["dtype"])
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return [make(v) for v in spec]

    return {"caches": make(cache_specs(cfg, gb, s)),
            "token": _sds((gb, 1), torch.int32),
            "pos": _sds((), torch.int32)}
