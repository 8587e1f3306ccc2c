"""DDPM/LDM-style UNet epsilon-predictor; port of ``repro.nn.unet``.

Same param tree as the reference, path for path (``down_0.res_0/conv1/w``
...), NHWC activations and HWIO conv weights, so a JAX tree converts by
path (``repro_torch.convert``).

With a ``UNetConfig.context_dim`` each attention block is instead Stable
Diffusion's spatial transformer (Rombach et al. 2022; CompVis
``ldm/modules/attention.py``): GroupNorm (eps 1e-6), a 1x1 ``proj_in``,
then LayerNorm -> multi-head self-attention, LayerNorm -> cross-attention
to the row's text ``context``, LayerNorm -> GEGLU feed-forward, each with
its residual, a 1x1 ``proj_out`` and the block's residual. Its denses and
1x1 convs go through ``dense_apply``/``conv2d_apply`` (W4A4 on the
kernels like every other site); the attention products and softmax are
f32 (``attention``). That path has no JAX counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.common.device import no_tf32
from repro_torch.common.tree import flatten_paths
from repro_torch.core.talora import lora_target_dims_from_weights
from repro_torch.nn.embeddings import timestep_embedding
from repro_torch.nn.layers import (conv2d_apply, conv2d_init, dense_apply,
                                   dense_init, groupnorm_apply, groupnorm_init,
                                   layernorm_apply, layernorm_init, silu)

# the most f32 scores one query block of ``attention`` holds (1 GiB)
ATTN_BLOCK_SCORES = 1 << 28
_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 32
    in_ch: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    num_classes: int | None = None
    gn_groups: int = 32
    # Stable Diffusion's text-to-image UNet (``context_dim`` > 0): spatial
    # transformers with ``num_heads`` heads in place of the attention
    # blocks, cross-attending to a (tokens, context_dim) text context a row
    num_heads: int = 1
    context_dim: int = 0

    @property
    def temb_dim(self) -> int:
        return self.ch * 4


def _res_init(gen, c_in, c_out, temb_dim, device):
    p = {
        "norm1": groupnorm_init(c_in, device),
        "conv1": conv2d_init(gen, c_in, c_out, 3, device=device),
        "temb": dense_init(gen, temb_dim, c_out, bias=True, device=device),
        "norm2": groupnorm_init(c_out, device),
        "conv2": conv2d_init(gen, c_out, c_out, 3, scale=1e-5, device=device),
    }
    if c_in != c_out:
        p["skip"] = conv2d_init(gen, c_in, c_out, 1, device=device)
    return p


def _attn_init(gen, c, device):
    return {
        "norm": groupnorm_init(c, device),
        "q": dense_init(gen, c, c, bias=True, device=device),
        "k": dense_init(gen, c, c, bias=True, device=device),
        "v": dense_init(gen, c, c, bias=True, device=device),
        "proj": dense_init(gen, c, c, bias=True, scale=1e-5, device=device),
    }


def _mha_init(gen, c, c_kv, device):
    return {"q": dense_init(gen, c, c, device=device),
            "k": dense_init(gen, c_kv, c, device=device),
            "v": dense_init(gen, c_kv, c, device=device),
            "out": dense_init(gen, c, c, bias=True, device=device)}


def _transformer_init(gen, c, cfg, device):
    return {
        "norm": groupnorm_init(c, device),
        "proj_in": conv2d_init(gen, c, c, 1, device=device),
        "norm1": layernorm_init(c, device=device),
        "attn1": _mha_init(gen, c, c, device),
        "norm2": layernorm_init(c, device=device),
        "attn2": _mha_init(gen, c, cfg.context_dim, device),
        "norm3": layernorm_init(c, device=device),
        "ff": {"proj": dense_init(gen, c, 8 * c, bias=True, device=device),
               "out": dense_init(gen, 4 * c, c, bias=True, device=device)},
        "proj_out": conv2d_init(gen, c, c, 1, scale=1e-5, device=device),
    }


def unet_init(gen: torch.Generator, cfg: UNetConfig, device="cpu") -> dict:
    """Random params drawn from ``gen`` (a CPU ``torch.Generator``)."""
    p: dict[str, Any] = {
        "temb0": dense_init(gen, cfg.ch, cfg.temb_dim, bias=True, device=device),
        "temb1": dense_init(gen, cfg.temb_dim, cfg.temb_dim, bias=True,
                            device=device),
        "conv_in": conv2d_init(gen, cfg.in_ch, cfg.ch, 3, device=device),
    }
    if cfg.num_classes:
        table = torch.randn((cfg.num_classes, cfg.temb_dim), generator=gen)
        p["class_emb"] = {"table": (table * 0.02).to(device)}

    attn_init = (
        (lambda c: _transformer_init(gen, c, cfg, device)) if cfg.context_dim
        else (lambda c: _attn_init(gen, c, device)))
    res = cfg.image_size
    chans = [cfg.ch]
    c_cur = cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        c_out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            p[f"down_{i}.res_{j}"] = _res_init(gen, c_cur, c_out, cfg.temb_dim,
                                               device)
            c_cur = c_out
            if res in cfg.attn_resolutions:
                p[f"down_{i}.attn_{j}"] = attn_init(c_cur)
            chans.append(c_cur)
        if i != len(cfg.ch_mult) - 1:
            p[f"down_{i}.downsample"] = conv2d_init(gen, c_cur, c_cur, 3,
                                                    device=device)
            res //= 2
            chans.append(c_cur)

    p["mid.res_0"] = _res_init(gen, c_cur, c_cur, cfg.temb_dim, device)
    p["mid.attn"] = attn_init(c_cur)
    p["mid.res_1"] = _res_init(gen, c_cur, c_cur, cfg.temb_dim, device)

    for i in reversed(range(len(cfg.ch_mult))):
        c_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            c_skip = chans.pop()
            p[f"up_{i}.res_{j}"] = _res_init(gen, c_cur + c_skip, c_out,
                                             cfg.temb_dim, device)
            c_cur = c_out
            if res in cfg.attn_resolutions:
                p[f"up_{i}.attn_{j}"] = attn_init(c_cur)
        if i != 0:
            p[f"up_{i}.upsample"] = conv2d_init(gen, c_cur, c_cur, 3,
                                                device=device)
            res *= 2

    p["norm_out"] = groupnorm_init(c_cur, device)
    p["conv_out"] = conv2d_init(gen, c_cur, cfg.out_ch, 3, scale=1e-5,
                                device=device)
    return p


def _res_apply(p, x, temb, cfg, *, ctx, site):
    h = silu(groupnorm_apply(p["norm1"], x, groups=cfg.gn_groups))
    h = conv2d_apply(p["conv1"], h, ctx=ctx, site=f"{site}/conv1")
    h = h + dense_apply(p["temb"], silu(temb), ctx=ctx,
                        site=f"{site}/temb")[:, None, None, :]
    h = silu(groupnorm_apply(p["norm2"], h, groups=cfg.gn_groups))
    h = conv2d_apply(p["conv2"], h, ctx=ctx, site=f"{site}/conv2")
    if "skip" in p:
        x = conv2d_apply(p["skip"], x, ctx=ctx, site=f"{site}/skip")
    return x + h


def _attn_apply(p, x, cfg, *, ctx, site):
    """Spatial self-attention; the two products and the f32 softmax are
    plain torch, as the reference leaves them to XLA."""
    b, hh, ww, c = x.shape
    h = groupnorm_apply(p["norm"], x, groups=cfg.gn_groups).reshape(b, hh * ww, c)
    q = dense_apply(p["q"], h, ctx=ctx, site=f"{site}/q")
    k = dense_apply(p["k"], h, ctx=ctx, site=f"{site}/k")
    v = dense_apply(p["v"], h, ctx=ctx, site=f"{site}/v")
    s = torch.einsum("bqc,bkc->bqk", q.to(torch.float32), k.to(torch.float32))
    w = torch.softmax(s * (c ** -0.5), dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", w, v)
    o = dense_apply(p["proj"], o, ctx=ctx, site=f"{site}/proj")
    return x + o.reshape(b, hh, ww, c)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """Multi-head softmax attention in f32 (TF32 off): q (B, N, C) over k, v
    (B, M, C), ``heads`` heads of C / heads channels ->
    ``softmax(q k^T * d^-0.5) v`` (B, N, C). The scores are taken a block
    of queries at a time, at most ``ATTN_BLOCK_SCORES`` of them, so a batch
    over 4096 tokens never holds its whole (B, heads, N, M) score tensor."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // heads

    def split(t):          # (B, L, C) -> (B * heads, L, d)
        return (t.to(torch.float32).reshape(b, -1, heads, d).transpose(1, 2)
                .reshape(b * heads, -1, d))
    qh, kt, vh = split(q), split(k).transpose(1, 2), split(v)
    out = torch.empty_like(qh)
    block = max(1, min(n, ATTN_BLOCK_SCORES // (b * heads * m)))
    with no_tf32():
        for i in range(0, n, block):
            qb = qh[:, i:i + block]
            s = qb.new_empty((b * heads, qb.shape[1], m)).baddbmm_(
                qb, kt, beta=0.0, alpha=d ** -0.5)
            out[:, i:i + block] = torch.bmm(torch.softmax(s, dim=-1), vh)
    return out.reshape(b, heads, n, d).transpose(1, 2).reshape(b, n, c)


def geglu(h: torch.Tensor) -> torch.Tensor:
    """GEGLU's gate: the first half of the features times the exact (erf)
    GELU of the second."""
    a, gate = h.chunk(2, dim=-1)
    return a * F.gelu(gate)


def _mha(p, x, kv, heads, *, ctx, site):
    q = dense_apply(p["q"], x, ctx=ctx, site=f"{site}/q")
    k = dense_apply(p["k"], kv, ctx=ctx, site=f"{site}/k")
    v = dense_apply(p["v"], kv, ctx=ctx, site=f"{site}/v")
    return dense_apply(p["out"], attention(q, k, v, heads), ctx=ctx,
                       site=f"{site}/out")


def _no_spans(name: str):
    return _NO_SPAN


def _transformer_apply(p, x, context, cfg, *, ctx, site, spans):
    """Stable Diffusion's spatial transformer (one block of depth 1);
    ``spans(name)`` opens the ranges ``transformer``, ``self_attn``,
    ``cross_attn`` and ``ff``."""
    b, hh, ww, c = x.shape
    heads = cfg.num_heads
    with spans("transformer"):
        h = groupnorm_apply(p["norm"], x, groups=cfg.gn_groups, eps=1e-6)
        h = conv2d_apply(p["proj_in"], h, ctx=ctx,
                         site=f"{site}/proj_in").reshape(b, hh * ww, c)
        with spans("self_attn"):
            n = layernorm_apply(p["norm1"], h)
            h = h + _mha(p["attn1"], n, n, heads, ctx=ctx,
                         site=f"{site}/attn1")
        with spans("cross_attn"):
            h = h + _mha(p["attn2"], layernorm_apply(p["norm2"], h), context,
                         heads, ctx=ctx, site=f"{site}/attn2")
        with spans("ff"):
            f = dense_apply(p["ff"]["proj"], layernorm_apply(p["norm3"], h),
                            ctx=ctx, site=f"{site}/ff/proj")
            h = h + dense_apply(p["ff"]["out"], geglu(f), ctx=ctx,
                                site=f"{site}/ff/out")
        h = conv2d_apply(p["proj_out"], h.reshape(b, hh, ww, c), ctx=ctx,
                         site=f"{site}/proj_out")
    return x + h


def unet_apply(p: dict, x: torch.Tensor, t: torch.Tensor, cfg: UNetConfig, *,
               y: torch.Tensor | None = None, ctx=None,
               context: torch.Tensor | None = None,
               spans=_no_spans) -> torch.Tensor:
    """x: (B,H,W,C) noisy image; t: (B,) timesteps -> predicted eps.
    ``context`` (B, L, context_dim): each row's text context, for a config
    with a ``context_dim``; ``spans(name)``: a context manager around each
    of its spatial transformer's parts (the engine's obs ranges)."""
    if cfg.context_dim:
        def block(q, h, site):
            return _transformer_apply(q, h, context, cfg, ctx=ctx, site=site,
                                      spans=spans)
    else:
        def block(q, h, site):
            return _attn_apply(q, h, cfg, ctx=ctx, site=site)
    temb = timestep_embedding(t, cfg.ch)
    temb = dense_apply(p["temb0"], temb, ctx=ctx, site="temb0")
    temb = dense_apply(p["temb1"], silu(temb), ctx=ctx, site="temb1")
    if cfg.num_classes and y is not None:
        temb = temb + p["class_emb"]["table"][y]

    h = conv2d_apply(p["conv_in"], x, ctx=ctx, site="conv_in")
    hs = [h]
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            h = _res_apply(p[f"down_{i}.res_{j}"], h, temb, cfg, ctx=ctx,
                           site=f"down_{i}.res_{j}")
            if f"down_{i}.attn_{j}" in p:
                h = block(p[f"down_{i}.attn_{j}"], h, f"down_{i}.attn_{j}")
            hs.append(h)
        if i != len(cfg.ch_mult) - 1:
            h = conv2d_apply(p[f"down_{i}.downsample"], h, stride=2, ctx=ctx,
                             site=f"down_{i}.downsample")
            hs.append(h)

    h = _res_apply(p["mid.res_0"], h, temb, cfg, ctx=ctx, site="mid.res_0")
    h = block(p["mid.attn"], h, "mid.attn")
    h = _res_apply(p["mid.res_1"], h, temb, cfg, ctx=ctx, site="mid.res_1")

    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = _res_apply(p[f"up_{i}.res_{j}"], h, temb, cfg, ctx=ctx,
                           site=f"up_{i}.res_{j}")
            if f"up_{i}.attn_{j}" in p:
                h = block(p[f"up_{i}.attn_{j}"], h, f"up_{i}.attn_{j}")
        if i != 0:
            # 2x nearest resize: repeat along H and W
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = conv2d_apply(p[f"up_{i}.upsample"], h, ctx=ctx,
                             site=f"up_{i}.upsample")

    h = silu(groupnorm_apply(p["norm_out"], h, groups=cfg.gn_groups))
    return conv2d_apply(p["conv_out"], h, ctx=ctx, site="conv_out")


def io_sites(p: dict) -> set[str]:
    """Input/output layers the paper keeps at 8-bit."""
    return {"conv_in", "conv_in/w", "conv_out", "conv_out/w"}


def lora_target_sites(p: dict) -> dict[str, tuple[int, int]]:
    """LoRA dims for every conv/dense weight (paper: all quantized layers).

    Keys are '/'-joined weight paths (e.g. 'mid.attn/q/w'); convs use the
    flattened (kh*kw*cin, cout) factorization (see talora.merge_into_tree).
    """
    flat = {k: v for k, v in flatten_paths(p).items()
            if k.endswith("/w") and v.ndim >= 2}
    return lora_target_dims_from_weights(flat)
