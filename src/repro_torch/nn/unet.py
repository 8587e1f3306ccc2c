"""DDPM/LDM-style UNet epsilon-predictor; port of ``repro.nn.unet``.

Same param tree as the reference, path for path (``down_0.res_0/conv1/w``
...), NHWC activations and HWIO conv weights, so a JAX tree converts by
path (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.tree import flatten_paths
from repro_torch.core.talora import lora_target_dims_from_weights
from repro_torch.nn.embeddings import timestep_embedding
from repro_torch.nn.layers import (conv2d_apply, conv2d_init, dense_apply,
                                   dense_init, groupnorm_apply, groupnorm_init,
                                   silu)


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
                p[f"down_{i}.attn_{j}"] = _attn_init(gen, c_cur, device)
            chans.append(c_cur)
        if i != len(cfg.ch_mult) - 1:
            p[f"down_{i}.downsample"] = conv2d_init(gen, c_cur, c_cur, 3,
                                                    device=device)
            res //= 2
            chans.append(c_cur)

    p["mid.res_0"] = _res_init(gen, c_cur, c_cur, cfg.temb_dim, device)
    p["mid.attn"] = _attn_init(gen, c_cur, device)
    p["mid.res_1"] = _res_init(gen, c_cur, c_cur, cfg.temb_dim, device)

    for i in reversed(range(len(cfg.ch_mult))):
        c_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            c_skip = chans.pop()
            p[f"up_{i}.res_{j}"] = _res_init(gen, c_cur + c_skip, c_out,
                                             cfg.temb_dim, device)
            c_cur = c_out
            if res in cfg.attn_resolutions:
                p[f"up_{i}.attn_{j}"] = _attn_init(gen, c_cur, device)
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


def unet_apply(p: dict, x: torch.Tensor, t: torch.Tensor, cfg: UNetConfig, *,
               y: torch.Tensor | None = None, ctx=None) -> torch.Tensor:
    """x: (B,H,W,C) noisy image; t: (B,) timesteps -> predicted eps."""
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
                h = _attn_apply(p[f"down_{i}.attn_{j}"], h, cfg, ctx=ctx,
                                site=f"down_{i}.attn_{j}")
            hs.append(h)
        if i != len(cfg.ch_mult) - 1:
            h = conv2d_apply(p[f"down_{i}.downsample"], h, stride=2, ctx=ctx,
                             site=f"down_{i}.downsample")
            hs.append(h)

    h = _res_apply(p["mid.res_0"], h, temb, cfg, ctx=ctx, site="mid.res_0")
    h = _attn_apply(p["mid.attn"], h, cfg, ctx=ctx, site="mid.attn")
    h = _res_apply(p["mid.res_1"], h, temb, cfg, ctx=ctx, site="mid.res_1")

    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = _res_apply(p[f"up_{i}.res_{j}"], h, temb, cfg, ctx=ctx,
                           site=f"up_{i}.res_{j}")
            if f"up_{i}.attn_{j}" in p:
                h = _attn_apply(p[f"up_{i}.attn_{j}"], h, cfg, ctx=ctx,
                                site=f"up_{i}.attn_{j}")
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
