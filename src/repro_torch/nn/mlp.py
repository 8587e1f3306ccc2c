"""Transformer MLPs (SwiGLU / GeGLU / plain GELU); port of ``repro.nn.mlp``.

Each projection is a ``dense_apply`` site (``{site}/gate``, ``/up``,
``/down``): over packed weights under a serve-mode context it runs the
fused W4A4 matmul (K2).
"""
from __future__ import annotations

import torch

from repro_torch.nn.layers import ACTIVATIONS, dense_apply, dense_init


def glu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                 device="cpu", dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"gate": dense_init(gen, d_model, d_ff, **kw),
            "up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, **kw)}


def glu_mlp_apply(p: dict, x: torch.Tensor, *, act: str = "silu", ctx=None,
                  site: str | None = None) -> torch.Tensor:
    g = dense_apply(p["gate"], x, ctx=ctx, site=f"{site}/gate")
    u = dense_apply(p["up"], x, ctx=ctx, site=f"{site}/up")
    # ``down`` consumes act(gate) * up: the AAL site of the paper
    return dense_apply(p["down"], ACTIVATIONS[act](g) * u, ctx=ctx,
                       site=f"{site}/down")


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  device="cpu", dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"up": dense_init(gen, d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, d_model, **kw)}


def gelu_mlp_apply(p: dict, x: torch.Tensor, *, act: str = "gelu", ctx=None,
                   site: str | None = None) -> torch.Tensor:
    h = ACTIVATIONS[act](dense_apply(p["up"], x, ctx=ctx, site=f"{site}/up"))
    return dense_apply(p["down"], h, ctx=ctx, site=f"{site}/down")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             device="cpu", dtype=torch.float32) -> dict:
    if kind in ("swiglu", "geglu"):
        return glu_mlp_init(gen, d_model, d_ff, device, dtype)
    return gelu_mlp_init(gen, d_model, d_ff, device, dtype)


def mlp_apply(p: dict, x: torch.Tensor, kind: str, *, ctx=None,
              site=None) -> torch.Tensor:
    if kind == "swiglu":
        return glu_mlp_apply(p, x, act="silu", ctx=ctx, site=site)
    if kind == "geglu":
        return glu_mlp_apply(p, x, act="gelu_tanh", ctx=ctx, site=site)
    return gelu_mlp_apply(p, x, ctx=ctx, site=site)
