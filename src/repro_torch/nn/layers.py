"""Functional layers over plain param dicts; port of ``repro.nn.layers``
(dense, NHWC/HWIO conv2d, group/rms/layer norm, the embedding table,
activations).

Quantization hooks as in the reference: ``ctx`` (a ``QuantContext``)
supplies the serve-mode act quantizer per site, and a weight is a dense
tensor or a ``PackedW4`` (serving form), dispatched to the kernels here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops
from repro_torch.nn import partition
from repro_torch.quant.calibrate import QuantContext


def _maybe_quant_act(ctx: QuantContext | None, site: str | None, x):
    if ctx is None or site is None:
        return x
    return ctx.act(site, x)


def randn(gen: torch.Generator | None, shape: tuple, device) -> torch.Tensor:
    """f32 standard-normal draws of ``shape`` from ``gen``, on ``gen``'s
    device; for a ``device`` of ``meta`` an empty meta tensor, the
    generator untouched (``gen`` may be None): the dry run's abstract
    parameters, built with no draw and no storage."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               device="cpu", dtype=torch.float32) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    w = randn(gen, (d_in, d_out), device) * scale
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device, dtype=dtype)
    return p


def dense_apply(p: dict, x: torch.Tensor, *, ctx: QuantContext | None = None,
                site: str | None = None, act_qp=None) -> torch.Tensor:
    """PackedW4 weights run the fused W4A4 matmul (K2); a dense weight
    gets a standalone act qdq (K1) then an f32 matmul."""
    x = _maybe_quant_act(ctx, site, x)
    w = p["w"]
    if act_qp is None and ctx is not None:
        act_qp = ctx.serving_qp(site)
    if isinstance(w, PackedW4):
        y = partition.w4a4_matmul(x, w, act_qp)
    else:
        if act_qp is not None:
            x = partition.msfp_quantize(x, act_qp)
        y = ops.dense_matmul(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def conv2d_init(gen: torch.Generator, c_in: int, c_out: int, kernel: int = 3,
                *, bias: bool = True, scale: float | None = None,
                device="cpu") -> dict:
    scale = scale if scale is not None else (c_in * kernel * kernel) ** -0.5
    w = torch.randn((kernel, kernel, c_in, c_out), generator=gen) * scale
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros((c_out,), device=device)
    return p


def conv2d_apply(p: dict, x: torch.Tensor, *, stride: int = 1,
                 padding="SAME", ctx: QuantContext | None = None,
                 site: str | None = None, act_qp=None) -> torch.Tensor:
    """PackedW4 weights run the W4A4 conv kernels (K3, or im2col + K2);
    a dense (bf16-fallback) weight, the io sites, runs its act snap, f32
    conv and bias as one op (``ops.dense_conv2d``: one ``qdq_conv2d``
    launch where it covers the call)."""
    x = _maybe_quant_act(ctx, site, x)
    w = p["w"]
    if act_qp is None and ctx is not None:
        act_qp = ctx.serving_qp(site)
    if not isinstance(w, PackedW4):
        return ops.dense_conv2d(x, w, act_qp, p.get("b"), stride=stride,
                                padding=padding)
    y = ops.w4a4_conv2d(x, w, act_qp, stride=stride, padding=padding)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def groupnorm_init(dim: int, device="cpu") -> dict:
    return {"g": torch.ones((dim,), device=device),
            "b": torch.zeros((dim,), device=device)}


def groupnorm_apply(p: dict, x: torch.Tensor, *, groups: int = 32,
                    eps: float = 1e-5) -> torch.Tensor:
    """NHWC group norm in f32 (``groups`` capped at the channel count)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xf = x.to(torch.float32).reshape(b, h, w, g, c // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    n = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (n * p["g"] + p["b"]).to(x.dtype)


def rmsnorm_init(dim: int, dtype=torch.float32, device="cpu") -> dict:
    return {"g": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, *, eps: float = 1e-6,
                  plus_one: bool = False) -> torch.Tensor:
    """RMS norm in f32, cast back to x.dtype; ``plus_one``: the gemma
    convention, which stores g - 1."""
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    g = p["g"].to(torch.float32)
    g = g + 1.0 if plus_one else g
    return (n * g).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device="cpu") -> dict:
    return {"g": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor, *, eps: float = 1e-5
                    ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * p["g"].to(torch.float32)
            + p["b"].to(torch.float32)).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, device="cpu",
               dtype=torch.float32) -> dict:
    w = randn(gen, (vocab, dim), device) * 0.02
    return {"table": w.to(device=device, dtype=dtype)}


def embed_apply(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def embed_attend(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-readout logits: x @ table.T in x's dtype (the LM's tied
    head's product, ``ops.tied_logits``)."""
    return ops.tied_logits(x, p["table"])


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ``jax.nn.gelu`` defaults to the tanh approximation, so "gelu" is it too.
ACTIVATIONS = {
    "silu": silu,
    "gelu": gelu_tanh,
    "gelu_tanh": gelu_tanh,
    "relu": torch.relu,
}
