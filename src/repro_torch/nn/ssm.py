"""Mamba2 block, its decode step; port of the decode part of
``repro.nn.ssm``.

Decode is the dual recurrence: state' = exp(dt*A) * state + dt * B ⊗ x,
read out through C, over a rolling causal-conv buffer of the last
``d_conv - 1`` projected inputs. The state is f32; the conv buffer is
bf16 whatever the model's dtype (the reference's choice). ``in_proj``
and ``out_proj`` are ``dense_apply`` sites: over packed weights under a
serve-mode context they run the fused W4A4 kernel (K2). The recurrence
itself is plain torch, as the reference leaves it to XLA.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.device import no_tf32
from repro_torch.nn.layers import (dense_apply, dense_init, rmsnorm_apply,
                                   rmsnorm_init, silu)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(gen: torch.Generator, cfg: SSMConfig, device="cpu",
             dtype=torch.float32) -> dict:
    """Random parameters from ``gen`` (drawn on ``gen``'s device) in the
    reference's layout."""
    kw = dict(device=device, dtype=dtype)
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    in_proj = dense_init(gen, cfg.d_model, d_in_proj, **kw)
    conv_w = torch.randn((cfg.d_conv, cfg.conv_dim), generator=gen,
                         device=gen.device) * 0.2
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(**kw),
        "conv_b": torch.zeros((cfg.conv_dim,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, cfg.n_heads).to(**kw)),
        "dt_bias": torch.zeros((cfg.n_heads,), **kw),
        "D": torch.ones((cfg.n_heads,), **kw),
        "norm": rmsnorm_init(cfg.d_inner, dtype, device),
        "out_proj": dense_init(gen, cfg.d_inner, cfg.d_model, **kw),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: SSMConfig):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    return z, xbc, dt


def ssm_state_spec(batch: int, cfg: SSMConfig) -> dict:
    return {
        "state": dict(shape=(batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                      dtype=torch.float32),
        "conv": dict(shape=(batch, cfg.d_conv - 1, cfg.conv_dim),
                     dtype=torch.bfloat16),
    }


def init_ssm_state(batch: int, cfg: SSMConfig, device="cpu") -> dict:
    return {k: torch.zeros(v["shape"], dtype=v["dtype"], device=device)
            for k, v in ssm_state_spec(batch, cfg).items()}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of two operands in their dtype, summed in f32 (TF32 off)
    and rounded once: XLA's dot on exact bf16 products."""
    with no_tf32():
        return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: SSMConfig, *,
               ctx=None, site: str | None = None):
    """One-token decode. x: (B, 1, D) -> (B, 1, D); the cache's state and
    conv buffer are updated in place (the reference returns new ones) and
    the same dict returned."""
    bsz = x.shape[0]
    zxbcdt = dense_apply(p["in_proj"], x[:, 0], ctx=ctx,
                         site=f"{site}/in_proj")
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    dtype = xbc.dtype
    # rolling causal conv: window = [conv buffer ; xbc]
    win = torch.cat([cache["conv"].to(dtype), xbc[:, None]], dim=1)
    conv_out = silu(_contract("bkc,kc->bc", win, p["conv_w"].to(dtype))
                    + p["conv_b"].to(dtype))
    new_conv = win[:, 1:].to(torch.bfloat16)
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    xs = conv_out[..., :di].reshape(bsz, h, cfg.headdim)
    b_mat = conv_out[..., di:di + g * n].reshape(bsz, g, n)
    c_mat = conv_out[..., di + g * n:].reshape(bsz, g, n)
    rep = h // g
    b_mat = torch.repeat_interleave(b_mat, rep, dim=1)            # (B,H,N)
    c_mat = torch.repeat_interleave(c_mat, rep, dim=1)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,H)
    a = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dt * a)[..., None, None]                     # (B,H,1,1)
    xdt = xs * dt[..., None].to(dtype)
    incr = (xdt[..., :, None] * b_mat[..., None, :]).to(torch.float32)
    state = cache["state"] * decay + incr
    y = _contract("bhpn,bhn->bhp", state.to(dtype), c_mat)
    y = y + xs * p["D"][None, :, None].to(dtype)
    y = y.reshape(bsz, di) * silu(z)
    y = rmsnorm_apply(p["norm"], y)
    out = dense_apply(p["out_proj"], y, ctx=ctx, site=f"{site}/out_proj")
    cache["state"].copy_(state)
    cache["conv"].copy_(new_conv)
    return out[:, None], cache
