"""Mamba2 block: the full-sequence forward (chunked SSD) and the decode
step; port of ``repro.nn.ssm``.

The forward (``ssm_apply``) runs the causal depthwise conv, then the SSD
scan (arXiv:2405.21060 §6) one chunk of ``chunk`` positions at a time,
carrying the inter-chunk state in f32, so the (H, chunk, chunk) decay
matrix exists for one chunk only. Its einsums of three and four operands
are contracted pairwise in the order ``opt_einsum`` gives the reference's
``jnp.einsum`` at these shapes, each pair summed in f32 and rounded once
to the model's dtype (``_contract``).

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
import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.common.device import no_tf32
from repro_torch.common.sharding import over_batch
from repro_torch.nn.layers import (dense_apply, dense_init, randn,
                                   rmsnorm_apply, rmsnorm_init, silu)


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
    conv_w = randn(gen, (cfg.d_conv, cfg.conv_dim), device) * 0.2
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


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then silu. xbc: (B, S, C);
    w: (K, C). The taps are summed in the reference's order (Python's
    ``sum``: tap 0 first)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., s) -> (..., s, s) lower-triangular segment sums: entry (i, j)
    is a[j+1] + ... + a[i], -inf above the diagonal."""
    s = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                dtype=diff.dtype,
                                                device=a.device))


def ssd_scan(x: torch.Tensor, dt_a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, chunk: int, init_state=None):
    """Chunked SSD. x: (B, S, H, P) (already dt-scaled), dt_a: (B, S, H)
    log-decay, b_mat/c_mat: (B, S, H, N) (groups broadcast to heads).
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    in f32."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.to(torch.float32))
    ys = []
    for c0 in range(0, s, chunk):
        xk, bk, ck = (t[:, c0:c0 + chunk] for t in (x, b_mat, c_mat))
        dtype = ck.dtype
        a_t = dt_a[:, c0:c0 + chunk].to(torch.float32).movedim(-1, 1)
        cum = torch.cumsum(a_t, dim=-1)                   # (B, H, chunk)
        li = torch.exp(_segsum(a_t))                      # (B, H, l, s)
        # blhn,bshn,bhls,bshp->blhp as (C B^T) . L, then @ x
        cb = _contract("blhn,bshn->bhls", ck, bk)
        y_diag = _contract("bhls,bshp->blhp", cb * li.to(dtype), xk)
        # bshn,bhs,bshp->bhpn as B^T (decay * x)
        decay = torch.exp(cum[..., -1:] - cum).to(bk.dtype)
        xw = xk * decay.movedim(1, -1)[..., None]
        chunk_state = _contract("bshn,bshp->bhpn", bk, xw)
        # blhn,bhpn,bhl->blhp as (C state) * decay
        out_decay = torch.exp(cum).to(dtype)
        y_off = (_contract("blhn,bhpn->blhp", ck, state.to(dtype))
                 * out_decay.movedim(1, -1)[..., None])
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + chunk_state.to(torch.float32))
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), state


def ssm_apply(p: dict, x: torch.Tensor, cfg: SSMConfig, *, ctx=None,
              site: str | None = None) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, S, D) -> (B, S, D). The conv
    runs in the model's dtype (decode's conv buffer is bf16; here there is
    none). On DTensors the mixer between the two projections runs on each
    rank's batch shard (``over_batch``): its views have no DTensor rule in
    torch 2.11."""
    zxbcdt = dense_apply(p["in_proj"], x, ctx=ctx, site=f"{site}/in_proj")
    whole = tuple(p[k] for k in MIXER_PARAMS)
    if isinstance(zxbcdt, DTensor):
        y = over_batch(functools.partial(_mixer, cfg=cfg), zxbcdt, whole)
    else:
        y = _mixer(zxbcdt, *whole, cfg=cfg)
    y = rmsnorm_apply(p["norm"], y)
    return dense_apply(p["out_proj"], y, ctx=ctx, site=f"{site}/out_proj")


MIXER_PARAMS = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _mixer(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, *,
           cfg: SSMConfig) -> torch.Tensor:
    """The causal conv, the SSD scan, the skip and the gate: (B, S,
    d_in_proj) -> (B, S, d_inner)."""
    bsz, s, _ = zxbcdt.shape
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = _causal_conv(xbc, conv_w, conv_b)
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    xs = xbc[..., :di].reshape(bsz, s, h, cfg.headdim)
    rep = h // g
    b_mat = torch.repeat_interleave(
        xbc[..., di:di + g * n].reshape(bsz, s, g, n), rep, dim=2)
    c_mat = torch.repeat_interleave(
        xbc[..., di + g * n:].reshape(bsz, s, g, n), rep, dim=2)
    dt = softplus(dt.to(torch.float32) + dt_bias)                 # (B,S,H)
    a = -torch.exp(a_log.to(torch.float32))                       # (H,)
    y, _ = ssd_scan(xs * dt[..., None].to(xs.dtype), dt * a, b_mat, c_mat,
                    cfg.chunk)
    y = y + xs * d_skip[None, None, :, None].to(xs.dtype)
    return y.reshape(bsz, s, di) * silu(z)


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
