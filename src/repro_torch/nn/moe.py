"""Token-choice top-k MoE with fixed expert capacity (sort-based
dispatch); port of ``repro.nn.moe``: ``moe_apply``, the load-balance
loss, and ``moe_apply_ep`` as the reference runs it without a device mesh
(its shard_map path is ROADMAP Queue A item 13).

Dispatch sorts the (T*k) token-expert assignments by expert id (stably,
as ``jnp.argsort``), ranks each entry within its expert's run with a
cummax, and scatters into a dense (E, C, d) buffer; an entry past the
capacity C goes to a sentinel row and drops. Combine is the inverse
gather, weighted by the renormalised router probabilities. Nothing here
reads the routing on the host: every expert runs over its C rows.

Each expert's product over a packed weight runs K2 in its weight-only
mode (``ops.w4_matmul``): one launch an expert and a projection. That is
the reference's ``x @ dequant(W)`` einsum: its expert sites never snap an
act (a serve-mode ``ctx.act`` is the identity), so neither does the port,
under ``--act-quant fp4`` too. The shared expert is a ``glu_mlp_apply``
site and runs W4A4 K2 under a serve-mode context. The router is a plain
f32 product (``dense_apply`` without a context).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops
from repro_torch.nn.layers import ACTIVATIONS, dense_apply, dense_init
from repro_torch.nn.mlp import glu_mlp_apply, glu_mlp_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25
    act: str = "silu"
    router_dtype: str = "float32"


def moe_init(gen: torch.Generator, cfg: MoEConfig, device="cpu",
             dtype=torch.float32) -> dict:
    """Random parameters from ``gen`` (drawn on its device) in the
    reference's layout: an f32 router, (E, d, f) gate/up and (E, f, d)
    down stacks, and the shared expert's GLU MLP."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def randn(*shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device) * scale
        return w.to(device=device, dtype=dtype)

    p = {"router": dense_init(gen, d, e, device=device, dtype=torch.float32),
         "w_gate": randn(e, d, f, scale=d ** -0.5),
         "w_up": randn(e, d, f, scale=d ** -0.5),
         "w_down": randn(e, f, d, scale=f ** -0.5)}
    if cfg.n_shared:
        p["shared"] = glu_mlp_init(gen, d, f * cfg.n_shared, device, dtype)
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)  # pad to a lane-friendly multiple


def _positions_in_segment(sorted_ids: torch.Tensor) -> torch.Tensor:
    """For a sorted id vector, the rank of each entry within its id run."""
    n = sorted_ids.shape[0]
    idx = torch.arange(n, device=sorted_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - seg_start


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, largest
    first, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _expert_operand(t: torch.Tensor, e: int, n_experts: int) -> torch.Tensor:
    """Expert e's scale (or zero-point) from an expert pack's: (E|1, 1,
    1|N) keepdims, or already flat -> a scalar or an (N,) vector."""
    if t.ndim == 3:
        t = t[e if t.shape[0] == n_experts else 0]
    t = t.reshape(-1)
    return t.reshape(()) if t.numel() == 1 else t


def expert_packs(pw: PackedW4) -> list[PackedW4]:
    """An (E, K, N/2) expert pack as E 2D packs, each with its scale and
    zero-point (one for all experts, as a layer's slice of a stacked pack
    has, or one per expert) as a scalar or an (N,) vector: what K2
    takes."""
    n = pw.packed.shape[0]
    return [dataclasses.replace(
        pw, packed=pw.packed[e], scale=_expert_operand(pw.scale, e, n),
        zero_point=_expert_operand(pw.zero_point, e, n),
        shape=tuple(pw.shape[1:])) for e in range(n)]


def _experts(p: dict, hidden: torch.Tensor, act, down_in) -> torch.Tensor:
    """hidden (E, C, d) -> (E, C, d): each expert's GLU FFN, ``down_in``
    applied to the down projection's input. Packed weights: one K2
    weight-only launch an expert and a projection; dense ones: the
    reference's batched product (a plain f32 matmul)."""
    if not isinstance(p["w_gate"], PackedW4):
        g = ops.dense_matmul(hidden, p["w_gate"])
        u = ops.dense_matmul(hidden, p["w_up"])
        return ops.dense_matmul(down_in(act(g) * u), p["w_down"])
    gate, up, down = (expert_packs(p[k]) for k in ("w_gate", "w_up",
                                                   "w_down"))
    outs = []
    for e in range(hidden.shape[0]):
        h = hidden[e]
        g = ops.w4_matmul(h, gate[e])
        u = ops.w4_matmul(h, up[e])
        outs.append(ops.w4_matmul(down_in(act(g) * u), down[e]))
    return torch.stack(outs)


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, *, ctx=None,
              site: str | None = None) -> torch.Tensor:
    """x: (..., d) -> (..., d). Flattens leading dims into tokens."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    k, e = cfg.top_k, cfg.n_experts
    c = capacity(t, cfg)
    dev = x.device

    # router in f32, kept unquantized like the paper's sensitive layers
    logits = dense_apply(p["router"], xt.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_ids = top_k(probs, k)                             # (T,k)
    gate_w = (gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
              ).to(x.dtype)

    # dispatch: sort the (T*k) assignments by expert
    flat_e = gate_ids.reshape(-1)
    flat_w = gate_w.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]
    pos = _positions_in_segment(se)
    keep = pos < c
    dst = torch.where(keep, se * c + pos, e * c)                   # sentinel

    xq = ctx.act(f"{site}/experts", xt) if (ctx is not None and site) \
        else xt
    buf = torch.zeros((e * c + 1, d), dtype=xq.dtype, device=dev)
    buf[dst] = xq[st]
    hidden = buf[:-1].reshape(e, c, d)

    def down_in(h):
        if ctx is not None and site:
            return ctx.act(f"{site}/down", h)
        return h

    out_e = _experts(p, hidden, ACTIVATIONS[cfg.act], down_in)

    # combine: gather back and weight
    flat_out = out_e.reshape(e * c, d)
    gathered = torch.where(keep[:, None], flat_out[dst.clamp(0, e * c - 1)],
                           torch.zeros((), dtype=flat_out.dtype, device=dev))
    contrib = gathered * sw[:, None]
    yt = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, st, contrib.to(x.dtype))

    if "shared" in p:
        yt = yt + glu_mlp_apply(p["shared"], xt, act=cfg.act, ctx=ctx,
                                site=f"{site}/shared" if site else None)
    return yt.reshape(*lead, d)


def moe_apply_ep(p: dict, x: torch.Tensor, cfg: MoEConfig, *,
                 model_axis: str = "model", ctx=None,
                 site: str | None = None) -> torch.Tensor:
    """The expert-parallel MoE without a mesh: the reference falls back to
    ``moe_apply`` when no mesh has a ``model_axis`` (``repro/nn/moe.py:
    174-175``), and the port has no mesh yet (ROADMAP Queue A item 13)."""
    return moe_apply(p, x, cfg, ctx=ctx, site=site)


def aux_load_balance_loss(logits: torch.Tensor, gate_ids: torch.Tensor,
                          cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: n_experts * sum over
    experts of (mean router probability) x (share of tokens whose first
    choice it is). logits: (T, E); gate_ids: (T, k)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    me = probs.mean(dim=0)
    one_hot = torch.nn.functional.one_hot(gate_ids[..., 0].long(),
                                          cfg.n_experts).to(torch.float32)
    ce = one_hot.mean(dim=0)
    return cfg.n_experts * torch.sum(me * ce)
