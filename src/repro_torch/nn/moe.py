"""Token-choice top-k MoE with fixed expert capacity (sort-based
dispatch); port of ``repro.nn.moe``: ``moe_apply``, the load-balance
loss, and ``moe_apply_ep``, the expert-parallel form over the ambient
mesh's ``model`` axis (``local_map`` in place of the reference's
``shard_map``, one ``all_to_all_single`` each way).

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

The combine sums each token's k contributions in dispatch order with no
atomic add, so a step gives the same bits on every run on the card
(``_combine_local``). Under a mesh, ``moe_apply`` on DTensors runs on
every rank over the whole token set and whole expert stacks
(``_on_replicas``): correct, and as costly as the reference's global
dispatch under GSPMD; ``moe_apply_ep`` is the form that shards it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.common.sharding import (P, ambient_mesh, axis_sizes,
                                         grad_placements, like, placements)
from repro_torch.common.tree import flatten_paths, tree_map, unflatten_paths
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops
from repro_torch.nn.layers import (ACTIVATIONS, dense_apply, dense_init,
                                   randn)
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

    def draw(*shape, scale):
        w = randn(gen, shape, device) * scale
        return w.to(device=device, dtype=dtype)

    p = {"router": dense_init(gen, d, e, device=device, dtype=torch.float32),
         "w_gate": draw(e, d, f, scale=d ** -0.5),
         "w_up": draw(e, d, f, scale=d ** -0.5),
         "w_down": draw(e, f, d, scale=f ** -0.5)}
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


def _dispatch_local(xt: torch.Tensor, probs: torch.Tensor, cfg: MoEConfig,
                    c: int):
    """Sort-based dispatch of ``xt``'s tokens into an (E, c, d) buffer:
    (hidden, the metadata ``_combine_local`` gathers the outputs back
    with)."""
    t, d = xt.shape
    k, e = cfg.top_k, cfg.n_experts
    dev = xt.device
    gate_w, gate_ids = top_k(probs, k)                             # (T,k)
    gate_w = (gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
              ).to(xt.dtype)
    flat_e = gate_ids.reshape(-1)
    flat_w = gate_w.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]
    pos = _positions_in_segment(se)
    keep = pos < c
    dst = torch.where(keep, se * c + pos, e * c)                   # sentinel
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=dev)
    buf[dst] = xt[st]
    return buf[:-1].reshape(e, c, d), (keep, dst, st, sw)


def _combine_local(out_e: torch.Tensor, meta, t: int, d: int, dtype):
    """Each token's k weighted expert outputs summed back into (T, d).
    The sum runs over a token's entries in dispatch order (ascending
    expert id) in f32 from 0, rounded once to ``dtype``: the bits of the
    CPU's ``index_add_``, with no atomic add (CUDA's ``index_add_`` adds
    in an order that varies between runs)."""
    keep, dst, st, sw = meta
    e_c = out_e.shape[0] * out_e.shape[1]
    flat_out = out_e.reshape(e_c, -1)
    gathered = torch.where(keep[:, None], flat_out[dst.clamp(0, e_c - 1)],
                           torch.zeros((), dtype=flat_out.dtype,
                                       device=flat_out.device))
    contrib = (gathered * sw[:, None]).to(dtype)
    by_token = contrib[torch.argsort(st, stable=True)].reshape(t, -1, d)
    yt = torch.zeros((t, d), dtype=torch.float32, device=out_e.device)
    for j in range(by_token.shape[1]):
        yt = yt + by_token[:, j].to(torch.float32)
    return yt.to(dtype)


_PACK_FIELDS = ("packed", "scale", "zero_point")


def _tensors_of(w) -> tuple:
    """A weight's tensors: a PackedW4's three, a dense weight itself."""
    if isinstance(w, PackedW4):
        return tuple(getattr(w, f) for f in _PACK_FIELDS)
    return (w,)


def _rebuild(w, it):
    """``w`` with its tensors taken in turn from the iterator ``it``."""
    if isinstance(w, PackedW4):
        return dataclasses.replace(w, **{f: next(it) for f in _PACK_FIELDS})
    return next(it)


def _on_replicas(fn, p: dict, x, *args, **kw):
    """``fn(p, x, ...)`` with DTensor inputs gathered whole onto every
    rank and its output replicated: the global dispatch's argsort and
    scatter over a sharded token set have no DTensor sharding rule, and
    under GSPMD they meet the same gathers (the reference's baseline,
    which ``moe_apply_ep`` replaces). A PackedW4's tensors go in one by
    one."""
    mesh = x.device_mesh
    flat = flatten_paths(p)
    leaves = [t for w in flat.values() for t in _tensors_of(w)]
    # lists: local_map reads a tuple of out_placements as one an output
    rep = [Replicate()] * mesh.ndim

    def local(x_l, *leaves_l):
        it = iter(leaves_l)
        return fn(unflatten_paths({k: _rebuild(w, it) for k, w in
                                   flat.items()}), x_l, *args, **kw)

    return local_map(local, out_placements=rep, in_placements=tuple(
        rep if isinstance(a, DTensor) else None for a in (x, *leaves)),
        device_mesh=mesh, redistribute_inputs=True)(x, *leaves)


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, *, ctx=None,
              site: str | None = None) -> torch.Tensor:
    """x: (..., d) -> (..., d). Flattens leading dims into tokens."""
    if isinstance(x, DTensor):
        return _on_replicas(moe_apply, p, x, cfg, ctx=ctx, site=site)
    lead = x.shape[:-1]
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]

    # router in f32, kept unquantized like the paper's sensitive layers
    logits = dense_apply(p["router"], xt.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    xq = ctx.act(f"{site}/experts", xt) if (ctx is not None and site) \
        else xt
    hidden, meta = _dispatch_local(xq, probs, cfg, capacity(t, cfg))

    def down_in(h):
        if ctx is not None and site:
            return ctx.act(f"{site}/down", h)
        return h

    out_e = _experts(p, hidden, ACTIVATIONS[cfg.act], down_in)
    yt = _combine_local(out_e, meta, t, d, x.dtype)

    if "shared" in p:
        yt = yt + glu_mlp_apply(p["shared"], xt, act=cfg.act, ctx=ctx,
                                site=f"{site}/shared" if site else None)
    return yt.reshape(*lead, d)


class _AllToAll(torch.autograd.Function):
    """``t`` split into the group's size of equal chunks along dim 0,
    chunk j sent to rank j, the chunks received stacked in source-rank
    order. With equal chunks the exchange is its own inverse, so the
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = torch.empty_like(t, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(t, group)


def moe_apply_ep(p: dict, x: torch.Tensor, cfg: MoEConfig, *,
                 model_axis: str = "model", ctx=None,
                 site: str | None = None) -> torch.Tensor:
    """Expert-parallel MoE (the fix for the global-sort dispatch, whose
    sorts and scatters span every token). Each token shard sorts and
    buckets its LOCAL tokens, then one all-to-all over the ``model`` group
    reshards (E, c_l, d) -> (E/mp, mp*c_l, d); each rank runs its own
    experts on their weights; the inverse all-to-all and the local gather
    combine. Collective volume is 2x the dispatched activations.

    Tokens shard over every mesh axis for the dispatch, the model axis
    included: a (B, S, d) input whose batch the DP axes and whose
    sequence the model axis divide is cut so, which is the same token set
    a rank that cuts the flattened tokens over every axis holds (and
    needs no view of a dim cut over three mesh axes, which DTensor
    shapes wrongly); any other input is flattened first. Falls back to
    ``moe_apply`` where the reference does: no ambient mesh or none with
    ``model_axis``, experts that the axis does not divide, tokens that
    the shards do not divide. Plain-tensor inputs
    are taken as replicated (a plain ``x`` gets its output gathered
    whole); a DTensor's output stays a DTensor sharded over the
    tokens."""
    mesh = ambient_mesh()
    if mesh is None or model_axis not in mesh.mesh_dim_names:
        return moe_apply(p, x, cfg, ctx=ctx, site=site)
    sizes = axis_sizes(mesh)
    mp = sizes[model_axis]
    if cfg.n_experts % mp != 0:
        return moe_apply(p, x, cfg, ctx=ctx, site=site)
    dp_axes = tuple(a for a in mesh.mesh_dim_names if a != model_axis)

    lead = x.shape[:-1]
    d = x.shape[-1]
    t = math.prod(lead)
    tok_axes = (*dp_axes, model_axis)
    n_shards = math.prod(sizes[a] for a in tok_axes)
    if t % n_shards != 0:
        return moe_apply(p, x, cfg, ctx=ctx, site=site)
    dp_n = n_shards // mp
    if x.ndim == 3 and x.shape[0] % dp_n == 0 and x.shape[1] % mp == 0:
        xt, tok_spec = x, P(dp_axes, model_axis, None)
    else:
        xt, tok_spec = x.reshape(-1, d), P(tok_axes, None)
    rep = [Replicate()] * mesh.ndim
    plain = not isinstance(xt, DTensor)
    if plain:
        xt = DTensor.from_local(xt, mesh, rep, run_check=False)
    p = tree_map(lambda a: like(a, xt), p)
    c_l = capacity(t // n_shards, cfg)
    group = mesh.get_group(model_axis)
    e_l = cfg.n_experts // mp
    act = ACTIVATIONS[cfg.act]

    names = ("w_gate", "w_up", "w_down")
    fields = [t for k in names for t in _tensors_of(p[k])]

    def local_fn(x_l, router_w, *fields_l):
        it = iter(fields_l)
        w_gate_l, w_up_l, w_down_l = (_rebuild(p[k], it) for k in names)
        xt_l = x_l.reshape(-1, d)
        logits = ops.dense_matmul(xt_l.to(torch.float32), router_w)
        probs = torch.softmax(logits, dim=-1)
        hidden, meta = _dispatch_local(xt_l, probs, cfg, c_l)  # (E, c_l, d)
        # (E, c_l, d) -> (E/mp, mp*c_l, d)
        hidden = _all_to_all(hidden, group).reshape(
            mp, e_l, c_l, d).transpose(0, 1).reshape(e_l, mp * c_l, d)
        out_e = _experts({"w_gate": w_gate_l, "w_up": w_up_l,
                          "w_down": w_down_l}, hidden, act, lambda h: h)
        out_e = _all_to_all(out_e.reshape(e_l, mp, c_l, d).transpose(0, 1),
                            group).reshape(cfg.n_experts, c_l, d)
        return _combine_local(out_e, meta, xt_l.shape[0], d,
                              xt_l.dtype).reshape(x_l.shape)

    tok = list(placements(tok_spec, mesh))
    experts = list(placements(P(model_axis, None, None), mesh))
    # a whole input's gradient is a partial sum over the ranks whose tokens
    # reached it: the router's over every token shard, an expert's over
    # the data ranks (the all-to-all brings it its model group's tokens)
    router_grad = grad_placements(tok)
    experts_grad = [g if isinstance(e, Replicate) else e
                    for g, e in zip(router_grad, experts)]
    # an expert stack's tensors cut over the experts; a pack's scale and
    # zero-point one for all experts whole
    cut = [t.shape[0] == cfg.n_experts for t in fields]
    yt = local_map(local_fn, out_placements=tok,
                   in_placements=(tok, rep, *(experts if c else rep
                                              for c in cut)),
                   in_grad_placements=(tok, router_grad, *(
                       experts_grad if c else router_grad for c in cut)),
                   device_mesh=mesh, redistribute_inputs=True)(
        xt, p["router"]["w"].to(torch.float32), *fields)

    if "shared" in p:
        yt = yt + glu_mlp_apply(p["shared"], xt, act=cfg.act, ctx=ctx,
                                site=f"{site}/shared" if site else None)
    y = yt.reshape(*lead, d)
    return y.full_tensor() if plain else y


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
