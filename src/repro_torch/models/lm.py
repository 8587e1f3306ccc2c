"""Unified LM family (dense / GQA / MoE / SSM / hybrid / audio / vlm); port
of ``repro.models.lm``.

Three entry points per architecture, as the reference's:
  forward(...)      full-sequence logits (training / prefill)
  loss_fn(...)      next-token cross-entropy
  decode_step(...)  one token against KV caches / SSM states (serving)

The parameter tree is the reference's: ``embed``, ``final_norm``,
optional ``lm_head``, ``vision_proj`` (vlm), ``dense_{i}`` for the
``first_k_dense`` leading layers, ``blocks`` (a list with one entry per
position of ``layer_pattern``, each a tree stacked over ``n_groups``; the
reference scans over that axis) and ``shared_attn`` (zamba2's block,
applied after each group with the same weights). ``forward`` and
``decode_step`` loop over the groups instead, and hand each layer its
slice: a stacked ``PackedW4`` becomes the layer's 2D pack (an expert
stack, E of them) with a scalar (or per-output-channel) scale, so every
dense site runs K2 (W4A4 under a serve-mode context, weight-only without
one) and every expert product K2's weight-only mode, never the
stacked-pack oracle. Decode's caches (KV, SSM state and conv buffer, and
the shared block's KV cache per group) are stacked the same way and
written in place.

``cfg.remat`` recomputes each group in the backward
(``torch.utils.checkpoint``, non-reentrant) when grad is enabled, which
changes no number; ``cfg.unroll`` needs nothing here (the groups are a
Python loop either way). ``moe_impl == "ep"`` runs ``moe_apply_ep``,
which without a mesh is ``moe_apply``, as in the reference.
``loss_fn`` adds no MoE aux loss, as the reference's code (its module
docstring says it does; ROADMAP Queue C).

Under a mesh (``launch/mesh.py:mesh_scope``) the parameters and the batch
may be DTensors, and the reference's six activation hints
(``common/sharding.py:shard_hint``) redistribute the embeddings, each
block's output and the residual to (DP, None, None) and the logits to
(DP, None, MODEL); meshless they pass through.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.common.sharding import (DP, MODEL, like, over_batch,
                                         recompute_contexts, shard_hint)
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops
from repro_torch.nn.attention import (AttnConfig, attn_apply, attn_decode,
                                      attn_init, kv_cache_spec)
from repro_torch.nn.embeddings import rope_frequencies, timestep_embedding
from repro_torch.nn.layers import (dense_apply, dense_init, randn,
                                   rmsnorm_apply, rmsnorm_init)
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_apply_ep, moe_init
from repro_torch.nn.ssm import (SSMConfig, ssm_apply, ssm_decode, ssm_init,
                                ssm_state_spec)

ATTN, SSM = "attn", "ssm"
SHARED_THETA = 10_000.0      # the shared attention block's rope theta


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig``, field for field; ``dtype`` is a torch
    dtype."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    family: str = "dense"            # dense|moe|ssm|hybrid|audio|vlm
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    pos: str = "rope"                # rope | sinusoidal
    scale_embed: bool = False        # gemma: h *= sqrt(d_model)
    tie_embeddings: bool = False
    # depth pattern, period P entries of (kind, window|None, rope_theta)
    layer_pattern: tuple = ((ATTN, None, 10_000.0),)
    # --- moe ---
    moe_impl: str = "global"         # global | ep (expert parallel)
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # --- ssm ---
    ssm_d_state: int = 0
    ssm_headdim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0       # the shared attn block every k layers
    # --- vlm / audio stubs ---
    n_img_tokens: int = 0
    d_vision: int = 0
    # --- execution ---
    dtype: Any = torch.bfloat16
    remat: bool = True
    unroll: bool = False
    q_chunk: int = 512
    kv_dtype: str = "bf16"           # bf16 | fp8 | fp4  (serving KV cache)
    logits_softcap: float | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    def attn_cfg(self, window, theta) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv, self.hd,
                          qkv_bias=self.qkv_bias, rope_theta=theta,
                          window=window, use_rope=(self.pos == "rope"))

    def ssm_cfg(self) -> SSMConfig:
        return SSMConfig(self.d_model, self.ssm_d_state, self.ssm_headdim,
                         2, self.ssm_n_groups, 4, self.ssm_chunk)

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.moe_d_ff, self.n_experts,
                         self.top_k, self.n_shared, self.capacity_factor)

    @property
    def n_scanned(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def n_groups(self) -> int:
        if self.n_scanned % self.period:
            raise ValueError(f"{self.name}: {self.n_scanned} scanned layers "
                             f"are not a multiple of the pattern period "
                             f"{self.period}")
        return self.n_scanned // self.period

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, for 6ND math)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        per_attn = (d * (self.n_heads + 2 * self.n_kv) * self.hd
                    + self.n_heads * self.hd * d)
        per_mlp = (3 if self.mlp_kind in ("swiglu", "geglu") else 2) * d * f
        per_moe = (self.n_experts * 3 * d * self.moe_d_ff
                   + self.n_shared * 3 * d * self.moe_d_ff
                   + d * self.n_experts)
        ssm = self.ssm_cfg()
        per_ssm = (d * (2 * ssm.d_inner + 2 * ssm.n_groups * ssm.d_state
                        + ssm.n_heads)
                   + ssm.d_inner * d + ssm.conv_dim * 4)
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = (self.layer_pattern[(max(0, i - self.first_k_dense))
                                       % self.period][0]
                    if i >= self.first_k_dense else ATTN)
            if kind == SSM:
                total += per_ssm
            else:
                total += per_attn
                if self.family == "moe" and i >= self.first_k_dense:
                    total += per_moe
                elif i < self.first_k_dense:
                    total += 3 * d * (f or 4 * d)
                elif self.d_ff:
                    total += per_mlp
        if self.shared_attn_every:
            total += per_attn + (per_mlp if self.d_ff else 0)
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        per_moe_all = (self.n_experts * 3 * d * self.moe_d_ff
                       + self.n_shared * 3 * d * self.moe_d_ff
                       + d * self.n_experts)
        per_moe_act = ((self.top_k + self.n_shared) * 3 * d * self.moe_d_ff
                       + d * self.n_experts)
        n_moe_layers = self.n_layers - self.first_k_dense
        return self.param_count() - n_moe_layers * (per_moe_all - per_moe_act)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(gen, cfg: LMConfig, kind: str, window, theta, device
                ) -> dict:
    kw = dict(device=device, dtype=cfg.dtype)
    if kind == SSM:
        return {"ln1": rmsnorm_init(cfg.d_model, **kw),
                "ssm": ssm_init(gen, cfg.ssm_cfg(), **kw)}
    p = {"ln1": rmsnorm_init(cfg.d_model, **kw),
         "attn": attn_init(gen, cfg.attn_cfg(window, theta), **kw),
         "ln2": rmsnorm_init(cfg.d_model, **kw)}
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg.moe_cfg(), **kw)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)
    return p


def _stacked(make, n: int) -> Any:
    """``n`` trees from ``make()`` (called in order) stacked leaf by leaf
    into (n, ...) tensors, each tree copied in as it is made: the device
    holds the stack and one layer's tree, never n trees and the stack."""
    out = None

    def put(dst, src, g):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], g)
        else:
            dst[g].copy_(src)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

    for g in range(n):
        tree = make()
        if out is None:
            out = alloc(tree)
        put(out, tree, g)
        del tree        # before the next make(): one layer's tree at a time
    return out


def lm_init(gen: torch.Generator | None, cfg: LMConfig,
            device="cpu") -> dict:
    """Random parameters from ``gen`` (drawn on ``gen``'s device, then
    moved to ``device``) in the reference's tree layout and leaf order
    (the numbers differ from ``jax.random``'s; tests carry the port's
    trees over to the reference). A generator on the card draws a
    full-width model there in a fraction of the host's time. On the
    ``meta`` device nothing is drawn and ``gen`` may be None
    (``nn/layers.py:randn``): the abstract tree of the dry run."""
    kw = dict(device=device, dtype=cfg.dtype)
    p: dict[str, Any] = {
        "embed": (randn(gen, (cfg.vocab, cfg.d_model), device)
                  * 0.02).to(**kw),
        "final_norm": rmsnorm_init(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, **kw)
    if cfg.family == "vlm":
        p["vision_proj"] = dense_init(gen, cfg.d_vision, cfg.d_model,
                                      bias=True, **kw)
    for i in range(cfg.first_k_dense):
        # leading dense layers (kimi-k2, gemma3): unscanned attn + MLP
        p[f"dense_{i}"] = {
            "ln1": rmsnorm_init(cfg.d_model, **kw),
            "attn": attn_init(gen, cfg.attn_cfg(*cfg.layer_pattern[0][1:]),
                              **kw),
            "ln2": rmsnorm_init(cfg.d_model, **kw),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff or 4 * cfg.d_model,
                            cfg.mlp_kind, **kw)}
    p["blocks"] = [
        _stacked(lambda: _block_init(gen, cfg, kind, window, theta, device),
                 cfg.n_groups)
        for kind, window, theta in cfg.layer_pattern]
    if cfg.shared_attn_every:
        # zamba2: one shared transformer block, reused after every group
        sp = {"ln": rmsnorm_init(cfg.d_model, **kw),
              "attn": attn_init(gen, cfg.attn_cfg(None, SHARED_THETA), **kw)}
        if cfg.d_ff:
            sp["ln2"] = rmsnorm_init(cfg.d_model, **kw)
            sp["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                 **kw)
        p["shared_attn"] = sp
    return p


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------


def _slice(tree: Any, g: int) -> Any:
    """Group ``g`` of a stacked tree. A stacked pack (G, K, N/2) becomes
    the layer's 2D pack with its scale and zero-point flattened to a
    scalar or an (N,) vector (what K2 takes); an expert stack (G, E, K,
    N/2) becomes the layer's (E, K, N/2) pack with the group's keepdims
    (1, 1, 1|N) scale, which ``moe.expert_packs`` splits into E 2D packs
    sharing it."""
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    if isinstance(tree, PackedW4):
        scale, zp = tree.scale[g], tree.zero_point[g]
        if tree.packed.ndim == 3:
            scale, zp = scale.reshape(-1), zp.reshape(-1)
            if scale.numel() == 1:
                scale, zp = scale.reshape(()), zp.reshape(())
        return dataclasses.replace(tree, packed=tree.packed[g], scale=scale,
                                   zero_point=zp, shape=tuple(tree.shape[1:]))
    return tree[g]


def _moe_block(bp: dict, x, cfg: LMConfig, *, ctx, site: str):
    fn = moe_apply_ep if cfg.moe_impl == "ep" else moe_apply
    return fn(bp["moe"], x, cfg.moe_cfg(), ctx=ctx, site=site)


def _attn_block(bp: dict, h, cos, sin, acfg: AttnConfig, cfg: LMConfig, *,
                ctx, site: str):
    """Pre-norm attention, then the block's MoE or MLP, each a
    residual."""
    x = rmsnorm_apply(bp["ln1"], h)
    h = h + attn_apply(bp["attn"], x, cos, sin, acfg, q_chunk=cfg.q_chunk,
                       ctx=ctx, site=f"{site}/attn")
    if "moe" in bp:
        x = rmsnorm_apply(bp["ln2"], h)
        h = h + _moe_block(bp, x, cfg, ctx=ctx, site=f"{site}/moe")
    elif "mlp" in bp:
        x = rmsnorm_apply(bp["ln2"], h)
        h = h + mlp_apply(bp["mlp"], x, cfg.mlp_kind, ctx=ctx,
                          site=f"{site}/mlp")
    return shard_hint(h, DP, None, None)


def _ssm_block(bp: dict, h, cfg: LMConfig, *, ctx, site: str):
    x = rmsnorm_apply(bp["ln1"], h)
    return shard_hint(h + ssm_apply(bp["ssm"], x, cfg.ssm_cfg(), ctx=ctx,
                                    site=f"{site}/ssm"), DP, None, None)


def _shared_attn(sp: dict, h, cos, sin, cfg: LMConfig, *, ctx):
    x = rmsnorm_apply(sp["ln"], h)
    h = h + attn_apply(sp["attn"], x, cos, sin,
                       cfg.attn_cfg(None, SHARED_THETA), q_chunk=cfg.q_chunk,
                       ctx=ctx, site="shared_attn")
    if "mlp" in sp:
        x = rmsnorm_apply(sp["ln2"], h)
        h = h + mlp_apply(sp["mlp"], x, cfg.mlp_kind, ctx=ctx,
                          site="shared_attn/mlp")
    return h


def _rope_tables(cfg: LMConfig, s: int, device) -> dict:
    """theta -> the f32 (S, hd/2) cos/sin tables the attention layers use
    (the first_k_dense and shared blocks' too); ``{10000: (None, None)}``
    for a model without attention."""
    tables = {}

    def add(theta):
        if theta not in tables:
            tables[theta] = rope_frequencies(cfg.hd, s, theta, device=device)

    for kind, _, theta in cfg.layer_pattern:
        if kind == ATTN:
            add(theta)
    if cfg.first_k_dense or cfg.shared_attn_every:
        kind, _, theta = cfg.layer_pattern[0]
        add(theta if kind == ATTN else SHARED_THETA)
    return tables or {SHARED_THETA: (None, None)}


def _lookup(table, tokens):
    """``table[tokens]``. On DTensors each rank gathers its batch shard's
    rows from the table taken whole (``over_batch``): torch 2.11 (the
    card's) has no working rule for the backward of a gather from a table
    cut over its rows (its ``index_put`` strategy builds an unnormalized
    ``Shard(-1)``)."""
    if isinstance(tokens, DTensor):
        return over_batch(lambda t, w: w[t], tokens, (table,))
    return table[tokens]


def _embed_tokens(p: dict, cfg: LMConfig, tokens: torch.Tensor, extra):
    """The token embeddings (scaled by sqrt(d_model) for gemma), the vlm's
    projected patch embeddings over the first positions, and the
    sinusoidal positions where the config has them."""
    h = _lookup(p["embed"], tokens).to(cfg.dtype)
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=h.device).to(cfg.dtype)
    if cfg.family == "vlm" and extra is not None:
        img = dense_apply(p["vision_proj"], like(extra, h).to(cfg.dtype))
        if img.shape[1] > h.shape[1]:
            raise ValueError(f"{img.shape[1]} image tokens do not fit a "
                             f"sequence of {h.shape[1]}")
        # dynamic_update_slice at 0 along the sequence, out of place
        h = torch.cat([img.to(h.dtype), h[:, img.shape[1]:]], dim=1)
    if cfg.pos == "sinusoidal":
        pos = timestep_embedding(torch.arange(h.shape[1], device=h.device),
                                 cfg.d_model)
        h = h + like(pos[None].to(cfg.dtype), h)
    return shard_hint(h, DP, None, None)


def _head(p: dict, cfg: LMConfig, h, ctx):
    """Final norm, the tied readout or the untied head, the softcap."""
    h = rmsnorm_apply(p["final_norm"], h)
    if cfg.tie_embeddings:
        logits = ops.tied_logits(h, p["embed"])
    else:
        logits = dense_apply(p["lm_head"], h, ctx=ctx, site="lm_head")
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return shard_hint(logits, DP, None, MODEL)


def forward(p: dict, cfg: LMConfig, tokens: torch.Tensor,
            extra: torch.Tensor | None = None, ctx=None) -> torch.Tensor:
    """Full-sequence logits: tokens (B, S) [+ extra (B, n_img, d_vision)]
    -> (B, S, vocab)."""
    s = tokens.shape[1]
    h = _embed_tokens(p, cfg, tokens, extra)
    tables = {theta: tuple(t if t is None else like(t, h) for t in cs)
              for theta, cs in _rope_tables(cfg, s, tokens.device).items()}

    for i in range(cfg.first_k_dense):
        _, window, theta = cfg.layer_pattern[0]
        h = _attn_block(p[f"dense_{i}"], h, *tables[theta],
                        cfg.attn_cfg(window, theta), cfg, ctx=ctx,
                        site="dense_block")

    def group_body(h, group_params):
        for pos_i, (kind, window, theta) in enumerate(cfg.layer_pattern):
            bp, site = group_params[pos_i], f"block_p{pos_i}"
            if kind == SSM:
                h = _ssm_block(bp, h, cfg, ctx=ctx, site=site)
            else:
                h = _attn_block(bp, h, *tables[theta],
                                cfg.attn_cfg(window, theta), cfg, ctx=ctx,
                                site=site)
        if cfg.shared_attn_every:
            # the reference's choice: the first table built
            h = _shared_attn(p["shared_attn"], h, *tables[next(iter(tables))],
                             cfg, ctx=ctx)
        return h

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        group_params = [_slice(stack, g) for stack in p["blocks"]]
        if remat:
            # the recomputation runs on the backward's thread: it takes
            # the forward's ambient mesh with it
            h = checkpoint(group_body, h, group_params, use_reentrant=False,
                           context_fn=recompute_contexts)
        else:
            h = group_body(h, group_params)
    return _head(p, cfg, h, ctx)


def loss_fn(p: dict, cfg: LMConfig, tokens: torch.Tensor,
            extra: torch.Tensor | None = None, ctx=None) -> torch.Tensor:
    """Next-token cross-entropy (mean over tokens), as logsumexp minus the
    label's logit in f32. The label is picked with a gather: the value of
    the reference's one-hot sum, without a (B, S, vocab) one-hot. Under a
    mesh the logits' vocab dim is gathered whole first: DTensor's gather
    along a sharded dim leaves a masked partial sum that its reduction
    mishandles (an IndexError in torch 2.13)."""
    logits = forward(p, cfg, tokens, extra, ctx=ctx)
    lg = shard_hint(logits[:, :-1].to(torch.float32), DP, None, None)
    lse = torch.logsumexp(lg, dim=-1)
    lab = lg.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return (lse - lab).mean()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _stack_spec(per: dict, n: int) -> dict:
    return {k: dict(shape=(n, *v["shape"]), dtype=v["dtype"])
            for k, v in per.items()}


def cache_specs(cfg: LMConfig, batch: int, s_max: int) -> dict:
    """Shape/dtype of every cache tensor: per pattern position a KV cache
    (windowed layers a ring of ``min(s_max, window)`` slots) or an SSM
    state and conv buffer, stacked over groups; ``dense_{i}`` a full KV
    cache each; ``shared`` one KV cache per group (zamba2 shares the
    attention weights, not the caches)."""
    specs: dict[str, Any] = {"blocks": []}
    for kind, window, theta in cfg.layer_pattern:
        if kind == SSM:
            per = ssm_state_spec(batch, cfg.ssm_cfg())
        else:
            s_eff = min(s_max, window) if window else s_max
            per = kv_cache_spec(batch, s_eff, cfg.attn_cfg(window, theta),
                                cfg.kv_dtype)
        specs["blocks"].append(_stack_spec(per, cfg.n_groups))
    for i in range(cfg.first_k_dense):
        specs[f"dense_{i}"] = kv_cache_spec(
            batch, s_max, cfg.attn_cfg(*cfg.layer_pattern[0][1:]),
            cfg.kv_dtype)
    if cfg.shared_attn_every:
        specs["shared"] = _stack_spec(
            kv_cache_spec(batch, s_max, cfg.attn_cfg(None, SHARED_THETA),
                          cfg.kv_dtype), cfg.n_groups)
    return specs


def init_caches(cfg: LMConfig, batch: int, s_max: int, device="cpu") -> dict:
    def make(spec):
        if isinstance(spec, dict) and "shape" in spec:
            return torch.zeros(spec["shape"], dtype=spec["dtype"],
                               device=device)
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return [make(s) for s in spec]

    return make(cache_specs(cfg, batch, s_max))


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def _attn_mlp(bp: dict, h, cache: dict, store_pos: int, valid_len: int,
              rot, acfg: AttnConfig, cfg: LMConfig, *, ctx, site: str,
              attn_site: str | None = None, ln: str = "ln1"):
    """Pre-norm attention decode (at ``attn_site``, ``{site}/attn`` by
    default), then the block's MoE or MLP, each as a residual."""
    x = rmsnorm_apply(bp[ln], h)
    x, _ = attn_decode(bp["attn"], x, cache, store_pos, valid_len, *rot,
                       acfg, kv_dtype=cfg.kv_dtype, ctx=ctx,
                       site=attn_site or f"{site}/attn")
    h = h + x
    if "moe" in bp:
        x = rmsnorm_apply(bp["ln2"], h)
        h = h + moe_apply(bp["moe"], x, cfg.moe_cfg(), ctx=ctx,
                          site=f"{site}/moe")
    elif "mlp" in bp:
        x = rmsnorm_apply(bp["ln2"], h)
        h = h + mlp_apply(bp["mlp"], x, cfg.mlp_kind, ctx=ctx,
                          site=f"{site}/mlp")
    return h


def decode_step(p: dict, cfg: LMConfig, caches: dict, token: torch.Tensor,
                pos: int, ctx=None) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1) ids; pos: the absolute position (a
    Python int, so no step reads the device). Returns (logits
    (B, 1, vocab), caches), the caches updated in place."""
    dev = token.device
    h = p["embed"][token].to(cfg.dtype)
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=dev).to(cfg.dtype)
    if cfg.pos == "sinusoidal":
        t = torch.tensor([float(pos)], device=dev)
        h = h + like(timestep_embedding(t, cfg.d_model)[None].to(cfg.dtype),
                     h)
    h = shard_hint(h, DP, None, None)

    rots: dict[float, tuple] = {}

    def rot(theta):
        """cos/sin (1, hd/2) at the absolute position (the reference's
        decode-time rotation, which equals the RoPE table's row)."""
        if theta not in rots:
            ar = torch.arange(0, cfg.hd, 2, dtype=torch.float32, device=dev)
            ang = float(pos) * (1.0 / (theta ** (ar / cfg.hd)))
            rots[theta] = (like(torch.cos(ang)[None], h),
                           like(torch.sin(ang)[None], h))
        return rots[theta]

    for i in range(cfg.first_k_dense):
        # the reference decodes these over the whole cache, with no window
        _, window, theta = cfg.layer_pattern[0]
        h = _attn_mlp(p[f"dense_{i}"], h, caches[f"dense_{i}"], pos, pos + 1,
                      rot(theta), cfg.attn_cfg(window, theta), cfg, ctx=ctx,
                      site="dense_block")

    for g in range(cfg.n_groups):
        for pos_i, (kind, window, theta) in enumerate(cfg.layer_pattern):
            bp = _slice(p["blocks"][pos_i], g)
            cache = _slice(caches["blocks"][pos_i], g)
            site = f"block_p{pos_i}"
            if kind == SSM:
                x = rmsnorm_apply(bp["ln1"], h)
                x, _ = ssm_decode(bp["ssm"], x, cache, cfg.ssm_cfg(), ctx=ctx,
                                  site=f"{site}/ssm")
                h = h + x
                continue
            # windowed layers keep a ring of ``window`` slots, which needs
            # no mask
            if window:
                store_pos, valid_len = pos % window, min(pos + 1, window)
            else:
                store_pos, valid_len = pos, pos + 1
            h = _attn_mlp(bp, h, cache, store_pos, valid_len, rot(theta),
                          cfg.attn_cfg(None, theta), cfg, ctx=ctx, site=site)
        if cfg.shared_attn_every:
            # zamba2: shared weights, this group's own KV cache
            h = _attn_mlp(p["shared_attn"], h, _slice(caches["shared"], g),
                          pos, pos + 1, rot(SHARED_THETA),
                          cfg.attn_cfg(None, SHARED_THETA), cfg, ctx=ctx,
                          site="shared_attn", attn_site="shared_attn",
                          ln="ln")

    return _head(p, cfg, h, ctx), caches
