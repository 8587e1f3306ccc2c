"""LM decode for the dense family; port of the serving part of
``repro.models.lm``.

The parameter tree is the reference's: ``embed``, ``final_norm``,
optional ``lm_head``, and ``blocks``, a list with one entry per position of
``layer_pattern``, each a tree of tensors stacked over ``n_groups`` (the
reference scans over that axis). ``decode_step`` loops over the groups
instead, and hands each layer its slice: a stacked ``PackedW4`` becomes the
layer's 2D pack with a scalar (or per-output-channel) scale, so every
dense site runs the fused W4A4 kernel K2, never the stacked-pack oracle.
Caches are stacked the same way and written in place.

Dense family only: sliding-window ring slots, ``scale_embed``, sinusoidal
positions, the logit softcap and ``qkv_bias`` are here; the
moe, ssm, hybrid and vlm families, ``first_k_dense`` and
``shared_attn_every`` raise ``NotImplementedError`` (ROADMAP Queue A
item 12), as do ``forward``/``loss_fn`` (the training slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops
from repro_torch.nn.attention import (AttnConfig, attn_decode, attn_init,
                                      kv_cache_spec)
from repro_torch.nn.embeddings import (rope_frequencies,
                                       timestep_embedding)
from repro_torch.nn.layers import (dense_apply, dense_init, rmsnorm_apply,
                                   rmsnorm_init)
from repro_torch.nn.mlp import mlp_apply, mlp_init

ATTN = "attn"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` fields that decode reads (``family``,
    ``first_k_dense`` and ``shared_attn_every`` only to refuse what is not
    ported); ``dtype`` is a torch dtype."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    family: str = "dense"
    head_dim: int | None = None
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    pos: str = "rope"                # rope | sinusoidal
    scale_embed: bool = False        # gemma: h *= sqrt(d_model)
    tie_embeddings: bool = False
    # depth pattern, period P entries of (kind, window|None, rope_theta)
    layer_pattern: tuple = ((ATTN, None, 10_000.0),)
    first_k_dense: int = 0
    shared_attn_every: int = 0
    dtype: Any = torch.bfloat16
    kv_dtype: str = "bf16"           # bf16 | fp8 | fp4  (serving KV cache)
    logits_softcap: float | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        n = self.n_layers - self.first_k_dense
        if n % self.period:
            raise ValueError(f"{self.name}: {n} scanned layers are not a "
                             f"multiple of the pattern period {self.period}")
        return n // self.period

    def attn_cfg(self, window, theta) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.n_kv, self.hd,
                          qkv_bias=self.qkv_bias, rope_theta=theta,
                          window=window, use_rope=(self.pos == "rope"))


def check_supported(cfg: LMConfig) -> None:
    """Raise for what the port's LM slice does not run yet."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.first_k_dense:
        missing.append("first_k_dense")
    if cfg.shared_attn_every:
        missing.append("shared_attn_every")
    if any(kind != ATTN for kind, _, _ in cfg.layer_pattern):
        missing.append("ssm layers")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port runs "
            f"the dense family; the rest is ROADMAP Queue A item 12)")


def _block_init(gen, cfg: LMConfig, window, theta, device) -> dict:
    kw = dict(device=device, dtype=cfg.dtype)
    p = {"ln1": rmsnorm_init(cfg.d_model, **kw),
         "attn": attn_init(gen, cfg.attn_cfg(window, theta), **kw),
         "ln2": rmsnorm_init(cfg.d_model, **kw)}
    if cfg.d_ff:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)
    return p


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def lm_init(gen: torch.Generator, cfg: LMConfig, device="cpu") -> dict:
    """Random parameters from ``gen`` in the reference's tree layout (the
    numbers differ from ``jax.random``'s; tests carry the reference's
    trees over with ``convert.from_numpy_tree``)."""
    check_supported(cfg)
    p: dict[str, Any] = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen)
                  * 0.02).to(device=device, dtype=cfg.dtype),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=device,
                                  dtype=cfg.dtype)
    p["blocks"] = [
        _stack([_block_init(gen, cfg, window, theta, device)
                for _ in range(cfg.n_groups)])
        for _, window, theta in cfg.layer_pattern]
    return p


def cache_specs(cfg: LMConfig, batch: int, s_max: int) -> dict:
    """Shape/dtype of every cache tensor, stacked over groups; windowed
    layers keep a ring of ``min(s_max, window)`` slots."""
    check_supported(cfg)
    specs: dict[str, Any] = {"blocks": []}
    for _, window, theta in cfg.layer_pattern:
        s_eff = min(s_max, window) if window else s_max
        per = kv_cache_spec(batch, s_eff, cfg.attn_cfg(window, theta),
                            cfg.kv_dtype)
        specs["blocks"].append({
            k: dict(shape=(cfg.n_groups, *v["shape"]), dtype=v["dtype"])
            for k, v in per.items()})
    return specs


def init_caches(cfg: LMConfig, batch: int, s_max: int, device="cpu") -> dict:
    return {"blocks": [
        {k: torch.zeros(v["shape"], dtype=v["dtype"], device=device)
         for k, v in per.items()}
        for per in cache_specs(cfg, batch, s_max)["blocks"]]}


def _slice(tree: Any, g: int) -> Any:
    """Group ``g`` of a stacked tree; a stacked pack becomes the layer's
    2D pack with a scalar or (N,) scale (what K2 takes)."""
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    if isinstance(tree, PackedW4):
        scale = tree.scale[g].reshape(-1)
        zp = tree.zero_point[g].reshape(-1)
        if scale.numel() == 1:
            scale, zp = scale.reshape(()), zp.reshape(())
        return dataclasses.replace(tree, packed=tree.packed[g], scale=scale,
                                   zero_point=zp, shape=tuple(tree.shape[1:]))
    return tree[g]


def decode_step(p: dict, cfg: LMConfig, caches: dict, token: torch.Tensor,
                pos: int, ctx=None) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1) ids; pos: the absolute position (a
    Python int, so no step reads the device). Returns (logits
    (B, 1, vocab), caches), the caches updated in place."""
    check_supported(cfg)
    dev = token.device
    h = p["embed"][token].to(cfg.dtype)
    if cfg.scale_embed:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=dev).to(cfg.dtype)
    if cfg.pos == "sinusoidal":
        t = torch.tensor([float(pos)], device=dev)
        h = h + timestep_embedding(t, cfg.d_model)[None].to(cfg.dtype)
    # cos/sin (1, hd/2) of the absolute position: the last row of the table
    rot = {theta: tuple(t[pos:] for t in rope_frequencies(
        cfg.hd, pos + 1, theta, device=dev))
        for _, _, theta in cfg.layer_pattern}
    for g in range(cfg.n_groups):
        for pos_i, (_, window, theta) in enumerate(cfg.layer_pattern):
            bp = _slice(p["blocks"][pos_i], g)
            cache = _slice(caches["blocks"][pos_i], g)
            site = f"block_p{pos_i}"
            acfg = cfg.attn_cfg(None, theta)   # ring slots need no mask
            if window:
                store_pos, valid_len = pos % window, min(pos + 1, window)
            else:
                store_pos, valid_len = pos, pos + 1
            x = rmsnorm_apply(bp["ln1"], h)
            x, _ = attn_decode(bp["attn"], x, cache, store_pos, valid_len,
                               *rot[theta], acfg, kv_dtype=cfg.kv_dtype,
                               ctx=ctx, site=f"{site}/attn")
            h = h + x
            if "mlp" in bp:
                x = rmsnorm_apply(bp["ln2"], h)
                h = h + mlp_apply(bp["mlp"], x, cfg.mlp_kind, ctx=ctx,
                                  site=f"{site}/mlp")
    h = rmsnorm_apply(p["final_norm"], h)
    if cfg.tie_embeddings:
        logits = ops.tied_logits(h, p["embed"])
    else:
        logits = dense_apply(p["lm_head"], h, ctx=ctx, site="lm_head")
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits, caches
