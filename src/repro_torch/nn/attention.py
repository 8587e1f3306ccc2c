"""GQA attention decode against a preallocated KV cache; port of the decode
part of ``repro.nn.attention``.

One new token attends over the cache. The cache dtype is bf16, fp8 (e4m3)
or packed FP4 (signed E2M1 with an f16 scale per (token, kv-head), the
MSFP-style cache compression). An FP4 cache takes two kernels a layer
(``kernels/kv4.py``): ``kv4_store`` encodes the new token's k and v into
its slot, ``kv4_attend`` attends over the packed cache, decoding it where
it reads it; their plain versions are the reference's arithmetic (K4's
encode, K5's decode, then the attention below). Unlike the reference,
which returns a new cache, ``attn_decode`` writes the new token into the
cache tensors in place and returns the same dict.

For bf16 and fp8 caches the attention stays plain torch
(``kernels/kv4.py:attend``), as the reference leaves it to XLA: the logits
in f32 over f32-cast operands (the reference's ``preferred_element_type=
f32`` on exact upcasts), TF32 off; the weighted sum of the values in the
cache's load dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import kv4, ops
from repro_torch.nn.embeddings import apply_rope
from repro_torch.nn.layers import dense_apply, dense_init

KV_DTYPES = ("bf16", "fp8", "fp4")
FP8_OVERFLOW = 464.0   # e4m3fn: 448 is the largest value, 464 its rounding edge


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None      # sliding-window size; None = global
    softcap: float | None = None
    use_rope: bool = True


def attn_init(gen: torch.Generator, cfg: AttnConfig, device="cpu",
              dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    qkv = dict(bias=cfg.qkv_bias, **kw)
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim, **qkv),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv * cfg.head_dim, **qkv),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv * cfg.head_dim, **qkv),
        "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, **kw),
    }


def _qkv(p, x, cfg: AttnConfig, cos, sin, *, ctx=None, site=None):
    """x (B, S, D) -> q (B, S, K, G, hd), k and v (B, S, K, hd), RoPE on q
    and k."""
    b, s, _ = x.shape
    g = cfg.n_heads // cfg.n_kv
    q = dense_apply(p["wq"], x, ctx=ctx, site=f"{site}/wq")
    k = dense_apply(p["wk"], x, ctx=ctx, site=f"{site}/wk")
    v = dense_apply(p["wv"], x, ctx=ctx, site=f"{site}/wv")
    q = q.reshape(b, s, cfg.n_kv * g, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv, cfg.head_dim)
    if cfg.use_rope and cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q.reshape(b, s, cfg.n_kv, g, cfg.head_dim), k, v


def kv_cache_spec(batch: int, s_max: int, cfg: AttnConfig,
                  kv_dtype: str = "bf16") -> dict:
    """Shape and dtype of one layer's cache tensors."""
    shape = (batch, s_max, cfg.n_kv, cfg.head_dim)
    if kv_dtype == "bf16":
        kv = dict(shape=shape, dtype=torch.bfloat16)
        return {"k": kv, "v": kv}
    if kv_dtype == "fp8":
        kv = dict(shape=shape, dtype=torch.float8_e4m3fn)
        return {"k": kv, "v": kv}
    if kv_dtype == "fp4":
        kv = dict(shape=(*shape[:-1], cfg.head_dim // 2), dtype=torch.uint8)
        sc = dict(shape=shape[:-1], dtype=torch.float16)
        return {"k": kv, "v": kv, "k_scale": sc, "v_scale": sc}
    raise ValueError(f"kv dtype {kv_dtype!r} not in {KV_DTYPES}")


def init_kv_cache(batch: int, s_max: int, cfg: AttnConfig,
                  kv_dtype: str = "bf16", device="cpu") -> dict:
    spec = kv_cache_spec(batch, s_max, cfg, kv_dtype)
    return {k: torch.zeros(v["shape"], dtype=v["dtype"], device=device)
            for k, v in spec.items()}


def to_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``astype(float8_e4m3fn)`` as JAX does it: round to nearest even, and
    NaN for what rounds past 448 (|x| > 464, inf). PyTorch's cast saturates
    to +-448 instead, so those inputs are set to NaN first."""
    xf = x.to(torch.float32)
    xf = torch.where(xf.abs() > FP8_OVERFLOW,
                     torch.full_like(xf, float("nan")), xf)
    return xf.to(torch.float8_e4m3fn)


def _kv_store(cache: dict, k_new, v_new, pos: int, kv_dtype: str) -> None:
    """Write one position (B, 1, K, hd) into a bf16/fp8 cache at ``pos``."""
    cast = ((lambda t: t.to(torch.bfloat16)) if kv_dtype == "bf16"
            else to_fp8_e4m3)
    cache["k"][:, pos] = cast(k_new[:, 0])
    cache["v"][:, pos] = cast(v_new[:, 0])


def attn_decode(p: dict, x: torch.Tensor, cache: dict, store_pos: int,
                valid_len: int, cos_t, sin_t, cfg: AttnConfig, *,
                kv_dtype: str = "bf16", ctx=None,
                site: str | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D).

    ``store_pos``: cache slot of the new token (ring index for windowed
    layers, absolute position otherwise); ``valid_len``: number of valid
    slots to attend over. cos_t/sin_t: (1, hd/2) rotation at the token's
    absolute position, applied before the store, so ring slots keep their
    own rotation after wraparound.
    """
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, cos_t, sin_t, ctx=ctx, site=site)
    scale = cfg.head_dim ** -0.5
    if kv_dtype == "fp4":
        fp4 = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
        ops.kv4_store(k[:, 0], v[:, 0], *fp4, store_pos)
        o = ops.kv4_attend(q[:, 0], *fp4, valid_len, scale, cfg.softcap)
    else:
        _kv_store(cache, k, v, store_pos, kv_dtype)
        keys, vals = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        o = kv4.attend(q[:, 0], keys, vals, valid_len, scale, cfg.softcap)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return dense_apply(p["wo"], o, ctx=ctx, site=f"{site}/wo"), cache
