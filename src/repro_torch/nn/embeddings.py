"""Sinusoidal timestep embedding and RoPE; port of ``repro.nn.embeddings``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """DDPM sinusoidal timestep embedding, cos then sin.
    t: (...,) -> (..., dim) f32."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = t.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10_000.0,
                     dtype=torch.float32, device="cpu"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Precomputed RoPE cos/sin tables: (max_seq, head_dim//2)."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (ar / head_dim))
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    ang = pos[:, None] * inv[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate the half-split pairs (x[..., j], x[..., j + D/2]).
    x: (..., S, H, D); cos/sin: (S, D//2) or (..., S, D//2). The rotation
    runs in the tables' type (f32) and the result is cast to x.dtype."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:  # (S, D/2) -> broadcast over batch and heads
        cos, sin = cos[:, None, :], sin[:, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
