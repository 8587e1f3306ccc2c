"""Sinusoidal timestep embedding; port of ``repro.nn.embeddings``."""
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
