"""Noise schedules and the DFA denoising factor; port of
``repro.diffusion.schedule``.

The schedule is computed in float64 with numpy (as the reference does) and
stored as f32 CPU tensors: the samplers read per-step scalars from it on
the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor        # (T,) f32, CPU
    alphas: torch.Tensor       # (T,)
    alpha_bars: torch.Tensor   # (T,) cumulative products

    @property
    def T(self) -> int:
        return self.betas.shape[0]

    def gamma(self) -> torch.Tensor:
        """DFA denoising factor (paper Eq. 4) for every t, f32 on the CPU."""
        from repro_torch.core.dfa import denoising_factor
        return denoising_factor(self.alphas, self.alpha_bars)


def make_schedule(kind: str = "linear", T: int = 1000, *,
                  beta_start: float = 1e-4, beta_end: float = 0.02
                  ) -> NoiseSchedule:
    if kind == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif kind == "quad":  # DDIM paper's CelebA schedule
        betas = np.linspace(beta_start**0.5, beta_end**0.5, T,
                            dtype=np.float64) ** 2
    elif kind == "cosine":
        s = 0.008
        ts = np.arange(T + 1, dtype=np.float64) / T
        f = np.cos((ts + s) / (1 + s) * np.pi / 2) ** 2
        ab = f / f[0]
        betas = np.clip(1 - ab[1:] / ab[:-1], 0, 0.999)
    else:
        raise ValueError(kind)
    alphas = 1.0 - betas
    alpha_bars = np.cumprod(alphas)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return NoiseSchedule(f32(betas), f32(alphas), f32(alpha_bars))


def sample_timesteps(T: int, steps: int) -> np.ndarray:
    """DDIM uniform-stride timestep subsequence, descending."""
    seq = np.linspace(0, T - 1, steps).round().astype(np.int64)
    return np.unique(seq)[::-1].copy()
