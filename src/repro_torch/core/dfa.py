"""DFA: Denoising-Factor loss Alignment (paper §4.3, Eq. 4/9); port of
``repro.core.dfa``.

The plain distillation loss L_t = ||eps_fp - eps_q||^2 mis-weights
timesteps: Eq. 3 applies the predicted noise with coefficient

    gamma_t = (1 / sqrt(alpha_t)) * (1 - alpha_t) / sqrt(1 - alpha_bar_t)

so an eps error at step t moves x_{t-1} by gamma_t * error. DFA rescales
the per-step loss by gamma_t (Eq. 9).
"""
from __future__ import annotations

import torch


def denoising_factor(alphas: torch.Tensor, alpha_bars: torch.Tensor
                     ) -> torch.Tensor:
    """gamma_t for every t (Eq. 4). alphas/alpha_bars: (T,)."""
    return (1.0 / torch.sqrt(alphas)) * (1.0 - alphas) / torch.sqrt(
        1.0 - alpha_bars)


def eps_mse(eps_fp: torch.Tensor, eps_q: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE between teacher and student noise predictions."""
    d = (eps_fp.to(torch.float32) - eps_q.to(torch.float32)) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=-1)


def dfa_loss(eps_fp: torch.Tensor, eps_q: torch.Tensor,
             gamma_t: torch.Tensor) -> torch.Tensor:
    """Eq. 9: mean over the batch of gamma_t * ||eps_fp - eps_q||^2, with
    gamma_t the (B,) factor of each sample's timestep."""
    return torch.mean(gamma_t * eps_mse(eps_fp, eps_q))


def plain_loss(eps_fp: torch.Tensor, eps_q: torch.Tensor,
               gamma_t: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 7 baseline (gamma ignored), for the ablation."""
    return torch.mean(eps_mse(eps_fp, eps_q))


def denoising_gap(x_prev_fp: torch.Tensor, x_prev_q: torch.Tensor
                  ) -> torch.Tensor:
    """MSE(x_{t-1}, x_hat_{t-1}) per sample: the paper's 'performance gap'
    (Fig. 3's ground-truth curve)."""
    d = (x_prev_fp.to(torch.float32) - x_prev_q.to(torch.float32)) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=-1)
