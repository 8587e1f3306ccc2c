"""Adam/AdamW over trees of tensors: moment dtype, clipping, schedules; port
of ``repro.optim.adam``.

The update is functional, as the reference's: ``adam_update`` returns new
parameter and state trees (detached tensors) and leaves its inputs alone.
Trees are nested dicts/lists of tensors, walked in sorted key order as
``jax.tree`` walks them, so the global norm sums the leaves in the
reference's order. ``step`` is a 0-d int32 tensor on the parameters'
device, so no step reads the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.common.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    moment_dtype: Any = torch.float32
    schedule: str = "constant"     # constant | cosine | linear_warmup_cosine
    warmup_steps: int = 0
    total_steps: int = 10_000


def lr_at(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=s.device)
    if cfg.schedule == "constant":
        return lr
    if cfg.schedule not in ("cosine", "linear_warmup_cosine"):
        raise ValueError(cfg.schedule)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return lr * warm * cos


def adam_init(params: Any, cfg: AdamConfig) -> dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(l.to(torch.float32)))
            for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adam_update(grads: Any, state: dict, params: Any, cfg: AdamConfig
                ) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                1.0)
        grads = tree_map(lambda g: g * scale, grads)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=sf.device), sf)
    lr = lr_at(cfg, step)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = lr * mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + lr * cfg.weight_decay * p.to(torch.float32)
        return ((p.detach().to(torch.float32) - delta).to(p.dtype),
                m_new.to(cfg.moment_dtype), v_new.to(cfg.moment_dtype))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    is_leaf = (lambda t: isinstance(t, tuple)
               and len(t) == 3 and isinstance(t[0], torch.Tensor))

    def pick(node, i):
        if is_leaf(node):
            return node[i]
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return type(node)(pick(v, i) for v in node)

    return (pick(out, 0), {"m": pick(out, 1), "v": pick(out, 2),
                           "step": step},
            {"grad_norm": gnorm, "lr": lr})


@dataclasses.dataclass
class EMA:
    """Exponential moving average of params (diffusion training standard)."""
    decay: float = 0.999

    def init(self, params):
        return tree_map(lambda p: p.detach().to(torch.float32), params)

    def update(self, ema, params):
        d = self.decay
        return tree_map(lambda e, p: d * e + (1 - d) * p.detach().to(
            torch.float32), ema, params)
