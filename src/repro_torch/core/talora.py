"""TALoRA: timestep-aware LoRA hub + learnable router (paper §4.2); port
of ``repro.core.talora``.

Each quantized layer carries a hub of ``h`` LoRA adapters; one router maps
the sinusoidal timestep embedding to per-(layer, slot) logits, and a
straight-through argmax (``ste_one_hot``) turns those into a hard one-of-h
selection, so one adapter is active per layer per timestep while the
router still gets the softmax's gradient. The fine-tune folds the selected
adapters into the weights (``merge_into_tree``, differentiable in the hubs
and the selection); serving does the same per routing segment.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.nn.embeddings import timestep_embedding


@dataclasses.dataclass(frozen=True)
class TALoRAConfig:
    hub_size: int = 2          # h — paper finds h=2 optimal (App. E.2)
    rank: int = 32             # paper App. C
    alpha: float = 32.0        # scaling = alpha / rank
    router_hidden: int = 128
    t_emb_dim: int = 128       # timestep embedding dim fed to the router


def init_lora_hub(generator: torch.Generator,
                  layer_dims: dict[str, tuple[int, int]], cfg: TALoRAConfig,
                  device="cpu") -> dict[str, Any]:
    """Per-layer hubs: A ~ N(0, 1/r) (h, in, r); B = 0 (h, r, out)."""
    hubs = {}
    for name, (d_in, d_out) in layer_dims.items():
        a = torch.randn((cfg.hub_size, d_in, cfg.rank), generator=generator)
        hubs[name] = {
            "A": (a / cfg.rank ** 0.5).to(device),
            "B": torch.zeros((cfg.hub_size, cfg.rank, d_out), device=device),
        }
    return hubs


def init_router(generator: torch.Generator, n_layers: int, cfg: TALoRAConfig,
                device="cpu") -> dict[str, Any]:
    w1 = torch.randn((cfg.t_emb_dim, cfg.router_hidden), generator=generator)
    w2 = torch.randn((cfg.router_hidden, n_layers * cfg.hub_size),
                     generator=generator)
    return {
        "w1": (w1 / cfg.t_emb_dim ** 0.5).to(device),
        "b1": torch.zeros((cfg.router_hidden,), device=device),
        "w2": (w2 / cfg.router_hidden ** 0.5).to(device),
        "b2": torch.zeros((n_layers * cfg.hub_size,), device=device),
    }


def router_logits(router: dict, t: torch.Tensor, n_layers: int,
                  cfg: TALoRAConfig) -> torch.Tensor:
    """(..., n_layers, h) logits for timesteps t of shape (...)."""
    emb = timestep_embedding(t.to(torch.float32), cfg.t_emb_dim)
    hdn = torch.tanh(emb @ router["w1"] + router["b1"])
    out = hdn @ router["w2"] + router["b2"]
    return out.reshape(*t.shape, n_layers, cfg.hub_size)


def ste_one_hot(logits: torch.Tensor) -> torch.Tensor:
    """Hard one-hot over the last axis; softmax gradient (STE)."""
    soft = torch.softmax(logits, dim=-1)
    hard = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                       logits.shape[-1]).to(soft.dtype)
    return soft + (hard - soft).detach()


def route(router: dict, t: torch.Tensor, layer_names: list[str],
          cfg: TALoRAConfig) -> dict[str, torch.Tensor]:
    """Per-layer hard selection weights (h,) for a scalar timestep t."""
    t = torch.as_tensor(t, dtype=torch.float32, device=router["w1"].device)
    sel = ste_one_hot(router_logits(router, t, len(layer_names), cfg))
    return {name: sel[i] for i, name in enumerate(layer_names)}


def _selected(hub: dict, sel: torch.Tensor):
    """(A_sel, B_sel): the hub contracted with the (h,) selection, which
    keeps the router differentiable while one adapter's math runs."""
    return (torch.einsum("h,hir->ir", sel, hub["A"]),
            torch.einsum("h,hro->ro", sel, hub["B"]))


def lora_delta(x: torch.Tensor, hub: dict, sel: torch.Tensor,
               cfg: TALoRAConfig) -> torch.Tensor:
    """Selected adapter's contribution: (x @ A_sel) @ B_sel * alpha/r."""
    a_sel, b_sel = _selected(hub, sel)
    return ((x @ a_sel) @ b_sel) * (cfg.alpha / cfg.rank)


def lora_apply(x: torch.Tensor, w_q: torch.Tensor, hub: dict | None,
               sel: torch.Tensor | None, cfg: TALoRAConfig) -> torch.Tensor:
    """y = x @ W_quantized + LoRA_sel(x)."""
    y = x @ w_q
    if hub is not None and sel is not None:
        y = y + lora_delta(x, hub, sel, cfg)
    return y


def merged_weight(w_q: torch.Tensor, hub: dict, sel: torch.Tensor,
                  cfg: TALoRAConfig) -> torch.Tensor:
    """W_q + A_sel B_sel * alpha/r: the adapter folded for serving."""
    a_sel, b_sel = _selected(hub, sel)
    return w_q + (a_sel @ b_sel) * (cfg.alpha / cfg.rank)


def allocation_histogram(router: dict, timesteps, layer_names: list[str],
                         cfg: TALoRAConfig) -> torch.Tensor:
    """(T, h) fraction of layers routed to each hub slot per timestep (the
    paper's Fig. 7/9 allocation plots)."""
    ts = torch.as_tensor(timesteps, dtype=torch.float32,
                         device=router["w1"].device)
    logits = router_logits(router, ts, len(layer_names), cfg)
    hard = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                       cfg.hub_size).to(torch.float32)
    return hard.mean(dim=-2)


def routing_signatures(router: dict, timesteps, layer_names: list[str],
                       cfg: TALoRAConfig) -> torch.Tensor:
    """(T, n_layers) int32 hard slot selection per timestep.

    An argmax over float logits: computed in f32 on the host, in the
    reference's order, so near-ties resolve as the JAX package does.
    """
    router = {k: v.detach().to("cpu", torch.float32) for k, v in router.items()}
    ts = torch.as_tensor(timesteps, dtype=torch.float32, device="cpu")
    logits = router_logits(router, ts, len(layer_names), cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def lora_target_dims_from_weights(weights: dict, cfg: TALoRAConfig | None = None
                                  ) -> dict[str, tuple[int, int]]:
    """LoRA dims for flat path->weight maps: (prod(in dims), out)."""
    dims = {}
    for name, w in weights.items():
        if hasattr(w, "ndim") and w.ndim >= 2:
            d_in = 1
            for s in w.shape[:-1]:
                d_in *= s
            dims[name] = (d_in, w.shape[-1])
    return dims


def merge_into_tree(params: dict, hubs: dict[str, dict],
                    sels: dict[str, torch.Tensor], cfg: TALoRAConfig) -> dict:
    """Fold each site's selected adapter into its (frozen) weight:
    w_eff = w + (A_sel @ B_sel).reshape(w.shape) * alpha/r. Gradients
    reach the hubs and the selection, never the base weight."""
    flat = flatten_paths(params)
    scale = cfg.alpha / cfg.rank
    for site, hub in hubs.items():
        w = flat[site]
        a_sel, b_sel = _selected(hub, sels[site])
        delta = (a_sel @ b_sel).reshape(w.shape) * scale
        flat[site] = w.detach() + delta.to(w.dtype)
    return unflatten_paths(flat)
