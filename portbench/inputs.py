"""What the benchmark hands to both sides of the UNet family
(``families/unet.py``), made from ``--seed`` on the device in a few large
draws: the UNet's parameters, the TALoRA hubs and router, and each
request's x_T.

Every conv and dense weight is drawn at its fan-in scale (``N(0, 1 /
fan_in)``), the output layers included, so that every layer moves the
model's eps; biases and norm affines are drawn near their usual values.
Each adapter's ``B`` is drawn (not zero, as an untrained hub has it) so
that a weight set differs from segment to segment by about 5% of its
weight's spread, and the merge is part of what is compared.
"""
from __future__ import annotations

import math

import torch

from portbench import reference


def _draw(gen: torch.Generator, numels: list[int]) -> list[torch.Tensor]:
    flat = torch.randn(sum(numels), generator=gen, device=gen.device)
    return list(torch.split(flat, numels))


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return out


def params(cfg: dict, gen: torch.Generator) -> dict:
    shapes = reference.flat_shapes(cfg)
    draws = _draw(gen, [math.prod(s) for s in shapes.values()])
    flat = {}
    for (path, shape), d in zip(shapes.items(), draws):
        d = d.reshape(shape)
        leaf = path.rsplit("/", 1)[1]
        if leaf == "w":
            flat[path] = d * math.prod(shape[:-1]) ** -0.5
        elif leaf == "g":
            flat[path] = 1.0 + 0.1 * d
        else:
            flat[path] = 0.1 * d
    return _nest(flat)


def hubs(cfg: dict, gen: torch.Generator) -> dict:
    tal = cfg["talora"]
    h, r = tal["hub_size"], tal["rank"]
    dims = {site: (math.prod(s[:-1]), s[-1])
            for site, s in reference.flat_shapes(cfg).items()
            if site in reference.weight_sites(cfg)}
    a = _draw(gen, [h * din * r for din, _ in dims.values()])
    b = _draw(gen, [h * r * dout for _, dout in dims.values()])
    b_scale = 0.05 * r / tal["alpha"]
    return {site: {"A": ai.reshape(h, din, r) * r ** -0.5,
                   "B": bi.reshape(h, r, dout) * (b_scale * din ** -0.5)}
            for (site, (din, dout)), ai, bi in zip(dims.items(), a, b)}


def router(cfg: dict, gen: torch.Generator) -> dict:
    tal = cfg["talora"]
    d, hid = tal["t_emb_dim"], tal["router_hidden"]
    out = len(reference.weight_sites(cfg)) * tal["hub_size"]
    w1, b1, w2, b2 = _draw(gen, [d * hid, hid, hid * out, out])
    return {"w1": w1.reshape(d, hid) * d ** -0.5, "b1": 0.1 * b1,
            "w2": w2.reshape(hid, out) * hid ** -0.5, "b2": 0.1 * b2}


def noise(cfg: dict, gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, H, W, C) x_T, row i for the request of index i."""
    s = cfg["image_size"]
    return torch.randn((n, s, s, cfg["in_ch"]), generator=gen,
                       device=gen.device)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
