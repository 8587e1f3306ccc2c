"""Synthetic data (no datasets are downloaded); port of
``repro.data.synthetic``.

Image stream: a learnable toy distribution for the DDIM reproduction, each
image a 2D Gaussian bump with random centre, width, amplitude and sign
per channel over a linear gradient background (``gaussian_bump_images``,
whose arithmetic is ``bump_images``, a pure function of the five draws).

Token stream: Zipf-distributed ids (p proportional to 1/rank) with a
short-range copy structure, so next-token loss is learnable: every
position ``i`` with ``i % 4 == 0`` and ``i >= 3`` repeats the token drawn
for ``i - 3``. The draws come from an explicit ``torch.Generator`` (on
the device the tokens are made on): one uniform a token, looked up in the
distribution's cumulative sum (``zipf_cdf``), so a seed gives the same
tokens on every run. ``torch.multinomial`` does not on the card: its
cumulative sum over a 1-D distribution is a scan whose partial sums meet
in an order that varies between runs, and up to 2 draws of 4096 moved
between runs.

``ShardedLoader``: each data-parallel rank draws from a generator of its
own and its batches are its shard of the global batch.

``jax.random``'s streams cannot be reproduced in torch, so the port holds
the distributions and the structure, not the values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch
from torch.distributed.tensor import DTensor


def bump_images(cx, cy, w, amp, sign, size: int) -> torch.Tensor:
    """(n, size, size, channels) in [-1, 1] from the draws: centres cx, cy
    and width w (n, 1, 1, 1) in pixels, amplitude amp and sign (+-1)
    (n, 1, 1, channels)."""
    xs = torch.arange(size, dtype=torch.float32,
                      device=cx.device)[None, :, None, None]
    ys = torch.arange(size, dtype=torch.float32,
                      device=cx.device)[None, None, :, None]
    bump = torch.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * w ** 2)))
    grad = (xs / size - 0.5) * 0.6
    return torch.clamp(sign * amp * bump + grad, -1.0, 1.0)


def gaussian_bump_images(gen: torch.Generator, n: int, size: int,
                         channels: int = 3) -> torch.Tensor:
    """(n, size, size, channels) in [-1, 1], on ``gen``'s device."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=gen.device) \
            * (hi - lo) + lo

    one, per_channel = (n, 1, 1, 1), (n, 1, 1, channels)
    cx = uniform(one, 0.2, 0.8) * size
    cy = uniform(one, 0.2, 0.8) * size
    w = uniform(one, 0.08, 0.25) * size
    amp = uniform(per_channel, 0.5, 1.0)
    sign = torch.where(uniform(per_channel, 0.0, 1.0) < 0.5, 1.0, -1.0)
    return bump_images(cx, cy, w, amp, sign, size)


def image_batches(gen: torch.Generator, batch: int, size: int,
                  channels: int = 3) -> Iterator[torch.Tensor]:
    while True:
        yield gaussian_bump_images(gen, batch, size, channels)


def zipf_cdf(vocab: int) -> torch.Tensor:
    """The cumulative distribution of p proportional to 1/rank over
    ``vocab`` ids, in f64 on the CPU, whose sums run in one order."""
    probs = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)
    return torch.cumsum(probs / probs.sum(), dim=0)


def zipf_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int
                ) -> torch.Tensor:
    """(batch, seq) int64 ids on ``gen``'s device."""
    dev = gen.device
    u = torch.rand(batch * seq, generator=gen, device=dev,
                   dtype=torch.float64)
    base = torch.searchsorted(zipf_cdf(vocab).to(dev), u, right=True
                              ).clamp_max(vocab - 1).reshape(batch, seq)
    idx = torch.arange(seq, device=dev)
    shifted = torch.roll(base, 3, dims=1)
    mask = (idx % 4 == 0) & (idx >= 3)
    return torch.where(mask[None, :], shifted, base)


def token_batches(gen: torch.Generator, batch: int, seq: int, vocab: int
                  ) -> Iterator[torch.Tensor]:
    while True:
        yield zipf_tokens(gen, batch, seq, vocab)


@dataclasses.dataclass
class ShardedLoader:
    """Host-sharded loader: each data-parallel rank (``host_id``, its
    coordinate on the data axes) draws from a generator of its own, seeded
    ``seed * 1000003 + host_id``; ``make_batch(gen)`` makes this rank's
    batch, which with a ``sharding`` (a ``common/sharding.py:
    NamedSharding``) is placed as this rank's shard of the global batch
    (``DTensor.from_local``: ranks that share a data coordinate draw the
    same stream and hold the same shard)."""
    batch: int
    make_batch: Callable
    sharding: object | None = None
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def __iter__(self):
        gen = torch.Generator().manual_seed(self.seed * 1000003
                                            + self.host_id)
        while True:
            b = self.make_batch(gen)
            if self.sharding is not None:
                b = DTensor.from_local(b, self.sharding.mesh,
                                       self.sharding.placements,
                                       run_check=False)
            yield b
