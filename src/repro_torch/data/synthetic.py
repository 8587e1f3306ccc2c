"""Synthetic token stream (no datasets are downloaded); port of the token
part of ``repro.data.synthetic``.

Zipf-distributed ids (p proportional to 1/rank) with a short-range copy
structure, so next-token loss is learnable: every position ``i`` with
``i % 4 == 0`` and ``i >= 3`` repeats the token drawn for ``i - 3``. The
draws come from an explicit ``torch.Generator`` (on the device the tokens
are made on). ``jax.random``'s stream cannot be reproduced in torch, so
the port holds the distribution and the copy structure, not the values.
"""
from __future__ import annotations

from typing import Iterator

import torch


def zipf_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int
                ) -> torch.Tensor:
    """(batch, seq) int64 ids on ``gen``'s device."""
    dev = gen.device
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=dev)
    probs = 1.0 / ranks
    probs = probs / probs.sum()
    base = torch.multinomial(probs, batch * seq, replacement=True,
                             generator=gen).reshape(batch, seq)
    idx = torch.arange(seq, device=dev)
    shifted = torch.roll(base, 3, dims=1)
    mask = (idx % 4 == 0) & (idx >= 3)
    return torch.where(mask[None, :], shifted, base)


def token_batches(gen: torch.Generator, batch: int, seq: int, vocab: int
                  ) -> Iterator[torch.Tensor]:
    while True:
        yield zipf_tokens(gen, batch, seq, vocab)
