"""musicgen-large [audio] — decoder-only over EnCodec tokens (2306.05284).
Port of ``repro.configs.musicgen_large``.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048, GELU MLP,
sinusoidal positions. The EnCodec frontend is a stub per the assignment:
input_specs provide token ids (the 4-codebook interleave is flattened).
"""
import torch

from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig("musicgen-large", family="audio", n_layers=48,
                    d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=2048,
                    mlp_kind="gelu", pos="sinusoidal", head_dim=64)


def smoke() -> LMConfig:
    return LMConfig("musicgen-smoke", family="audio", n_layers=3, d_model=64,
                    n_heads=4, n_kv=4, d_ff=128, vocab=64, mlp_kind="gelu",
                    pos="sinusoidal", head_dim=16, dtype=torch.float32,
                    q_chunk=8)
