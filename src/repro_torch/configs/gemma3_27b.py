"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.
Port of ``repro.configs.gemma3_27b``.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144, GeGLU,
head_dim=128, sliding window 1024 on local layers, rope theta 10k local /
1M global. 62 = 2 leading (unscanned) local layers + 10 scanned groups of
(5 local + 1 global).
"""
import torch

from repro_torch.models.lm import LMConfig, ATTN

_PAT = ((ATTN, 1024, 10_000.0),) * 5 + ((ATTN, None, 1_000_000.0),)


def full() -> LMConfig:
    return LMConfig("gemma3-27b", n_layers=62, d_model=5376, n_heads=32,
                    n_kv=16, d_ff=21504, vocab=262144, mlp_kind="geglu",
                    head_dim=128, scale_embed=True, layer_pattern=_PAT,
                    first_k_dense=2)


def smoke() -> LMConfig:
    return LMConfig("gemma3-27b-smoke", n_layers=8, d_model=64, n_heads=4,
                    n_kv=2, d_ff=128, vocab=128, mlp_kind="geglu",
                    head_dim=16, scale_embed=True,
                    layer_pattern=((ATTN, 8, 10_000.0),) * 5
                    + ((ATTN, None, 1_000_000.0),),
                    first_k_dense=2, dtype=torch.float32, q_chunk=8)
