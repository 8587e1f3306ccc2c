"""gemma3-4b [dense] — 5:1 local:global, 128k context.
Port of ``repro.configs.gemma3_4b``.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, GeGLU,
head_dim=256. 34 = 4 leading local layers + 5 scanned groups of 6.
"""
import torch

from repro_torch.models.lm import LMConfig, ATTN

_PAT = ((ATTN, 1024, 10_000.0),) * 5 + ((ATTN, None, 1_000_000.0),)


def full() -> LMConfig:
    return LMConfig("gemma3-4b", n_layers=34, d_model=2560, n_heads=8,
                    n_kv=4, d_ff=10240, vocab=262144, mlp_kind="geglu",
                    head_dim=256, scale_embed=True, layer_pattern=_PAT,
                    first_k_dense=4)


def smoke() -> LMConfig:
    return LMConfig("gemma3-4b-smoke", n_layers=10, d_model=64, n_heads=4,
                    n_kv=2, d_ff=128, vocab=128, mlp_kind="geglu",
                    head_dim=16, scale_embed=True,
                    layer_pattern=((ATTN, 8, 10_000.0),) * 5
                    + ((ATTN, None, 1_000_000.0),),
                    first_k_dense=4, dtype=torch.float32, q_chunk=8)
