"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres tiling stub.
Port of ``repro.configs.llava_next_mistral_7b``.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, head_dim=128,
rope theta 1e6. Vision frontend is a stub per the assignment:
input_specs provide 576 precomputed patch embeddings (d_vision=1024)
projected and placed at the sequence head.
"""
import torch

from repro_torch.models.lm import LMConfig, ATTN


def full() -> LMConfig:
    return LMConfig("llava-next-mistral-7b", family="vlm", n_layers=32,
                    d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
                    vocab=32000, head_dim=128,
                    layer_pattern=((ATTN, None, 1_000_000.0),),
                    n_img_tokens=576, d_vision=1024)


def smoke() -> LMConfig:
    return LMConfig("llava-next-smoke", family="vlm", n_layers=2, d_model=64,
                    n_heads=4, n_kv=2, d_ff=128, vocab=128, head_dim=16,
                    layer_pattern=((ATTN, None, 1_000_000.0),),
                    n_img_tokens=8, d_vision=32, dtype=torch.float32, q_chunk=8)
