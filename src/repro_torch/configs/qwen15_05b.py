"""qwen1.5-0.5b [dense] — QKV bias (hf:Qwen/Qwen1.5-0.5B).
Port of ``repro.configs.qwen15_05b``.

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936, tied embeddings.
"""
import torch

from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig("qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16,
                    n_kv=16, d_ff=2816, vocab=151936, qkv_bias=True,
                    tie_embeddings=True, head_dim=64)


def smoke() -> LMConfig:
    return LMConfig("qwen1.5-0.5b-smoke", n_layers=3, d_model=64, n_heads=4,
                    n_kv=4, d_ff=128, vocab=128, qkv_bias=True,
                    tie_embeddings=True, head_dim=16, dtype=torch.float32,
                    q_chunk=8)
