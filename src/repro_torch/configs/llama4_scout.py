"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert.
Port of ``repro.configs.llama4_scout``.

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048.
(Modality early-fusion is out of scope for the LM backbone cells.)
"""
import torch

from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig("llama4-scout-17b-a16e", family="moe", n_layers=48,
                    d_model=5120, n_heads=40, n_kv=8, d_ff=0, vocab=202048,
                    head_dim=128, n_experts=16, top_k=1, moe_d_ff=8192,
                    n_shared=1)


def smoke() -> LMConfig:
    return LMConfig("llama4-scout-smoke", family="moe", n_layers=2,
                    d_model=64, n_heads=4, n_kv=2, d_ff=0, vocab=128,
                    head_dim=16, n_experts=4, top_k=1, moe_d_ff=32,
                    n_shared=1, capacity_factor=2.0, dtype=torch.float32,
                    q_chunk=8)
