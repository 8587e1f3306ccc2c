"""kimi-k2-1t-a32b [moe] — trillion-param MoE (arXiv:2501.kimi2 table).
Port of ``repro.configs.kimi_k2_1t``.

61L d_model=7168 64H (GQA kv=8) vocab=163840, MoE 384 experts top-8 +
1 shared expert, expert d_ff=2048, first layer dense. head_dim=112.
Training this on a v5e pod requires bf16 Adam moments + full remat (see
EXPERIMENTS §Roofline).
"""
import torch

from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig("kimi-k2-1t-a32b", family="moe", n_layers=61,
                    d_model=7168, n_heads=64, n_kv=8, d_ff=0, vocab=163840,
                    head_dim=112, n_experts=384, top_k=8, moe_d_ff=2048,
                    n_shared=1, first_k_dense=1)


def smoke() -> LMConfig:
    return LMConfig("kimi-k2-smoke", family="moe", n_layers=3, d_model=64,
                    n_heads=4, n_kv=2, d_ff=0, vocab=128, head_dim=16,
                    n_experts=8, top_k=2, moe_d_ff=32, n_shared=1,
                    first_k_dense=1, capacity_factor=2.0, dtype=torch.float32,
                    q_chunk=8)
