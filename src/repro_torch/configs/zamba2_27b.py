"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention (2411.15242).
Port of ``repro.configs.zamba2_27b``.

54L d_model=2560, ssm_state=64, headdim=64; one shared transformer block
(attn 32H + GeLU MLP d_ff=10240) applied every 6 mamba layers with shared
weights (9 invocations, per-invocation KV cache).
"""
import torch

from repro_torch.models.lm import LMConfig, SSM


def full() -> LMConfig:
    return LMConfig("zamba2-2.7b", family="hybrid", n_layers=54,
                    d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
                    vocab=32000, head_dim=80, mlp_kind="gelu",
                    layer_pattern=((SSM, None, 10_000.0),) * 6,
                    shared_attn_every=6, ssm_d_state=64, ssm_headdim=64,
                    ssm_chunk=256)


def smoke() -> LMConfig:
    return LMConfig("zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
                    n_heads=4, n_kv=4, d_ff=128, vocab=128, head_dim=16,
                    mlp_kind="gelu", layer_pattern=((SSM, None, 10_000.0),) * 2,
                    shared_attn_every=2, ssm_d_state=16, ssm_headdim=16,
                    ssm_chunk=8, dtype=torch.float32, q_chunk=8)
