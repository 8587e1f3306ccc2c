"""mamba2-370m [ssm] — SSD, attention-free (arXiv:2405.21060).
Port of ``repro.configs.mamba2_370m``.

48L d_model=1024, ssm_state=128, vocab=50280, headdim=64 (d_inner=2048 ->
32 SSM heads). No attention => no KV cache; decode carries (state, conv).
"""
import torch

from repro_torch.models.lm import LMConfig, SSM

_PAT = ((SSM, None, 10_000.0),)


def full() -> LMConfig:
    return LMConfig("mamba2-370m", family="ssm", n_layers=48, d_model=1024,
                    n_heads=16, n_kv=16, d_ff=0, vocab=50280,
                    layer_pattern=_PAT, ssm_d_state=128, ssm_headdim=64,
                    ssm_chunk=256, tie_embeddings=True)


def smoke() -> LMConfig:
    return LMConfig("mamba2-370m-smoke", family="ssm", n_layers=4, d_model=64,
                    n_heads=4, n_kv=4, d_ff=0, vocab=128, layer_pattern=_PAT,
                    ssm_d_state=16, ssm_headdim=16, ssm_chunk=8,
                    tie_embeddings=True, dtype=torch.float32)
