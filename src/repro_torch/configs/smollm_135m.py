"""smollm-135m [dense]: llama-arch small (hf:HuggingFaceTB/SmolLM-135M);
port of ``repro.configs.smollm_135m``.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings, bf16.
"""
import torch

from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig("smollm-135m", n_layers=30, d_model=576, n_heads=9,
                    n_kv=3, d_ff=1536, vocab=49152, tie_embeddings=True,
                    head_dim=64)


def smoke() -> LMConfig:
    return LMConfig("smollm-135m-smoke", n_layers=3, d_model=48, n_heads=3,
                    n_kv=1, d_ff=96, vocab=128, tie_embeddings=True,
                    head_dim=16, dtype=torch.float32, q_chunk=8)
