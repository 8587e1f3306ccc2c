"""Assigned input-shape set for the LM-family architectures; port of
``repro.configs.shapes``.

train_4k    -> train_step (next-token XE + Adam) on (batch, seq)
prefill_32k -> serve prefill: full-sequence forward producing logits
decode_32k  -> serve_step: one new token against a seq_len KV cache
long_500k   -> serve_step at 524288 context — sub-quadratic archs only
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k runs only for archs with sub-quadratic context cost (SSM /
# hybrid / mostly-sliding-window). Pure full-attention archs skip it —
# noted in DESIGN.md §Model-structure decisions.
LONG_OK = {"mamba2-370m", "zamba2-2.7b", "gemma3-4b", "gemma3-27b"}


def cells(arch_ids):
    """Every (arch, shape) dry-run cell."""
    out = []
    for a in arch_ids:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_OK:
                continue
            out.append((a, s))
    return out
