"""Architecture registry: --arch <id> -> LMConfig (full or smoke); port of
``repro.configs.registry`` holding only the archs the port runs. The
reference's other archs are known here by name (``PENDING_ARCHS``): asking
for one raises ``NotImplementedError`` naming ROADMAP Queue A item 12b,
which ports their configs, never an "unknown arch" error."""
from __future__ import annotations

from repro_torch.configs import smollm_135m

ARCHS = {"smollm-135m": smollm_135m}

ARCH_IDS = list(ARCHS)

# the reference registry's archs whose configs (and families: moe, ssm,
# hybrid, vlm, audio) the port does not run yet
PENDING_ARCHS = ("mamba2-370m", "qwen1.5-0.5b", "gemma3-27b", "gemma3-4b",
                 "kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "musicgen-large",
                 "llava-next-mistral-7b", "zamba2-2.7b")


def require_ported(arch: str) -> None:
    """Raise unless the port runs ``arch``: ``NotImplementedError`` for an
    arch of the reference's registry not ported yet, ``KeyError`` for a
    name neither registry knows."""
    if arch in ARCHS:
        return
    if arch in PENDING_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (the port runs {ARCH_IDS}; the "
            "reference's other LM configs are ROADMAP Queue A item 12b)")
    raise KeyError(f"unknown arch {arch!r} (known: "
                   f"{sorted(ARCH_IDS + list(PENDING_ARCHS))})")


def get_config(arch: str, smoke: bool = False):
    require_ported(arch)
    mod = ARCHS[arch]
    return mod.smoke() if smoke else mod.full()


def list_models() -> list[str]:
    """The archs the port runs, sorted (``PENDING_ARCHS`` holds the rest
    of the reference's)."""
    return sorted(ARCHS)
