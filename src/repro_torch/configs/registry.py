"""Architecture registry: --arch <id> -> LMConfig (full or smoke); port of
``repro.configs.registry`` holding only the archs the port runs (the other
LM configs are ROADMAP Queue A item 12)."""
from __future__ import annotations

from repro_torch.configs import smollm_135m

ARCHS = {"smollm-135m": smollm_135m}

ARCH_IDS = list(ARCHS)


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (the port runs {ARCH_IDS}; the "
            "other LM configs are ROADMAP Queue A item 12)")
    mod = ARCHS[arch]
    return mod.smoke() if smoke else mod.full()


def list_models() -> list[str]:
    return sorted(ARCHS)
