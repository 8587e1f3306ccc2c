"""Architecture registry: --arch <id> -> LMConfig (full or smoke); port of
``repro.configs.registry``."""
from __future__ import annotations

from repro_torch.configs import (gemma3_27b, gemma3_4b, kimi_k2_1t,
                                 llama4_scout, llava_next_mistral_7b,
                                 mamba2_370m, musicgen_large, qwen15_05b,
                                 smollm_135m, zamba2_27b)
from repro_torch.configs.shapes import LONG_OK, SHAPES, cells

ARCHS = {
    "mamba2-370m": mamba2_370m,
    "qwen1.5-0.5b": qwen15_05b,
    "gemma3-27b": gemma3_27b,
    "gemma3-4b": gemma3_4b,
    "smollm-135m": smollm_135m,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "llama4-scout-17b-a16e": llama4_scout,
    "musicgen-large": musicgen_large,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "zamba2-2.7b": zamba2_27b,
}

ARCH_IDS = list(ARCHS)


def _validate() -> None:
    """Fail at import on a malformed registry (duplicate names, missing
    config builders, shape references to unknown archs): the gateway's
    model registry and the cell matrix both trust these entries, so a bad
    one must not survive to first use."""
    seen: dict[str, str] = {}
    for arch, mod in ARCHS.items():
        for attr in ("full", "smoke"):
            if not callable(getattr(mod, attr, None)):
                raise ImportError(f"configs registry: {arch!r} module "
                                  f"{mod.__name__} lacks a callable "
                                  f"{attr}()")
        name = mod.full().name
        if name in seen:
            raise ImportError(f"configs registry: duplicate config name "
                              f"{name!r} ({seen[name]} vs {arch})")
        seen[name] = arch
    unknown = set(LONG_OK) - set(ARCHS)
    if unknown:
        raise ImportError(f"configs registry: LONG_OK references unknown "
                          f"archs {sorted(unknown)}")
    if not SHAPES:
        raise ImportError("configs registry: SHAPES is empty")


_validate()


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.smoke() if smoke else mod.full()


def list_models() -> list[str]:
    """Registered arch ids, sorted: the gateway registry and the
    ``--models`` flag help text both enumerate from here."""
    return sorted(ARCHS)


def all_cells():
    return cells(ARCH_IDS)
