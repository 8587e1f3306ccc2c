"""Model registry for the multi-model serving gateway; port of
``repro.serving.gateway.registry``.

A ``ModelEntry`` is the curated record the gateway needs to host one
quantized model: its routing name, family (``diffusion`` | ``lm``), the
config reference it is built from, the quant recipe its weight bank
packs with, the bank's LRU capacity, and the default SLO its traffic is
judged against. The registry is deliberately *data only* — engines are
constructed by builders the launcher supplies (``launch/serve_gateway``),
so this layer never imports model/launch code.

``default_entries()`` ships the two-model development pair every smoke /
bench run uses: the tiny diffusion preset plus the smollm smoke LM. LM
entries must name an arch the port runs (``configs.registry.list_models``;
an arch of the reference's registry not ported yet raises
``NotImplementedError`` naming ROADMAP Queue A item 12b); diffusion
entries name a ``DIFFUSION_PRESETS`` key.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.diffusion_presets import DIFFUSION_PRESETS
from repro_torch.configs.registry import (PENDING_ARCHS, list_models,
                                          require_ported)
from repro_torch.serving.traffic.metrics import SLO

FAMILIES = ("diffusion", "lm")


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One hostable model: routing name + everything a builder needs."""

    name: str                      # routing key (trace ``model`` field)
    family: str                    # "diffusion" | "lm"
    config: str                    # DIFFUSION_PRESETS key or configs arch id
    quant: str = "absmax-w4"       # bank packing recipe (builder-resolved)
    bank_cap: int = 4              # LRU cap on cached segment weight-sets
    slo: SLO = SLO()               # default verdict thresholds
    max_batch: int = 4             # in-flight slots for this model's engine
    smoke: bool = True             # lm only: smoke() vs full() config

    def validate(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"model entry needs a non-empty name, "
                             f"got {self.name!r}")
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: family {self.family!r} "
                             f"not in {FAMILIES}")
        if self.family == "diffusion":
            if self.config not in DIFFUSION_PRESETS:
                raise ValueError(
                    f"{self.name}: unknown diffusion preset "
                    f"{self.config!r} (known: {sorted(DIFFUSION_PRESETS)})")
        elif self.config in PENDING_ARCHS:
            require_ported(self.config)        # NotImplementedError
        elif self.config not in list_models():
            raise ValueError(f"{self.name}: unknown LM arch "
                             f"{self.config!r} (known: {list_models()})")
        if self.bank_cap < 1 or self.max_batch < 1:
            raise ValueError(f"{self.name}: bank_cap/max_batch must be "
                             ">= 1")


class ModelRegistry:
    """Name -> ModelEntry with validation; the gateway resolves against
    one of these, the launcher populates it from ``--models``."""

    def __init__(self, entries: list[ModelEntry] | None = None):
        self._entries: dict[str, ModelEntry] = {}
        for e in entries or []:
            self.register(e)

    def register(self, entry: ModelEntry) -> ModelEntry:
        entry.validate()
        if entry.name in self._entries:
            raise ValueError(f"model {entry.name!r} already registered")
        self._entries[entry.name] = entry
        return entry

    def resolve(self, name: str) -> ModelEntry:
        if name not in self._entries:
            raise KeyError(f"unknown model {name!r} "
                           f"(registered: {self.list()})")
        return self._entries[name]

    def list(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)


def default_entries() -> list[ModelEntry]:
    """The curated development pair: one tiny diffusion model + one smoke
    LM — the models the ``mixed_model`` / ``per_model_slo`` scenarios
    name and the gateway smoke runs register."""
    return [
        ModelEntry(name="tiny-ddim", family="diffusion", config="tiny-ddim",
                   quant="absmax-w4", bank_cap=4, max_batch=4,
                   slo=SLO(p95_s=120.0)),
        ModelEntry(name="smollm-135m", family="lm", config="smollm-135m",
                   quant="absmax-w4", bank_cap=1, max_batch=4, smoke=True,
                   slo=SLO(p95_s=120.0)),
    ]


def default_registry() -> ModelRegistry:
    return ModelRegistry(default_entries())
