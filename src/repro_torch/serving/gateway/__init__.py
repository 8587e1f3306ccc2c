"""Multi-model serving gateway: registry + router over per-model engines;
port of ``repro.serving.gateway``.

Layer contract: ``serving.gateway`` sits *above* the engine, traffic and
obs sub-layers — it may import any of them, nothing below imports it.
Engine construction stays in the launcher (``launch/serve_gateway``): the
registry is data-only, the gateway hosts whatever engines the builders
hand it.
"""
from repro_torch.serving.gateway.gateway import ServingGateway
from repro_torch.serving.gateway.lm_engine import (DecodeState,
                                                   LMServingEngine)
from repro_torch.serving.gateway.registry import (FAMILIES, ModelEntry,
                                                  ModelRegistry,
                                                  default_entries,
                                                  default_registry)

__all__ = ["ServingGateway", "LMServingEngine", "DecodeState",
           "ModelEntry", "ModelRegistry", "FAMILIES",
           "default_entries", "default_registry"]
