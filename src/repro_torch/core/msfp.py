"""The MSFP plan's data types; port of the dataclasses of ``repro.core.msfp``.

``build_plan`` / ``build_mixed_plan`` (the calibrate + MSE-search pipeline)
belong to the paper-pipeline slice; the serving path only needs the plan's
shape.
"""
from __future__ import annotations

import dataclasses

from repro_torch.quant.fakequant import QuantizerParams


@dataclasses.dataclass
class SiteInfo:
    qp: QuantizerParams
    is_weight: bool
    is_aal: bool
    mse: float
    diagnostics: dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class QuantPlan:
    """Static quantization plan: site name -> searched quantizer params."""

    sites: dict[str, SiteInfo]
    bits_w: int
    bits_a: int
    mode: str
