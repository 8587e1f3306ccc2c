"""Quant context threaded through model forwards; port of the serving part
of ``repro.quant.calibrate`` (the ``off`` and ``serve`` modes).

mode='off'   : identity at every quant site (full-precision run).
mode='serve' : activation quant happens inside the fused W4A4 kernels —
               ``act`` is identity, and packed layers fetch their per-site
               ``QuantizerParams`` via ``serving_qp``. ``act_qps`` maps
               site -> params; the key ``"*"`` is the fallback.
The calibration modes (``collect``/``quantize``, ``CalibrationDB``, the
AAL classifier) belong to the paper-pipeline slice.
"""
from __future__ import annotations

MODES = ("off", "serve")


class QuantContext:
    def __init__(self, mode: str = "off", act_qps: dict | None = None):
        if mode not in MODES:
            raise NotImplementedError(
                f"QuantContext mode {mode!r}: only {MODES} are ported; "
                "collect/quantize come with the paper pipeline "
                "(ROADMAP Queue A item 10)")
        self.mode = mode
        self.act_qps = act_qps or {}

    def act(self, name: str, x):
        return x

    def serving_qp(self, name: str | None):
        """Per-site activation quantizer for the fused serving kernel."""
        if self.mode != "serve":
            return None
        return resolve_act_qp(self.act_qps, name)


def resolve_act_qp(act_qps, name: str | None):
    """Site lookup in an ``act_qps`` mapping; ``"*"`` is the wildcard."""
    if not act_qps:
        return None
    if name is None:
        return act_qps.get("*")
    return act_qps.get(name, act_qps.get("*"))


OFF = QuantContext("off")
