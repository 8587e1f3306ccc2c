"""Calibration and the quant context; port of ``repro.quant.calibrate``.

The paper builds a Q-Diffusion-style calibration set (intermediate x_t
states across timesteps), runs it through the FP model, and records the
input activation of every quantized layer. A layer whose input carries the
SiLU signature (negative tail compressed into about [-0.278, 0)) is an AAL
(anomalous-activation-distribution layer); the rest are NALs.

Models thread a ``QuantContext`` through their forward:

mode='off'      : identity at every quant site (full-precision run).
mode='collect'  : record activation samples into a ``CalibrationDB``.
mode='quantize' : apply the searched fake-quantizers of a ``QuantPlan``
                  (``act_fn``, injected by ``core.msfp`` to avoid a cyclic
                  import: the STE fake-quant of the fine-tune).
mode='serve'    : activation quant happens inside the fused W4A4 kernels;
                  ``act`` is identity, and packed layers fetch their
                  per-site ``QuantizerParams`` via ``serving_qp``.
                  ``act_qps`` maps site -> params; ``"*"`` is the fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

MODES = ("off", "collect", "quantize", "serve")


@dataclasses.dataclass
class SiteStats:
    samples: np.ndarray  # strided subsample of observed values (f32)
    x_min: float
    x_max: float
    n_seen: int

    @property
    def asymmetry(self) -> float:
        """|min| / max: near 0 for SiLU-fed (half-normal-ish) activations."""
        if self.x_max <= 0:
            return float("inf")
        return abs(min(self.x_min, 0.0)) / self.x_max


@dataclasses.dataclass
class AALConfig:
    """AAL classifier: a site is an AAL when its negative tail is both
    shallow (bounded like SiLU's -0.278 * gamma) and small relative to the
    positive range (Fig. 1 (b)/(c))."""

    max_asymmetry: float = 0.30   # |min|/max below this -> asymmetric
    min_floor: float = -0.45      # negative tail shallower than this


class CalibrationDB:
    """Accumulates activation samples per site across calibration batches.

    ``record`` takes the reference's strided subsample of the ravelled
    (NHWC) input; the stride, min and max are taken where the tensor lives
    and only the subsample crosses to the host, one copy a record.
    """

    def __init__(self, sample_cap: int = 1 << 15):
        self.sites: dict[str, SiteStats] = {}
        self.sample_cap = sample_cap

    def record(self, name: str, x) -> None:
        flat = torch.as_tensor(x).detach().reshape(-1).to(torch.float32)
        n = flat.numel()
        stride = max(1, n // self.sample_cap)
        sub = flat[::stride][: self.sample_cap]
        host = torch.cat([torch.stack([flat.min(), flat.max()]), sub]).cpu()
        lo, hi = float(host[0]), float(host[1])
        sub = host[2:].numpy()
        if name in self.sites:
            s = self.sites[name]
            merged = np.concatenate([s.samples, sub])
            if merged.size > self.sample_cap:
                merged = merged[:: max(1, merged.size // self.sample_cap)]
            self.sites[name] = SiteStats(merged, min(s.x_min, lo),
                                         max(s.x_max, hi), s.n_seen + n)
        else:
            self.sites[name] = SiteStats(sub, lo, hi, n)

    def is_aal(self, name: str, cfg: AALConfig | None = None) -> bool:
        cfg = cfg or AALConfig()
        s = self.sites[name]
        return (s.x_min >= cfg.min_floor and s.x_min < 0.0
                and s.asymmetry <= cfg.max_asymmetry)

    def classify(self, cfg: AALConfig | None = None) -> dict[str, bool]:
        return {n: self.is_aal(n, cfg) for n in self.sites}

    def summary(self) -> dict[str, dict]:
        return {
            n: dict(min=s.x_min, max=s.x_max, asym=s.asymmetry, n=s.n_seen)
            for n, s in self.sites.items()
        }


class QuantContext:
    def __init__(self, mode: str = "off", db: CalibrationDB | None = None,
                 plan=None, act_fn: Callable | None = None,
                 act_qps: dict | None = None):
        if mode not in MODES:
            raise ValueError(f"QuantContext mode {mode!r} not in {MODES}")
        if mode == "collect" and db is None:
            raise ValueError("collect mode needs a CalibrationDB")
        if mode == "quantize" and plan is not None and act_fn is None:
            raise ValueError("quantize mode needs the plan's act_fn "
                             "(core.msfp.quantize_act)")
        self.mode = mode
        self.db = db
        self.plan = plan
        self.act_qps = act_qps or {}
        self._act_fn = act_fn

    def act(self, name: str, x):
        if self.mode == "collect":
            self.db.record(name, x)
            return x
        if self.mode == "quantize" and self.plan is not None:
            return self._act_fn(name, x, self.plan)
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
