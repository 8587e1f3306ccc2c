"""MSFP: Mixup-Sign Floating-Point quantization (paper §4.1); port of
``repro.core.msfp``.

Builds a ``QuantPlan``: every quantized site (layer weight or layer input
activation) gets searched quantizer parameters. NAL activations and all
weights use signed FP; AAL activations also search unsigned FP with a
zero-point and keep the MSE-minimal candidate (Alg. 1's mixup-sign
selection).

Plan modes (benchmarks/ablations):
  'msfp'        the paper's method (signed everywhere + unsigned for AALs)
  'signed'      signed-FP-only baseline
  'signed_zp'   signed FP with a zero point for AALs (Fig. 4's 3rd strategy)
  'int'         INT-affine baseline (Q-Diffusion-style)

The searches run where ``device`` says (the card by default); the plan's
parameters live there too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.quant.calibrate import AALConfig, CalibrationDB
from repro_torch.quant.fakequant import (KIND_FP_UNSIGNED, KIND_INT_AFFINE,
                                         QuantizerParams, apply_qdq, ste_qdq)
from repro_torch.quant.search import (SearchResult, search_activation_params,
                                      search_int_affine, search_signed_fp,
                                      search_weight_params)

PLAN_MODES = ("msfp", "signed", "signed_zp", "int")


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

    def qp(self, name: str) -> QuantizerParams:
        return self.sites[name].qp

    def act_sites(self) -> list[str]:
        return [n for n, s in self.sites.items() if not s.is_weight]

    def weight_sites(self) -> list[str]:
        return [n for n, s in self.sites.items() if s.is_weight]

    def n_unsigned(self) -> int:
        return sum(1 for s in self.sites.values()
                   if s.qp.kind == KIND_FP_UNSIGNED)

    def to(self, device) -> "QuantPlan":
        return dataclasses.replace(self, sites={
            k: dataclasses.replace(s, qp=s.qp.to(device))
            for k, s in self.sites.items()})

    def summary(self) -> dict[str, Any]:
        return {
            "mode": self.mode, "bits_w": self.bits_w, "bits_a": self.bits_a,
            "sites": len(self.sites),
            "aal_sites": sum(1 for s in self.sites.values() if s.is_aal),
            "unsigned_sites": self.n_unsigned(),
        }


def _search_act(samples, bits: int, mode: str, is_aal: bool,
                device=None) -> SearchResult:
    if mode == "int":
        return search_int_affine(samples, bits, device=device)
    if mode == "signed":
        return search_activation_params(samples, bits, allow_unsigned=False,
                                         device=device)
    if mode == "signed_zp":
        # Fig. 4's strategy: a signed grid shifted by a zero point, as a
        # signed search over zp-shifted data (the reference's emulation)
        best = None
        for zp in np.linspace(-0.3, 0.0, 6):
            r = search_signed_fp(samples - zp, bits, device=device)
            if best is None or r.mse < best[0].mse:
                best = (r, zp)
        r, zp = best
        qp = dataclasses.replace(r.params, zero_point=torch.tensor(
            zp, dtype=torch.float32, device=r.params.maxval.device))
        return SearchResult(qp, r.mse, r.per_format)
    return search_activation_params(samples, bits, allow_unsigned=is_aal,
                                    device=device)


def build_plan(weights: Mapping[str, Any], act_db: CalibrationDB, *,
               bits_w: int = 4, bits_a: int = 4, mode: str = "msfp",
               aal_cfg: AALConfig | None = None,
               skip: Callable[[str], bool] | None = None,
               progress: Callable[[str], None] | None = None,
               device="cuda") -> QuantPlan:
    """Search quantizer parameters for every weight and activation site.

    ``weights`` maps site name -> weight tensor (flattened module tree);
    ``act_db`` holds calibration samples recorded under the same site
    names. ``skip(name)`` exempts sites (``build_mixed_plan`` sends the io
    sites through a second plan at 8 bits).
    """
    if mode not in PLAN_MODES:
        raise ValueError(f"plan mode {mode!r} not in {PLAN_MODES}")
    sites: dict[str, SiteInfo] = {}
    for name, w in weights.items():
        if skip and skip(name):
            continue
        if progress:
            progress(f"weight:{name}")
        if mode == "int":
            r = search_int_affine(w, bits_w, symmetric=True, device=device)
        else:
            r = search_weight_params(w, bits_w, device=device)
        sites[name] = SiteInfo(r.params, True, False, r.mse, r.per_format)
    classes = act_db.classify(aal_cfg)
    for name, stats in act_db.sites.items():
        if skip and skip(name):
            continue
        if progress:
            progress(f"act:{name}")
        is_aal = classes[name]
        r = _search_act(stats.samples, bits_a, mode, is_aal, device)
        sites[name] = SiteInfo(r.params, False, is_aal, r.mse, r.per_format)
    return QuantPlan(sites, bits_w, bits_a, mode)


def build_mixed_plan(weights, act_db, *, bits_w=4, bits_a=4, mode="msfp",
                     io_sites: set[str] = frozenset(), io_bits: int = 8,
                     aal_cfg=None, device="cuda",
                     progress: Callable[[str], None] | None = None
                     ) -> QuantPlan:
    """The paper's configuration: io layers at 8 bits, the rest at target."""
    inner = build_plan(weights, act_db, bits_w=bits_w, bits_a=bits_a,
                       mode=mode, aal_cfg=aal_cfg,
                       skip=lambda n: n in io_sites, progress=progress,
                       device=device)
    if io_sites:
        outer = build_plan(
            {k: v for k, v in weights.items() if k in io_sites}, act_db,
            bits_w=io_bits, bits_a=io_bits, mode=mode, aal_cfg=aal_cfg,
            skip=lambda n: n not in io_sites, progress=progress,
            device=device)
        inner.sites.update(outer.sites)
    return inner


# ---------------------------------------------------------------------------
# Application: fake-quant weights / activations under a plan.
# ---------------------------------------------------------------------------


def quantize_act(name: str, x: torch.Tensor, plan: QuantPlan) -> torch.Tensor:
    """Activation fake-quant with STE gradients; identity if unplanned."""
    if plan is None or name not in plan.sites:
        return x
    return ste_qdq(x, plan.sites[name].qp)


def quantize_weight_tree(weights: Mapping[str, Any], plan: QuantPlan) -> dict:
    """Fake-quantize every planned weight (the frozen quantized base of the
    QLoRA fine-tune). The reference runs this eagerly, so the scale is the
    true division ``maxval / base_max`` (the eager form)."""
    out = {}
    for name, w in weights.items():
        if name in plan.sites and plan.sites[name].is_weight:
            out[name] = apply_qdq(w, plan.sites[name].qp, form="eager")
        else:
            out[name] = w
    return out


def pow2_plan(plan: QuantPlan) -> QuantPlan:
    """The plan on power-of-two grid scales: every FP maxval rounded down
    to ``base_max * 2^k`` and every zero-point to a multiple of 1/16, the
    formats kept. Every weight and act of the fake-quant model is then a
    grid point times a power of two (plus a short zp), so its products and
    sums are exact whatever their order: the card-vs-CPU checks of the
    fine-tune hold their steps on it."""
    sites = {}
    for k, s in plan.sites.items():
        qp = s.qp
        if qp.kind != KIND_INT_AFFINE:
            bm = qp.fmt.base_max
            mv = bm * torch.exp2(torch.floor(torch.log2(
                qp.maxval.double().clamp_min(1e-30) / bm)))
            zp = torch.round(qp.zero_point.double() * 16) / 16
            qp = dataclasses.replace(qp, maxval=mv.float(),
                                     zero_point=zp.float())
        sites[k] = dataclasses.replace(s, qp=qp)
    return QuantPlan(sites, plan.bits_w, plan.bits_a, plan.mode)


def plan_mse_report(plan: QuantPlan) -> dict[str, dict]:
    """Per-site search MSE + chosen format (Fig. 4-style evidence)."""
    return {
        n: dict(format=(s.qp.fmt.name if s.qp.kind != KIND_INT_AFFINE
                        else f"int{s.qp.bits}"),
                kind=s.qp.kind, is_aal=s.is_aal, is_weight=s.is_weight,
                mse=s.mse, maxval=float(s.qp.maxval),
                zp=float(s.qp.zero_point))
        for n, s in plan.sites.items()
    }
