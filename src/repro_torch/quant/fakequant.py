"""Fake quantization (quantize-dequantize); port of ``repro.quant.fakequant``.

``QuantizerParams`` carries a format, a grid maximum and (unsigned only) a
zero-point. ``maxval`` / ``zero_point`` are f32 tensors (0-d per tensor,
or (N,) per channel for weights) so the CUDA kernels can read them through
device pointers without a host round trip.

``fp_qdq`` is also the plain version of the MSFP kernel (K1,
``kernels/msfp_quant.py``): the operation order (``inv`` then ``|x|*inv``,
``sign(x) * q * scale``) is the reference's, so both agree bit for bit.

``grid_scale`` is ``maxval / base_max`` as the reference computes it once
compiled: XLA turns a division by the constant ``base_max`` into a multiply
by its f32 reciprocal (the Pallas kernels write it so outright,
``w4_matmul.py:123``). The port does the same everywhere the reference is
jitted (the act snap, the weight decode), so it matches the served model
bit for bit; the offline pack (``qmodule.encode_codes``) runs eagerly in
the reference and keeps the true division. For the same reason the
unsigned ``q * scale + zp`` is one fused multiply-add (``fma``): compiled
XLA contracts it, and the CUDA kernels call ``__fmaf_rn``.

Hence ``form``, one of ``FORMS``, for ``fp_qdq`` and ``int_qdq``:
* ``"compiled"``: under ``jit`` with the parameters as runtime operands
  (the MSE search's candidate grids, the served act snap): the scale by
  the reciprocal multiply, the unsigned output one ``fma``;
* ``"folded"``: under ``jit`` with the parameters as constants, which XLA
  folds exactly: the reference's fine-tune, whose act STE takes its
  quantizer as a static argument (``custom_vjp``'s ``nondiff_argnums``
  refuses a traced one): the scale a true division, the output ``fma``;
* ``"eager"``: outside ``jit`` (``msfp.quantize_weight_tree``, the
  weights' fake-quant): the true division, no ``fma``.
The forms differ by one rounding of the scale or the output.

``ste_qdq`` is the fine-tune's act fake-quant: the forward is the folded
``apply_qdq`` (for a per-tensor FP quantizer ``kernels.ops.msfp_quantize``
with ``folded=True``, so on the card K1), the backward the reference's
clipped straight-through mask (identity inside ``quantizer_range``, zero
outside).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant.formats import FPFormat, snap_to_base_grid

# Quantizer kinds.
KIND_FP_SIGNED = 0
KIND_FP_UNSIGNED = 1  # unsigned FP + zero-point (the paper's Eq. 8)
KIND_INT_AFFINE = 2  # INT baseline

FORMS = ("compiled", "folded", "eager")


def _f32(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device or v.device)
    return torch.tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class QuantizerParams:
    """Searched quantization parameters for one site (layer weight or act)."""

    kind: int
    exp_bits: int
    man_bits: int
    bits: int
    maxval: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(1.0))
    zero_point: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0.0))

    def __post_init__(self):
        object.__setattr__(self, "maxval", _f32(self.maxval))
        object.__setattr__(self, "zero_point",
                           _f32(self.zero_point, self.maxval.device))

    @property
    def fmt(self) -> FPFormat:
        return FPFormat(self.exp_bits, self.man_bits,
                        self.kind == KIND_FP_SIGNED)

    @property
    def is_unsigned(self) -> bool:
        return self.kind == KIND_FP_UNSIGNED

    def to(self, device) -> "QuantizerParams":
        return dataclasses.replace(self, maxval=self.maxval.to(device),
                                   zero_point=self.zero_point.to(device))


def grid_scale(maxval: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """``maxval / base_max`` as compiled XLA computes it (see above)."""
    return maxval * (1.0 / fmt.base_max)


def true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded once on every device: PyTorch's CUDA kernels take a
    division by a Python scalar as a multiply by its reciprocal, a
    division by a tensor as a division."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as compiled XLA and ``__fmaf_rn``
    give it: the product of two f32 values is exact in f64, and the f64 sum
    rounds to f32 as the fused operation does (short of a double rounding
    at an exact f32 midpoint, which the grid operands here never reach)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def fp_qdq(x: torch.Tensor, fmt: FPFormat, maxval, zero_point=0.0, *,
           form: str = "compiled") -> torch.Tensor:
    """Quantize-dequantize onto the scaled ExMy grid.

    Signed:   sign(x) * snap(|x| / s) * s, clipped to [-maxval, maxval].
    Unsigned: snap(max((x - z) / s, 0)) * s + z (Eq. 8).
    ``s = grid_scale(maxval)`` (the compiled form) or ``maxval /
    base_max``; the division by ``s`` is taken as ``* inv`` with
    ``inv = 1 / max(s, 1e-30)`` (0 when s <= 0), as the reference does.
    ``maxval`` and ``zero_point`` broadcast against ``x``: a (C, 1)
    maxval and a (1, S) x give C candidates' qdq of the same samples.
    """
    dtype = x.dtype
    x = x.to(torch.float32)
    maxval = _f32(maxval, x.device)
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    scale = (grid_scale(maxval, fmt) if form == "compiled"
             else true_div(maxval, fmt.base_max))
    inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, 1e-30),
                      torch.zeros_like(scale))
    if fmt.signed:
        y = torch.abs(x) * inv
        out = torch.sign(x) * (snap_to_base_grid(y, fmt) * scale)
    else:
        z = _f32(zero_point, x.device)
        y = (x - z) * inv
        y = torch.where(y < 0, torch.zeros_like(y), y)   # NaN passes
        q = snap_to_base_grid(y, fmt)
        out = q * scale + z if form == "eager" else fma(q, scale, z)
    return out.to(dtype)


def int_qdq(x: torch.Tensor, bits: int, maxval, zero_point=0.0,
            symmetric: bool = True, *, form: str = "eager") -> torch.Tensor:
    """Affine INT quantize-dequantize (Q-Diffusion-style baseline, Eq. 5).
    The compiled form takes the scale's division by ``qmax`` as a multiply
    by its f32 reciprocal; the compiled and folded forms take the affine
    ``q * s + z`` as one ``fma`` (see ``FORMS``)."""
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    dtype = x.dtype
    x = x.to(torch.float32)
    maxval = _f32(maxval, x.device)
    if symmetric:
        qmax = 2 ** (bits - 1) - 1
        s = torch.clamp_min(maxval, 1e-30)
        s = s * (1.0 / qmax) if form == "compiled" else true_div(s, qmax)
        q = torch.clamp(torch.round(x / s), -qmax - 1, qmax)
        out = q * s
    else:
        qmax = 2**bits - 1
        z = _f32(zero_point, x.device)
        s = torch.clamp_min(maxval - z, 1e-30)
        s = s * (1.0 / qmax) if form == "compiled" else true_div(s, qmax)
        q = torch.clamp(torch.round((x - z) / s), 0, qmax)
        out = q * s + z if form == "eager" else fma(q, s, z)
    return out.to(dtype)


def apply_qdq(x: torch.Tensor, qp: QuantizerParams, *,
              form: str | None = None) -> torch.Tensor:
    """Dispatch on quantizer kind. ``form=None`` keeps each kind's default:
    compiled for FP (the served act snap), eager for INT."""
    if qp.kind == KIND_INT_AFFINE:
        return int_qdq(x, qp.bits, qp.maxval, qp.zero_point, symmetric=False,
                       form=form or "eager")
    return fp_qdq(x, qp.fmt, qp.maxval, qp.zero_point,
                  form=form or "compiled")


class _SteQdq(torch.autograd.Function):
    """Clipped straight-through estimator over the act fake-quant."""

    @staticmethod
    def forward(ctx, x, qp):
        lo, hi = quantizer_range(qp)
        ctx.save_for_backward((x >= lo) & (x <= hi))
        if qp.kind != KIND_INT_AFFINE and qp.maxval.numel() == 1:
            # ops (under nn.partition) imports this module
            from repro_torch.nn import partition
            return partition.msfp_quantize(x, qp, folded=True)
        return apply_qdq(x, qp, form="folded")

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None


def ste_qdq(x: torch.Tensor, qp: QuantizerParams) -> torch.Tensor:
    """Act fake-quant in the folded form with the clipped-STE gradient
    (the reference's ``ste_qdq`` under ``jit``): identity gradient inside
    ``quantizer_range``, zero outside."""
    return _SteQdq.apply(x, qp)


def quantizer_range(qp: QuantizerParams):
    """(lo, hi) of representable values (INT-affine as signed, as the
    reference's STE takes it)."""
    if qp.is_unsigned:
        return qp.zero_point, qp.maxval + qp.zero_point
    return -qp.maxval, qp.maxval
