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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant.formats import FPFormat, snap_to_base_grid

# Quantizer kinds.
KIND_FP_SIGNED = 0
KIND_FP_UNSIGNED = 1  # unsigned FP + zero-point (the paper's Eq. 8)
KIND_INT_AFFINE = 2  # INT baseline


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


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as compiled XLA and ``__fmaf_rn``
    give it: the product of two f32 values is exact in f64, and the f64 sum
    rounds to f32 as the fused operation does (short of a double rounding
    at an exact f32 midpoint, which the grid operands here never reach)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def fp_qdq(x: torch.Tensor, fmt: FPFormat, maxval, zero_point=0.0
           ) -> torch.Tensor:
    """Quantize-dequantize onto the scaled ExMy grid.

    Signed:   sign(x) * snap(|x| / s) * s, clipped to [-maxval, maxval].
    Unsigned: snap(max((x - z) / s, 0)) * s + z (Eq. 8).
    ``s = grid_scale(maxval)``; the division by ``s`` is taken as
    ``* inv`` with ``inv = 1 / max(s, 1e-30)`` (0 when s <= 0), as the
    reference does.
    """
    dtype = x.dtype
    x = x.to(torch.float32)
    maxval = _f32(maxval, x.device)
    scale = grid_scale(maxval, fmt)
    inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, 1e-30),
                      torch.zeros_like(scale))
    if fmt.signed:
        y = torch.abs(x) * inv
        out = torch.sign(x) * (snap_to_base_grid(y, fmt) * scale)
    else:
        z = _f32(zero_point, x.device)
        y = (x - z) * inv
        y = torch.where(y < 0, torch.zeros_like(y), y)   # NaN passes
        out = fma(snap_to_base_grid(y, fmt), scale, z)
    return out.to(dtype)


def int_qdq(x: torch.Tensor, bits: int, maxval, zero_point=0.0,
            symmetric: bool = True) -> torch.Tensor:
    """Affine INT quantize-dequantize (Q-Diffusion-style baseline, Eq. 5)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    maxval = _f32(maxval, x.device)
    if symmetric:
        qmax = 2 ** (bits - 1) - 1
        s = torch.clamp_min(maxval, 1e-30) / qmax
        q = torch.clamp(torch.round(x / s), -qmax - 1, qmax)
        out = q * s
    else:
        qmax = 2**bits - 1
        z = _f32(zero_point, x.device)
        s = torch.clamp_min(maxval - z, 1e-30) / qmax
        q = torch.clamp(torch.round((x - z) / s), 0, qmax)
        out = q * s + z
    return out.to(dtype)


def apply_qdq(x: torch.Tensor, qp: QuantizerParams) -> torch.Tensor:
    """Dispatch on quantizer kind."""
    if qp.kind == KIND_INT_AFFINE:
        return int_qdq(x, qp.bits, qp.maxval, qp.zero_point, symmetric=False)
    return fp_qdq(x, qp.fmt, qp.maxval, qp.zero_point)


def quantizer_range(qp: QuantizerParams):
    """(lo, hi) of representable values."""
    if qp.is_unsigned:
        return qp.zero_point, qp.maxval + qp.zero_point
    return -qp.maxval, qp.maxval
