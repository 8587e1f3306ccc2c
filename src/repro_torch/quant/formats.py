"""Floating-point quantization formats (ExMy grids), signed and unsigned.

Port of ``repro.quant.formats``: the same base grid (smallest normal octave
``[1, 2)``, subnormals step ``2^-M``), the same code layout and the same
format registry. See that module for the derivation.

The snap takes the octave from the float's exponent bits and builds the
step from bits too, where the reference computes ``floor(log2(y))`` and
``exp2``: both are exact here, so the CUDA kernels (which do the same in
``kernels/csrc/msfp.cuh``) and this plain version agree bit for bit on
every device. At an octave boundary the two octave choices snap to the
same grid point, so the reference's ``log2`` rounding does not change the
result either.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, order=True)
class FPFormat:
    """An ExMy floating-point format, signed or unsigned."""

    exp_bits: int
    man_bits: int
    signed: bool

    @property
    def bits(self) -> int:
        return self.exp_bits + self.man_bits + (1 if self.signed else 0)

    @property
    def base_max(self) -> float:
        if self.exp_bits == 0:
            return (2**self.man_bits - 1) / 2**self.man_bits
        return float(2 ** (2**self.exp_bits - 2) * (2.0 - 2.0**-self.man_bits))

    @property
    def name(self) -> str:
        return f"{'s' if self.signed else 'u'}E{self.exp_bits}M{self.man_bits}"


def signed_formats(bits: int) -> tuple[FPFormat, ...]:
    """The paper's signed search space for a bit-width (Table 6 / App. B)."""
    if bits == 4:
        ems = [(3, 0), (2, 1), (1, 2), (0, 3)]
    elif bits == 6:
        ems = [(4, 1), (3, 2), (2, 3), (1, 4)]
    elif bits == 8:
        ems = [(5, 2), (4, 3), (3, 4), (2, 5)]
    else:  # generic: every split with e+m = bits-1
        ems = [(e, bits - 1 - e) for e in range(bits - 1, -1, -1)]
    return tuple(FPFormat(e, m, True) for e, m in ems)


def unsigned_formats(bits: int) -> tuple[FPFormat, ...]:
    """All ExMy splits with x + y = bits, exponent bits capped at 5."""
    return tuple(
        FPFormat(e, bits - e, False) for e in range(min(bits, 5), -1, -1)
    )


def enumerate_grid(fmt: FPFormat) -> np.ndarray:
    """Every representable base-grid value, sorted ascending (test oracle)."""
    vals = set()
    m_range = range(2**fmt.man_bits)
    if fmt.exp_bits == 0:
        for m in m_range:
            vals.add(m / 2**fmt.man_bits)
    else:
        for p in range(2**fmt.exp_bits):
            for m in m_range:
                if p == 0:
                    vals.add(m / 2**fmt.man_bits)
                else:
                    vals.add(2.0 ** (p - 1) * (1 + m / 2**fmt.man_bits))
    out = sorted(vals)
    if fmt.signed:
        out = sorted({-v for v in out} | set(out))
    return np.asarray(out, dtype=np.float64)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0 ** e`` (f32) for integer tensors ``e`` in [-126, 127],
    built from the exponent field."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def octave(y: torch.Tensor, exp_bits: int) -> torch.Tensor:
    """``clip(floor(log2(y)), 0, 2^e - 2)`` for f32 ``y >= 0``, from the
    exponent bits (zero and subnormals land in octave 0, inf in the top)."""
    e = ((y.view(torch.int32) >> 23) & 0xFF) - 127
    return e.clamp(0, 2**exp_bits - 2)


def snap_to_base_grid(y: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Round f32 |y| (y >= 0) to the nearest base-grid point (half to
    even), clamped to base_max. NaN stays NaN."""
    if fmt.exp_bits == 0:
        step = 2.0**-fmt.man_bits
    else:
        step = pow2(octave(y, fmt.exp_bits) - fmt.man_bits)
    q = torch.round(y / step) * step
    return torch.where(q > fmt.base_max, torch.full_like(q, fmt.base_max), q)


def quant_codes(fmt: FPFormat) -> np.ndarray:
    """Map 4-bit (or n-bit) integer codes -> base-grid values.

    Code layout (unsigned part): p = code >> man_bits, m = code & (2^man-1).
    Signed formats put the sign in the top bit.
    """
    n_mag = 2 ** (fmt.exp_bits + fmt.man_bits)
    mags = np.zeros(n_mag)
    for c in range(n_mag):
        p, m = c >> fmt.man_bits, c & (2**fmt.man_bits - 1)
        if fmt.exp_bits == 0 or p == 0:
            mags[c] = m / 2**fmt.man_bits
        else:
            mags[c] = 2.0 ** (p - 1) * (1 + m / 2**fmt.man_bits)
    if not fmt.signed:
        return mags
    return np.concatenate([mags, -mags])  # sign bit = MSB


def encode_to_codes(x: np.ndarray, fmt: FPFormat, maxval: float
                    ) -> np.ndarray:
    """Encode values to integer codes by nearest value (numpy, offline)."""
    lut = quant_codes(fmt) * (maxval / fmt.base_max)
    d = np.abs(x[..., None] - lut[None, :])
    return np.argmin(d, axis=-1).astype(np.uint8)


FORMAT_BY_NAME: dict[str, FPFormat] = {}
for _b in (3, 4, 5, 6, 8):
    for _f in signed_formats(_b) + unsigned_formats(_b):
        FORMAT_BY_NAME[_f.name] = _f


def format_list_names(fmts: Sequence[FPFormat]) -> list[str]:
    return [f.name for f in fmts]
