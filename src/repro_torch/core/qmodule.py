"""W4 packed-weight representation; port of ``repro.core.qmodule``.

Each quantized weight is stored as 4-bit codes packed two per uint8 in the
split-half layout (low nibble column j, high nibble column j + N/2) plus a
scalar or per-output-channel scale (the grid maxval) and zero-point. The
packed bytes are byte-identical to the JAX package's.

Code layout (matches ``formats.quant_codes``):
  [sign | exponent p | mantissa m]   (sign bit only for signed formats)
  p = 0 -> subnormal m/2^M ; p >= 1 -> 2^(p-1) * (1 + m/2^M)
"""
from __future__ import annotations

import dataclasses
from math import prod

import torch

from repro_torch.quant.fakequant import (QuantizerParams, _f32, fma,
                                         grid_scale, true_div)
from repro_torch.quant.formats import (FPFormat, octave, pow2,
                                       snap_to_base_grid)


@dataclasses.dataclass
class PackedW4:
    """A weight quantized to a 4-bit FP format and packed 2 codes/byte."""

    packed: torch.Tensor          # uint8, (K, N/2) (or stacked (..., N/2))
    scale: torch.Tensor           # f32 scalar or (N,)
    zero_point: torch.Tensor      # f32, same shape as scale
    exp_bits: int
    man_bits: int
    signed: bool
    shape: tuple                  # original weight shape (HWIO for convs)

    @property
    def fmt(self) -> FPFormat:
        return FPFormat(self.exp_bits, self.man_bits, self.signed)

    def to(self, device) -> "PackedW4":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scale=self.scale.to(device),
                                   zero_point=self.zero_point.to(device))


def encode_codes(w: torch.Tensor, fmt: FPFormat, maxval, zero_point=0.0
                 ) -> torch.Tensor:
    """Arithmetic nearest-code encode (uint8 codes). Runs eagerly in the
    reference, so ``maxval / base_max`` is a true division here."""
    w = w.to(torch.float32)
    scale = true_div(_f32(maxval, w.device), fmt.base_max)
    inv = 1.0 / torch.clamp_min(scale, 1e-30)
    if fmt.signed:
        y = torch.abs(w) * inv
        sign = (w < 0).to(torch.int32)
    else:
        y = (w - _f32(zero_point, w.device)) * inv
        y = torch.where(y < 0, torch.zeros_like(y), y)
    code = grid_codes(snap_to_base_grid(y, fmt), fmt)
    if fmt.signed:
        code = code | (sign << (fmt.exp_bits + fmt.man_bits))
    return code.to(torch.uint8)


def grid_codes(v: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Base-grid points ``v >= 0`` -> unsigned int32 codes: ``v`` lies on
    the grid, so (p, m) come back exactly."""
    man = fmt.man_bits
    if fmt.exp_bits == 0:
        return torch.round(v * 2**man).to(torch.int32)
    oct_ = octave(v, fmt.exp_bits)
    is_sub = v < 1.0
    p = torch.where(is_sub, torch.zeros_like(oct_), oct_ + 1)
    m_sub = torch.round(v * 2**man)
    m_norm = torch.round((v / pow2(oct_) - 1.0) * 2**man)
    m = torch.where(is_sub, m_sub, m_norm).to(torch.int32)
    return (p << man) | m


def decode_magnitudes(code: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Unsigned part of a code -> base-grid magnitude (f32)."""
    man = fmt.man_bits
    if fmt.exp_bits == 0:
        return code.to(torch.float32) / 2**man
    p = code >> man
    m = (code & (2**man - 1)).to(torch.float32)
    return torch.where(p == 0, m / 2**man,
                       pow2((p - 1).clamp_min(0)) * (1 + m / 2**man))


def decode_codes(code: torch.Tensor, fmt: FPFormat, scale, zero_point=0.0,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Arithmetic code -> value decode: ``mag * grid_scale(scale)``,
    negated by the sign bit, or ``fma(mag, grid_scale(scale), zero_point)``
    for unsigned formats."""
    nbits = fmt.exp_bits + fmt.man_bits
    # every code's magnitude, decoded once, then gathered (the same
    # arithmetic per code as decoding each element: ten times faster on
    # the CPU); the sign bit sits above the magnitude's bits, so a signed
    # table lists the magnitudes and then their negations
    table = decode_magnitudes(torch.arange(1 << nbits, dtype=torch.int32,
                                           device=code.device), fmt)
    if fmt.signed:
        table = torch.cat([table, -table])
    mag = table[code.to(torch.int64)]
    sc = grid_scale(_f32(scale, code.device), fmt)
    if fmt.signed:      # (-m) * s is -(m * s) bit for bit
        val = mag * sc
    else:
        val = fma(mag, sc, _f32(zero_point, code.device))
    return val.to(dtype)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(..., K) uint8 codes < 16 -> (..., K/2), split-half layout:
    packed[..., j] = codes[..., j] | codes[..., j + K/2] << 4."""
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_nibbles needs an even last dim, got "
                         f"{tuple(codes.shape)}")
    half = codes.shape[-1] // 2
    return (codes[..., :half] | (codes[..., half:] << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    return torch.cat([packed & 0xF, (packed >> 4) & 0xF], dim=-1)


def pack_weight(w: torch.Tensor, qp: QuantizerParams) -> PackedW4:
    """Quantize + pack one weight under its searched parameters.

    ``qp.maxval`` is a scalar (per-tensor) or an (out,) vector (per output
    channel). 4D HWIO conv weights pack as their (kh*kw*cin, cout)
    flattening while ``shape`` keeps the HWIO tuple.
    """
    fmt = qp.fmt
    if fmt.bits != 4:
        raise ValueError(f"packing is 4-bit only, got {fmt.bits}")
    orig_shape = tuple(w.shape)
    if w.ndim == 4 and qp.maxval.ndim <= 1:
        w = w.reshape(-1, orig_shape[-1])
    scale = qp.maxval.to(w.device)
    if scale.ndim == 1 and not (w.ndim == 2 and scale.shape[0] == w.shape[-1]):
        raise ValueError(f"per-channel scale {tuple(scale.shape)} vs weight "
                         f"{orig_shape}")
    codes = encode_codes(w, fmt, scale, qp.zero_point.to(w.device))
    zp = torch.broadcast_to(qp.zero_point.to(w.device), scale.shape).clone()
    return PackedW4(pack_nibbles(codes), scale.clone(), zp,
                    fmt.exp_bits, fmt.man_bits, fmt.signed, orig_shape)


def dequant_weight(pw: PackedW4, dtype=torch.bfloat16) -> torch.Tensor:
    codes = unpack_nibbles(pw.packed)
    out = decode_codes(codes, pw.fmt, pw.scale, pw.zero_point, dtype)
    if out.ndim == 2 and len(pw.shape) == 4 and out.numel() == prod(pw.shape):
        out = out.reshape(pw.shape)  # flattened HWIO conv pack -> back to 4D
    return out


def quantize_param_tree(params: dict, plan, prefix: str = "") -> dict:
    """Replace planned 4-bit weights with PackedW4 leaves (serving form)."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = quantize_param_tree(v, plan, path + "/")
        elif (path in plan.sites and plan.sites[path].is_weight
              and plan.sites[path].qp.bits == 4 and v.ndim >= 2):
            out[k] = pack_weight(v, plan.sites[path].qp)
        else:
            out[k] = v
    return out
