"""Plain PyTorch oracles for the kernels; port of ``repro.kernels.ref``.

``ops`` routes the branches that no kernel covers (INT-affine acts,
per-channel act maxvals, stacked packs) here, counted through
``ops._dispatch``. The kv4 oracles are the reference's eager ones, which
the compiled Pallas kernels (and so K4/K5, ``kernels/kv4.py``) do not
match bit for bit; nothing on the serving path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.core.qmodule import (PackedW4, decode_codes,
                                      decode_magnitudes, dequant_weight,
                                      encode_codes, pack_nibbles,
                                      unpack_nibbles)
from repro_torch.kernels.conv import conv2d_nhwc
from repro_torch.kernels.kv4 import FMT as KV4_FMT
from repro_torch.quant.fakequant import QuantizerParams, apply_qdq


def ref_msfp_qdq(x: torch.Tensor, qp: QuantizerParams) -> torch.Tensor:
    return apply_qdq(x, qp)


def ref_w4_matmul(x: torch.Tensor, pw: PackedW4, dtype=torch.bfloat16
                  ) -> torch.Tensor:
    """Decode then dot, in f32."""
    w = decode_codes(unpack_nibbles(pw.packed), pw.fmt, pw.scale,
                     pw.zero_point, torch.float32)
    return (x.to(torch.float32) @ w).to(dtype)


def ref_w4a4_matmul(x: torch.Tensor, pw: PackedW4, act_qp: QuantizerParams,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return ref_w4_matmul(apply_qdq(x, act_qp), pw, dtype)


def ref_w4a4_conv2d(x: torch.Tensor, pw: PackedW4,
                    act_qp: QuantizerParams | None = None, *,
                    stride=(1, 1), padding="SAME",
                    dtype=torch.bfloat16) -> torch.Tensor:
    """qdq(x) (before the zero padding), decode W to HWIO, f32 conv."""
    if act_qp is not None:
        x = apply_qdq(x, act_qp)
    w = dequant_weight(pw, torch.float32)
    return conv2d_nhwc(x.to(torch.float32), w, stride=stride,
                       padding=padding).to(dtype)


def ref_kv4_encode(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FP4 KV-cache encode: per-row absmax scale, E2M1 codes by
    ``encode_codes`` (true division by ``scale / 6``).
    t: (..., hd) -> packed (..., hd/2) uint8, scale (...,) f16."""
    scale = torch.clamp_min(t.to(torch.float32).abs().amax(-1), 1e-6)
    codes = encode_codes(t, KV4_FMT, scale[..., None])
    return pack_nibbles(codes), scale.to(torch.float16)


def ref_kv4_decode(packed: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """The eager decode: ``mag * (scale / 6)`` with a true division."""
    codes = unpack_nibbles(packed).to(torch.int32)
    sign = (codes >> 3) & 1
    mag = decode_magnitudes(codes & 7, KV4_FMT)
    val = mag * (scale.to(torch.float32)[..., None] / KV4_FMT.base_max)
    return torch.where(sign == 1, -val, val).to(dtype)
