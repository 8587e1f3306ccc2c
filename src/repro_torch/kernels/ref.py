"""Plain PyTorch oracles for the kernels; port of ``repro.kernels.ref``.

``ops`` routes the branches that no kernel covers (INT-affine acts,
per-channel act maxvals, stacked packs) here, counted through
``ops._dispatch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.qmodule import (PackedW4, decode_codes, dequant_weight,
                                      unpack_nibbles)
from repro_torch.kernels.conv import conv2d_nhwc
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
