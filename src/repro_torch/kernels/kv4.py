"""K4/K5: the FP4 (signed E2M1) KV-cache encode and decode.

CUDA kernels ``csrc/kv4.cu`` (replace the TPU kernels
``src/repro/kernels/kv4.py:kv4_encode_2d`` and ``:kv4_decode_2d``) and
their plain PyTorch versions, bit-identical to them and to the
interpret-mode Pallas kernels. Each row (one token's kv-head vector) gets
an absmax scale stored as f16 and hd/2 bytes of split-half nibbles; the
sign is bit 3 of a code. ``kv4_encode_2d`` / ``kv4_decode_2d`` dispatch
on the tensor's device: a CPU tensor takes the plain version, a CUDA
tensor the kernel.

The arithmetic is the compiled Pallas kernel's, which differs from the
reference's ``ref.py`` oracles (ported as ``kernels/ref.py:ref_kv4_*``):
encode scales as ``(|t| * (1 / scale)) * 6`` where the oracle divides by
``scale / 6``, and decode multiplies by ``scale * f32(1/6)`` (XLA's form
of the division by the constant 6).
"""
from __future__ import annotations

import torch

from repro_torch.core.qmodule import (decode_codes, grid_codes, pack_nibbles,
                                      unpack_nibbles)
from repro_torch.kernels import build
from repro_torch.kernels.msfp_quant import DTYPE_CODES, check_input
from repro_torch.quant.formats import FPFormat, snap_to_base_grid

FMT = FPFormat(2, 1, True)  # E2M1 grid {0,.5,1,1.5,2,3,4,6} * scale/6


def _check_rows(hd: int, what: str) -> None:
    if hd % 2:
        raise ValueError(f"{what}: head dim {hd} must be even")


def kv4_encode_2d_plain(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: (R, hd) -> packed (R, hd/2) uint8, scale (R,) f16."""
    _check_rows(t.shape[-1], "kv4_encode")
    tf = t.to(torch.float32)
    scale = torch.clamp_min(tf.abs().amax(-1, keepdim=True), 1e-6)
    y = tf.abs() * (1.0 / scale) * FMT.base_max
    codes = grid_codes(snap_to_base_grid(y, FMT), FMT)
    codes = codes | ((tf < 0).to(torch.int32) << 3)
    return pack_nibbles(codes.to(torch.uint8)), scale[:, 0].to(torch.float16)


def kv4_decode_2d_plain(packed: torch.Tensor, scale: torch.Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """packed: (R, hd/2) uint8, scale: (R,) f16 -> (R, hd) ``dtype``."""
    return decode_codes(unpack_nibbles(packed), FMT,
                        scale.to(torch.float32)[:, None], 0.0, dtype)


def kv4_encode_2d_cuda(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dtype = check_input(t, "kv4_encode")
    if t.ndim != 2:
        raise ValueError(f"kv4_encode: t must be 2D, got {tuple(t.shape)}")
    r, hd = t.shape
    _check_rows(hd, "kv4_encode")
    packed = torch.empty((r, hd // 2), dtype=torch.uint8, device=t.device)
    scale = torch.empty((r,), dtype=torch.float16, device=t.device)
    rc = build.function("kv4_encode_launch")(
        t.data_ptr(), packed.data_ptr(), scale.data_ptr(), r, hd, dtype,
        torch.cuda.current_stream(t.device).cuda_stream)
    build.check(rc, "kv4_encode")
    kv4_encode_2d_cuda.launches += 1
    return packed, scale


kv4_encode_2d_cuda.launches = 0


def kv4_decode_2d_cuda(packed: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    if not packed.is_cuda or packed.dtype != torch.uint8 or packed.ndim != 2:
        raise ValueError(f"kv4_decode: packed must be 2D uint8 on the card, "
                         f"got {packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kv4_decode: dtype {dtype} not in "
                        f"{list(DTYPE_CODES)}")
    r, half = packed.shape
    if (scale.dtype != torch.float16 or scale.shape != (r,)
            or scale.device != packed.device):
        raise ValueError(f"kv4_decode: scale must be ({r},) f16 on "
                         f"{packed.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    if not (packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("kv4_decode: packed and scale must be contiguous")
    out = torch.empty((r, 2 * half), dtype=dtype, device=packed.device)
    rc = build.function("kv4_decode_launch")(
        packed.data_ptr(), scale.data_ptr(), out.data_ptr(), r, half,
        DTYPE_CODES[dtype], torch.cuda.current_stream(packed.device).cuda_stream)
    build.check(rc, "kv4_decode")
    kv4_decode_2d_cuda.launches += 1
    return out


kv4_decode_2d_cuda.launches = 0


def kv4_encode_2d(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: (R, hd) f32/bf16 -> packed (R, hd/2) uint8, scale (R,) f16."""
    if t.device.type == "cuda":
        return kv4_encode_2d_cuda(t.contiguous())
    if t.device.type == "cpu":
        return kv4_encode_2d_plain(t)
    raise ValueError(f"kv4_encode: no route for device {t.device}")


def kv4_decode_2d(packed: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """packed: (R, hd/2) uint8, scale: (R,) f16 -> (R, hd) ``dtype``."""
    if packed.device.type == "cuda":
        return kv4_decode_2d_cuda(packed.contiguous(), scale.contiguous(),
                                  dtype)
    if packed.device.type == "cpu":
        return kv4_decode_2d_plain(packed, scale, dtype)
    raise ValueError(f"kv4_decode: no route for device {packed.device}")
