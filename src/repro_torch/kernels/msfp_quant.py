"""K1: fused MSFP fake-quantization (quantize-dequantize).

CUDA kernel ``csrc/msfp_quant.cu`` (replaces the TPU kernel
``src/repro/kernels/msfp_quant.py:msfp_qdq_2d``) and its plain PyTorch
version, bit-identical to it. ``msfp_qdq_2d`` dispatches on the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams, fp_qdq
from repro_torch.quant.formats import FPFormat

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def msfp_qdq_2d_plain(x: torch.Tensor, maxval, zero_point, *, exp_bits: int,
                      man_bits: int, signed: bool) -> torch.Tensor:
    return fp_qdq(x, FPFormat(exp_bits, man_bits, signed), maxval, zero_point)


def scalar_operand(v: torch.Tensor, like: torch.Tensor, what: str
                   ) -> torch.Tensor:
    """A per-tensor f32 parameter as a one-element tensor on ``like``'s
    device, read by the kernel through its pointer."""
    if not isinstance(v, torch.Tensor) or v.numel() != 1:
        raise ValueError(f"{what} must be a one-element tensor")
    if v.device != like.device:
        raise ValueError(f"{what} lives on {v.device}, input on {like.device}")
    return v.to(torch.float32).contiguous()


def check_input(x: torch.Tensor, what: str) -> int:
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    return DTYPE_CODES[x.dtype]


def msfp_qdq_2d_cuda(x: torch.Tensor, maxval, zero_point, *, exp_bits: int,
                     man_bits: int, signed: bool) -> torch.Tensor:
    dtype = check_input(x, "msfp_qdq")
    mv = scalar_operand(maxval, x, "maxval")
    zp = scalar_operand(zero_point, x, "zero_point")
    out = torch.empty_like(x)
    rc = build.function("msfp_qdq_launch")(
        x.data_ptr(), out.data_ptr(), x.numel(), mv.data_ptr(), zp.data_ptr(),
        exp_bits, man_bits, int(signed), dtype,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "msfp_qdq")
    msfp_qdq_2d_cuda.launches += 1
    return out


msfp_qdq_2d_cuda.launches = 0


def msfp_qdq_2d(x: torch.Tensor, maxval, zero_point, *, exp_bits: int,
                man_bits: int, signed: bool) -> torch.Tensor:
    """Elementwise qdq of ``x`` (any shape) under a per-tensor quantizer."""
    kw = dict(exp_bits=exp_bits, man_bits=man_bits, signed=signed)
    if x.device.type == "cuda":
        return msfp_qdq_2d_cuda(x.contiguous(), maxval, zero_point, **kw)
    if x.device.type == "cpu":
        return msfp_qdq_2d_plain(x, maxval, zero_point, **kw)
    raise ValueError(f"msfp_qdq: no route for device {x.device}")


def msfp_qdq(x: torch.Tensor, qp: QuantizerParams) -> torch.Tensor:
    return msfp_qdq_2d(x, qp.maxval, qp.zero_point, exp_bits=qp.exp_bits,
                       man_bits=qp.man_bits,
                       signed=(qp.kind == KIND_FP_SIGNED))
