"""K2: packed-FP4 weight matmul, optionally with the fused act snap.

CUDA kernel ``csrc/w4_matmul.cu`` (replaces the TPU kernels
``src/repro/kernels/w4_matmul.py:w4_matmul_2d`` / ``w4a4_matmul_2d``) and
its plain PyTorch version: qdq the act, decode the weight to f32, matmul,
add an unsigned weight's zero-point as the rank-1 term
``zp_n * sum_k x_q[i, k]`` (as the TPU kernel does), cast to ``x.dtype``.
The kernel, its plain version and the TPU kernel differ only in the order
of the f32 sums.
"""
from __future__ import annotations

import torch

from repro_torch.core.qmodule import decode_codes, unpack_nibbles
from repro_torch.kernels import build
from repro_torch.kernels.msfp_quant import check_input, scalar_operand
from repro_torch.quant.fakequant import fp_qdq
from repro_torch.quant.formats import FPFormat


def weight_operands(packed: torch.Tensor, scale, zero_point, n: int,
                    like: torch.Tensor):
    """Validate a (K, N/2) pack and its scale/zp for the kernels; returns
    (packed, scale, zp, scale_stride) with scale/zp f32 on the device."""
    if packed.dtype != torch.uint8 or packed.ndim != 2:
        raise ValueError(f"packed must be 2D uint8, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if packed.device != like.device or not packed.is_contiguous():
        raise ValueError("packed must be contiguous on the input's device")
    sc = torch.as_tensor(scale, dtype=torch.float32, device=like.device)
    zp = torch.as_tensor(zero_point, dtype=torch.float32, device=like.device)
    if sc.numel() == 1 and zp.numel() == 1:
        return packed, sc.reshape(1), zp.reshape(1), 0
    if sc.numel() == 1:
        sc = sc.reshape(1).expand(n)
    if zp.numel() == 1:
        zp = zp.reshape(1).expand(n)
    if sc.shape != (n,) or zp.shape != (n,):
        raise ValueError(f"scale/zero_point must be scalars or ({n},), got "
                         f"{tuple(sc.shape)} / {tuple(zp.shape)}")
    return packed, sc.contiguous(), zp.contiguous(), 1


def act_operands(act, like: torch.Tensor):
    """Kernel arguments (maxval_ptr, zp_ptr, exp_bits, man_bits, signed,
    enabled) for an optional (maxval, zp, exp_bits, man_bits, signed) act
    snap, plus the operand tensors, which the caller keeps alive across
    the launch."""
    if act is None:
        return (0, 0, 0, 0, 1, 0), ()
    maxval, zp, e, m, signed = act
    mv = scalar_operand(maxval, like, "act maxval")
    z = scalar_operand(zp, like, "act zero_point")
    return (mv.data_ptr(), z.data_ptr(), e, m, int(signed), 1), (mv, z)


def zero_point_term(x_q: torch.Tensor, zero_point) -> torch.Tensor:
    """An unsigned weight format's zero-point as the TPU kernels add it,
    the rank-1 term ``zp_n * sum_k x_q[..., k]`` after
    the product of the acts with the weight decoded without it."""
    zp = torch.as_tensor(zero_point, dtype=torch.float32, device=x_q.device)
    return x_q.to(torch.float32).sum(-1, keepdim=True) * zp.reshape(-1)


def w4_matmul_2d_plain(x, packed, scale, zero_point=0.0, act=None, *,
                       exp_bits: int, man_bits: int, signed: bool = True):
    """``act``: None or (maxval, zp, exp_bits, man_bits, signed)."""
    if act is not None:
        maxval, zp, e, m, s = act
        x = fp_qdq(x, FPFormat(e, m, s), maxval, zp)
    w = decode_codes(unpack_nibbles(packed), FPFormat(exp_bits, man_bits,
                                                      signed),
                     scale, 0.0, torch.float32)
    y = x.to(torch.float32) @ w
    if not signed:
        y = y + zero_point_term(x, zero_point)
    return y.to(x.dtype)


def w4_matmul_2d_cuda(x, packed, scale, zero_point=0.0, act=None, *,
                      exp_bits: int, man_bits: int, signed: bool = True):
    dtype = check_input(x, "w4_matmul")
    if x.ndim != 2 or packed.ndim != 2 or x.shape[1] != packed.shape[0]:
        raise ValueError(f"w4_matmul: x {tuple(x.shape)} vs packed "
                         f"{tuple(packed.shape)}")
    m, k = x.shape
    n = 2 * packed.shape[1]
    packed, sc, zp, stride = weight_operands(packed, scale, zero_point, n, x)
    act_args, _keep = act_operands(act, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.function("w4_matmul_launch")(
        x.data_ptr(), packed.data_ptr(), sc.data_ptr(), zp.data_ptr(), stride,
        m, n, k, exp_bits, man_bits, int(signed), *act_args, dtype,
        out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "w4_matmul")
    w4_matmul_2d_cuda.launches += 1
    return out


w4_matmul_2d_cuda.launches = 0


def w4_matmul_2d(x, packed, scale, zero_point=0.0, act=None, *,
                 exp_bits: int, man_bits: int, signed: bool = True):
    """x: (M, K) f32/bf16; packed: (K, N/2) uint8 -> (M, N) x.dtype.

    ``scale``/``zero_point`` are scalars or (N,) tensors; ``act`` = None
    (``w4_matmul_2d``) or (maxval, zp, exp_bits, man_bits, signed) for the
    fused snap (``w4a4_matmul_2d``)."""
    kw = dict(exp_bits=exp_bits, man_bits=man_bits, signed=signed)
    if x.device.type == "cuda":
        return w4_matmul_2d_cuda(x.contiguous(), packed, scale, zero_point,
                                 act, **kw)
    if x.device.type == "cpu":
        return w4_matmul_2d_plain(x, packed, scale, zero_point, act, **kw)
    raise ValueError(f"w4_matmul: no route for device {x.device}")


def w4a4_matmul_2d(x, packed, scale, zero_point, act_maxval, act_zero_point,
                   *, exp_bits: int, man_bits: int, signed: bool,
                   act_exp_bits: int, act_man_bits: int, act_signed: bool):
    """Fused act qdq + W4 matmul (the reference's signature)."""
    return w4_matmul_2d(
        x, packed, scale, zero_point,
        (act_maxval, act_zero_point, act_exp_bits, act_man_bits, act_signed),
        exp_bits=exp_bits, man_bits=man_bits, signed=signed)
