"""K2: packed-FP4 weight matmul, optionally with the fused act snap.

CUDA kernel ``csrc/w4_matmul.cu`` (replaces the TPU kernels
``src/repro/kernels/w4_matmul.py:w4_matmul_2d`` / ``w4a4_matmul_2d``) and
its plain PyTorch version: qdq the act, decode the weight to f32, matmul,
add an unsigned weight's zero-point as the rank-1 term
``zp_n * sum_k x_q[i, k]`` (as the TPU kernel does), cast to ``x.dtype``.
The kernel multiplies exact bf16 grid operands on the tensor cores and
applies the scales to its f32 sums, so it differs from its plain version
(and from the TPU kernel's f32 path) only by per-term roundings of the
scales and the order of the f32 sums; with power-of-two scales and grid
acts the two agree bit for bit. ``gemm_plan`` picks the kernel's tile and
its split of K.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.qmodule import decode_codes, unpack_nibbles
from repro_torch.kernels import build, meta
from repro_torch.kernels.msfp_quant import check_input, scalar_operand
from repro_torch.quant.fakequant import fp_qdq
from repro_torch.quant.formats import FPFormat


LARGE, SMALL, MEDIUM = 0, 1, 2     # K2/K3's tiles, build.GEMM_TILES
TILES = build.GEMM_TILES           # cfg -> (rows, byte columns, k step, threads)
SMS = 132                          # streaming multiprocessors of an H100
MIN_STEPS = {LARGE: 3, SMALL: 1, MEDIUM: 2}   # k steps a split keeps


def tiles_for(m: int) -> tuple[int, ...]:
    """The tiles an (m, k) x (k, n) launch may take: Small (y^T = W^T x^T)
    exactly when m fits its rows."""
    return (SMALL,) if m <= TILES[SMALL][0] else (LARGE, MEDIUM)


def _k_steps(cfg: int, k: int) -> int:
    return -(-k // TILES[cfg][2])


def _splits(steps: int, per: int) -> int:
    """Splits of ``per`` steps each (the last may be shorter, none empty)."""
    return -(-steps // per) if steps else 1


def gemm_candidates(m: int, n: int, k: int) -> list[tuple[int, int]]:
    """Every (cfg, splits) a launch over (m, k) x (k, n) accepts: each tile
    ``tiles_for(m)`` with each split count whose splits are all non-empty.
    (``python -m repro_torch.kernels.sweep`` times them.)"""
    out = []
    for cfg in tiles_for(m):
        steps = _k_steps(cfg, k)
        out += [(cfg, s) for s in sorted({_splits(steps, per) for per in
                                          range(1, max(steps, 1) + 1)})]
    return out


def gemm_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(cfg, splits) of a K2/K3 launch over an (m, k) x (k, n) product, one
    of ``gemm_candidates``.

    Small serves m <= 8; Large the products with K >= 1024 and at least 32
    Large tiles, where the act snap's arithmetic is the cost and a big tile
    spreads it over more columns; Medium the rest, where latency is the
    cost and more, smaller blocks win. K is then split into as many splits
    as fit one wave of 2 x 132 blocks, each keeping at least ``MIN_STEPS``
    k steps. The splits' f32 partials are summed in split order. The
    thresholds come from ``kernels.sweep`` (its table is in
    PERF_APPENDIX.md)."""
    half = n // 2
    large_tiles = -(-m // TILES[LARGE][0]) * -(-half // TILES[LARGE][1])
    tiles = tiles_for(m)
    cfg = tiles[0] if len(tiles) == 1 else (
        LARGE if k >= 1024 and large_tiles >= 32 else MEDIUM)
    rows, bj, _, _ = TILES[cfg]
    blocks = -(-m // rows) * -(-half // bj)
    steps = _k_steps(cfg, k)
    want = max(1, 2 * SMS // max(blocks, 1))
    return cfg, _splits(steps, max(MIN_STEPS[cfg], -(-steps // want)))


def split_workspace(cfg_splits, m: int, n: int, like: torch.Tensor):
    """The f32 (splits, m, n) partials of a split launch (None for one
    split) and the kernel's (cfg, splits, workspace pointer) arguments."""
    cfg, splits = cfg_splits
    if splits == 1:
        return None, (cfg, 1, 0)
    ws = torch.empty(splits * m * n, dtype=torch.float32, device=like.device)
    return ws, (cfg, splits, ws.data_ptr())


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
                      exp_bits: int, man_bits: int, signed: bool = True,
                      plan: tuple[int, int] | None = None):
    """The kernel; ``plan`` forces one of ``gemm_candidates`` instead of
    ``gemm_plan``'s pick."""
    dtype = check_input(x, "w4_matmul")
    if x.ndim != 2 or packed.ndim != 2 or x.shape[1] != packed.shape[0]:
        raise ValueError(f"w4_matmul: x {tuple(x.shape)} vs packed "
                         f"{tuple(packed.shape)}")
    m, k = x.shape
    n = 2 * packed.shape[1]
    packed, sc, zp, stride = weight_operands(packed, scale, zero_point, n, x)
    act_args, _keep = act_operands(act, x)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _ws, plan_args = split_workspace(plan or gemm_plan(m, n, k), m, n, x)
    if x.is_meta:
        meta.record(flops=2 * m * n * k, operands=(
            x, packed, sc, *_keep, *(() if signed else (zp,))),
            results=(out,))
        return out
    rc = build.function("w4_matmul_launch")(
        x.data_ptr(), packed.data_ptr(), sc.data_ptr(), zp.data_ptr(), stride,
        m, n, k, exp_bits, man_bits, int(signed), *act_args, dtype, *plan_args,
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
    if meta.route(x, "w4_matmul") == "plain":
        return w4_matmul_2d_plain(x, packed, scale, zero_point, act, **kw)
    return w4_matmul_2d_cuda(x.contiguous(), packed, scale, zero_point, act,
                             **kw)


def w4a4_matmul_2d(x, packed, scale, zero_point, act_maxval, act_zero_point,
                   *, exp_bits: int, man_bits: int, signed: bool,
                   act_exp_bits: int, act_man_bits: int, act_signed: bool):
    """Fused act qdq + W4 matmul (the reference's signature)."""
    return w4_matmul_2d(
        x, packed, scale, zero_point,
        (act_maxval, act_zero_point, act_exp_bits, act_man_bits, act_signed),
        exp_bits=exp_bits, man_bits=man_bits, signed=signed)
