"""K3: packed-W4 NHWC conv2d as an implicit GEMM, plus the im2col route.

**Implicit GEMM** (``w4a4_conv2d_implicit``): CUDA kernel ``csrc/conv.cu``
(replaces the TPU kernel ``src/repro/kernels/conv.py:w4a4_conv2d_implicit``)
and its plain PyTorch version: qdq the act, zero-pad, conv against the
decoded HWIO weight (the ``kernels/ref.py`` oracle's quantize-then-pad
order); an unsigned weight's zero-point is added as the TPU kernel adds
it, as ``zp_n`` times the sum of each output pixel's taps. Signed and
unsigned per-tensor act snaps fuse.

**im2col** (``w4a4_conv2d_im2col``): a torch unfold into the patch matrix,
then K2. It is the oracle for the implicit route's gather and the
``CONV_ROUTE="im2col"`` path; only signed act snaps fuse there (the pad
zeros must survive the snap), so the dispatcher pre-quantizes the rest.

Padding is always explicit ``((ph_lo, ph_hi), (pw_lo, pw_hi))``: SAME
follows ``lax.padtype_to_pads``, which pads a 3x3 stride-2 conv at even
sizes by (0, 1), not PyTorch's symmetric (1, 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.device import no_tf32
from repro_torch.core.qmodule import PackedW4, decode_codes, unpack_nibbles
from repro_torch.kernels import build
from repro_torch.kernels.msfp_quant import check_input
from repro_torch.kernels.w4_matmul import (act_operands, gemm_plan,
                                           split_workspace, w4_matmul_2d,
                                           weight_operands, zero_point_term)
from repro_torch.quant.fakequant import (KIND_FP_SIGNED, QuantizerParams,
                                         apply_qdq)


def conv_pads(h: int, w: int, kh: int, kw: int, stride: tuple[int, int],
              padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """Resolve 'SAME'/'VALID' or explicit pairs to ((ph0, ph1), (pw0, pw1)),
    as ``lax.padtype_to_pads`` does."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for size, k, s in ((h, kh, stride[0]), (w, kw, stride[1])):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads[0], pads[1]
    (p0, p1), (p2, p3) = [tuple(p) for p in padding]
    return (int(p0), int(p1)), (int(p2), int(p3))


def conv_geometry(x_shape, kh: int, kw: int, stride, padding):
    """(oh, ow, (ph0, ph1), (pw0, pw1)) of an NHWC conv."""
    _, h, w, _ = x_shape
    (ph0, ph1), (pw0, pw1) = conv_pads(h, w, kh, kw, stride, padding)
    oh = (h + ph0 + ph1 - kh) // stride[0] + 1
    ow = (w + pw0 + pw1 - kw) // stride[1] + 1
    return oh, ow, (ph0, ph1), (pw0, pw1)


def im2col(x: torch.Tensor, kh: int, kw: int, *, stride, padding):
    """NHWC x -> (B*OH*OW, kh*kw*cin) patches, (kh, kw, cin)-major columns
    (the HWIO flattening), + (B, OH, OW)."""
    b, h, w, c = x.shape
    sh, sw = stride
    oh, ow, (ph0, ph1), (pw0, pw1) = conv_geometry(x.shape, kh, kw, stride,
                                                   padding)
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    cols = [x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    patches = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return patches.reshape(b * oh * ow, kh * kw * c), (b, oh, ow)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride, padding
                ) -> torch.Tensor:
    """Plain f32 NHWC/HWIO conv with explicit pads, TF32 off on the card."""
    kh, kw = w.shape[0], w.shape[1]
    _, _, (ph0, ph1), (pw0, pw1) = conv_geometry(x.shape, kh, kw, stride,
                                                 padding)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    with no_tf32():
        y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=tuple(stride))
    return y.permute(0, 2, 3, 1).contiguous()


def w4a4_conv2d_implicit_plain(x: torch.Tensor, pw: PackedW4,
                               act_qp: QuantizerParams | None, *, stride,
                               padding) -> torch.Tensor:
    if act_qp is not None:
        x = apply_qdq(x, act_qp)
    xf = x.to(torch.float32)
    w = decode_codes(unpack_nibbles(pw.packed), pw.fmt, pw.scale, 0.0,
                     torch.float32).reshape(pw.shape)
    y = conv2d_nhwc(xf, w, stride=stride, padding=padding)
    if not pw.signed:   # zp_n * (the sum of each output pixel's taps)
        kh, kw, cin, _ = pw.shape
        taps = conv2d_nhwc(xf, xf.new_ones(kh, kw, cin, 1), stride=stride,
                           padding=padding)
        y = y + zero_point_term(taps, pw.zero_point)
    return y.to(x.dtype)


def w4a4_conv2d_implicit_cuda(x: torch.Tensor, pw: PackedW4,
                              act_qp: QuantizerParams | None, *, stride,
                              padding, plan: tuple[int, int] | None = None
                              ) -> torch.Tensor:
    """The kernel; ``plan`` forces one of ``gemm_candidates`` instead of
    ``gemm_plan``'s pick."""
    dtype = check_input(x, "w4a4_conv2d")
    kh, kw, cin, cout = pw.shape
    if x.ndim != 4 or x.shape[-1] != cin:
        raise ValueError(f"conv: x {tuple(x.shape)} vs weight {pw.shape}")
    if cout % 2 or tuple(pw.packed.shape) != (kh * kw * cin, cout // 2):
        raise ValueError(f"conv: pack {tuple(pw.packed.shape)} is not the "
                         f"(kh*kw*cin, cout/2) flattening of {pw.shape}")
    if act_qp is not None and act_qp.maxval.numel() != 1:
        raise ValueError("conv kernel fuses per-tensor act quantizers only")
    b, h, w, _ = x.shape
    oh, ow, (ph0, _), (pw0, _) = conv_geometry(x.shape, kh, kw, stride, padding)
    packed, sc, zp, s_stride = weight_operands(pw.packed, pw.scale,
                                               pw.zero_point, cout, x)
    act = None if act_qp is None else (
        act_qp.maxval, act_qp.zero_point, act_qp.exp_bits, act_qp.man_bits,
        act_qp.kind == KIND_FP_SIGNED)
    act_args, _keep = act_operands(act, x)
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    m = b * oh * ow
    kdim = kh * kw * cin
    _ws, plan_args = split_workspace(plan or gemm_plan(m, cout, kdim), m,
                                     cout, x)
    rc = build.function("w4_conv2d_launch")(
        x.data_ptr(), packed.data_ptr(), sc.data_ptr(), zp.data_ptr(),
        s_stride, b, h, w, cin, oh, ow, kh, kw, stride[0], stride[1], ph0, pw0,
        cout, pw.exp_bits, pw.man_bits, int(pw.signed), *act_args, dtype,
        *plan_args, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "w4a4_conv2d")
    w4a4_conv2d_implicit_cuda.launches += 1
    return out


w4a4_conv2d_implicit_cuda.launches = 0


def w4a4_conv2d_implicit(x: torch.Tensor, pw: PackedW4,
                         act_qp: QuantizerParams | None, *, stride,
                         padding) -> torch.Tensor:
    """x (B, H, W, cin) @ packed HWIO W4 -> (B, OH, OW, cout) NHWC."""
    if x.device.type == "cuda":
        return w4a4_conv2d_implicit_cuda(x.contiguous(), pw, act_qp,
                                         stride=stride, padding=padding)
    if x.device.type == "cpu":
        return w4a4_conv2d_implicit_plain(x, pw, act_qp, stride=stride,
                                          padding=padding)
    raise ValueError(f"w4a4_conv2d: no route for device {x.device}")


def w4a4_conv2d_im2col(x: torch.Tensor, pw: PackedW4,
                       act_qp: QuantizerParams | None, *, stride,
                       padding) -> torch.Tensor:
    """Unfold then K2. ``act_qp`` must be signed per-tensor (or None)."""
    kh, kw, cin, cout = pw.shape
    patches, (b, oh, ow) = im2col(x, kh, kw, stride=stride, padding=padding)
    act = None
    if act_qp is not None:
        if act_qp.kind != KIND_FP_SIGNED or act_qp.maxval.numel() != 1:
            raise ValueError("im2col route fuses signed per-tensor acts only")
        act = (act_qp.maxval, act_qp.zero_point, act_qp.exp_bits,
               act_qp.man_bits, True)
    out = w4_matmul_2d(patches, pw.packed, pw.scale, pw.zero_point, act,
                       exp_bits=pw.exp_bits, man_bits=pw.man_bits,
                       signed=pw.signed)
    return out.reshape(b, oh, ow, cout)
