"""K1: fused MSFP fake-quantization (quantize-dequantize), and the io
sites' conv with K1 fused into it.

CUDA kernels in ``csrc/msfp_quant.cu``, each with its plain PyTorch
version, and dispatchers that send a CPU tensor to the plain version, a
CUDA tensor to the kernel and a meta tensor to the kernel's checks and
allocations with no launch (``kernels/meta.py``):

* ``msfp_qdq_2d``: K1 (replaces the TPU kernel
  ``src/repro/kernels/msfp_quant.py:msfp_qdq_2d``), bit-identical to its
  plain version;
* ``qdq_conv2d``: K1's snap, the dense f32 conv and the bias of an io site
  in one launch (replaces K1 fused with the XLA conv at
  ``src/repro/nn/layers.py:106``); its plain version is the composition it
  replaces, K1's plain version, ``conv.conv2d_nhwc`` and the bias add.

The kernels are forward only. Under autograd (the fine-tune's FP teacher
and fake-quant student run their dense convs through ``qdq_conv2d``) the
CUDA route goes through ``QdqConv2dFn``: the kernel forward, the conv's
input, weight and bias gradients in plain torch (TF32 off), as the
reference computes its backward outside Pallas too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, meta
from repro_torch.quant.fakequant import (KIND_FP_SIGNED, KIND_INT_AFFINE,
                                         QuantizerParams, fp_qdq)
from repro_torch.quant.formats import FPFormat

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def msfp_qdq_2d_plain(x: torch.Tensor, maxval, zero_point, *, exp_bits: int,
                      man_bits: int, signed: bool, folded: bool = False
                      ) -> torch.Tensor:
    return fp_qdq(x, FPFormat(exp_bits, man_bits, signed), maxval, zero_point,
                  form="folded" if folded else "compiled")


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
    """A kernel input's dtype code; a meta tensor passes where a CUDA one
    would (the meta route runs the kernel wrapper's checks)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not in {list(DTYPE_CODES)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    return DTYPE_CODES[x.dtype]


def msfp_qdq_2d_cuda(x: torch.Tensor, maxval, zero_point, *, exp_bits: int,
                     man_bits: int, signed: bool, folded: bool = False
                     ) -> torch.Tensor:
    dtype = check_input(x, "msfp_qdq")
    mv = scalar_operand(maxval, x, "maxval")
    zp = scalar_operand(zero_point, x, "zero_point")
    out = torch.empty_like(x)
    if x.is_meta:
        meta.record(operands=(x,), results=(out,))
        return out
    rc = build.function("msfp_qdq_launch")(
        x.data_ptr(), out.data_ptr(), x.numel(), mv.data_ptr(), zp.data_ptr(),
        exp_bits, man_bits, int(signed), int(folded), dtype,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "msfp_qdq")
    msfp_qdq_2d_cuda.launches += 1
    return out


msfp_qdq_2d_cuda.launches = 0


def msfp_qdq_2d(x: torch.Tensor, maxval, zero_point, *, exp_bits: int,
                man_bits: int, signed: bool, folded: bool = False
                ) -> torch.Tensor:
    """Elementwise qdq of ``x`` (any shape) under a per-tensor quantizer;
    ``folded``: the scale as the true division ``maxval / base_max``
    (``fakequant.FORMS``), for the fine-tune's STE."""
    kw = dict(exp_bits=exp_bits, man_bits=man_bits, signed=signed,
              folded=folded)
    if meta.route(x, "msfp_qdq") == "plain":
        return msfp_qdq_2d_plain(x, maxval, zero_point, **kw)
    return msfp_qdq_2d_cuda(x.contiguous(), maxval, zero_point, **kw)


def msfp_qdq(x: torch.Tensor, qp: QuantizerParams, folded: bool = False
             ) -> torch.Tensor:
    return msfp_qdq_2d(x, qp.maxval, qp.zero_point, exp_bits=qp.exp_bits,
                       man_bits=qp.man_bits,
                       signed=(qp.kind == KIND_FP_SIGNED), folded=folded)


# ---------------------------------------------------------------------------
# qdq_conv2d: the io sites' act snap, dense f32 conv and bias, one launch
# ---------------------------------------------------------------------------

WEIGHT_CODES = {torch.float32: 0, torch.bfloat16: 1}
IO_CONV_KERNELS = (1, 3)   # the square kernel sizes qdq_conv2d takes


class IoConvLayout(NamedTuple):
    """A ``qdq_conv2d`` launch's band and shared-memory layout (floats):
    ``rows`` output rows a CTA, act pixels ``cs`` apart, the narrow
    kernel's weight rows ``ks`` apart, ``smem`` bytes in all."""
    rows: int
    cs: int
    ks: int
    smem: int


def _odd_words(n: int) -> int:
    """n (a multiple of 4) padded to an odd count of 16-byte words, so
    that neighbouring threads' 16-byte reads fall in distinct banks."""
    return n + 4 if (n // 4) % 2 == 0 else n


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def io_conv_layout(oh: int, ow: int, cin: int, cout: int, k: int,
                   rows: int | None = None) -> IoConvLayout:
    """The one formula for ``qdq_conv2d``'s layout, which its launch is
    given (csrc/msfp_quant.cu carves the shared memory up the same way and
    refuses less): the halo of ``rows`` output rows (2 by default),
    (rows + k - 1) x (ow + k - 1) pixels of ``cs`` floats, rounded up to
    16 bytes, then the weights: HWIO for the wide kernel (cout % 4 == 0),
    channel-major rows of ``ks`` floats for the narrow one (a multiple of
    its min(cout, 4) channels a thread, the padding rows zero); then the
    bias."""
    rows = min(rows or 2, oh)
    kdim = k * k * cin
    if cout % 4 != 0 and cin % 4 == 0:   # narrow, 16-byte reads over c
        cs, ks = _odd_words(cin), _odd_words(kdim)
    else:
        cs, ks = cin | 1, kdim | 1
    xs = _round4((rows + k - 1) * (ow + k - 1) * cs)
    nc = min(cout, 4)   # the narrow kernel's channels a thread
    ws = kdim * cout if cout % 4 == 0 else _round4(-(-cout // nc) * nc * ks)
    return IoConvLayout(rows, cs, ks, 4 * (xs + ws + _round4(cout)))


def io_conv_fits(x_shape, w_shape, padding="SAME") -> bool:
    """Whether ``qdq_conv2d``'s band fits one block's shared memory."""
    from repro_torch.kernels.conv import conv_geometry
    k, _, cin, cout = w_shape
    oh, ow, _, _ = conv_geometry(x_shape, k, k, (1, 1), padding)
    return io_conv_layout(oh, ow, cin, cout, k).smem <= build.BLOCK_SMEM_LIMIT


def qdq_conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                     act_qp: QuantizerParams | None,
                     bias: torch.Tensor | None, *, padding="SAME"
                     ) -> torch.Tensor:
    """K1's plain version, then the f32 conv (TF32 off), then the bias:
    the composition the kernel replaces, bit for bit."""
    from repro_torch.kernels.conv import conv2d_nhwc
    if act_qp is not None:
        x = msfp_qdq_2d_plain(x, act_qp.maxval, act_qp.zero_point,
                              exp_bits=act_qp.exp_bits,
                              man_bits=act_qp.man_bits,
                              signed=act_qp.kind == KIND_FP_SIGNED)
    y = conv2d_nhwc(x, w.to(x.dtype), stride=(1, 1), padding=padding)
    return y if bias is None else y + bias.to(y.dtype)


def _aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"qdq_conv2d: {what} must start 16-byte aligned "
                         "(the kernel reads it 16 bytes at a time)")


def qdq_conv2d_cuda(x: torch.Tensor, w: torch.Tensor,
                    act_qp: QuantizerParams | None,
                    bias: torch.Tensor | None, *, padding="SAME",
                    rows: int | None = None) -> torch.Tensor:
    """The kernel; ``rows`` forces the band height (output rows a CTA)."""
    from repro_torch.kernels.conv import conv_geometry
    if x.device.type not in ("cuda", "meta") or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("qdq_conv2d: x must be a contiguous f32 CUDA tensor")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"qdq_conv2d: x {tuple(x.shape)} must be NHWC and "
                         f"w {tuple(w.shape)} HWIO")
    k, kw, cin, cout = w.shape
    if k != kw or k not in IO_CONV_KERNELS or x.shape[-1] != cin:
        raise ValueError(f"qdq_conv2d: weight {tuple(w.shape)} must be a "
                         f"square {IO_CONV_KERNELS} kernel over x's "
                         f"{x.shape[-1]} channels")
    if w.dtype not in WEIGHT_CODES or w.device != x.device \
            or not w.is_contiguous():
        raise ValueError(f"qdq_conv2d: weight must be a contiguous "
                         f"{list(WEIGHT_CODES)} tensor on {x.device}")
    if bias is not None:
        if bias.shape != (cout,) or bias.device != x.device:
            raise ValueError(f"qdq_conv2d: bias {tuple(bias.shape)} must be "
                             f"({cout},) on {x.device}")
        bias = bias.to(torch.float32).contiguous()
        _aligned(bias, "bias")
    _aligned(x, "x")
    act = (None, None, 0, 0, 0, 0)
    if act_qp is not None:
        if act_qp.kind == KIND_INT_AFFINE or act_qp.maxval.numel() != 1:
            raise ValueError("qdq_conv2d fuses per-tensor FP act quantizers "
                             "only")
        act = (scalar_operand(act_qp.maxval, x, "maxval"),
               scalar_operand(act_qp.zero_point, x, "zero_point"),
               act_qp.exp_bits, act_qp.man_bits,
               int(act_qp.kind == KIND_FP_SIGNED), 1)
    b, h, wd, _ = x.shape
    oh, ow, (ph0, _), (pw0, _) = conv_geometry(x.shape, k, k, (1, 1), padding)
    if min(ph0, pw0) < 0:
        raise ValueError(f"qdq_conv2d: negative pads {padding}")
    lay = io_conv_layout(oh, ow, cin, cout, k, rows)
    if lay.smem > build.BLOCK_SMEM_LIMIT:
        raise ValueError(
            f"qdq_conv2d: a band of {lay.rows} rows at {ow} wide x {cin} "
            f"channels needs {lay.smem} bytes of shared memory, above the "
            f"{build.BLOCK_SMEM_LIMIT} one block may hold")
    out = torch.empty((b, oh, ow, cout), dtype=torch.float32, device=x.device)
    if x.is_meta:
        meta.record(flops=2 * out.numel() * k * k * cin,
                    operands=(x, w, bias), results=(out,))
        return out
    mv, zp, eb, mb, sgn, has_act = act
    rc = build.function("qdq_conv2d_launch")(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, h, wd, cin, cout, oh, ow, k, ph0, pw0, lay.rows,
        lay.cs, lay.ks, lay.smem, None if mv is None else mv.data_ptr(),
        None if zp is None else zp.data_ptr(), eb, mb, sgn, has_act,
        WEIGHT_CODES[w.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "qdq_conv2d")
    qdq_conv2d_cuda.launches += 1
    return out


qdq_conv2d_cuda.launches = 0


class QdqConv2dFn(torch.autograd.Function):
    """``qdq_conv2d_cuda`` with a backward: the conv's gradients in plain
    torch. The act snap has no gradient of its own here (the fine-tune
    snaps in ``ste_qdq`` first), so a grad-requiring call takes
    ``act_qp=None`` only."""

    @staticmethod
    def forward(ctx, x, w, bias, padding):
        from repro_torch.kernels.conv import conv_geometry
        k = w.shape[0]
        _, _, ctx.pads_h, ctx.pads_w = conv_geometry(x.shape, k, k, (1, 1),
                                                     padding)
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return qdq_conv2d_cuda(x, w, None, bias, padding=padding)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.common.device import no_tf32
        x, w = ctx.saved_tensors
        (ph0, ph1), (pw0, pw1) = ctx.pads_h, ctx.pads_w
        _, h, wd, _ = x.shape
        g = g.to(torch.float32).permute(0, 3, 1, 2)
        w_oihw = w.to(torch.float32).permute(3, 2, 0, 1)
        xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                     (pw0, pw1, ph0, ph1))
        gx = gw = gb = None
        with no_tf32():
            if ctx.needs_input_grad[0]:
                gxp = torch.nn.grad.conv2d_input(xp.shape, w_oihw, g)
                gx = gxp[:, :, ph0:ph0 + h, pw0:pw0 + wd].permute(0, 2, 3, 1)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(xp, w_oihw.shape, g)
                gw = gw.permute(2, 3, 1, 0).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.sum((0, 2, 3))
        return gx, gw, gb, None


def qdq_conv2d(x: torch.Tensor, w: torch.Tensor,
               act_qp: QuantizerParams | None, bias: torch.Tensor | None, *,
               padding="SAME") -> torch.Tensor:
    """y = conv(pad(snap(x)), w) + bias at stride 1: x (B, H, W, cin) f32
    NHWC, w (k, k, cin, cout) HWIO in f32 or bf16, act_qp a per-tensor FP
    quantizer or None, bias (cout,) or None. On the card a call that needs
    gradients runs ``QdqConv2dFn``; on the CPU the plain version is
    differentiable as it is."""
    r = meta.route(x, "qdq_conv2d")
    if r == "meta":
        return qdq_conv2d_cuda(x.contiguous(), w.contiguous(), act_qp, bias,
                               padding=padding)
    if r == "cuda":
        x, w = x.contiguous(), w.contiguous()
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, w, bias)):
            if act_qp is not None:
                raise NotImplementedError(
                    "qdq_conv2d's backward takes act_qp=None only (snap "
                    "the act with quant.fakequant.ste_qdq first)")
            return QdqConv2dFn.apply(x, w, bias, padding)
        return qdq_conv2d_cuda(x, w, act_qp, bias, padding=padding)
    return qdq_conv2d_plain(x, w, act_qp, bias, padding=padding)
