"""Kernel dispatch; port of ``repro.kernels.ops``.

Every op dispatches on its input's device: a CUDA tensor launches the
hand-written kernel (K1 ``msfp_quant`` and the io sites' ``qdq_conv2d``
beside it, K2 ``w4_matmul``, K3 ``conv``, K4/K5 ``kv4`` and the decode
path's ``kv4_store``/``kv4_attend``) or raises, a CPU tensor takes the
kernel's plain PyTorch version. There is no fallback from a failed kernel
to the plain version.

The branches that no kernel covers keep the reference's rules (INT-affine
or per-channel act params, stacked packs -> ``kernels/ref.py``; the dense
f32 matmul of bf16-fallback weights; the dense conv that ``qdq_conv2d``
does not cover) and, like every other decision here, go through
``_dispatch``, which counts it in ``ROUTES`` under ``(op, route)``. Route
labels: ``cuda`` / ``cuda:implicit`` / ``cuda:im2col`` (a kernel),
``plain`` / ``plain:*`` (a kernel's plain version on the CPU), ``ref`` (an
off-kernel oracle), ``torch_f32`` (a dense f32 product the reference
leaves to XLA: ``dense_matmul``, and ``dense_conv2d`` outside
``qdq_conv2d``'s cover) and ``torch`` (the tied LM head's readout
product, likewise).

``CONV_ROUTE``: ``"implicit"`` (the implicit-GEMM kernel K3) or
``"im2col"`` (unfold + K2).

``PROFILER``: ``None``, or an installed ``serving.obs.KernelProfiler``
that ``_dispatch`` hands each call to (``PROFILER.call(op, route, thunk,
probe=x)``); with ``None`` a dispatch costs one more global read.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.common.device import no_tf32
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.conv import (conv2d_nhwc, w4a4_conv2d_im2col,
                                      w4a4_conv2d_implicit)
from repro_torch.kernels import kv4 as _kv4
from repro_torch.kernels.kv4 import kv4_decode_2d, kv4_encode_2d
from repro_torch.kernels.msfp_quant import (IO_CONV_KERNELS, io_conv_fits,
                                            msfp_qdq, qdq_conv2d)
from repro_torch.kernels.w4_matmul import w4_matmul_2d
from repro_torch.quant.fakequant import (KIND_FP_SIGNED, KIND_FP_UNSIGNED,
                                         KIND_INT_AFFINE, QuantizerParams)

CONV_ROUTE: str = "implicit"  # "implicit" | "im2col"

# (op, route) -> dispatch count; reset_routes() clears it.
ROUTES: collections.Counter = collections.Counter()

KERNEL_ROUTES = ("cuda", "cuda:implicit", "cuda:im2col")

# the obs layer's per-route profiler, when one is installed
PROFILER = None


def _dispatch(op: str, route: str, thunk, probe=None):
    ROUTES[(op, route)] += 1
    if PROFILER is not None:
        return PROFILER.call(op, route, thunk, probe=probe)
    return thunk()


def reset_routes() -> None:
    ROUTES.clear()


def _kernel_label(x: torch.Tensor) -> str:
    return "cuda" if x.device.type == "cuda" else "plain"


def msfp_quantize(x: torch.Tensor, qp: QuantizerParams,
                  folded: bool = False) -> torch.Tensor:
    """Fused fake-quant (serving path; ``folded``: the fine-tune's STE,
    ``quant/fakequant.py:FORMS``). The kernel takes per-tensor FP
    parameters; INT-affine and per-channel maxvals take the oracle."""
    if qp.kind != KIND_INT_AFFINE and qp.maxval.numel() == 1:
        return _dispatch("msfp_quantize", _kernel_label(x),
                         lambda: msfp_qdq(x, qp, folded), x)
    return _dispatch("msfp_quantize", "ref",
                     lambda: _ref.ref_msfp_qdq(x, qp), x)


def _w4_ok(pw: PackedW4) -> bool:
    """The kernels cover every MSFP format with a scalar or per-output-
    channel scale on a single 2D pack; stacked packs take the oracle."""
    if pw.packed.ndim != 2:
        return False
    if pw.scale.numel() == 1:
        return True
    return pw.scale.ndim == 1 and pw.scale.shape[0] == 2 * pw.packed.shape[-1]


def _w4_args(pw: PackedW4) -> dict:
    return dict(exp_bits=pw.exp_bits, man_bits=pw.man_bits, signed=pw.signed)


def w4_matmul(x: torch.Tensor, pw: PackedW4) -> torch.Tensor:
    """x: (..., K) @ packed W4 (K, N/2-packed) -> (..., N)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _w4_ok(pw):
        out = _dispatch("w4_matmul", _kernel_label(x), lambda: w4_matmul_2d(
            x2, pw.packed, pw.scale, pw.zero_point, None, **_w4_args(pw)), x2)
    else:
        out = _dispatch("w4_matmul", "ref",
                        lambda: _ref.ref_w4_matmul(x2, pw, x.dtype), x2)
    return out.reshape(*lead, out.shape[-1])


def w4a4_matmul(x: torch.Tensor, pw: PackedW4,
                act_qp: QuantizerParams | None) -> torch.Tensor:
    """Fused activation-quant + W4 matmul: qdq(x, act_qp) @ W in one kernel;
    INT-affine or per-channel act params fall back to qdq-then-matmul."""
    if act_qp is None:
        return w4_matmul(x, pw)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if (_w4_ok(pw) and act_qp.kind != KIND_INT_AFFINE
            and act_qp.maxval.numel() == 1):
        act = (act_qp.maxval, act_qp.zero_point, act_qp.exp_bits,
               act_qp.man_bits, act_qp.kind == KIND_FP_SIGNED)
        out = _dispatch("w4a4_matmul", _kernel_label(x), lambda: w4_matmul_2d(
            x2, pw.packed, pw.scale, pw.zero_point, act, **_w4_args(pw)), x2)
    else:
        out = _dispatch("w4a4_matmul", "ref",
                        lambda: _ref.ref_w4a4_matmul(x2, pw, act_qp, x.dtype), x2)
    return out.reshape(*lead, out.shape[-1])


def _normalize_stride(stride) -> tuple[int, int]:
    return (stride, stride) if isinstance(stride, int) else tuple(stride)


def w4a4_conv2d(x: torch.Tensor, pw: PackedW4,
                act_qp: QuantizerParams | None = None, *,
                stride=1, padding="SAME") -> torch.Tensor:
    """NHWC conv on a packed HWIO W4 weight.

    The implicit route fuses signed and unsigned per-tensor FP act snaps;
    the im2col route fuses signed ones only. Any other act quantizer is
    applied first (``msfp_quantize``), as the reference does."""
    strides = _normalize_stride(stride)
    if len(pw.shape) == 4 and _w4_ok(pw):
        route = CONV_ROUTE
        if route not in ("implicit", "im2col"):
            raise ValueError(f"CONV_ROUTE must be 'implicit' or 'im2col', "
                             f"got {route!r}")
        fusable = ((KIND_FP_SIGNED, KIND_FP_UNSIGNED) if route == "implicit"
                   else (KIND_FP_SIGNED,))
        if act_qp is not None and not (act_qp.kind in fusable
                                       and act_qp.maxval.numel() == 1):
            x = msfp_quantize(x, act_qp)
            act_qp = None
        fn = w4a4_conv2d_implicit if route == "implicit" else w4a4_conv2d_im2col
        return _dispatch("w4a4_conv2d", f"{_kernel_label(x)}:{route}",
                         lambda: fn(x, pw, act_qp, stride=strides,
                                    padding=padding), x)
    if act_qp is not None and not (act_qp.kind == KIND_FP_SIGNED
                                   and act_qp.maxval.numel() == 1):
        x = msfp_quantize(x, act_qp)
        act_qp = None
    return _dispatch("w4a4_conv2d", "ref", lambda: _ref.ref_w4a4_conv2d(
        x, pw, act_qp, stride=strides, padding=padding, dtype=x.dtype), x)


def _io_conv_ok(x: torch.Tensor, w: torch.Tensor,
                act_qp: QuantizerParams | None, strides, padding) -> bool:
    """``qdq_conv2d``'s cover: f32 x, a per-tensor FP act quantizer or
    none, stride 1, a square 1x1 or 3x3 f32/bf16 weight, and a band that
    fits one block's shared memory."""
    return (x.dtype == torch.float32 and x.ndim == 4 and w.ndim == 4
            and w.dtype in (torch.float32, torch.bfloat16)
            and (act_qp is None or (act_qp.kind != KIND_INT_AFFINE
                                    and act_qp.maxval.numel() == 1))
            and strides == (1, 1) and w.shape[0] == w.shape[1]
            and w.shape[0] in IO_CONV_KERNELS
            and io_conv_fits(x.shape, w.shape, padding))


def dense_conv2d(x: torch.Tensor, w: torch.Tensor,
                 act_qp: QuantizerParams | None = None,
                 bias: torch.Tensor | None = None, *, stride=1,
                 padding="SAME") -> torch.Tensor:
    """The io sites: act snap, f32 conv of a dense (bf16-fallback) weight
    and bias. One ``qdq_conv2d`` launch where it covers the call
    (``_io_conv_ok``); otherwise the composition the reference runs:
    ``msfp_quantize``, the f32 conv (``torch_f32``), the bias add."""
    strides = _normalize_stride(stride)
    if _io_conv_ok(x, w, act_qp, strides, padding):
        return _dispatch("conv2d", _kernel_label(x), lambda: qdq_conv2d(
            x, w, act_qp, bias, padding=padding), x)
    if act_qp is not None:
        x = msfp_quantize(x, act_qp)
    y = _dispatch("conv2d", "torch_f32", lambda: conv2d_nhwc(
        x, w.to(x.dtype), stride=strides, padding=padding), x)
    return y if bias is None else y + bias.to(y.dtype)


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 matmul of a dense (bf16-fallback) weight."""
    def run():
        with no_tf32():
            return x @ w.to(x.dtype)
    return _dispatch("matmul", "torch_f32", run, x)


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``x @ table.T`` in x.dtype: the tied LM head's readout, a plain
    product (f32 with TF32 off, or bf16 with f32 accumulation)."""
    def run():
        with no_tf32():
            return x @ table.to(x.dtype).T
    return _dispatch("tied_logits", "torch", run, x)


def kv4_encode(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: (..., hd) -> packed (..., hd/2) uint8 + scale (...,) f16 (K4)."""
    lead, hd = t.shape[:-1], t.shape[-1]
    packed, scale = _dispatch("kv4_encode", _kernel_label(t),
                              lambda: kv4_encode_2d(t.reshape(-1, hd)), t)
    return packed.reshape(*lead, hd // 2), scale.reshape(lead)


def kv4_decode(packed: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """packed (..., hd/2) + scale (...,) -> (..., hd) ``dtype`` (K5)."""
    lead, hh = packed.shape[:-1], packed.shape[-1]
    out = _dispatch("kv4_decode", _kernel_label(packed),
                    lambda: kv4_decode_2d(packed.reshape(-1, hh),
                                          scale.reshape(-1), dtype), packed)
    return out.reshape(*lead, 2 * hh)


def kv4_store(k_new: torch.Tensor, v_new: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, k_scale: torch.Tensor, v_scale: torch.Tensor,
              pos: int) -> None:
    """The new token's k and v (B, K, hd) encoded into slot ``pos`` of the
    packed cache (k, v (B, S, K, hd/2) uint8; k_scale, v_scale (B, S, K)
    f16), in place: one ``kv4_store`` launch."""
    _dispatch("kv4_store", _kernel_label(k_new), lambda: _kv4.kv4_store(
        k_new, v_new, k, v, k_scale, v_scale, pos), k_new)


def kv4_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               k_scale: torch.Tensor, v_scale: torch.Tensor, valid_len: int,
               scale: float, softcap: float | None = None) -> torch.Tensor:
    """q (B, K, G, hd) attends over the first ``valid_len`` slots of the
    packed cache -> o (B, K, G, hd) in q.dtype: one ``kv4_attend``
    launch, the cache decoded where it is read."""
    return _dispatch("kv4_attend", _kernel_label(q), lambda: _kv4.kv4_attend(
        q, k, v, k_scale, v_scale, valid_len, scale, softcap), q)
