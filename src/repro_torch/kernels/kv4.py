"""K4/K5: the FP4 (signed E2M1) KV-cache encode and decode, and the two
kernels the decode path runs on them.

CUDA kernels ``csrc/kv4.cu`` (replace the TPU kernels
``src/repro/kernels/kv4.py:kv4_encode_2d`` and ``:kv4_decode_2d``) and
their plain PyTorch versions, bit-identical to them and to the
interpret-mode Pallas kernels. Each row (one token's kv-head vector) gets
an absmax scale stored as f16 and hd/2 bytes of split-half nibbles; the
sign is bit 3 of a code. Every entry point dispatches on the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor the kernel,
a meta tensor the kernel's checks and allocations with no launch
(``kernels/meta.py``).

The decode path (``nn/attention.py``) launches neither K4 nor K5: it runs
``kv4_store`` (K4's encode of the new token's k and v, written in place
into the cache at its slot, one launch) and ``kv4_attend`` (decode
attention reading the packed cache, K5's decode fused into it). Their
plain versions are the composition they replace, moved as it was, so the
CPU path computes what it computed before bit for bit.

The arithmetic is the compiled Pallas kernel's, which differs from the
reference's ``ref.py`` oracles (ported as ``kernels/ref.py:ref_kv4_*``):
encode scales as ``(|t| * (1 / scale)) * 6`` where the oracle divides by
``scale / 6``, and decode multiplies by ``scale * f32(1/6)`` (XLA's form
of the division by the constant 6).
"""
from __future__ import annotations

import torch

import contextlib
import math

from repro_torch.common.device import no_tf32
from repro_torch.core.qmodule import (decode_codes, grid_codes, pack_nibbles,
                                      unpack_nibbles)
from repro_torch.kernels import build, meta
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
    if t.is_meta:
        meta.record(operands=(t,), results=(packed, scale))
        return packed, scale
    rc = build.function("kv4_encode_launch")(
        t.data_ptr(), packed.data_ptr(), scale.data_ptr(), r, hd, dtype,
        torch.cuda.current_stream(t.device).cuda_stream)
    build.check(rc, "kv4_encode")
    kv4_encode_2d_cuda.launches += 1
    return packed, scale


kv4_encode_2d_cuda.launches = 0


def kv4_decode_2d_cuda(packed: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    if packed.device.type not in ("cuda", "meta") or \
            packed.dtype != torch.uint8 or packed.ndim != 2:
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
    if packed.is_meta:
        meta.record(operands=(packed, scale), results=(out,))
        return out
    rc = build.function("kv4_decode_launch")(
        packed.data_ptr(), scale.data_ptr(), out.data_ptr(), r, half,
        DTYPE_CODES[dtype], torch.cuda.current_stream(packed.device).cuda_stream)
    build.check(rc, "kv4_decode")
    kv4_decode_2d_cuda.launches += 1
    return out


kv4_decode_2d_cuda.launches = 0


def kv4_encode_2d(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t: (R, hd) f32/bf16 -> packed (R, hd/2) uint8, scale (R,) f16."""
    if meta.route(t, "kv4_encode") == "plain":
        return kv4_encode_2d_plain(t)
    return kv4_encode_2d_cuda(t.contiguous())


def kv4_decode_2d(packed: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """packed: (R, hd/2) uint8, scale: (R,) f16 -> (R, hd) ``dtype``."""
    if meta.route(packed, "kv4_decode") == "plain":
        return kv4_decode_2d_plain(packed, scale, dtype)
    return kv4_decode_2d_cuda(packed.contiguous(), scale.contiguous(), dtype)


# ---------------------------------------------------------------------------
# the decode path's pair: kv4_store and kv4_attend
# ---------------------------------------------------------------------------

def attend_row_stride(hd: int) -> int:
    """A staged cache row's stride in kv4_attend's shared memory: hd/2
    bytes padded so that each row starts 16-byte aligned (8 where hd/2 is
    not a multiple of 16) and the threads' reads of consecutive rows fall
    in distinct banks. The kernel computes the same (csrc/kv4.cu:
    row_stride) and its launch refuses a stride that differs."""
    hh = hd // 2
    return hh + (8 if hh % 16 else 16)


def attend_smem_bytes(g: int, hd: int, slots: int,
                      logits: bool = True) -> int:
    """kv4_attend's dynamic shared memory for a cache of ``slots`` slots,
    the size its launch is given: the two-chunk ring of staged rows, q in
    f32, the ring's row scales, the reductions' scratch and, with
    ``logits``, the G x slots f32 logits (the layout csrc/kv4.cu:
    kv4_attend_kernel carves up; the chunk and the most query heads are
    kernels/build.py's)."""
    chunk = build.ATTEND_CHUNK
    return 2 * chunk * attend_row_stride(hd) + 4 * (
        g * hd + 2 * chunk + 8 * build.ATTEND_MAX_G + (g * slots if logits
                                                       else 0))


def attend_logits_shared(g: int, hd: int, slots: int) -> bool:
    """Whether kv4_attend keeps the G x slots logits in shared memory
    (they fit one block's ``build.BLOCK_SMEM_LIMIT``) or in a global
    workspace of B x K x G x slots f32. The two give the same bits."""
    return attend_smem_bytes(g, hd, slots) <= build.BLOCK_SMEM_LIMIT


def check_attend_shape(g: int, hd: int, slots: int) -> None:
    """Raise ValueError naming the limit kv4_attend's kernel would break
    (a long cache breaks none: its logits go to the workspace)."""
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"kv4_attend: head dim {hd} must be a multiple of "
                         "16 in [16, 256]")
    if not 1 <= g <= build.ATTEND_MAX_G:
        raise ValueError(f"kv4_attend: {g} query heads per kv-head, the "
                         f"kernel takes 1 to {build.ATTEND_MAX_G}")
    if slots < 1:
        raise ValueError(f"kv4_attend: a cache of {slots} slots")


def attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
           valid_len: int, scale: float, softcap: float | None = None
           ) -> torch.Tensor:
    """Decode attention over a decoded cache: q (B, K, G, hd), keys/vals
    (B, S, K, hd) in the load dtype -> o (B, K, G, hd) in it. The
    reference leaves this to XLA: logits in f32 over f32-cast operands
    (TF32 off) times ``scale``, the optional softcap, slots from
    ``valid_len`` on masked to -1e30, softmax, the weights rounded to the
    load dtype, and their product with the values in that dtype (bf16
    products reduced in f32 on the card too)."""
    s_max = keys.shape[1]
    with no_tf32():
        logits = torch.einsum("bqkgh,bskh->bkgqs",
                              q[:, None].to(torch.float32),
                              keys.to(torch.float32)) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    valid = torch.arange(s_max, device=q.device) < valid_len
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(vals.dtype)
    with no_tf32(), f32_reductions():
        o = torch.einsum("bkgqs,bskh->bqkgh", w, vals)
    return o[:, 0]


@contextlib.contextmanager
def f32_reductions():
    """cuBLAS may add a bf16 product's split-K partials in bf16 unless told
    not to; the reference (and the CPU) reduce in f32."""
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = old


def kv4_store_plain(k_new, v_new, k, v, k_scale, v_scale, pos: int) -> None:
    """k_new, v_new (B, K, hd) -> their codes and scales written into slot
    ``pos`` of k, v (B, S, K, hd/2) uint8 and k_scale, v_scale (B, S, K)
    f16, in place."""
    for t, codes, scales in ((k_new, k, k_scale), (v_new, v, v_scale)):
        packed, sc = kv4_encode_2d_plain(t.reshape(-1, t.shape[-1]))
        codes[:, pos] = packed.reshape(codes[:, pos].shape)
        scales[:, pos] = sc.reshape(scales[:, pos].shape)


def _decode_cache(codes, scales, dtype):
    b, s, n_kv, hh = codes.shape
    return kv4_decode_2d_plain(codes.reshape(-1, hh), scales.reshape(-1),
                               dtype).reshape(b, s, n_kv, 2 * hh)


def kv4_attend_plain(q, k, v, k_scale, v_scale, valid_len: int,
                     scale: float, softcap: float | None = None
                     ) -> torch.Tensor:
    """q (B, K, G, hd) over the packed cache -> o (B, K, G, hd) in q.dtype
    (the load dtype): the whole cache decoded by K5's arithmetic, then
    ``attend``."""
    return attend(q, _decode_cache(k, k_scale, q.dtype),
                  _decode_cache(v, v_scale, q.dtype), valid_len, scale,
                  softcap)


def kv4_attend_allowed(q, k, v, k_scale, v_scale, valid_len: int,
                       scale: float, softcap: float | None,
                       want: torch.Tensor) -> torch.Tensor:
    """Per element of o, how far kv4_attend's kernel may lie from
    ``want``, the plain version's output on the same inputs. The two round
    at the same points and differ in the order of their f32 sums only, and
    in an ulp or two of tanh, exp and the divisions:
      * a logit's dot over hd terms: 4 sqrt(hd) 2^-24 of the sum of
        |q k| * scale (check_close's sum-order rule), plus 2^-21 of |logit|
        for the scale, softcap and tanh steps; the softmax passes an error
        d in the logits on to the weights as at most 2 d relative, plus
        (4 sqrt(n) + 8) 2^-24 for exp, the division and the n-term sum;
      * o's sum over the n = valid_len slots: 4 sqrt(n) 2^-24 of
        mag = sum_s w_s |v_s|, plus the weights' relative error times mag;
      * that, or rtol = atol = 1e-5 where larger (check_close's rule), plus
        one ulp of the load dtype on the rounded weights (eps * mag) and on
        the rounded output (eps * |want|)."""
    n = int(valid_len)
    hd = q.shape[-1]
    u = 2.0 ** -24
    keys = _decode_cache(k, k_scale, q.dtype)[:, :n].double()
    vals = _decode_cache(v, v_scale, q.dtype)[:, :n].double()
    qd = q.double()
    lmag = torch.einsum("bkgh,bskh->bkgs", qd.abs(), keys.abs()) * scale
    logits = torch.einsum("bkgh,bskh->bkgs", qd, keys) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    d = 4 * math.sqrt(hd) * u * lmag.amax(-1) + 2.0 ** -21 * logits.abs(
        ).amax(-1)
    rel_w = 2 * d + (4 * math.sqrt(n) + 8) * u
    mag = torch.einsum("bkgs,bskh->bkgh", torch.softmax(logits, -1),
                       vals.abs())
    wd = want.double().abs()
    eps = torch.finfo(q.dtype).eps
    order = (4 * math.sqrt(n) * u + rel_w[..., None]) * mag
    return (torch.maximum(1e-5 + 1e-5 * wd, order) + eps * mag
            + eps * wd)


def _check_cache(k, v, k_scale, v_scale, b, n_kv, hd, device, what) -> int:
    """The four cache tensors' layout; returns the number of slots."""
    if k.dim() != 4:
        raise ValueError(f"{what}: cache codes must be (B, S, K, hd/2), got "
                         f"{tuple(k.shape)}")
    slots = k.shape[1]
    codes, scales = (b, slots, n_kv, hd // 2), (b, slots, n_kv)
    for name, x, dt, shape in (("k", k, torch.uint8, codes),
                               ("v", v, torch.uint8, codes),
                               ("k_scale", k_scale, torch.float16, scales),
                               ("v_scale", v_scale, torch.float16, scales)):
        if (x.dtype != dt or tuple(x.shape) != shape or x.device != device
                or not x.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"{shape} on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return slots


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kv4_store_cuda(k_new, v_new, k, v, k_scale, v_scale, pos: int) -> None:
    dtype = check_input(k_new, "kv4_store")
    if (v_new.shape != k_new.shape or v_new.dtype != k_new.dtype
            or v_new.device != k_new.device or not v_new.is_contiguous()):
        raise ValueError("kv4_store: v_new must match k_new, contiguous")
    if k_new.dim() != 3:
        raise ValueError(f"kv4_store: k_new must be (B, K, hd), got "
                         f"{tuple(k_new.shape)}")
    b, n_kv, hd = k_new.shape
    _check_rows(hd, "kv4_store")
    slots = _check_cache(k, v, k_scale, v_scale, b, n_kv, hd, k_new.device,
                         "kv4_store")
    if not 0 <= pos < slots:
        raise ValueError(f"kv4_store: slot {pos} outside [0, {slots})")
    if k_new.is_meta:
        meta.record(operands=(k_new, v_new), results=(
            k[:, pos], v[:, pos], k_scale[:, pos], v_scale[:, pos]))
        return
    rc = build.function("kv4_store_launch")(
        k_new.data_ptr(), v_new.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), b, n_kv, slots, pos, hd,
        dtype, _stream(k_new))
    build.check(rc, "kv4_store")
    kv4_store_cuda.launches += 1


kv4_store_cuda.launches = 0


def kv4_attend_cuda(q, k, v, k_scale, v_scale, valid_len: int, scale: float,
                    softcap: float | None = None, *,
                    workspace: bool | None = None) -> torch.Tensor:
    """The kernel. ``workspace``: True puts the logits in the global
    workspace, False in shared memory (raises where they do not fit),
    None picks by ``attend_logits_shared``."""
    dtype = check_input(q, "kv4_attend")
    if q.dim() != 4:
        raise ValueError(f"kv4_attend: q must be (B, K, G, hd), got "
                         f"{tuple(q.shape)}")
    b, n_kv, g, hd = q.shape
    slots = _check_cache(k, v, k_scale, v_scale, b, n_kv, hd, q.device,
                         "kv4_attend")
    check_attend_shape(g, hd, slots)
    if not 1 <= valid_len <= slots:
        raise ValueError(f"kv4_attend: valid_len {valid_len} outside "
                         f"[1, {slots}]")
    # the widest cp.async copy every row start allows (rows lie hd/2 bytes
    # apart, hd/2 a multiple of 8)
    align = math.gcd(hd // 2, k.data_ptr(), v.data_ptr())
    cpw = next((w for w in (16, 8, 4) if align % w == 0), None)
    if cpw is None:
        raise ValueError("kv4_attend: cache rows must start 4-byte aligned")
    shared = attend_logits_shared(g, hd, slots)
    if workspace is None:
        workspace = not shared
    elif not workspace and not shared:
        raise ValueError(
            f"kv4_attend: {g} query heads x {slots} cache slots of f32 "
            f"logits need {attend_smem_bytes(g, hd, slots)} bytes of shared "
            f"memory, above the {build.BLOCK_SMEM_LIMIT} one block may hold")
    out = torch.empty_like(q)
    ws = (torch.empty(b * n_kv * g * slots, dtype=torch.float32,
                      device=q.device) if workspace else None)
    if q.is_meta:
        n = b * n_kv * g * slots
        meta.record(flops=4 * n * hd, operands=(q, k, v, k_scale, v_scale),
                    results=(out,), transcendentals=n * (2 if softcap else 1))
        return out
    rc = build.function("kv4_attend_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), None if ws is None else
        ws.data_ptr(), b, n_kv, g, hd, slots, int(valid_len), float(scale),
        float(softcap or 0.0), cpw, attend_row_stride(hd),
        attend_smem_bytes(g, hd, slots, logits=not workspace), dtype,
        _stream(q))
    build.check(rc, "kv4_attend")
    kv4_attend_cuda.launches += 1
    return out


kv4_attend_cuda.launches = 0


def kv4_store(k_new, v_new, k, v, k_scale, v_scale, pos: int) -> None:
    """Encode k_new, v_new (B, K, hd) into cache slot ``pos``, in place."""
    if meta.route(k_new, "kv4_store") == "plain":
        return kv4_store_plain(k_new, v_new, k, v, k_scale, v_scale, pos)
    return kv4_store_cuda(k_new.contiguous(), v_new.contiguous(), k, v,
                          k_scale, v_scale, pos)


def kv4_attend(q, k, v, k_scale, v_scale, valid_len: int, scale: float,
               softcap: float | None = None) -> torch.Tensor:
    """q (B, K, G, hd) attends over the first ``valid_len`` slots of the
    packed cache -> o (B, K, G, hd) in q.dtype."""
    if meta.route(q, "kv4_attend") == "plain":
        return kv4_attend_plain(q, k, v, k_scale, v_scale, valid_len, scale,
                                softcap)
    return kv4_attend_cuda(q.contiguous(), k, v, k_scale, v_scale, valid_len,
                           scale, softcap)
