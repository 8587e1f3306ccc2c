#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build the four CUDA sources from ``src/repro_torch/kernels/csrc`` (one
     nvcc each, all at once);
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes: ddim-cifar10's and smollm-135m's decode (K1, K4,
     K5 and kv4_store bit-exact; K2/K3 and the io sites' qdq_conv2d (at
     conv_in and conv_out, acts signed, unsigned with zp != 0, and off)
     within rtol = atol = 1e-5 or the f32 sum-order bound, plus one bf16
     rounding step for bf16 outputs, see check_close; kv4_attend within
     kernels/kv4.py:kv4_attend_allowed, that bound carried through the
     softmax plus one ulp of the load dtype);
  4. time kernel, plain version and library yardstick as device time
     (CUDA-graph replays timed with CUDA events; TF32 off for the
     yardsticks and plain versions) beside the bound; qdq_conv2d also
     beside the composition it replaces (K1, the torch f32 conv, the bias
     add);
  5. serve ddim-cifar10 at full width through the launcher: the golden
     trace under the virtual clock; 8 requests x 10 ddim steps at
     max-batch 8 on the wall clock (written at t=0 with save_trace and
     replayed with --trace); deadline_mix under the slo policy on the wall
     clock with obs on (span trace, metrics, report: the profiler's route
     counts equal ops.ROUTES and the launch counts, the trace has the
     request lifecycle, ticks, forwards and bank fetches, the report's
     summary is the collector's; goodput, p95, SLO verdict, evals/s and
     the profiler's device ms printed). In every run each kernel of the
     path must launch (qdq_conv2d twice a forward, the standalone K1
     never), no off-kernel route may run, and the K2/K3 launches, tallied
     by shape, must add up to their counts. Then the golden trace replayed
     on the card and on the CPU from the same params, router, hubs and
     x_T: tick log, outcomes, bank counters and x_T identical, x0 held on
     power-of-two weight scales (REPLAY_X0_LIMIT, with a control fault
     that must break it, and TF32 as a reading) and reported on the
     random weights, where the
     card's digest must be the launcher's; the card replay with obs on
     identical to obs off; and the 8 x 10 replay's evals/s with obs off
     and on in turns (a reading);
  6. full-width forwards at batch 8 against the CPU plain versions: on
     power-of-two weight scales every K2/K3 call bit-exact and each io
     call within check_close, the forward held card vs CPU and kernels vs
     plain versions on the card, and two control faults that must break
     the card-vs-CPU limit; on the random weights every call held by
     check_close and a control that must break it (see forward_checks);
     the card's forward with the io sites' old composition reported
     against the CPU beside it; then one profiled forward (device busy
     time, idle share, kernel launches, top kernels);
  7. serve smollm-135m at full width (W4A4, FP4 KV cache, batch 8, 32
     prompt + 32 generated tokens) through its launcher: K2, kv4_store and
     kv4_attend must launch (one kv4_store and one kv4_attend a layer and
     step; the standalone K4/K5 never), no off-kernel route may run apart
     from the tied LM head's product, and the K2 launches by shape add up
     to their count;
  8. a few teacher-forced decode steps of smollm-135m at full width, in
     f32 and in bf16, on the card vs the plain CPU path, each held to its
     limit (see lm_checks), then one bf16 decode step timed and profiled
     (device busy, idle share, kernel launches, K2/kv4_store/kv4_attend
     device ms);
  9. every distinct K2/K3 shape launched by the 8 x 10 run of phase 5 and
     the serve run of phase 7, checked signed and unsigned by check_close
     and timed as in phases 3-4, with its launches per forward / per
     decode step in those runs and launches x ms, and per path the sum of
     launches x ms beside the K2/K3 device totals of the phase 6 and 8
     profiles;
  10. the paper's pipeline on ddim-cifar10 at full width (pipeline_phase:
     calibration, the MSFP search on the card held against the CPU's on a
     named subset, TALoRA + DFA train steps with K1 and qdq_conv2d
     launching under autograd, one step profiled, one step card vs CPU
     between its control faults, beside readings with TF32 in the
     backward and with K1 and qdq_conv2d on their plain versions,
     eval_denoising_gap, the kernels at the
     plan's formats), then the 8 x 10 replay on --plan absmax and --plan
     search in turns, each through serve()'s checks;
  11. a ``kernels`` JSON line (each kernel's launches in all and per path:
     per forward for ddim-cifar10, per decode step for smollm-135m, per
     train step for the pipeline), the card line, and the result line.
Needs one card; exits non-zero without one or without the repo around it.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B = 8                       # main-path batch (max-batch 8)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = 989e12     # bf16 dense tensor-core rate, H100 SXM
PEAK_F32_PER_S = 67e12      # f32 outside the tensor cores, H100 SXM
TOL = dict(rtol=1e-5, atol=1e-5)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Device milliseconds per call of ``fn`` (kernels.sweep.device_ms:
    calls captured in one CUDA graph, its replays timed with CUDA events,
    so the host's launch overhead is not in the number). A refused capture
    fails the run."""
    from repro_torch.kernels.sweep import device_ms
    try:
        return device_ms(fn)
    except RuntimeError as e:
        fail(f"CUDA graph capture refused, no device time to report: {e}")


def bound(ops: float, nbytes: float, peak: float = PEAK_OPS_PER_S,
          f32_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the peak rate of their type and the bytes (each input read once,
    each output written once) over the memory rate. The products' operands
    are FP4 grid points times per-tensor scales, so the bf16 tensor-core
    rate is their peak; the elementwise snap runs on the f32 units.
    ``f32_ops`` are elementwise operations beside ``ops``' products, priced
    at the f32 rate (the two kinds of unit run side by side)."""
    t_ops = max(ops / peak, f32_ops / PEAK_F32_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def abs_weight(pw):
    """|w| + |zp| per weight element, w decoded without its zero-point:
    the summands of the product and of the rank-1 zero-point term."""
    import torch
    from repro_torch.core.qmodule import decode_codes, unpack_nibbles
    w = decode_codes(unpack_nibbles(pw.packed), pw.fmt, pw.scale, 0.0,
                     torch.float32)
    return (w.abs() + pw.zero_point.abs()).reshape(pw.shape)


def check_close(name, got, want, mag, k: int) -> float:
    """K2/K3 against the plain version: the f32 sums run in another order,
    nothing else differs. Allowed per element: the larger of the stated
    rtol = atol = 1e-5 and 4 * sqrt(K) * 2^-24 * mag, where mag is the same
    product over |x_q| and abs_weight (the order error of a K-term f32 sum
    grows like sqrt(K) ulps of the summands' magnitude, which can be far
    above their sum). One wrong term, a whole |x w|, stays far above it.
    A bf16 output adds one bf16 rounding step (eps * |want|): two f32 sums
    an ulp apart can round to neighbouring bf16 values."""
    bad, err, allowed = close_violations(got, want, mag, k)
    if bad:
        fail(f"{name}: kernel disagrees with its plain version at {bad} "
             f"elements (max abs err {err:.3g}, allowed there "
             f"{allowed:.3g})")
    return err


def close_violations(got, want, mag, k: int) -> tuple[int, float, float]:
    """check_close's rule: (elements outside it, max abs err, the largest
    allowance among those elements)."""
    import torch
    eps = torch.finfo(got.dtype).eps if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allowed = (TOL["atol"] + TOL["rtol"] * want.abs()).maximum(
        4.0 * math.sqrt(k) * 2.0**-24 * mag) + eps * want.abs()
    bad = diff > allowed
    n = int(bad.sum())
    return n, float(diff.max()), float(allowed[bad].max()) if n else 0.0


def _gen_randn(dev, seed):
    import torch
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)
    return randn


def _qp(dev, signed, maxval, zp=0.0, per=None):
    import torch
    from repro_torch.quant.fakequant import QuantizerParams
    mv = maxval if per is None else per
    return QuantizerParams(0 if signed else 1, 2, 1 if signed else 2, 4,
                           torch.as_tensor(mv, dtype=torch.float32,
                                           device=dev),
                           torch.tensor(zp, device=dev))


def k2_row(dev, m: int, k: int, n: int, dt) -> dict:
    """K2 at (m, k) x (k, n) in ``dt``: checked signed (E2M1 weight, E2M1
    acts at maxval 6, the main path) and unsigned (per-channel uE2M2
    weight with a zero-point, uE2M2 acts), then the signed case timed
    beside the plain version, the f32 library product (TF32 off) and, for
    bf16, the bf16 product of the bf16-rounded dequantized weight (a
    different rounding, reported only)."""
    import torch
    from repro_torch.common.device import no_tf32
    from repro_torch.core.qmodule import dequant_weight, pack_weight
    from repro_torch.kernels import w4_matmul as k2
    from repro_torch.quant.fakequant import apply_qdq
    randn = _gen_randn(dev, m * 7919 + k * 31 + n)
    x = randn(m, k).to(dt)
    w = randn(k, n, scale=k ** -0.5)
    cases = [(_qp(dev, True, float(w.abs().max())), _qp(dev, True, 6.0)),
             (_qp(dev, False, 0.0, -0.3 * float(w.abs().max()),
                  per=w.abs().amax(0) * 1.2), _qp(dev, False, 3.0, -0.28))]
    label = f"({m},{k})x({k},{n})" + (" bf16" if dt == torch.bfloat16 else "")
    row = None
    for i, (wq, aq) in enumerate(cases):
        pw = pack_weight(w, wq)
        act = (aq.maxval, aq.zero_point, aq.exp_bits, aq.man_bits,
               aq.kind == 0)
        args = (x, pw.packed, pw.scale, pw.zero_point, act)
        kw = dict(exp_bits=pw.exp_bits, man_bits=pw.man_bits,
                  signed=pw.signed)
        got = k2.w4_matmul_2d_cuda(*args, **kw)
        wd = dequant_weight(pw, torch.float32)
        with no_tf32():
            want = k2.w4_matmul_2d_plain(*args, **kw)
            mag = apply_qdq(x, aq).float().abs() @ abs_weight(pw)
        err = check_close(f"w4a4_matmul {label} case {i}", got, want, mag, k)
        if i:
            row["max_abs_err_unsigned"] = err
            continue
        ms = cuda_ms(lambda: k2.w4_matmul_2d_cuda(*args, **kw))
        xf = x.float()
        with no_tf32():
            plain_ms = cuda_ms(lambda: k2.w4_matmul_2d_plain(*args, **kw))
            lib_ms = cuda_ms(lambda: torch.matmul(xf, wd))
        elt = x.element_size()
        b_ms, b_by = bound(2.0 * m * k * n, elt * m * k + k * n // 2
                           + elt * m * n)
        row = dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   split=list(k2.gemm_plan(m, n, k)))
        if dt == torch.bfloat16:
            wb = wd.to(torch.bfloat16)
            row["library_bf16_ms"] = cuda_ms(lambda: torch.matmul(x, wb))
    return row


def k3_row(dev, b: int, hw: int, cin: int, cout: int, kk: int, s: int
           ) -> dict:
    """K3, NHWC (b, hw, hw, cin) * (kk, kk, cin, cout) at stride s, SAME,
    in f32: checked signed and unsigned as ``k2_row``, then timed beside
    the plain version and the f32 library conv (cuDNN, TF32 off)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.common.device import no_tf32
    from repro_torch.core.qmodule import dequant_weight, pack_weight
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import w4_matmul as k2
    from repro_torch.quant.fakequant import apply_qdq
    randn = _gen_randn(dev, hw * 7919 + cin * 31 + cout + kk * 3 + s)
    x = randn(b, hw, hw, cin)
    w = randn(kk, kk, cin, cout, scale=(kk * kk * cin) ** -0.5)
    cases = [(_qp(dev, True, float(w.abs().max())), _qp(dev, True, 6.0)),
             (_qp(dev, False, 0.0, -0.3 * float(w.abs().max()),
                  per=w.abs().amax((0, 1, 2)) * 1.2),
              _qp(dev, False, 3.0, -0.28))]
    label = f"{kk}x{kk} s{s} {hw}x{hw} {cin}->{cout}" + (
        f" B{b}" if b != B else "")
    row = None
    for i, (wq, aq) in enumerate(cases):
        pw = pack_weight(w, wq)
        kw = dict(stride=(s, s), padding="SAME")
        got = k3.w4a4_conv2d_implicit_cuda(x, pw, aq, **kw)
        want = k3.w4a4_conv2d_implicit_plain(x, pw, aq, **kw)
        mag = k3.conv2d_nhwc(apply_qdq(x, aq).abs(), abs_weight(pw), **kw)
        err = check_close(f"w4a4_conv2d {label} case {i}", got, want,
                          mag, kk * kk * cin)
        if i:
            row["max_abs_err_unsigned"] = err
            continue
        ms = cuda_ms(lambda: k3.w4a4_conv2d_implicit_cuda(x, pw, aq, **kw))
        plain_ms = cuda_ms(
            lambda: k3.w4a4_conv2d_implicit_plain(x, pw, aq, **kw))
        oh, ow, (ph0, ph1), (pw0, pw1) = k3.conv_geometry(
            x.shape, kk, kk, (s, s), "SAME")
        xn = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1)).contiguous()
        wn = dequant_weight(pw, torch.float32).permute(3, 2, 0, 1).contiguous()
        with no_tf32():
            lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, stride=s))
        m, kdim = b * oh * ow, kk * kk * cin
        b_ms, b_by = bound(2.0 * m * kdim * cout,
                           4 * x.numel() + kdim * cout // 2 + 4 * m * cout)
        row = dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   split=list(k2.gemm_plan(m, cout, kdim)))
    return row


def io_conv_row(dev, site: str, cin: int, cout: int) -> dict:
    """qdq_conv2d at an io site of ddim-cifar10 (B 8, 32x32, 3x3 SAME, a
    bf16 weight and a bias, as the bank keeps them): checked with acts
    signed (E2M1 at maxval 6, the main path), unsigned (uE2M2, zp -0.28:
    its snap of 0 is not 0, so the pads must stay 0) and off, each by
    check_close against the plain version with K = 9 * cin and the
    magnitude the same conv over |snap(x)| and |W|; then the signed case
    timed beside the plain version, the bound, the library yardstick
    (F.conv2d in f32, TF32 off, on the snapped input padded to NCHW
    beforehand: the conv alone, which the port never calls) and the
    composition the kernel replaces (K1, dense_conv2d's torch f32 conv,
    the bias add). The bound counts each input read once and the output
    written once, 2 f32 operations a multiply-add and 20 a snapped act."""
    import torch
    import torch.nn.functional as F
    from repro_torch.common.device import no_tf32
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.quant.fakequant import apply_qdq
    randn = _gen_randn(dev, cin * 31 + cout)
    x = randn(B, 32, 32, cin, scale=2.0)
    w = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(torch.bfloat16)
    bias = randn(cout, scale=0.1)
    acts = {"signed": _qp(dev, True, 6.0),
            "unsigned": _qp(dev, False, 3.0, -0.28), "off": None}
    label = f"{site} 3x3 32x32 {cin}->{cout} B{B}, bf16 weight, bias"
    checks = {}
    for kind, aq in acts.items():
        got = k1.qdq_conv2d_cuda(x, w, aq, bias)
        want = k1.qdq_conv2d_plain(x, w, aq, bias)
        xq = x if aq is None else apply_qdq(x, aq)
        mag = k3.conv2d_nhwc(xq.abs(), w.float().abs(), stride=(1, 1),
                             padding="SAME")
        checks[kind] = check_close(f"qdq_conv2d {label}, acts {kind}", got,
                                   want, mag, 9 * cin)
    aq = acts["signed"]
    snap = dict(exp_bits=aq.exp_bits, man_bits=aq.man_bits, signed=True)

    def composition():
        xq = k1.msfp_qdq_2d_cuda(x, aq.maxval, aq.zero_point, **snap)
        return k3.conv2d_nhwc(xq, w.to(torch.float32), stride=(1, 1),
                              padding="SAME") + bias

    ms = cuda_ms(lambda: k1.qdq_conv2d_cuda(x, w, aq, bias))
    plain_ms = cuda_ms(lambda: k1.qdq_conv2d_plain(x, w, aq, bias))
    comp_ms = cuda_ms(composition)
    xn = F.pad(apply_qdq(x, aq).permute(0, 3, 1, 2),
               (1, 1, 1, 1)).contiguous()
    wn = w.float().permute(3, 2, 0, 1).contiguous()
    with no_tf32():
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn))
    m = B * 32 * 32
    b_ms, b_by = bound(0.0, 4 * x.numel() + 2 * w.numel() + 4 * cout
                       + 4 * m * cout,
                       f32_ops=2.0 * m * 9 * cin * cout + 20.0 * x.numel())
    return dict(shape=label, max_abs_err=max(checks.values()),
                checks=checks, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library="F.conv2d f32 (TF32 off) on the snapped input padded "
                        "to NCHW beforehand: the conv alone",
                composition_ms=comp_ms,
                composition="K1 + dense_conv2d's torch f32 conv + bias add")


def kernel_checks(dev):
    """Phases 3 and 4: per kernel, per main-path shape, check and time
    (K2/K3 at their first main-path shapes; every other shape the paths
    launch in phase 9)."""
    import torch
    from repro_torch.kernels import msfp_quant as k1
    randn = _gen_randn(dev, 0)

    def qp(signed, maxval, zp=0.0):
        return _qp(dev, signed, maxval, zp)

    rows = {"msfp_qdq": [], "qdq_conv2d": [], "w4a4_matmul": [],
            "w4a4_conv2d": []}

    # K1: the io-site act snaps, (B*1024, 3) at conv_in, (B*1024, 128) at
    # conv_out; signed E2M1 at maxval 6 (main path) and unsigned E2M2.
    for m, n in ((B * 1024, 3), (B * 1024, 128)):
        x = randn(m, n, scale=2.0)
        for signed in (True, False):
            q = qp(signed, 6.0 if signed else 3.0, 0.0 if signed else -0.28)
            kw = dict(exp_bits=q.exp_bits, man_bits=q.man_bits, signed=signed)
            args = (x, q.maxval, q.zero_point)
            got = k1.msfp_qdq_2d_cuda(*args, **kw)
            want = k1.msfp_qdq_2d_plain(*args, **kw)
            if not torch.equal(got, want):
                fail(f"msfp_qdq ({m},{n}) signed={signed}: not bit-exact "
                     f"({int((got != want).sum())} elements differ)")
            if not signed:
                continue
            ms = cuda_ms(lambda: k1.msfp_qdq_2d_cuda(*args, **kw))
            plain_ms = cuda_ms(lambda: k1.msfp_qdq_2d_plain(*args, **kw))
            b_ms, b_by = bound(20.0 * m * n, 2 * 4 * m * n, PEAK_F32_PER_S)
            rows["msfp_qdq"].append(dict(
                shape=f"({m},{n})", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None))

    # the io sites, each one qdq_conv2d launch: conv_in 3 -> 128 and
    # conv_out 128 -> 3 at 32x32
    rows["qdq_conv2d"] = [io_conv_row(dev, "conv_in", 3, 128),
                          io_conv_row(dev, "conv_out", 128, 3)]

    # K2: attention q/k/v/proj at 16x16 x 256 ch, and temb1 (B, 512)x512
    # (ddim-cifar10, f32); smollm-135m's decode at batch B in bf16: the
    # up/gate projection (B,576)x(576,1536) and down (B,1536)x(1536,576).
    for m, k, n, dt in ((B * 256, 256, 256, torch.float32),
                        (B, 512, 512, torch.float32),
                        (B, 576, 1536, torch.bfloat16),
                        (B, 1536, 576, torch.bfloat16)):
        rows["w4a4_matmul"].append(k2_row(dev, m, k, n, dt))

    # K3: ResBlock conv 3x3 s1 at 32x32 128->128, downsample 3x3 s2
    # 32->16, up-path 3x3 s1 at 8x8 512->256 and its 1x1 skip 512->256.
    for hw, cin, cout, kk, s in ((32, 128, 128, 3, 1), (32, 128, 128, 3, 2),
                                 (8, 512, 256, 3, 1), (8, 512, 256, 1, 1)):
        rows["w4a4_conv2d"].append(k3_row(dev, B, hw, cin, cout, kk, s))
    return rows


def kernel_fns() -> dict:
    """Each kernel's CUDA wrapper, which counts its launches."""
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import kv4 as k45
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    return {"msfp_qdq": k1.msfp_qdq_2d_cuda,
            "qdq_conv2d": k1.qdq_conv2d_cuda,
            "w4a4_matmul": k2.w4_matmul_2d_cuda,
            "w4a4_conv2d": k3.w4a4_conv2d_implicit_cuda,
            "kv4_encode": k45.kv4_encode_2d_cuda,
            "kv4_decode": k45.kv4_decode_2d_cuda,
            "kv4_store": k45.kv4_store_cuda,
            "kv4_attend": k45.kv4_attend_cuda}


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_fns().items()}


def reset_counts():
    from repro_torch.kernels import ops
    for fn in kernel_fns().values():
        fn.launches = 0
    ops.reset_routes()


def check_path(name: str, counts: dict, needed, allowed_off) -> None:
    """Every kernel of the path launched; no off-kernel route ran apart
    from the ``allowed_off`` (op, route) pairs."""
    from repro_torch.kernels import ops
    for k in needed:
        if counts[k] <= 0:
            fail(f"{name}: kernel {k} was never launched")
    off = {f"{op}/{r}": n for (op, r), n in ops.ROUTES.items()
           if r not in ops.KERNEL_ROUTES and (op, r) not in allowed_off}
    if off:
        fail(f"{name}: off-kernel routes ran on the card: {off}")


DIFFUSION_KERNELS = ("qdq_conv2d", "w4a4_matmul", "w4a4_conv2d")
LM_KERNELS = ("w4a4_matmul", "kv4_store", "kv4_attend")


def serve(name: str, argv: list[str]) -> dict:
    """Phase 5: one launcher run with the counts set to 0 just before it
    and read just after, each K2/K3 launch tallied by shape on the way
    (the launcher raises on a non-finite x0)."""
    import torch
    from repro_torch.launch import serve_diffusion
    print(f"--- serve: {name}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recording_launches() as shapes:
        out = serve_diffusion.main(argv)
    counts = launch_counts()
    check_path(name, counts, DIFFUSION_KERNELS, set())
    check_shapes(name, shapes, counts)
    s = out["engine"]
    # the io sites: one qdq_conv2d each a forward, the standalone K1 never
    if counts["msfp_qdq"] or counts["qdq_conv2d"] != 2 * s["forwards"]:
        fail(f"{name}: {counts['qdq_conv2d']} qdq_conv2d and "
             f"{counts['msfp_qdq']} K1 launches over {s['forwards']} "
             "forwards, expected two qdq_conv2d a forward and no K1")
    print(f"serve {name}: {out['summary']['requests']} requests, "
          f"{out['summary']['requests'] / out['wall_s']:.3f} req/s, "
          f"{out['evals'] / out['wall_s']:.2f} denoise evals/s, "
          f"wall {out['wall_s']:.3f}s, bank hits/misses/builds "
          f"{s['bank_hits']}/{s['bank_misses']}/{s['bank_builds']}, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"launches {counts}, {len(shapes)} distinct K2/K3 shapes",
          flush=True)
    return {"counts": counts, "out": out, "units": s["forwards"],
            "unit": "forward", "shapes": shapes}


# the CUDA wrappers that phases 6 and 10 and the launch tally can replace:
# kernel name -> (module under repro_torch.kernels, wrapper's name there)
WRAPPERS = {"w4a4_matmul": ("w4_matmul", "w4_matmul_2d_cuda"),
            "w4a4_conv2d": ("conv", "w4a4_conv2d_implicit_cuda"),
            "qdq_conv2d": ("msfp_quant", "qdq_conv2d_cuda"),
            "msfp_qdq": ("msfp_quant", "msfp_qdq_2d_cuda")}


@contextlib.contextmanager
def wrapped_kernels(wraps: dict):
    """Each named kernel's CUDA wrapper f replaced by ``wraps[name](f)``
    while the context is open. A wrapper counts its launches under its
    module-level name, so the replacements take the counts over and hand
    them back."""
    import importlib
    swapped = []
    for name, wrap in wraps.items():
        module, attr = WRAPPERS[name]
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        f = getattr(mod, attr)
        r = wrap(f)
        r.launches = f.launches
        setattr(mod, attr, r)
        swapped.append((mod, attr, f, r))
    try:
        yield
    finally:
        for mod, attr, f, r in swapped:
            f.launches = r.launches
            setattr(mod, attr, f)


def shape_key(kernel: str, x, w, kw) -> tuple:
    """A K2/K3 call's shape: (m, k, n, dtype) for K2 (``w`` the pack),
    (b, hw, cin, cout, kh, stride) for K3 (``w`` the PackedW4)."""
    if kernel == "w4a4_matmul":
        return (kernel, (x.shape[0], x.shape[1], 2 * w.shape[1],
                         str(x.dtype)[6:]))
    b, h, wd, cin = x.shape
    stride = kw["stride"]
    if h != wd or stride[0] != stride[1] or kw["padding"] != "SAME":
        fail(f"conv shape {tuple(x.shape)} {stride} {kw['padding']} is not "
             "one phase 9 can rebuild")
    return (kernel, (b, h, cin, w.shape[3], w.shape[0], stride[0]))


@contextlib.contextmanager
def recording_launches():
    """Yields a Counter to which each K2/K3 launch on the card adds one
    under its kernel and shape (``shape_key``), where its wrapper counts
    the launch. The wrapper's own count follows each call, for code that
    holds the wrapper itself (the LM launcher's launches per step)."""
    tally = collections.Counter()

    def recorder(kernel):
        def wrap(f):
            def launch(x, w, *args, **kw):
                y = f(x, w, *args, **kw)
                f.launches = launch.launches
                tally[shape_key(kernel, x, w, kw)] += 1
                return y
            return launch
        return wrap

    with wrapped_kernels({k: recorder(k)
                          for k in ("w4a4_matmul", "w4a4_conv2d")}):
        yield tally


def check_shapes(name: str, shapes: collections.Counter, counts: dict):
    """The launches tallied by shape add up to the kernels' counts."""
    for kernel in ("w4a4_matmul", "w4a4_conv2d"):
        n = sum(c for (k, _), c in shapes.items() if k == kernel)
        if n != counts[kernel]:
            fail(f"{name}: {n} {kernel} launches tallied by shape against "
                 f"{counts[kernel]} counted")


def plain_kernels(names=("w4a4_matmul", "w4a4_conv2d", "qdq_conv2d")):
    """The named kernels (K2, K3 and the io sites' qdq_conv2d by default;
    K1 as ``msfp_qdq``) dispatch CUDA tensors to their plain versions (on
    the card) while the context is open."""
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    plain = {"w4a4_matmul": lambda *a, **kw: k2.w4_matmul_2d_plain(*a, **kw),
             "w4a4_conv2d":
                 lambda *a, **kw: k3.w4a4_conv2d_implicit_plain(*a, **kw),
             "qdq_conv2d": lambda *a, **kw: k1.qdq_conv2d_plain(*a, **kw),
             "msfp_qdq": lambda *a, **kw: k1.msfp_qdq_2d_plain(*a, **kw)}
    return wrapped_kernels({k: (lambda _, f=plain[k]: f) for k in names})


def io_composition():
    """The io sites run as the port ran them before qdq_conv2d, while the
    context is open: K1's snap (its CUDA kernel), the torch f32 conv
    (kernels/conv.py:conv2d_nhwc, cuDNN with TF32 off), the bias add."""
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1

    def old(x, w, act_qp, bias, *, padding="SAME"):
        if act_qp is not None:
            x = k1.msfp_qdq(x, act_qp)
        y = k3.conv2d_nhwc(x, w.to(x.dtype), stride=(1, 1), padding=padding)
        return y if bias is None else y + bias.to(y.dtype)
    return wrapped_kernels({"qdq_conv2d": lambda _: old})


def bf16_act_kernels():
    """A control fault: K2 and K3 snap their f32 acts after rounding them
    to bf16 (a tensor-core shortcut), while the context is open."""
    import torch

    def wrap(f):
        return lambda x, *a, **kw: f(
            x.bfloat16().float() if x.dtype == torch.float32 else x, *a,
            **kw)
    return wrapped_kernels({"w4a4_matmul": wrap, "w4a4_conv2d": wrap})


@contextlib.contextmanager
def tf32_allowed():
    """A control fault on the card only: TF32 allowed for f32 matmuls and
    convs (a common global setting). On the forward it reaches only the
    UNet attention's two products: every conv, the io sites' included, runs
    in the port's own kernels, which TF32 does not touch."""
    import torch
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def forward_diff(what: str, got, want) -> dict:
    """Relative Frobenius error and the share of elements off by more than
    1e-4 of max |want| (fails on a non-finite ``got``)."""
    import numpy as np
    g, w = got.double().numpy(), want.double().numpy()
    if not np.isfinite(g).all():
        fail(f"full-width forward ({what}) is not finite")
    rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    atol = 1e-4 * float(np.abs(w).max())
    off = float(np.mean(np.abs(g - w) > atol))
    print(f"forward ddim-cifar10 B={B}, {what}: relative Frobenius error "
          f"{rel:.3g}, max abs err {float(np.abs(g - w).max()):.3g}, "
          f"{off:.4%} of elements off by > {atol:.3g} (1e-4 of max |out| "
          f"{float(np.abs(w).max()):.3g})", flush=True)
    return {"rel_frobenius": rel, "frac_off": off}


# Phase 6's limits on a full-width forward: (relative Frobenius error,
# share of the elements off by more than 1e-4 of max |out|)
KERNEL_FORWARD_LIMIT = (1e-3, 0.01)   # kernels vs plain versions, on the card
CPU_FORWARD_LIMIT = (1e-2, 0.01)      # card vs CPU, dyadic weights


def within(d: dict, limit: tuple[float, float]) -> bool:
    return d["rel_frobenius"] <= limit[0] and d["frac_off"] <= limit[1]


def held_to(limit: tuple[float, float]) -> str:
    return (f" (held to relative Frobenius error <= {limit[0]:g} and at most "
            f"{limit[1]:.0%} off)")


def forward_checks(dev) -> dict:
    """Phase 6: full-width forwards at the main path's batch on the card
    against the same forwards through the plain versions on the CPU; then
    one profiled forward, for where the device time goes.

    On ``dyadic_unet_weights`` (every W4A4 sum exact in any order), held:
    each K2/K3 call of the forward bit-exact against the CPU plain
    version's output on the same inputs, each io-site call (qdq_conv2d:
    its bf16 weight makes no sum exact) within check_close; the forward
    through the kernels against the forward through the plain versions,
    both on the card, at KERNEL_FORWARD_LIMIT; the card's forward against
    the CPU's at CPU_FORWARD_LIMIT. The torch ops between the kernels
    (GroupNorm, SiLU, softmax) round differently on the two devices and
    flip a few E2M1 act ties, which 63 layers carry to the output (ROADMAP
    Queue C), so that limit sits between the sound reading and two control
    faults, each of which must exceed it: K2/K3 snapping bf16-rounded
    acts, and TF32 allowed on the card. Reported beside it: the card's
    forward with the io sites on their old composition (K1's snap, the
    cuDNN f32 conv, the bias add: qdq_conv2d's plain version) against the
    CPU's.

    On the random weights, held: each call within check_close of the CPU
    output, and a control must break that rule (one K3 call on its
    decoded weight rounded to bf16, as the Pallas kernel rounds it for bf16
    inputs). Reported, not held: the forward against the CPU's and against
    the plain versions on the card; the kernels' f32 sums run in an order
    of their own, which decides act ties throughout.

    An element counts as off when it differs by more than 1e-4 of the
    output's largest magnitude: the outputs of random weights are small
    (conv_out is initialised at scale 1e-5), so an absolute 1e-4 could
    never fail."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common.tree import flatten_paths
    from repro_torch.configs.diffusion_presets import ddim_cifar10
    from repro_torch.nn.unet import io_sites, unet_apply, unet_init
    from repro_torch.quant.calibrate import QuantContext
    from repro_torch.quant.fakequant import QuantizerParams
    from repro_torch.serving.replay import dyadic_unet_weights
    from repro_torch.serving.weight_bank import (_tree_to,
                                                 default_serving_plan,
                                                 pack_param_tree)
    cfg = ddim_cifar10()
    gen = torch.Generator().manual_seed(1)
    params = unet_init(gen, cfg, dev)
    weights = {k: v for k, v in flatten_paths(params).items()
               if k.endswith("/w") and v.ndim >= 2}
    packed, _ = pack_param_tree(params, default_serving_plan(
        weights, io_sites=io_sites(params)))
    dyadic = dyadic_unet_weights(params, weights)
    held, _ = pack_param_tree(dyadic, default_serving_plan(
        {k: v for k, v in flatten_paths(dyadic).items() if k in weights},
        io_sites=io_sites(params)))
    x = torch.randn(B, 32, 32, 3, generator=gen)
    ts = torch.arange(B, dtype=torch.float32) * 12.0

    def run(tree, device):
        ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0, device=device))})
        p = _tree_to(tree, device)
        with torch.inference_mode():
            return unet_apply(p, x.to(device), ts.to(device), cfg,
                              ctx=ctx).cpu()

    res = {}
    for kind, tree in (("dyadic", held), ("random", packed)):
        exact = kind == "dyadic"
        got = run(tree, dev)
        calls = []
        with recording_calls(calls):
            want = run(tree, torch.device("cpu"))
        r = res[kind] = {"calls_held": call_checks(dev, calls, exact)}
        with plain_kernels():
            ref = run(tree, dev)
        r["vs_card_plain"] = forward_diff(
            f"{kind} weights, kernels vs the plain versions, both on the card"
            + (held_to(KERNEL_FORWARD_LIMIT) if exact else " (not held)"),
            got, ref)
        r["vs_cpu"] = forward_diff(
            f"{kind} weights, card vs CPU plain"
            + (held_to(CPU_FORWARD_LIMIT) if exact else " (not held)"),
            got, want)
        if not exact:
            r["control_call"] = call_control(dev, calls)
            continue
        with plain_kernels(("qdq_conv2d",)):
            r["vs_cpu_io_composition"] = forward_diff(
                f"{kind} weights, card vs CPU plain, the io sites on their "
                "old composition (not held)", run(tree, dev), want)
        if not within(r["vs_card_plain"], KERNEL_FORWARD_LIMIT):
            fail("full-width forward through the kernels disagrees with "
                 "the forward through the plain versions")
        if not within(r["vs_cpu"], CPU_FORWARD_LIMIT):
            fail("full-width forward on the card disagrees with the CPU's")
        for name, fault in (("K2/K3 snap bf16-rounded acts",
                             bf16_act_kernels),
                            ("TF32 allowed on the card", tf32_allowed)):
            with fault():
                bad = run(tree, dev)
            d = r[f"control: {name}"] = forward_diff(
                f"{kind} weights, control fault ({name}), card vs CPU plain "
                "(must exceed the limit)", bad, want)
            if within(d, CPU_FORWARD_LIMIT):
                fail(f"control fault '{name}' stays within the card-vs-CPU "
                     "forward limit: the limit would not see it")
        del calls

    p_dev = _tree_to(packed, dev)
    ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
        0, 2, 1, 4, torch.tensor(6.0, device=dev))})
    xb, tb = x.to(dev), ts.to(dev)

    def fwd():
        with torch.inference_mode():
            return unet_apply(p_dev, xb, tb, cfg, ctx=ctx)

    def profiled():
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    # before: the io sites as the port ran them until qdq_conv2d (K1, the
    # torch f32 conv, the bias add); then as they run now
    with io_composition():
        prof, before_wall = profiled()
    before_busy, _ = device_time(prof)
    before = {"wall_ms": before_wall, "busy_ms": before_busy,
              "launches": kernel_launches(prof)}
    print(f"profile forward ddim-cifar10 B={B}, the io sites on their old "
          f"composition (K1 + torch f32 conv + bias add): wall "
          f"{before_wall:.3f} ms, device busy {before_busy:.3f} ms, "
          f"{before['launches']} CUDA kernel launches", flush=True)
    prof, wall_ms = profiled()
    busy_ms, top = device_time(prof)
    per_kernel = kernel_device_ms(prof)
    launches = kernel_launches(prof)
    print(f"profile forward ddim-cifar10 B={B}: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {launches} CUDA kernel launches, "
          f"K2 {per_kernel['w4a4_matmul']:.3f} ms, K3 "
          f"{per_kernel['w4a4_conv2d']:.3f} ms, io sites (qdq_conv2d) "
          f"{per_kernel['qdq_conv2d']:.4f} ms, K1 "
          f"{per_kernel['msfp_qdq']:.4f} ms", flush=True)
    for line in top:
        print(line, flush=True)
    res.update(profile_wall_ms=wall_ms, profile_device_busy_ms=busy_ms,
               profile_kernel_ms=per_kernel, profile_launches=launches,
               profile_io_composition=before)
    return res


# ---------------------------------------------------------------------------
# Phase 5, continued: the golden replay held card vs CPU, a full-width
# scenario run with obs on, and what obs costs.
# ---------------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "data" / "golden_trace.jsonl"
# The golden replay's x0, card vs CPU, on power-of-two weight scales,
# relative to the model's part of x0 (serving/replay.py:x0_error: x0 minus
# the eps-free x0 of the same x_T; the x_T part is some 1e4 times larger and
# sets x0's f32 resolution, so an element counts as off only above 4 ulps of
# itself as well). Derived as phase 6's limit was, between the sound reading
# and a control fault: on an NVIDIA H100 80GB HBM3 at 700.00 W the sound
# replay reads 0.0209 with 16.86% of elements off, and K2/K3 snapping
# bf16-rounded acts reads 0.287 with 99.56% off. Not phase 6's 1e-2 and 1%:
# the sampler's eps coefficients add up (all of one sign), so x0's model
# part carries its forwards' errors as they are, and the replay's forwards
# (t from 99 down on pure-noise x_T, batches of 1-4, each step's input
# carrying the last step's difference) differ card vs CPU by more than
# phase 6's single forward (0.002); each tick's eps error is printed. TF32
# in the attention products (phase 6's second control, 0.227 on a forward)
# reads 0.0299 with 34.46% off here: a reading, not held, too close to the
# sound reading to be a control.
REPLAY_X0_LIMIT = (5e-2, 0.4)


def write_requests_trace(path: str, n: int = 8, steps: int = 10) -> str:
    """``n`` ddim requests of ``steps`` steps, seeds 0..n-1, all arriving
    at t=0 (what the launcher's ``--requests`` meant before it became the
    scenario's count), written with the port's ``save_trace``."""
    from repro_torch.serving.traffic import TraceRequest, save_trace
    save_trace(path, [TraceRequest(arrival=0.0, steps=steps, seed=i, rid=i)
                      for i in range(n)],
               meta={"requests": n, "steps": steps, "arrival": 0.0})
    return path


def golden_setup(dyadic: bool):
    """ddim-cifar10 as ``launch/serve_diffusion.py --seed 0`` builds it
    (params, then the abs-max plan, hubs and router from the same
    generator), on the CPU, optionally on ``dyadic_unet_weights``. The
    bank merges each hub's B·A before packing; B is 0 in untrained hubs,
    which keeps the dyadic scales dyadic: checked here."""
    import torch
    from repro_torch.common.tree import flatten_paths
    from repro_torch.configs.diffusion_presets import ddim_cifar10
    from repro_torch.diffusion.schedule import make_schedule
    from repro_torch.launch.serve_diffusion import TALORA_CFG
    from repro_torch.nn.unet import io_sites, unet_init
    from repro_torch.serving import absmax_talora_setup
    from repro_torch.serving.replay import dyadic_unet_weights
    cfg = ddim_cifar10()
    gen = torch.Generator().manual_seed(0)
    params = unet_init(gen, cfg, "cpu")
    if dyadic:
        params = dyadic_unet_weights(params, {
            k: v for k, v in flatten_paths(params).items()
            if k.endswith("/w") and v.ndim >= 2})
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=io_sites(params))
    nonzero = sorted(k for k, h in hubs.items() if bool(h["B"].any()))
    if nonzero:
        fail(f"the launcher's hubs have B != 0 at {nonzero[:3]}: the bank's "
             "merge would move the weights off their scales")
    return cfg, make_schedule("linear", 100), params, plan, hubs, router


def golden_replay(setup, device, obs=None) -> dict:
    """The golden trace through an engine on ``device`` under the virtual
    clock, as the launcher runs it (max-batch 4, bank cap 4, E2M1 acts at
    maxval 6): serving/replay.py's record, plus the outcome digest and
    each tick's eps (on the CPU)."""
    import torch
    from repro_torch.launch.serve_diffusion import TALORA_CFG, outcome_digest
    from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
    from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                     WeightBank)
    from repro_torch.serving.replay import replay
    from repro_torch.serving.traffic import load_trace
    cfg, sched, params, plan, hubs, router = setup
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, sched.T,
                      max_cached=4, device=device)
    engine = DiffusionServingEngine(
        cfg, sched, bank, act_qps={"*": QuantizerParams(
            KIND_FP_SIGNED, 2, 1, 4, torch.tensor(6.0, device=device))},
        max_batch=4, clock=VirtualClock(), device=device, obs=obs)
    eps = []
    forward = engine._forward

    def logged(*a):
        out = forward(*a)
        eps.append(out.detach().to("cpu", copy=True))
        return out
    engine._forward = logged
    if obs is not None:
        obs.install_kernels()
    try:
        r = replay(engine, load_trace(str(GOLDEN))[0])
    finally:
        if obs is not None:
            obs.uninstall_kernels()
    r["digest"] = outcome_digest(engine.results)
    r["eps"] = eps
    return r


def eps_by_tick(card: dict, host: dict) -> list:
    """Each tick's eps, card vs CPU: relative Frobenius error (the ticks
    match one to one: their logs are identical)."""
    return [float((a.double() - b.double()).norm()
                  / max(float(b.double().norm()), 1e-30))
            for a, b in zip(card["eps"], host["eps"])]


def x0_line(what: str, d: dict) -> None:
    print(f"golden replay ddim-cifar10 x0, {what}: relative Frobenius "
          f"error {d['rel_frobenius']:.3g} of the model's part (rms "
          f"{d['model_part_rms']:.3g}; x0 rms {d['x0_rms']:.3g}), "
          f"{d['frac_off']:.4%} of elements off, max abs err "
          f"{d['max_abs_err']:.3g}", flush=True)


def replay_checks(dev, launcher_digest: str) -> dict:
    """Phase 5: the golden trace replayed at full width on the card and on
    the CPU from the same params, router, hubs and x_T (each request's,
    drawn on the host from its seed). Under the virtual clock the routing
    and the scheduler's decisions do not depend on numerics, so the tick
    log, the outcomes, the bank counters and x_T must be identical, on
    both weight sets. On dyadic_unet_weights x0 is held card vs CPU at
    REPLAY_X0_LIMIT, and a control fault (K2/K3 snapping bf16-rounded acts)
    must break it; TF32 allowed on the card is a reading; on the random
    weights the x0 error is a reading, and the card's replay must give the
    launcher's golden digest. Then the card replay again with obs on
    (tracer, registry and kernel profiler): tick log, outcomes and x0 must
    equal the replay with obs off. Every reading is printed before any
    limit is applied."""
    import torch
    from repro_torch.serving.obs import Observability
    from repro_torch.serving.replay import (eps_free_x0, replay_mismatches,
                                            x0_error)
    from repro_torch.serving.traffic import load_trace
    print("--- golden replay, card vs CPU", flush=True)
    res, runs = {}, {}
    cpu = torch.device("cpu")
    held = "K2/K3 snap bf16-rounded acts"
    controls = ((held, bf16_act_kernels),
                ("TF32 allowed on the card", tf32_allowed))
    for kind in ("dyadic", "random"):
        setup = golden_setup(kind == "dyadic")
        t0 = time.perf_counter()
        card = golden_replay(setup, dev)
        t1 = time.perf_counter()
        host = golden_replay(setup, cpu)
        t2 = time.perf_counter()
        bad = replay_mismatches(card, host)
        if bad:
            fail(f"golden replay ({kind} weights), card vs CPU: "
                 + "; ".join(bad))
        cfg = setup[0]
        base = eps_free_x0(load_trace(str(GOLDEN))[0], setup[1],
                           (1, cfg.image_size, cfg.image_size, cfg.in_ch))
        d = res[kind] = x0_error(card["x0"], host["x0"], base)
        print(f"golden replay ({kind} weights): tick log ({len(card['ticks'])}"
              f" ticks), outcomes, bank counters {card['bank']} and x_T "
              f"identical card vs CPU; card {t1 - t0:.1f}s, CPU "
              f"{t2 - t1:.1f}s", flush=True)
        x0_line(f"{kind} weights, card vs CPU" + (
            held_to(REPLAY_X0_LIMIT) if kind == "dyadic" else " (not held)"),
            d)
        d["eps_by_tick"] = eps_by_tick(card, host)
        print(f"golden replay ({kind} weights), each tick's eps card vs CPU, "
              "relative Frobenius error: "
              + ", ".join(f"{e:.3g}" for e in d["eps_by_tick"]), flush=True)
        runs[kind] = (setup, card)
        if kind == "random":
            continue
        for name, fault in controls:
            with fault():
                ctl = golden_replay(setup, dev)
            d[f"control: {name}"] = x0_error(ctl["x0"], host["x0"], base)
            x0_line(f"dyadic weights, control fault ({name}), card vs CPU "
                    + ("(must exceed the limit)" if name == held
                       else "(not held)"), d[f"control: {name}"])
    if not within(res["dyadic"], REPLAY_X0_LIMIT):
        fail("golden replay x0 on the card disagrees with the CPU's")
    if within(res["dyadic"][f"control: {held}"], REPLAY_X0_LIMIT):
        fail(f"control fault '{held}' stays within the golden replay's x0 "
             "limit: the limit would not see it")
    setup, card = runs["random"]
    if card["digest"] != launcher_digest:
        fail(f"golden replay digest {card['digest']} differs from the "
             f"launcher's {launcher_digest} on the same weights")
    obs = Observability()
    on = golden_replay(setup, dev, obs)
    bad = replay_mismatches(on, card)
    if bad or not all(torch.equal(on["x0"][r], card["x0"][r])
                      for r in card["x0"]):
        fail("golden replay on the card with obs on differs from obs off: "
             + ("; ".join(bad) or "x0 differs"))
    n_events = len(obs.tracer.events())
    if not n_events:
        fail("golden replay with obs on recorded no trace events")
    res["obs_on_off_identical"] = True
    print(f"golden replay on the card, obs on vs off: tick log, outcomes, "
          f"bank counters and x0 identical ({n_events} trace events with "
          "obs on)", flush=True)
    return res


TRACE_EVENTS = ("request", "admit", "eval", "tick", "forward", "bank_fetch")
# each diffusion kernel's (op, route) in the dispatch counts on the card
PROFILED_ROUTES = {"w4a4_matmul": ("w4a4_matmul", "cuda"),
                   "w4a4_conv2d": ("w4a4_conv2d", "cuda:implicit"),
                   "qdq_conv2d": ("conv2d", "cuda")}


def scenario_run(tmp: str) -> dict:
    """Phase 5: deadline_mix under the slo policy on the wall clock at full
    width, obs on (span trace, metrics text and report). Besides serve's
    checks: the profiler's route counts equal ops.ROUTES and each kernel's
    launch count; the trace loads and has the request lifecycle (submit,
    admit, eval, complete or expire), ticks, forwards and bank fetches;
    the report's summary is the collector's."""
    from repro_torch.kernels import ops
    paths = {k: f"{tmp}/deadline_mix.{k}" for k in ("trace.json",
                                                    "metrics.txt",
                                                    "report.json")}
    run = serve("deadline_mix, slo policy, wall clock, obs on", [
        "--preset", "ddim-cifar10", "--scenario", "deadline_mix",
        "--policy", "slo", "--device", "cuda",
        "--trace-out", paths["trace.json"],
        "--metrics-out", paths["metrics.txt"],
        "--report-json", paths["report.json"]])
    with open(paths["report.json"]) as f:
        report = json.load(f)
    routes = {f"{op}:{r}": n for (op, r), n in ops.ROUTES.items()}
    if report["kernel_routes"] != routes:
        fail(f"profiler route counts {report['kernel_routes']} != "
             f"ops.ROUTES {routes}")
    counts = run["counts"]
    for kernel, (op, r) in PROFILED_ROUTES.items():
        key = f"{op}:{r}"
        if routes.get(key, 0) != counts[kernel]:
            fail(f"profiler counted {routes.get(key, 0)} {key}, the kernel "
                 f"{counts[kernel]} launches")
    with open(paths["trace.json"]) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    missing = [n for n in TRACE_EVENTS if n not in names]
    ends = {e["args"].get("outcome") for e in events
            if e["name"] == "request" and e["ph"] == "e"}
    if (missing or not any(e["name"] == "request" and e["ph"] == "b"
                           for e in events) or not ends <= {"complete",
                                                            "expired"}
            or not ends):
        fail(f"span trace lacks {missing or 'a request begin or end'}")
    want = run["out"]["collector_summary"]
    got = {k: v for k, v in report["summary"].items()
           if k not in ("scenario", "wall_s")}
    if got != want:
        fail(f"report summary {got} != the collector's {want}")
    s = report["summary"]
    snap = report["obs"]
    dev_ms = {k: 1e3 * snap.get(f'kernel_call_seconds{{op="{op}",'
                                f'route="{r}"}}_sum', 0.0)
              for k, (op, r) in (("K2", PROFILED_ROUTES["w4a4_matmul"]),
                                 ("K3", PROFILED_ROUTES["w4a4_conv2d"]),
                                 ("qdq_conv2d",
                                  PROFILED_ROUTES["qdq_conv2d"]))}
    slo = report["slo"]
    out = {"goodput_frac": s["goodput_frac"], "p95_s": s["p95_s"],
           "slo_passed": slo["passed"], "expired": s["expired"],
           "evals_per_s": run["out"]["evals"] / run["out"]["wall_s"],
           "wall_s": run["out"]["wall_s"], "profiler_span_ms": dev_ms,
           "trace_events": len(events)}
    print(f"scenario deadline_mix (slo, wall clock, obs on): goodput "
          f"{s['goodput_frac']:.4f}, p95 {s['p95_s']:.4f} s, SLO "
          f"{'PASS' if slo['passed'] else 'FAIL'} "
          f"{ {k: c['actual'] for k, c in slo['checks'].items()} }, "
          f"{s['expired']} expired, {out['evals_per_s']:.2f} denoise "
          f"evals/s, profiler CUDA-event spans ms K2 {dev_ms['K2']:.3f}, K3 "
          f"{dev_ms['K3']:.3f}, qdq_conv2d {dev_ms['qdq_conv2d']:.4f}; "
          f"{len(events)} trace events", flush=True)
    run["scenario"] = out
    return run


def obs_overhead(trace: str, tmp: str) -> dict:
    """Phase 5: the 8 x 10 replay with obs off and on in turns (off, on,
    on, off); denoise evals/s of each, a reading with no limit (walls move
    by up to 40% between calls)."""
    from repro_torch.launch import serve_diffusion
    rates = {"off": [], "on": []}
    for i, mode in enumerate(("off", "on", "on", "off")):
        argv = ["--preset", "ddim-cifar10", "--trace", trace,
                "--max-batch", "8", "--device", "cuda"]
        if mode == "on":
            argv += ["--report-json", f"{tmp}/overhead{i}.json"]
        out = serve_diffusion.main(argv)
        rates[mode].append(out["evals"] / out["wall_s"])
    print(f"obs overhead, 8 x 10 replay (off, on, on, off): denoise evals/s "
          f"off {rates['off']}, on {rates['on']}", flush=True)
    return rates


def kv4_checks(dev) -> dict:
    """Phases 3 and 4 for K4/K5: bit-exact with the plain versions on the
    card (packed bytes, f16 scale bits, decoded bits), then timed. K4 at
    the decode step's (B*n_kv, hd) = (24, 64) and at (8192, 64); K5 over
    the serve phase's cache (B*s_max*n_kv, hd/2) = (1536, 32) and a
    2048-token one, (49152, 32). Both are elementwise: the bound counts
    20 f32 operations per element for K4 (as K1) and 8 for K5."""
    import torch
    from repro_torch.kernels import kv4 as k45
    gen = torch.Generator().manual_seed(3)
    rows = {"kv4_encode": [], "kv4_decode": []}

    def bits(v):
        return v.view(torch.int16) if v.element_size() == 2 else v.view(
            torch.int32)

    for r, hd in ((B * 3, 64), (8192, 64)):
        for dt in (torch.bfloat16, torch.float32):
            t = (torch.randn(r, hd, generator=gen)
                 * torch.rand(r, 1, generator=gen) * 4).to(dev, dt)
            t[0] = 0.0
            p, sc = k45.kv4_encode_2d_cuda(t)
            pp, sp = k45.kv4_encode_2d_plain(t)
            if not (torch.equal(p, pp) and torch.equal(bits(sc), bits(sp))):
                fail(f"kv4_encode ({r},{hd}) {dt}: not bit-exact "
                     f"({int((p != pp).sum())} bytes, "
                     f"{int((bits(sc) != bits(sp)).sum())} scales differ)")
            ms = cuda_ms(lambda: k45.kv4_encode_2d_cuda(t))
            plain_ms = cuda_ms(lambda: k45.kv4_encode_2d_plain(t))
            b_ms, b_by = bound(20.0 * r * hd, t.element_size() * r * hd
                               + r * hd // 2 + 2 * r, PEAK_F32_PER_S)
            rows["kv4_encode"].append(dict(
                shape=f"({r},{hd}) {str(dt)[6:]}", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
    for r, hh in ((B * 64 * 3, 32), (B * 2048 * 3, 32)):
        p = torch.randint(0, 256, (r, hh), generator=gen,
                          dtype=torch.uint8).to(dev)
        sc = (torch.rand(r, generator=gen) * 8).to(dev, torch.float16)
        for dt in (torch.float32, torch.bfloat16):
            got = k45.kv4_decode_2d_cuda(p, sc, dt)
            want = k45.kv4_decode_2d_plain(p, sc, dt)
            if not torch.equal(bits(got), bits(want)):
                fail(f"kv4_decode ({r},{hh}) {dt}: not bit-exact "
                     f"({int((bits(got) != bits(want)).sum())} differ)")
        ms = cuda_ms(lambda: k45.kv4_decode_2d_cuda(p, sc, torch.bfloat16))
        plain_ms = cuda_ms(
            lambda: k45.kv4_decode_2d_plain(p, sc, torch.bfloat16))
        b_ms, b_by = bound(8.0 * r * 2 * hh, r * hh + 2 * r + 2 * r * 2 * hh,
                           PEAK_F32_PER_S)
        rows["kv4_decode"].append(dict(
            shape=f"({r},{hh}) -> bf16", max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
    return rows


def kv4_pair_checks(dev) -> dict:
    """Phases 3 and 4 for the decode path's pair, on a cache of finite
    garbage (random codes, f16 scales in [0, 4)), 3 kv-heads x 3 query
    heads, hd 64. kv4_store at the serve shape (B 8, 64 slots), f32 and
    bf16: codes and f16 scale bits equal the plain version's after a store
    at slot 32, every other slot untouched; timed in bf16. kv4_attend held
    to kv4_attend_allowed at the serve shape (64 slots, 32 valid) in bf16
    and f32 with and without a softcap, and over 2048 slots, all valid, in
    bf16; timed in bf16 at both. Bounds: bytes (each input read once, only
    the valid slots of the cache, each output written once) or operations
    (the encode's 20 f32 an element as K4; attend's two products, 4 G x
    valid x hd a (batch, kv-head), at the bf16 tensor-core rate as
    ``bound`` prices products, beside 2 f32 a decoded K/V value, each
    counted once: a multiply and a rounding); the yardstick is
    F.scaled_dot_product_attention (enable_gqa) over the valid slots of a
    bf16 cache decoded beforehand, untimed: attention only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import kv4 as k45
    gen = torch.Generator().manual_seed(5)
    n_kv, g, hd = 3, 3, 64
    rows = {"kv4_store": [], "kv4_attend": []}

    def cache(slots):
        codes = (B, slots, n_kv, hd // 2)
        c = [torch.randint(0, 256, codes, generator=gen, dtype=torch.uint8),
             torch.randint(0, 256, codes, generator=gen, dtype=torch.uint8),
             (torch.rand(B, slots, n_kv, generator=gen) * 4).half(),
             (torch.rand(B, slots, n_kv, generator=gen) * 4).half()]
        return [x.to(dev) for x in c]

    def draw(*shape, dt):
        return (torch.randn(*shape, generator=gen) * torch.rand(
            *shape[:-1], 1, generator=gen) * 8).to(dev, dt)

    fp4 = cache(64)
    for dt in (torch.bfloat16, torch.float32):
        k_new, v_new = draw(B, n_kv, hd, dt=dt), draw(B, n_kv, hd, dt=dt)
        got, want = [x.clone() for x in fp4], [x.clone() for x in fp4]
        k45.kv4_store_cuda(k_new, v_new, *got, 32)
        k45.kv4_store_plain(k_new, v_new, *want, 32)
        diff = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                   for a, b in zip(got, want))
        if diff:
            fail(f"kv4_store B{B} S64 {dt}: not bit-exact ({diff} bytes "
                 "differ)")
        if dt != torch.bfloat16:
            continue
        ms = cuda_ms(lambda: k45.kv4_store_cuda(k_new, v_new, *got, 32))
        plain_ms = cuda_ms(
            lambda: k45.kv4_store_plain(k_new, v_new, *want, 32))
        n = 2 * B * n_kv
        b_ms, b_by = bound(20.0 * n * hd, 2 * n * hd + n * (hd // 2 + 2),
                           PEAK_F32_PER_S)
        rows["kv4_store"].append(dict(
            shape=f"B{B} S64 K{n_kv} hd{hd} bf16", max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))

    checks = {}
    cases = [(64, 32, torch.bfloat16, None), (64, 32, torch.bfloat16, 30.0),
             (64, 32, torch.float32, None), (64, 32, torch.float32, 30.0),
             (2048, 2048, torch.bfloat16, None)]
    for slots, valid, dt, softcap in cases:
        fp4 = cache(slots) if slots != 64 else fp4
        q = draw(B, n_kv, g, hd, dt=dt)
        args = (valid, hd ** -0.5, softcap)
        got = k45.kv4_attend_cuda(q, *fp4, *args)
        want = k45.kv4_attend_plain(q, *fp4, *args)
        allowed = k45.kv4_attend_allowed(q, *fp4, *args, want)
        diff = (got.double() - want.double()).abs()
        label = (f"B{B} S{slots} valid {valid} K{n_kv} G{g} hd{hd} "
                 f"{str(dt)[6:]}" + (f" softcap {softcap:g}" if softcap
                                     else ""))
        if bool((diff > allowed).any()):
            fail(f"kv4_attend {label}: {int((diff > allowed).sum())} "
                 f"elements outside kv4_attend_allowed (max abs err "
                 f"{float(diff.max()):.3g})")
        err = checks[label] = float(diff.max())
        print(f"kv4_attend {label}: max abs err {err:.3g}, largest share of "
              f"the allowance {float((diff / allowed).max()):.3g}",
              flush=True)
        if dt != torch.bfloat16 or softcap:
            continue
        ms = cuda_ms(lambda: k45.kv4_attend_cuda(q, *fp4, *args))
        plain_ms = cuda_ms(lambda: k45.kv4_attend_plain(q, *fp4, *args))
        keys, vals = (k45._decode_cache(c, sc, dt)[:, :valid].transpose(1, 2)
                      .contiguous() for c, sc in ((fp4[0], fp4[2]),
                                                  (fp4[1], fp4[3])))
        qs = q.reshape(B, n_kv * g, 1, hd)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, keys, vals, enable_gqa=True))
        b_ms, b_by = bound(
            4.0 * B * n_kv * g * valid * hd,
            2 * 2 * B * n_kv * g * hd + 2 * B * valid * n_kv * (hd // 2 + 2),
            f32_ops=2.0 * 2 * B * n_kv * valid * hd)
        rows["kv4_attend"].append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention(enable_gqa=True), "
                    "attention only, cache pre-decoded"))
    rows["kv4_attend"][0]["checks"] = checks
    return rows


LM_ARGV = ["--arch", "smollm-135m", "--quant", "w4", "--act-quant", "fp4",
           "--kv", "fp4", "--batch", str(B), "--prompt-len", "32",
           "--gen-len", "32", "--device", "cuda"]


def serve_lm() -> dict:
    """Phase 7: smollm-135m at full width (30 layers, random weights from
    the seed) through its launcher: W4A4 at every dense site, an FP4 KV
    cache, batch 8, 32 prompt tokens stepped in, 32 greedy tokens out.
    Only kernel routes may run, apart from the tied LM head's product;
    each K2 launch is tallied by shape as in ``serve``."""
    import torch
    from repro_torch.configs.smollm_135m import full
    from repro_torch.launch import serve
    print("--- serve: smollm-135m W4A4 FP4-KV", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recording_launches() as shapes:
        out = serve.main(LM_ARGV)
    counts = launch_counts()
    check_path("smollm-135m serve", counts, LM_KERNELS,
               {("tied_logits", "torch")})
    check_shapes("smollm-135m serve", shapes, counts)
    n_layers, per_step = full().n_layers, out["launches_per_step"]
    want = {"kv4_store": n_layers, "kv4_attend": n_layers, "kv4_encode": 0,
            "kv4_decode": 0}
    if any(per_step[k] != v for k, v in want.items()):
        fail(f"smollm-135m serve: launches per decode step {per_step}, "
             f"expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"serve smollm-135m: {out['tok_s']:.2f} tok/s decode at batch "
          f"{B}, prefill {out['prefill_s']:.3f}s, decode "
          f"{out['decode_s']:.3f}s, max_memory_allocated {peak:.1f} MiB, "
          f"launches {counts}", flush=True)
    return {"counts": counts, "tok_s": out["tok_s"], "peak_mib": peak,
            "launches_per_step": out["launches_per_step"],
            "units": out["steps"], "unit": "decode step", "shapes": shapes}


LM_LIMITS = {"float32": "relative Frobenius error <= 1e-3 and at most 1% "
                        "of the logits off by more than 1e-4 of max |logit|",
             "bfloat16": "relative Frobenius error <= 2e-2"}


def lm_checks(dev, steps: int = 4) -> dict:
    """Phase 8: smollm-135m at full width, W4A4 with the FP4 cache,
    ``steps`` teacher-forced decode steps at batch 8 through the kernels on
    the card and through the plain versions on the CPU (both sides in
    torch), in f32 and in bf16, each held to its limit (``LM_LIMITS``: the
    forward tolerance in f32, the JAX parity tests' bf16 limit in bf16).
    The held runs use ``steps.dyadic_weights``, so the W4A4 sums are exact
    and the kernels' arithmetic alone is compared; the same steps on the
    random weights are reported too (there the order of the sums decides
    FP4 and act-grid ties). Then one bf16 decode step of the serve
    configuration, timed without the profiler and then profiled
    (``launch/profile_decode.py``): the idle share is reported against both
    wall times, with the step's CUDA kernel launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.smollm_135m import full
    from repro_torch.launch.profile_decode import decode_step_profile
    from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import init_caches, lm_init
    from repro_torch.quant.calibrate import QuantContext
    from repro_torch.quant.fakequant import QuantizerParams
    from repro_torch.serving.weight_bank import _tree_to
    toks = torch.randint(0, full().vocab, (B, steps),
                         generator=torch.Generator().manual_seed(1))

    def run(cfg, packed, device):
        ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0, device=device))})
        p, step = _tree_to(packed, device), make_decode_fn(cfg, ctx=ctx)
        caches = init_caches(cfg, B, steps, device)
        out = []
        with torch.inference_mode():
            for i in range(steps):
                lg, caches = step(p, caches, toks[:, i:i + 1].to(device), i)
                out.append(lg.cpu())
        return torch.stack(out).double().numpy()

    res = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(full(), dtype=dt, kv_dtype="fp4")
        raw = lm_init(torch.Generator().manual_seed(0), cfg)
        dname = str(dt)[6:]
        for kind, params in (("dyadic", dyadic_weights(raw)), ("random", raw)):
            packed = quantize_lm_for_serving(params)
            g = run(cfg, packed, dev)
            w = run(cfg, packed, torch.device("cpu"))
            if not np.isfinite(g).all():
                fail(f"smollm-135m {dname} decode on the card ({kind} "
                     "weights) is not finite")
            rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
            atol = 1e-4 * float(np.abs(w).max())
            off = float(np.mean(np.abs(g - w) > atol))
            same = bool((g.argmax(-1) == w.argmax(-1)).all())
            per_step = [float(np.linalg.norm(g[i] - w[i])
                              / np.linalg.norm(w[i])) for i in range(steps)]
            print(f"decode smollm-135m {dname} W4A4 FP4-KV B={B}, {steps} "
                  f"teacher-forced steps, {kind} weights: card vs CPU plain: "
                  f"relative Frobenius error {rel:.3g}, max abs err "
                  f"{float(np.abs(g - w).max()):.3g}, {off:.4%} of logits "
                  f"off by > {atol:.3g} (1e-4 of max |logit|), argmax equal "
                  f"{same}, per step {' '.join(f'{e:.3g}' for e in per_step)}"
                  + (f"; held to {LM_LIMITS[dname]}" if kind == "dyadic"
                     else "; not held"), flush=True)
            res[f"{dname}_{kind}"] = {"rel_frobenius": rel, "frac_off": off,
                                      "argmax_equal": same,
                                      "per_step": per_step}
    f32, bf16 = res["float32_dyadic"], res["bfloat16_dyadic"]
    if f32["rel_frobenius"] > 1e-3 or f32["frac_off"] > 0.01:
        fail("full-width f32 decode on the card disagrees with the plain CPU "
             "decode")
    if bf16["rel_frobenius"] > 2e-2:
        fail("full-width bf16 decode on the card disagrees with the plain "
             "CPU decode")

    # one decode step of the serve configuration (bf16, B 8, 64-slot cache
    # half full): median of 10 unprofiled steps, then one profiled step
    prof = decode_step_profile(dataclasses.replace(full(), kv_dtype="fp4"), B,
                               64, 32, dev)
    _, top = device_time(prof.pop("prof"))
    per_kernel = kernel_ms(prof["kernels"])
    print(f"profile decode step smollm-135m B={B}: unprofiled wall "
          f"{prof['step_ms']:.3f} ms (median of 10; host CPU "
          f"{prof['cpu_ms']:.3f} ms), profiled wall "
          f"{prof['profile_wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share {prof['idle_share']:.3f} of "
          f"the unprofiled step ({prof['idle_share_profiled']:.3f} of the "
          f"profiled one), {prof['launches']} CUDA kernel launches; device "
          + ", ".join(f"{k} {v['ms']:.4f} ms x{v['launches']}"
                      for k, v in per_kernel.items()), flush=True)
    for line in top:
        print(line, flush=True)
    res.update(step_ms=prof["step_ms"], step_cpu_ms=prof["cpu_ms"],
               profile_wall_ms=prof["profile_wall_ms"],
               profile_device_busy_ms=prof["busy_ms"],
               idle_share=prof["idle_share"],
               idle_share_profiled=prof["idle_share_profiled"],
               kernel_launches=prof["launches"],
               profile_kernel_ms={k: v["ms"] for k, v in per_kernel.items()},
               profile_kernel_launches={k: v["launches"]
                                        for k, v in per_kernel.items()})
    return res


@contextlib.contextmanager
def recording_calls(calls: list):
    """Collect each K2/K3 and io-site call that reaches the plain versions
    (phase 6's CPU forwards) as (kernel, args, kwargs, output)."""
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    hooks = [(k2, "w4_matmul_2d_plain", "w4a4_matmul"),
             (k3, "w4a4_conv2d_implicit_plain", "w4a4_conv2d"),
             (k1, "qdq_conv2d_plain", "qdq_conv2d")]
    saved = [getattr(mod, attr) for mod, attr, _ in hooks]

    def recorder(f, kernel):
        def call(*args, **kw):
            y = f(*args, **kw)
            calls.append((kernel, args, kw, y))
            return y
        return call

    for (mod, attr, kernel), f in zip(hooks, saved):
        setattr(mod, attr, recorder(f, kernel))
    try:
        yield
    finally:
        for (mod, attr, _), f in zip(hooks, saved):
            setattr(mod, attr, f)


def call_control(dev, calls: list) -> int:
    """Phase 6's control on the call check: the first K3 call of the
    random-weight forward, recomputed on its decoded weight rounded to
    bf16 (the Pallas kernel's rule for bf16 inputs, which the port does
    not follow), must break check_close against the CPU output. Returns
    the number of elements outside the rule."""
    import torch
    from repro_torch.core.qmodule import decode_codes, unpack_nibbles
    from repro_torch.kernels import conv as k3
    from repro_torch.quant.fakequant import apply_qdq
    i, (_, args, kw, y) = next((i, c) for i, c in enumerate(calls)
                               if c[0] == "w4a4_conv2d")
    x, pw, aq = (a.to(dev) for a in args)
    if not pw.signed:
        fail("the control expects a signed weight (the main path's)")
    w = decode_codes(unpack_nibbles(pw.packed), pw.fmt, pw.scale, 0.0,
                     torch.float32).reshape(pw.shape)
    xq = apply_qdq(x, aq)
    bad = k3.conv2d_nhwc(xq, w.bfloat16().float(), **kw)
    mag = k3.conv2d_nhwc(xq.abs(), abs_weight(pw), **kw)
    n, err, _ = close_violations(bad, y.to(dev), mag,
                                 pw.shape[0] * pw.shape[1] * pw.shape[2])
    print(f"forward ddim-cifar10 B={B}, random weights, control fault (K3 "
          f"call {i} on its decoded weight rounded to bf16): {n} elements "
          f"outside check_close, max abs err {err:.3g}", flush=True)
    if n == 0:
        fail("a K3 call on bf16-rounded decoded weights passes check_close "
             "against the CPU: the call check would not see it")
    return n


def call_checks(dev, calls: list, exact: bool) -> int:
    """Each captured CPU call of phase 6 rerun through its kernel on the
    card and held against the CPU output: a K2/K3 call bit for bit where
    ``exact``, every call by check_close (an io call's bf16 weight makes
    no sum exact; how many of them matched bit for bit is printed); the
    card's plain version's largest difference from the CPU is printed
    beside the kernel's for scale. Returns the number of calls held."""
    import torch
    from repro_torch.common.device import no_tf32
    from repro_torch.core.qmodule import PackedW4
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    from repro_torch.quant.fakequant import apply_qdq, fp_qdq
    from repro_torch.quant.formats import FPFormat

    def to(v):
        if isinstance(v, tuple):
            return tuple(to(u) for u in v)
        return v.to(dev) if hasattr(v, "to") else v

    worst = {"w4a4_matmul": [0.0, 0.0], "w4a4_conv2d": [0.0, 0.0],
             "qdq_conv2d": [0.0, 0.0]}
    io_equal = 0
    for i, (kernel, args, kw, y) in enumerate(calls):
        a, want = to(args), y.to(dev)
        with no_tf32():
            if kernel == "qdq_conv2d":
                x, w, aq, _ = a
                got = k1.qdq_conv2d_cuda(*a, **kw)
                plain = k1.qdq_conv2d_plain(*a, **kw)
                xq = x if aq is None else apply_qdq(x, aq)
                mag = k3.conv2d_nhwc(xq.abs(), w.float().abs(),
                                     stride=(1, 1), **kw)
                k = w.shape[0] * w.shape[1] * w.shape[2]
                io_equal += int(torch.equal(got, want))
            elif kernel == "w4a4_matmul":
                x, packed, scale, zp, act = a
                got = k2.w4_matmul_2d_cuda(*a, **kw)
                plain = k2.w4_matmul_2d_plain(*a, **kw)
                xq = x if act is None else fp_qdq(
                    x, FPFormat(act[2], act[3], act[4]), act[0], act[1])
                pw = PackedW4(packed, scale, zp, kw["exp_bits"],
                              kw["man_bits"], kw["signed"],
                              (x.shape[1], 2 * packed.shape[1]))
                mag = xq.float().abs() @ abs_weight(pw)
                k = x.shape[1]
            else:
                x, pw, aq = a
                got = k3.w4a4_conv2d_implicit_cuda(*a, **kw)
                plain = k3.w4a4_conv2d_implicit_plain(*a, **kw)
                xq = x if aq is None else apply_qdq(x, aq)
                mag = k3.conv2d_nhwc(xq.abs(), abs_weight(pw), **kw)
                k = pw.shape[0] * pw.shape[1] * pw.shape[2]
        if exact and kernel != "qdq_conv2d" and not torch.equal(got, want):
            fail(f"{kernel} call {i} of the forward is not bit-exact with "
                 f"the CPU ({int((got != want).sum())} elements differ)")
        check_close(f"{kernel} call {i} of the forward vs the CPU", got, want,
                    mag, k)
        w = worst[kernel]
        w[0] = max(w[0], float((got - want).abs().max()))
        w[1] = max(w[1], float((plain - want).abs().max()))
    n_io = sum(c[0] == "qdq_conv2d" for c in calls)
    for kernel, (kern, plain) in worst.items():
        how = ("bit-exact" if exact and kernel != "qdq_conv2d"
               else "by check_close")
        print(f"forward ddim-cifar10 B={B}, {'dyadic' if exact else 'random'}"
              f" weights, every {kernel} call held {how} vs the CPU: "
              f"largest difference {kern:.3g} (the card's plain version: "
              f"{plain:.3g})"
              + (f"; {io_equal} of {n_io} bit for bit" if kernel ==
                 "qdq_conv2d" else ""), flush=True)
    if n_io != 2:
        fail(f"phase 6 recorded {n_io} io-site calls of the forward, not 2")
    return len(calls)


def path_shapes(dev, rows: dict, runs: dict, profiled: dict) -> dict:
    """Phase 9: every distinct K2/K3 shape that ``runs`` (path name ->
    phase 5 or 7 run, with its per-shape launch tally) launched on the
    card, checked signed and unsigned and timed as in phases 3-4 (shapes
    timed there are reused), with its launches per unit of the path (a
    forward or a decode step) and launches x ms; per path and kernel, the
    sum of launches x ms beside the device total of the path's profile."""
    import torch
    by_label = {r["shape"]: r for rs in rows.values() for r in rs}
    sums = {}
    for path, run in runs.items():
        for (kernel, key), count in sorted(run["shapes"].items(), key=str):
            if kernel == "w4a4_matmul":
                m, k, n, dt = key
                label = f"({m},{k})x({k},{n})" + (
                    " bf16" if dt == "bfloat16" else "")
                if label not in by_label:
                    by_label[label] = k2_row(dev, m, k, n,
                                             getattr(torch, dt))
                    rows[kernel].append(by_label[label])
            else:
                b, hw, cin, cout, kk, st = key
                label = f"{kk}x{kk} s{st} {hw}x{hw} {cin}->{cout}" + (
                    f" B{b}" if b != B else "")
                if label not in by_label:
                    by_label[label] = k3_row(dev, b, hw, cin, cout, kk, st)
                    rows[kernel].append(by_label[label])
            row = by_label[label]
            per_unit = count / run["units"]
            row.setdefault("launches_by_path", {})[path] = per_unit
            row.setdefault("launches_x_ms", {})[path] = per_unit * row["ms"]
            sums.setdefault(path, {}).setdefault(kernel, 0.0)
            sums[path][kernel] += per_unit * row["ms"]
    for rs in (rows["w4a4_matmul"], rows["w4a4_conv2d"]):
        for r in rs:
            lib = r["library_ms"]
            print(f"shape {r['shape']}: {r['ms']:.6f} ms (split {r['split']}),"
                  f" bound {r['bound_ms']:.6f} ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.6f}, library {lib:.6f}"
                  + (f", library_bf16 (bf16-rounded weight, a different "
                     f"rounding) {r['library_bf16_ms']:.6f}"
                     if "library_bf16_ms" in r else "")
                  + f", {lib / r['ms']:.2f}x the library's speed, "
                  f"launches {r.get('launches_by_path', {})}, launches x ms "
                  f"{r.get('launches_x_ms', {})}, max abs err "
                  f"{r['max_abs_err']:.3g} / unsigned "
                  f"{r['max_abs_err_unsigned']:.3g}", flush=True)
    for path, ks in sums.items():
        for kernel, total in ks.items():
            print(f"path {path}, per {runs[path]['unit']}: {kernel} sum of "
                  f"launches x ms {total:.4f} ms; profiled device total "
                  f"{profiled[path].get(kernel, 0.0):.4f} ms", flush=True)
    return sums


# ---------------------------------------------------------------------------
# Phase 10: the paper's pipeline at full width, and --plan search served.
# ---------------------------------------------------------------------------

PIPE_TRAIN_STEPS = 3   # DFA train steps at batch B, each loss printed
PIPE_SUBSET = 8        # sites a class whose search is held card vs CPU
PIPE_GAP_STEPS = 3     # eval_denoising_gap's trajectory
# One train step card vs CPU from the same state on power-of-two scales
# (msfp.pow2_plan): (limit on every finetune.step_errors reading, the
# control faults that must break it). With the act snaps on, the ulps of
# the torch ops between the exact products (GroupNorm, SiLU, softmax)
# differ by device and flip act-grid ties, as on phase 6's forward: the
# loss moves by 8e-4 and the worst leaf's gradient by 0.108 (an H100 80GB
# HBM3 at 700 W), TF32 in the backward drowns under that (0.1085), an STE
# without its clip mask reads 0.555 and the 'plain' loss 40: the limit sits
# between. K1 and qdq_conv2d on their plain versions on the card read the
# same 0.108, so the kernels add nothing to it. With the act sites off (the
# fake-quant weights alone) nothing ties, and the limit sits between the
# f32 sum orders and TF32.
CARD_STEP_LIMITS = {"acts on": (0.25, ("plain loss",
                                       "STE without its clip mask")),
                    "acts off": (1e-4, ("plain loss",
                                        "TF32 in the backward"))}


def _clock() -> float:
    import torch
    torch.cuda.synchronize()
    return time.perf_counter()


@contextlib.contextmanager
def counts_after_build():
    """The launcher's build (under --plan search the pipeline's FP forwards,
    which run qdq_conv2d on dense weights) is not the serve path: every
    kernel's launch count is set to 0 when the build returns, so serve()'s
    counts are the serve run's (the launcher resets its routes itself)."""
    from repro_torch.launch import serve_diffusion
    build = serve_diffusion.build_quantized

    def counted(*a, **kw):
        out = build(*a, **kw)
        for fn in kernel_fns().values():
            fn.launches = 0
        return out
    serve_diffusion.build_quantized = counted
    try:
        yield
    finally:
        serve_diffusion.build_quantized = build


def plan_serve_runs(trace: str) -> dict:
    """Phase 10: the 8 x 10 replay served on the abs-max plan and on the
    searched plan (--plan search: the pipeline, then the bank on the
    searched formats) in turns, absmax, search, absmax, search: each run
    through serve()'s checks (every kernel of the path launched, K2/K3 at
    every packed site, no off-kernel route, two qdq_conv2d a forward, no
    K1) and its evals/s."""
    out = {"absmax": [], "search": []}
    runs = {}
    for plan in ("absmax", "search", "absmax", "search"):
        with counts_after_build():
            run = serve(f"8 requests x 10 steps, --plan {plan}", [
                "--preset", "ddim-cifar10", "--trace", trace,
                "--max-batch", "8", "--device", "cuda", "--plan", plan])
        out[plan].append(run["out"]["evals"] / run["out"]["wall_s"])
        runs[plan] = run
    print(f"--plan search vs --plan absmax, 8 x 10 evals/s in turns "
          f"(absmax, search, absmax, search): {out['absmax'][0]:.2f}, "
          f"{out['search'][0]:.2f}, {out['absmax'][1]:.2f}, "
          f"{out['search'][1]:.2f}", flush=True)
    return {"evals_per_s": out, "search_run": runs["search"]}


def _cpu_mse_at(samples, qp) -> float:
    """The CPU's MSE of a site's samples at a (card's) pick."""
    import torch
    from repro_torch.quant import search
    from repro_torch.quant.fakequant import apply_qdq
    xs = search._subsample(samples, device="cpu")
    q = apply_qdq(xs, qp.to("cpu"), form="compiled")
    return float(((xs - q) ** 2).mean())


def held_subset(plan, weights, db, io) -> dict:
    """The card's searched plan against the CPU's on the same DB for a
    named subset: PIPE_SUBSET weight, NAL and AAL sites each, evenly spaced
    in name order, and every io site (the model has 4). Each pick equal,
    or a near-tie: the CPU's MSEs at the two picks within the f32 sum-order
    bound of the mean (search.tie_bound)."""
    from repro_torch.core import msfp
    from repro_torch.quant import search
    from repro_torch.quant.calibrate import CalibrationDB

    def spaced(names):
        names = sorted(names)
        step = max(1, len(names) // PIPE_SUBSET)
        return names[::step][:PIPE_SUBSET]

    w_names = [k for k in plan.weight_sites() if k not in io]
    acts = [k for k in plan.act_sites() if k not in io]
    classes = {"weight": spaced(w_names),
               "NAL act": spaced([k for k in acts
                                  if not plan.sites[k].is_aal]),
               "AAL act": spaced([k for k in acts if plan.sites[k].is_aal]),
               "io": sorted(k for k in plan.sites if k in io)}
    names = {k for v in classes.values() for k in v}
    sub_db = CalibrationDB(db.sample_cap)
    sub_db.sites = {k: s for k, s in db.sites.items() if k in names}
    t0 = time.perf_counter()
    host = msfp.build_mixed_plan(
        {k: w.cpu() for k, w in weights.items() if k in names}, sub_db,
        io_sites=io, device="cpu")
    cpu_s = time.perf_counter() - t0
    near = []
    for k in sorted(names):
        c, h = plan.sites[k], host.sites[k]
        pick = lambda s: (s.qp.kind, s.qp.exp_bits, s.qp.man_bits,  # noqa
                          s.qp.bits, float(s.qp.maxval),
                          float(s.qp.zero_point), s.is_aal)
        if pick(c) == pick(h):
            continue
        samples = weights[k] if c.is_weight else db.sites[k].samples
        a, b = _cpu_mse_at(samples, h.qp), _cpu_mse_at(samples, c.qp)
        n = min(samples.numel() if hasattr(samples, "numel")
                else samples.size, 1 << 16)
        if (c.is_aal != h.is_aal
                or abs(a - b) > search.tie_bound(n) * max(a, b)):
            fail(f"searched plan, site {k}: card picks {pick(c)}, CPU "
                 f"{pick(h)}; CPU MSEs {a!r} vs {b!r}, beyond a near-tie")
        near.append(k)
    print(f"searched plan card vs CPU on {len(names)} sites "
          f"({ {c: len(v) for c, v in classes.items()} }; CPU search "
          f"{cpu_s:.1f} s): {len(names) - len(near)} picks equal, "
          f"{len(near)} near-ties {near}; sites {classes}", flush=True)
    return {"sites": classes, "near_ties": near, "cpu_search_s": cpu_s}


def plan_format_checks(dev, plan, io) -> dict:
    """K1, qdq_conv2d, K2 and K3 against their plain versions at every
    (kind, exp, man) the searched plan holds: K1 bit-exact at (B*1024, 128)
    for every act format, in the serve form and the STE's folded one;
    qdq_conv2d at conv_in and conv_out for the io sites' act formats; K2
    at (2048,256)x(256,256) and K3 3x3 s1 16x16 256->256 for every 4-bit
    act format against every 4-bit weight format (each at a site's searched
    maxval and zp), by check_close."""
    import torch
    from repro_torch.core.qmodule import pack_weight
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    from repro_torch.quant.fakequant import (KIND_FP_SIGNED, QuantizerParams,
                                             apply_qdq)
    fmt = lambda qp: (qp.kind, qp.exp_bits, qp.man_bits, qp.bits)  # noqa
    acts, w4 = {}, {}
    for k, s in plan.sites.items():
        (w4 if s.is_weight else acts).setdefault(fmt(s.qp), (k, s.qp))
    w4 = {f: v for f, v in w4.items() if f[3] == 4}
    randn = _gen_randn(dev, 17)
    x = randn(B * 1024, 128, scale=2.0)
    for f, (_, qp) in acts.items():
        for folded in (False, True):   # the serve form, the STE's
            kw = dict(exp_bits=qp.exp_bits, man_bits=qp.man_bits,
                      signed=qp.kind == KIND_FP_SIGNED, folded=folded)
            got = k1.msfp_qdq_2d_cuda(x, qp.maxval, qp.zero_point, **kw)
            want = k1.msfp_qdq_2d_plain(x, qp.maxval, qp.zero_point, **kw)
            if not torch.equal(got, want):
                fail(f"msfp_qdq at the plan's act format {f} (folded "
                     f"{folded}): not bit-exact")
    xio = randn(B, 32, 32, 3, scale=2.0)
    for site, (cin, cout) in (("conv_in", (3, 128)), ("conv_out", (128, 3))):
        qp = plan.sites[site].qp
        xi = xio if cin == 3 else randn(B, 32, 32, 128)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(torch.bfloat16)
        bias = randn(cout, scale=0.1)
        got = k1.qdq_conv2d_cuda(xi, w, qp, bias)
        want = k1.qdq_conv2d_plain(xi, w, qp, bias)
        mag = k3.conv2d_nhwc(apply_qdq(xi, qp).abs(), w.float().abs(),
                             stride=(1, 1), padding="SAME")
        check_close(f"qdq_conv2d {site} at the plan's {fmt(qp)}", got, want,
                    mag, 9 * cin)
    xm = randn(2048, 256)
    xc = randn(B, 16, 16, 256)
    wm = randn(256, 256, scale=256 ** -0.5)
    wc = randn(3, 3, 256, 256, scale=(9 * 256) ** -0.5)
    n = 0
    for fw in w4:
        for fa, (_, aq) in acts.items():
            if fa[3] != 4:
                continue
            for w, xx in ((wm, xm), (wc, xc)):
                wq = QuantizerParams(fw[0], fw[1], fw[2], 4,
                                     w.abs().max().reshape(()))
                pw = pack_weight(w, wq)
                if w.ndim == 2:
                    act = (aq.maxval, aq.zero_point, aq.exp_bits,
                           aq.man_bits, aq.kind == KIND_FP_SIGNED)
                    kw = dict(exp_bits=pw.exp_bits, man_bits=pw.man_bits,
                              signed=pw.signed)
                    args = (xx, pw.packed, pw.scale, pw.zero_point, act)
                    got = k2.w4_matmul_2d_cuda(*args, **kw)
                    want = k2.w4_matmul_2d_plain(*args, **kw)
                    mag = apply_qdq(xx, aq).abs() @ abs_weight(pw)
                    check_close(f"w4a4_matmul weight {fw} act {fa}", got,
                                want, mag, 256)
                else:
                    kw = dict(stride=(1, 1), padding="SAME")
                    got = k3.w4a4_conv2d_implicit_cuda(xx, pw, aq, **kw)
                    want = k3.w4a4_conv2d_implicit_plain(xx, pw, aq, **kw)
                    mag = k3.conv2d_nhwc(apply_qdq(xx, aq).abs(),
                                         abs_weight(pw), **kw)
                    check_close(f"w4a4_conv2d weight {fw} act {fa}", got,
                                want, mag, 9 * 256)
                n += 1
    print(f"plan formats: act {sorted(acts)}, 4-bit weight {sorted(w4)}: K1 "
          f"bit-exact at each act format (serve and folded forms), "
          f"qdq_conv2d at both io formats, {n} K2/K3 checks within "
          f"check_close", flush=True)
    return {"act_formats": sorted(acts), "weight_formats": sorted(w4),
            "k2_k3_checks": n}


def conv_row(dev, hw: int, cin: int, cout: int, k: int) -> dict:
    """qdq_conv2d at an inner conv shape the FP teacher and the fake-quant
    student send it (B 8, f32 weight, a bias, acts off: quantize mode snaps
    in the STE first): checked by check_close, timed beside the plain
    version and F.conv2d alone (f32, TF32 off, on the input padded to NCHW
    beforehand), the bound as io_conv_row's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.common.device import no_tf32
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    randn = _gen_randn(dev, hw * 31 + cin + cout * 7 + k)
    x = randn(B, hw, hw, cin)
    w = randn(k, k, cin, cout, scale=(k * k * cin) ** -0.5)
    bias = randn(cout, scale=0.1)
    label = f"{k}x{k} {hw}x{hw} {cin}->{cout} B{B}, f32 weight, bias, acts off"
    got = k1.qdq_conv2d_cuda(x, w, None, bias)
    want = k1.qdq_conv2d_plain(x, w, None, bias)
    mag = k3.conv2d_nhwc(x.abs(), w.abs(), stride=(1, 1), padding="SAME")
    err = check_close(f"qdq_conv2d {label}", got, want, mag, k * k * cin)
    ms = cuda_ms(lambda: k1.qdq_conv2d_cuda(x, w, None, bias))
    plain_ms = cuda_ms(lambda: k1.qdq_conv2d_plain(x, w, None, bias))
    p = k // 2
    xn = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p)).contiguous()
    wn = w.permute(3, 2, 0, 1).contiguous()
    with no_tf32():
        lib_ms = cuda_ms(lambda: F.conv2d(xn, wn))
    m = B * hw * hw
    b_ms, b_by = bound(0.0, 4 * x.numel() + 4 * w.numel() + 4 * cout
                       + 4 * m * cout, f32_ops=2.0 * m * k * k * cin * cout)
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library="F.conv2d f32 (TF32 off) on the input padded to "
                        "NCHW beforehand: the conv alone")


@contextlib.contextmanager
def recording_io_shapes():
    """Yields a Counter of the (hw, cin, cout, k) of each qdq_conv2d launch
    while the context is open (the wrapper's own count kept)."""
    tally = collections.Counter()

    def wrap(f):
        def launch(x, w, *a, **kw):
            y = f(x, w, *a, **kw)
            f.launches = launch.launches
            tally[(x.shape[1], w.shape[2], w.shape[3], w.shape[0])] += 1
            return y
        return launch
    with wrapped_kernels({"qdq_conv2d": wrap}):
        yield tally


@contextlib.contextmanager
def ste_without_mask():
    """A control fault: the act STE passes the gradient everywhere (no clip
    mask), while the context is open."""
    from repro_torch.quant import fakequant
    orig = fakequant._SteQdq.backward
    fakequant._SteQdq.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        yield
    finally:
        fakequant._SteQdq.backward = orig


@contextlib.contextmanager
def tf32_backward():
    """A control fault: the train step runs with TF32 allowed; the
    forward's convs and products set it off around themselves, so it
    reaches the backward's convs and products only."""
    from repro_torch.train import finetune
    orig = finetune.no_tf32
    finetune.no_tf32 = tf32_allowed
    try:
        yield
    finally:
        finetune.no_tf32 = orig


def pipeline_phase(dev) -> dict:
    """Phase 10: the paper's pipeline on ddim-cifar10 at full width (random
    weights from seed 0, T 100): the calibration set at the reference's
    defaults (32 samples, 20 steps, batch 8), calibrate_activations,
    build_mixed_plan on the card (held against the CPU's on a named subset,
    held_subset), quantize_weight_tree, TALoRA attached (the paper's
    TALoRAConfig: h 2, rank 32), PIPE_TRAIN_STEPS DFA train steps at batch
    B along the teacher's trajectory (each loss printed; K1 and qdq_conv2d
    launches per step, no off-kernel oracle route), one step profiled
    (device busy, idle share, launches, peak memory), one step on
    power-of-two scales card vs CPU with the act sites on and off, each
    within its CARD_STEP_LIMITS between the control faults that must break
    it ('plain' loss, an STE without its clip mask, TF32 in the backward),
    beside two readings (TF32 in the backward with acts on, where act-grid
    ties drown it; K1 and qdq_conv2d on their plain versions on the card,
    the witness that the kernels add nothing to the tie flips),
    eval_denoising_gap at PIPE_GAP_STEPS
    steps, the kernels at the plan's formats (plan_format_checks) and
    qdq_conv2d at each inner shape a train step sends it (conv_row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common.tree import flatten_paths, unflatten_paths
    from repro_torch.configs.diffusion_presets import DIFFUSION_PRESETS
    from repro_torch.core import msfp, talora
    from repro_torch.diffusion import pipeline as pipe
    from repro_torch.diffusion.samplers import ddim_step
    from repro_torch.diffusion.schedule import make_schedule, sample_timesteps
    from repro_torch.kernels import ops
    from repro_torch.nn.unet import io_sites, unet_init
    from repro_torch.optim.adam import adam_init
    from repro_torch.train import finetune as ftm
    print("--- paper pipeline: ddim-cifar10 at full width", flush=True)
    t_phase = _clock()
    cfg = DIFFUSION_PRESETS["ddim-cifar10"]()
    sched = make_schedule("linear", 100)
    params = unet_init(torch.Generator().manual_seed(0), cfg, dev)
    io = io_sites(params)
    t0 = _clock()
    calib = pipe.build_calibration_set(params, cfg, sched, seed=0)
    t1 = _clock()
    db = pipe.calibrate_activations(params, cfg, calib)
    t2 = _clock()
    weights = {k: v for k, v in flatten_paths(params).items()
               if k.endswith("/w")}
    plan = msfp.build_mixed_plan(weights, db, io_sites=io, device=dev)
    t3 = _clock()
    summary = plan.summary()
    formats = collections.Counter(
        f"{'w' if s.is_weight else 'a'}:{s.qp.fmt.name}"
        for s in plan.sites.values())
    n_rec = len(db.sites) * min(8, len(calib))
    times = {"calibration_set_s": t1 - t0, "calibrate_s": t2 - t1,
             "calibrate_records": n_rec, "search_s": t3 - t2}
    print(f"pipeline: calibration set {len(calib)} states in {t1 - t0:.2f} "
          f"s; calibrate_activations {t2 - t1:.2f} s ({n_rec} records, one "
          f"device-to-host copy each); build_mixed_plan on the card "
          f"{t3 - t2:.2f} s: {summary}, formats {dict(formats)}", flush=True)
    subset = held_subset(plan, weights, db, io)

    def bundle_for(p):
        """The fake-quant tree under plan ``p``, the paper's TALoRA hubs
        and router attached (seed 0)."""
        flat = dict(flatten_paths(params))
        flat.update(msfp.quantize_weight_tree(weights, p))
        b = pipe.QuantizedDiffusion(cfg, sched, params, unflatten_paths(flat),
                                    p)
        return pipe.attach_talora(b, talora.TALoRAConfig(), seed=0)

    bundle = bundle_for(plan)
    ft = ftm.FinetuneConfig(batch=B)
    tr = {"hubs": bundle.hubs, "router": bundle.router}
    opt = adam_init(tr, ft.adam())
    gammas = sched.gamma()
    seq = sample_timesteps(sched.T, ft.steps_per_epoch)
    x = torch.randn((B, 32, 32, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recording_io_shapes() as io_shapes:
        for i, t in enumerate(seq[:PIPE_TRAIN_STEPS]):
            tb = torch.full((B,), float(t), device=dev)
            g = torch.full((B,), float(gammas[int(t)]), device=dev)
            s0 = _clock()
            tr, opt, loss, m = ftm.train_step(bundle, ft, tr, opt, x, tb, g,
                                              t_frac=float(t) / sched.T)
            step_s.append(_clock() - s0)
            losses.append(float(loss))
            print(f"train step {i + 1} (t {int(t)}): DFA loss "
                  f"{losses[-1]!r}, grad norm {float(m['grad_norm']):.4g}, "
                  f"{step_s[-1]:.3f} s", flush=True)
            x = ddim_step(sched, x, int(t), int(seq[i + 1]), m["eps_t"])
    counts = launch_counts()
    check_path("train steps", counts, ("msfp_qdq", "qdq_conv2d"),
               {("matmul", "torch_f32"), ("conv2d", "torch_f32")})
    routes = {f"{op}/{r}": n for (op, r), n in sorted(ops.ROUTES.items())}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    per_step = {k: v / PIPE_TRAIN_STEPS for k, v in counts.items() if v}
    if not all(math.isfinite(v) for v in losses):
        fail(f"train step losses not finite: {losses}")
    print(f"train steps: {PIPE_TRAIN_STEPS} at batch {B}, launches per step "
          f"{per_step}, routes {routes}, peak memory {peak_mib:.1f} MiB, "
          f"qdq_conv2d shapes (hw, cin, cout, k) per step "
          f"{ {k: v / PIPE_TRAIN_STEPS for k, v in io_shapes.items()} }",
          flush=True)
    train_run = {"counts": counts, "units": PIPE_TRAIN_STEPS,
                 "unit": "train step"}

    # one step profiled
    tb = torch.full((B,), float(seq[PIPE_TRAIN_STEPS]), device=dev)
    g = torch.full((B,), float(gammas[int(seq[PIPE_TRAIN_STEPS])]),
                   device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        ftm.train_step(bundle, ft, tr, opt, x, tb, g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - s0) * 1e3
    busy_ms, top = device_time(prof)
    per_kernel = kernel_device_ms(prof)
    launches = kernel_launches(prof)
    print(f"profile train step ddim-cifar10 B={B}: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {launches} CUDA kernel launches, "
          f"K1 {per_kernel['msfp_qdq']:.3f} ms, qdq_conv2d "
          f"{per_kernel['qdq_conv2d']:.3f} ms", flush=True)
    for line in top:
        print(line, flush=True)

    # one step card vs CPU on power-of-two scales, acts on and acts off,
    # each between its control faults (CARD_STEP_LIMITS)
    pow2 = msfp.pow2_plan(plan)
    xs = torch.randn((B, 32, 32, 3),
                     generator=torch.Generator().manual_seed(2))
    t_h = int(seq[2])

    def one_step(b, d, f=ft):
        tr0 = {"hubs": b.hubs, "router": b.router}
        o0 = adam_init(tr0, f.adam())
        tr1, o1, loss, m = ftm.train_step(
            b, f, tr0, o0, xs.to(d), torch.full((B,), float(t_h), device=d),
            torch.full((B,), float(gammas[t_h]), device=d),
            t_frac=t_h / sched.T)
        return dict(tr=tr1, opt=o1, loss=loss, grad_norm=m["grad_norm"],
                    grads=m["grads"], before=tr0)

    plain = ftm.FinetuneConfig(batch=B, loss_mode="plain")
    readings, host_s = {}, {}
    for acts, p in (("acts on", pow2), ("acts off", msfp.QuantPlan(
            {k: v for k, v in pow2.sites.items() if v.is_weight},
            pow2.bits_w, pow2.bits_a, pow2.mode))):
        pb = bundle_for(p)
        s0 = time.perf_counter()
        host = one_step(pb.to("cpu"), torch.device("cpu"))
        host_s[acts] = time.perf_counter() - s0
        limit, controls = CARD_STEP_LIMITS[acts]
        readings[acts] = {}
        for name, ctl, f in (
                ("sound", contextlib.nullcontext(), ft),
                ("plain loss", contextlib.nullcontext(), plain),
                ("STE without its clip mask", ste_without_mask(), ft),
                ("TF32 in the backward", tf32_backward(), ft),
                ("K1 and qdq_conv2d on their plain versions",
                 plain_kernels(("msfp_qdq", "qdq_conv2d")), ft)):
            with ctl:
                card = one_step(pb, dev, f)
            if name == "sound" and acts == "acts on":
                sound = card
            errs = ftm.step_errors(card, host, host["before"])
            readings[acts][name] = errs
            held = all(v <= limit for v in errs.values())
            role = ("sound" if name == "sound" else
                    "control" if name in controls else "reading")
            print(f"train step card vs CPU, power-of-two scales, {acts}, "
                  f"{name} ({role}): "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" ({'within' if held else 'beyond'} {limit})",
                  flush=True)
            if role != "reading" and held != (role == "sound"):
                fail(f"train step card vs CPU, {acts}, {name}: "
                     + ("beyond" if role == "sound" else "within")
                     + f" the limit {limit}: {errs}")
    gb = flatten_paths(sound["grads"])
    zero_b = [k for k in gb if k.endswith("/B") and not bool(gb[k].any())]
    if zero_b:
        fail(f"train step on the card: hubs with a zero B gradient {zero_b}")
    print(f"train step: every hub's B gradient nonzero on the card "
          f"({sum(k.endswith('/B') for k in gb)} hubs); the CPU steps took "
          f"{ {k: round(v, 1) for k, v in host_s.items()} } s", flush=True)

    bundle.hubs, bundle.router = tr["hubs"], tr["router"]
    gap = ftm.eval_denoising_gap(bundle, ft, steps=PIPE_GAP_STEPS, batch=B)
    if not math.isfinite(gap["final_image_mse"]):
        fail(f"eval_denoising_gap not finite: {gap}")
    print(f"eval_denoising_gap ({PIPE_GAP_STEPS} steps, batch {B}): final "
          f"image MSE {gap['final_image_mse']!r}, mean step gap "
          f"{gap['mean_step_gap']!r}, mean eps MSE {gap['mean_eps_mse']!r}",
          flush=True)

    fmts = plan_format_checks(dev, plan, io)
    rows = [conv_row(dev, hw, cin, cout, k)
            for (hw, cin, cout, k) in sorted(io_shapes)
            if cin > 3 and cout > 3]
    for r in rows:
        print(f"qdq_conv2d at the teacher's {r['shape']}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    wall = _clock() - t_phase
    print(f"pipeline phase wall {wall:.1f} s", flush=True)
    return {"times": times, "plan": summary, "formats": dict(formats),
            "subset": subset, "losses": losses, "step_s": step_s,
            "per_step": per_step, "routes": routes, "peak_mib": peak_mib,
            "profile": {"wall_ms": wall_ms, "busy_ms": busy_ms,
                        "idle_share": 1 - busy_ms / wall_ms,
                        "launches": launches, "kernel_ms": per_kernel},
            "card_vs_cpu": readings, "gap": {k: gap[k] for k in (
                "final_image_mse", "mean_step_gap", "mean_eps_mse")},
            "formats_checked": fmts, "io_rows": rows, "wall_s": wall,
            "train_run": train_run}


# a kernel's instances in a profile: K2/K3 carry their operand loader's
# name (split-K reduction included; K3's as the template argument
# "ConvA<", since qdq_conv2d's kernel takes a "ConvArgs"), the kv4
# kernels their own
KERNEL_KEYS = {"w4a4_matmul": "DenseA", "w4a4_conv2d": "ConvA<",
               "qdq_conv2d": "qdq_conv2d_kernel",
               "msfp_qdq": "msfp_qdq_kernel",
               "kv4_store": "kv4_store_kernel",
               "kv4_attend": "kv4_attend_kernel"}


def kernel_ms(rows: dict) -> dict:
    """Device ms and launches by kernel of ``rows`` (kernel name ->
    {"ms", "launches"}, as profile_decode gives them)."""
    out = {k: {"ms": 0.0, "launches": 0} for k in KERNEL_KEYS}
    for name, r in rows.items():
        for k, key in KERNEL_KEYS.items():
            if key in name:
                out[k]["ms"] += r["ms"]
                out[k]["launches"] += r["launches"]
    return out


def kernel_device_ms(prof) -> dict:
    """Device ms by kernel in a profile (``kernel_ms``)."""
    from repro_torch.launch.profile_decode import device_us, kernel_rows
    return {k: v["ms"] for k, v in kernel_ms(
        {e.key: {"ms": device_us(e) / 1e3, "launches": e.count}
         for e in kernel_rows(prof)}).items()}


def kernel_launches(prof) -> int:
    """The CUDA kernels a profile launched (memory copies and sets not
    counted), as launch/profile_decode.py counts a decode step's."""
    from repro_torch.launch.profile_decode import is_kernel, kernel_rows
    return sum(e.count for e in kernel_rows(prof) if is_kernel(e))


def device_time(prof, n_top: int = 8):
    """Device busy ms (kernel rows of the profile: an aten op's row repeats
    its kernels' device time) and the top kernels' lines."""
    from repro_torch.launch.profile_decode import device_us, kernel_rows
    evs = kernel_rows(prof)
    busy_ms = sum(device_us(e) for e in evs) / 1e3
    top = sorted(evs, key=device_us, reverse=True)[:n_top]
    return busy_ms, [f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                     f"{e.key[:90]}" for e in top]


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    built = build.build()
    print(f"built {built or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    rows = kernel_checks(dev)
    rows.update(kv4_checks(dev))
    rows.update(kv4_pair_checks(dev))
    for name, rs in rows.items():
        for r in rs:
            print(f"kernel {name} {r['shape']}: {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library "
                  f"{'-' if r['library_ms'] is None else '%.4f' % r['library_ms']}"
                  f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"max abs err {r['max_abs_err']:.3g}"
                  + (f", composition it replaces {r['composition_ms']:.4f} "
                     "ms" if "composition_ms" in r else ""), flush=True)

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    golden = serve("golden trace, virtual clock", [
        "--preset", "ddim-cifar10", "--trace", str(GOLDEN),
        "--replay-clock", "virtual", "--device", "cuda"])
    trace8 = write_requests_trace(f"{tmp}/requests_8x10.jsonl")
    wall = serve("8 requests x 10 steps, wall clock", [
        "--preset", "ddim-cifar10", "--trace", trace8,
        "--max-batch", "8", "--device", "cuda"])
    scenario = scenario_run(tmp)
    replayed = replay_checks(dev, golden["out"]["digest"])
    overhead = obs_overhead(trace8, tmp)
    fwd = forward_checks(dev)
    lm_serve = serve_lm()
    lm = lm_checks(dev)
    pipeline = pipeline_phase(dev)
    plan_runs = plan_serve_runs(trace8)
    tmp_dir.cleanup()
    rows["qdq_conv2d"].extend(pipeline["io_rows"])
    # each path's own launches, per forward (diffusion), per decode step
    # (LM: prompt steps and generated steps alike) or per train step
    paths = {"ddim-cifar10 golden trace": golden, "ddim-cifar10 8x10": wall,
             "ddim-cifar10 deadline_mix slo": scenario,
             "smollm-135m serve": lm_serve,
             "ddim-cifar10 8x10 --plan search": plan_runs["search_run"],
             "ddim-cifar10 train step": pipeline["train_run"]}
    by_path = {k: {name: {"launches": run["counts"][k],
                          f"per_{run['unit'].replace(' ', '_')}":
                              run["counts"][k] / run["units"]}
                   for name, run in paths.items() if run["counts"][k]}
               for k in golden["counts"]}
    launches = {k: sum(v["launches"] for v in by_path[k].values())
                for k in by_path}
    print("--- every main-path K2/K3 shape", flush=True)
    path_sums = path_shapes(
        dev, rows, {"ddim-cifar10 8x10": wall, "smollm-135m serve": lm_serve},
        {"ddim-cifar10 8x10": fwd["profile_kernel_ms"],
         "smollm-135m serve": lm["profile_kernel_ms"]})

    source = "src/repro_torch/kernels/csrc/"
    meta = {"msfp_qdq": (source + "msfp_quant.cu",
                         "src/repro/kernels/msfp_quant.py:55"),
            "qdq_conv2d": (source + "msfp_quant.cu",
                           "src/repro/kernels/msfp_quant.py:55"),
            "w4a4_matmul": (source + "w4_matmul.cu",
                            "src/repro/kernels/w4_matmul.py:240"),
            "w4a4_conv2d": (source + "conv.cu",
                            "src/repro/kernels/conv.py:232"),
            "kv4_encode": (source + "kv4.cu",
                           "src/repro/kernels/kv4.py:65"),
            "kv4_decode": (source + "kv4.cu",
                           "src/repro/kernels/kv4.py:86"),
            "kv4_store": (source + "kv4.cu", "src/repro/kernels/kv4.py:65"),
            "kv4_attend": (source + "kv4.cu", "src/repro/kernels/kv4.py:86")}
    kernels = []
    for name, rs in rows.items():
        head = rs[0]        # the first main path's shape of this kernel
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "launches_by_path": by_path[name],
            "max_abs_err": max(max([r["max_abs_err"],
                                    *r.get("checks", {}).values()])
                               for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rs})
    for k in kernels:
        for v in (k["ms"], k["plain_ms"], k["bound_ms"]):
            if not (isinstance(v, float) and math.isfinite(v) and v > 0):
                fail(f"kernel {k['name']}: bad timing {v}")
    print(json.dumps({"kernels": kernels,
                      "serve": {"golden_digest": golden["out"]["digest"],
                                "wall_req_per_s": wall["out"]["summary"][
                                    "requests"] / wall["out"]["wall_s"],
                                "wall_evals_per_s": wall["out"]["evals"]
                                / wall["out"]["wall_s"],
                                "deadline_mix": scenario["scenario"],
                                "golden_replay": replayed,
                                "obs_overhead_evals_per_s": overhead},
                      "forward": fwd, "launches_x_ms": path_sums,
                      "pipeline": {k: v for k, v in pipeline.items()
                                   if k not in ("train_run", "io_rows")},
                      "plan_evals_per_s": plan_runs["evals_per_s"],
                      "lm": {"tok_s": lm_serve["tok_s"],
                             "peak_mib": lm_serve["peak_mib"],
                             "launches_per_step":
                                 lm_serve["launches_per_step"], **lm}}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
