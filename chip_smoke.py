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
     softmax plus one ulp of the load dtype); K2's weight-only mode
     (act=None) at the gateway LM's batch-1 shapes in bf16 by check_close;
     phase 12's new shapes: K1 on bf16 (8, 2560) and (8, 5120) acts
     (bit-exact), K2 at zamba2's in_proj (8,2560)x(2560,10448) and
     out_proj and at llama4-scout's expert products (weight-only),
     kv4_store and kv4_attend at zamba2's, llama4-scout's and gemma3-4b's
     heads (hd 80, 128, 256; KV4_HEADS);
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
  9. every distinct K2/K3 shape launched by the 8 x 10 run of phase 5,
     the serve run of phase 7, phase 12's four serve runs and phase 13's
     eight prefill runs, every K2 shape (either mode) of phase 11's
     mixed_model run and every K2 shape of phase 15(b)'s gemma3-4b
     decode_32k cell at M 128 (this phase runs after phase 15), checked
     signed and unsigned by check_close and timed as in phases 3-4, with
     its launches per forward / per decode step in those runs and
     launches x ms, and per path the sum of launches x ms beside the K2/K3
     device totals of the phase 6, 8, 12, 13 and 15(b) profiles;
  10. the paper's pipeline on ddim-cifar10 at full width (pipeline_phase:
     calibration, the MSFP search on the card held against the CPU's on a
     named subset, TALoRA + DFA train steps with K1 and qdq_conv2d
     launching under autograd, one step profiled, one step card vs CPU
     between its control faults, beside readings with TF32 in the
     backward and with K1 and qdq_conv2d on their plain versions,
     eval_denoising_gap, the kernels at the
     plan's formats), then the 8 x 10 replay on --plan absmax and --plan
     search in turns, each through serve()'s checks;
  11. the multi-model gateway and the fleet router at full width
     (gateway_phase): (a) the golden trace under the virtual clock through
     a one-model gateway hosting ddim-cifar10 and a one-replica
     round-robin fleet, each digest equal to phase 5's, and the
     serve_fleet launcher at its own preset (tiny-ddim, 16) equal to
     serve_diffusion's there; (b) ddim-cifar10 and smollm-135m (full
     config: 30 layers, bf16, W4 abs-max, acts off, bf16 KV cache) behind
     one gateway: mixed_model (8 requests, the mix's model names renamed
     to the entries') under the virtual clock on the card and on the CPU
     from the same seed, tick logs, outcomes and bank counters identical,
     the LM's tokens and the diffusion x0 card vs CPU as readings, K2 in
     both modes (W4A4 at the UNet's dense sites, weight-only at the LM's,
     7 a layer and decode step), K3 and qdq_conv2d launched, only the tied
     LM head off the kernels; then per_model_slo under the slo policy on
     the wall clock (per-model goodput, p95, SLO verdict, evals/s, tok/s,
     every bank reconciled); (c) two ddim-cifar10 replicas behind one
     fleet router on the wall clock: deadline_mix at the fleet bench's
     shaping (6 req/s, steps jitter 4, max-batch 4, bank cap 6; its 20
     requests cut to FLEET_REQUESTS = 10 to keep both runs near a minute),
     round robin then segment affinity (pooled hit rate, goodput, p95,
     builds, placements, each replica's bank reconciled; both replicas
     share the one card, so this shows placement, not scaling);
  12. every LM family's decode at full width (family_phase): (a)
     zamba2-2.7b (hybrid, all 54 layers), mamba2-370m (ssm, all 48),
     gemma3-4b (first_k_dense and ring layers, all 34) and
     llama4-scout-17b-a16e (moe, full width, depth cut to LLAMA4_DEPTH of
     48 layers, printed as ``reduced``) through launch/serve.py (W4
     abs-max, E2M1 acts, FP4 cache where there is attention, batch 8, 32 +
     32 tokens): each shows FAMILY_LAUNCHES per decode step (K2 by mode,
     kv4_store, kv4_attend, K1), no off-kernel route beyond the tied
     readout or an untied head's and the router's f32 products; tok/s,
     prefill and decode seconds and peak memory printed; (b) teacher-forced
     steps card vs CPU on power-of-two scales (zamba2 in f32 and bf16,
     llama4-scout at depth 1 in f32), each between its sound reading and
     control faults (FAMILY_CHECKS), and the kernels against their plain
     versions on the card (KERNELS_VS_PLAIN_LIMIT); (c) one bf16 decode
     step of zamba2 and of llama4-scout profiled (busy, idle share,
     launches, top kernels, K2's device ms by mode); the phase's wall
     printed;
  13. the LM full-sequence forward and training at full width
     (prefill_train_phase): (a) smollm-135m (B 8 x S 2048), zamba2-2.7b (B
     4 x S 2048), gemma3-4b (B 2 x S 2048, across its 1024-token window)
     and llama4-scout (LLAMA4_DEPTH layers, B 8 x S 512), W4 abs-max, bf16:
     one forward under a serve context (E2M1 acts: W4A4 K2, K1 before an
     untied head) and one make_prefill_step call (weight-only K2), each
     with PREFILL_LAUNCHES a forward, no off-kernel route beyond the dense
     products, then timed and profiled (wall, prefill tokens/s, busy, idle
     share, peak memory); (b) the forward card vs CPU in f32 on
     power-of-two scales (smollm W4A4 at 2 layers, zamba2 W4A4 and
     weight-only at one group with its weights 2^-3 smaller and 16-step
     SSD chunks, B 2 x S 256), each between its sound reading and two
     control faults (PREFILL_CHECKS), every K2 and K1 launch of the card's
     forward held against its plain version, and the CPU's ulp
     sensitivity within ULP_SHARE of the limit; (c) launch/train.py at full width (TRAIN_RUNS:
     smollm-135m 8 steps, checkpoints every 4, and mamba2-370m 4 steps):
     finite losses, no contained crash, smollm's resumed run (4 steps, the
     launcher restarted to 8) equal to the uninterrupted one bit for bit
     (losses, parameters, Adam state; the token stream restarted must
     break it), one step of the launcher's step function profiled
     meshless; (d) five steps on a fixed batch
     lower smollm's loss, and one f32 loss and gradient card vs CPU
     (TRAIN_*_LIMIT) which TF32 in the backward must break. Phases 3-4
     hold and time K2 at the prefill shapes in both modes and K1 at (B x S,
     d_model);
  14. the distribution layer on a 1-rank NCCL mesh at full width
     (mesh_phase; the process group is made once after the build, since
     the train and serve launchers run on a mesh from phase 7 on, and
     destroyed at the end): (a) smollm-135m (B 8 x S 512, 4 steps) through
     launch/train.py, parameters and batches DTensors, against the
     meshless make_train_step on plain tensors from the same seed: every
     loss, parameter and Adam moment bit for bit, both step walls printed;
     (b) smollm-135m served through launch/serve.py under the host mesh
     (phase 7's setting) against the same run meshless: token ids and the
     K2, kv4_store and kv4_attend launches a step identical; (c)
     llama4-scout (LLAMA4_DEPTH layers, bf16 weights drawn on the card, B 8
     x S 512): one forward with moe_impl "ep" (the all-to-all over the
     model axis) against "global", logits bit for bit; (d) phase 13(c)'s
     resume, bit for bit; the phase's wall printed;
  15. the dry run and the long cache (dryrun_phase): (a) three production
     cells at full width and depth over fake worlds, each a
     ``python -m repro_torch.launch.dryrun`` process under the card
     machine's torch (gemma3-4b decode_32k single W4/FP4, smollm-135m
     train_4k single, llama4-scout prefill_32k multi W4 moeep), each
     record ``ok``, its per-device bytes against the card's 80 GB, flops
     and collective bytes printed; (b) gemma3-4b decode_32k (W4 abs-max
     under E2M1 acts, FP4 cache, B 128, S 32768, 34 layers) whole on the
     card on the 1-rank mesh against the dry run's record for the same
     cell on a 1-rank fake world: the arguments' bytes equal the
     prediction's leaf by leaf (rounded to the allocator's 512 B), the
     caches filled through kv4_store, three decode steps each within
     PEAK_LIMIT (2 MiB) of the predicted step peak, which the prediction through
     the plain routes must break, the launches a step (K2 W4A4 238,
     kv4_store and kv4_attend 34, K1 1), the walls and a profiled step's
     busy time; (c) kv4_attend past one block's shared memory
     (KV4_LONG, the logits in the global workspace) held to
     kv4_attend_allowed, bit for bit to its plain version summed in the
     kernel's order, and timed beside SDPA and the bound, and at 2048
     slots the two paths' bits equal; (d) gemma3-4b over a 32768-slot
     cache, 3 teacher-forced steps at batch 8 from each of three seeds'
     caches and tokens, every launch of the first held against its plain
     version, the logits against the plain versions' with kv4_attend's
     summed in the kernel's order within KERNELS_VS_PLAIN_LIMIT (1e-5, as
     phase 12), and against the plain versions as they stand (cuBLAS's sum
     order) read (a control, kv4_attend one slot short, breaks the holds
     and the limit);
  16. a ``kernels`` JSON line (each kernel's launches in all and per path:
     per forward for ddim-cifar10, per decode step for smollm-135m and
     phase 12's models, per train step for the pipeline, per forward or
     decode step by model for the gateway's mixed_model run, per forward
     for the fleet's runs, phase 13's prefill runs, phase 14's meshed
     decode and phase 15's cell), the card line, and the result line.
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


def k2_row(dev, m: int, k: int, n: int, dt, act: bool = True) -> dict:
    """K2 at (m, k) x (k, n) in ``dt``: checked signed (E2M1 weight, E2M1
    acts at maxval 6, the main path) and unsigned (per-channel uE2M2
    weight with a zero-point, uE2M2 acts), then the signed case timed
    beside the plain version, the f32 library product (TF32 off) and, for
    bf16, the bf16 product of the bf16-rounded dequantized weight (a
    different rounding, reported only). ``act=False``: the weight-only
    mode (``act=None``, the gateway LM's path), both weights with acts
    off."""
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
    label = k2_label(m, k, n, str(dt)[6:], act)
    row = None
    for i, (wq, aq) in enumerate(cases):
        pw = pack_weight(w, wq)
        if not act:
            aq = None
        a = None if aq is None else (aq.maxval, aq.zero_point, aq.exp_bits,
                                     aq.man_bits, aq.kind == 0)
        args = (x, pw.packed, pw.scale, pw.zero_point, a)
        kw = dict(exp_bits=pw.exp_bits, man_bits=pw.man_bits,
                  signed=pw.signed)
        got = k2.w4_matmul_2d_cuda(*args, **kw)
        wd = dequant_weight(pw, torch.float32)
        with no_tf32():
            want = k2.w4_matmul_2d_plain(*args, **kw)
            xq = x if aq is None else apply_qdq(x, aq)
            mag = xq.float().abs() @ abs_weight(pw)
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


def k2_label(m: int, k: int, n: int, dtype: str, act: bool) -> str:
    return (f"({m},{k})x({k},{n})" + (" bf16" if dtype == "bfloat16" else "")
            + ("" if act else " weight-only"))


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


def k1_bf16_row(dev, m: int, n: int) -> dict:
    """K1 on bf16 (m, n) acts, signed E2M1 at maxval 6 (the snap before an
    untied LM head): bit-exact against its plain version, then timed."""
    import torch
    from repro_torch.kernels import msfp_quant as k1
    x = _gen_randn(dev, m * 31 + n)(m, n, scale=2.0).to(torch.bfloat16)
    q = _qp(dev, True, 6.0)
    kw = dict(exp_bits=q.exp_bits, man_bits=q.man_bits, signed=True)
    args = (x, q.maxval, q.zero_point)
    got = k1.msfp_qdq_2d_cuda(*args, **kw)
    want = k1.msfp_qdq_2d_plain(*args, **kw)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        fail(f"msfp_qdq ({m},{n}) bf16: not bit-exact "
             f"({int((got != want).sum())} elements differ)")
    ms = cuda_ms(lambda: k1.msfp_qdq_2d_cuda(*args, **kw))
    plain_ms = cuda_ms(lambda: k1.msfp_qdq_2d_plain(*args, **kw))
    b_ms, b_by = bound(20.0 * m * n, 2 * 2 * m * n, PEAK_F32_PER_S)
    return dict(shape=f"({m},{n}) bf16", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# phase 13's prefill shapes for phases 3-4 (see kernel_checks)
PREFILL_K2_SHAPES = ((16384, 576, 576), (16384, 576, 192),
                     (16384, 576, 1536), (16384, 1536, 576),
                     (8192, 2560, 10448), (8192, 5120, 2560),
                     (320, 5120, 8192), (320, 8192, 5120))
PREFILL_K1_SHAPES = ((8192, 2560), (4096, 2560), (4096, 5120))


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

    # K1 as the LM path runs it: the standalone snap of the bf16 acts
    # before an untied lm_head (phase 12: zamba2 and gemma3-4b at d_model
    # 2560, llama4-scout at 5120), signed E2M1 at maxval 6
    for m, n in ((B, 2560), (B, 5120)):
        rows["msfp_qdq"].append(k1_bf16_row(dev, m, n))

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
    # K2's weight-only mode (act=None) at the gateway LM's batch-1 decode
    # (smollm-135m, bf16, acts off): up/gate, down, and q/o projections
    for m, k, n in ((1, 576, 1536), (1, 1536, 576), (1, 576, 576)):
        rows["w4a4_matmul"].append(k2_row(dev, m, k, n, torch.bfloat16,
                                          act=False))
    # phase 12's new shapes at batch B in bf16: zamba2's in_proj (N/2 =
    # 5224, no multiple of 16: the weight's non-vector load) and out_proj
    # (W4A4); llama4-scout's expert gate/up and down (weight-only)
    for m, k, n, act in ((B, 2560, 10448, True), (B, 5120, 2560, True),
                         (B, 5120, 8192, False), (B, 8192, 5120, False)):
        rows["w4a4_matmul"].append(k2_row(dev, m, k, n, torch.bfloat16,
                                          act=act))

    # phase 13's prefill shapes, M = B x S rows, bf16, in both K2 modes:
    # smollm-135m at B 8 x S 2048 (q/o, k/v, gate/up, down), zamba2-2.7b's
    # in_proj and out_proj at B 4 x S 2048, llama4-scout's expert products
    # over capacity(4096) = 320 rows
    for m, k, n in PREFILL_K2_SHAPES:
        for act in (True, False):
            rows["w4a4_matmul"].append(k2_row(dev, m, k, n, torch.bfloat16,
                                              act=act))
    # K1 before an untied head in a prefill forward: (B x S, d_model) bf16
    # (zamba2-2.7b at B 4 x S 2048, gemma3-4b at B 2 x S 2048, llama4-scout
    # at B 8 x S 512); every other prefill K2 shape in phase 9
    for m, n in PREFILL_K1_SHAPES:
        rows["msfp_qdq"].append(k1_bf16_row(dev, m, n))

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


def driven(name: str, drive, needed, allowed_off=frozenset()) -> dict:
    """``drive()`` with the counts set to 0 just before it and read just
    after, each K2/K3 launch tallied by shape and mode; every kernel of
    ``needed`` must launch and no other off-kernel route run."""
    reset_counts()
    with recording_launches() as shapes:
        out = drive()
    counts = launch_counts()
    check_path(name, counts, needed, allowed_off)
    check_shapes(name, shapes, counts)
    return {"counts": counts, "shapes": shapes, "out": out}


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
    run = driven(name, lambda: serve_diffusion.main(argv), DIFFUSION_KERNELS)
    out, counts, shapes = run["out"], run["counts"], run["shapes"]
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
            "msfp_qdq": ("msfp_quant", "msfp_qdq_2d_cuda"),
            "kv4_store": ("kv4", "kv4_store_cuda"),
            "kv4_attend": ("kv4", "kv4_attend_cuda")}


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


def shape_key(kernel: str, x, w, args, kw) -> tuple:
    """A K2/K3 call's shape: (m, k, n, dtype, acts on) for K2 (``w`` the
    pack; its act tuple, or None in the weight-only mode, follows the
    scale and zero-point), (b, hw, cin, cout, kh, stride) for K3 (``w``
    the PackedW4)."""
    if kernel == "w4a4_matmul":
        act = args[2] if len(args) > 2 else kw.get("act")
        return (kernel, (x.shape[0], x.shape[1], 2 * w.shape[1],
                         str(x.dtype)[6:], act is not None))
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
                tally[shape_key(kernel, x, w, args, kw)] += 1
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
    K1 as ``msfp_qdq``; the decode path's ``kv4_store`` and
    ``kv4_attend``) dispatch CUDA tensors to their plain versions (on the
    card) while the context is open."""
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import kv4 as k45
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    plain = {"kv4_store": lambda *a, **kw: k45.kv4_store_plain(*a, **kw),
             "kv4_attend": lambda *a, **kw: k45.kv4_attend_plain(*a, **kw),
             "w4a4_matmul": lambda *a, **kw: k2.w4_matmul_2d_plain(*a, **kw),
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


# (n_kv, G, hd) the decode paths give kv4_store and kv4_attend: smollm-135m
# (phase 7) first, then phase 12's zamba2-2.7b (hd 80: rows 40 bytes
# apart), llama4-scout (G 5) and gemma3-4b (hd 256)
KV4_HEADS = ((3, 3, 64), (32, 1, 80), (8, 5, 128), (4, 2, 256))


def kv4_pair_checks(dev) -> dict:
    """Phases 3 and 4 for the decode path's pair, on a cache of finite
    garbage (random codes, f16 scales in [0, 4)), at each of KV4_HEADS.
    kv4_store at the serve shape (B 8, 64 slots), f32 and bf16: codes and
    f16 scale bits equal the plain version's after a store at slot 32,
    every other slot untouched; timed in bf16. kv4_attend held to
    kv4_attend_allowed at the serve shape (64 slots, 32 valid) in bf16 and
    f32 with and without a softcap, and, at smollm-135m's heads, over 2048
    slots, all valid, in bf16; timed in bf16 at each. Bounds: bytes (each
    input read once, only the valid slots of the cache, each output
    written once) or operations (the encode's 20 f32 an element as K4;
    attend's two products, 4 G x valid x hd a (batch, kv-head), at the
    bf16 tensor-core rate as ``bound`` prices products, beside 2 f32 a
    decoded K/V value, each counted once: a multiply and a rounding); the
    yardstick is F.scaled_dot_product_attention (enable_gqa) over the
    valid slots of a bf16 cache decoded beforehand, untimed: attention
    only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import kv4 as k45
    gen = torch.Generator().manual_seed(5)
    rows = {"kv4_store": [], "kv4_attend": []}
    checks = {}

    def cache(slots, n_kv, hd):
        codes = (B, slots, n_kv, hd // 2)
        c = [torch.randint(0, 256, codes, generator=gen, dtype=torch.uint8),
             torch.randint(0, 256, codes, generator=gen, dtype=torch.uint8),
             (torch.rand(B, slots, n_kv, generator=gen) * 4).half(),
             (torch.rand(B, slots, n_kv, generator=gen) * 4).half()]
        return [x.to(dev) for x in c]

    def draw(*shape, dt):
        return (torch.randn(*shape, generator=gen) * torch.rand(
            *shape[:-1], 1, generator=gen) * 8).to(dev, dt)

    for n_kv, g, hd in KV4_HEADS:
        heads = f"K{n_kv} G{g} hd{hd}"
        fp4 = cache(64, n_kv, hd)
        for dt in (torch.bfloat16, torch.float32):
            k_new, v_new = draw(B, n_kv, hd, dt=dt), draw(B, n_kv, hd, dt=dt)
            got, want = [x.clone() for x in fp4], [x.clone() for x in fp4]
            k45.kv4_store_cuda(k_new, v_new, *got, 32)
            k45.kv4_store_plain(k_new, v_new, *want, 32)
            diff = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                       for a, b in zip(got, want))
            if diff:
                fail(f"kv4_store B{B} S64 {heads} {dt}: not bit-exact "
                     f"({diff} bytes differ)")
            if dt != torch.bfloat16:
                continue
            ms = cuda_ms(lambda: k45.kv4_store_cuda(k_new, v_new, *got, 32))
            plain_ms = cuda_ms(
                lambda: k45.kv4_store_plain(k_new, v_new, *want, 32))
            n = 2 * B * n_kv
            b_ms, b_by = bound(20.0 * n * hd,
                               2 * n * hd + n * (hd // 2 + 2), PEAK_F32_PER_S)
            rows["kv4_store"].append(dict(
                shape=f"B{B} S64 {heads} bf16", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None))

        cases = [(64, 32, torch.bfloat16, None),
                 (64, 32, torch.bfloat16, 30.0),
                 (64, 32, torch.float32, None), (64, 32, torch.float32, 30.0)]
        if (n_kv, g, hd) == KV4_HEADS[0]:
            cases.append((2048, 2048, torch.bfloat16, None))
        for slots, valid, dt, softcap in cases:
            c = cache(slots, n_kv, hd) if slots != 64 else fp4
            q = draw(B, n_kv, g, hd, dt=dt)
            args = (valid, hd ** -0.5, softcap)
            got = k45.kv4_attend_cuda(q, *c, *args)
            want = k45.kv4_attend_plain(q, *c, *args)
            allowed = k45.kv4_attend_allowed(q, *c, *args, want)
            diff = (got.double() - want.double()).abs()
            label = (f"B{B} S{slots} valid {valid} {heads} {str(dt)[6:]}"
                     + (f" softcap {softcap:g}" if softcap else ""))
            if bool((diff > allowed).any()):
                fail(f"kv4_attend {label}: {int((diff > allowed).sum())} "
                     f"elements outside kv4_attend_allowed (max abs err "
                     f"{float(diff.max()):.3g})")
            err = checks[label] = float(diff.max())
            print(f"kv4_attend {label}: max abs err {err:.3g}, largest share "
                  f"of the allowance {float((diff / allowed).max()):.3g}",
                  flush=True)
            if dt != torch.bfloat16 or softcap:
                continue
            ms = cuda_ms(lambda: k45.kv4_attend_cuda(q, *c, *args))
            plain_ms = cuda_ms(lambda: k45.kv4_attend_plain(q, *c, *args))
            keys, vals = (k45._decode_cache(x, sc, dt)[:, :valid]
                          .transpose(1, 2).contiguous()
                          for x, sc in ((c[0], c[2]), (c[1], c[3])))
            qs = q.reshape(B, n_kv * g, 1, hd)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, keys, vals, enable_gqa=True))
            b_ms, b_by = bound(
                4.0 * B * n_kv * g * valid * hd,
                2 * 2 * B * n_kv * g * hd
                + 2 * B * valid * n_kv * (hd // 2 + 2),
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
    run = driven("smollm-135m serve", lambda: serve.main(LM_ARGV),
                 LM_KERNELS, {("tied_logits", "torch")})
    out, counts, shapes = run["out"], run["counts"], run["shapes"]
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
            packed = quantize_lm_for_serving(params, searched=False)
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


def k2_mag(x, packed, scale, zero_point=0.0, act=None, *, exp_bits: int,
           man_bits: int, signed: bool = True, plan=None):
    """check_close's magnitude for a K2 call (its wrapper's arguments):
    |x_q| times abs_weight of the call's pack, in f32 with TF32 off."""
    from repro_torch.common.device import no_tf32
    from repro_torch.core.qmodule import PackedW4
    from repro_torch.quant.fakequant import fp_qdq
    from repro_torch.quant.formats import FPFormat
    xq = x if act is None else fp_qdq(x, FPFormat(act[2], act[3], act[4]),
                                      act[0], act[1])
    pw = PackedW4(packed, scale, zero_point, exp_bits, man_bits, signed,
                  (x.shape[1], 2 * packed.shape[1]))
    with no_tf32():
        return xq.float().abs() @ abs_weight(pw)


def call_checks(dev, calls: list, exact: bool) -> int:
    """Each captured CPU call of phase 6 rerun through its kernel on the
    card and held against the CPU output: a K2/K3 call bit for bit where
    ``exact``, every call by check_close (an io call's bf16 weight makes
    no sum exact; how many of them matched bit for bit is printed); the
    card's plain version's largest difference from the CPU is printed
    beside the kernel's for scale. Returns the number of calls held."""
    import torch
    from repro_torch.common.device import no_tf32
    from repro_torch.kernels import conv as k3
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    from repro_torch.quant.fakequant import apply_qdq

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
                got = k2.w4_matmul_2d_cuda(*a, **kw)
                plain = k2.w4_matmul_2d_plain(*a, **kw)
                mag, k = k2_mag(*a, **kw), a[0].shape[1]
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
    a run of phase 5, 7, 11, 12 or 13, with its per-shape launch tally)
    launched on the card, checked signed and unsigned and timed as in phases 3-4 (shapes
    timed there are reused), with its launches per unit of the path (a
    forward or a decode step) and launches x ms; per path and kernel, the
    sum of launches x ms beside the device total of the path's profile."""
    import torch
    by_label = {r["shape"]: r for rs in rows.values() for r in rs}
    sums = {}
    for path, run in runs.items():
        for (kernel, key), count in sorted(run["shapes"].items(), key=str):
            if kernel == "w4a4_matmul":
                m, k, n, dt, act = key
                label = k2_label(m, k, n, dt, act)
                if label not in by_label:
                    by_label[label] = k2_row(dev, m, k, n,
                                             getattr(torch, dt), act)
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
            prof = (f"; profiled device total "
                    f"{profiled[path].get(kernel, 0.0):.4f} ms"
                    if path in profiled else "")
            print(f"path {path}, per {runs[path]['unit']}: {kernel} sum of "
                  f"launches x ms {total:.4f} ms{prof}", flush=True)
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


# ---------------------------------------------------------------------------
# Phase 11: the multi-model gateway and the fleet router at full width.
# ---------------------------------------------------------------------------

GATEWAY_MODELS = ("ddim-cifar10", "smollm-135m")
# the fleet bench's deadline_mix shaping (benchmarks/fleet_bench.py): 6
# req/s, steps jitter 4, max-batch 4, bank cap 6; its 20 requests cut to
# FLEET_REQUESTS so that both placements' runs stay near a minute
FLEET_REQUESTS = 10
FLEET_SHAPING = dict(rate=6.0, steps_jitter=4, max_batch=4, bank_cap=6)
FLEET_PLACEMENTS = ("round_robin", "segment_affinity")


def gateway_registry():
    """The two models at full width: ddim-cifar10 and smollm-135m's full
    config (30 layers, bf16), each with the development entries' bank cap,
    max-batch and SLO."""
    from repro_torch.serving.gateway import ModelEntry, ModelRegistry
    from repro_torch.serving.traffic import SLO
    return ModelRegistry([
        ModelEntry(name="ddim-cifar10", family="diffusion",
                   config="ddim-cifar10", bank_cap=4, max_batch=4,
                   slo=SLO(p95_s=120.0)),
        ModelEntry(name="smollm-135m", family="lm", config="smollm-135m",
                   bank_cap=1, max_batch=4, smoke=False,
                   slo=SLO(p95_s=120.0))])


def gateway_of(models, clock: str, device, policy: str = "fifo"):
    """``serve_gateway.build_gateway`` over ``gateway_registry()`` with the
    launcher's defaults (seed 0, T 100, max-batch 4)."""
    from repro_torch.launch import serve_gateway
    args = serve_gateway.build_parser().parse_args(
        ["--clock", clock, "--device", str(device), "--policy", policy])
    args.gateway_max_batch = 4
    gw, _ = serve_gateway.build_gateway(list(models), args,
                                        registry=gateway_registry())
    return gw


def renamed(name: str):
    """A two-model scenario with its mix's model names renamed to the
    full-width entries' names; nothing else changed."""
    import dataclasses
    from repro_torch.serving.traffic import get_scenario
    scn = get_scenario(name)
    return dataclasses.replace(scn, mix=dataclasses.replace(
        scn.mix, models=GATEWAY_MODELS))


def fleet_of(dev, replicas: int, placement: str, clock: str, bank_cap: int,
             max_batch: int):
    """``serve_fleet.build_fleet`` on ddim-cifar10 (its ``cfg`` seam) with
    the launcher's defaults (seed 0, T 100), on ``dev``."""
    from repro_torch.configs.diffusion_presets import ddim_cifar10
    from repro_torch.launch import serve_fleet
    args = serve_fleet.build_parser().parse_args(
        ["--replicas", str(replicas), "--placement", placement,
         "--clock", clock, "--bank-cap", str(bank_cap), "--device", str(dev)])
    args.fleet_max_batch = max_batch
    fleet, _ = serve_fleet.build_fleet(args, cfg=ddim_cifar10())
    return fleet


def reconciled(name: str, bank) -> str:
    if bank.builds + bank.build_failures != bank.misses + bank.prefetches:
        fail(f"{name}: bank counters do not reconcile ({bank.describe()})")
    return (f"{bank.builds} builds = {bank.misses} misses + "
            f"{bank.prefetches} prefetches")


def k2_modes(shapes) -> dict:
    """K2 launches tallied by mode: acts on (W4A4) and weight-only."""
    out = {"w4a4": 0, "weight_only": 0}
    for (kernel, key), c in shapes.items():
        if kernel == "w4a4_matmul":
            out["w4a4" if key[4] else "weight_only"] += c
    return out


def model_runs(run: dict, gw) -> dict:
    """The gateway run's launches split by model: the diffusion model's
    K2 (acts on), K3 and qdq_conv2d per forward, the LM's K2 (weight-only)
    per decode step; each a path of the kernels line and of phase 9."""
    diff, lm = (gw.engine(n) for n in GATEWAY_MODELS)
    modes = k2_modes(run["shapes"])
    zero = {k: 0 for k in run["counts"]}
    d_counts = dict(zero, w4a4_matmul=modes["w4a4"],
                    w4a4_conv2d=run["counts"]["w4a4_conv2d"],
                    qdq_conv2d=run["counts"]["qdq_conv2d"])
    l_counts = dict(zero, w4a4_matmul=modes["weight_only"])
    split = {"ddim-cifar10": (d_counts, diff.n_forwards, "forward", True),
             "smollm-135m": (l_counts, lm.n_forwards, "decode step", False)}
    return {name: {"counts": c, "units": units, "unit": unit,
                   "shapes": collections.Counter(
                       {key: n for key, n in run["shapes"].items()
                        if key[0] == "w4a4_matmul" and key[1][4] == act})}
            for name, (c, units, unit, act) in split.items()}


def gateway_identity(dev, golden_digest: str) -> dict:
    """Phase 11(a): the golden trace under the virtual clock at full width
    through a one-model gateway (ddim-cifar10) and a one-replica
    round-robin fleet, each giving phase 5's golden digest from
    serve_diffusion; then the serve_fleet launcher at its own preset
    (tiny-ddim, --image-size 16), whose digest must be serve_diffusion's
    there."""
    from repro_torch.launch import serve_diffusion, serve_fleet
    from repro_torch.launch.serve_diffusion import outcome_digest
    from repro_torch.serving.traffic import load_trace, submit_trace
    reqs = load_trace(str(GOLDEN))[0]
    digests = {}
    for name, build in (
            ("gateway", lambda: gateway_of(("ddim-cifar10",), "virtual",
                                           dev)),
            ("fleet", lambda: fleet_of(dev, 1, "rr", "virtual", 4, 4))):
        router = build()

        def drive(router=router):
            submit_trace(router, reqs)
            return router.run()
        run = driven(f"golden trace through the one-model {name}", drive,
                     DIFFUSION_KERNELS)
        digests[name] = outcome_digest(run["out"])
        if digests[name] != golden_digest:
            fail(f"golden trace through the one-model {name}: digest "
                 f"{digests[name]} != serve_diffusion's {golden_digest}")
    launcher = serve_fleet.main(
        ["--replicas", "1", "--placement", "rr", "--scenario", "golden",
         "--clock", "virtual", "--device", str(dev)])
    bare = serve_diffusion.main(
        ["--preset", "tiny-ddim", "--image-size", "16", "--scenario",
         "golden", "--replay-clock", "virtual", "--device", str(dev)])
    if launcher["outcome_digest"] != bare["digest"]:
        fail(f"serve_fleet --replicas 1 digest {launcher['outcome_digest']} "
             f"!= serve_diffusion's {bare['digest']} (tiny-ddim, 16)")
    digests["serve_fleet tiny-ddim"] = launcher["outcome_digest"]
    print(f"golden trace, virtual clock: one-model gateway {digests['gateway']}"
          f", one-replica fleet {digests['fleet']} = serve_diffusion's "
          f"{golden_digest} (ddim-cifar10); serve_fleet --replicas 1 "
          f"{launcher['outcome_digest']} = serve_diffusion's "
          f"{bare['digest']} (tiny-ddim, 16)", flush=True)
    return digests


def mixed_record(gw, results) -> dict:
    """What two virtual-clock runs of one workload must share: each
    engine's selected ticks (recorded by the caller), each request's gid,
    model, n_evals and expiry, each bank's counters."""
    from repro_torch.serving.replay import BANK_COUNTERS
    return {"outcomes": {g: (rs.gid, rs.model, rs.n_evals, rs.expired)
                         for g, rs in results.items()},
            "banks": {n: {k: getattr(gw.engine(n).bank, k)
                          for k in BANK_COUNTERS}
                      for n in gw.list_models()}}


def gateway_mixed(dev) -> dict:
    """Phase 11(b): mixed_model (8 Poisson arrivals at 20 req/s, steps
    6 +- 1, the two models 1:1) under the virtual clock through the
    two-model gateway on the card (the path: K2 in both modes, K3 and
    qdq_conv2d; the tied LM head the only off-kernel route) and on the
    CPU from the same seed: tick logs, outcomes and bank counters
    identical; the LM's tokens and the diffusion x0 card vs CPU as
    readings. Then per_model_slo under the slo policy on the wall clock
    (readings; every bank must reconcile)."""
    import torch
    from repro_torch.configs.smollm_135m import full
    from repro_torch.serving.replay import (eps_free_x0, record_ticks,
                                            x0_error)
    from repro_torch.serving.traffic import run_scenario
    recs, runs = {}, {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        gw = gateway_of(GATEWAY_MODELS, "virtual", device)
        ticks = {n: record_ticks(gw.engine(n)) for n in GATEWAY_MODELS}
        t0 = time.perf_counter()
        if where == "card":
            run = driven("gateway mixed_model", lambda gw=gw: run_scenario(
                renamed("mixed_model"), gw, seed=0),
                DIFFUSION_KERNELS, {("tied_logits", "torch")})
        else:
            run = {"out": run_scenario(renamed("mixed_model"), gw, seed=0)}
        run["wall_s"] = time.perf_counter() - t0
        recs[where] = dict(mixed_record(gw, gw.results), ticks=ticks)
        runs[where] = (run, gw)
    if recs["card"] != recs["cpu"]:
        bad = [k for k in recs["card"] if recs["card"][k] != recs["cpu"][k]]
        fail(f"gateway mixed_model, card vs CPU: {bad} differ "
             f"({recs['card']} vs {recs['cpu']})")
    run, gw = runs["card"]
    host = runs["cpu"][1]
    paths = model_runs(run, gw)
    lm_steps, fwds = (paths["smollm-135m"]["units"],
                      paths["ddim-cifar10"]["units"])
    modes = k2_modes(run["shapes"])
    per_step = 7 * full().n_layers
    if (modes["weight_only"] != per_step * lm_steps or not modes["w4a4"]
            or run["counts"]["qdq_conv2d"] != 2 * fwds
            or run["counts"]["msfp_qdq"]):
        fail(f"gateway mixed_model: K2 {modes} over {lm_steps} decode steps "
             f"(want {per_step} weight-only a step) and {fwds} forwards, "
             f"qdq_conv2d {run['counts']['qdq_conv2d']} (want 2 a forward), "
             f"K1 {run['counts']['msfp_qdq']} (want 0)")
    lm_c, lm_h = (g.engine("smollm-135m").results for g in (gw, host))
    same = [bool(torch.equal(lm_c[r].x0, lm_h[r].x0)) for r in lm_c]
    tok_c = torch.cat([lm_c[r].x0 for r in sorted(lm_c)])
    tok_h = torch.cat([lm_h[r].x0 for r in sorted(lm_h)])
    d_c, d_h = (g.engine("ddim-cifar10") for g in (gw, host))
    base = eps_free_x0([rs.req for rs in d_h.results.values()], d_h.sched,
                       (1, d_h.cfg.image_size, d_h.cfg.image_size,
                        d_h.cfg.in_ch))
    x0 = x0_error({r: rs.x0.cpu() for r, rs in d_c.results.items()
                   if rs.x0 is not None},
                  {r: rs.x0 for r, rs in d_h.results.items()
                   if rs.x0 is not None}, base)
    out = {"identical": ["ticks", "outcomes", "banks"],
           "lm_requests_tokens_equal": f"{sum(same)}/{len(same)}",
           "lm_token_share_equal": float((tok_c == tok_h).float().mean()),
           "diffusion_x0": x0, "launches": run["counts"], "k2_modes": modes,
           "decode_steps": lm_steps, "forwards": fwds,
           "card_s": run["wall_s"], "cpu_s": runs["cpu"][0]["wall_s"]}
    print(f"gateway mixed_model (virtual clock), card vs CPU: tick logs "
          f"({ {n: len(t) for n, t in recs['card']['ticks'].items()} } "
          f"ticks), outcomes of {len(recs['card']['outcomes'])} requests "
          f"and bank counters {recs['card']['banks']} identical; LM requests "
          f"with every token equal {out['lm_requests_tokens_equal']}, token "
          f"share equal {out['lm_token_share_equal']:.4f}; diffusion x0 "
          f"relative Frobenius error {x0['rel_frobenius']:.3g} of its model "
          f"part, {x0['frac_off']:.4%} off (not held); card "
          f"{run['wall_s']:.1f}s, CPU {out['cpu_s']:.1f}s; launches "
          f"{run['counts']}, K2 by mode {modes} over {fwds} forwards and "
          f"{lm_steps} decode steps", flush=True)
    out["paths"] = paths
    out["per_model_slo"] = gateway_slo(dev)
    return out


def gateway_slo(dev) -> dict:
    """Phase 11(b): per_model_slo (the diffusion requests' deadlines 1.5 s)
    under the slo policy on the wall clock through the two-model gateway
    on the card: per model goodput, p95, SLO verdict and bank
    reconciliation; the diffusion model's evals/s and the LM's tok/s."""
    from repro_torch.serving.traffic import run_scenario
    gw = gateway_of(GATEWAY_MODELS, "wall", dev, policy="slo")
    run = driven("gateway per_model_slo", lambda: run_scenario(
        renamed("per_model_slo"), gw, seed=0), DIFFUSION_KERNELS,
        {("tied_logits", "torch")})
    wall = run["out"]["wall_s"]
    stats = gw.stats()["per_model"]
    out = {"wall_s": wall, "goodput_frac": run["out"]["goodput_frac"]}
    for name in GATEWAY_MODELS:
        eng = gw.engine(name)
        summ, slo = stats[name]["summary"], stats[name]["slo"]
        done = [rs for rs in eng.results.values() if not rs.expired]
        rate = (sum(rs.n_evals for rs in eng.results.values()) / wall
                if name == "ddim-cifar10"
                else sum(len(rs.x0) for rs in done) / wall)
        out[name] = {"goodput_frac": summ["goodput_frac"],
                     "p95_s": summ["p95_s"], "slo_passed": slo["passed"],
                     "expired": summ["expired"],
                     ("evals_per_s" if name == "ddim-cifar10"
                      else "tok_per_s"): rate,
                     "bank": reconciled(f"per_model_slo {name}", eng.bank)}
        print(f"gateway per_model_slo (slo policy, wall clock) {name}: "
              f"goodput {summ['goodput_frac']:.4f}, p95 {summ['p95_s']:.4f} "
              f"s, SLO {'PASS' if slo['passed'] else 'FAIL'}, "
              f"{summ['expired']} expired, "
              + (f"{rate:.2f} denoise evals/s" if name == "ddim-cifar10"
                 else f"{rate:.2f} tok/s")
              + f", bank {out[name]['bank']}; wall {wall:.2f}s", flush=True)
    return out


def fleet_scenario():
    import dataclasses
    from repro_torch.serving.traffic import get_scenario
    scn = get_scenario("deadline_mix")
    return dataclasses.replace(
        scn, n_requests=FLEET_REQUESTS, max_batch=FLEET_SHAPING["max_batch"],
        mix=dataclasses.replace(scn.mix,
                                steps_jitter=FLEET_SHAPING["steps_jitter"]),
        gen_kw=(("rate", FLEET_SHAPING["rate"]),))


def fleet_runs(dev) -> dict:
    """Phase 11(c): two ddim-cifar10 replicas behind one fleet router on
    the wall clock, deadline_mix at the fleet bench's shaping, round robin
    and segment affinity in alternating runs; both replicas share the one
    card, so this shows placement, not scaling. Each run: every kernel of
    the path launched, no off-kernel route, two qdq_conv2d a forward;
    pooled hit rate, goodput, p95, builds, placements and per-replica
    reconciliation."""
    from repro_torch.serving.traffic import run_scenario
    out, paths = {}, {}
    for placement in FLEET_PLACEMENTS:
        fleet = fleet_of(dev, 2, placement, "wall",
                         FLEET_SHAPING["bank_cap"], FLEET_SHAPING["max_batch"])
        run = driven(f"fleet deadline_mix {placement}", lambda: run_scenario(
            fleet_scenario(), fleet, seed=0), DIFFUSION_KERNELS)
        fwds = sum(r.engine.n_forwards for r in fleet.replicas)
        if (run["counts"]["qdq_conv2d"] != 2 * fwds
                or run["counts"]["msfp_qdq"]):
            fail(f"fleet {placement}: {run['counts']} over {fwds} forwards")
        agg = fleet.stats()["aggregate"]
        s = run["out"]
        out[placement] = {
            "bank_hit_rate": agg["bank_hit_rate"],
            "goodput_frac": s["goodput_frac"], "p95_s": s["p95_s"],
            "expired": s["expired"], "bank_builds": agg["bank_builds"],
            "placements": agg["placements"],
            "placement_reasons": agg["placement_reasons"],
            "wall_s": s["wall_s"], "forwards": fwds,
            "replicas": {r.name: reconciled(f"fleet {placement} {r.name}",
                                            r.bank)
                         for r in fleet.replicas}}
        print(f"fleet deadline_mix ({FLEET_REQUESTS} requests, 2 replicas on "
              f"one card, {placement}, wall clock): pooled bank hit rate "
              f"{agg['bank_hit_rate']:.4f}, goodput {s['goodput_frac']:.4f}, "
              f"p95 {s['p95_s']:.4f} s, {s['expired']} expired, "
              f"{agg['bank_builds']} builds, placements {agg['placements']} "
              f"{agg['placement_reasons']}, replicas "
              f"{out[placement]['replicas']}, wall {s['wall_s']:.2f}s",
              flush=True)
        paths[f"fleet deadline_mix {placement}"] = dict(
            run, units=fwds, unit="forward")
    out["paths"] = paths
    return out


def gateway_phase(dev, golden_digest: str) -> dict:
    """Phase 11: (a) the identities, (b) the two-model gateway, (c) the
    fleet; its wall time printed."""
    print("--- gateway and fleet at full width", flush=True)
    t0 = time.perf_counter()
    out = {"identity": gateway_identity(dev, golden_digest),
           "mixed_model": gateway_mixed(dev), "fleet": fleet_runs(dev)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"gateway and fleet phase wall {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 12: every LM family's decode at full width.
# ---------------------------------------------------------------------------

# depth cut of llama4-scout-17b-a16e (48 layers of 2.2 G params, 211 GB in
# bf16): 4 layers and the embed/head hold about 22 GB in bf16 at init
LLAMA4_DEPTH = 4
# (arch, layers served or None for all): the hybrid, ssm, dense-with-
# first_k_dense and moe families at full width
FAMILY_RUNS = (("zamba2-2.7b", None), ("mamba2-370m", None),
               ("gemma3-4b", None), ("llama4-scout-17b-a16e", LLAMA4_DEPTH))
# launches each must show per decode step (prompt and generated steps
# alike): K2 W4A4 at the dense sites (4 an attention layer, the MLP's 2 or
# 3, 2 an SSM layer, 3 the shared expert), K2 weight-only at every expert
# product (3 an expert), kv4_store and kv4_attend once an attention layer
# (zamba2: the shared block once a group), K1 once for an untied head
FAMILY_LAUNCHES = {
    "zamba2-2.7b": dict(w4a4=162, weight_only=0, kv4_store=9, kv4_attend=9,
                        msfp_qdq=1),
    "mamba2-370m": dict(w4a4=96, weight_only=0, kv4_store=0, kv4_attend=0,
                        msfp_qdq=0),
    "gemma3-4b": dict(w4a4=238, weight_only=0, kv4_store=34, kv4_attend=34,
                      msfp_qdq=1),
    "llama4-scout-17b-a16e": dict(w4a4=28, weight_only=192, kv4_store=4,
                                  kv4_attend=4, msfp_qdq=1)}


def family_config(arch: str, depth=None):
    """The arch's full config, ``depth`` layers of it when given."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def has_attention(cfg) -> bool:
    return (any(kind == "attn" for kind, _, _ in cfg.layer_pattern)
            or bool(cfg.first_k_dense or cfg.shared_attn_every))


def free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_family(arch: str, depth) -> dict:
    """Phase 12(a): one arch through the LM launcher at full width (random
    weights from the seed, W4 abs-max, E2M1 acts fused, FP4 cache where
    there is attention, batch 8, 32 prompt tokens stepped in and 32
    generated), its depth cut through the launcher's ``cfg`` seam where
    ``depth`` is given. Only kernel routes may run apart from the plain
    products the reference computes outside any kernel (the tied readout;
    an untied head's and the MoE router's f32 products); the launches per
    decode step, K2's by mode from the launches tallied by shape, must be
    FAMILY_LAUNCHES'."""
    from repro_torch.launch import serve
    cfg = family_config(arch, depth)
    attn = has_attention(cfg)
    name = f"{arch} serve" + (f" (depth {depth})" if depth else "")
    print(f"--- serve: {name} W4A4" + (" FP4-KV" if attn else ""),
          flush=True)
    argv = ["--arch", arch, "--quant", "w4", "--act-quant", "fp4", "--kv",
            "fp4" if attn else "bf16", "--batch", str(B), "--prompt-len",
            "32", "--gen-len", "32", "--device", "cuda"]
    needed = ["w4a4_matmul"] + (["kv4_store", "kv4_attend"] if attn else []) \
        + ([] if cfg.tie_embeddings else ["msfp_qdq"])
    allowed = ({("tied_logits", "torch")} if cfg.tie_embeddings
               else {("matmul", "torch_f32")})
    t0 = time.perf_counter()
    run = driven(name, lambda: serve.main(argv, cfg=cfg), needed, allowed)
    wall = time.perf_counter() - t0
    out, counts, shapes = run["out"], run["counts"], run["shapes"]
    steps = out["steps"]
    modes = k2_modes(shapes)
    per_step = {"w4a4": modes["w4a4"] / steps,
                "weight_only": modes["weight_only"] / steps,
                **{k: counts[k] / steps
                   for k in ("kv4_store", "kv4_attend", "msfp_qdq")}}
    if per_step != FAMILY_LAUNCHES[arch]:
        fail(f"{name}: launches per decode step {per_step}, expected "
             f"{FAMILY_LAUNCHES[arch]}")
    if counts["kv4_encode"] or counts["kv4_decode"] or counts[
            "w4a4_conv2d"] or counts["qdq_conv2d"]:
        fail(f"{name}: a kernel off the decode path launched: {counts}")
    peak = out["peak_bytes"] / 2**30
    reduced = (f"; reduced: n_layers {cfg.n_layers} of "
               f"{family_config(arch).n_layers}, widths as published"
               if depth else "")
    print(f"serve {name}: {out['tok_s']:.2f} tok/s decode at batch {B}, "
          f"prefill {out['prefill_s']:.3f}s, decode {out['decode_s']:.3f}s, "
          f"max_memory_allocated {peak:.2f} GiB, {out['params']} params, "
          f"launches per decode step {per_step}, run wall {wall:.1f}s"
          + reduced, flush=True)
    return {"counts": counts, "units": steps, "unit": "decode step",
            "shapes": shapes, "tok_s": out["tok_s"],
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "peak_gib": peak, "params": out["params"],
            "launches_per_step": per_step, "reduced": bool(depth),
            "n_layers": cfg.n_layers}


@contextlib.contextmanager
def ssm_state_in_bf16():
    """A control fault: each SSM layer's f32 state rounded to bf16 after
    its update (a recurrence kept in the model's low precision), while the
    context is open."""
    from repro_torch.models import lm
    orig = lm.ssm_decode

    def rounded(*args, **kw):
        out, cache = orig(*args, **kw)
        cache["state"].copy_(cache["state"].bfloat16().float())
        return out, cache
    lm.ssm_decode = rounded
    try:
        yield
    finally:
        lm.ssm_decode = orig


# card vs CPU decode checks of phase 12(b): (arch, depth, dtype name,
# teacher-forced steps, limit on the relative Frobenius error of the
# logits, the control faults that must break it). Each limit lies between
# the sound reading and its controls' (on an NVIDIA H100 80GB HBM3 at
# 700.00 W; PERF.md). zamba2 in f32 reads 0.0432 card vs CPU, and the same
# 0.0432 with K2 and K1 on their plain versions on the card: the torch ops
# between the kernels (exp, softplus, silu, the norms' sums) differ from
# the CPU's by ulps, which flip an E2M1 act tie at in_proj or out_proj
# about once a step, and 54 layers of random weights carry each flip on;
# its limit is the geometric mean of that and its weaker control (0.331).
# In bf16 the model's own roundings absorb those ulps (1.03e-5).
FAMILY_CHECKS = (
    ("zamba2-2.7b", None, "float32", 3, 0.12,
     ("bf16 acts into K2", "SSM state in bf16")),
    ("zamba2-2.7b", None, "bfloat16", 3, 2e-2, ("SSM state in bf16",)),
    ("llama4-scout-17b-a16e", 1, "float32", 2, 1e-3, ("bf16 acts into K2",)))
# the same steps through the kernels and through their plain versions on
# the card (the torch ops between them identical): relative Frobenius
# error of the logits (they read 0 on the same card)
KERNELS_VS_PLAIN_LIMIT = 1e-5
CONTROLS = {"bf16 acts into K2": bf16_act_kernels,
            "SSM state in bf16": ssm_state_in_bf16}


def family_decode_checks(dev) -> dict:
    """Phase 12(b): teacher-forced decode steps at batch 8, full width, W4A4
    on ``steps.dyadic_weights`` (power-of-two scales: the W4A4 sums are
    exact) with the FP4 cache, through the kernels on the card and through
    the plain versions on the CPU, from the same packs (drawn and packed on
    the card, copied to the host); each held to its FAMILY_CHECKS limit,
    and each control fault, rerun on the card, must break it; the kernels
    against their plain versions on the card held to
    KERNELS_VS_PLAIN_LIMIT. zamba2's SSM layers run exp, softplus and silu
    ahead of out_proj's act snap, so the limit is derived from the
    readings, not taken from LM_LIMITS."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import init_caches, lm_init
    from repro_torch.quant.calibrate import QuantContext
    from repro_torch.quant.fakequant import QuantizerParams
    from repro_torch.serving.weight_bank import _tree_to

    def run(cfg, params, device, toks):
        ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0, device=device))})
        step = make_decode_fn(cfg, ctx=ctx)
        caches = init_caches(cfg, B, toks.shape[1], device)
        out = []
        with torch.inference_mode():
            for i in range(toks.shape[1]):
                lg, caches = step(params, caches, toks[:, i:i + 1].to(device),
                                  i)
                out.append(lg.float().cpu())
        return torch.stack(out).double().numpy()

    def reading(g, w) -> dict:
        return {"rel_frobenius": float(np.linalg.norm(g - w)
                                       / max(np.linalg.norm(w), 1e-30)),
                "max_abs_over_max": float(np.abs(g - w).max()
                                          / np.abs(w).max()),
                "argmax_equal": bool((g.argmax(-1) == w.argmax(-1)).all())}

    res = {}
    for arch, depth, dname, steps, limit, controls in FAMILY_CHECKS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(family_config(arch, depth),
                                  dtype=getattr(torch, dname), kv_dtype="fp4")
        packed = quantize_lm_for_serving(dyadic_weights(lm_init(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)),
            searched=False)
        host = _tree_to(packed, torch.device("cpu"))
        toks = torch.randint(0, cfg.vocab, (B, steps),
                             generator=torch.Generator().manual_seed(1))
        g = run(cfg, packed, dev, toks)
        if not np.isfinite(g).all():
            fail(f"{arch} {dname} decode on the card is not finite")
        w = run(cfg, host, torch.device("cpu"), toks)
        sound = reading(g, w)
        # K2 and K1 on their plain versions on the card: against the CPU
        # only the torch ops between the kernels differ (a reading), against
        # the kernels only the kernels (held)
        with plain_kernels(("w4a4_matmul", "msfp_qdq")):
            gp = run(cfg, packed, dev, toks)
        plain, vs_plain = reading(gp, w), reading(g, gp)
        faults = {}
        for c in controls:
            with CONTROLS[c]():
                faults[c] = reading(run(cfg, packed, dev, toks), w)
        label = f"{arch}" + (f" depth {depth}" if depth else "") + \
            f" {dname}"
        print(f"decode {label} W4A4 FP4-KV B={B}, {steps} teacher-forced "
              f"steps, dyadic weights, card vs CPU plain: {sound}; held to "
              f"relative Frobenius error <= {limit:g}; the card with K2 and "
              f"K1 on their plain versions vs the CPU (a reading): {plain}; "
              f"the kernels vs their plain versions on the card: {vs_plain}, "
              f"held to <= {KERNELS_VS_PLAIN_LIMIT:g}; control faults: "
              + "; ".join(f"{c}: {r}" for c, r in faults.items())
              + f" (wall {time.perf_counter() - t0:.1f}s)", flush=True)
        if sound["rel_frobenius"] > limit:
            fail(f"{label} decode on the card disagrees with the plain CPU "
                 f"decode ({sound['rel_frobenius']:.3g} > {limit:g})")
        if vs_plain["rel_frobenius"] > KERNELS_VS_PLAIN_LIMIT:
            fail(f"{label} decode through the kernels disagrees with their "
                 f"plain versions on the card ({vs_plain['rel_frobenius']:.3g}"
                 f" > {KERNELS_VS_PLAIN_LIMIT:g})")
        for c, r in faults.items():
            if r["rel_frobenius"] <= limit:
                fail(f"{label}: control fault '{c}' passes the decode check "
                     f"({r['rel_frobenius']:.3g} <= {limit:g}): the check "
                     "would not see it")
        res[label] = {"sound": sound, "card_plain_versions": plain,
                      "kernels_vs_plain": vs_plain, "controls": faults,
                      "limit": limit}
        del packed, host
        free_card()
    return res


@contextlib.contextmanager
def k2_mode_ranges():
    """Each K2 launch inside a profiler range named by its mode ("K2
    W4A4" / "K2 weight-only"), while the context is open, so a profile
    splits K2's device time by mode (a bf16 instance's symbol does not
    tell them apart)."""
    import torch

    def wrap(f):
        def launch(x, w, *args, **kw):
            act = args[2] if len(args) > 2 else kw.get("act")
            with torch.profiler.record_function(
                    "K2 W4A4" if act is not None else "K2 weight-only"):
                y = f(x, w, *args, **kw)
            f.launches = launch.launches
            return y
        return launch
    with wrapped_kernels({"w4a4_matmul": wrap}):
        yield


def range_device_ms(prof, name: str) -> float:
    """Device ms of the profiler ranges named ``name``: each range's row on
    the card spans the kernels launched inside it (a split-K launch's
    reduction included)."""
    import torch
    from repro_torch.launch.profile_decode import device_us
    return sum(device_us(e) for e in prof.key_averages()
               if e.key == name
               and e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def family_profiles(dev) -> dict:
    """Phase 12(c): one bf16 decode step of zamba2-2.7b and of llama4-scout
    at its cut depth (launch/profile_decode.py's configuration: W4A4, FP4
    cache of 64 slots half full, batch 8): wall, device busy time, idle
    share, launches, top kernels and K2's device ms by mode."""
    import dataclasses
    from repro_torch.launch.profile_decode import decode_step_profile
    out = {}
    for arch, depth in (("zamba2-2.7b", None),
                        ("llama4-scout-17b-a16e", LLAMA4_DEPTH)):
        cfg = dataclasses.replace(family_config(arch, depth), kv_dtype="fp4")
        with k2_mode_ranges():
            prof = decode_step_profile(cfg, B, 64, 32, dev)
        p = prof.pop("prof")
        _, top = device_time(p)
        per_kernel = kernel_ms(prof["kernels"])
        modes = {m: range_device_ms(p, f"K2 {m}")
                 for m in ("W4A4", "weight-only")}
        label = arch + (f" depth {depth}" if depth else "")
        print(f"profile decode step {label} bf16 B={B}: unprofiled wall "
              f"{prof['step_ms']:.3f} ms (median of 10; host CPU "
              f"{prof['cpu_ms']:.3f} ms), profiled wall "
              f"{prof['profile_wall_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f} ({prof['idle_share_profiled']:.3f} "
              f"of the profiled step), {prof['launches']} CUDA kernel "
              f"launches; K2 device ms by mode {modes}; device "
              + ", ".join(f"{k} {v['ms']:.4f} ms x{v['launches']}"
                          for k, v in per_kernel.items() if v["launches"]),
              flush=True)
        for line in top:
            print(line, flush=True)
        out[label] = {k: prof[k] for k in (
            "step_ms", "cpu_ms", "profile_wall_ms", "busy_ms", "idle_share",
            "idle_share_profiled", "launches")}
        out[label]["k2_ms_by_mode"] = modes
        out[label]["profile_kernel_ms"] = {k: v["ms"]
                                           for k, v in per_kernel.items()}
        del p
        free_card()
    return out


def family_phase(dev) -> dict:
    """Phase 12: (a) the four serve runs, (b) the card-vs-CPU decode
    checks, (c) the profiles; its wall time printed."""
    print("--- every LM family at full width", flush=True)
    t0 = time.perf_counter()
    runs = {}
    for arch, depth in FAMILY_RUNS:
        runs[f"{arch} serve"] = serve_family(arch, depth)
        free_card()
    out = {"runs": runs, "checks": family_decode_checks(dev),
           "profiles": family_profiles(dev)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"LM families phase wall {out['wall_s']:.1f} s", flush=True)
    return out


# Phase 13: the LM full-sequence forward (prefill) and training.
# ---------------------------------------------------------------------------

# (arch, layers or None for all, batch, sequence): each crosses what decode
# never runs: K2 at M = B x S (16384 rows for smollm), the SSD scan over 8
# chunks (zamba2), gemma3's 1024-token window, the MoE at capacity(4096)
PREFILL_RUNS = (("smollm-135m", None, 8, 2048), ("zamba2-2.7b", None, 4, 2048),
                ("gemma3-4b", None, 2, 2048),
                ("llama4-scout-17b-a16e", LLAMA4_DEPTH, 8, 512))
# launches a W4A4 forward must show (under a serve context): phase 12's per
# decode step without the kv4 pair; make_prefill_step's forward (no
# context) runs the same sites in K2's weight-only mode and no K1
PREFILL_LAUNCHES = {
    "smollm-135m": dict(w4a4=210, weight_only=0, msfp_qdq=0),
    "zamba2-2.7b": dict(w4a4=162, weight_only=0, msfp_qdq=1),
    "gemma3-4b": dict(w4a4=238, weight_only=0, msfp_qdq=1),
    "llama4-scout-17b-a16e": dict(w4a4=28, weight_only=192, msfp_qdq=1)}


def weight_only_launches(arch: str) -> dict:
    w = PREFILL_LAUNCHES[arch]
    return dict(w4a4=0, weight_only=w["w4a4"] + w["weight_only"], msfp_qdq=0)


def _sync():
    import torch
    torch.cuda.synchronize()


def profiled(fn) -> dict:
    """One call of ``fn`` under torch.profiler (ending in a synchronise):
    its wall, the device busy time (kernel rows), the idle share and the
    CUDA kernels launched, device ms by kernel. Device activity first: the host's op events of
    a step of tens of thousands of launches take the profiler's tables
    tens of seconds to build (47 s for a mamba2-370m train step on an
    NVIDIA H100 80GB HBM3); if that records no device time, the host's
    activity beside it."""
    from torch.profiler import ProfilerActivity, profile
    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, top = device_time(prof, 4)
        if busy_ms > 0:
            break
    else:
        fail("the profiler recorded no device time")
    return {"profile_wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "launches": kernel_launches(prof),
            "kernel_ms": kernel_device_ms(prof), "top": top}


def serve_ctx(dev):
    import torch
    from repro_torch.quant.calibrate import QuantContext
    from repro_torch.quant.fakequant import QuantizerParams
    return QuantContext("serve", act_qps={"*": QuantizerParams(
        0, 2, 1, 4, torch.tensor(6.0, device=dev))})


def prefill_runs(dev) -> dict:
    """Phase 13(a): each PREFILL_RUNS arch at full width (random weights
    from the seed drawn on the card, W4 abs-max, bf16), one forward under
    a serve context (E2M1 acts at maxval 6: W4A4 K2, K1 before an untied
    head) and one ``make_prefill_step`` call (weight-only K2), each with
    the counts set to 0 before it and read after: the launches a forward,
    K2's by mode, must be PREFILL_LAUNCHES' (weight_only_launches'), no
    off-kernel route beyond the tied readout or the untied head's and the
    router's f32 products, the logits finite. Then the same call timed
    (wall, prefill tokens/s, peak memory) and profiled (busy time, idle
    share, launches)."""
    import torch
    from repro_torch.launch.steps import (make_prefill_step,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import forward, lm_init
    out = {}
    for arch, depth, b, s in PREFILL_RUNS:
        cfg = family_config(arch, depth)
        params = quantize_lm_for_serving(lm_init(
            torch.Generator(device=dev).manual_seed(0), cfg, dev),
            searched=False)
        toks = torch.randint(0, cfg.vocab, (b, s), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        ctx = serve_ctx(dev)
        modes = {"W4A4": (lambda: forward(params, cfg, toks, ctx=ctx),
                          PREFILL_LAUNCHES[arch]),
                 "weight-only": (lambda: make_prefill_step(cfg)(
                     params, {"tokens": toks}), weight_only_launches(arch))}
        allowed = ({("tied_logits", "torch")} if cfg.tie_embeddings
                   else {("matmul", "torch_f32")})
        if cfg.family == "moe":
            allowed = allowed | {("matmul", "torch_f32")}
        reduced = (f"; reduced: n_layers {cfg.n_layers} of "
                   f"{family_config(arch).n_layers}, widths as published"
                   if depth else "")
        for mode, (fn, want) in modes.items():
            name = f"{arch} prefill {mode}"
            needed = ["w4a4_matmul"] + (["msfp_qdq"] if want["msfp_qdq"]
                                        else [])

            def call(fn=fn):
                with torch.inference_mode():
                    y = fn()
                _sync()
                return y

            run = driven(name, call, needed, allowed)
            logits, counts = run["out"], run["counts"]
            if tuple(logits.shape) != (b, s, cfg.vocab) or not bool(
                    torch.isfinite(logits).all()):
                fail(f"{name}: logits {tuple(logits.shape)} not finite or "
                     f"not ({b}, {s}, {cfg.vocab})")
            del logits
            k2 = k2_modes(run["shapes"])
            got = {"w4a4": k2["w4a4"], "weight_only": k2["weight_only"],
                   "msfp_qdq": counts["msfp_qdq"]}
            if got != want:
                fail(f"{name}: launches a forward {got}, expected {want}")
            if any(counts[k] for k in ("kv4_store", "kv4_attend",
                                       "kv4_encode", "kv4_decode",
                                       "w4a4_conv2d", "qdq_conv2d")):
                fail(f"{name}: a kernel off the prefill path launched: "
                     f"{counts}")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            call()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            t1 = time.perf_counter()
            prof = profiled(call)
            prof_s = time.perf_counter() - t1
            print(f"prefill {name} B={b} S={s} bf16: wall {wall * 1e3:.2f} "
                  f"ms, {b * s / wall:.0f} prefill tokens/s, "
                  f"max_memory_allocated {peak:.2f} GiB; profiled wall "
                  f"{prof['profile_wall_ms']:.2f} ms, device busy "
                  f"{prof['busy_ms']:.3f} ms, idle share "
                  f"{prof['idle_share']:.3f}, {prof['launches']} CUDA kernel "
                  f"launches (profile {prof_s:.1f}s); launches a forward "
                  f"{got}{reduced}", flush=True)
            for line in prof.pop("top"):
                print(line, flush=True)
            out[name] = {"counts": counts, "units": 1, "unit": "forward",
                         "shapes": run["shapes"], "wall_ms": wall * 1e3,
                         "tokens_per_s": b * s / wall, "peak_gib": peak,
                         "launches_per_forward": got, "batch": b, "seq": s,
                         "n_layers": cfg.n_layers, "reduced": bool(depth),
                         **prof}
        del params, modes
        free_card()
    return out


@contextlib.contextmanager
def tf32_in_attention():
    """A control fault: the attention's two products (the f32 logits and
    the weighted sum) run with TF32 allowed, while the context is open
    (every f32 product of the forward turns TF32 off around itself, so a
    global TF32 setting reaches none of them)."""
    from repro_torch.nn import attention
    orig = attention.no_tf32
    attention.no_tf32 = tf32_allowed
    try:
        yield
    finally:
        attention.no_tf32 = orig


# phase 13(b), the prefill card vs CPU on power-of-two scales in f32:
# (arch, layers, mode, limit on the relative Frobenius error of the
# logits, the control faults that must break it, the setting: weights
# from ``steps.dyadic_weights(shift=)``, ``ssm_chunk``). "W4A4": under a
# serve context, acts snapped (exact W4A4 sums); "weight-only":
# make_prefill_step. The limits stand between the sound readings and the
# controls' on an NVIDIA H100 80GB HBM3 at 700.00 W: smollm-135m 4.26e-07
# (controls 0.522, 0.195). zamba2-2.7b at one group on dyadic_weights'
# own scale (absmax 0.75 over 2560 inputs) reaches dt 30, a chunk of 256
# steps sums its log-decays to -2e4, and the reference's segment sums
# (differences of those sums, repro/nn/ssm.py:75) carry an ulp of 2e-3
# into every decay factor: its W4A4 forward read 0.833 card vs CPU and
# the CPU alone moved 0.386 with its rms norms summed in f64, ties
# flipping. Its weights 2^-3 smaller and 16-step chunks keep dt and the
# sums small: W4A4 7.6e-07 (controls 0.656, 0.481), weight-only 2.5e-06
# (controls 0.00797, 0.00108). PERF.md records each limit's history.
PREFILL_CHECKS = (
    ("smollm-135m", 2, "W4A4", 1e-3,
     ("bf16 acts into K2", "TF32 in the attention"), {}),
    ("zamba2-2.7b", 6, "W4A4", 1e-3,
     ("bf16 acts into K2", "SSD inputs in bf16"),
     {"shift": 3, "ssm_chunk": 16}),
    ("zamba2-2.7b", 6, "weight-only", 1e-4,
     ("bf16 acts into K2", "SSD inputs in bf16"),
     {"shift": 3, "ssm_chunk": 16}))
PREFILL_CHECK_SHAPE = (2, 256)   # batch, sequence
# a row's premise: the CPU's own logits, its rms norms summed in f64, stay
# within this share of the row's limit (an ulp cannot reach the limit)
ULP_SHARE = 0.1


@contextlib.contextmanager
def rmsnorm_in_f64():
    """Every rms norm sums in f64 (results an ulp or so from the f32 sums)
    while the context is open: how far that moves the logits is how far
    ulps can."""
    from repro_torch.models import lm
    from repro_torch.nn import layers, ssm
    orig = layers.rmsnorm_apply

    def rms64(p, x, *, eps=1e-6, plus_one=False):
        xf = x.double()
        n = xf * (xf * xf).mean(-1, keepdim=True).add(eps).rsqrt()
        g = p["g"].double() + (1.0 if plus_one else 0.0)
        return (n * g).to(x.dtype)

    mods = (layers, lm, ssm)
    for m in mods:
        m.rmsnorm_apply = rms64
    try:
        yield
    finally:
        for m in mods:
            m.rmsnorm_apply = orig


@contextlib.contextmanager
def held_launches(name: str, exact: bool):
    """While the context is open, each K1 and K2 launch on the card is
    held against its plain version on the same inputs: K1 bit for bit, K2
    bit for bit where ``exact`` (W4A4 on power-of-two scales, whose sums
    are exact in any order), else by check_close, the f32 sum-order bound
    of the launch's K. Yields a dict by kernel: launches held, largest
    difference."""
    import torch
    from repro_torch.common.device import no_tf32
    from repro_torch.kernels import msfp_quant as k1
    from repro_torch.kernels import w4_matmul as k2
    plain = {"w4a4_matmul": k2.w4_matmul_2d_plain,
             "msfp_qdq": k1.msfp_qdq_2d_plain}
    held = {k: {"launches": 0, "max_abs_err": 0.0} for k in plain}

    def holder(kernel):
        def wrap(f):
            def launch(x, *a, **kw):
                y = f(x, *a, **kw)
                with no_tf32():
                    want = plain[kernel](x, *a, **{k: v for k, v in
                                                   kw.items() if k != "plan"})
                h = held[kernel]
                h["launches"] += 1
                what = f"{name}: {kernel} launch {h['launches']}"
                if kernel == "msfp_qdq" or exact:
                    if not torch.equal(y, want):
                        fail(f"{what} is not bit-exact with its plain "
                             f"version ({int((y != want).sum())} elements "
                             f"differ)")
                else:
                    check_close(what, y, want, k2_mag(x, *a, **kw),
                                x.shape[1])
                h["max_abs_err"] = max(h["max_abs_err"], float(
                    (y.float() - want.float()).abs().max()))
                return y
            return launch
        return wrap
    with wrapped_kernels({k: holder(k) for k in plain}):
        yield held


@contextlib.contextmanager
def ssd_inputs_in_bf16():
    """A control fault: each SSM layer's SSD scan takes its x, B and C
    rounded to bf16 (a low-precision scan), while the context is open."""
    from repro_torch.nn import ssm
    orig = ssm.ssd_scan

    def rounded(x, dt_a, b_mat, c_mat, chunk, init_state=None):
        r = (lambda t: t.bfloat16().to(t.dtype))
        return orig(r(x), dt_a, r(b_mat), r(c_mat), chunk, init_state)
    ssm.ssd_scan = rounded
    try:
        yield
    finally:
        ssm.ssd_scan = orig


def prefill_checks(dev) -> dict:
    """Phase 13(b): the forward at full width (depth and setting as
    PREFILL_CHECKS says), f32, on ``steps.dyadic_weights`` packs drawn on
    the card and copied to the host, the same tokens on both devices: the
    card (K2, K1) against the CPU (their plain versions), held to the
    row's limit, with each K2 and K1 launch of the card's forward held
    against its plain version (held_launches: bit for bit in the W4A4
    mode, by check_close in the weight-only mode, whose f32 acts make the
    products inexact); each control fault, rerun on the card, must break
    the limit; the CPU with its rms norms summed in f64 must stay within
    ULP_SHARE of it (the row's premise)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.launch.steps import (dyadic_weights, make_prefill_step,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import forward, lm_init
    from repro_torch.serving.weight_bank import _tree_to
    controls = {"bf16 acts into K2": bf16_act_kernels,
                "TF32 in the attention": tf32_in_attention,
                "SSD inputs in bf16": ssd_inputs_in_bf16}

    def run(cfg, params, device, toks, mode):
        with torch.inference_mode():
            if mode == "W4A4":
                y = forward(params, cfg, toks.to(device),
                            ctx=serve_ctx(device))
            else:
                y = make_prefill_step(cfg)(params,
                                           {"tokens": toks.to(device)})
        return y.double().cpu().numpy()

    def rel(g, w) -> float:
        return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))

    b, s = PREFILL_CHECK_SHAPE
    res, packs = {}, {}
    for arch, depth, mode, limit, names, setting in PREFILL_CHECKS:
        t0 = time.perf_counter()
        shift = setting.get("shift", 0)
        cfg = dataclasses.replace(family_config(arch, depth),
                                  dtype=torch.float32,
                                  **{k: v for k, v in setting.items()
                                     if k != "shift"})
        if (arch, shift) not in packs:
            packs.clear()
            free_card()
            packed = quantize_lm_for_serving(dyadic_weights(lm_init(
                torch.Generator(device=dev).manual_seed(0), cfg, dev),
                shift=shift), searched=False)
            packs[arch, shift] = (packed, _tree_to(packed,
                                                   torch.device("cpu")))
        packed, host = packs[arch, shift]
        toks = torch.randint(0, cfg.vocab, (b, s),
                             generator=torch.Generator().manual_seed(2))
        label = (f"{arch} depth {depth} {mode}"
                 + "".join(f" {k} {v}" for k, v in setting.items()))
        with held_launches(f"prefill {label}", mode == "W4A4") as held:
            g = run(cfg, packed, dev, toks, mode)
        if not np.isfinite(g).all():
            fail(f"{arch} prefill on the card is not finite")
        w = run(cfg, host, torch.device("cpu"), toks, mode)
        with rmsnorm_in_f64():
            ws = run(cfg, host, torch.device("cpu"), toks, mode)
        sound, ulps = rel(g, w), rel(ws, w)
        faults = {}
        for c in names:
            with controls[c]():
                faults[c] = rel(run(cfg, packed, dev, toks, mode), w)
        k2, k1 = held["w4a4_matmul"], held["msfp_qdq"]
        print(f"prefill {label} f32 B={b} S={s}, dyadic weights, card vs CPU "
              f"plain: relative Frobenius error {sound:.3g} (argmax equal "
              f"{bool((g.argmax(-1) == w.argmax(-1)).all())}), held to <= "
              f"{limit:g}; the CPU with its rms norms in f64 vs the CPU: "
              f"{ulps:.3g}, held to <= {ULP_SHARE * limit:g}; every launch "
              f"of the card's forward vs its plain version: K2 "
              f"{k2['launches']} "
              + ("bit-exact" if mode == "W4A4" else "by check_close")
              + f" (largest difference {k2['max_abs_err']:.3g}), K1 "
              f"{k1['launches']} bit-exact; control faults: "
              + "; ".join(f"{c}: {r:.3g}" for c, r in faults.items())
              + f" (wall {time.perf_counter() - t0:.1f}s)", flush=True)
        if sound > limit:
            fail(f"{label} prefill on the card disagrees with the plain CPU "
                 f"forward ({sound:.3g} > {limit:g})")
        if ulps > ULP_SHARE * limit:
            fail(f"{label}: an ulp moves the CPU's logits by {ulps:.3g}, "
                 f"beyond {ULP_SHARE:g} of the limit: the forward is too "
                 f"ill-conditioned for the check")
        if not k2["launches"]:
            fail(f"{label}: the card's forward launched no K2")
        for c, r in faults.items():
            if r <= limit:
                fail(f"{label}: control fault '{c}' passes the prefill check "
                     f"({r:.3g} <= {limit:g}): the check would not see it")
        res[label] = {"sound": sound, "ulp_sensitivity": ulps,
                      "held_launches": held, "controls": faults,
                      "limit": limit}
    del packed, host
    packs.clear()
    free_card()
    return res


# phase 13(c): (arch, batch, sequence, steps, checkpoint every) through
# launch/train.py at full width in bf16; smollm also resumed: 4 steps, then
# the launcher restarted from that checkpoint to 8
TRAIN_RUNS = (("smollm-135m", 8, 512, 8, 4),
              ("mamba2-370m", 4, 1024, 4, 100))
# the resumed run against the uninterrupted one: every loss and every
# leaf of the parameters and Adam's state equal bit for bit, which the
# control, the reference's resume (its token stream started again from the
# first batch), must break. A run is deterministic on the card: the
# batches are drawn by an inverse-CDF lookup (data/synthetic.py:zipf_cdf),
# since torch.multinomial's scan over the 1-D distribution moved up to 2 of
# 4096 draws between runs (the cause of the drift PR 20 read, 7.4e-05 on
# the losses and 1.65e-03 on the parameters); the embedding's backward
# read the same bits in 10 runs of 10 (NVIDIA H100 80GB HBM3, 700.00 W).


def bits_equal(a, b) -> bool:
    """Two trees of tensors, leaf for leaf the same dtype and bytes."""
    import torch
    from repro_torch.common.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def tree_rel(a, b) -> float:
    """Relative Frobenius error of tree ``a`` against tree ``b``."""
    import torch
    from repro_torch.common.tree import tree_leaves
    num = den = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.double() - y.double())
        num += float(torch.sum(d * d))
        den += float(torch.sum(y.double() ** 2))
    return math.sqrt(num / max(den, 1e-30))


@contextlib.contextmanager
def restarted_stream():
    """A control fault: the train launcher's token stream starts again
    from the first batch when a run resumes (the reference's launcher),
    while the context is open."""
    from repro_torch.launch import train
    orig, first = train.batch_of, []

    def batch_of(cfg, args, device, step):
        first[:] = first or [step]
        return orig(cfg, args, device, step - first[0])
    train.batch_of = batch_of
    try:
        yield
    finally:
        train.batch_of = orig


def resume_check(argv, cfg, steps: int, tmp: str, straight: dict) -> dict:
    """``steps // 2`` steps, then the launcher restarted from that
    checkpoint to ``steps``, against the uninterrupted run ``straight``:
    the losses and the final parameters and Adam state bit for bit (the
    relative errors printed beside); the same resume under
    ``restarted_stream`` must break it."""
    import shutil

    from repro_torch.launch import train
    half = steps // 2
    first = train.main(argv + ["--steps", str(half), "--ckpt-dir",
                               f"{tmp}/resumed"], cfg=cfg)
    shutil.copytree(f"{tmp}/resumed", f"{tmp}/control")
    runs = {"resumed": train.main(argv + ["--steps", str(steps), "--ckpt-dir",
                                          f"{tmp}/resumed"], cfg=cfg)}
    with restarted_stream():
        runs["control"] = train.main(argv + ["--steps", str(steps),
                                             "--ckpt-dir", f"{tmp}/control"],
                                     cfg=cfg)
    want = straight["losses"][half:]
    sp, so = straight["state"]
    out = {}
    for name, r in runs.items():
        if r["start"] != half or first["restarts"] or r["restarts"]:
            fail(f"resume: the restarted launcher started at step "
                 f"{r['start']} (restarts {first['restarts']}, "
                 f"{r['restarts']})")
        p, o = r["state"]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(r["losses"], want))
        out[name] = {"losses": r["losses"], "loss_rel_err": loss_err,
                     "params_rel_frobenius": tree_rel(p, sp),
                     "m_rel_frobenius": tree_rel(o["m"], so["m"]),
                     "v_rel_frobenius": tree_rel(o["v"], so["v"]),
                     "bit_exact": (first["losses"] + r["losses"]
                                   == straight["losses"]
                                   and bits_equal(r["state"],
                                                  straight["state"]))}
    res, ctl = out["resumed"], out["control"]
    print(f"train resumed ({half} steps, then the launcher restarted from "
          f"step {half} to {steps}) vs uninterrupted: losses "
          f"{first['losses'] + res['losses']} against {straight['losses']}; "
          f"bit-exact {res['bit_exact']} (held to equality of every loss "
          f"and every leaf); largest loss relative error "
          f"{res['loss_rel_err']:.3g}, relative Frobenius error of the "
          f"parameters {res['params_rel_frobenius']:.3g}, of Adam's m "
          f"{res['m_rel_frobenius']:.3g} and v {res['v_rel_frobenius']:.3g};"
          f" control (the token stream restarted): bit-exact "
          f"{ctl['bit_exact']}, loss {ctl['loss_rel_err']:.3g}, parameters "
          f"{ctl['params_rel_frobenius']:.3g}", flush=True)
    if not res["bit_exact"]:
        fail("the resumed run does not equal the uninterrupted one bit for "
             "bit")
    if ctl["bit_exact"]:
        fail("control fault 'token stream restarted' passes the resume "
             "check")
    return {k: {f: v for f, v in r.items() if f != "losses"}
            for k, r in out.items()}


def train_runs(dev, tmp: str) -> dict:
    """Phase 13(c): TRAIN_RUNS through ``launch/train.main`` (random
    weights and zipf batches from the seed on the card, Adam under the
    reference's schedule, checkpoints under ``tmp``): every loss finite,
    no contained crash (``restarts`` 0), then one more step of the
    launcher's own train step, on its next batch, profiled; smollm's resumed run held to the uninterrupted
    one (``resume_check``)."""
    from repro_torch.common.sharding import to_full
    from repro_torch.launch import train
    out = {}
    for arch, b, s, steps, every in TRAIN_RUNS:
        argv = ["--arch", arch, "--batch", str(b), "--seq", str(s),
                "--ckpt-every", str(every), "--device", "cuda"]
        name = f"{arch} train"
        print(f"--- train: {name} B={b} S={s}, {steps} steps", flush=True)
        cfg = family_config(arch)
        t0 = time.perf_counter()
        r = train.main(argv + ["--steps", str(steps), "--ckpt-dir",
                               f"{tmp}/{arch}-straight"], cfg=cfg)
        wall = time.perf_counter() - t0
        losses = r["losses"]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"{name}: losses {losses}")
        if r["restarts"]:
            fail(f"{name}: the trainer contained {r['restarts']} crashes")
        walls = sorted(h.wall for h in r["history"])
        med = walls[len(walls) // 2]
        # the launcher's own step, meshless: its state comes back whole
        batch = {k: to_full(v) for k, v in r["data"](steps).items()}
        params, opt = r["state"]
        step = r["step"]
        t1 = time.perf_counter()
        prof = profiled(lambda: step(params, opt, batch))
        prof_s = time.perf_counter() - t1
        top = prof.pop("top")
        row = {"losses": losses, "step_wall_ms_median": med * 1e3,
               "tokens_per_s": b * s / med,
               "peak_gib": r["peak_bytes"] / 2**30, "run_wall_s": wall,
               "stragglers": r["stragglers"], **prof}
        print(f"train {name} bf16 B={b} S={s}: {steps} steps, loss[0] "
              f"{losses[0]:.4f} loss[-1] {losses[-1]:.4f}, median step wall "
              f"{med * 1e3:.1f} ms ({b * s / med:.0f} tokens/s), "
              f"max_memory_allocated {row['peak_gib']:.2f} GiB; profiled "
              f"step wall {prof['profile_wall_ms']:.1f} ms, device busy "
              f"{prof['busy_ms']:.2f} ms, idle share "
              f"{prof['idle_share']:.3f}, {prof['launches']} CUDA kernel "
              f"launches (profile {prof_s:.1f}s); stragglers "
              f"{r['stragglers']}, run wall {wall:.1f}s", flush=True)
        for line in top:
            print(line, flush=True)
        del params, opt, batch, step
        if arch == "smollm-135m":
            t1 = time.perf_counter()
            row["resume"] = resume_check(argv, cfg, steps,
                                         f"{tmp}/{arch}", r)
            print(f"resume check wall {time.perf_counter() - t1:.1f}s",
                  flush=True)
        del r
        free_card()
        out[name] = row
    return out


# phase 13(d): one f32 train step's loss and gradients card vs CPU at
# smollm-135m's full width, 2 layers, B 2 x S 128: the worst leaf's
# relative Frobenius error held to this limit, between the sound reading
# and the TF32-in-the-backward control
TRAIN_GRAD_LIMIT = 1e-4
TRAIN_LOSS_LIMIT = 1e-5        # relative
LEARN_STEPS, LEARN_LR = 5, 5e-3


@contextlib.contextmanager
def tf32_train_backward():
    """A control fault: the train step runs with TF32 allowed; the
    forward's products set it off around themselves, so it reaches the
    backward's products only."""
    from repro_torch.launch import steps
    orig = steps.no_tf32
    steps.no_tf32 = tf32_allowed
    try:
        yield
    finally:
        steps.no_tf32 = orig


def train_checks(dev) -> dict:
    """Phase 13(d): five make_train_step steps on one fixed batch at lr
    5e-3 (the reference's test_arch_train_step_decreases_loss recipe) at
    smollm-135m's full width in bf16 must lower the loss; then one f32
    loss and gradient (the train step's value_and_grad, TF32 off) card vs
    CPU at 2 layers, held to TRAIN_LOSS_LIMIT and TRAIN_GRAD_LIMIT, which
    the TF32-in-the-backward control must break."""
    import dataclasses

    import torch
    from repro_torch.common.tree import flatten_paths
    from repro_torch.launch import steps
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.adam import AdamConfig, adam_init
    from repro_torch.serving.weight_bank import _tree_to
    cfg = family_config("smollm-135m")
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 128), device=dev,
                                     generator=torch.Generator(device=dev)
                                     .manual_seed(3))}
    acfg = AdamConfig(lr=LEARN_LR)
    opt = adam_init(params, acfg)
    step = steps.make_train_step(cfg, acfg)
    losses = []
    for _ in range(LEARN_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    print(f"train smollm-135m bf16 full width, {LEARN_STEPS} steps on one "
          f"fixed batch (B 2 x S 128) at lr {LEARN_LR:g}: losses {losses}",
          flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"five train steps on a fixed batch did not lower the loss: "
             f"{losses}")
    del params, opt, step
    free_card()

    cfg = dataclasses.replace(family_config("smollm-135m", 2),
                              dtype=torch.float32)
    params = lm_init(torch.Generator(device=dev).manual_seed(4), cfg, dev)
    host = _tree_to(params, torch.device("cpu"))
    tb = {"tokens": torch.randint(0, cfg.vocab, (2, 128),
                                  generator=torch.Generator().manual_seed(5))}

    def grads(p, device):
        # the train step's value_and_grad under its TF32 setting, looked
        # up at call time so the control can replace it
        with steps.no_tf32():
            loss, g = steps.value_and_grad(
                p, cfg, {"tokens": tb["tokens"].to(device)})
        return float(loss), {k: v.double().cpu()
                             for k, v in flatten_paths(g).items()}

    def worst(g, w) -> tuple[float, str]:
        errs = {k: float(torch.linalg.norm(g[k] - w[k])
                         / max(float(torch.linalg.norm(w[k])), 1e-30))
                for k in w}
        k = max(errs, key=errs.get)
        return errs[k], k

    lw, gw = grads(host, torch.device("cpu"))
    lg, gg = grads(params, dev)
    loss_err = abs(lg - lw) / abs(lw)
    sound, leaf = worst(gg, gw)
    with tf32_train_backward():
        _, gt = grads(params, dev)
    control, cleaf = worst(gt, gw)
    print(f"train step smollm-135m depth 2 f32 B 2 x S 128, card vs CPU: "
          f"loss {lg:.6f} vs {lw:.6f} (relative error {loss_err:.3g}, held "
          f"to <= {TRAIN_LOSS_LIMIT:g}); worst leaf's gradient relative "
          f"Frobenius error {sound:.3g} ({leaf}), held to <= "
          f"{TRAIN_GRAD_LIMIT:g}; control TF32 in the backward: {control:.3g}"
          f" ({cleaf})", flush=True)
    if loss_err > TRAIN_LOSS_LIMIT or sound > TRAIN_GRAD_LIMIT:
        fail("the train step on the card disagrees with the CPU's")
    if control <= TRAIN_GRAD_LIMIT:
        fail(f"control fault 'TF32 in the backward' passes the gradient "
             f"check ({control:.3g} <= {TRAIN_GRAD_LIMIT:g})")
    del params, host
    free_card()
    return {"losses": losses, "loss_rel_err": loss_err,
            "grad_worst_rel": sound, "grad_worst_leaf": leaf,
            "tf32_backward_control": control}


def prefill_train_phase(dev) -> dict:
    """Phase 13: (a) prefill runs, (b) prefill card vs CPU, (c) the train
    launcher, (d) learning and one train step card vs CPU; its wall."""
    print("--- the LM full-sequence forward and training at full width",
          flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"prefill": prefill_runs(dev), "checks": prefill_checks(dev),
               "train": train_runs(dev, tmp), "train_checks":
               train_checks(dev)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"prefill and training phase wall {out['wall_s']:.1f} s",
          flush=True)
    return out


# phase 14(a): the launcher's run under the mesh and the meshless control
MESH_TRAIN_ARGV = ["--arch", "smollm-135m", "--batch", "8", "--seq", "512",
                   "--steps", "4", "--ckpt-every", "100", "--device", "cuda"]


def mesh_train(dev, tmp: str) -> dict:
    """Phase 14(a): smollm-135m through launch/train.main on the 1-rank
    mesh (DTensor parameters and batches) against its step function on
    plain tensors from the same seed and batches: losses, parameters and
    Adam state bit for bit; the median step walls of both."""
    import torch
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.adam import AdamConfig, adam_init
    cfg = family_config("smollm-135m")
    argv = MESH_TRAIN_ARGV + ["--ckpt-dir", f"{tmp}/mesh-train"]
    meshed = train.main(argv, cfg=cfg)
    args = train.build_parser().parse_args(argv)
    acfg = AdamConfig(lr=args.lr, schedule="linear_warmup_cosine",
                      warmup_steps=max(10, args.steps // 20),
                      total_steps=args.steps)
    params = lm_init(torch.Generator(device=dev).manual_seed(args.seed),
                     cfg, dev)
    opt, step = adam_init(params, acfg), make_train_step(cfg, acfg)
    losses, walls = [], []
    for i in range(args.steps):
        batch = train.batch_of(cfg, args, dev, i)
        _sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        _sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    mesh_walls = sorted(h.wall for h in meshed["history"])
    out = {"losses": losses, "mesh_losses": meshed["losses"],
           "bit_exact": (losses == meshed["losses"]
                         and bits_equal((params, opt), meshed["state"])),
           "mesh_step_wall_ms_median": mesh_walls[len(mesh_walls) // 2] * 1e3,
           "plain_step_wall_ms_median": sorted(walls)[len(walls) // 2] * 1e3,
           "mesh_step_walls_ms": [h.wall * 1e3 for h in meshed["history"]],
           "plain_step_walls_ms": [w * 1e3 for w in walls]}
    print(f"mesh train smollm-135m bf16 B 8 x S 512, {args.steps} steps on "
          f"the 1-rank mesh vs meshless: losses {meshed['losses']} vs "
          f"{losses}; bit-exact {out['bit_exact']} (held to equality of "
          f"every loss, parameter and moment); median step wall "
          f"{out['mesh_step_wall_ms_median']:.1f} ms meshed (DTensor) vs "
          f"{out['plain_step_wall_ms_median']:.1f} ms meshless; walls "
          f"{[round(w, 1) for w in out['mesh_step_walls_ms']]} vs "
          f"{[round(w, 1) for w in out['plain_step_walls_ms']]}", flush=True)
    if not out["bit_exact"]:
        fail("the meshed train run does not equal the meshless one")
    del params, opt, meshed
    free_card()
    return out


def mesh_serve() -> dict:
    """Phase 14(b): smollm-135m served through launch/serve.main under the
    host mesh (phase 7's argv, counted as a path) against the same run
    meshless (``serve.serve``): token ids and launches a step equal."""
    import torch
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(LM_ARGV)
    plain = serve.serve(args, torch.device("cuda"))
    run = driven("smollm-135m serve under the mesh",
                 lambda: serve.main(LM_ARGV), LM_KERNELS,
                 {("tied_logits", "torch")})
    meshed = run["out"]
    same = (torch.equal(plain["tokens"], meshed["tokens"])
            and plain["launches_per_step"] == meshed["launches_per_step"])
    print(f"mesh serve smollm-135m W4A4 FP4-KV B {B}: token ids and launches "
          f"a step identical to the meshless run: {same} (launches a step "
          f"{meshed['launches_per_step']}); {meshed['tok_s']:.2f} tok/s "
          f"meshed vs {plain['tok_s']:.2f} meshless", flush=True)
    if not same:
        fail("the meshed serve run differs from the meshless one")
    return {"counts": run["counts"], "units": meshed["steps"],
            "unit": "decode step", "shapes": run["shapes"],
            "tok_s": meshed["tok_s"], "plain_tok_s": plain["tok_s"],
            "identical": same}


def mesh_moe(dev, mesh) -> dict:
    """Phase 14(c): llama4-scout at LLAMA4_DEPTH layers, bf16 weights drawn
    on the card, one B 8 x S 512 forward with moe_impl "ep" on the 1-rank
    mesh against "global": the logits bit for bit. On one rank the
    expert-parallel path dispatches the same tokens into the same
    capacity and its all-to-all is a copy, so any difference is a fault
    of the path."""
    import dataclasses

    import torch
    from repro_torch.common.tree import tree_bytes
    from repro_torch.launch.mesh import mesh_scope
    from repro_torch.models.lm import forward, lm_init
    cfg = family_config("llama4-scout-17b-a16e", LLAMA4_DEPTH)
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    toks = torch.randint(0, cfg.vocab, (B, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    out, walls = {}, {}
    with torch.no_grad(), mesh_scope(mesh):
        for impl in ("global", "ep"):
            c = dataclasses.replace(cfg, moe_impl=impl)
            _sync()
            t0 = time.perf_counter()
            out[impl] = forward(params, c, toks)
            _sync()
            walls[impl] = (time.perf_counter() - t0) * 1e3
    same = torch.equal(out["ep"].view(torch.int16),
                       out["global"].view(torch.int16))
    gib = tree_bytes(params) / 2**30
    print(f"mesh moe llama4-scout-17b-a16e depth {LLAMA4_DEPTH} bf16 "
          f"({gib:.1f} GiB of weights) B {B} x S 512: moe_impl ep vs global "
          f"logits bit for bit {same}; forward wall {walls['ep']:.1f} ms ep, "
          f"{walls['global']:.1f} ms global; reduced: n_layers "
          f"{cfg.n_layers} of {family_config('llama4-scout-17b-a16e').n_layers},"
          f" widths as published", flush=True)
    if not same:
        fail("the expert-parallel forward differs from the global one")
    del params, out
    free_card()
    return {"bit_exact": same, "forward_ms": walls, "weights_gib": gib}


def mesh_phase(dev, resume: dict) -> dict:
    """Phase 14: (a) mesh_train, (b) mesh_serve, (c) mesh_moe on the
    1-rank mesh the process group carries; (d) phase 13(c)'s resume
    (``resume``), held bit for bit there; the phase's wall."""
    from repro_torch.launch.mesh import make_host_mesh
    print("--- the distribution layer on a 1-rank mesh at full width",
          flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"train": mesh_train(dev, tmp)}
    out["serve"] = mesh_serve()
    out["moe_ep"] = mesh_moe(dev, make_host_mesh())
    out["resume_bit_exact"] = resume["resumed"]["bit_exact"]
    out["wall_s"] = time.perf_counter() - t0
    print(f"mesh phase wall {out['wall_s']:.1f} s (the resume, phase 13(c): "
          f"bit-exact {out['resume_bit_exact']})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 15: the dry run on the card's machine; gemma3-4b decode_32k (W4,
# FP4 KV) whole on the card against its prediction; kv4_attend past one
# block's shared memory.
# ---------------------------------------------------------------------------

# (a) production cells at full width and depth over fake worlds, each a
# process of its own (the dry run owns its default process group)
DRYRUN_CELLS = {
    "gemma3-4b decode_32k single w4 fp4": [
        "--arch", "gemma3-4b", "--shape", "decode_32k", "--mesh", "single",
        "--quant", "w4", "--kv", "fp4"],
    "smollm-135m train_4k single": [
        "--arch", "smollm-135m", "--shape", "train_4k", "--mesh", "single"],
    "llama4-scout-17b-a16e prefill_32k multi w4 moeep": [
        "--arch", "llama4-scout-17b-a16e", "--shape", "prefill_32k",
        "--mesh", "multi", "--quant", "w4", "--opts", "moeep"]}
# (b)'s prediction on the card's one-rank mesh, and the control traced
# through the kernels' plain versions
PREDICTION_ARGV = ["--arch", "gemma3-4b", "--shape", "decode_32k",
                   "--mesh-shape", "1,1", "--quant", "w4", "--kv", "fp4"]
DRYRUN_RUNS = {**DRYRUN_CELLS, "prediction": PREDICTION_ARGV,
               "control": PREDICTION_ARGV + ["--plain-routes"]}
CARD_BYTES = 80e9             # an H100's device memory
CELL_B, CELL_S, CELL_STEPS = 128, 32768, 3   # decode_32k's batch and cache
# (b): the step's peak above its arguments, card against prediction, in
# bytes either way. Set from the readings: on an NVIDIA H100 80GB HBM3 at
# 700.00 W all three steps' peaks equalled the prediction (137103360 B) to
# the byte, so the limit is a few MiB of allocator rounding; a doubled or
# leaked kv4_attend workspace (134217728 B at this cell) breaks it, as
# does the plain-route control (64.5 GB)
PEAK_LIMIT = 2 * 2**20
ALLOC_ROUND = 512             # the caching allocator's smallest block
# (c): kv4_attend past one block's shared memory: (B, n_kv, G, hd, slots)
KV4_LONG = ((8, 4, 2, 256, 32768), (8, 8, 5, 128, 16384))
# (d): gemma3-4b at B 8 over a 32768-slot cache, 3 teacher-forced steps
# from each seed's cache and tokens (seed 0 with every launch held against
# its plain version on its own inputs: K2 and K1 bit for bit on
# power-of-two scales, kv4_store's slot bit for bit, kv4_attend within
# kv4_attend_allowed). The logits through the kernels are held as phase 12
# holds them (KERNELS_VS_PLAIN_LIMIT, relative Frobenius) against the plain
# versions with kv4_attend's plain version summed in the kernel's order
# (kv4_attend_index_order). Against the plain version as it stands
# (cuBLAS's order of the same f32 sums, which at 32768 slots is not the
# kernel's index order) the logits are read and printed, not held: a sum
# an ulp apart moves an E2M1 act code at the next dense site, and that
# moves whole decode steps (ROADMAP Queue C; an NVIDIA H100 80GB HBM3 at
# 700.00 W read 0.129 at seed 0)
LONG_DECODE_B = 8
LONG_DECODE_SEEDS = (0, 1, 2)


def start_dryruns(tmp: str) -> dict:
    """Phase 15(a): every DRYRUN_RUNS entry started as
    ``python -m repro_torch.launch.dryrun``, each writing its record under
    its own directory of ``tmp``; the CPU traces run while the card works
    on (c) and (d)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for name, argv in DRYRUN_RUNS.items():
        out = pathlib.Path(tmp) / name.replace(" ", "_")
        procs[name] = (out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", str(out)], cwd=str(ROOT), env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def finish_dryruns(procs: dict) -> dict:
    """Phase 15(a): each run's record, which must read ok; the production
    cells' per-device bytes (against the card's 80 GB), flops and
    collective bytes by op printed."""
    recs, failed = {}, []
    for name, (out, t0, p) in procs.items():
        try:
            log, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for _, _, q in procs.values():
                q.kill()
            fail(f"dry run {name}: no record within 600 s")
        files = sorted(out.glob("*.json"))
        rec = json.loads(files[0].read_text()) if files else {}
        if p.returncode != 0 or not rec.get("ok"):
            print(f"dry run {name} (rc {p.returncode}) FAILED: "
                  f"{rec.get('error', '')}\n{log[-3000:]}", flush=True)
            failed.append(name)
            continue
        rec["wall_s"] = time.perf_counter() - t0
        recs[name] = rec
        if name not in DRYRUN_CELLS:
            continue
        mem = rec["memory"]
        held = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                + mem["temp_size_in_bytes"])
        print(f"dry run {name} ({rec['chips']} fake ranks, torch "
              f"{__import__('torch').__version__}): ok; per device "
              f"arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, "
              f"outputs {mem['output_size_in_bytes'] / 1e9:.3f} GB, temp "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB: "
              f"{held / 1e9:.3f} GB against {CARD_BYTES / 1e9:.0f} GB; "
              f"flops {rec['cost']['flops']:.4g}, bytes accessed "
              f"{rec['cost']['bytes accessed']:.4g}, collectives by op "
              f"{ {k: f'{v / 1e9:.3f} GB' for k, v in rec['collectives']['bytes_by_op'].items()} }"
              f"; traced in {rec['compile_s']} s ({rec['ops']} local ops), "
              f"run wall {rec['wall_s']:.1f} s", flush=True)
    if failed:
        fail(f"dry runs {failed} did not read ok")
    return recs


def kv4_long_checks(dev) -> dict:
    """Phase 15(c): kv4_attend at KV4_LONG, every slot valid, bf16, on a
    cache of finite garbage (random codes, f16 scales in [0, 4)): the
    logits past one block's shared memory go to the global workspace, held
    to kv4_attend_allowed against the plain version and bit for bit against
    kv4_attend_index_order (the plain version summed in the kernel's
    order), and timed by CUDA-graph
    replays beside SDPA over the decoded cache and the bound (as
    kv4_pair_checks); at 2048 slots, at smollm-135m's and gemma3-4b's
    heads, the shared-memory path and a forced workspace launch give the
    same bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import kv4 as k45
    gen = torch.Generator().manual_seed(15)

    def cache(b, slots, n_kv, hd):
        codes = (b, slots, n_kv, hd // 2)
        return [torch.randint(0, 256, codes, generator=gen,
                              dtype=torch.uint8).to(dev) for _ in range(2)] \
            + [(torch.rand(b, slots, n_kv, generator=gen) * 4).half().to(dev)
               for _ in range(2)]

    def draw(*shape):
        return (torch.randn(*shape, generator=gen) * 8).to(dev,
                                                           torch.bfloat16)

    rows, same = [], {}
    for b, n_kv, g, hd in ((B, 3, 3, 64), (B, 4, 2, 256)):
        c, q = cache(b, 2048, n_kv, hd), draw(b, n_kv, g, hd)
        args = (2048, hd ** -0.5, None)
        shared = k45.kv4_attend_cuda(q, *c, *args, workspace=False)
        ws = k45.kv4_attend_cuda(q, *c, *args, workspace=True)
        label = f"B{b} S2048 K{n_kv} G{g} hd{hd} bf16"
        if not torch.equal(shared.view(torch.int16), ws.view(torch.int16)):
            fail(f"kv4_attend {label}: the workspace path's bits differ "
                 "from the shared-memory path's")
        same[label] = {
            "shared_ms": cuda_ms(lambda: k45.kv4_attend_cuda(
                q, *c, *args, workspace=False)),
            "workspace_ms": cuda_ms(lambda: k45.kv4_attend_cuda(
                q, *c, *args, workspace=True))}
        print(f"kv4_attend {label}: the workspace path equals the "
              f"shared-memory path bit for bit; {same[label]['shared_ms']:.4f}"
              f" ms shared, {same[label]['workspace_ms']:.4f} ms workspace",
              flush=True)
        del c, q, shared, ws
    for b, n_kv, g, hd, slots in KV4_LONG:
        if k45.attend_logits_shared(g, hd, slots):
            fail(f"kv4_attend G{g} hd{hd} S{slots} would not take the "
                 "workspace path")
        c, q = cache(b, slots, n_kv, hd), draw(b, n_kv, g, hd)
        args = (slots, hd ** -0.5, None)
        got = k45.kv4_attend_cuda(q, *c, *args)
        want = k45.kv4_attend_plain(q, *c, *args)
        allowed = k45.kv4_attend_allowed(q, *c, *args, want)
        diff = (got.double() - want.double()).abs()
        label = f"B{b} S{slots} valid {slots} K{n_kv} G{g} hd{hd} bf16"
        if bool((diff > allowed).any()):
            fail(f"kv4_attend {label}: {int((diff > allowed).sum())} "
                 f"elements outside kv4_attend_allowed (max abs err "
                 f"{float(diff.max()):.3g})")
        witness = kv4_attend_index_order(q, *c, *args)
        if not torch.equal(got.view(torch.int16), witness.view(torch.int16)):
            fail(f"kv4_attend {label}: the kernel's bits differ from its "
                 "plain version summed in the kernel's order")
        n_off_plain = int((got != want).sum())
        del witness
        err = float(diff.max())
        share = float((diff / allowed).max())
        del allowed, diff
        ms = cuda_ms(lambda: k45.kv4_attend_cuda(q, *c, *args))
        plain_ms = cuda_ms(lambda: k45.kv4_attend_plain(q, *c, *args))
        keys, vals = (k45._decode_cache(x, sc, torch.bfloat16)
                      .transpose(1, 2).contiguous()
                      for x, sc in ((c[0], c[2]), (c[1], c[3])))
        qs = q.reshape(b, n_kv * g, 1, hd)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, keys, vals, enable_gqa=True))
        b_ms, b_by = bound(
            4.0 * b * n_kv * g * slots * hd,
            2 * 2 * b * n_kv * g * hd + 2 * b * slots * n_kv * (hd // 2 + 2),
            f32_ops=2.0 * 2 * b * n_kv * slots * hd)
        print(f"kv4_attend {label} (logits in the global workspace): max "
              f"abs err {err:.3g}, largest share of the allowance "
              f"{share:.3g}, {n_off_plain} elements off the plain version's "
              "bits, none off those of the plain version summed in the "
              f"kernel's order; {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"over the decoded cache {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        rows.append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention(enable_gqa=True), "
                    "attention only, cache pre-decoded",
            logits="global workspace"))
        del c, q, got, want, keys, vals, qs
        free_card()
    return {"rows": rows, "same_bits_2048": same}


def garbage_cache(caches, upto: int, gen) -> None:
    """Random codes and f16 scales in [0, 4) written into every FP4 cache
    of ``caches`` (a tree of local tensors) below slot ``upto``."""
    import torch
    from repro_torch.common.tree import flatten_paths
    for path, t in flatten_paths(caches).items():
        t = t.to_local() if hasattr(t, "to_local") else t
        s_dim = t.ndim - (2 if path.endswith("_scale") else 3)
        n = min(upto, t.shape[s_dim])
        part = t.narrow(s_dim, 0, n)
        if t.dtype == torch.uint8:
            part.copy_(torch.randint(0, 256, part.shape, generator=gen,
                                     dtype=torch.uint8))
        else:
            part.copy_((torch.rand(part.shape, generator=gen) * 4).half())


def fma_is_fused(dev) -> None:
    """kv4_attend_index_order's chains rest on ``torch.addcmul_`` being one
    fused multiply-add on the card, as the kernel's fmaf is: (1 + 2^-13)
    (1 - 2^-13) - 1 is -2^-26 fused and 0 with the product rounded first
    (broadcast operands, as the chains give them)."""
    import torch
    acc = torch.full((4, 2, 8), -1.0, device=dev)
    acc.addcmul_(torch.full((4, 2, 1), 1 + 2**-13, device=dev),
                 torch.full((4, 1, 8), 1 - 2**-13, device=dev))
    if not bool((acc == -2.0**-26).all()):
        fail("torch.addcmul_ on the card is not a fused multiply-add: the "
             "kernel-order witness cannot stand in for kv4_attend's sums")


def kv4_attend_index_order(q, k, v, k_scale, v_scale, valid_len, scale,
                           softcap=None, **_):
    """kv4_attend's plain version with its f32 sums in the kernel's order
    (csrc/kv4.cu:kv4_attend_kernel), from torch ops alone: a logit one FMA
    chain over h = 0..hd-1 from zero, times the scale, the softcap; the
    softmax's sum per thread t < 128 over slots t, t + 128, ..., then a
    butterfly over each warp's 32 lanes and the four warps added in order;
    the weights divided by it and rounded to the load dtype; an output one
    FMA chain over s = 0..valid-1 from zero, rounded to the load dtype.
    Each decoded value is K5's (kv4._decode_cache), as in the plain
    version. ``addcmul_`` is the FMA (fma_is_fused)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import kv4 as k45
    dt, n = q.dtype, int(valid_len)
    b, n_kv, g, hd = q.shape
    keys = k45._decode_cache(k[:, :n], k_scale[:, :n], dt).float()
    qf = q.float()
    kt = keys.permute(0, 2, 3, 1)                    # (B, K, hd, n)
    lg = torch.zeros(b, n_kv, g, n, device=q.device)
    for h in range(hd):
        lg.addcmul_(qf[..., h, None], kt[:, :, None, h])
    del keys, kt
    lg = lg * scale
    if softcap:
        lg = softcap * torch.tanh(lg / softcap)
    e = torch.exp(lg - lg.amax(-1, keepdim=True))
    per = F.pad(e, (0, -n % 128)).unflatten(-1, (-1, 128))
    part = per[..., 0, :].clone()
    for c in range(1, per.shape[-2]):
        part += per[..., c, :]
    lanes = part.unflatten(-1, (4, 32))
    idx = torch.arange(32, device=q.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ off]
    r = lanes[..., 0]
    total = ((r[..., 0] + r[..., 1]) + r[..., 2]) + r[..., 3]
    w = (e / total[..., None]).to(dt).float()
    vals = k45._decode_cache(v[:, :n], v_scale[:, :n], dt).float()
    ws = w.unsqueeze(-2).unbind(-1)                  # n x (B, K, G, 1)
    vs = vals.permute(0, 2, 1, 3).unsqueeze(2).unbind(3)  # n x (B, K, 1, hd)
    o = torch.zeros(b, n_kv, g, hd, device=q.device)
    for i in range(n):
        o.addcmul_(ws[i], vs[i])
    return o.to(dt)


def long_decode_checks(dev) -> dict:
    """Phase 15(d): gemma3-4b at full width, W4A4 on steps.dyadic_weights
    with the FP4 cache, B 8 over a 32768-slot cache of finite garbage below
    slot 32765, three teacher-forced steps at positions 32765-32767 (the
    global and first_k_dense layers attend over up to 32768 slots through
    the workspace path; the local layers over their 1024-slot rings), for
    each LONG_DECODE_SEEDS seed's cache and tokens: through the kernels
    (seed 0 with every launch held), through their plain versions with
    kv4_attend's summed in the kernel's order (the witness), and through
    their plain versions as they stand, on the card from the same caches.
    The kernels' logits against the witness's are held to
    KERNELS_VS_PLAIN_LIMIT as phase 12 holds them; against the plain
    versions' they are read. A control, kv4_attend one slot short, must
    break both the launch holds and the limit."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import init_caches, lm_init
    t0 = time.perf_counter()
    fma_is_fused(dev)
    cfg = dataclasses.replace(family_config("gemma3-4b"), kv_dtype="fp4")
    packed = quantize_lm_for_serving(dyadic_weights(lm_init(
        torch.Generator(device=dev).manual_seed(0), cfg, dev)),
        searched=False)
    free_card()
    first = CELL_S - CELL_STEPS
    name = "gemma3-4b decode over 32768 slots"
    others = ("w4a4_matmul", "msfp_qdq", "kv4_store")

    def run(base, toks):
        from repro_torch.common.tree import tree_map
        caches = tree_map(lambda t: t.clone(), base)
        step = make_decode_fn(cfg, ctx=serve_ctx(dev))
        out = []
        with torch.inference_mode():
            for i in range(CELL_STEPS):
                lg, caches = step(packed, caches, toks[:, i:i + 1].to(dev),
                                  first + i)
                out.append(lg.float().cpu())
        return torch.stack(out).double().numpy()

    def reading(a, b) -> dict:
        return {"rel_frobenius": float(np.linalg.norm(a - b)
                                       / max(np.linalg.norm(b), 1e-30)),
                "max_abs_over_max": float(np.abs(a - b).max()
                                          / np.abs(b).max()),
                "argmax_equal": bool((a.argmax(-1) == b.argmax(-1)).all())}

    def short(f):
        def attend(q, k, v, ks, vs, valid, *a, **kw):
            return f(q, k, v, ks, vs, valid - 1, *a, **kw)
        return attend

    seeds, held, held4, held_c, ctrl, per_step = {}, None, None, None, None, None
    for seed in LONG_DECODE_SEEDS:
        t1 = time.perf_counter()
        base = init_caches(cfg, LONG_DECODE_B, CELL_S, dev)
        garbage_cache(base, first, torch.Generator().manual_seed(16 + seed))
        toks = torch.randint(0, cfg.vocab, (LONG_DECODE_B, CELL_STEPS),
                             generator=torch.Generator().manual_seed(1 + seed))
        reset_counts()
        if seed == LONG_DECODE_SEEDS[0]:
            with held_launches(name, exact=True) as held, \
                    held_kv4(name, strict=True) as held4:
                g = run(base, toks)
            counts = launch_counts()
            per_step = {k: counts[k] / CELL_STEPS
                        for k in ("w4a4_matmul", "kv4_store", "kv4_attend",
                                  "msfp_qdq")}
        else:
            g = run(base, toks)
        if not np.isfinite(g).all():
            fail(f"{name} (seed {seed}) is not finite")
        with plain_kernels(others), wrapped_kernels(
                {"kv4_attend": lambda _: kv4_attend_index_order}):
            gw = run(base, toks)
        with plain_kernels(others + ("kv4_attend",)):
            gp = run(base, toks)
        if seed == LONG_DECODE_SEEDS[0]:
            with wrapped_kernels({"kv4_attend": short}), \
                    held_kv4(name + " (control)", strict=False) as held_c:
                ctrl = reading(run(base, toks), gw)
        seeds[seed] = {"kernels_vs_witness": reading(g, gw),
                       "kernels_vs_plain": reading(g, gp),
                       "witness_vs_plain": reading(gw, gp),
                       "wall_s": time.perf_counter() - t1}
        print(f"decode gemma3-4b W4A4 FP4-KV B={LONG_DECODE_B}, seed {seed}, "
              f"{CELL_STEPS} teacher-forced steps at positions {first}-"
              f"{CELL_S - 1} of a {CELL_S}-slot cache, dyadic weights, on "
              f"the card: {seeds[seed]}", flush=True)
        del base
        free_card()
    print(f"{name}: every launch of seed {LONG_DECODE_SEEDS[0]} held: K2/K1 "
          f"{held}, kv4 {held4}; the kernels vs the kernel-order witness "
          f"held to <= {KERNELS_VS_PLAIN_LIMIT:g}; the control, kv4_attend "
          f"one slot short, vs the witness: {ctrl}, launches outside their "
          f"hold {held_c}; launches a step {per_step} (wall "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)
    if held_c["kv4_attend"]["outside"] == 0:
        fail(f"{name}: kv4_attend one slot short passes every launch's "
             "hold: the hold would not see it")
    if ctrl["rel_frobenius"] <= KERNELS_VS_PLAIN_LIMIT:
        fail(f"{name}: kv4_attend one slot short passes the check "
             f"({ctrl['rel_frobenius']:.3g}): it would not see it")
    if per_step["kv4_attend"] != 34 or per_step["kv4_store"] != 34:
        fail(f"{name}: launches a step {per_step}")
    for seed, r in seeds.items():
        d = r["kernels_vs_witness"]["rel_frobenius"]
        if d > KERNELS_VS_PLAIN_LIMIT:
            fail(f"{name} (seed {seed}) through the kernels disagrees with "
                 f"the plain versions summed in the kernel's order ({d:.3g} "
                 f"> {KERNELS_VS_PLAIN_LIMIT:g})")
    del packed
    free_card()
    return {"seeds": seeds, "limit": KERNELS_VS_PLAIN_LIMIT,
            "control_one_slot_short": ctrl, "held": held,
            "held_kv4": held4, "control_held_kv4": held_c,
            "launches_per_step": per_step,
            "wall_s": time.perf_counter() - t0}


@contextlib.contextmanager
def held_kv4(name: str, strict: bool):
    """While the context is open, each kv4_store launch on the card is
    held bit for bit against K4's plain encode of its token at its slot,
    and each kv4_attend launch against its plain version on the same
    inputs within kv4_attend_allowed. ``strict``: a launch outside fails
    the run; else it is counted. Yields a dict by kernel: launches held,
    launches outside, largest difference (kv4_attend)."""
    import torch
    from repro_torch.kernels import kv4 as k45
    held = {k: {"launches": 0, "outside": 0, "max_abs_err": 0.0}
            for k in ("kv4_store", "kv4_attend")}

    def outside(kernel, n, what):
        h = held[kernel]
        h["outside"] += int(n > 0)
        if n and strict:
            fail(f"{name}: {kernel} launch {h['launches']}: {what}")

    def store(f):
        def launch(k_new, v_new, k, v, ks, vs, pos):
            f(k_new, v_new, k, v, ks, vs, pos)
            held["kv4_store"]["launches"] += 1
            n = 0
            for t, codes, scales in ((k_new, k, ks), (v_new, v, vs)):
                want_c, want_s = k45.kv4_encode_2d_plain(
                    t.reshape(-1, t.shape[-1]))
                n += int((codes[:, pos].reshape(want_c.shape)
                          != want_c).sum())
                n += int((scales[:, pos].reshape(-1).view(torch.int16)
                          != want_s.view(torch.int16)).sum())
            outside("kv4_store", n, f"{n} bytes differ at slot {pos}")
        return launch

    def attend(f):
        def launch(q, k, v, ks, vs, valid, scale, softcap=None, **kw):
            y = f(q, k, v, ks, vs, valid, scale, softcap, **kw)
            h = held["kv4_attend"]
            h["launches"] += 1
            args = (valid, scale, softcap)
            want = k45.kv4_attend_plain(q, k, v, ks, vs, *args)
            allowed = k45.kv4_attend_allowed(q, k, v, ks, vs, *args, want)
            diff = (y.double() - want.double()).abs()
            h["max_abs_err"] = max(h["max_abs_err"], float(diff.max()))
            outside("kv4_attend", int((diff > allowed).sum()),
                    "elements outside kv4_attend_allowed")
            return y
        return launch

    with wrapped_kernels({"kv4_store": store, "kv4_attend": attend}):
        yield held


def on_mesh(tree, shardings):
    """Each tensor of ``tree`` as a DTensor on its sharding with itself as
    the local shard: on the one-rank mesh every placement is whole, and
    nothing is copied (the 43 GB of caches could not be)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import _leaves_with_path, _map_leaves
    flat = dict(_leaves_with_path(shardings))
    return _map_leaves(lambda p, t: DTensor.from_local(
        t, flat[p].mesh, flat[p].placements, run_check=False), tree)


def cell_on_card(dev, prediction: dict, control: dict) -> dict:
    """Phase 15(b): the dry-run cell gemma3-4b decode_32k W4 (abs-max packs,
    acts snapped to E2M1 by K2 and K1) with the FP4 cache, whole on the
    card: B 128, S 32768, all 34 layers, parameters, caches and token
    DTensors on the 1-rank NCCL mesh. The arguments' bytes requested of
    the allocator after placement, less the baseline, equal the
    prediction's leaves (the position is a Python int on the card); the
    bytes it allocated lie at or above them rounded up leaf by leaf to
    its 512 bytes, by less than 1 MiB a leaf (a large block whose
    segment's tail is too small to split is allocated whole). The caches
    are filled through kv4_store with drawn k and v below slot 32765, then
    three decode steps at positions 32765-32767; each step's peak above what it
    started with is held within PEAK_LIMIT bytes of the prediction's
    ``step_peak_bytes``, which the control (the same trace through the
    kernels' plain versions) must break. The steps' walls, the third
    step's device-busy time (profiled) and the launches a step."""
    import dataclasses

    import torch
    from repro_torch.common.sharding import NamedSharding
    from repro_torch.kernels import kv4 as k45
    from repro_torch.launch.mesh import make_host_mesh, mesh_scope
    from repro_torch.launch.sharding import (cache_shardings, data_spec,
                                             param_shardings)
    from repro_torch.launch.steps import (make_decode_fn,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import init_caches, lm_init
    print(f"--- gemma3-4b decode_32k W4 FP4-KV whole on the card (B "
          f"{CELL_B}, S {CELL_S}, 34 layers) against its dry run",
          flush=True)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(family_config("gemma3-4b"), kv_dtype="fp4")
    mesh = make_host_mesh()
    free_card()

    def requested():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    base, base_asked = torch.cuda.memory_allocated(), requested()
    with torch.no_grad():
        params = quantize_lm_for_serving(lm_init(
            torch.Generator(device=dev).manual_seed(0), cfg, dev),
            searched=False)
        params = on_mesh(params, param_shardings(params, mesh))
        caches = init_caches(cfg, CELL_B, CELL_S, dev)
        caches = on_mesh(caches, cache_shardings(caches, mesh))
        tokens = torch.randint(0, cfg.vocab, (CELL_STEPS, CELL_B, 1),
                               generator=torch.Generator().manual_seed(2),
                               dtype=torch.int32)
        token = on_mesh(tokens[0].to(dev), NamedSharding(
            mesh, data_spec((CELL_B, 1), mesh)))
    free_card()
    args = torch.cuda.memory_allocated() - base
    asked = requested() - base_asked
    # the position is a Python int on the card (the record's leaf "#3")
    leaves = [n for path, (n, _) in prediction["argument_leaves"].items()
              if path != "#3"]
    want = sum(leaves)
    rounded = sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in leaves)
    read = prediction["memory"]["argument_size_in_bytes"]
    print(f"arguments on the card: {asked} bytes requested of the allocator "
          f"({asked / 1e9:.3f} GB), held to the dry run's {want} (its "
          f"{len(leaves)} leaves; {read} the leaves the step reads); {args} "
          f"bytes allocated against the leaves rounded up to {ALLOC_ROUND} "
          f"B, {rounded} ({args - rounded} more: a large block whose "
          "segment's tail is too small to split is allocated whole)",
          flush=True)
    if asked != want:
        fail(f"cell on the card: arguments take {asked} bytes, the dry run "
             f"predicts {want}")
    if not 0 <= args - rounded < len(leaves) * 2**20:
        fail(f"cell on the card: {args} bytes allocated for arguments the "
             f"dry run rounds to {rounded}")

    # the caches through kv4_store, slot by slot, below the first step
    first = CELL_S - CELL_STEPS
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = [(torch.randn(CELL_B, cfg.n_kv, cfg.hd, generator=gen, device=dev)
             * 2).bfloat16() for _ in range(8)]
    t1 = time.perf_counter()
    n_stores = 0

    def fill(c, n):
        nonlocal n_stores
        lc = [c[k].to_local() for k in ("k", "v", "k_scale", "v_scale")]
        for s in range(n):
            k45.kv4_store_cuda(pool[s % 8], pool[(s + 3) % 8], *lc, s)
        n_stores += n

    for i in range(cfg.first_k_dense):
        fill(caches[f"dense_{i}"], first)
    for pos_i, (_, window, _) in enumerate(cfg.layer_pattern):
        stack = caches["blocks"][pos_i]
        for g in range(cfg.n_groups):
            fill({k: v[g] for k, v in stack.items()},
                 min(window, CELL_S) if window else first)
    _sync()
    fill_s = time.perf_counter() - t1
    del pool
    free_card()
    print(f"caches filled through kv4_store: {n_stores} launches in "
          f"{fill_s:.1f} s", flush=True)

    step = make_decode_fn(cfg, ctx=serve_ctx(dev))
    walls, peaks, logits = [], [], None

    def one(i, profile=False):
        nonlocal logits, caches
        logits = None
        tok = on_mesh(tokens[i].to(dev), NamedSharding(
            mesh, data_spec((CELL_B, 1), mesh)))
        free_card()
        _sync()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def go():
            nonlocal logits, caches
            with mesh_scope(mesh), torch.no_grad():
                logits, caches = step(params, caches, tok, first + i)

        if profile:
            prof = profiled(go)
        else:
            t = time.perf_counter()
            go()
            _sync()
            walls.append((time.perf_counter() - t) * 1e3)
            prof = None
        peaks.append(torch.cuda.max_memory_allocated() - before)
        return prof

    def drive():
        one(0)
        one(1)
        return one(2, profile=True)

    run = driven("gemma3-4b decode_32k on the card", drive,
                 ("w4a4_matmul", "kv4_store", "kv4_attend", "msfp_qdq"),
                 {("matmul", "torch_f32")})
    prof = run["out"]
    lg = logits.to_local() if hasattr(logits, "to_local") else logits
    if tuple(lg.shape) != (CELL_B, 1, cfg.vocab) or not bool(
            torch.isfinite(lg).all()):
        fail(f"cell on the card: logits {tuple(lg.shape)} not finite")
    counts = run["counts"]
    modes = k2_modes(run["shapes"])
    per_step = {"w4a4": modes["w4a4"] / CELL_STEPS,
                "weight_only": modes["weight_only"] / CELL_STEPS,
                **{k: counts[k] / CELL_STEPS
                   for k in ("kv4_store", "kv4_attend", "msfp_qdq")}}
    if per_step != FAMILY_LAUNCHES["gemma3-4b"]:
        fail(f"cell on the card: launches a step {per_step}, expected "
             f"{FAMILY_LAUNCHES['gemma3-4b']}")
    pred, ctrl = prediction["step_peak_bytes"], control["step_peak_bytes"]

    def within(x):
        return abs(x - pred) <= PEAK_LIMIT

    print(f"step peaks above the arguments on the card {peaks} bytes; the "
          f"dry run predicts {pred} (kernel routes; temp "
          f"{prediction['memory']['temp_size_in_bytes']}), held to "
          f"+-{PEAK_LIMIT / 2**20:g} MiB; the control "
          f"through the plain routes predicts {ctrl} ({ctrl / 1e9:.2f} GB); "
          f"step walls {[round(w, 2) for w in walls]} ms, the profiled "
          f"step's wall {prof['profile_wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}),"
          f" {prof['launches']} CUDA kernels; launches a step {per_step}; "
          f"phase wall {time.perf_counter() - t0:.1f}s", flush=True)
    if not all(within(p) for p in peaks):
        fail(f"cell on the card: step peaks {peaks} outside the limit about "
             f"the prediction {pred}")
    if within(ctrl):
        fail(f"cell on the card: the plain-route control's prediction {ctrl}"
             " passes the limit: the check would not see it")
    out = {"counts": counts, "shapes": run["shapes"], "units": CELL_STEPS,
           "unit": "decode step", "arguments_requested": asked,
           "arguments_predicted": want, "arguments_allocated": args,
           "arguments_predicted_rounded": rounded, "step_peaks": peaks,
           "step_peak_predicted": pred, "step_peak_control": ctrl,
           "peak_limit": PEAK_LIMIT, "step_walls_ms": walls,
           "profile": {k: v for k, v in prof.items() if k != "top"},
           "launches_per_step": per_step, "fill_stores": n_stores,
           "fill_s": fill_s, "wall_s": time.perf_counter() - t0}
    del params, caches, logits, lg
    free_card()
    return out


def dryrun_phase(dev) -> dict:
    """Phase 15: (a) the dry runs started, (c) and (d) on the card while
    they trace, (a) read, (b) the cell against its prediction."""
    print("--- the dry run over fake worlds; gemma3-4b decode_32k against it",
          flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(tmp)
        long_kv4 = kv4_long_checks(dev)
        long_decode = long_decode_checks(dev)
        recs = finish_dryruns(procs)
    cell = cell_on_card(dev, recs["prediction"], recs["control"])
    wall = time.perf_counter() - t0
    print(f"dry-run phase wall {wall:.1f} s", flush=True)
    keep = ("memory", "cost", "collectives", "step_peak_bytes", "chips",
            "compile_s", "ops", "wall_s")
    return {"records": {name: {k: r[k] for k in keep if k in r}
                        for name, r in recs.items()},
            "kv4_long": long_kv4, "long_decode": long_decode, "cell": cell,
            "wall_s": wall}


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
    # the 1-rank NCCL group every meshed launcher run shares (phase 14)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    init_world(dev)

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
    gateway = gateway_phase(dev, golden["out"]["digest"])
    families = family_phase(dev)
    lm13 = prefill_train_phase(dev)
    meshed = mesh_phase(dev, lm13["train"]["smollm-135m train"]["resume"])
    dry = dryrun_phase(dev)
    tmp_dir.cleanup()
    rows["qdq_conv2d"].extend(pipeline["io_rows"])
    rows["kv4_attend"].extend(dry["kv4_long"]["rows"])
    # each path's own launches, per forward (diffusion), per decode step
    # (LM: prompt steps and generated steps alike) or per train step
    paths = {"ddim-cifar10 golden trace": golden, "ddim-cifar10 8x10": wall,
             "ddim-cifar10 deadline_mix slo": scenario,
             "smollm-135m serve": lm_serve,
             "ddim-cifar10 8x10 --plan search": plan_runs["search_run"],
             "ddim-cifar10 train step": pipeline["train_run"],
             **{f"gateway mixed_model {name}": run for name, run in
                gateway["mixed_model"]["paths"].items()},
             **gateway["fleet"]["paths"], **families["runs"],
             **lm13["prefill"], "smollm-135m serve under the mesh":
                 meshed["serve"],
             "gemma3-4b decode_32k B128 (dry-run cell)": dry["cell"]}
    by_path = {k: {name: {"launches": run["counts"][k],
                          f"per_{run['unit'].replace(' ', '_')}":
                              run["counts"][k] / run["units"]}
                   for name, run in paths.items() if run["counts"][k]}
               for k in golden["counts"]}
    launches = {k: sum(v["launches"] for v in by_path[k].values())
                for k in by_path}
    print("--- every main-path K2/K3 shape", flush=True)
    path_sums = path_shapes(
        dev, rows, {"ddim-cifar10 8x10": wall, "smollm-135m serve": lm_serve,
                    **{f"gateway mixed_model {name}": run for name, run in
                       gateway["mixed_model"]["paths"].items()},
                    **families["runs"], **lm13["prefill"],
                    "gemma3-4b decode_32k B128 (dry-run cell)": dry["cell"]},
        {**{name: r["kernel_ms"] for name, r in lm13["prefill"].items()},
         "gemma3-4b decode_32k B128 (dry-run cell)":
             dry["cell"]["profile"]["kernel_ms"],
         "ddim-cifar10 8x10": fwd["profile_kernel_ms"],
         "smollm-135m serve": lm["profile_kernel_ms"],
         "zamba2-2.7b serve":
             families["profiles"]["zamba2-2.7b"]["profile_kernel_ms"],
         "llama4-scout-17b-a16e serve": families["profiles"][
             f"llama4-scout-17b-a16e depth {LLAMA4_DEPTH}"][
             "profile_kernel_ms"]})

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
                      "gateway": {
                          "identity": gateway["identity"],
                          "mixed_model": {k: v for k, v in
                                          gateway["mixed_model"].items()
                                          if k != "paths"},
                          "fleet": {k: v for k, v in gateway["fleet"].items()
                                    if k != "paths"},
                          "wall_s": gateway["wall_s"]},
                      "lm_families": {
                          "runs": {k: {f: v for f, v in r.items()
                                       if f not in ("counts", "shapes")}
                                   for k, r in families["runs"].items()},
                          "checks": families["checks"],
                          "profiles": families["profiles"],
                          "wall_s": families["wall_s"]},
                      "lm_prefill_train": {
                          "prefill": {k: {f: v for f, v in r.items()
                                          if f not in ("counts", "shapes")}
                                      for k, r in lm13["prefill"].items()},
                          "checks": lm13["checks"], "train": lm13["train"],
                          "train_checks": lm13["train_checks"],
                          "wall_s": lm13["wall_s"]},
                      "mesh": {"train": meshed["train"],
                               "serve": {k: v for k, v in
                                         meshed["serve"].items()
                                         if k not in ("counts", "shapes")},
                               "moe_ep": meshed["moe_ep"],
                               "resume_bit_exact":
                                   meshed["resume_bit_exact"],
                               "wall_s": meshed["wall_s"]},
                      "dryrun": {
                          "records": dry["records"],
                          "kv4_long_same_bits_2048":
                              dry["kv4_long"]["same_bits_2048"],
                          "long_decode": dry["long_decode"],
                          "cell": {k: v for k, v in dry["cell"].items()
                                   if k not in ("counts", "shapes")},
                          "wall_s": dry["wall_s"]},
                      "lm": {"tok_s": lm_serve["tok_s"],
                             "peak_mib": lm_serve["peak_mib"],
                             "launches_per_step":
                                 lm_serve["launches_per_step"], **lm}}),
          flush=True)
    dist.destroy_process_group()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
