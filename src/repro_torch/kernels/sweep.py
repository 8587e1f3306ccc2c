"""Time K2/K3 on the card at each main-path shape for every plan it accepts.

    python -m repro_torch.kernels.sweep        (needs a CUDA card)
    python -m repro_torch.kernels.sweep --io   (the io sites' qdq_conv2d)

For each shape it prints one markdown table row: the (tile, splits) that
``w4_matmul.gemm_plan`` picks and its device time per call (CUDA-graph
replays timed with CUDA events), the fastest of ``gemm_candidates`` and
its time, and every candidate's time by tile and split count: the data
behind the plan's rule. Signed E2M1 weights and E2M1 acts at maxval 6,
f32 (bf16 at the LM shapes), inputs from a seeded generator.

``--io`` times ``qdq_conv2d`` instead, at ddim-cifar10's two io sites
(32x32, bf16 weights, E2M1 acts at maxval 6, a bias) at each batch of the
engine's power-of-two buckets, for bands of 1, 2 and 4 output rows a CTA
(``msfp_quant.io_conv_layout`` picks 2): one row per site and batch.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.qmodule import pack_weight
from repro_torch.kernels import conv as k3
from repro_torch.kernels import msfp_quant as k1
from repro_torch.kernels import w4_matmul as k2
from repro_torch.quant.fakequant import QuantizerParams

# (m, k, n, dtype) products and (b, hw, cin, cout, kh, stride) convs
GEMMS = [(8, 576, 576, torch.bfloat16), (8, 1536, 576, torch.bfloat16),
         (8, 512, 256, torch.float32), (128, 256, 256, torch.float32),
         (2048, 256, 256, torch.float32)]
CONVS = [(8, 32, 128, 128, 3, 1), (8, 32, 128, 128, 3, 2),
         (8, 32, 256, 256, 3, 1), (8, 16, 256, 256, 3, 1),
         (8, 16, 512, 256, 3, 1), (8, 8, 256, 256, 3, 1),
         (8, 8, 512, 256, 3, 1),
         (8, 8, 512, 256, 1, 1), (8, 16, 128, 256, 1, 1),
         (8, 4, 512, 256, 3, 1), (8, 4, 256, 256, 3, 1),
         (8, 32, 256, 128, 1, 1)]


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph, its
    replays timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def sweep(launch, m: int, n: int, k: int) -> str:
    """``launch(plan)`` timed at each of ``gemm_candidates(m, n, k)``: the
    row's cells after its shape."""
    us = {plan: device_ms(lambda: launch(plan)) * 1e3  # noqa: B023
          for plan in k2.gemm_candidates(m, n, k)}
    chosen = k2.gemm_plan(m, n, k)
    best = min(us, key=us.get)
    by_tile = "; ".join(
        f"tile {cfg}: " + " ".join(f"{s}:{t:.2f}" for (c, s), t in us.items()
                                   if c == cfg)
        for cfg in k2.tiles_for(m))
    return (f"{chosen} {us[chosen]:.2f} | {best} {us[best]:.2f} | "
            f"{by_tile} |")


def io_sweep(dev: torch.device, gen: torch.Generator) -> None:
    """``qdq_conv2d`` at conv_in (3 -> 128) and conv_out (128 -> 3), 32x32,
    for each batch and band height."""
    aq = QuantizerParams(0, 2, 1, 4, torch.tensor(6.0)).to(dev)
    print("| io site | B | us by output rows a CTA (CTAs) |\n"
          "| --- | --- | --- |", flush=True)
    for name, cin, cout in (("conv_in", 3, 128), ("conv_out", 128, 3)):
        w = (torch.randn(3, 3, cin, cout, generator=gen)
             * (9 * cin) ** -0.5).to(dev, torch.bfloat16)
        bias = torch.randn(cout, generator=gen).to(dev)
        for b in (1, 2, 4, 8):
            x = torch.randn(b, 32, 32, cin, generator=gen).to(dev)
            cells = []
            for rows in (1, 2, 4):
                us = device_ms(lambda: k1.qdq_conv2d_cuda(  # noqa: B023
                    x, w, aq, bias, rows=rows)) * 1e3
                cells.append(f"{rows}: {us:.2f} ({b * -(-32 // rows)})")
            print(f"| {name} {cin}->{cout} | {b} | {' '.join(cells)} |",
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--io", action="store_true",
                    help="time the io sites' qdq_conv2d instead of K2/K3")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("sweep times the CUDA kernels: it needs a card")
    gen = torch.Generator().manual_seed(0)
    if args.io:
        io_sweep(dev, gen)
        return
    print("| shape | plan (tile, splits) us | fastest us | us by tile and "
          "splits |\n| --- | --- | --- | --- |", flush=True)
    aq = QuantizerParams(0, 2, 1, 4, torch.tensor(6.0)).to(dev)
    act = (aq.maxval, aq.zero_point, 2, 1, True)
    for m, k, n, dt in GEMMS:
        w = torch.randn(k, n, generator=gen)
        pw = pack_weight(w, QuantizerParams(0, 2, 1, 4, w.abs().max())).to(dev)
        x = torch.randn(m, k, generator=gen).to(dev, dt)
        kw = dict(exp_bits=2, man_bits=1, signed=True)
        line = sweep(lambda plan: k2.w4_matmul_2d_cuda(
            x, pw.packed, pw.scale, pw.zero_point, act, plan=plan, **kw),
            m, n, k)
        print(f"| K2 ({m},{k})x({k},{n}) {str(dt)[6:]} | {line}", flush=True)
    for b, hw, cin, cout, kh, s in CONVS:
        w = torch.randn(kh, kh, cin, cout, generator=gen)
        pw = pack_weight(w, QuantizerParams(0, 2, 1, 4, w.abs().max())).to(dev)
        x = torch.randn(b, hw, hw, cin, generator=gen).to(dev)
        kw = dict(stride=(s, s), padding="SAME")
        oh, ow, _, _ = k3.conv_geometry(x.shape, kh, kh, (s, s), "SAME")
        line = sweep(lambda plan: k3.w4a4_conv2d_implicit_cuda(
            x, pw, aq, plan=plan, **kw), b * oh * ow, cout, kh * kh * cin)
        print(f"| K3 {kh}x{kh} s{s} {hw}x{hw} {cin}->{cout} | {line}",
              flush=True)


if __name__ == "__main__":
    main()
