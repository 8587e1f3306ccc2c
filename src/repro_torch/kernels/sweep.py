"""Time K2/K3 on the card at each main-path shape for every plan it accepts.

    python -m repro_torch.kernels.sweep        (needs a CUDA card)

For each shape it prints one markdown table row: the (tile, splits) that
``w4_matmul.gemm_plan`` picks and its device time per call (CUDA-graph
replays timed with CUDA events), the fastest of ``gemm_candidates`` and
its time, and every candidate's time by tile and split count: the data
behind the plan's rule. Signed E2M1 weights and E2M1 acts at maxval 6,
f32 (bf16 at the LM shapes), inputs from a seeded generator.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.qmodule import pack_weight
from repro_torch.kernels import conv as k3
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type != "cuda":
        raise SystemExit("sweep times the CUDA kernels: it needs a card")
    gen = torch.Generator().manual_seed(0)
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
