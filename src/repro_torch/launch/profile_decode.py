"""Profile one LM decode step on the card: its wall time, device busy time,
idle share, CUDA kernel launches and device time by kernel.

    python -m repro_torch.launch.profile_decode [--walls 10]

The serve configuration of ``launch/serve.py``: smollm-135m in bf16,
random weights from seed 0 quantized to W4, E2M1 acts at maxval 6 fused
into every dense site, an FP4 KV cache of 64 slots at batch 8. 32 steps
fill the cache, then the step at slot 32 is timed ``--walls`` times
without the profiler (the median is the step's wall; the median of the
thread's CPU time over the same steps is its host time, which other
processes on the host's cores do not lengthen) and once under it. The
idle share is 1 - busy / wall. The last line is the result as JSON.

It uses only the launcher's own building blocks (config, init, quantize,
decode step), so the same file can also profile an earlier checkout of the
port: ``PYTHONPATH=<checkout>/src python
src/repro_torch/launch/profile_decode.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common.clock import wall_clock
from repro_torch.configs.registry import get_config
from repro_torch.launch.steps import make_decode_fn, quantize_lm_for_serving
from repro_torch.models.lm import init_caches, lm_init
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams


def device_us(event) -> float:
    """An event's own device time in us (the attribute's name moved
    between torch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_rows(prof) -> list:
    """The profile's device rows (an aten op's row repeats its kernels'
    time, so only these are summed), memory copies and sets included."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and device_us(e) > 0]


def is_kernel(event) -> bool:
    return not event.key.startswith(("Memcpy", "Memset"))


def decode_step_profile(cfg, batch: int, slots: int, pos: int,
                        device: torch.device, walls: int = 10) -> dict:
    """Fill ``pos`` slots, then time and profile the step at ``pos``.
    Returns the walls (median and least), the host's CPU time and the busy
    time in ms, the idle shares, the kernel launches of the profiled step,
    ms and launches by kernel name, and the profile itself (``prof``)."""
    p = quantize_lm_for_serving(lm_init(torch.Generator().manual_seed(0),
                                        cfg, device))
    ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
        KIND_FP_SIGNED, 2, 1, 4, torch.tensor(6.0, device=device))})
    step = make_decode_fn(cfg, ctx=ctx)
    caches = init_caches(cfg, batch, slots, device)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
    with torch.inference_mode():
        for i in range(pos):
            step(p, caches, tok, i)
        torch.cuda.synchronize()
        times, cpu = [], []
        for _ in range(walls):
            # thread_time is this thread's CPU time on the host, not a
            # wall clock: what the host spends issuing the step
            t0, c0 = wall_clock(), time.thread_time()
            step(p, caches, tok, pos)
            torch.cuda.synchronize()
            times.append((wall_clock() - t0) * 1e3)
            cpu.append((time.thread_time() - c0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = wall_clock()
            step(p, caches, tok, pos)
            torch.cuda.synchronize()
            wall_ms = (wall_clock() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    step_ms = sorted(times)[len(times) // 2]
    cpu_ms = sorted(cpu)[len(cpu) // 2]
    kernels = {e.key: {"launches": e.count, "ms": device_us(e) / 1e3}
               for e in rows if is_kernel(e)}
    return {"step_ms": step_ms, "step_ms_min": min(times), "cpu_ms": cpu_ms,
            "profile_wall_ms": wall_ms,
            "busy_ms": busy_ms, "idle_share": 1 - busy_ms / step_ms,
            "idle_share_profiled": 1 - busy_ms / wall_ms,
            "launches": sum(k["launches"] for k in kernels.values()),
            "kernels": kernels, "prof": prof}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walls", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_decode measures the card; torch.cuda is "
                           "not available")
    cfg = dataclasses.replace(get_config("smollm-135m"), kv_dtype="fp4",
                              dtype=torch.bfloat16)
    batch, slots, pos = 8, 64, 32
    r = decode_step_profile(cfg, batch, slots, pos, torch.device("cuda"),
                            args.walls)
    r.pop("prof")
    print(f"decode step {cfg.name} bfloat16 B={batch}, {pos} of {slots} "
          f"slots filled, on {torch.cuda.get_device_name(0)}"
          f": wall {r['step_ms']:.3f} ms (median of {args.walls}; least "
          f"{r['step_ms_min']:.3f}), host CPU {r['cpu_ms']:.3f} ms, device "
          f"busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
          f"{r['launches']} kernel launches", flush=True)
    for name, k in sorted(r["kernels"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {k['ms']:9.4f} ms  x{k['launches']:<5d} {name[:90]}")
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
