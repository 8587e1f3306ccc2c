"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a part
of the window, read back from its Chrome trace.

The harness marks its own host spans with ``record_function``
(``portbench.window`` around the traced part, ``portbench.tick`` around
each ``engine.tick()``, ``portbench.submit`` and ``portbench.idle``), so
that each idle gap on the device is named by the span the host was in and
the innermost host op it was running.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict            # kernel class -> device seconds
    device_ops: list          # [[name, seconds]] the ten longest by name
    idle_gaps: list           # [[host span: op, seconds]] the ten longest


def short(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


def prime(device) -> None:
    """Start and stop the profiler once, in set-up: its first start in a
    process initialises CUPTI, which takes seconds."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(8, device=device).sum().item()


def start() -> torch.profiler.profile:
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(prof: torch.profiler.profile, kernels: dict) -> Trace:
    """Reduce the trace of the stopped ``prof``; ``kernels`` (a family's
    ``KERNELS``) maps a pattern, searched for in a device kernel's name,
    to the kernel class whose device time ``kernel_s`` sums: the first
    pattern that matches."""
    classes = [(re.compile(pat), k) for pat, k in kernels.items()]

    def kernel_class(name: str) -> str | None:
        return next((k for pat, k in classes if pat.search(name)), None)

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the traced window's span is not in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name, kernel_s = [], collections.Counter(), collections.Counter()
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            name = e.get("name", "")
            by_name[short(name)] += (b - a) * 1e-6
            k = kernel_class(name)
            if k is not None:
                kernel_s[k] += (b - a) * 1e-6
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            if e["name"] != WINDOW:
                spans.append((a, b, e["name"].removeprefix("portbench.")))
        elif cat == "cpu_op":
            ops.append((a, b, e.get("name", "")))
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    spans.sort()
    ops.sort()
    span_starts = [s[0] for s in spans]
    op_starts = [o[0] for o in ops]

    def inner(items, starts, x):
        i = bisect.bisect_right(starts, x)
        for j in range(i - 1, max(i - 200, -1), -1):
            if items[j][1] > x:
                return items[j][2]
        return None

    idle = collections.Counter()
    for a, b in gaps:
        span = inner(spans, span_starts, a) or "between spans"
        op = inner(ops, op_starts, a)
        idle[f"{span}: {op}" if op else span] += (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                 kernel_s=dict(kernel_s),
                 device_ops=[[n, s] for n, s in by_name.most_common(10)],
                 idle_gaps=[[n, s] for n, s in idle.most_common(10)])
