"""The port's own spans in a traced run: the host's time a tick, a bank
build's merge, and the card's idle time put down to the tick's phases.

With an ``Observability`` bundle the engine's tracer records each tick's
phases and each bank build's stages (``serving/engine.py``,
``serving/weight_bank.py``) in its buffer, on the engine's clock (the
harness's ``Clock``, restarted at the window), and opens for each span a
``torch.profiler`` range ``<cat>.<name>`` on the profiler's clock, beside
the device's kernels. This module reads both:

  * ``split`` — the buffer's spans of set-up (before the mark taken at the
    clock's restart) and of the window (after it, begun before the
    window's end); ``None`` once the ring has dropped events, since the
    mark then points elsewhere;
  * ``host_ms`` — the mean, over the window's busy ticks, of
    ``engine.tick`` less its ``engine.sync``: the host's own time a tick;
  * ``merge_s`` — set-up's ``bank.merge`` spans summed (host clock, no
    synchronise);
  * ``idle_phases`` — the traced window's device-idle time, each instant
    put down to the innermost program range the engine's thread was in
    (intervals intersected, not a gap's start), and to ``outside engine``
    where it was in none;
  * ``idle_share`` — one range's idle over the traced window, in %.

``run.py`` reads none of it yet: the harness builds its engine with
``NULL_OBS`` and keeps no raw trace events (``PERF.md`` §7 names the
edits). ``main`` runs a cell's set-up and window as the harness does,
traced, with the bundle on or off, and prints these numbers beside the
harness's own (the mean tick, the idle share, ``bank_build_s``), one JSON
line a run:

    python3 portbench/phases.py --workload bedroom.online --seconds 51 \\
        --seeds 5 6 --obs 1 0
"""
from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import gc
import json
import os
import pathlib
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import devtrace, harness  # noqa: E402

OUTSIDE = "outside engine"
# the tick's phases, the direct children of its span
PHASES = ("admit", "group", "bank_fetch", "forward", "advance", "prefetch")


@dataclasses.dataclass
class Spans:
    setup: list       # the buffer's duration spans before the window
    window: list      # and those begun in it


def split(events: list, mark: int, end_s: float,
          dropped: int) -> Spans | None:
    """The tracer's ``events`` cut at ``mark`` (the buffer's length at the
    clock's restart); window spans are those begun before ``end_s``."""
    if dropped:
        return None
    xs = [e for e in events[:mark] if e["ph"] == "X"]
    win = [e for e in events[mark:] if e["ph"] == "X"
           and e["ts"] < end_s * 1e6]
    return Spans(xs, win)


def _named(events, name: str, cat: str = "engine") -> list:
    return [e for e in events if e["name"] == name and e["cat"] == cat]


def busy_ticks(spans: Spans) -> list:
    return [e for e in _named(spans.window, "tick")
            if not e["args"].get("idle")]


def _within(ticks, spans) -> list[float]:
    """For each tick, the summed duration of ``spans`` on its track that
    begin inside it."""
    keyed = sorted((e["tid"], e["ts"], e["dur"]) for e in spans)
    out = []
    for t in ticks:
        i = bisect.bisect_left(keyed, (t["tid"], t["ts"]))
        total = 0.0
        while (i < len(keyed) and keyed[i][0] == t["tid"]
               and keyed[i][1] <= t["ts"] + t["dur"]):
            total += keyed[i][2]
            i += 1
        out.append(total)
    return out


def host_ms(spans: Spans | None) -> float | None:
    """Mean of ``engine.tick`` less its ``engine.sync`` over the window's
    busy ticks, in ms."""
    ticks = busy_ticks(spans) if spans is not None else []
    if not ticks:
        return None
    sync = _within(ticks, _named(spans.window, "sync"))
    return 1e-3 * sum(t["dur"] - s for t, s in zip(ticks, sync)) / len(ticks)


def phase_ms(spans: Spans | None) -> dict | None:
    """Mean ms a busy tick of the window spends in the tick itself, in each
    phase and in the tick's own code between them (``self``)."""
    ticks = busy_ticks(spans) if spans is not None else []
    if not ticks:
        return None
    n = len(ticks)
    out = {"tick": 1e-3 * sum(t["dur"] for t in ticks) / n}
    children = [0.0] * n
    for name in PHASES + ("stage", "launch", "sync"):
        cat = "bank" if name == "bank_fetch" else "engine"
        each = _within(ticks, _named(spans.window, name, cat))
        out[name] = 1e-3 * sum(each) / n
        if name in PHASES:
            children = [c + x for c, x in zip(children, each)]
    out["self"] = 1e-3 * sum(t["dur"] - c
                             for t, c in zip(ticks, children)) / n
    return out


def merge_s(spans: Spans | None) -> float | None:
    """Set-up's ``bank.merge`` spans summed, in s."""
    merges = _named(spans.setup, "merge", "bank") if spans else []
    return 1e-6 * sum(e["dur"] for e in merges) if merges else None


def chrome_events(prof: torch.profiler.profile) -> list:
    """The stopped ``prof``'s Chrome trace events."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class _Exported:
    """A stopped profiler's events, exported again for ``devtrace.read``
    (a profiler exports its trace once)."""

    def __init__(self, events: list):
        self.events = events

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _gaps(events, w0: float, w1: float) -> list:
    dev = []
    for e in events:
        if e.get("cat") in devtrace.DEVICE_CATS and "dur" in e:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
    gaps, t = [], w0
    for a, b in devtrace._merge(dev):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


class _Idle:
    """Idle time inside [a, b], from the sorted disjoint gaps."""

    def __init__(self, gaps):
        self.gaps = gaps
        self.starts = [a for a, _ in gaps]
        self.before = [0.0]
        for a, b in gaps:
            self.before.append(self.before[-1] + b - a)

    def upto(self, x: float) -> float:
        i = bisect.bisect_right(self.starts, x) - 1
        if i < 0:
            return 0.0
        a, b = self.gaps[i]
        return self.before[i] + min(x, b) - a

    def within(self, a: float, b: float) -> float:
        return max(self.upto(b) - self.upto(a), 0.0)


def _window(events) -> dict:
    win = [e for e in events if e.get("name") == devtrace.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the traced window's span is not in the trace")
    return win[0]


def idle_in(events, name: str) -> float:
    """Device-idle seconds of the traced window inside the ranges called
    ``name`` (on any thread)."""
    win = _window(events)
    w0 = float(win["ts"])
    idle = _Idle(_gaps(events, w0, w0 + float(win["dur"])))
    return 1e-6 * sum(idle.within(float(e["ts"]),
                                  float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("name") == name
                      and e.get("cat") == "user_annotation")


def idle_phases(events) -> list | None:
    """``[[range, seconds]]``, longest first: the traced window's idle time
    by the innermost program range (``user_annotation`` not prefixed
    ``portbench.``) open on the window's thread, and ``outside engine``;
    the entries sum to the window's idle time. ``None`` where the trace
    holds no program range."""
    win = _window(events)
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    gaps = _gaps(events, w0, w1)
    idle = _Idle(gaps)
    ranges = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
         for e in events if e.get("cat") == "user_annotation"
         and e.get("tid") == win.get("tid")
         and not e["name"].startswith("portbench.")),
        key=lambda r: (r[0], -r[1]))
    if not ranges:
        return None
    own = collections.Counter()
    stack = []            # (a, b, name) of the open ranges, clipped
    top = 0.0
    for a, b, name in ranges:
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack:
            a, b = max(a, stack[-1][0]), min(b, stack[-1][1])
        inside = idle.within(a, b) if b > a else 0.0
        own[name] += inside
        if stack:
            own[stack[-1][2]] -= inside
        else:
            top += inside
        stack.append((a, b, name))
    own[OUTSIDE] = sum(b - a for a, b in gaps) - top
    return [[n, s * 1e-6] for n, s in own.most_common()]


def idle_share(phases: list | None, name: str,
               window_s: float) -> float | None:
    """``name``'s idle over the traced window, in %."""
    if phases is None or not window_s:
        return None
    return 100.0 * dict(phases).get(name, 0.0) / window_s


def traced_run(cell: harness.Cell, seed: int, seconds: float, bundle,
               device) -> dict:
    """Set-up and the window of one run as ``harness.run_cell`` makes them,
    with the window traced and the engine on ``bundle``, and no answer
    checked; the run's numbers."""
    from repro_torch.serving import obs as obs_module
    device = torch.device(device)
    clock = harness.Clock()
    backlog = cell.traffic["process"] == "backlog"
    # the family builds its engine with the NULL_OBS it imports while it
    # is built: lend it the bundle for that
    null = obs_module.NULL_OBS
    obs_module.NULL_OBS = bundle
    try:
        system = cell.family.build(cell, seed, seconds, device, clock)
    finally:
        obs_module.NULL_OBS = null
    bank_build_s = system.set_up()
    devtrace.prime(device)
    if backlog:
        for r in system.reqs:
            system.submit(r)
    _sync(device)
    win = harness.Window(system, clock, seconds, True)
    clock.reset()
    mark = len(bundle.tracer.events())
    if backlog:
        win.run_backlog(set())
    else:
        win.run_open(system.reqs, set())
    _sync(device)
    tracer = bundle.tracer
    spans = (split(tracer.events(), mark, win.end, tracer.dropped)
             if bundle.enabled else None)
    events = chrome_events(win.prof)
    out = reading(devtrace.read(_Exported(events), cell.family.KERNELS),
                  events, spans)
    out.update(tick_ms=1e3 * sum(win.tick_s) / max(len(win.tick_s), 1),
               ticks=win.ticks, bank_build_s=bank_build_s,
               tracer={"events": len(tracer.events()),
                       "dropped": tracer.dropped})
    del system, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reading(trace: devtrace.Trace, events: list,
            spans: Spans | None) -> dict:
    """What one traced window says: the device's busy and idle time, the
    idle by program range, and the spans' readers."""
    phases = idle_phases(events)
    idle_s = trace.window_s - trace.busy_s
    tick_idle = idle_in(events, "portbench.tick")
    in_phases = (None if phases is None else
                 sum(s for n, s in phases if n not in (OUTSIDE,
                                                       "engine.tick")))
    per_phase = phase_ms(spans)
    return {
        "window_s": trace.window_s, "busy_s": trace.busy_s,
        "device_idle_pct": 100.0 * idle_s / trace.window_s,
        "idle_phases": phases,
        "idle_phases_sum_s": (sum(s for _, s in phases)
                              if phases is not None else None),
        "idle_s": idle_s,
        "idle_advance_pct": idle_share(phases, "engine.advance",
                                       trace.window_s),
        "idle_launch_pct": idle_share(phases, "engine.launch",
                                      trace.window_s),
        # idle under the harness's tick span, against the part of it that
        # falls in the engine's phases
        "tick_idle_s": tick_idle,
        "phases_of_tick_idle_pct": (100.0 * in_phases / tick_idle
                                    if in_phases is not None and tick_idle
                                    else None),
        "host_ms": host_ms(spans),
        "phase_ms": per_phase,
        "tick_self_pct": (100.0 * per_phase["self"] / per_phase["tick"]
                          if per_phase else None),
        "bank_merge_s": merge_s(spans),
        "idle_gaps": trace.idle_gaps}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--obs", type=int, nargs="+", choices=(0, 1),
                    default=[1], help="each seed runs once per value, in "
                                      "order: the bundle on (1) or off (0)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phases: no CUDA card; nothing was measured", file=sys.stderr)
        return 2
    from repro_torch.serving.obs import NULL_OBS, Observability
    cell = harness.load_cell(args.workload)
    torch.cuda.set_device(0)
    device = {"kind": torch.cuda.get_device_name(0),
              "power_limit": os.popen(
                  "nvidia-smi --query-gpu=power.limit "
                  "--format=csv,noheader").read().strip()}
    for seed in args.seeds:
        for on in args.obs:
            bundle = Observability() if on else NULL_OBS
            out = traced_run(cell, seed, args.seconds, bundle, "cuda")
            out.update(workload=cell.name, seed=seed, obs=bool(on),
                       device=device)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
