"""One run of one cell: set-up, the measured window, the trace, the metrics
and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, metric or
model family is a file the harness finds by name (``BENCHMARK.json``
names the cells and configurations): ``configs/<config>.json`` (whose
``family`` key names the model family), ``families/<family>.py``,
``traffic/<traffic>.json``, ``metrics/<metric>.py`` (a ``read(run)`` that
returns a number or None) and ``limits/<workload>.json`` (the limit of
each number compared).

A family module owns all that the harness does not need to know of the
model: ``build(cell, seed, seconds, device, clock)`` draws the inputs from
the seed, generates the requests (``loadgen``), picks those the
comparison follows and builds the port's engine through its normal
entry, and returns the system, which has ``engine`` (``submit``, ``tick``,
``batcher``, ``n_forwards``, ``n_samples_batched``, ``results``,
``on_forward``, ``stats``), ``device``, ``reqs``, ``follow``, ``set_up()``
(the builds and warm forwards; returns ``bank_build_s``), ``submit(req)``,
``close()`` (the window has closed) and ``ready(follow)`` (what the
drain waits on); ``evals_per_image(cell, reqs)``,
``flops_per_eval(cfg)`` and ``kernel_bound_seconds(cfg, kernel, batch)``
count the work; ``KERNELS`` maps a pattern of a device kernel's name to
its kernel class (``devtrace.read``); and ``compare(system)`` frees the
engine and returns the values named in the cell's limits file. A run
whose comparison leaves out a number that the limits file names, or
returns one that it does not name, is not correct.

The harness submits the traffic's requests when they are due and steps
``engine.tick()`` itself, so the window has a fixed length.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from portbench import devtrace

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# an open-loop run keeps arriving this long past the window, at the same
# rate, while the requests the comparison follows finish
TAIL_S = 120.0
# and a run gives those requests at most this long past the window
DRAIN_LIMIT_S = 150.0
# the traced part of a --trace 1 run's window: from TRACE_AT of it, for
# TRACE_S seconds (or to the window's end)
TRACE_AT = 0.25
TRACE_S = 3.0


def forbidden_modules(names=None) -> list[str]:
    """Top-level names (the part before the first dot, compared whole) of
    loaded modules that a run may not load: JAX and the JAX package."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    cfg: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    root: pathlib.Path
    family: object = None     # the module families/<family>.py


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, names)]
    bench = root / "portbench"
    cfg = json.loads((root / conf["file"]).read_text())
    if "family" not in cfg:
        raise SystemExit(f"{conf['file']} has no \"family\" key: a "
                         "configuration names its model family, the module "
                         "portbench/families/<family>.py")
    return Cell(
        name=workload, config_name=w["config"], cfg=cfg,
        traffic_name=w["traffic"],
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=e2e, per_layer=per_layer,
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text()),
        root=root, family=load_family(root, cfg["family"]))


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered, as an import would, so that its dataclasses resolve
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_family(root: pathlib.Path, name: str):
    path = root / "portbench" / "families" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no model family {name!r}: "
                         f"{path.relative_to(root)} does not exist")
    return _load(path, "portbench_family_" + name.replace(".", "_"))


def load_reader(root: pathlib.Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    return _load(path, "portbench_metric_" + name.replace(".", "_")).read


class Clock:
    """Seconds on the host's monotonic clock from ``reset``."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def reset(self) -> None:
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    setup_s: float = 0.0
    bank_build_s: float = 0.0
    window_s: float = 0.0
    evals: int = 0                 # useful rows of the window's forwards
    forwards: int = 0
    ticks: int = 0
    tick_s: list = dataclasses.field(default_factory=list)
    evals_per_image: float = 0.0   # over the traffic's window requests
    flops_per_eval: int = 0
    trace: devtrace.Trace | None = None
    traced_buckets: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def family(self):
        return self.cell.family

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str):
    return torch.profiler.record_function(f"portbench.{name}")


class Window:
    """Drives a family's system through the window, ticking ``engine``
    and recording; once the window has closed it tells the system
    (``close``) and drains until the system is ``ready``."""

    def __init__(self, system, clock: Clock, seconds: float,
                 trace: bool):
        self.sys, self.clock, self.seconds = system, clock, seconds
        self.trace_on = trace
        self.prof = None
        self.traced = collections.Counter()
        self.win_span = None
        self.tick_s: list[float] = []
        self.ticks = self.forwards = self.evals = 0
        self.end = None
        self.peak = 0
        self.padded = 0
        system.engine.on_forward.append(self._on_forward)

    def _on_forward(self, engine, padded_rows: int) -> None:
        self.padded = padded_rows

    def _trace_edge(self, now: float) -> None:
        if not self.trace_on:
            return
        t0 = TRACE_AT * self.seconds
        if self.prof is None and now >= t0 and self.end is None:
            self.prof = devtrace.start()
            self.win_span = _span("window")
            self.win_span.__enter__()
        elif (self.win_span is not None and now >= min(t0 + TRACE_S,
                                                       self.seconds)):
            self._end_trace()

    def _end_trace(self) -> None:
        self.win_span.__exit__(None, None, None)
        self.win_span = None
        self.prof.stop()

    def tick(self) -> None:
        eng = self.sys.engine
        now = self.clock.now()
        if now >= self.seconds:
            self.close()
        self._trace_edge(now)
        rows0, fwd0 = eng.n_samples_batched, eng.n_forwards
        with _span("tick"):
            t0 = time.perf_counter()
            eng.tick()
            dt = time.perf_counter() - t0
        if self.end is None and eng.n_forwards > fwd0:
            self.ticks += 1
            self.tick_s.append(dt)
            self.forwards += eng.n_forwards - fwd0
            self.evals += eng.n_samples_batched - rows0
            if self.win_span is not None:
                self.traced[self.padded] += 1

    def close(self) -> None:
        if self.end is None:
            self.end = self.clock.now()
            if self.win_span is not None:
                self._end_trace()
            dev = self.sys.device
            if dev.type == "cuda":
                self.peak = torch.cuda.max_memory_allocated(dev)
            self.sys.close()

    def run_backlog(self, follow: set) -> None:
        """Tick through the window, then on until the system is ready for
        ``follow`` (at most ``DRAIN_LIMIT_S`` past the window)."""
        batcher = self.sys.engine.batcher
        while self.clock.now() < self.seconds and (batcher.inflight
                                                   or batcher.pending):
            self.tick()
        self.close()
        # a window that closes as a batch retires leaves nothing in flight
        # and the backlog pending: the next tick admits and runs it
        while ((batcher.inflight or batcher.pending)
               and not self.sys.ready(follow)):
            if self.clock.now() > self.seconds + DRAIN_LIMIT_S:
                break
            self.tick()

    def run_open(self, reqs: list, follow: set) -> list:
        """Submit each request when due and tick, through the window and on
        until the system is ready for ``follow`` (at most
        ``DRAIN_LIMIT_S`` past the window). Returns the generator's
        lateness at every submit."""
        eng = self.sys.engine
        late = []
        i = 0
        while True:
            now = self.clock.now()
            with _span("submit"):
                while i < len(reqs) and reqs[i].due <= now:
                    self.sys.submit(reqs[i])
                    late.append(self.clock.now() - reqs[i].due)
                    i += 1
            if now >= self.seconds and self.sys.ready(follow):
                break
            if now > self.seconds + DRAIN_LIMIT_S:
                break
            if eng.batcher.inflight or eng.batcher.pending:
                self.tick()
            else:
                if now >= self.seconds:
                    self.close()
                wait = reqs[i].due - now if i < len(reqs) else 0.001
                with _span("idle"):
                    time.sleep(min(max(wait, 0.0), 0.01))
        self.close()
        return late


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the result line's object (without checking what
    the process has loaded: the caller does that last)."""
    device = torch.device(device)
    clock = Clock()
    fam, traffic = cell.family, cell.traffic
    system = fam.build(cell, seed, seconds, device, clock)
    run = Run(cell, bank_build_s=system.set_up(),
              flops_per_eval=fam.flops_per_eval(cell.cfg),
              evals_per_image=fam.evals_per_image(
                  cell, [r for r in system.reqs if r.in_window]))
    if trace:
        devtrace.prime(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if traffic["process"] == "backlog":
        for r in system.reqs:
            system.submit(r)
    sync(device)
    win = Window(system, clock, seconds, trace)
    clock.reset()
    run.setup_s = time.perf_counter() - t_start
    follow = set(system.follow)
    late = []
    if traffic["process"] == "backlog":
        win.run_backlog(follow)
    else:
        late = win.run_open(system.reqs, follow)
    sync(device)
    run.window_s = win.end
    run.ticks, run.tick_s = win.ticks, win.tick_s
    run.forwards, run.evals = win.forwards, win.evals
    if win.prof is not None:
        run.trace = devtrace.read(win.prof, fam.KERNELS)
        run.traced_buckets = win.traced
    if late:
        print(f"generator lateness: max {max(late) * 1e3:.3f} ms, median "
              f"{float(np.median(late)) * 1e3:.3f} ms over {len(late)} "
              "submits", file=sys.stderr)

    # the answers: every request finished by the run's end (one still
    # queued is late, not wrong), and every followed one
    by_index = {rs.req.seed: rs for rs in system.engine.results.values()}
    due = sorted(set(by_index) | follow)
    failed = [i for i in due if i not in by_index
              or by_index[i].x0 is None
              or not bool(torch.isfinite(by_index[i].x0).all())]
    stats = system.engine.stats()
    del by_index
    checks = fam.compare(system)

    metrics = {}
    for m in (cell.end_to_end if not trace else cell.per_layer):
        v = load_reader(cell.root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # every number the limits file names, and no other, is compared
    names = list(cell.limits) + [k for k in checks if k not in cell.limits]
    unmatched = [k for k in names if k not in checks or k not in cell.limits]
    if unmatched:
        print(f"checks {unmatched}: each is in only one of the limits file "
              "and the family's comparison", file=sys.stderr)
    correct = (not failed and not unmatched
               and all(math.isfinite(checks[k]) and checks[k] <= cell.limits[k]
                       for k in names))
    out = {"correct": correct, "attempted": len(due),
           "failed": len(failed), "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": win.peak}}
    if run.trace is not None:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["engine"] = {k: stats[k] for k in ("requests", "ticks", "forwards",
                                           "mean_batch", "buckets",
                                           "padded_samples",
                                           "bank_segments", "bank_builds",
                                           "bank_misses")}
    out["checks"] = {k: {"value": checks.get(k), "limit": cell.limits.get(k)}
                     for k in names}
    return out
