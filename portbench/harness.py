"""One run of one cell: set-up, the measured window, the trace, the metrics
and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric is a
file the harness finds by name (``BENCHMARK.json`` names them):
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(run)`` that returns a number or None)
and ``limits/<workload>.json`` (the limit of each number compared).

The system under test is the port's serving entry,
``repro_torch.serving.DiffusionServingEngine``, built as
``launch/serve_diffusion.py`` builds it (the abs-max FP4 plan, TALoRA hubs
and router, E2M1 acts, policy ``fifo``, the implicit conv route, no obs),
with a weight bank that holds every routing segment, all built in set-up.
The harness submits the traffic's requests when they are due and steps
``engine.tick()`` itself, so the window has a fixed length. It watches
through two seams: the engine's ``apply_fn`` (``Recorder``: the model
call itself, noting what the comparison needs) and the batcher's
``select`` (which requests a forward's rows hold).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from portbench import check, devtrace, flops, inputs, loadgen, reference

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
    return Cell(
        name=workload, config_name=w["config"],
        cfg=json.loads((root / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=e2e, per_layer=per_layer,
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text()),
        root=root)


def load_reader(root: pathlib.Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
    def traffic(self) -> dict:
        return self.cell.traffic


def _unet_config(cfg: dict):
    from repro_torch.nn.unet import UNetConfig
    return UNetConfig(image_size=cfg["image_size"], in_ch=cfg["in_ch"],
                      out_ch=cfg["out_ch"], ch=cfg["ch"],
                      ch_mult=tuple(cfg["ch_mult"]),
                      num_res_blocks=cfg["num_res_blocks"],
                      attn_resolutions=tuple(cfg["attn_resolutions"]),
                      gn_groups=cfg["gn_groups"])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str):
    return torch.profiler.record_function(f"portbench.{name}")


class Recorder:
    """The engine's model call (its ``apply_fn`` seam): ``unet_apply``
    itself, noting for the comparison, without a synchronise, the input,
    timestep and eps rows of the sampled requests at every forward; and
    once asked (``capture``), the first and last rows of every conv, dense
    and GroupNorm call of one forward."""

    def __init__(self, ucfg, sampled: set):
        self.ucfg = ucfg
        self.sampled = sampled
        self.members: list = []
        self.records = collections.defaultdict(list)
        self.capture = False
        self.captured: dict | None = None

    def select(self, select):
        """Wrap the batcher's ``select`` to learn each forward's rows: one
        partition (no class labels), rows in the members' order."""
        def recording_select(*args, **kw):
            seg, self.members = select(*args, **kw)
            return seg, self.members
        return recording_select

    def __call__(self, params, x, tb, y, ctx):
        from repro_torch.nn import unet
        if not self.capture:
            eps = unet.unet_apply(params, x, tb, self.ucfg, y=y, ctx=ctx)
        else:
            eps = self._captured_forward(unet, params, x, tb, y, ctx)
        for j, rs in enumerate(self.members[:x.shape[0]]):
            if rs.req.seed in self.sampled:
                self.records[rs.req.seed].append(
                    (tb[j:j + 1].clone(), x[j:j + 1].clone(),
                     eps[j:j + 1].clone()))
        return eps

    def _captured_forward(self, unet, params, x, tb, y, ctx):
        rows = torch.tensor(sorted({0, x.shape[0] - 1}), device=x.device)
        ops, saved = [], {}
        for name in ("conv2d_apply", "dense_apply", "groupnorm_apply"):
            fn = saved[name] = getattr(unet, name)

            def rec(p, xx, _fn=fn, **kw):
                out = _fn(p, xx, **kw)
                ops.append((xx[rows].float(), out[rows].float()))
                return out
            setattr(unet, name, rec)
        try:
            eps = unet.unet_apply(params, x, tb, self.ucfg, y=y, ctx=ctx)
        finally:
            for name, fn in saved.items():
                setattr(unet, name, fn)
        self.capture = False
        self.captured = {"x": x[rows].clone(), "t": tb[rows].clone(),
                         "eps": eps[rows].clone(), "ops": ops}
        return eps


class System:
    """The port, built for one cell from the handed inputs."""

    def __init__(self, cell: Cell, params: dict, hubs: dict, router: dict,
                 x_T: torch.Tensor, clock: Clock, device,
                 sampled: set = frozenset()):
        from repro_torch.common.tree import flatten_paths
        from repro_torch.core import talora
        from repro_torch.diffusion.schedule import make_schedule
        from repro_torch.kernels import ops
        from repro_torch.nn.unet import io_sites
        from repro_torch.quant.fakequant import (KIND_FP_SIGNED,
                                                 QuantizerParams)
        from repro_torch.serving import (DiffusionServingEngine, WeightBank,
                                         default_serving_plan)
        from repro_torch.serving.obs import NULL_OBS
        cfg = cell.cfg
        ops.CONV_ROUTE = "implicit"
        self.device = device
        self.ucfg = _unet_config(cfg)
        weights = {k: v for k, v in flatten_paths(params).items()
                   if k.endswith("/w") and v.ndim >= 2}
        plan = default_serving_plan(weights, io_sites=io_sites(params))
        self.bank = WeightBank(params, plan, hubs, router,
                               talora.TALoRAConfig(**cfg["talora"]), cfg["T"],
                               max_cached=cfg["T"], device=device)
        act = QuantizerParams(KIND_FP_SIGNED, 2, 1, 4, torch.tensor(
            float(cfg["act_maxval"]), device=device))

        def new_engine(max_batch: int, clock: Clock):
            self.recorder = Recorder(self.ucfg, sampled)
            eng = DiffusionServingEngine(
                self.ucfg, make_schedule("linear", cfg["T"]), self.bank,
                act_qps={"*": act}, apply_fn=self.recorder,
                max_batch=max_batch, policy="fifo", now_fn=clock.now,
                obs=NULL_OBS, device=device,
                noise_fn=lambda req: x_T[req.seed:req.seed + 1])
            eng.batcher.select = self.recorder.select(eng.batcher.select)
            return eng

        self.new_engine = new_engine
        self.engine = new_engine(cell.traffic["max_batch"], clock)

    def build_segments(self) -> None:
        for s in range(self.bank.n_segments):
            self.bank.prefetch(s, block=True)
        _sync(self.device)

    def warm(self, buckets: list[int], gen: torch.Generator) -> None:
        """One forward at each batch bucket the traffic runs."""
        from repro_torch.nn.unet import unet_apply
        params = self.bank.params_for_segment(0)
        s, c = self.ucfg.image_size, self.ucfg.in_ch
        for b in buckets:
            x = torch.randn((b, s, s, c), generator=gen, device=gen.device)
            tb = (torch.arange(b, device=gen.device) % self.bank.T).float()
            with torch.inference_mode():
                unet_apply(params, x, tb, self.ucfg, ctx=self.engine.ctx)
        _sync(self.device)

    def submit(self, r: loadgen.Request) -> int:
        return self.engine.submit(steps=r.steps, eta=r.eta, seed=r.index,
                                  sampler=r.sampler, arrival=r.due)


class Window:
    """Drives the system through the window, ticking and recording; the
    first forward after it is the one the comparison records op by op."""

    def __init__(self, system: System, clock: Clock, seconds: float,
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
            rec = self.sys.recorder
            rec.capture = rec.captured is None

    def run_backlog(self, follow: set) -> None:
        """Tick through the window, then once more (the forward the
        comparison records) and on until the requests in ``follow`` have
        finished (at most ``DRAIN_LIMIT_S`` past the window)."""
        eng = self.sys.engine
        batcher = eng.batcher
        while self.clock.now() < self.seconds and (batcher.inflight
                                                   or batcher.pending):
            self.tick()
        self.close()
        while batcher.inflight and (
                self.sys.recorder.captured is None
                or not follow <= {rs.req.seed for rs in eng.results.values()}):
            if self.clock.now() > self.seconds + DRAIN_LIMIT_S:
                break
            self.tick()

    def run_open(self, reqs: list, follow: set) -> list:
        """Submit each request when due and tick, through the window and on
        until the requests in ``follow`` have finished (at most
        ``DRAIN_LIMIT_S`` past the window). Returns the generator's
        lateness at every submit."""
        eng = self.sys.engine
        late, rid_of = [], {}
        i = 0
        while True:
            now = self.clock.now()
            with _span("submit"):
                while i < len(reqs) and reqs[i].due <= now:
                    rid_of[reqs[i].index] = self.sys.submit(reqs[i])
                    late.append(self.clock.now() - reqs[i].due)
                    i += 1
            if (now >= self.seconds
                    and self.sys.recorder.captured is not None
                    and all(rid_of.get(k) in eng.results for k in follow)):
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


def sample_of(cell: Cell, reqs: list, seed: int) -> list[int]:
    """The requests the comparison follows, drawn from the seed before the
    run: from a backlog's first batch, or from the requests due in the
    window's first third with the one of most evals among them; both
    finish within the window even where the queue grows (at twice the
    knee a request due at d finishes near 2d plus its own service)."""
    T = cell.cfg["T"]
    if cell.traffic["process"] == "backlog":
        cand = [r.index for r in reqs[:cell.traffic["max_batch"]]]
        return check.pick(cand, {}, seed, longest=False)
    third = max(r.due for r in reqs if r.in_window) / 3
    evals = {r.index: reference.n_evals(r.sampler, T, r.steps)
             for r in reqs if r.in_window and r.due <= third}
    return check.pick(list(evals), evals, seed, longest=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the result line's object (without checking what
    the process has loaded: the caller does that last)."""
    device = torch.device(device)
    clock = Clock()
    cfg, traffic = cell.cfg, cell.traffic
    gen = inputs.generator(seed, device)
    params = inputs.params(cfg, gen)
    hubs = inputs.hubs(cfg, gen)
    router = inputs.router(cfg, gen)
    reqs = loadgen.generate(traffic, seed, seconds,
                            TAIL_S if traffic["process"] != "backlog" else 0)
    x_T = inputs.noise(cfg, gen, len(reqs))
    sample = sample_of(cell, reqs, seed)
    system = System(cell, params, hubs, router, x_T, clock, device,
                    set(sample))
    t_bank = time.perf_counter()
    system.build_segments()
    window = [r for r in reqs if r.in_window]
    run = Run(cell, bank_build_s=time.perf_counter() - t_bank,
              flops_per_eval=flops.model_flops(cfg, 1),
              evals_per_image=float(np.mean([
                  reference.n_evals(r.sampler, cfg["T"], r.steps)
                  for r in window])))
    system.warm(loadgen.buckets(traffic), gen)
    if trace:
        devtrace.prime(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    eng = system.engine
    if traffic["process"] == "backlog":
        for r in reqs:
            system.submit(r)
    _sync(device)
    win = Window(system, clock, seconds, trace)
    clock.reset()
    run.setup_s = time.perf_counter() - t_start
    late = []
    if traffic["process"] == "backlog":
        win.run_backlog(set(sample))
    else:
        late = win.run_open(reqs, set(sample))
    _sync(device)
    run.window_s = win.end
    run.ticks, run.tick_s = win.ticks, win.tick_s
    run.forwards, run.evals = win.forwards, win.evals
    if win.prof is not None:
        run.trace = devtrace.read(win.prof)
        run.traced_buckets = win.traced
    if late:
        print(f"generator lateness: max {max(late) * 1e3:.3f} ms, median "
              f"{float(np.median(late)) * 1e3:.3f} ms over {len(late)} "
              "submits", file=sys.stderr)

    # the answers: every request finished by the run's end (one still
    # queued is late, not wrong), and every followed one
    by_index = {rs.req.seed: rs for rs in eng.results.values()}
    due = sorted(set(by_index) | set(sample))
    failed = [i for i in due if i not in by_index
              or by_index[i].x0 is None
              or not bool(torch.isfinite(by_index[i].x0).all())]
    answers = {i: by_index[i].x0 for i in sample
               if i in by_index and by_index[i].x0 is not None}
    rec = system.recorder
    stats = eng.stats()
    del by_index, eng
    system.bank = system.engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    spec = {r.index: r for r in reqs}
    weights = reference.Weights(params, hubs, router, cfg)
    checks = {
        "trajectory_gap": check.trajectory_gap(
            cfg, [spec[i] for i in sample], x_T, rec.records, answers),
        "layer_gap": (check.layer_gap(cfg, weights, rec.captured)
                      if rec.captured is not None else float("inf"))}
    print(f"reference: {len(sample)} trajectories and one forward in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)

    metrics = {}
    for m in (cell.end_to_end if not trace else cell.per_layer):
        v = load_reader(cell.root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = (not failed and all(math.isfinite(v) for v in checks.values())
               and all(v <= cell.limits[k] for k, v in checks.items()))
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
    out["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                     for k, v in checks.items()}
    return out
