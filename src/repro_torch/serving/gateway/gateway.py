"""ServingGateway: one submit/complete surface over N model engines; port
of ``repro.serving.gateway.gateway``.

The gateway owns one engine per registered model — a
``DiffusionServingEngine`` or the thin ``LMServingEngine`` adapter, each
with its *own* ``WeightBank`` — and routes every submitted request by
its ``model`` field (``None`` -> the default model, the first one
added). Requests get a gateway-wide id (*gid*) so two engines counting
their local rids from zero never collide on the gateway surface;
``results`` and the return of ``submit``/``run`` are keyed by gid.

Hook fan-in: each engine's ``on_submit`` / ``on_complete`` /
``on_expire`` / ``on_tick_end`` hooks forward into the gateway's own
hook lists after annotating the request state with its routing
(``rs.model``, ``rs.gid``) — so one shared ``MetricsCollector`` (or a
``TraceWriter``, or a closed-loop generator) attaches to the gateway
exactly like it would to a single engine. Per-model collectors attach in
``add_model`` and power ``stats()``'s per-model summaries and SLO
verdicts.

Determinism: ``run()`` generalizes the single-engine driver — under a
shared ``VirtualClock`` it advances time to the earliest next arrival
across engines that could admit it, then ticks every live engine in
registration order; with exactly one model the tick sequence is
*identical* to ``engine.run()``, so a single-model golden replay through
the gateway reproduces the engine's golden digest (the "gateway adds
zero behavior" CI assertion). Under a shared ``SimClock`` both engines'
compute charges the same simulated time axis, which is what makes
cross-model contention measurable and machine-independent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.serving.gateway.registry import ModelEntry
from repro_torch.serving.traffic.metrics import MetricsCollector


@dataclasses.dataclass
class HostedModel:
    """One registered model: its entry, engine, and routing bookkeeping."""

    entry: ModelEntry
    engine: object
    collector: MetricsCollector
    gid_of: dict[int, int] = dataclasses.field(default_factory=dict)


class ServingGateway:
    """Multi-model request router over per-model engines + weight banks."""

    # submit_trace / generators pass each request's ``model`` field only
    # to surfaces that advertise routing
    routes_models = True

    def __init__(self, *, clock=None,
                 now_fn: Callable[[], float] | None = None,
                 max_idle_sleep: float = 0.25):
        self._models: dict[str, HostedModel] = {}
        self.default_model: str | None = None
        if clock is not None:
            self._now = clock.now
            self._advance = clock.advance_to
        else:
            t0 = time.monotonic()
            self._now = now_fn or (lambda: time.monotonic() - t0)
            self._advance = None
        self.max_idle_sleep = max_idle_sleep
        self._next_gid = 0
        self._pending_submit: tuple[str, int] | None = None
        self.route: dict[int, tuple[str, int]] = {}   # gid -> (name, rid)
        self.results: dict[int, object] = {}          # gid -> RequestState
        self.n_idle_sleeps = 0
        # gateway-surface hooks: same contract as an engine's (the shared
        # MetricsCollector / TraceWriter / closed-loop generator attach
        # here); receive the per-engine RequestState annotated with
        # ``rs.model`` / ``rs.gid``
        self.on_submit: list[Callable] = []
        self.on_complete: list[Callable] = []
        self.on_expire: list[Callable] = []
        self.on_tick_end: list[Callable] = []

    # -- registration --------------------------------------------------------

    def add_model(self, entry: ModelEntry, engine) -> "ServingGateway":
        """Host ``engine`` under ``entry.name``. The engine must be idle
        (no submitted requests) and share the gateway's clock — builders
        construct it with the same ``clock=`` / ``now_fn=`` the gateway
        was given."""
        name = entry.name
        if name in self._models:
            raise ValueError(f"model {name!r} already hosted")
        if engine.batcher.pending or engine.batcher.inflight:
            raise ValueError(f"engine for {name!r} already has requests")
        m = HostedModel(entry=entry, engine=engine,
                        collector=MetricsCollector())
        m.collector.attach(engine)

        def fwd_submit(rs, _m=m, _name=name):
            # runs inside engine.submit: the gateway stashed (name, gid)
            # just before calling it. Direct engine.submit calls (not
            # through the gateway) keep rs un-annotated.
            if self._pending_submit is not None:
                pname, gid = self._pending_submit
                if pname == _name:
                    rs.model = _name
                    rs.gid = gid
                    _m.gid_of[rs.req.rid] = gid
            for cb in self.on_submit:
                cb(rs)

        def fwd_done(rs, _m=m, _name=name, expire=False):
            gid = _m.gid_of.get(rs.req.rid)
            if gid is not None:
                self.results[gid] = rs
            for cb in (self.on_expire if expire else self.on_complete):
                cb(rs)

        engine.on_submit.append(fwd_submit)
        engine.on_complete.append(lambda rs: fwd_done(rs))
        engine.on_expire.append(lambda rs: fwd_done(rs, expire=True))
        engine.on_tick_end.append(
            lambda e: [cb(e) for cb in self.on_tick_end])
        self._models[name] = m
        if self.default_model is None:
            self.default_model = name
        return self

    def list_models(self) -> list[str]:
        return list(self._models)          # registration order

    def engine(self, name: str):
        return self._models[name].engine

    def _resolve(self, model: str | None) -> str:
        if model is None:
            if self.default_model is None:
                raise RuntimeError("gateway has no models registered")
            return self.default_model
        if model not in self._models:
            raise KeyError(f"unknown model {model!r} "
                           f"(hosted: {self.list_models()})")
        return model

    # -- request lifecycle -----------------------------------------------------

    def submit(self, *, model: str | None = None, **kw) -> int:
        """Route one request; returns its gateway-wide gid. ``kw`` is the
        engine submit signature (steps/eta/seed/sampler/.../think_s)."""
        name = self._resolve(model)
        m = self._models[name]
        gid = self._next_gid
        self._next_gid += 1
        self._pending_submit = (name, gid)
        try:
            rid = m.engine.submit(**kw)
        finally:
            self._pending_submit = None
        m.gid_of[rid] = gid
        self.route[gid] = (name, rid)
        return gid

    def pop_result(self, gid: int):
        """Hand a finished request to its caller and drop *every* piece of
        per-request bookkeeping — ``results``, the gid routing entry, and
        the hosted model's rid->gid map. A long-lived gateway that popped
        results but kept route/gid_of entries would leak one dict entry
        per request forever."""
        rs = self.results.pop(gid)
        name, rid = self.route.pop(gid)
        m = self._models[name]
        m.engine.results.pop(rid, None)
        m.gid_of.pop(rid, None)
        return rs

    # -- driver ------------------------------------------------------------

    def run(self, *, max_idle_sleep: float | None = None) -> dict:
        """Tick every engine to drain; returns ``results`` keyed by gid.

        Mirrors the single-engine driver exactly (see ``engine.run``):
        under a virtual clock, advance to the earliest next arrival any
        engine could admit *before* ticking; under a wall clock, sleep
        while every engine is idle. Engines tick in registration order,
        so a multi-model replay is deterministic under the virtual clock.
        """
        cap = self.max_idle_sleep if max_idle_sleep is None else max_idle_sleep
        engines = [m.engine for m in self._models.values()]
        if not engines:
            return self.results

        def live(e):
            return e.batcher.pending or e.batcher.inflight

        while any(live(e) for e in engines):
            if self._advance is not None:
                nxts = [e.batcher.next_arrival() for e in engines
                        if e.batcher.pending
                        and len(e.batcher.inflight) < e.batcher.max_batch]
                if nxts:
                    nxt = min(nxts)
                    if nxt > self._now():
                        self._advance(nxt)
                        self.n_idle_sleeps += 1
            for e in engines:
                if live(e):
                    e.tick()
            if (self._advance is None
                    and all(not e.batcher.inflight for e in engines)
                    and any(e.batcher.pending for e in engines)):
                wait = min(e.batcher.next_arrival() for e in engines
                           if e.batcher.pending) - self._now()
                # cap <= 0 disables sleeping entirely (see engine.run)
                if wait > 0 and cap > 0:
                    time.sleep(min(wait, cap))
                    self.n_idle_sleeps += 1
        for e in engines:
            e.bank.drain()
        return self.results

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        """Aggregate + per-model view. Per-model entries carry the
        engine's full ``stats()`` (bank counters included), the model's
        traffic summary, and its SLO verdict against the registry entry's
        thresholds; the aggregate sums the cross-model totals."""
        per = {}
        for name, m in self._models.items():
            s = m.engine.stats()
            summary = m.collector.summary()
            per[name] = {"engine": s, "summary": summary,
                         "slo": m.collector.evaluate(m.entry.slo),
                         "family": m.entry.family}
        agg = {
            "models": self.list_models(),
            "requests": sum(p["engine"]["requests"] for p in per.values()),
            "expired": sum(p["engine"]["expired"] for p in per.values()),
            "ticks": sum(p["engine"]["ticks"] for p in per.values()),
            "forwards": sum(p["engine"]["forwards"] for p in per.values()),
            "idle_sleeps": self.n_idle_sleeps,
            "goodput_frac": {name: p["summary"]["goodput_frac"]
                             for name, p in per.items()},
        }
        return {"aggregate": agg, "per_model": per}
