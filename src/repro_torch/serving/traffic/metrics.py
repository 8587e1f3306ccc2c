"""SLO metrics for the serving engine: sliding windows + run summaries;
port of ``repro.serving.traffic.metrics``.

``MetricsCollector`` hangs off the engine's callback hooks (no engine
import — anything with ``on_complete``/``on_expire``/``on_tick_end``
lists and a ``now()`` works) and owns every latency/throughput number
the launcher and bench report:

  * per-request: latency from *arrival* (not submit), deadline met/miss,
    expiry (refused admission past deadline),
  * per-tick: queue depth, in-flight count, cumulative bank hits/misses,
  * derived: sliding-window throughput / p50 / p95 / p99 / goodput /
    mean queue depth / window cache hit rate (``windows``), whole-run
    ``summary``, and SLO pass/fail (``evaluate``),
  * scheduler/bank counters: ``summary()`` folds in ``preemptions`` /
    ``deadline_saves`` and the weight bank's ``builds`` /
    ``build_joins`` / ``prefetch_hits`` from the attached engine (these
    used to exist only as launcher print lines).

Memory is bounded: ``events``/``ticks`` are retention-capped buffers
(``max_events``/``max_ticks``). When a cap is hit, the oldest entries
are *compacted* into running aggregates instead of dropped — counts,
goodput, duration, peak queue depth and mean in-flight stay exact over
the whole run; latency percentiles and ``windows()`` cover the retained
window only (``summary()['compacted_events']`` says how much was folded
away). With nothing compacted, every number is identical to the
unbounded behavior.

``percentile`` is the single nearest-rank implementation shared with
``engine.stats()`` (previously duplicated ad-hoc in the launcher path).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses


def percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            int(round(p / 100 * (len(sorted_vals) - 1))))
    return sorted_vals[max(k, 0)]


def _win_index(t: float, w: float) -> int:
    """Half-open window index for time ``t`` at width ``w``.

    Plain ``int(t // w)`` puts a value landing *exactly* on a boundary in
    the window below it whenever ``t / w`` floats just under the integer
    (``0.3 // 0.1 == 2.0``), breaking the documented ``[i*w, (i+1)*w)``
    contract; snap quotients whose fractional part is within 1e-9 of 1
    up to the next integer instead.
    """
    q = t / w
    i = int(q)
    if q - i > 1.0 - 1e-9:
        i += 1
    return i


@dataclasses.dataclass(frozen=True)
class SLO:
    """Thresholds a scenario is judged against (None = not enforced)."""

    p95_s: float | None = None          # latency-from-arrival ceiling
    goodput_min: float | None = None    # fraction finishing within deadline
    throughput_min: float | None = None  # finished requests / second


@dataclasses.dataclass(frozen=True)
class _Event:
    arrival: float
    finished: float
    latency: float | None      # None for expired requests
    met_deadline: bool
    expired: bool


class _Bounded(collections.deque):
    """Append-compatible retention buffer: beyond ``cap`` entries, the
    oldest is handed to ``fold`` (compacted into aggregates) before the
    new one is appended. ``cap=None`` never compacts."""

    def __init__(self, cap: int | None, fold):
        super().__init__()
        self._cap = cap
        self._fold = fold

    def append(self, item) -> None:
        if self._cap is not None and len(self) >= self._cap:
            self._fold(self.popleft())
        super().append(item)


class MetricsCollector:
    def __init__(self, window_s: float = 1.0,
                 max_events: int | None = 200_000,
                 max_ticks: int | None = 200_000):
        assert window_s > 0
        self.window_s = window_s
        self.events: collections.deque = _Bounded(max_events,
                                                  self._fold_event)
        # (now, pending, inflight, hits, misses)
        self.ticks: collections.deque = _Bounded(max_ticks, self._fold_tick)
        self._engine = None
        # compacted-entry aggregates (all zero until a cap is hit); kept
        # exact so summary() totals never depend on retention
        self._f_events = 0
        self._f_done = 0
        self._f_expired = 0
        self._f_met = 0
        self._f_min_arrival: float | None = None
        self._f_max_finished: float | None = None
        self._f_ticks = 0
        self._f_inflight_sum = 0.0
        self._f_peak_queue = 0

    def _fold_event(self, e: "_Event") -> None:
        self._f_events += 1
        self._f_done += not e.expired
        self._f_expired += e.expired
        self._f_met += e.met_deadline
        self._f_min_arrival = (e.arrival if self._f_min_arrival is None
                               else min(self._f_min_arrival, e.arrival))
        self._f_max_finished = (e.finished if self._f_max_finished is None
                                else max(self._f_max_finished, e.finished))

    def _fold_tick(self, t: tuple) -> None:
        self._f_ticks += 1
        self._f_peak_queue = max(self._f_peak_queue, t[1])
        self._f_inflight_sum += t[2]

    # -- engine hooks --------------------------------------------------------

    def attach(self, engine) -> "MetricsCollector":
        engine.on_complete.append(self.on_complete)
        engine.on_expire.append(self.on_expire)
        engine.on_tick_end.append(self.on_tick_end)
        self._engine = engine   # scheduler/bank counters read at summary()
        return self

    def on_complete(self, rs) -> None:
        dl = rs.req.deadline
        self.events.append(_Event(
            arrival=max(rs.submitted_at, rs.req.arrival),
            finished=rs.finished_at, latency=rs.latency,
            met_deadline=(dl is None or rs.finished_at <= dl),
            expired=False))

    def on_expire(self, rs) -> None:
        self.events.append(_Event(
            arrival=max(rs.submitted_at, rs.req.arrival),
            finished=rs.finished_at, latency=None,
            met_deadline=False, expired=True))

    def on_tick_end(self, engine) -> None:
        now = engine.now()
        # queue depth = *arrived* but not yet admitted; an open-loop trace
        # submits its whole future up front and that is not a backlog.
        # pending stays sorted by arrival, so the due prefix bisects.
        queued = bisect.bisect_right(engine.batcher.pending, now,
                                     key=lambda rs: rs.req.arrival)
        self.ticks.append((now, queued, len(engine.batcher.inflight),
                           engine.bank.hits, engine.bank.misses))

    # -- derived views -------------------------------------------------------

    def windows(self, window_s: float | None = None) -> list[dict]:
        """Sliding-window rows over [0, end) at ``window_s`` granularity."""
        w = window_s or self.window_s
        if not self.events and not self.ticks:
            return []
        end = max([e.finished for e in self.events]
                  + [t[0] for t in self.ticks])
        rows = []
        # half-open windows [i*w, (i+1)*w); +1 so an event landing exactly
        # on the last boundary still has a window
        n_win = _win_index(end, w) + 1 if end > 0 else 1
        ev_by_win = collections.defaultdict(list)
        for e in self.events:
            ev_by_win[_win_index(e.finished, w)].append(e)
        ticks_by_win = collections.defaultdict(list)
        for t in self.ticks:
            ticks_by_win[_win_index(t[0], w)].append(t)
        prev_h = prev_m = 0   # cumulative counters at previous window's end
        for i in range(n_win):
            lo = i * w
            evs = ev_by_win.get(i, [])
            lats = sorted(e.latency for e in evs if e.latency is not None)
            ticks = ticks_by_win.get(i, [])
            done = [e for e in evs if not e.expired]
            row = {"t": lo,
                   "throughput_rps": len(done) / w,
                   "p50_s": percentile(lats, 50),
                   "p95_s": percentile(lats, 95),
                   "p99_s": percentile(lats, 99),
                   "goodput_rps": sum(e.met_deadline for e in evs) / w,
                   "expired": sum(e.expired for e in evs),
                   "queue_depth": (sum(t[1] for t in ticks) / len(ticks)
                                   if ticks else 0.0),
                   "inflight": (sum(t[2] for t in ticks) / len(ticks)
                                if ticks else 0.0)}
            if ticks:
                h = ticks[-1][3] - prev_h
                m = ticks[-1][4] - prev_m
                row["cache_hit_rate"] = h / (h + m) if (h + m) else None
                prev_h, prev_m = ticks[-1][3], ticks[-1][4]
            rows.append(row)
        return rows

    def summary(self) -> dict:
        done = [e for e in self.events if not e.expired]
        # percentiles cover the retained window; every count below folds
        # in the compacted aggregates, so totals stay exact under caps
        lats = sorted(e.latency for e in done if e.latency is not None)
        n_events = self._f_events + len(self.events)
        n_done = self._f_done + len(done)
        n_expired = self._f_expired + sum(e.expired for e in self.events)
        n_met = self._f_met + sum(e.met_deadline for e in self.events)
        duration = 0.0
        if n_events:
            arrivals = [e.arrival for e in self.events]
            finishes = [e.finished for e in self.events]
            if self._f_min_arrival is not None:
                arrivals.append(self._f_min_arrival)
                finishes.append(self._f_max_finished)
            duration = max(finishes) - min(arrivals)
        duration = max(duration, 1e-9)
        n_ticks = self._f_ticks + len(self.ticks)
        out = {
            "requests": n_done,
            "expired": n_expired,
            "deadline_misses": n_events - n_met,
            "duration_s": duration,
            "throughput_rps": n_done / duration,
            "goodput_rps": n_met / duration,
            "goodput_frac": n_met / n_events if n_events else 1.0,
            "p50_s": percentile(lats, 50),
            "p95_s": percentile(lats, 95),
            "p99_s": percentile(lats, 99),
            "peak_queue_depth": max([self._f_peak_queue]
                                    + [t[1] for t in self.ticks]),
            "mean_inflight": ((self._f_inflight_sum
                               + sum(t[2] for t in self.ticks)) / n_ticks
                              if n_ticks else 0.0),
            "compacted_events": self._f_events,
            "compacted_ticks": self._f_ticks,
        }
        out.update(self._engine_counters())
        return out

    def _engine_counters(self) -> dict:
        """Scheduler preemption and weight-bank build/prefetch counters
        from the attached engine — read live at summary time (so post-run
        ``bank.drain()`` builds are included), zeros when unattached."""
        eng = self._engine
        batcher = getattr(eng, "batcher", None)
        bank = getattr(eng, "bank", None)
        return {
            "preemptions": getattr(batcher, "preemptions", 0),
            "deadline_saves": getattr(batcher, "deadline_saves", 0),
            "bank_builds": getattr(bank, "builds", 0),
            "bank_build_joins": getattr(bank, "build_joins", 0),
            "prefetch_hits": getattr(bank, "prefetch_hits", 0),
        }

    def evaluate(self, slo: SLO) -> dict:
        """{'passed': bool, 'checks': {name: {...}}} for the set thresholds."""
        s = self.summary()
        checks = {}
        if slo.p95_s is not None:
            checks["p95_s"] = {"limit": slo.p95_s, "actual": s["p95_s"],
                               "ok": s["p95_s"] <= slo.p95_s}
        if slo.goodput_min is not None:
            checks["goodput_frac"] = {"limit": slo.goodput_min,
                                      "actual": s["goodput_frac"],
                                      "ok": s["goodput_frac"]
                                      >= slo.goodput_min}
        if slo.throughput_min is not None:
            checks["throughput_rps"] = {"limit": slo.throughput_min,
                                        "actual": s["throughput_rps"],
                                        "ok": s["throughput_rps"]
                                        >= slo.throughput_min}
        return {"passed": all(c["ok"] for c in checks.values()),
                "checks": checks}
