"""Unified observability layer for the W4A4 serving stack; port of
``repro.serving.obs``.

One ``Observability`` bundle carries the three concerns every component
hangs telemetry off:

  * ``tracer`` — structured spans (``obs.tracer``): request lifecycle
    (submit -> admit -> per-eval -> complete/expire, as Chrome async
    events keyed by rid), engine ticks and their phases (``admit``,
    ``group``, ``bank_fetch``, ``forward`` with ``stage``/``launch``/
    ``sync``, ``advance``, ``prefetch``) with scheduler decision
    annotations, weight-bank build spans with their ``merge`` and
    ``pack`` stages (including from the background prefetch worker
    thread), and per-dispatch kernel-route marks. Exports Chrome
    trace-event JSON (Perfetto-loadable) or JSONL. Every duration span is
    also a ``torch.profiler`` range named ``<cat>.<name>``, on the
    profiler's clock, so a profiled run lines the spans up with the
    device's kernels.
  * ``metrics`` — the counter/gauge/histogram registry
    (``obs.metrics``): the single machine-readable home for the numbers
    previously scattered across ``engine.stats()``, ``bank.describe()``,
    scheduler attributes and launcher print lines. ``sample(engine)``
    refreshes the engine/bank/scheduler gauges once per tick (and emits
    Perfetto counter-track samples); ``finalize`` folds in the run-end
    summary.
  * ``kernel_profiler`` — per-route dispatch counts/timings installed
    into ``kernels/ops`` (see ``kernel_profile``: device seconds from CUDA
    events on the card, wall seconds on the CPU).

Contracts:

  * **Determinism** — the tracer's buffer keeps the *engine's* clock
    (``bind_engine``), never a wall clock of its own (only the profiler
    ranges carry the profiler's); under a
    ``VirtualClock`` replay the whole trace is deterministic and the
    golden outcome digest is unchanged whether obs is on or off (the
    layer only reads state; pinned by tests/test_obs.py).
  * **Near-zero disabled overhead** — ``NULL_OBS`` (the default
    everywhere) has ``enabled=False``; every instrumentation point in
    engine/scheduler/bank guards with that single branch before building
    any args, and opens no profiler range; the kernels hook is one
    module-global ``None`` check.
  * **Thread safety** — see ``tracer``/``metrics`` module docs; bank
    spans are emitted from the prefetch worker under churn without
    corrupting the buffer (pinned by tests/test_torch_obs.py).
"""
from __future__ import annotations

from repro_torch.serving.obs.kernel_profile import KernelProfiler
from repro_torch.serving.obs.metrics import (Counter, Gauge, Histogram,
                                             MetricsRegistry)
from repro_torch.serving.obs.tracer import NullTracer, Span, SpanTracer


class Observability:
    def __init__(self, enabled: bool = True, *, clock=None,
                 max_events: int = 500_000, lock_factory=None):
        # lock_factory propagates to every obs-owned lock (tracer buffer,
        # registry + instruments, kernel profiler) — the seam an
        # order-tracking lock monitor installs through in the
        # lock-discipline tests.
        self.enabled = enabled
        self.tracer = (SpanTracer(clock=clock, max_events=max_events,
                                  lock_factory=lock_factory)
                       if enabled else NullTracer())
        self.metrics = MetricsRegistry(lock_factory=lock_factory)
        self.kernel_profiler = (KernelProfiler(self,
                                               lock_factory=lock_factory)
                                if enabled else None)

    # -- wiring --------------------------------------------------------------

    def bind_engine(self, engine) -> "Observability":
        """Point the tracer at the engine's clock (virtual, simulated, or
        wall — whatever the engine runs on, timestamps follow it)."""
        self.tracer.set_clock(engine.now)
        return self

    def install_kernels(self) -> "Observability":
        if self.kernel_profiler is not None:
            self.kernel_profiler.install()
        return self

    def uninstall_kernels(self) -> None:
        if self.kernel_profiler is not None:
            self.kernel_profiler.uninstall()

    # -- per-tick / run-end registry sync ------------------------------------

    @staticmethod
    def _engine_labels(engine) -> dict:
        lab = {}
        if getattr(engine, "model", None):
            lab["model"] = engine.model
        if getattr(engine, "replica", None):
            lab["replica"] = engine.replica
        return lab

    def sample(self, engine) -> None:
        """Cheap per-tick snapshot of engine/bank/scheduler counters into
        registry gauges + a Perfetto counter-track sample. Reads plain
        attributes only (never ``engine.stats()``, which sorts latency
        lists) so a tick pays O(#gauges) dict work, nothing more."""
        if not self.enabled:
            return
        m = self.metrics
        b = engine.batcher
        bank = engine.bank
        # engines hosted behind the gateway carry a model identity, fleet
        # replicas a replica identity: their gauges become labeled series
        # so two engines never clobber one family; a standalone engine
        # (model=None, replica=None) keeps the unlabeled names
        # byte-identical to the pre-gateway exposition
        lab = self._engine_labels(engine)
        m.set("engine_ticks", engine.tick_count, **lab)
        m.set("engine_forwards", engine.n_forwards, **lab)
        m.set("engine_finished", engine.n_finished, **lab)
        m.set("engine_expired", engine.n_expired, **lab)
        m.set("engine_pending", len(b.pending), **lab)
        m.set("engine_inflight", len(b.inflight), **lab)
        m.set("engine_padded_samples", engine.n_padded_samples, **lab)
        # the (bucket, has_y) forward shapes run so far: the port runs
        # eagerly, so this counts the shapes the reference would compile
        # (its len(engine._jit)); the gauge keeps the reference's name so
        # both expositions have the same keys
        m.set("engine_compiled_forwards", len(engine._shapes), **lab)
        m.set("sched_preemptions", b.preemptions, **lab)
        m.set("sched_deadline_saves", b.deadline_saves, **lab)
        m.set("sched_cost_sample_s", b.cost.sample_s, **lab)
        m.set("sched_cost_switch_s", b.cost.switch_s, **lab)
        m.set("bank_hits", bank.hits, **lab)
        m.set("bank_misses", bank.misses, **lab)
        m.set("bank_builds", bank.builds, **lab)
        m.set("bank_build_joins", bank.build_joins, **lab)
        m.set("bank_build_failures", bank.build_failures, **lab)
        m.set("bank_prefetches", bank.prefetches, **lab)
        m.set("bank_prefetch_hits", bank.prefetch_hits, **lab)
        m.set("bank_evictions", bank.evictions, **lab)
        tr = self.tracer
        tr.counter("queue", {"pending": len(b.pending),
                             "inflight": len(b.inflight)})
        tr.counter("bank", {"hits": bank.hits, "misses": bank.misses,
                            "builds": bank.builds})

    def finalize(self, engine, collector=None) -> None:
        """Run-end sync: full ``engine.stats()`` plus the traffic
        collector's summary land in the registry, so ``to_text()`` /
        ``snapshot()`` expose every number the launcher prints."""
        if not self.enabled:
            return
        self.sample(engine)
        m = self.metrics
        lab = self._engine_labels(engine)
        for k, v in engine.stats().items():
            if isinstance(v, (int, float, bool)):
                m.set(f"engine_{k}", float(v), **lab)
        if collector is not None:
            for k, v in collector.summary().items():
                if isinstance(v, (int, float, bool)):
                    m.set(f"traffic_{k}", float(v), **lab)
        if self.kernel_profiler is not None:
            m.set("kernel_routes", len(self.kernel_profiler.route_counts()))
        m.set("trace_events", len(self.tracer.events()))
        m.set("trace_events_dropped", self.tracer.dropped)


NULL_OBS = Observability(enabled=False)

__all__ = ["Observability", "NULL_OBS", "SpanTracer", "NullTracer", "Span",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "KernelProfiler"]
