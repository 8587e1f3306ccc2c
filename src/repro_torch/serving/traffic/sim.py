"""Deterministic simulated service clock for scheduler-policy studies;
port of ``repro.serving.traffic.sim``.

Wall-clock goodput comparisons are machine-dependent (a slow CI runner
turns every deadline into a miss), so the bench's fifo-vs-slo rows and
the scheduler test suites score policies under simulated time instead:
each batched forward costs ``tick_base_s + sample_s * padded rows``
(CFG partitions bucket separately, exactly like the engine pads them)
and an idle tick costs ``tick_base_s``.

The forward's cost is charged *inside* the tick — through the engine's
``on_forward`` hook, which fires with the padded row count before
completions are stamped — so a finishing request has already paid for
its own forward; charging in ``on_tick_end`` instead would score every
completion one full tick early (deadline verdicts systematically
optimistic). The scheduler's ``CostModel`` is primed with the same
rates, so slack estimates and preemptive splits are live from tick 0
and consistent with what the clock actually charges. Attaching also
forces *synchronous* prefetch builds: simulated time does not model
build wall time, and a real background thread finishing earlier or
later on a loaded machine would otherwise flip warm/mid-build switch
penalties — and therefore selection — per machine.
"""
from __future__ import annotations


class SimClock:
    """now_fn-compatible clock advanced by the engine's own compute.

    ``build_s`` > 0 additionally charges every weight-bank segment build
    (merge + pack) through the bank's ``on_build`` seam — the cost that
    makes cold segment switches *matter* in simulated time (the fleet's
    affinity-vs-round-robin rows hinge on it). The default 0.0 keeps
    every pre-existing bench row and the obs-overhead gate's pinned
    goodput baseline bit-identical.
    """

    def __init__(self, tick_base_s: float = 0.02, sample_s: float = 0.015,
                 build_s: float = 0.0):
        self.tick_base_s = tick_base_s
        self.sample_s = sample_s
        self.build_s = build_s
        self.t = 0.0
        # forward counters are tracked per attached engine: one SimClock
        # serves every engine behind a multi-model gateway, and engine A's
        # forwards must not mask engine B's idle ticks
        self._fwd_seen: dict[int, int] = {}

    def now(self) -> float:
        return self.t

    def attach(self, engine) -> "SimClock":
        """Wire the clock into an engine built with ``now_fn=clock.now``
        (and ``max_idle_sleep=0.0`` so idle waits spin through ticks).
        Attach every engine sharing the simulation to the same instance —
        simulated time is then one global axis their ticks interleave on."""
        engine.async_prefetch = False    # thread timing must not leak in

        def charge_forward(e, padded_rows):
            self.t += self.tick_base_s + self.sample_s * padded_rows

        engine.on_forward.append(charge_forward)

        def idle_advance(e):
            if e.n_forwards == self._fwd_seen.get(id(e), 0):  # no forward
                self.t += self.tick_base_s
            self._fwd_seen[id(e)] = e.n_forwards

        engine.on_tick_end.append(idle_advance)
        if self.build_s > 0:
            def charge_build(bank, seg):
                self.t += self.build_s

            engine.bank.on_build.append(charge_build)
        engine.batcher.cost.sample_s = self.sample_s
        # prime the switch estimate with what the clock actually charges
        # per cold build (tick_base_s when builds are free, as before)
        engine.batcher.cost.switch_s = self.build_s or self.tick_base_s
        return self
