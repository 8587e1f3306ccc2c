"""Named traffic scenarios: generator + engine shaping + SLO, one handle;
port of ``repro.serving.traffic.scenarios``.

A scenario is the unit the bench and launcher iterate over — every
traffic-level perf claim ("prefetch helps under bursts") is made against
a named scenario so the number is reproducible. ``run_scenario`` is the
one runner: it attaches a metrics collector, feeds the engine (open-loop
trace submit, closed-loop live drive, or trace-file replay), runs to
drain, and returns the SLO-scored summary.

Registry (see ``SCENARIOS``):

  * ``steady``       — Poisson baseline; the launcher default.
  * ``burst``        — Markov-modulated flash crowds.
  * ``diurnal``      — compressed daily ramp (inhomogeneous Poisson).
  * ``heavy_tail``   — Pareto inter-arrivals; queue-tail stress.
  * ``closed_loop``  — N users with think time; rate adapts to service.
  * ``deadline_mix`` — tiered deadlines + priorities over Poisson; the
    goodput/expiry scenario (tight-budget requests expire under load).
  * ``tight_deadlines`` — a minority of requests carry tight budgets at
    uniform priority, so *admission* cannot save them — only deadline-
    aware group selection can. The fifo-vs-slo policy discriminator
    (largest-group-wins demonstrably misses the tight tier).
  * ``golden``       — replay of the checked-in CI fixture trace.
  * ``mixed_model``  — two gateway models interleaved 1:1 over Poisson;
    the cross-model capacity-contention scenario (run against a
    ``ServingGateway``; a plain engine serves everything itself).
  * ``per_model_slo`` — the same two-model interleave where only the
    diffusion model's requests carry deadlines: goodput is judged
    per model, not per fleet.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.common.clock import wall_clock
from repro_torch.serving.traffic.generators import (ClosedLoopGenerator,
                                              RequestMix, open_loop_trace)
from repro_torch.serving.traffic.metrics import SLO, MetricsCollector
from repro_torch.serving.traffic.trace import (TraceRequest, load_trace,
                                         submit_trace)

GOLDEN_TRACE = os.path.join("tests", "data", "golden_trace.jsonl")


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    desc: str
    kind: str                      # "open" | "closed" | "trace"
    gen: str = "poisson"           # open-loop generator name
    gen_kw: tuple = ()             # ((key, value), ...) — hashable/frozen
    n_requests: int = 8
    mix: RequestMix = RequestMix()
    n_users: int = 4               # closed-loop shape
    requests_per_user: int = 3
    think_mean_s: float = 0.2
    trace_path: str | None = None
    max_batch: int = 4             # engine shaping hint for builders
    slo: SLO = SLO()


SCENARIOS: dict[str, Scenario] = {}


def register(scn: Scenario) -> Scenario:
    SCENARIOS[scn.name] = scn
    return scn


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(known: {sorted(SCENARIOS)})")
    return SCENARIOS[name]


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


register(Scenario(
    name="steady", kind="open", gen="poisson", gen_kw=(("rate", 20.0),),
    desc="Poisson arrivals at a steady 20 req/s; the baseline row.",
    mix=RequestMix(samplers=("ddim", "plms"), steps=10, steps_jitter=2),
    slo=SLO(p95_s=120.0)))

register(Scenario(
    name="burst", kind="open", gen="bursty",
    gen_kw=(("rate_base", 4.0), ("rate_burst", 40.0),
            ("dwell_base_s", 1.0), ("dwell_burst_s", 0.25)),
    desc="Markov-modulated Poisson: 4 req/s base with 40 req/s bursts.",
    mix=RequestMix(samplers=("ddim",), steps=10, steps_jitter=2),
    slo=SLO(p95_s=120.0)))

register(Scenario(
    name="diurnal", kind="open", gen="diurnal",
    gen_kw=(("rate_min", 2.0), ("rate_max", 30.0), ("period_s", 4.0)),
    desc="Raised-cosine rate ramp 2->30 req/s (compressed diurnal cycle).",
    mix=RequestMix(samplers=("ddim", "dpm_solver2"), steps=10,
                   steps_jitter=2),
    slo=SLO(p95_s=120.0)))

register(Scenario(
    name="heavy_tail", kind="open", gen="pareto",
    gen_kw=(("rate", 15.0), ("alpha", 1.5)),
    desc="Pareto(1.5) inter-arrivals, mean 15 req/s; queue-tail stress.",
    mix=RequestMix(samplers=("ddim",), steps=10, steps_jitter=2),
    slo=SLO(p95_s=120.0)))

register(Scenario(
    name="closed_loop", kind="closed",
    desc="4 users, think-time feedback loop, 3 requests each.",
    n_users=4, requests_per_user=3, think_mean_s=0.2,
    mix=RequestMix(samplers=("ddim", "plms"), steps=10, steps_jitter=1),
    slo=SLO(p95_s=120.0, goodput_min=0.99)))

register(Scenario(
    name="deadline_mix", kind="open", gen="poisson",
    gen_kw=(("rate", 25.0),),
    desc="Tiered SLOs over Poisson: tight/loose/no deadline x priority.",
    mix=RequestMix(samplers=("ddim",), steps=10, steps_jitter=1,
                   deadline_s=(2.0, 30.0, None), priorities=(2, 1, 0)),
    slo=SLO(goodput_min=0.25)))

register(Scenario(
    name="tight_deadlines", kind="open", gen="poisson",
    gen_kw=(("rate", 50.0),),
    desc="Every 3rd request has a tight budget, all at equal priority; "
         "only deadline-aware selection meets the tight tier.",
    n_requests=12,
    mix=RequestMix(samplers=("ddim",), steps=6, steps_jitter=1,
                   deadline_s=(1.2, None, None), priorities=(0,)),
    max_batch=6, slo=SLO(goodput_min=0.9)))

register(Scenario(
    name="golden", kind="trace", trace_path=GOLDEN_TRACE,
    desc="Checked-in CI fixture trace; deterministic replay smoke.",
    max_batch=2, slo=SLO()))

# Multi-model gateway scenarios. Model names are routing keys the run's
# submission surface resolves (the gateway registry's defaults pair the
# tiny diffusion preset with the smollm smoke LM); a surface without
# routing (plain engine) ignores them and serves every request itself.
register(Scenario(
    name="mixed_model", kind="open", gen="poisson", gen_kw=(("rate", 20.0),),
    desc="Two models interleaved 1:1 over Poisson arrivals; the gateway "
         "cross-model contention baseline.",
    mix=RequestMix(samplers=("ddim",), steps=6, steps_jitter=1,
                   models=("tiny-ddim", "smollm-135m")),
    slo=SLO(p95_s=120.0)))

register(Scenario(
    name="per_model_slo", kind="open", gen="poisson",
    gen_kw=(("rate", 25.0),),
    desc="Two models 1:1 where only the diffusion requests carry "
         "deadlines — per-model goodput under cross-model contention.",
    mix=RequestMix(samplers=("ddim",), steps=6, steps_jitter=1,
                   models=("tiny-ddim", "smollm-135m"),
                   deadline_s=(1.5, None)),
    slo=SLO(goodput_min=0.25)))


def resolve_trace_path(path: str) -> str:
    """Absolute, cwd-relative, or repo-root-relative trace location."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.dirname(here)))))   # src/repro_torch/serving/traffic
    cand = os.path.join(root, path)
    return cand if os.path.exists(cand) else path


def build_trace(scn: Scenario, seed: int = 0,
                n: int | None = None) -> list[TraceRequest]:
    """Materialize an open-loop or trace-file scenario as trace requests."""
    if scn.kind == "trace":
        reqs, _ = load_trace(resolve_trace_path(scn.trace_path))
        return reqs
    if scn.kind == "open":
        return open_loop_trace(scn.gen, n or scn.n_requests, seed,
                               scn.mix, **dict(scn.gen_kw))
    raise ValueError(f"scenario {scn.name!r} is {scn.kind}; its trace is "
                     "realized by driving an engine (run_scenario)")


def run_scenario(scn: Scenario, engine, *, seed: int = 0,
                 collector: MetricsCollector | None = None) -> dict:
    """Feed the engine with the scenario's workload, run to drain, and
    return the metrics summary + SLO verdict."""
    collector = collector or MetricsCollector()
    collector.attach(engine)
    t0 = wall_clock()
    if scn.kind == "closed":
        gen = ClosedLoopGenerator(n_users=scn.n_users,
                                  requests_per_user=scn.requests_per_user,
                                  think_mean_s=scn.think_mean_s,
                                  mix=scn.mix, seed=seed)
        gen.drive(engine)
    else:
        submit_trace(engine, build_trace(scn, seed=seed))
        engine.run()
    out = collector.summary()
    out["scenario"] = scn.name
    out["wall_s"] = wall_clock() - t0
    out["slo"] = collector.evaluate(scn.slo)
    return out
