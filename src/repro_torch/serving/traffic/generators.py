"""Load generators: open-loop arrival processes + a closed-loop generator;
port of ``repro.serving.traffic.generators``.

Every generator emits the same trace schema (``trace.TraceRequest``)
deterministically from a seed, so a generated workload can be saved,
diffed, and replayed like a captured one.

Open-loop processes (arrivals independent of service times):

  * ``poisson``  — memoryless baseline, exponential inter-arrivals.
  * ``bursty``   — Markov-modulated Poisson: two rate states (base /
    burst) with exponential dwell times; models flash crowds.
  * ``diurnal``  — inhomogeneous Poisson with a raised-cosine rate curve
    between ``rate_min`` and ``rate_max`` (thinning simulation); models
    the daily ramp, compressed to a test-friendly period.
  * ``pareto``   — heavy-tail (Pareto) inter-arrivals with the same mean
    rate; stresses queue tails a Poisson trace never exercises.

The closed-loop generator models N users who each *wait for their result
and think* before issuing the next request — arrival rate adapts to
service rate, which is the feedback an open-loop replay cannot express.
It drives a live engine through its completion callbacks and returns the
realized trace (with ``user``/``parent``/``think_s`` links) for capture.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.traffic.trace import TraceRequest


@dataclasses.dataclass(frozen=True)
class RequestMix:
    """Deterministic per-index request shaping shared by all generators.

    Field cycles are indexed by the request number (for closed-loop:
    ``user * requests_per_user + k``), never by an RNG, so the schema
    side of a trace is identical across runs even when arrival times are
    wall-clock (closed-loop under a real clock).
    """

    samplers: tuple = ("ddim",)
    steps: int = 10
    steps_jitter: int = 2           # request i runs steps + i % (jitter+1)
    eta: float = 0.0
    seed0: int = 0                  # request i samples with seed0 + i
    deadline_s: tuple = (None,)     # latency budgets (s), cycled; None = no SLO
    priorities: tuple = (0,)        # cycled
    models: tuple = (None,)         # gateway routing targets, cycled;
    #                                 None = the surface's default model.
    #                                 Align the cycle length with
    #                                 deadline_s to express per-model SLOs
    #                                 (e.g. models=(a, b) with
    #                                 deadline_s=(1.5, None) gives model a
    #                                 a deadline and b none).

    def make(self, i: int, arrival: float, *, user: int | None = None,
             parent: int | None = None,
             think_s: float | None = None) -> TraceRequest:
        budget = self.deadline_s[i % len(self.deadline_s)]
        return TraceRequest(
            arrival=float(arrival),
            steps=self.steps + i % (self.steps_jitter + 1),
            eta=self.eta, seed=self.seed0 + i,
            sampler=self.samplers[i % len(self.samplers)],
            deadline=None if budget is None else float(arrival) + budget,
            priority=self.priorities[i % len(self.priorities)],
            model=self.models[i % len(self.models)],
            user=user, parent=parent, think_s=think_s)


# ---------------------------------------------------------------------------
# Open-loop arrival processes (cumulative times, seconds from trace start).
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, rng, *, rate: float = 20.0) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), size=n))


def pareto_arrivals(n: int, rng, *, rate: float = 20.0,
                    alpha: float = 1.5) -> np.ndarray:
    """Pareto(alpha) inter-arrivals scaled to mean 1/rate (alpha > 1)."""
    assert alpha > 1.0, "alpha <= 1 has infinite mean inter-arrival"
    scale = (alpha - 1.0) / (alpha * max(rate, 1e-9))
    return np.cumsum((rng.pareto(alpha, size=n) + 1.0) * scale)


def bursty_arrivals(n: int, rng, *, rate_base: float = 4.0,
                    rate_burst: float = 40.0, dwell_base_s: float = 1.0,
                    dwell_burst_s: float = 0.25) -> np.ndarray:
    """Two-state Markov-modulated Poisson process (exact simulation:
    next event is min(arrival at the current rate, state switch))."""
    rates = (max(rate_base, 1e-9), max(rate_burst, 1e-9))
    dwells = (max(dwell_base_s, 1e-9), max(dwell_burst_s, 1e-9))
    t, state = 0.0, 0
    next_switch = rng.exponential(dwells[state])
    out: list[float] = []
    while len(out) < n:
        ia = rng.exponential(1.0 / rates[state])
        if t + ia < next_switch:
            t += ia
            out.append(t)
        else:
            t = next_switch
            state = 1 - state
            next_switch = t + rng.exponential(dwells[state])
    return np.asarray(out)


def diurnal_arrivals(n: int, rng, *, rate_min: float = 2.0,
                     rate_max: float = 30.0,
                     period_s: float = 4.0) -> np.ndarray:
    """Raised-cosine rate curve simulated by thinning at rate_max."""
    assert rate_max >= rate_min > 0
    t = 0.0
    out: list[float] = []
    while len(out) < n:
        t += rng.exponential(1.0 / rate_max)
        lam = rate_min + (rate_max - rate_min) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * t / period_s))
        if rng.uniform() * rate_max <= lam:
            out.append(t)
    return np.asarray(out)


OPEN_LOOP = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
             "diurnal": diurnal_arrivals, "pareto": pareto_arrivals}


def open_loop_trace(kind: str, n: int, seed: int,
                    mix: RequestMix = RequestMix(),
                    **gen_kw) -> list[TraceRequest]:
    """n requests from a named arrival process, deterministic in seed."""
    if kind not in OPEN_LOOP:
        raise KeyError(f"unknown generator {kind!r} "
                       f"(known: {sorted(OPEN_LOOP)})")
    rng = np.random.default_rng(seed)
    arrivals = OPEN_LOOP[kind](n, rng, **gen_kw)
    return [dataclasses.replace(mix.make(i, t), rid=i)
            for i, t in enumerate(arrivals)]


# ---------------------------------------------------------------------------
# Closed loop: N users, think time, next request sent on completion.
# ---------------------------------------------------------------------------


class ClosedLoopGenerator:
    """Drives a live engine: each user submits, waits, thinks, resubmits.

    Think times come from one RNG stream per user (seeded ``[seed, u]``),
    so the think schedule — and under a virtual clock the whole run — is
    deterministic; request shaping is index-cycled via ``mix`` and never
    depends on completion interleaving. Expired requests also count as a
    completed turn (the user saw a failure and thinks before retrying),
    so each user stops after ``requests_per_user`` turns.
    """

    def __init__(self, n_users: int = 4, requests_per_user: int = 3,
                 think_mean_s: float = 0.2,
                 mix: RequestMix = RequestMix(), seed: int = 0):
        assert n_users >= 1 and requests_per_user >= 1
        self.n_users = n_users
        self.requests_per_user = requests_per_user
        self.think_mean_s = think_mean_s
        self.mix = mix
        self.seed = seed

    def drive(self, engine) -> list[TraceRequest]:
        rngs = [np.random.default_rng([self.seed, u])
                for u in range(self.n_users)]
        counts = [0] * self.n_users
        rid_user: dict[int, int] = {}
        sent: list[TraceRequest] = []

        routes = getattr(engine, "routes_models", False)

        def send(user: int, arrival: float, parent: int | None = None,
                 think_s: float | None = None) -> None:
            k = counts[user]
            counts[user] += 1
            tr = self.mix.make(user * self.requests_per_user + k, arrival,
                               user=user, parent=parent, think_s=think_s)
            kw = {"model": tr.model} if routes else {}
            rid = engine.submit(steps=tr.steps, eta=tr.eta, seed=tr.seed,
                                sampler=tr.sampler, y=tr.y,
                                guidance_scale=tr.guidance_scale,
                                arrival=tr.arrival, deadline=tr.deadline,
                                priority=tr.priority, user=user,
                                parent=parent, think_s=think_s, **kw)
            rid_user[rid] = user
            sent.append(dataclasses.replace(tr, rid=rid))

        def on_done(rs) -> None:
            # a gateway annotates rs.gid (its surface-level rid — what
            # submit() returned); plain engines complete with req.rid
            rid = getattr(rs, "gid", rs.req.rid)
            user = rid_user.get(rid)
            if user is None or counts[user] >= self.requests_per_user:
                return
            think = float(rngs[user].exponential(self.think_mean_s))
            send(user, float(rs.finished_at) + think,
                  parent=rid, think_s=think)

        engine.on_complete.append(on_done)
        engine.on_expire.append(on_done)
        for u in range(self.n_users):
            send(u, float(rngs[u].exponential(self.think_mean_s)))
        engine.run()
        return sorted(sent, key=lambda tr: (tr.arrival, tr.rid))
