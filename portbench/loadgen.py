"""The general traffic generator: one reader of every ``traffic/*.json``.

A traffic file names its arrival ``process`` and the request mix:

* ``backlog``: ``backlog`` requests all due at t = 0 (an offline job's
  queue, deeper than a window drains);
* ``poisson``: open-loop arrivals at ``rate`` per second. Exactly
  ``round(rate * seconds)`` of them fall in the window (a Poisson process
  conditioned on its count, so every seed offers the window the same
  load), and the process runs on past the window's end at the same rate.

With ``trace_seed`` the arrivals and the order of the mix come from that
seed and not the run's: every run replays the same trace, and the run's
seed draws only the weights and each request's x_T.

The mix (``samplers``, ``steps``, ``steps_jitter``, ``eta``) shapes
request i as ``steps + i % (steps_jitter + 1)`` steps of
``samplers[i % len(samplers)]``; a window's requests take the mix's first
N shapes in an order drawn from the seed, so every seed sends the same
sizes. ``max_batch`` is the engine's in-flight cap for the traffic. A
``source`` key, where there is one, names the public setting that the
mix copies; the generator does not read it.

``poisson_arrivals`` and ``percentile`` are frozen copies of the port's
``serving/traffic/generators.py:poisson_arrivals`` and
``serving/traffic/metrics.py:percentile``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def poisson_arrivals(n: int, rng, *, rate: float = 20.0) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), size=n))


def percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            int(round(p / 100 * (len(sorted_vals) - 1))))
    return sorted_vals[max(k, 0)]


@dataclasses.dataclass(frozen=True)
class Request:
    index: int          # the request's seed and the row of its x_T
    due: float          # seconds from the window's start
    sampler: str
    steps: int
    eta: float
    in_window: bool


def shape_of(traffic: dict, i: int) -> tuple[str, int]:
    samplers = traffic["samplers"]
    return (samplers[i % len(samplers)],
            traffic["steps"] + i % (traffic["steps_jitter"] + 1))


def generate(traffic: dict, seed: int, seconds: float,
             tail_seconds: float = 0.0) -> list[Request]:
    """Every request of a run, by due time: the window's, then (for an
    open process) ``tail_seconds`` more of arrivals after it."""
    rng = np.random.default_rng(traffic.get("trace_seed", seed))
    eta = float(traffic.get("eta", 0.0))
    if traffic["process"] == "backlog":
        return [Request(i, 0.0, *shape_of(traffic, i), eta, True)
                for i in range(traffic["backlog"])]
    if traffic["process"] != "poisson":
        raise ValueError(f"unknown arrival process {traffic['process']!r}")
    rate = float(traffic["rate"])
    n = int(round(rate * seconds))
    s = poisson_arrivals(n + 1, rng, rate=rate)
    due = s[:n] * (seconds / s[n])
    order = rng.permutation(n)
    reqs = [Request(i, float(due[i]), *shape_of(traffic, int(order[i])),
                    eta, True) for i in range(n)]
    n_tail = int(np.ceil(rate * tail_seconds))
    tail = seconds + poisson_arrivals(n_tail, rng, rate=rate)
    reqs += [Request(n + k, float(tail[k]), *shape_of(traffic, n + k), eta,
                     False) for k in range(n_tail)]
    return reqs


def buckets(traffic: dict) -> list[int]:
    """The power-of-two batch buckets the engine runs under this traffic:
    a backlog keeps every slot full, so only the top one."""
    top = 1
    while top < traffic["max_batch"]:
        top *= 2
    if traffic["process"] == "backlog":
        return [top]
    out, b = [], 1
    while b <= top:
        out.append(b)
        b *= 2
    return out
