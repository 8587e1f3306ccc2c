"""Replay a trace through an engine and keep what two replays of it must
share: the per-tick (segment, member rids) decisions, the initial latents,
the per-request outcomes and the weight bank's counters.

Under a ``VirtualClock`` none of these depends on numerics (routing
signatures are computed on the host, and virtual time never moves during
compute), so two replays of one trace from the same params, router, hubs
and seeds (one on the card and one on the CPU, or one with obs on and
one with it off) must agree on all of them exactly; only the final
latents ``x0`` may differ, within the forward's tolerance.

``x0 - eps_free_x0`` is the model's part of a final latent: the sampler's
output from the same ``x_T`` with every eps set to 0 depends on the
schedule alone, and the model's eps reach ``x0`` only through the
sampler's coefficients. ``x0_error`` measures a replay's ``x0`` against
another's relative to that part, which is what a forward's error moves
(the ``x_T`` part of ``x0`` can be far larger). ``dyadic_unet_weights``
gives a UNet power-of-two weight scales, on which every W4A4 product sums
exactly in any order, so what is left between two devices is the torch
ops between the kernels.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.diffusion.samplers import sampler_advance, sampler_init
from repro_torch.serving.traffic.trace import TraceRequest, submit_trace

BANK_COUNTERS = ("hits", "misses", "builds", "prefetches", "evictions")


def record_ticks(engine) -> list[tuple[int, tuple[int, ...]]]:
    """Log each tick's (segment, rids of its eval items) as it runs."""
    log = []
    run = engine._run_partitions

    def wrapped(params, items):
        log.append((engine.batcher.current_seg,
                    tuple(it[0].req.rid for it in items)))
        return run(params, items)
    engine._run_partitions = wrapped
    return log


def replay(engine, reqs: list[TraceRequest]) -> dict:
    """Submit ``reqs``, run the engine to drain, and return the tick log,
    each request's x_T and x0 (on the CPU), outcomes (n_evals, expired)
    and the bank counters."""
    ticks = record_ticks(engine)
    x_T = {}
    engine.on_submit.append(lambda rs: x_T.__setitem__(
        rs.req.rid, rs.state.x.detach().to("cpu", copy=True)))
    submit_trace(engine, reqs)
    results = engine.run()
    return {"ticks": ticks, "x_T": x_T,
            "outcomes": {rid: (rs.n_evals, rs.expired)
                         for rid, rs in results.items()},
            "x0": {rid: rs.x0.detach().cpu() for rid, rs in results.items()
                   if rs.x0 is not None},
            "bank": {k: getattr(engine.bank, k) for k in BANK_COUNTERS}}


def replay_mismatches(a: dict, b: dict) -> list[str]:
    """What two replays of one trace disagree on, apart from x0."""
    out = []
    if a["ticks"] != b["ticks"]:
        out.append(f"tick log {a['ticks']} != {b['ticks']}")
    if a["outcomes"] != b["outcomes"]:
        out.append(f"outcomes {a['outcomes']} != {b['outcomes']}")
    if a["bank"] != b["bank"]:
        out.append(f"bank counters {a['bank']} != {b['bank']}")
    if sorted(a["x_T"]) != sorted(b["x_T"]) or not all(
            torch.equal(a["x_T"][r], b["x_T"][r]) for r in a["x_T"]):
        out.append("initial latents x_T differ")
    return out


def eps_free_x0(reqs: list[TraceRequest], sched, shape) -> dict:
    """Each request's x0 with every eps 0 (on the CPU, from its seeded
    x_T): the schedule's part of the final latent."""
    out = {}
    for tr in reqs:
        st = sampler_init(tr.sampler, sched, shape, seed=tr.seed,
                          steps=tr.steps, eta=tr.eta)
        while not st.done:
            sampler_advance(st, torch.zeros_like(st.eval_x))
        out[tr.rid] = st.x
    return out


def x0_error(got: dict, want: dict, base: dict) -> dict:
    """``got`` against ``want`` (rid -> x0), relative to the model's part
    ``want - base``: the relative Frobenius error, and the share of
    elements off by more than 1e-4 of the part's largest magnitude or 4
    f32 ulps of the element, whichever is larger (the x_T part sets the
    resolution at which x0 is stored, and one rounding of the sampler's
    arithmetic moves an element by an ulp whatever the model did)."""
    rids = sorted(want)
    g = np.stack([got[r].double().numpy() for r in rids])
    w32 = np.stack([want[r].float().numpy() for r in rids])
    w = w32.astype(np.float64)
    m = w - np.stack([base[r].double().numpy() for r in rids])
    err = np.abs(g - w)
    atol = np.maximum(1e-4 * float(np.abs(m).max()),
                      4 * np.spacing(np.abs(w32)).astype(np.float64))
    return {"rel_frobenius": float(np.linalg.norm(g - w)
                                   / max(np.linalg.norm(m), 1e-30)),
            "frac_off": float(np.mean(err > atol)),
            "max_abs_err": float(err.max()),
            "model_part_rms": float(np.sqrt(np.mean(m ** 2))),
            "x0_rms": float(np.sqrt(np.mean(w ** 2)))}


def dyadic_unet_weights(params: dict, weights: dict) -> dict:
    """``params`` with each weight of ``weights`` (by path) rescaled by a
    factor in [0.7, 1.42) to the absmax 0.75 * 2^j nearest its own, its
    largest entry set to exactly that: packed per tensor, every grid scale
    is then a power of two, every decoded weight and E2M1 act (at maxval
    6) a short dyadic number, and every W4A4 product sums exactly in f32 in
    any order (the diffusion counterpart of steps.dyadic_weights); each
    layer keeps its magnitude, so the forward keeps its dynamics."""
    flat = flatten_paths(params)
    for path in weights:
        w = flat[path]
        top = float(w.abs().max())
        target = 0.75 * 2.0 ** round(math.log2(top / 0.75))
        w = w / top * target
        i = int(w.abs().argmax())
        w.view(-1)[i] = target if float(w.view(-1)[i]) > 0 else -target
        flat[path] = w
    return unflatten_paths(flat)
