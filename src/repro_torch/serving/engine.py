"""Diffusion serving engine: continuous-batched denoising on packed W4A4;
port of ``repro.serving.engine``.

One engine *tick*:

  1. admit arrived requests into free in-flight slots (priority desc,
     then FIFO; due requests past their deadline are expired instead —
     see ``scheduler.ContinuousBatcher.admit``),
  2. group in-flight requests by the weight-bank segment of the timestep
     each sampler needs next, pick one group (scheduler policy),
  3. fetch that segment's pre-merged, pre-packed weights from the bank
     (LRU — the common case is a hit, since consecutive sampler steps
     stay inside a routing segment),
  4. run ONE batched model forward per class-conditioning partition
     (per-sample ``t``; CFG-guided requests contribute a cond + uncond
     pair and are recombined as ``eps_u + s * (eps_c - eps_u)``) — batches
     pad to power-of-two buckets (outputs masked by slicing), so the
     kernels see a handful of shapes under churny in-flight counts,
  5. advance each request's sampler state; retire finished requests.

The forward runs under a *serve-mode* ``QuantContext`` — activation
quantization happens inside the fused W4A4 kernel for packed dense sites
and there is no fake-quant anywhere on this path; weights are real packed
uint8 nibbles end-to-end (``kernels/ops`` dispatch: the CUDA kernels on
the card). Each tick's forwards end in a device synchronise, so the engine
clock (and the scheduler's cost model) sees device time, not enqueue time.

The engine exposes callback hooks for the traffic subsystem
(``serving/traffic``): ``on_submit`` (trace capture), ``on_complete`` /
``on_expire`` (closed-loop generators, SLO metrics), ``on_tick_end``
(queue-depth / cache time series). After each tick it prefetches the
weight-bank segments that in-flight samplers will need next, so a
segment boundary crossing finds its merged+packed weights already built
(``stats()['prefetch_hits']``). Under a wall clock the prefetch is
*asynchronous* — the bank's background thread merges/packs the next
segment while the current segment's forwards run; under a
``VirtualClock`` it stays synchronous so replay digests are
deterministic.

``policy="slo"`` switches group selection from largest-group-wins to the
slack-aware scheduler (EDF pressure weighted against segment-switch
cost, with group-splitting preemption — see ``scheduler``); the engine
feeds the scheduler's ``CostModel`` with observed forward and
segment-build durations measured on the engine clock.

Observability (``serving/obs``): request spans, the tick's spans and
per-tick registry samples, each behind an ``obs.enabled`` branch; the
default ``NULL_OBS`` skips them all (no span, no profiler range), an
``Observability`` bundle records them in its buffer on the engine's own
clock (so a ``VirtualClock`` replay traces deterministically, and
outcomes are the same with obs on or off). A busy tick's span ``tick``
holds its phases in this order, each a child span:

  * ``admit`` — ``batcher.admit`` and the expiries (an idle tick has only
    this one);
  * ``group`` — ``batcher.groups`` and ``select``;
  * ``bank_fetch`` (cat ``bank``) — the segment's weights;
  * ``forward`` — holding ``stage`` (the eval items, the batch's
    ``torch.cat``, the timestep and label tensors, the padding) and
    ``launch`` (the host's enqueue of one UNet forward) for each
    partition, then ``sync`` (the device synchronise; zero length on the
    CPU);
  * ``advance`` — the CFG combine, ``sampler_advance``, retire and
    ``on_complete`` of every member;
  * ``prefetch`` — the bank prefetches for the members' next segments.

Each span is also a profiler range named ``<cat>.<name>`` on the
profiler's clock (``serving/obs/tracer``), so under ``torch.profiler``
the card's idle gaps can be put down to the phase the host was in.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.common.device import resolve_device
from repro_torch.diffusion.samplers import (sampler_advance, sampler_init,
                                            sampler_needed_t)
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.nn.unet import UNetConfig, unet_apply
from repro_torch.quant.calibrate import QuantContext
from repro_torch.serving.obs import NULL_OBS
from repro_torch.serving.scheduler import (ContinuousBatcher, GenRequest,
                                           RequestState, bucket_of)
from repro_torch.serving.traffic.metrics import percentile
from repro_torch.serving.weight_bank import WeightBank

# role of one eval item in its request: plain, or half of a CFG pair
_PLAIN, _UNCOND, _COND = 0, 1, 2


class VirtualClock:
    """Deterministic replay clock: time only moves when the idle run loop
    advances it to the next arrival, never during compute. Trace replay
    under a virtual clock admits/batches identically across runs and
    machines (the CI determinism check), at the cost of wall-latency
    metrics — latencies read ~0 and deadlines never expire, so use the
    default wall clock when measuring SLOs."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, t)


class DiffusionServingEngine:
    """Owns the denoising loop for many concurrent generation requests."""

    def __init__(self, cfg: UNetConfig, sched: NoiseSchedule,
                 bank: WeightBank, *,
                 act_qps: dict | None = None,
                 apply_fn: Callable | None = None,
                 max_batch: int = 8, starvation_ticks: int = 4,
                 policy: str = "fifo",
                 now_fn: Callable[[], float] | None = None,
                 clock: VirtualClock | None = None,
                 max_idle_sleep: float = 0.25,
                 prefetch: bool = True,
                 async_prefetch: bool = True,
                 obs=None,
                 model: str | None = None,
                 device="cuda",
                 noise_fn: Callable[[GenRequest], torch.Tensor] | None = None):
        # device: where latents live and forwards run (the card unless the
        # caller asks for the CPU); noise_fn: optional x_T per request
        # (parity tests inject the reference's draw), default the
        # sampler's own seeded draw
        self.device = resolve_device(device)
        self.noise_fn = noise_fn
        # model: identity label when hosted behind the multi-model gateway
        # (obs gauges/spans carry it; None keeps single-model output
        # byte-identical to the pre-gateway format)
        self.model = model
        # replica: identity label when hosted as a fleet replica (the
        # FleetRouter sets it after construction); obs gauges gain a
        # {replica=...} label and spans land on a per-replica track
        self.replica: str | None = None
        self.cfg = cfg
        self.sched = sched
        self.bank = bank
        self.ctx = QuantContext("serve", act_qps=act_qps or {})
        self._apply = apply_fn or (
            lambda params, x, tb, y, ctx: unet_apply(params, x, tb, cfg,
                                                     y=y, ctx=ctx))
        self.batcher = ContinuousBatcher(max_batch, starvation_ticks,
                                         policy=policy)
        self.batcher.segment_warm = bank.is_cached
        self.batcher.segment_building = bank.is_building
        if clock is not None:
            self._now = clock.now
            self._advance = clock.advance_to
        else:
            t0 = time.monotonic()
            self._now = now_fn or (lambda: time.monotonic() - t0)
            self._advance = None
        self.max_idle_sleep = max_idle_sleep
        self.prefetch_enabled = prefetch
        # background builds only make sense when real time passes during
        # compute; a VirtualClock replay must build synchronously so the
        # golden-trace digest stays deterministic.
        self.async_prefetch = async_prefetch and self._advance is None
        # observability: the tracer follows the *engine's* clock (so a
        # VirtualClock replay traces deterministically) and propagates to
        # the scheduler and bank so their spans land in the same buffer.
        self.obs = obs or NULL_OBS
        if self.obs.enabled:
            self.obs.bind_engine(self)
            self.batcher.obs = self.obs
            if self.bank.obs is NULL_OBS:
                self.bank.obs = self.obs
            self._h_forward = self.obs.metrics.histogram(
                "engine_forward_seconds",
                help="engine-clock batched-forward durations (the same "
                     "observations the scheduler cost EWMA consumes)")
            self._h_fetch = self.obs.metrics.histogram(
                "bank_fetch_seconds",
                help="engine-clock stalls fetching the tick's segment")
        self._shapes: set[tuple] = set()     # (bucket, has_y) run so far
        self._phase_span = None              # see _next_phase
        self._last_padded_rows = 0
        self._next_rid = 0
        self.tick_count = 0
        self.n_forwards = 0
        self.n_samples_batched = 0
        self.n_padded_samples = 0
        self.n_idle_sleeps = 0
        self.n_finished = 0
        self.n_expired = 0
        self._latencies: list[float] = []    # scalars only; never evicted
        self.results: dict[int, RequestState] = {}
        # traffic-subsystem hooks; each receives the RequestState (or the
        # engine itself for on_tick_end)
        self.on_submit: list[Callable] = []
        self.on_complete: list[Callable] = []
        self.on_expire: list[Callable] = []
        self.on_tick_end: list[Callable] = []
        # (engine, padded_rows) once per tick's batched forwards — the
        # seam simulated service clocks charge compute through
        self.on_forward: list[Callable] = []

    def now(self) -> float:
        return self._now()

    # -- request lifecycle -------------------------------------------------

    def submit(self, *, steps: int = 20, eta: float = 0.0, seed: int = 0,
               sampler: str = "ddim", y: int | None = None,
               guidance_scale: float = 0.0, arrival: float = 0.0,
               deadline: float | None = None, priority: int = 0,
               user: int | None = None, parent: int | None = None,
               think_s: float | None = None) -> int:
        if guidance_scale > 0 and (y is None or not self.cfg.num_classes):
            raise ValueError("guidance needs a class label y and a "
                             "class-conditional model")
        rid = self._next_rid
        self._next_rid += 1
        req = GenRequest(rid, steps, eta, seed, sampler, y, guidance_scale,
                         arrival, deadline, priority, user, parent, think_s)
        shape = (1, self.cfg.image_size, self.cfg.image_size, self.cfg.in_ch)
        x_T = self.noise_fn(req) if self.noise_fn is not None else None
        state = sampler_init(sampler, self.sched, shape, seed=seed,
                             steps=steps, eta=eta, x_T=x_T,
                             device=self.device)
        rs = RequestState(req, state, submitted_at=self._now())
        self.batcher.submit(rs)
        if self.obs.enabled:
            self.obs.tracer.set_track(self.replica or self.model)
            self.obs.tracer.async_begin(
                "request", rid, cat="request",
                args={"steps": steps, "sampler": sampler,
                      "arrival": arrival, "deadline": deadline,
                      "priority": priority,
                      "cfg": guidance_scale > 0})
        for cb in self.on_submit:
            cb(rs)
        return rid

    # -- one engine tick ---------------------------------------------------

    def tick(self) -> list[RequestState]:
        obs = self.obs
        tick_span = phase = None
        if obs.enabled:
            obs.tracer.set_track(self.replica or self.model)
            tick_span = obs.tracer.begin(
                "tick", cat="engine", args={"tick": self.tick_count})
            phase = obs.tracer.begin("admit", cat="engine")
        now = self._now()
        admitted, expired = self.batcher.admit(now, self.tick_count)
        if obs.enabled:
            for rs in admitted:
                obs.tracer.async_instant("admit", rs.req.rid, cat="request")
        for rs in expired:
            rs.finished_at = now
            self.results[rs.req.rid] = rs
            self.n_expired += 1
            if obs.enabled:
                obs.tracer.async_end("request", rs.req.rid, cat="request",
                                     args={"outcome": "expired"})
            for cb in self.on_expire:
                cb(rs)
        if obs.enabled:
            obs.tracer.end(phase)
        if not self.batcher.inflight:
            if obs.enabled:
                tick_span.args["idle"] = True
                obs.tracer.end(tick_span)
                obs.sample(self)
            for cb in self.on_tick_end:
                cb(self)
            return []
        if obs.enabled:
            phase = obs.tracer.begin("group", cat="engine")
        groups = self.batcher.groups(
            lambda rs: self.bank.segment_of(sampler_needed_t(rs.state)))
        seg, members = self.batcher.select(groups, self.tick_count, now=now)
        self.batcher.current_seg = seg
        fetch_span = None
        if obs.enabled:
            obs.tracer.end(phase)
            tick_span.args.update(
                {"seg": seg, "members": [rs.req.rid for rs in members],
                 "n_groups": len(groups), "policy": self.batcher.policy})
            fetch_span = obs.tracer.begin("bank_fetch", cat="bank",
                                          args={"seg": seg})
        t_fetch = self._now()
        misses_before = self.bank.misses
        joins_before = self.bank.build_joins
        params = self.bank.params_for_segment(seg)
        if self.bank.misses > misses_before:
            # cold fetch: the observed stall is the segment-switch cost
            self.batcher.cost.observe_switch(self._now() - t_fetch)
        elif self.bank.build_joins > joins_before:
            # joined an async build mid-way: with prefetch on this is the
            # common cold path (prefetch registers the build before the
            # fetch, so `misses` never moves) — without it the switch
            # EWMA would stay pinned to the first cold build forever.
            # The stall is the remaining ~half of a build on average.
            self.batcher.cost.observe_switch(2 * (self._now() - t_fetch))
        if obs.enabled:
            fetch_span.args["outcome"] = (
                "miss" if self.bank.misses > misses_before
                else "join" if self.bank.build_joins > joins_before
                else "hit")
            obs.tracer.end(fetch_span)
            self._h_fetch.observe(self._now() - t_fetch)

        fwd_span = None
        if obs.enabled:
            fwd_span = obs.tracer.begin("forward", cat="engine")
            self._phase_span = obs.tracer.begin("stage", cat="engine")
        # build eval items: (rs, role, t, x (1,H,W,C), y)
        items = []
        for rs in members:
            t = sampler_needed_t(rs.state)
            x = rs.state.eval_x
            if rs.req.guidance_scale > 0:
                items.append((rs, _UNCOND, t, x, None))
                items.append((rs, _COND, t, x, rs.req.y))
            else:
                items.append((rs, _PLAIN, t, x, rs.req.y))

        t_compute = self._now()
        n_shapes_before = len(self._shapes)
        eps_by_item = self._run_partitions(params, items)
        compiled = len(self._shapes) > n_shapes_before
        if not compiled:
            # skip ticks that ran a new (bucket, has_y) shape: its first
            # forward pays one-off costs (the kernels' build and load on
            # first launch); seeding the EWMA with them would poison slack
            # estimates for many subsequent ticks
            self.batcher.cost.observe_eval(self._now() - t_compute,
                                           self._last_padded_rows)
        if obs.enabled:
            dt = self._now() - t_compute
            fwd_span.args.update({"items": len(items),
                                  "padded_rows": self._last_padded_rows,
                                  "compiled": compiled})
            obs.tracer.end(fwd_span)
            # the same engine-clock observation the cost EWMA consumed
            if not compiled:
                self._h_forward.observe(dt)
            phase = obs.tracer.begin("advance", cat="engine")

        finished = []
        tick = self.tick_count
        for rs in members:
            parts = eps_by_item[id(rs)]
            if _PLAIN in parts:
                eps = parts[_PLAIN]
            else:
                s = rs.req.guidance_scale
                eps = parts[_UNCOND] + s * (parts[_COND] - parts[_UNCOND])
            sampler_advance(rs.state, eps)
            rs.last_advance_tick = tick
            rs.n_evals += 1
            if obs.enabled:
                obs.tracer.async_instant("eval", rs.req.rid, cat="request",
                                         args={"n_evals": rs.n_evals})
            if rs.state.done:
                rs.x0 = rs.state.x
                rs.finished_at = self._now()
                self.batcher.retire(rs)
                self.results[rs.req.rid] = rs
                self.n_finished += 1
                self._latencies.append(rs.latency)
                finished.append(rs)
                if obs.enabled:
                    obs.tracer.async_end(
                        "request", rs.req.rid, cat="request",
                        args={"outcome": "complete",
                              "n_evals": rs.n_evals,
                              "latency_s": rs.latency})
                for cb in self.on_complete:
                    cb(rs)
        self.tick_count += 1
        if obs.enabled:
            obs.tracer.end(phase)
        if self.prefetch_enabled:
            if obs.enabled:
                phase = obs.tracer.begin("prefetch", cat="engine")
            # Requests that just advanced may cross into a new routing
            # segment next step — build/pack it before it is asked for.
            # Async mode hands the build to the bank's background thread
            # so the next segment merges/packs while this segment's
            # forwards keep running; a later fetch joins the in-progress
            # build instead of rebuilding.
            for s in {self.bank.segment_of(sampler_needed_t(rs.state))
                      for rs in members if not rs.state.done}:
                self.bank.prefetch(s, block=not self.async_prefetch)
            if obs.enabled:
                obs.tracer.end(phase)
        if obs.enabled:
            tick_span.args["finished"] = len(finished)
            obs.tracer.end(tick_span)
            obs.sample(self)
        for cb in self.on_tick_end:
            cb(self)
        return finished

    def _run_partitions(self, params, items) -> dict[int, dict]:
        """One batched forward per class-conditioning partition.

        ``unet_apply`` takes a single optional ``y`` array, so items with
        and without a label cannot share a forward; each partition still
        batches arbitrary timesteps (``t`` is per-sample).
        """
        traced = self.obs.enabled
        eps_by_item: dict[int, dict] = {}
        padded_rows = 0
        for has_y in (False, True):
            part = [it for it in items if (it[4] is not None) == has_y]
            if not part:
                continue
            if traced and self._phase_span is None:
                self._next_phase("stage")       # a second partition's
            x = torch.cat([it[3] for it in part], dim=0)
            tb = torch.tensor([it[2] for it in part], dtype=torch.float32,
                              device=self.device)
            y = (torch.tensor([it[4] for it in part], dtype=torch.int64,
                              device=self.device) if has_y else None)
            eps = self._forward(params, x, tb, y)
            if traced:
                self._next_phase(None)
            self.n_forwards += 1
            self.n_samples_batched += len(part)
            padded_rows += self._bucket(len(part))
            for j, (rs, role, *_rest) in enumerate(part):
                eps_by_item.setdefault(id(rs), {})[role] = eps[j:j + 1]
        if traced:
            self._next_phase("sync")            # zero length on the CPU
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if traced:
            self._next_phase(None)
        self._last_padded_rows = padded_rows
        for cb in self.on_forward:
            cb(self, padded_rows)
        return eps_by_item

    # Partition batches pad to power-of-two buckets so churny in-flight
    # counts reuse a handful of forward shapes instead of one per distinct
    # batch size; the scheduler's cost model shares the same bucket
    # function so slack estimates price the padding.
    _bucket = staticmethod(bucket_of)

    def _forward(self, params, x, tb, y):
        n = x.shape[0]
        b = self._bucket(n)
        if b != n:
            # Pad with copies of row 0 (always finite through norms) and
            # mask by slicing the padded outputs away below.
            pad = b - n
            x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])], dim=0)
            tb = torch.cat([tb, tb[:1].expand(pad)], dim=0)
            if y is not None:
                y = torch.cat([y, y[:1].expand(pad)], dim=0)
            self.n_padded_samples += pad
        self._shapes.add((b, y is not None))
        if self.obs.enabled:
            self._next_phase("launch")
        with torch.inference_mode():
            eps = self._apply(params, x, tb, y, self.ctx)
        return eps[:n]

    def _next_phase(self, name: str | None) -> None:
        """With obs on: end the forward's open phase span (``stage``,
        ``launch`` or ``sync``) and begin ``name`` in its place (``None``:
        none). The phases cross ``_forward``, which the benchmark and the
        chip checks wrap, so the open one is kept here."""
        tracer = self.obs.tracer
        if self._phase_span is not None:
            tracer.end(self._phase_span)
        self._phase_span = (tracer.begin(name, cat="engine")
                            if name is not None else None)

    def pop_result(self, rid: int) -> RequestState:
        """Hand a finished request to its caller and release the engine's
        reference (a long-lived engine must not retain every generated
        latent; latency scalars stay for ``stats``)."""
        return self.results.pop(rid)

    # -- run loop ----------------------------------------------------------

    def run(self, *, max_idle_sleep: float | None = None
            ) -> dict[int, RequestState]:
        """Tick until every submitted request has finished or expired.

        While idle (nothing in flight, next arrival in the future) the
        loop sleeps until that arrival in one shot — capped at
        ``max_idle_sleep`` (engine default unless overridden here) as a
        clock-skew guard — instead of spinning a millisecond poll loop.

        Under a ``VirtualClock`` the loop instead advances the clock to
        the next arrival whenever an in-flight slot is free — arrival
        gaps are treated as instantaneous relative to service, so replay
        batches greedily and deterministically. The trace's arrival
        *order* and priorities still apply, but deadlines can never
        expire (virtual time never passes a pending request's own
        arrival) — score SLOs under the wall clock.
        """
        cap = self.max_idle_sleep if max_idle_sleep is None else max_idle_sleep
        while self.batcher.pending or self.batcher.inflight:
            if (self._advance is not None and self.batcher.pending
                    and len(self.batcher.inflight) < self.batcher.max_batch):
                nxt = self.batcher.next_arrival()
                if nxt > self._now():
                    self._advance(nxt)
                    self.n_idle_sleeps += 1
            self.tick()
            if (self._advance is None and not self.batcher.inflight
                    and self.batcher.pending):
                wait = self.batcher.next_arrival() - self._now()
                # cap <= 0 means "never sleep" (simulated clocks spin
                # through ticks to advance time) — sleep(0) would busy-
                # spin while still counting as an idle sleep
                if wait > 0 and cap > 0:
                    time.sleep(min(wait, cap))
                    self.n_idle_sleeps += 1
        # settle outstanding background builds so post-run stats (builds
        # vs misses+prefetches) reconcile deterministically
        self.bank.drain()
        return self.results

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        lat = sorted(self._latencies)
        buckets = sorted({k[0] for k in self._shapes})
        d = {"requests": self.n_finished, "ticks": self.tick_count,
             "expired": self.n_expired,
             "policy": self.batcher.policy,
             "preemptions": self.batcher.preemptions,
             "deadline_saves": self.batcher.deadline_saves,
             "forwards": self.n_forwards,
             "mean_batch": (self.n_samples_batched / self.n_forwards
                            if self.n_forwards else 0.0),
             "compiled_forwards": len(self._shapes),
             "buckets": buckets,
             "padded_samples": self.n_padded_samples,
             "idle_sleeps": self.n_idle_sleeps,
             "prefetch_hits": self.bank.prefetch_hits,
             "p50_s": percentile(lat, 50), "p95_s": percentile(lat, 95),
             "p99_s": percentile(lat, 99)}
        d.update({f"bank_{k}": v for k, v in self.bank.describe().items()})
        return d
