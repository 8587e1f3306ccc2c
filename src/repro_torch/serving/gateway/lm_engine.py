"""Thin LM serving engine: the gateway adapter around the decode path;
port of ``repro.serving.gateway.lm_engine``.

Wraps the autoregressive decode loop (``models.lm.decode_step`` through
``launch.steps.make_decode_fn`` — the step ``launch/serve.py`` drives by
hand) in the engine surface the serving stack already speaks:
``submit``/``tick``/``run``, the ``ContinuousBatcher`` admission/expiry/
selection machinery, a ``WeightBank`` (single segment, packing through its
``build_fn`` seam), the traffic hooks (``on_submit``/``on_complete``/
``on_expire``/``on_tick_end``/``on_forward``), and the obs instrumentation
points — so one ``ServingGateway`` can host diffusion and LM models behind
the same submit/complete surface, meter them with the same
``MetricsCollector``, and replay them under the same virtual/simulated
clocks.

Request mapping: a generation request's ``steps`` is the number of
tokens to decode greedily after a seed-derived prompt (drawn from
``torch.Generator().manual_seed(seed)``, or by ``prompt_fn(req)`` when the
engine is given one: parity tests feed the reference's
``jax.random``-drawn prompts through it); ``sampler``/``eta``/``y``/
``guidance_scale`` are diffusion-only shaping and are ignored. The
finished ``x0`` is the generated token ids (an int32 CPU tensor), which
the launcher's outcome digest hashes as the reference's float32 bytes.

Thinness (documented limitation, as in the reference): ``decode_step``
takes a *scalar* position, so requests at different positions cannot
share one batched forward — each in-flight request runs its own batch-1
decode per tick (prefill, also per-request, teacher-forces the prompt
through the same step on first advance). The KV cache is the config's
own ``kv_dtype``, allocated per request on the engine's device and
released with the request.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.common.device import resolve_device
from repro_torch.launch.steps import make_decode_fn
from repro_torch.models.lm import LMConfig, init_caches
from repro_torch.serving.obs import NULL_OBS
from repro_torch.serving.scheduler import (ContinuousBatcher, GenRequest,
                                           RequestState)
from repro_torch.serving.traffic.metrics import percentile
from repro_torch.serving.weight_bank import WeightBank


class DecodeState:
    """One request's decode trajectory (duck-types the sampler-state
    surface the scheduler reads: ``done`` / ``steps_left`` / ``kind``)."""

    kind = "lm"

    def __init__(self, cfg: LMConfig, seed: int, gen_len: int,
                 prompt_len: int, *, prompt: torch.Tensor | None = None,
                 device="cpu"):
        if prompt is None:
            prompt = torch.randint(0, cfg.vocab, (1, prompt_len),
                                   generator=torch.Generator().manual_seed(seed))
        if tuple(prompt.shape) != (1, prompt_len):
            raise ValueError(f"prompt shape {tuple(prompt.shape)} != "
                             f"(1, {prompt_len})")
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.gen_left = gen_len
        self.prompt = prompt.to(device=device, dtype=torch.int64)
        self.caches = init_caches(cfg, 1, prompt_len + gen_len, device)
        self.pos = 0               # next cache write position
        self.tok = None            # next input token (1, 1), post-prefill
        self.prefilled = False
        self.done = False
        self.output: torch.Tensor | None = None
        self._out: list[int] = []

    @property
    def steps_left(self) -> int:
        if self.done:
            return 0
        return self.gen_left + (self.prompt_len if not self.prefilled else 0)

    def prefill(self, params, dec) -> int:
        """Teacher-force the prompt through the decode step (fills the KV
        cache); returns the number of forwards run."""
        logits = None
        for i in range(self.prompt_len):
            logits, self.caches = dec(params, self.caches,
                                      self.prompt[:, i:i + 1], i)
        self.tok = logits[:, -1:].argmax(-1)
        self.pos = self.prompt_len
        self.prefilled = True
        return self.prompt_len

    def step(self, params, dec) -> None:
        """Emit the current greedy token, decode it, pick the next."""
        self._out.append(int(self.tok[0, 0]))
        logits, self.caches = dec(params, self.caches, self.tok, self.pos)
        self.pos += 1
        self.tok = logits[:, -1:].argmax(-1)
        self.gen_left -= 1
        if self.gen_left <= 0:
            self.done = True
            self.output = torch.tensor(self._out, dtype=torch.int32)
            self.caches = None     # release the KV cache with the request


class LMServingEngine:
    """Continuous-batching engine over per-request greedy decode."""

    def __init__(self, cfg: LMConfig, bank: WeightBank, *,
                 ctx=None, max_batch: int = 8, starvation_ticks: int = 4,
                 policy: str = "fifo",
                 now_fn: Callable[[], float] | None = None,
                 clock=None, max_idle_sleep: float = 0.25,
                 prompt_len: int = 4,
                 obs=None,
                 model: str | None = None,
                 device="cuda",
                 prompt_fn: Callable[[GenRequest], torch.Tensor] | None = None):
        # device: where the KV caches live and the decode runs (the card
        # unless the caller asks for the CPU); prompt_fn: optional
        # (1, prompt_len) prompt per request, default a draw from a CPU
        # generator seeded with the request's seed
        self.device = resolve_device(device)
        self.prompt_fn = prompt_fn
        self.cfg = cfg
        self.bank = bank
        self.ctx = ctx
        self.model = model
        self.prompt_len = prompt_len
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
        # one segment, fetched on the first tick: nothing to prefetch,
        # but SimClock.attach writes this flag on any engine it drives
        self.async_prefetch = False
        self.obs = obs or NULL_OBS
        if self.obs.enabled:
            self.obs.bind_engine(self)
            self.batcher.obs = self.obs
            if self.bank.obs is NULL_OBS:
                self.bank.obs = self.obs
        # the forward shapes run so far, as the diffusion engine's: one,
        # the batch-1 decode step, made on first use (the reference counts
        # its one jitted step as ``compiled_forwards``)
        self._shapes: dict[tuple, Callable] = {}
        self._next_rid = 0
        self.tick_count = 0
        self.n_forwards = 0
        self.n_samples_batched = 0
        self.n_padded_samples = 0     # batch-1 decodes never pad
        self.n_idle_sleeps = 0
        self.n_finished = 0
        self.n_expired = 0
        self._latencies: list[float] = []
        self.results: dict[int, RequestState] = {}
        self.on_submit: list[Callable] = []
        self.on_complete: list[Callable] = []
        self.on_expire: list[Callable] = []
        self.on_tick_end: list[Callable] = []
        self.on_forward: list[Callable] = []

    def now(self) -> float:
        return self._now()

    def _dec(self) -> Callable:
        key = ("decode",)
        if key not in self._shapes:
            self._shapes[key] = make_decode_fn(self.cfg, ctx=self.ctx)
        return self._shapes[key]

    # -- request lifecycle ---------------------------------------------------

    def submit(self, *, steps: int = 20, eta: float = 0.0, seed: int = 0,
               sampler: str = "ddim", y: int | None = None,
               guidance_scale: float = 0.0, arrival: float = 0.0,
               deadline: float | None = None, priority: int = 0,
               user: int | None = None, parent: int | None = None,
               think_s: float | None = None) -> int:
        """Same signature as the diffusion engine. ``steps`` = tokens to
        generate; ``eta``/``sampler``/``y``/``guidance_scale`` are
        diffusion shaping and are recorded but ignored."""
        rid = self._next_rid
        self._next_rid += 1
        req = GenRequest(rid, steps, eta, seed, sampler, y, guidance_scale,
                         arrival, deadline, priority, user, parent, think_s)
        prompt = self.prompt_fn(req) if self.prompt_fn is not None else None
        state = DecodeState(self.cfg, seed, steps, self.prompt_len,
                            prompt=prompt, device=self.device)
        rs = RequestState(req, state, submitted_at=self._now())
        self.batcher.submit(rs)
        if self.obs.enabled:
            self.obs.tracer.set_track(self.model)
            self.obs.tracer.async_begin(
                "request", rid, cat="request",
                args={"steps": steps, "arrival": arrival,
                      "deadline": deadline, "priority": priority,
                      "family": "lm"})
        for cb in self.on_submit:
            cb(rs)
        return rid

    # -- one engine tick -------------------------------------------------------

    def tick(self) -> list[RequestState]:
        obs = self.obs
        tick_span = None
        if obs.enabled:
            obs.tracer.set_track(self.model)
            tick_span = obs.tracer.begin(
                "tick", cat="engine", args={"tick": self.tick_count})
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
        if not self.batcher.inflight:
            if obs.enabled:
                tick_span.args["idle"] = True
                obs.tracer.end(tick_span)
                obs.sample(self)
            for cb in self.on_tick_end:
                cb(self)
            return []
        groups = self.batcher.groups(lambda rs: 0)   # one weight segment
        seg, members = self.batcher.select(groups, self.tick_count, now=now)
        self.batcher.current_seg = seg
        t_fetch = self._now()
        misses_before = self.bank.misses
        params = self.bank.params_for_segment(seg)
        if self.bank.misses > misses_before:
            self.batcher.cost.observe_switch(self._now() - t_fetch)

        fwd_span = None
        if obs.enabled:
            fwd_span = obs.tracer.begin("forward", cat="engine",
                                        args={"items": len(members)})
        t_compute = self._now()
        dec = self._dec()
        rows = 0
        finished = []
        tick = self.tick_count
        for rs in members:
            st = rs.state
            with torch.inference_mode():
                if not st.prefilled:
                    rows += st.prefill(params, dec)
                st.step(params, dec)
            rows += 1
            rs.last_advance_tick = tick
            rs.n_evals += 1
            if obs.enabled:
                obs.tracer.async_instant("eval", rs.req.rid, cat="request",
                                         args={"n_evals": rs.n_evals})
            if st.done:
                rs.x0 = st.output
                rs.finished_at = self._now()
                self.batcher.retire(rs)
                self.results[rs.req.rid] = rs
                self.n_finished += 1
                self._latencies.append(rs.latency)
                finished.append(rs)
                if obs.enabled:
                    obs.tracer.async_end(
                        "request", rs.req.rid, cat="request",
                        args={"outcome": "complete", "n_evals": rs.n_evals,
                              "latency_s": rs.latency})
                for cb in self.on_complete:
                    cb(rs)
        self.n_forwards += rows
        self.n_samples_batched += len(members)
        self.batcher.cost.observe_eval(self._now() - t_compute, rows)
        if obs.enabled:
            fwd_span.args["rows"] = rows
            obs.tracer.end(fwd_span)
        self.tick_count += 1
        for cb in self.on_forward:
            cb(self, rows)
        if obs.enabled:
            tick_span.args["finished"] = len(finished)
            obs.tracer.end(tick_span)
            obs.sample(self)
        for cb in self.on_tick_end:
            cb(self)
        return finished

    def pop_result(self, rid: int) -> RequestState:
        return self.results.pop(rid)

    # -- driver ----------------------------------------------------------------

    def run(self, *, max_idle_sleep: float | None = None
            ) -> dict[int, RequestState]:
        """Tick to drain — the same idle/advance policy as the diffusion
        engine's driver (see ``engine.DiffusionServingEngine.run``)."""
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
                # cap <= 0 disables sleeping entirely (see engine.run)
                if wait > 0 and cap > 0:
                    time.sleep(min(wait, cap))
                    self.n_idle_sleeps += 1
        self.bank.drain()
        return self.results

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        lat = sorted(self._latencies)
        d = {"requests": self.n_finished, "ticks": self.tick_count,
             "expired": self.n_expired,
             "policy": self.batcher.policy,
             "preemptions": self.batcher.preemptions,
             "deadline_saves": self.batcher.deadline_saves,
             "forwards": self.n_forwards,
             "mean_batch": (self.n_samples_batched / self.tick_count
                            if self.tick_count else 0.0),
             "compiled_forwards": len(self._shapes),
             "buckets": [1],                      # batch-1 decode only
             "padded_samples": self.n_padded_samples,
             "idle_sleeps": self.n_idle_sleeps,
             "prefetch_hits": self.bank.prefetch_hits,
             "p50_s": percentile(lat, 50), "p95_s": percentile(lat, 95),
             "p99_s": percentile(lat, 99)}
        d.update({f"bank_{k}": v for k, v in self.bank.describe().items()})
        return d
