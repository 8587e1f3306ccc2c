"""FleetRouter: N engine replicas behind one placement-routing surface;
port of ``repro.serving.fleet.fleet``.

The multi-host story: each replica is a full serving engine with its
*own* ``WeightBank``, so which replica a request lands on decides whether
its denoising trajectory runs against warm pre-merged segments (cache
hits) or stalls on cold TALoRA merge+pack builds. Placement is
therefore a first-class scheduling decision, not plumbing — the router
supports three policies (``PLACEMENTS``):

  * ``round_robin``     — the baseline: placement counter mod N.
  * ``least_loaded``    — minimize queue depth + in-flight padded rows
    (the same ``group_padded_rows`` bucket arithmetic the scheduler's
    cost model prices, so "load" means the rows the replica will
    actually compute).
  * ``segment_affinity`` — route to a replica whose bank already holds
    (``is_cached``) or is mid-build on (``is_building``) the request's
    *first* routing segment; ready beats mid-build, then ties break by
    load, then registration order. Universal miss falls back to
    least-loaded. This is the policy that multiplies the weight-bank
    cache-hit win: concentrating a segment's requests on its holder
    amortizes one build over many ticks instead of paying it per
    replica, and keeps LRU banks from thrashing.

Unlike the multi-model gateway (which forwards ``submit`` immediately —
its routing key is carried by the request), the router places requests
*at arrival time*: ``submit`` queues them fleet-side ordered by
``(arrival, gid)``, and the ``run`` driver places each one when the
fleet clock reaches its arrival. Placing at submit time would make
affinity a no-op — an open-loop trace submits its whole future up front
while every bank is still empty, so ``is_cached`` could never hit.

Gid/hook fan-in mirrors the gateway: requests get a fleet-wide gid,
each engine's hooks forward into the router's own hook lists after
annotating ``rs.gid`` / ``rs.replica``, so one shared
``MetricsCollector`` / ``TraceWriter`` / closed-loop generator attaches
to the router exactly like to a single engine, while per-replica
collectors power ``stats()``'s breakdowns.

Determinism: with one replica under ``round_robin`` the driver's
advance condition and tick sequence reduce to the bare engine's
(``engine.run``), so a 1-replica golden replay reproduces the
standalone golden digest bit-for-bit (the "fleet adds zero behavior" CI
assertion). Multi-replica runs are deterministic under a shared
``VirtualClock`` or per-replica ``SimClock``s — replicas tick in
registration order, placement is pure arithmetic over replica state.

Clocks: pass a shared ``VirtualClock`` (replay), a shared-origin
``now_fn`` (wall), or neither — in which case the fleet clock is the
*minimum* over replica clocks, the per-replica-``SimClock`` topology
where each replica charges compute on its own parallel service axis
(that is what makes replica-count sweeps show actual scaling; a shared
sim axis would serialize the fleet). A request is placed once every
replica's clock has reached its arrival — the lagging replica still has
simulated work to run before global time gets there.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable

from repro_torch.diffusion.schedule import sample_timesteps
from repro_torch.serving.obs import NULL_OBS, Observability
from repro_torch.serving.scheduler import group_padded_rows
from repro_torch.serving.traffic.metrics import MetricsCollector

PLACEMENTS = ("round_robin", "least_loaded", "segment_affinity")


class EngineReplica:
    """One fleet member: an engine + its own bank, with the live load and
    bank-contents introspection placement policies read."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        engine.replica = name          # obs: {replica=...} labels + track
        self.gid_of: dict[int, int] = {}   # engine rid -> fleet gid
        self.collector = MetricsCollector()
        self.n_placed = 0

    @property
    def bank(self):
        return self.engine.bank

    @property
    def batcher(self):
        return self.engine.batcher

    @property
    def queue_depth(self) -> int:
        """Arrived-or-future requests placed here but not yet admitted."""
        return len(self.batcher.pending)

    @property
    def inflight_rows(self) -> int:
        """Padded rows the in-flight set costs per tick (per-partition
        power-of-two buckets — the engine's real compute unit)."""
        return group_padded_rows(self.batcher.inflight)

    @property
    def load(self) -> int:
        return self.queue_depth + self.inflight_rows

    def holds(self, seg: int) -> str | None:
        """'cached' (warm, zero-stall), 'building' (mid merge+pack — a
        fetch would join), or None."""
        if self.bank.is_cached(seg):
            return "cached"
        if self.bank.is_building(seg):
            return "building"
        return None

    @property
    def live(self) -> bool:
        return bool(self.batcher.pending or self.batcher.inflight)

    def describe(self) -> dict:
        with self.bank._lock:   # snapshot, not point-queries per segment
            cached = sorted(self.bank._cache)
            building = sorted(self.bank._building)
        return {"name": self.name, "queue_depth": self.queue_depth,
                "inflight_rows": self.inflight_rows, "load": self.load,
                "placed": self.n_placed,
                "cached_segments": cached, "building_segments": building}


@dataclasses.dataclass
class _Queued:
    """A submitted request waiting for its arrival time to be placed."""

    gid: int
    arrival: float
    kw: dict            # the engine.submit signature, verbatim
    seg0: int | None    # first routing segment (None when unknowable)


class FleetRouter:
    """Load-balancing router over N ``EngineReplica``s."""

    def __init__(self, *, placement: str = "round_robin", clock=None,
                 now_fn: Callable[[], float] | None = None,
                 max_idle_sleep: float = 0.25,
                 obs: Observability | None = None):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
        self.placement = placement
        self.replicas: list[EngineReplica] = []
        if clock is not None:
            self._now_fn = clock.now
            self._advance = clock.advance_to
        else:
            self._now_fn = now_fn      # None -> min over replica clocks
            self._advance = None
        self.max_idle_sleep = max_idle_sleep
        self.obs = obs or NULL_OBS
        self._next_gid = 0
        self._pending_submit: tuple[str, int] | None = None
        self._unplaced: list[_Queued] = []   # sorted by (arrival, gid)
        self.route: dict[int, tuple[str, int]] = {}  # gid -> (replica, rid)
        self.results: dict[int, object] = {}         # gid -> RequestState
        self.n_idle_sleeps = 0
        self.reason_counts: dict[str, int] = {}
        # router-surface hooks, same contract as an engine's: receive the
        # per-engine RequestState annotated with ``rs.replica``/``rs.gid``
        self.on_submit: list[Callable] = []
        self.on_complete: list[Callable] = []
        self.on_expire: list[Callable] = []
        self.on_tick_end: list[Callable] = []

    # -- registration --------------------------------------------------------

    def add_replica(self, engine, name: str | None = None) -> "FleetRouter":
        """Host ``engine`` as the next replica. It must be idle and built
        on the fleet's clock topology (shared VirtualClock / shared-origin
        now_fn / its own SimClock)."""
        name = name if name is not None else f"r{len(self.replicas)}"
        if any(r.name == name for r in self.replicas):
            raise ValueError(f"replica {name!r} already registered")
        if engine.batcher.pending or engine.batcher.inflight:
            raise ValueError(f"engine for replica {name!r} already has "
                             "requests")
        rep = EngineReplica(name, engine)
        rep.collector.attach(engine)

        def fwd_submit(rs, _rep=rep, _name=name):
            # runs inside engine.submit during placement: the router
            # stashed (name, gid) just before calling it. Direct
            # engine.submit calls keep rs un-annotated.
            if self._pending_submit is not None:
                pname, gid = self._pending_submit
                if pname == _name:
                    rs.replica = _name
                    rs.gid = gid
                    _rep.gid_of[rs.req.rid] = gid
            for cb in self.on_submit:
                cb(rs)

        def fwd_done(rs, _rep=rep, expire=False):
            gid = _rep.gid_of.get(rs.req.rid)
            if gid is not None:
                self.results[gid] = rs
            for cb in (self.on_expire if expire else self.on_complete):
                cb(rs)

        engine.on_submit.append(fwd_submit)
        engine.on_complete.append(lambda rs: fwd_done(rs))
        engine.on_expire.append(lambda rs: fwd_done(rs, expire=True))
        engine.on_tick_end.append(
            lambda e: [cb(e) for cb in self.on_tick_end])
        self.replicas.append(rep)
        return self

    def replica(self, name: str) -> EngineReplica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"unknown replica {name!r} "
                       f"(fleet: {[r.name for r in self.replicas]})")

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """The fleet clock. With per-replica SimClocks this is the
        *minimum* replica time: a request arriving at global time t is
        placed only once every replica's axis has reached t."""
        if self._now_fn is not None:
            return self._now_fn()
        if not self.replicas:
            return 0.0
        return min(r.engine.now() for r in self.replicas)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, *, model: str | None = None, **kw) -> int:
        """Queue one request for placement at its arrival time; returns
        its fleet-wide gid. ``kw`` is the engine submit signature."""
        if model is not None:
            raise ValueError("fleet replicas serve one model; route "
                             "multi-model traffic through the gateway")
        if not self.replicas:
            raise RuntimeError("fleet has no replicas registered")
        gid = self._next_gid
        self._next_gid += 1
        q = _Queued(gid, float(kw.get("arrival", 0.0)), kw,
                    self._first_segment(kw))
        bisect.insort(self._unplaced, q, key=lambda x: (x.arrival, x.gid))
        return gid

    def _first_segment(self, kw: dict) -> int | None:
        """The routing segment of the first timestep this request's
        sampler will evaluate. Every step sampler starts from the top of
        its subsequence (``sample_timesteps(T, steps)[0]``), and routing
        segmentation is identical across replicas, so replica 0's bank
        answers for the whole fleet."""
        bank = self.replicas[0].bank
        try:
            t0 = int(sample_timesteps(bank.T, int(kw.get("steps", 20)))[0])
            return bank.segment_of(t0)
        except Exception:
            return None    # stub banks without a schedule: affinity
        #                    degrades to least-loaded for this request

    def pop_result(self, gid: int):
        """Hand a finished request over and drop every per-request
        bookkeeping entry (results, gid route, replica rid->gid map) —
        the same leak the gateway's pop_result had to close."""
        rs = self.results.pop(gid)
        name, rid = self.route.pop(gid)
        rep = self.replica(name)
        rep.engine.results.pop(rid, None)
        rep.gid_of.pop(rid, None)
        return rs

    # -- placement -----------------------------------------------------------

    def _least_loaded(self) -> int:
        return min(range(len(self.replicas)),
                   key=lambda i: (self.replicas[i].load, i))

    def _choose(self, q: _Queued) -> tuple[int, str]:
        """(replica index, reason) under the configured policy."""
        if self.placement == "round_robin":
            return self._next_gid_rr(), "rr"
        if self.placement == "least_loaded":
            return self._least_loaded(), "least_loaded"
        # segment_affinity
        if q.seg0 is not None:
            ranked = []
            for i, r in enumerate(self.replicas):
                h = r.holds(q.seg0)
                if h is not None:
                    # ready beats mid-build; then lightest; then index
                    ranked.append((h != "cached", r.load, i))
            if ranked:
                cold, _, i = min(ranked)
                return i, ("affinity_building" if cold else "affinity_hit")
        return self._least_loaded(), "affinity_miss"

    def _next_gid_rr(self) -> int:
        i = getattr(self, "_rr", 0)
        self._rr = i + 1
        return i % len(self.replicas)

    def _place(self, q: _Queued) -> None:
        i, reason = self._choose(q)
        rep = self.replicas[i]
        self._pending_submit = (rep.name, q.gid)
        try:
            rid = rep.engine.submit(**q.kw)
        finally:
            self._pending_submit = None
        rep.gid_of[rid] = q.gid
        rep.n_placed += 1
        self.route[q.gid] = (rep.name, rid)
        self.reason_counts[reason] = self.reason_counts.get(reason, 0) + 1
        if self.obs.enabled:
            self.obs.tracer.set_track("router")
            self.obs.tracer.instant(
                "route", cat="fleet",
                args={"gid": q.gid, "replica": rep.name,
                      "placement": self.placement, "reason": reason,
                      "seg0": q.seg0, "load": rep.load - 1})

    def _place_due(self, now: float) -> None:
        while self._unplaced and self._unplaced[0].arrival <= now:
            self._place(self._unplaced.pop(0))

    # -- driver --------------------------------------------------------------

    def run(self, *, max_idle_sleep: float | None = None) -> dict:
        """Place + tick until every submitted request finished or expired;
        returns ``results`` keyed by gid.

        Generalizes the single-engine driver: under a virtual clock,
        advance to the earliest event any replica could act on (its own
        next placed arrival with a free slot, or the head unplaced
        arrival when any slot is free anywhere) before ticking; replicas
        tick in registration order. With one replica this reduces
        exactly to ``engine.run``'s advance condition — the golden
        identity. Without an advancing clock, unplaced work also ticks
        otherwise-idle replicas so per-replica SimClocks keep moving
        toward the next arrival.
        """
        cap = self.max_idle_sleep if max_idle_sleep is None else max_idle_sleep
        if not self.replicas:
            return self.results

        def has_slot(r: EngineReplica) -> bool:
            return len(r.batcher.inflight) < r.batcher.max_batch

        while self._unplaced or any(r.live for r in self.replicas):
            if self._advance is not None:
                nxts = [r.batcher.next_arrival() for r in self.replicas
                        if r.batcher.pending and has_slot(r)]
                if self._unplaced and any(has_slot(r)
                                          for r in self.replicas):
                    nxts.append(self._unplaced[0].arrival)
                if nxts:
                    nxt = min(nxts)
                    if nxt > self.now():
                        self._advance(nxt)
                        self.n_idle_sleeps += 1
            self._place_due(self.now())
            for r in self.replicas:
                # unplaced work ticks idle replicas too when no advancing
                # clock exists: their SimClocks must idle forward for the
                # fleet min-clock to reach the next arrival
                if r.live or (self._advance is None and self._unplaced):
                    r.engine.tick()
            if (self._advance is None and cap > 0
                    and all(not r.batcher.inflight for r in self.replicas)
                    and (self._unplaced
                         or any(r.batcher.pending for r in self.replicas))):
                nxts = [r.batcher.next_arrival() for r in self.replicas
                        if r.batcher.pending]
                if self._unplaced:
                    nxts.append(self._unplaced[0].arrival)
                wait = min(nxts) - self.now()
                if wait > 0:
                    time.sleep(min(wait, cap))
                    self.n_idle_sleeps += 1
        for r in self.replicas:
            r.engine.bank.drain()
        return self.results

    # -- metrics -------------------------------------------------------------

    def stats(self) -> dict:
        """Aggregate + per-replica view: each replica's full engine
        stats (bank counters included) and traffic summary, fleet-wide
        totals, pooled bank hit rate, and the placement-decision
        histogram."""
        per = {}
        for r in self.replicas:
            per[r.name] = {"engine": r.engine.stats(),
                           "summary": r.collector.summary(),
                           "placed": r.n_placed,
                           "load": r.load}
        hits = sum(r.bank.hits for r in self.replicas)
        misses = sum(r.bank.misses for r in self.replicas)
        agg = {
            "replicas": [r.name for r in self.replicas],
            "placement": self.placement,
            "requests": sum(p["engine"]["requests"] for p in per.values()),
            "expired": sum(p["engine"]["expired"] for p in per.values()),
            "ticks": sum(p["engine"]["ticks"] for p in per.values()),
            "forwards": sum(p["engine"]["forwards"] for p in per.values()),
            "idle_sleeps": self.n_idle_sleeps,
            "bank_hits": hits,
            "bank_misses": misses,
            "bank_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "bank_builds": sum(r.bank.builds for r in self.replicas),
            "bank_evictions": sum(r.bank.evictions for r in self.replicas),
            "placements": {r.name: r.n_placed for r in self.replicas},
            "placement_reasons": dict(sorted(self.reason_counts.items())),
        }
        return {"aggregate": agg, "per_replica": per}
