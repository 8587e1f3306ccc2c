"""Continuous-batching scheduler for diffusion generation requests; port of
``repro.serving.scheduler`` (framework-free apart from the latent type).

Policy (documented for the README/tests):

  * **Admission** — by (priority desc, arrival, rid); plain FIFO when
    every request carries the default priority 0. A request is
    admissible once its arrival time has passed and an in-flight slot
    (``max_batch``) is free; requests admit/retire *mid-flight*, the
    batch never drains. A due request whose ``deadline`` has already
    passed is *expired* instead of admitted (it could not possibly meet
    its SLO) — admitted requests always run to completion and are scored
    against the deadline by the metrics collector instead. Admission is
    identical under both selection policies.
  * **Grouping** — in-flight requests are grouped by the weight-bank
    segment of the timestep their sampler needs next. Requests inside a
    segment batch into one model forward even at different timesteps
    (``t`` is per-sample in the UNet).
  * **Selection** — one segment group advances per tick.

    ``policy="fifo"`` (the PR-2 baseline): the largest group wins
    (ties: the group holding the smallest rid).

    ``policy="slo"``: slack-aware. Each group scores
    ``min-slack + switch-penalty`` and the *lowest* score runs, where a
    member's slack is ``deadline - now - remaining_evals * eval_cost``
    (``CostModel`` EWMA estimates; deadline-free members contribute the
    ``horizon_s`` ceiling) and the switch penalty is the estimated
    segment build time — zero when the group is the batcher's
    ``current_seg`` or the weight bank reports it warm. With no deadline
    pressure every group sits at the horizon, so the penalty makes the
    scheduler *stay on the current bank segment* (segment switches are
    the expensive event under TALoRA routing); at equal score the larger
    group wins, recovering throughput-first behavior.

    Under either policy a request that has not advanced for
    ``starvation_ticks`` ticks promotes its own group first (no segment
    starves under skewed traffic or deadline pressure).
  * **Preemption** (``slo`` only) — a selected group may *split*: when a
    tight-slack member would miss its deadline at the full group's
    padded-bucket cost but meets it at a smaller bucket, only the
    most-urgent members that fill the smaller bucket run this tick; the
    rest are deferred in place (they stay in flight, aging toward the
    starvation backstop). ``preemptions`` counts deferred members;
    ``deadline_saves`` counts split-triggering requests that then
    retired within their deadline.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable

import torch

from repro_torch.diffusion.samplers import SamplerState
from repro_torch.serving.obs import NULL_OBS

POLICIES = ("fifo", "slo")


def bucket_of(n: int) -> int:
    """Smallest power of two >= n — the engine pads partition batches to
    these buckets, so scheduling cost estimates must use them too."""
    b = 1
    while b < n:
        b *= 2
    return b


def remaining_evals(rs: "RequestState") -> int:
    """Model-forward evaluations a request still needs (upper estimate:
    DPM-Solver-2 runs ~2 evals per remaining step pair)."""
    st = rs.state
    if st.done:
        return 0
    left = st.steps_left
    return 2 * left if st.kind == "dpm_solver2" else left


def group_padded_rows(members: list["RequestState"]) -> int:
    """Padded rows a group's tick actually runs. The engine partitions
    eval items by class conditioning — a CFG-guided request contributes
    one row to *each* partition (uncond + cond), a plain one a single
    row to its own; a text-guided one (no label) both rows to the
    unlabelled one — and pads every partition to its own power-of-two
    bucket, so the cost model must price the sum of per-partition
    buckets, not one joint bucket."""
    n_none = n_y = 0
    for rs in members:
        if rs.req.guidance_scale > 0 and rs.req.y is None:
            n_none += 2
        elif rs.req.guidance_scale > 0:
            n_none += 1
            n_y += 1
        elif rs.req.y is None:
            n_none += 1
        else:
            n_y += 1
    return ((bucket_of(n_none) if n_none else 0)
            + (bucket_of(n_y) if n_y else 0))


@dataclasses.dataclass
class CostModel:
    """EWMA service-time estimates (seconds) feeding slack computations.

    ``sample_s`` is one sample's share of one batched forward at bucket
    granularity (a group of n costs ``sample_s * bucket_of(n)``);
    ``switch_s`` is one cold weight-bank segment build (merge + pack).
    Zero-duration observations are ignored — under a ``VirtualClock``
    compute takes no clock time, so the model stays at its seed values
    and slack degrades to pure EDF (deterministic replay preserved).
    """

    sample_s: float = 0.0
    switch_s: float = 0.0
    alpha: float = 0.25

    def _ewma(self, old: float, new: float) -> float:
        return new if old == 0.0 else (1 - self.alpha) * old + self.alpha * new

    def observe_eval(self, dt: float, padded_rows: int) -> None:
        """Record one tick's compute over the *padded* rows it actually
        ran (sum of per-partition buckets — the engine passes this), so
        sample_s matches what slack() prices."""
        if dt > 0 and padded_rows > 0:
            self.sample_s = self._ewma(self.sample_s, dt / padded_rows)

    def observe_switch(self, dt: float) -> None:
        if dt > 0:
            self.switch_s = self._ewma(self.switch_s, dt)

    def eval_s(self, batch_n: int) -> float:
        """Estimated cost of one forward over a batch of ``batch_n``."""
        return self.sample_s * bucket_of(max(batch_n, 1))


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One user's generation job (per-request steps/eta/seed/guidance)."""

    rid: int
    steps: int = 20
    eta: float = 0.0
    seed: int = 0
    sampler: str = "ddim"
    y: int | None = None            # class label (class-conditional models)
    guidance_scale: float = 0.0     # > 0 pairs a cond + uncond eval (CFG)
    arrival: float = 0.0            # seconds from trace start
    deadline: float | None = None   # absolute SLO cutoff, seconds
    priority: int = 0               # higher admits first under contention
    user: int | None = None         # closed-loop user id (trace metadata)
    parent: int | None = None       # rid whose completion triggered this one
    think_s: float | None = None    # think time preceding this request


@dataclasses.dataclass
class RequestState:
    """Scheduler-side lifecycle wrapper around a SamplerState."""

    req: GenRequest
    state: SamplerState
    submitted_at: float = 0.0
    admitted_at: float | None = None
    finished_at: float | None = None
    last_advance_tick: int = -1
    n_evals: int = 0
    x0: torch.Tensor | None = None
    expired: bool = False           # refused admission past its deadline
    context: torch.Tensor | None = None   # a text model's (1, L, D) context

    @property
    def latency(self) -> float | None:
        """Service latency from *arrival* (a trace request submitted ahead
        of its arrival time hasn't waited while merely scheduled). None
        until completion — and None forever for expired requests, which
        never ran: folding their refusal time into completion percentiles
        would poison p95/p99 (see ``expired_after_s``)."""
        if self.finished_at is None or self.expired:
            return None
        return self.finished_at - max(self.submitted_at, self.req.arrival)

    @property
    def expired_after_s(self) -> float | None:
        """How long past arrival an expired request waited before the
        scheduler refused it; None for non-expired requests."""
        if not self.expired or self.finished_at is None:
            return None
        return self.finished_at - max(self.submitted_at, self.req.arrival)

    @property
    def queue_wait(self) -> float | None:
        if self.admitted_at is None:
            return None
        return self.admitted_at - max(self.submitted_at, self.req.arrival)


class ContinuousBatcher:
    def __init__(self, max_batch: int = 8, starvation_ticks: int = 4,
                 policy: str = "fifo", horizon_s: float = 60.0):
        assert max_batch >= 1
        assert policy in POLICIES, f"policy {policy!r} not in {POLICIES}"
        self.max_batch = max_batch
        self.starvation_ticks = max(1, starvation_ticks)
        self.policy = policy
        self.horizon_s = horizon_s
        self.cost = CostModel()
        self.current_seg: int | None = None     # segment served last tick
        self.segment_warm: Callable[[int], bool] | None = None
        self.segment_building: Callable[[int], bool] | None = None
        self.obs = NULL_OBS                     # engine propagates its obs
        self.preemptions = 0                    # members deferred by splits
        self.deadline_saves = 0                 # split-urgent reqs that met
        self._save_watch: set[int] = set()      # rids whose split is pending
        self.pending: list[RequestState] = []
        self.inflight: list[RequestState] = []

    def slack(self, rs: RequestState, now: float, padded_rows: int
              ) -> float:
        """Seconds to spare if every remaining eval runs in a tick that
        computes ``padded_rows`` rows (``group_padded_rows`` of the
        request's group); ``horizon_s`` for deadline-free requests."""
        if rs.req.deadline is None:
            return self.horizon_s
        return (rs.req.deadline - now
                - remaining_evals(rs) * self.cost.sample_s * padded_rows)

    def submit(self, rs: RequestState) -> None:
        # pending must stay sorted by (arrival, rid) — admit() relies on
        # the due prefix. insort is O(n) per submit; re-sorting the whole
        # list each time was O(n^2 log n) over a bulk trace ingest.
        bisect.insort(self.pending, rs,
                      key=lambda r: (r.req.arrival, r.req.rid))

    def next_arrival(self) -> float | None:
        return self.pending[0].req.arrival if self.pending else None

    def admit(self, now: float, tick: int
              ) -> tuple[list[RequestState], list[RequestState]]:
        """Admit due requests into free slots; returns (admitted, expired).

        Due requests whose deadline has already passed are expired
        (removed from pending, never run) regardless of slot pressure;
        the rest admit by (priority desc, arrival, rid).
        """
        # pending stays sorted by (arrival, rid): the due requests are a
        # prefix, so a tick with nothing due costs O(1), not O(pending)
        n_due = 0
        while (n_due < len(self.pending)
               and self.pending[n_due].req.arrival <= now):
            n_due += 1
        if not n_due:
            return [], []
        due = self.pending[:n_due]
        expired = []
        for rs in due:
            if rs.req.deadline is not None and now > rs.req.deadline:
                rs.expired = True
                expired.append(rs)
        admitted = []
        for rs in sorted((rs for rs in due if not rs.expired),
                         key=lambda r: (-r.req.priority, r.req.arrival,
                                        r.req.rid)):
            if len(self.inflight) >= self.max_batch:
                break
            rs.admitted_at = now
            rs.last_advance_tick = tick  # freshly admitted, not starved
            self.inflight.append(rs)
            admitted.append(rs)
        taken = {id(rs) for rs in admitted} | {id(rs) for rs in expired}
        self.pending[:n_due] = [rs for rs in due if id(rs) not in taken]
        return admitted, expired

    def groups(self, seg_fn: Callable[[RequestState], int]
               ) -> dict[int, list[RequestState]]:
        out: dict[int, list[RequestState]] = {}
        for rs in self.inflight:
            out.setdefault(seg_fn(rs), []).append(rs)
        return out

    def select(self, groups: dict[int, list[RequestState]], tick: int,
               now: float = 0.0) -> tuple[int, list[RequestState]]:
        """Pick the segment group (possibly a split subset) to advance.

        The starvation backstop runs first under both policies and always
        serves the starved request's *full* group — a split can never
        defer a request the backstop just promoted.
        """
        assert groups
        starved = [rs for rs in self.inflight
                   if tick - rs.last_advance_tick >= self.starvation_ticks]
        if starved:
            oldest = min(starved, key=lambda r: (r.last_advance_tick,
                                                 r.req.rid))
            for seg, members in groups.items():
                if oldest in members:
                    if self.obs.enabled:
                        self.obs.tracer.instant(
                            "select", cat="sched",
                            args={"policy": self.policy, "seg": seg,
                                  "n": len(members), "starved": True,
                                  "starved_rid": oldest.req.rid})
                    return seg, members
        if self.policy == "slo":
            return self._select_slo(groups, tick, now)
        # fifo: largest group; ties -> the group holding the smallest rid
        def rank(item):
            seg, members = item
            return (-len(members), min(r.req.rid for r in members))

        seg, members = min(groups.items(), key=rank)
        if self.obs.enabled:
            self.obs.tracer.instant(
                "select", cat="sched",
                args={"policy": "fifo", "seg": seg, "n": len(members)})
        return seg, members

    # -- slo policy ----------------------------------------------------------

    def _switch_penalty(self, seg: int) -> float:
        if seg == self.current_seg:
            return 0.0
        if self.segment_warm is not None and self.segment_warm(seg):
            return 0.0
        if self.segment_building is not None and self.segment_building(seg):
            # a fetch would join the in-progress build mid-way: expected
            # remaining stall ~ half a cold build, not zero (pricing it
            # free would switch onto a barely-started build and stall)
            return 0.5 * self.cost.switch_s
        return self.cost.switch_s

    def _group_pressure(self, seg: int, members: list[RequestState],
                        now: float) -> tuple[float, float]:
        """(min-slack, switch-penalty) for one group — the two components
        the slo score adds. Members whose deadline has already passed are
        guaranteed misses: they exert no urgency (an arbitrarily negative
        slack would otherwise monopolize selection and starve
        still-savable groups until the backstop)."""
        n = group_padded_rows(members)
        sl = min((self.slack(rs, now, n) for rs in members
                  if rs.req.deadline is not None
                  and rs.req.deadline >= now),
                 default=self.horizon_s)
        return min(sl, self.horizon_s), self._switch_penalty(seg)

    def _select_slo(self, groups: dict[int, list[RequestState]], tick: int,
                    now: float) -> tuple[int, list[RequestState]]:
        def score(item):
            seg, members = item
            sl, penalty = self._group_pressure(seg, members, now)
            return (sl + penalty, -len(members),
                    min(r.req.rid for r in members))

        seg, members = min(groups.items(), key=score)
        if self.obs.enabled:
            sl, penalty = self._group_pressure(seg, members, now)
            self.obs.tracer.instant(
                "select", cat="sched",
                args={"policy": "slo", "seg": seg, "n": len(members),
                      "slack_s": sl, "switch_penalty_s": penalty})
        return seg, self._maybe_split(members, tick, now)

    def _maybe_split(self, members: list[RequestState], tick: int,
                     now: float) -> list[RequestState]:
        """Preempt: serve only the urgent prefix of a group when the full
        group's padded bucket would make a tight-slack member miss its
        deadline that a smaller bucket still meets (strict inequality:
        slack exactly 0 at the full bucket is a meet, not a miss)."""
        if len(members) < 2 or self.cost.sample_s <= 0:
            return members
        full_rows = group_padded_rows(members)
        # already-missed members (deadline < now) are guaranteed misses:
        # they are not worth splitting for AND must not inflate the
        # small bucket (a doomed groupmate would otherwise cancel a
        # split that saves a still-reachable request) — consistent with
        # the selection score's exclusion above
        tight = [rs for rs in members
                 if rs.req.deadline is not None and rs.req.deadline >= now
                 and self.slack(rs, now, full_rows) < 0]
        if not tight or len(tight) == len(members):
            return members
        small_rows = group_padded_rows(tight)
        if small_rows >= full_rows:
            return members
        # the split must actually save someone at the smaller bucket
        saved = [rs for rs in tight if self.slack(rs, now, small_rows) >= 0]
        if not saved:
            return members
        # every tight member runs (the tight prefix's padded rows are
        # exactly small_rows by construction — a merely-low-slack
        # non-tight member must never displace the request the split
        # exists to save); spare bucket capacity fills with the
        # most-urgent remainder, where a guaranteed-miss member again
        # carries horizon urgency (its raw slack is hugely negative and
        # would steal the spare slot from a still-savable groupmate)
        tight_ids = {id(rs) for rs in tight}

        def fill_slack(rs):
            if rs.req.deadline is not None and rs.req.deadline < now:
                return self.horizon_s
            return self.slack(rs, now, small_rows)

        by_urgency = sorted(
            members, key=lambda rs: (id(rs) not in tight_ids,
                                     fill_slack(rs), rs.req.rid))
        run, deferred = [], []
        for rs in by_urgency:
            if group_padded_rows(run + [rs]) <= small_rows:
                run.append(rs)
            else:
                deferred.append(rs)
        # never defer a member about to trip the starvation backstop
        if any(tick - rs.last_advance_tick >= self.starvation_ticks - 1
               for rs in deferred):
            return members
        self.preemptions += len(deferred)
        self._save_watch.update(rs.req.rid for rs in saved)
        if self.obs.enabled:
            self.obs.tracer.instant(
                "preempt", cat="sched",
                args={"run": [rs.req.rid for rs in run],
                      "deferred": [rs.req.rid for rs in deferred],
                      "saved": [rs.req.rid for rs in saved],
                      "full_rows": full_rows, "small_rows": small_rows})
        return run

    def retire(self, rs: RequestState) -> None:
        self.inflight.remove(rs)
        if rs.req.rid in self._save_watch:
            self._save_watch.discard(rs.req.rid)
            # watched rids always carry a deadline (saved ⊆ tight)
            if (rs.finished_at is not None
                    and rs.finished_at <= rs.req.deadline):
                self.deadline_saves += 1
