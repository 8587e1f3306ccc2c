"""Weight bank: per-routing-segment TALoRA merge + real FP4 pre-packing;
port of ``repro.serving.weight_bank``.

The TALoRA router maps each timestep to one adapter slot per layer
(``core.talora``). Sweeping the router over the full schedule yields a
small number of contiguous timestep segments with identical routing; within
a segment the merged weights ``W_q + A_sel B_sel * alpha/r`` are constant.
The bank therefore:

  1. sweeps ``routing_signatures`` once to find the segments,
  2. on demand merges each segment's adapters into the quantized base
     (``talora.merge_into_tree``) and *re-packs* every quantizable site to
     real packed FP4 (``core.qmodule.pack_weight``) under the plan's
     searched parameters — sampling then runs integer-packed weights
     end-to-end (kernels/ops dispatch) instead of fake-quant,
  3. keeps at most ``max_cached`` segment weight-sets alive (LRU; a
     trained router uses few segments — App. E.2's h=2 gives 2-4 — but an
     untrained or large-h router can fragment the schedule).

Sites the 4-bit packer cannot represent — 8-bit io sites, INT-affine
plans, odd output widths, 1-D leaves — fall back to dense ``bf16`` so the
forward stays total.

Re-packing note: fine-tuning computes the merged weight in float; packing
snaps it back onto the searched FP4 grid (values pushed past ``maxval`` by
the adapter clip). This is the standard merged-LoRA deployment trade and
is what the engine's parity test measures.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.core import talora
from repro_torch.core.msfp import QuantPlan, SiteInfo
from repro_torch.core.qmodule import PackedW4, pack_weight
from repro_torch.quant.fakequant import (KIND_FP_SIGNED, KIND_INT_AFFINE,
                                         QuantizerParams)
from repro_torch.serving.obs import NULL_OBS


@dataclasses.dataclass(frozen=True)
class Segment:
    """Maximal run of timesteps [t_lo, t_hi] with identical routing."""

    index: int
    t_lo: int
    t_hi: int                 # inclusive
    slots: tuple              # per-layer selected hub slot (len = n_layers)

    def __contains__(self, t: int) -> bool:
        return self.t_lo <= t <= self.t_hi


def segments_of(signatures: np.ndarray) -> list[Segment]:
    """Contiguous equal-row runs of a (T, n_layers) signature sweep."""
    sig = np.asarray(signatures)
    assert sig.ndim == 2, sig.shape
    segs: list[Segment] = []
    lo = 0
    for t in range(1, sig.shape[0] + 1):
        if t == sig.shape[0] or not np.array_equal(sig[t], sig[lo]):
            segs.append(Segment(len(segs), lo, t - 1, tuple(sig[lo].tolist())))
            lo = t
    return segs


def _tree_to(tree, device):
    """Nested dicts/lists of tensors (and PackedW4 leaves) onto ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    if isinstance(tree, (torch.Tensor, PackedW4)):
        return tree.to(device)
    return tree


def _packable(site: str, w, plan: QuantPlan) -> bool:
    if site not in plan.sites or not plan.sites[site].is_weight:
        return False
    qp = plan.sites[site].qp
    if qp.bits != 4 or qp.kind == KIND_INT_AFFINE:
        return False
    if getattr(w, "ndim", 0) < 2 or w.shape[-1] % 2 != 0:
        return False
    mv = qp.maxval
    if mv.ndim == 1 and not (w.ndim in (2, 4)          # dense or HWIO conv
                             and mv.shape[0] == w.shape[-1]):
        return False
    return mv.ndim <= 1


def pack_param_tree(params: dict, plan: QuantPlan, *,
                    fallback_dtype=torch.bfloat16) -> tuple[dict, dict]:
    """Pack every plan-covered 4-bit FP weight; bf16 the rest of the planned
    weights; leave unplanned leaves (biases, norms) untouched.

    HWIO conv weights pack as their (kh*kw*cin, cout) flattening (see
    ``pack_weight``), so conv sites ride the same im2col Pallas matmul
    route as dense sites instead of the bf16-fallback bucket.

    Returns (tree, stats) with stats = {'packed': [...], 'fallback': [...]}.
    """
    flat = dict(flatten_paths(params))
    packed_sites, fallback_sites = [], []
    for site, w in flat.items():
        if isinstance(w, PackedW4):
            packed_sites.append(site)
            continue
        if _packable(site, w, plan):
            flat[site] = pack_weight(w, plan.sites[site].qp)
            packed_sites.append(site)
        elif site in plan.sites and plan.sites[site].is_weight:
            flat[site] = w.to(fallback_dtype)
            fallback_sites.append(site)
    return unflatten_paths(flat), {"packed": packed_sites,
                                   "fallback": fallback_sites}


def default_serving_plan(weights: dict[str, Any], *,
                         io_sites: frozenset | set = frozenset()
                         ) -> QuantPlan:
    """Calibration-free deployment plan: signed E2M1 with abs-max grids.

    The searched plan (``msfp.build_mixed_plan``) is the paper-faithful
    path; this is the cheap bring-up default for the serving CLI / tests —
    every weight site gets a per-tensor abs-max signed FP4 quantizer, io
    sites get 8-bit (E4M3) which the packer treats as bf16 fallback.
    """
    sites: dict[str, SiteInfo] = {}
    for name, w in weights.items():
        mv = torch.clamp_min(torch.max(torch.abs(w)).to(torch.float32), 1e-8)
        if name in io_sites:
            qp = QuantizerParams(KIND_FP_SIGNED, 4, 3, 8, mv)
        else:
            qp = QuantizerParams(KIND_FP_SIGNED, 2, 1, 4, mv)
        sites[name] = SiteInfo(qp, True, False, 0.0)
    return QuantPlan(sites, 4, 4, "msfp")


def absmax_talora_setup(params: dict, talora_cfg: talora.TALoRAConfig,
                        generator: torch.Generator, *,
                        io_sites: frozenset | set = frozenset()
                        ) -> tuple[QuantPlan, dict, dict]:
    """Calibration-free bank inputs for a raw param tree.

    Shared by the serving launcher and bench: filters the packable weight
    sites, builds the abs-max plan, and initializes TALoRA hubs + router
    (untrained — routing is still a deterministic segmenting function).
    Returns (plan, hubs, router).
    """
    weights = {k: v for k, v in flatten_paths(params).items()
               if k.endswith("/w") and getattr(v, "ndim", 0) >= 2}
    plan = default_serving_plan(weights, io_sites=io_sites)
    dims = talora.lora_target_dims_from_weights(weights)
    device = next(iter(weights.values())).device
    hubs = talora.init_lora_hub(generator, dims, talora_cfg, device)
    router = talora.init_router(generator, len(dims), talora_cfg, device)
    return plan, hubs, router


def act_qps_from_plan(plan: QuantPlan | None) -> dict[str, QuantizerParams]:
    """Per-site activation quantizers the fused W4A4 kernel can consume.

    Serve-mode ``QuantContext`` feeds these to packed dense sites; only
    per-tensor FP quantizers qualify (INT-affine falls back to the plain
    packed matmul, which is still integer-packed — just not act-fused).
    """
    if plan is None:
        return {}
    out = {}
    for name, info in plan.sites.items():
        if info.is_weight or info.qp.kind == KIND_INT_AFFINE:
            continue
        if info.qp.bits != 4 or info.qp.maxval.ndim != 0:
            continue
        out[name] = info.qp
    return out


class WeightBank:
    """LRU cache of per-segment TALoRA-merged, FP4-packed weight sets."""

    def __init__(self, q_params: dict, plan: QuantPlan | None, hubs: dict,
                 router: dict, talora_cfg: talora.TALoRAConfig, T: int, *,
                 max_cached: int = 4, fallback_dtype=torch.bfloat16,
                 lock_factory=None, build_fn=None, signatures=None,
                 device="cuda"):
        # every tree the bank merges and packs lives on ``device``; the
        # routing sweep runs on the host (talora.routing_signatures)
        self.device = resolve_device(device)
        q_params, hubs, router = (_tree_to(t, self.device)
                                  for t in (q_params, hubs, router))
        self.q_params = q_params
        self.plan = plan
        # build_fn: alternative packer ``params -> packed tree`` replacing
        # the plan-driven ``pack_param_tree`` — the seam non-diffusion
        # engines (the gateway's LM adapter) use to reuse the bank's LRU /
        # single-build / counter machinery with their own quant recipe.
        # TALoRA merging still runs first when hubs are present.
        self.build_fn = build_fn
        if plan is None and build_fn is None:
            raise ValueError("WeightBank needs a QuantPlan or a build_fn")
        self.hubs = hubs
        self.router = router
        self.talora_cfg = talora_cfg
        self.T = T
        self.max_cached = max(1, max_cached)
        self.fallback_dtype = fallback_dtype
        self.names = sorted(hubs) if hubs else []

        if signatures is not None:
            # precomputed (T, k) routing-signature array overriding the
            # router evaluation — the seam fleet benches and placement
            # tests use to pin an exact segmentation (e.g. per-timestep)
            # without training a router to produce it
            sig = np.asarray(signatures)
            if sig.shape[0] != T:
                raise ValueError(f"signatures rows {sig.shape[0]} != T={T}")
        elif hubs and router is not None:
            sig = talora.routing_signatures(
                router, np.arange(T), self.names, talora_cfg).numpy()
        else:
            sig = np.zeros((T, 1), np.int32)   # no TALoRA: one segment
        self.signatures = sig
        self.segments = segments_of(sig)
        self._t_to_seg = np.zeros((T,), np.int32)
        for s in self.segments:
            self._t_to_seg[s.t_lo:s.t_hi + 1] = s.index

        # One lock guards the cache, the in-progress build registry, and
        # every counter: the async prefetch worker and the engine thread
        # race on all of them. Builds themselves (merge + pack work)
        # run outside the lock; a (seg -> Future) entry in ``_building``
        # is the single-build guarantee — any concurrent fetch joins the
        # future instead of building again. ``lock_factory`` is the
        # instrumentation seam: tools/analysis/lockcheck.py installs an
        # order-tracking lock here to verify that discipline at test time.
        self._lock = (lock_factory("bank._lock") if lock_factory is not None
                      else threading.Lock())
        self._building: dict[int, Future] = {}
        self._executor: ThreadPoolExecutor | None = None
        self._cache: OrderedDict[int, dict] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetches = 0
        self.prefetch_hits = 0
        # builds + build_failures == misses + prefetches once drained;
        # build_joins = fetches that waited on an in-progress build.
        # build_failures keeps a background prefetch whose merge+pack
        # raised (the error only surfaces to whoever joins the future)
        # from silently breaking that reconciliation.
        self.builds = 0
        self.build_joins = 0
        self.build_failures = 0
        self._prefetched: set[int] = set()
        self.pack_stats: dict | None = None
        # (bank, seg) after every completed build install — the seam
        # simulated service clocks charge merge+pack time through (the
        # engine's on_forward equivalent for segment switches). Fired
        # outside ``_lock``; under a SimClock builds are synchronous
        # (attach forces sync prefetch), so the charge lands inside the
        # tick that stalled on the build.
        self.on_build: list = []
        # observability: the engine propagates its bundle here so build/
        # prefetch spans (including those emitted from the background
        # worker thread) land in the same trace buffer. Spans are emitted
        # *outside* ``_lock`` — the tracer has its own lock and must
        # never nest inside the bank's.
        self.obs = NULL_OBS

    # -- segment lookup ----------------------------------------------------

    def segment_of(self, t: int) -> int:
        t = int(t)
        if not 0 <= t < self.T:
            raise ValueError(f"timestep {t} outside schedule [0, {self.T})")
        return int(self._t_to_seg[t])

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    # -- weight materialization --------------------------------------------

    def is_cached(self, seg: int) -> bool:
        """Ready now — switching to ``seg`` pays no build stall at all."""
        with self._lock:
            return seg in self._cache

    def is_building(self, seg: int) -> bool:
        """Mid-build — a fetch would join the in-progress build and stall
        for part of a merge+pack (the slo scheduler prices this at half
        the cold-build estimate)."""
        with self._lock:
            return seg in self._building

    def params_for_t(self, t: int) -> dict:
        return self.params_for_segment(self.segment_of(t))

    def params_for_segment(self, seg: int) -> dict:
        build_fut = None
        with self._lock:
            if seg in self._cache:
                self.hits += 1
                if seg in self._prefetched:
                    self.prefetch_hits += 1
                    self._prefetched.discard(seg)
                self._cache.move_to_end(seg)
                return self._cache[seg]
            fut = self._building.get(seg)
            if fut is None:
                self.misses += 1
                build_fut = fut = Future()
                self._building[seg] = fut
            else:
                # join the in-progress build instead of building twice;
                # the stall is shorter than a cold build, so it scores as
                # a hit (and a prefetch_hit when a prefetch started it)
                self.hits += 1
                self.build_joins += 1
                if seg in self._prefetched:
                    self.prefetch_hits += 1
                    self._prefetched.discard(seg)
        if build_fut is not None:
            return self._build_install(seg, build_fut)
        return fut.result()

    def prefetch(self, seg: int, *, block: bool = True) -> bool:
        """Eagerly build + cache a segment before any request asks for it
        (the engine calls this when in-flight samplers are about to cross
        into segment ``seg``). Not counted as a miss; the later
        ``params_for_segment`` hit on it counts as a ``prefetch_hit``.

        ``block=False`` hands the build to a single background worker
        thread so the next segment merges/packs while the current
        segment's forwards run; ``block=True`` builds inline (the
        VirtualClock replay path — thread interleaving must not be able
        to change admission/batching). Returns False without building
        when the segment is already cached or already being built.
        """
        with self._lock:
            if seg in self._cache or seg in self._building:
                return False
            fut = Future()
            self._building[seg] = fut
            self.prefetches += 1
            self._prefetched.add(seg)
            if not block:
                # create + submit under the lock: a concurrent drain()
                # swaps the executor out under the same lock, so a build
                # can never be enqueued on a shut-down worker
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix="weight-bank-prefetch")
                self._executor.submit(self._build_install, seg, fut)
        if self.obs.enabled:
            self.obs.tracer.instant("prefetch", cat="bank",
                                    args={"seg": seg, "block": block})
        if block:
            self._build_install(seg, fut)
        return True

    def drain(self) -> None:
        """Wait for every in-progress build to install (stats like
        ``builds == misses + prefetches`` only reconcile at rest), then
        release the idle worker thread — the next non-blocking prefetch
        lazily recreates it, so long-lived processes that churn through
        banks don't accumulate parked executors."""
        while True:
            with self._lock:
                futs = list(self._building.values())
            if not futs:
                break
            for f in futs:
                try:
                    f.result()
                except Exception:        # surfaced to the build's owner
                    pass
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    def _build_install(self, seg: int, fut: Future) -> dict:
        """Build outside the lock, install under it, resolve the future.
        Only the thread that registered ``fut`` in ``_building`` runs
        this, so each registered build executes exactly once."""
        span = None
        if self.obs.enabled:
            # may run on the prefetch worker thread: the span lands on
            # that thread's track (tracer assigns tids per thread)
            span = self.obs.tracer.begin(
                "bank_build", cat="bank",
                args={"seg": seg,
                      "prefetch": seg in self._prefetched})
        try:
            params = self._build(self.segments[seg])
        except BaseException as e:
            with self._lock:
                self._building.pop(seg, None)
                self._prefetched.discard(seg)
                self.build_failures += 1
            if span is not None:
                span.args["error"] = repr(e)
                self.obs.tracer.end(span)
            fut.set_exception(e)
            raise
        if span is not None:
            self.obs.tracer.end(span)
        with self._lock:
            self._cache[seg] = params
            self._cache.move_to_end(seg)
            self._building.pop(seg, None)
            self.builds += 1
            self._trim()
        for cb in self.on_build:      # outside _lock, like the spans
            cb(self, seg)
        fut.set_result(params)
        return params

    def _trim(self) -> None:
        # caller holds self._lock
        while len(self._cache) > self.max_cached:
            evicted, _ = self._cache.popitem(last=False)
            self._prefetched.discard(evicted)
            self.evictions += 1

    def _build(self, seg: Segment) -> dict:
        """Merge (span ``merge``: the adapters' selection and
        ``talora.merge_into_tree``) then pack (span ``pack``), both inside
        ``_build_install``'s ``bank_build`` span with obs on."""
        obs = self.obs
        params = self.q_params
        if self.hubs and self.router is not None:
            if obs.enabled:
                span = obs.tracer.begin("merge", cat="bank")
            h = self.talora_cfg.hub_size
            sels = {name: F.one_hot(torch.tensor(seg.slots[i]), h).to(
                        self.device, torch.float32)
                    for i, name in enumerate(self.names)}
            params = talora.merge_into_tree(params, self.hubs, sels,
                                            self.talora_cfg)
            if obs.enabled:
                obs.tracer.end(span)
        if obs.enabled:
            span = obs.tracer.begin("pack", cat="bank")
        if self.build_fn is not None:
            packed = self.build_fn(params)
            flat = flatten_paths(packed)
            stats = {"packed": [k for k, v in flat.items()
                                if isinstance(v, PackedW4)],
                     "fallback": []}
        else:
            packed, stats = pack_param_tree(
                params, self.plan, fallback_dtype=self.fallback_dtype)
        if obs.enabled:
            obs.tracer.end(span)
        if self.pack_stats is None:
            self.pack_stats = stats
        return packed

    def describe(self) -> dict:
        d = {"segments": self.n_segments, "cached": len(self._cache),
             "max_cached": self.max_cached, "hits": self.hits,
             "misses": self.misses, "evictions": self.evictions,
             "hit_rate": self.hit_rate, "prefetches": self.prefetches,
             "prefetch_hits": self.prefetch_hits, "builds": self.builds,
             "build_joins": self.build_joins,
             "build_failures": self.build_failures}
        if self.pack_stats is not None:
            d["packed_sites"] = len(self.pack_stats["packed"])
            d["fallback_sites"] = len(self.pack_stats["fallback"])
        return d
