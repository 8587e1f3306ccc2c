"""Diffusion serving launcher; port of ``repro.launch.serve_diffusion``.

Quantizes a UNet preset (random weights from ``--seed``) to real packed
FP4, TALoRA-merged per routing segment by the weight bank, and feeds the
continuous-batching engine either a recorded trace (``--trace``) or
``--requests N`` ddim requests of ``--steps`` steps all arriving at t=0.
Runs on the card unless ``--device cpu`` is given. Reports throughput,
latency, batching, weight-bank and route counts, plus the deterministic
outcome digest (two ``--replay-clock virtual`` replays of one trace print
the same digest on one device).

    PYTHONPATH=src python -m repro_torch.launch.serve_diffusion \\
        --preset ddim-cifar10 --trace tests/data/golden_trace.jsonl \\
        --replay-clock virtual
"""
from __future__ import annotations

import argparse
import bisect
import hashlib
import time

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import DIFFUSION_PRESETS, tiny_ddim
from repro_torch.core import talora
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels import ops
from repro_torch.nn.unet import io_sites, unet_init
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, absmax_talora_setup)
from repro_torch.serving.traffic.metrics import percentile
from repro_torch.serving.traffic.trace import load_trace, submit_trace

TALORA_CFG = talora.TALoRAConfig(hub_size=2, rank=4, t_emb_dim=32,
                                 router_hidden=16)


def outcome_digest(results) -> str:
    """Digest of per-request outcomes (step counts, expiry, final latents)."""
    h = hashlib.sha256()
    for rid in sorted(results):
        rs = results[rid]
        h.update(f"{rid}:{rs.n_evals}:{int(rs.expired)}".encode())
        if rs.x0 is not None:
            h.update(rs.x0.detach().to("cpu", torch.float32).numpy().tobytes())
    return h.hexdigest()[:16]


class RunRecorder:
    """Completion/expiry events and queue depth over one run (the subset of
    the reference's ``MetricsCollector`` this launcher reports)."""

    def __init__(self, engine):
        self.latencies: list[float] = []
        self.n_met = self.n_events = self.n_expired = 0
        self.peak_queue = 0
        engine.on_complete.append(self._complete)
        engine.on_expire.append(self._expire)
        engine.on_tick_end.append(self._tick)

    def _complete(self, rs):
        self.n_events += 1
        self.latencies.append(rs.latency)
        dl = rs.req.deadline
        self.n_met += dl is None or rs.finished_at <= dl

    def _expire(self, rs):
        self.n_events += 1
        self.n_expired += 1

    def _tick(self, engine):
        now = engine.now()
        queued = bisect.bisect_right(engine.batcher.pending, now,
                                     key=lambda rs: rs.req.arrival)
        self.peak_queue = max(self.peak_queue, queued)

    def summary(self) -> dict:
        lat = sorted(self.latencies)
        return {"requests": len(lat), "expired": self.n_expired,
                "deadline_misses": self.n_events - self.n_met,
                "goodput_frac": (self.n_met / self.n_events
                                 if self.n_events else 1.0),
                "p50_s": percentile(lat, 50), "p95_s": percentile(lat, 95),
                "p99_s": percentile(lat, 99),
                "peak_queue_depth": self.peak_queue}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-ddim",
                    choices=sorted(DIFFUSION_PRESETS))
    ap.add_argument("--image-size", type=int, default=16,
                    help="tiny-ddim only; other presets fix their size")
    ap.add_argument("--T", type=int, default=100, help="schedule length")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None,
                     help="replay a recorded JSONL trace file")
    src.add_argument("--requests", type=int, default=None,
                     help="N ddim requests arriving at t=0 (default 4)")
    ap.add_argument("--steps", type=int, default=10,
                    help="sampler steps per --requests request")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="in-flight slots")
    ap.add_argument("--replay-clock", default="wall",
                    choices=["wall", "virtual"],
                    help="virtual: deterministic admission/batching; "
                         "wall: real latencies")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"])
    ap.add_argument("--bank-cap", type=int, default=4,
                    help="LRU cap on cached segment weight-sets")
    ap.add_argument("--act-quant", default="fp4", choices=["off", "fp4"],
                    help="fp4 = fuse E2M1 act quant into packed matmuls")
    ap.add_argument("--act-maxval", type=float, default=6.0)
    ap.add_argument("--conv-route", default="auto",
                    choices=["auto", "implicit", "im2col"],
                    help="packed conv route: implicit-GEMM kernel "
                         "(implicit; auto is the same) or unfold + matmul "
                         "kernel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ops.CONV_ROUTE = ("implicit" if args.conv_route == "auto"
                      else args.conv_route)

    cfg = (tiny_ddim(args.image_size) if args.preset == "tiny-ddim"
           else DIFFUSION_PRESETS[args.preset]())
    sched = make_schedule("linear", args.T)
    gen = torch.Generator().manual_seed(args.seed)

    t0 = time.perf_counter()
    params = unet_init(gen, cfg, device)
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=io_sites(params))
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, args.T,
                      max_cached=args.bank_cap, device=device)
    act_qps = {}
    if args.act_quant == "fp4":
        act_qps["*"] = QuantizerParams(
            KIND_FP_SIGNED, 2, 1, 4,
            torch.tensor(args.act_maxval, device=device))
    clock = VirtualClock() if args.replay_clock == "virtual" else None
    engine = DiffusionServingEngine(cfg, sched, bank, act_qps=act_qps,
                                    max_batch=args.max_batch, clock=clock,
                                    policy=args.policy, device=device)
    print(f"bank ready: {bank.n_segments} routing segments, plan=absmax, "
          f"device={device} ({time.perf_counter() - t0:.1f}s)")

    if args.trace:
        reqs, _ = load_trace(args.trace)
        workload = f"trace:{args.trace} ({len(reqs)} requests)"
    else:
        n = 4 if args.requests is None else args.requests
        reqs = None
        workload = f"{n} ddim requests x {args.steps} steps at t=0"
    print(f"workload: {workload} [clock={args.replay_clock}, "
          f"policy={args.policy}, max_batch={args.max_batch}]")

    rec = RunRecorder(engine)
    t_run = time.perf_counter()
    if reqs is not None:
        submit_trace(engine, reqs)
    else:
        for i in range(n):
            engine.submit(steps=args.steps, seed=args.seed + i)
    results = engine.run()
    wall = time.perf_counter() - t_run
    for rs in results.values():
        if not rs.expired and not bool(torch.isfinite(rs.x0).all()):
            raise FloatingPointError(f"non-finite x0 rid={rs.req.rid}")

    summary = rec.summary()
    s = engine.stats()
    evals = sum(rs.n_evals for rs in results.values())
    print(f"served {summary['requests']} requests "
          f"({summary['expired']} expired) in {wall:.2f}s "
          f"({summary['requests'] / max(wall, 1e-9):.2f} req/s, "
          f"{evals / max(wall, 1e-9):.1f} denoise evals/s)")
    print(f"latency p50={summary['p50_s']:.2f}s p95={summary['p95_s']:.2f}s "
          f"p99={summary['p99_s']:.2f}s  goodput={summary['goodput_frac']:.2f} "
          f"({summary['deadline_misses']} deadline misses)")
    print(f"batching: mean batch {s['mean_batch']:.2f} "
          f"({s['forwards']} forwards / {s['ticks']} ticks), "
          f"peak queue depth {summary['peak_queue_depth']}")
    print(f"scheduler: policy={s['policy']}, {s['preemptions']} preemptions, "
          f"{s['deadline_saves']} deadline saves")
    print(f"weight bank: hit rate {s['bank_hit_rate']:.2f} "
          f"({s['bank_hits']} hits / {s['bank_misses']} misses, "
          f"{s['bank_evictions']} evictions, cap {args.bank_cap}), "
          f"{s['prefetch_hits']} prefetch hits / {s['bank_prefetches']} "
          f"prefetches, {s['bank_builds']} builds "
          f"({s['bank_build_joins']} joined in-progress), "
          f"{s['bank_packed_sites']} packed / "
          f"{s['bank_fallback_sites']} bf16-fallback sites")
    print(f"forward shapes: {s['compiled_forwards']} "
          f"(buckets {s['buckets']}), {s['padded_samples']} padded samples, "
          f"{s['idle_sleeps']} idle sleeps")

    # every even-width non-io conv weight must serve packed (the W4A4 conv
    # kernels), never from the bf16 fallback bucket
    flat_q = flatten_paths(params)
    conv_w = [k for k, v in flat_q.items()
              if k.endswith("/w") and getattr(v, "ndim", 0) == 4]
    packed_sites = set(bank.pack_stats["packed"])
    n_conv_packed = sum(k in packed_sites for k in conv_w)
    print(f"conv sites: {n_conv_packed}/{len(conv_w)} packed (W4A4 conv route)")
    missing = [k for k in conv_w if k not in io_sites(params)
               and flat_q[k].shape[-1] % 2 == 0 and k not in packed_sites]
    if missing:
        raise RuntimeError(f"conv sites fell back to bf16: {missing}")
    routes = ", ".join(f"{op}/{route}={n}"
                       for (op, route), n in sorted(ops.ROUTES.items()))
    print(f"routes: {routes}")
    digest = outcome_digest(results)
    print(f"outcome digest: {digest} "
          f"({len(results)} requests, {summary['expired']} expired)")
    return {"summary": summary, "engine": s, "wall_s": wall, "evals": evals,
            "digest": digest}


if __name__ == "__main__":
    main()
