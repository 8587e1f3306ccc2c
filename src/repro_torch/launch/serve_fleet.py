"""Multi-host fleet launcher: N replica engines behind one router; port of
``repro.launch.serve_fleet``.

Builds the ``serve_diffusion`` quantize -> bank -> engine path **once**
(one merge/pack plan shared read-only across the fleet), instantiates N
replicas each with its *own* ``WeightBank`` LRU, and drives a traffic
scenario through a ``FleetRouter`` under a placement policy. Runs on the
card unless ``--device cpu`` is given:

    python -m repro_torch.launch.serve_fleet --smoke \\
        --replicas 2 --placement affinity --scenario deadline_mix --clock sim

Placements: ``rr`` (round-robin), ``least_loaded`` (queue depth +
in-flight padded rows), ``affinity`` (segment-affinity against each
replica's bank contents; the policy the fleet exists for).

Clocks: ``--clock virtual`` replays deterministically on one shared
clock; ``--clock sim`` gives each replica its *own* simulated service
axis (parallel hosts — replica sweeps show real scaling) with
``--build-s`` charging every cold segment build, which is what makes
placement quality visible in goodput; ``--clock wall`` is real timing
on a shared origin (on one card the replicas share it: placement shows,
scaling does not).

Identity check: ``--replicas 1 --placement rr --scenario golden --clock
virtual`` prints ``serve_diffusion``'s golden outcome digest on the same
device, ``--preset tiny-ddim`` and ``--image-size`` — the fleet layer
adds zero behavior at N=1.

The report (``--report-json``) carries the placement-decision
histogram, pooled + per-replica bank counters with reconciliation,
per-replica goodput, and the aggregate outcome digest over fleet gids.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.common.clock import wall_clock
from repro_torch.common.device import resolve_device
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.launch.serve_diffusion import (TALORA_CFG,
                                                _scenario_from_args,
                                                build_quantized,
                                                outcome_digest)
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank)
from repro_torch.serving.fleet import PLACEMENTS, FleetRouter
from repro_torch.serving.obs import NULL_OBS, Observability
from repro_torch.serving.traffic import (MetricsCollector, SimClock,
                                         TraceWriter, list_scenarios,
                                         run_scenario)

PLACEMENT_ALIASES = {"rr": "round_robin", "affinity": "segment_affinity",
                     **{p: p for p in PLACEMENTS}}


def build_fleet(args, obs=NULL_OBS, cfg=None):
    """(router, [sim_clocks]): one quantize pass, N banks/engines on
    ``args.device``. ``cfg`` defaults to ``tiny_ddim(args.image_size)``,
    the launcher's model."""
    device = args.device = resolve_device(args.device)
    cfg = cfg if cfg is not None else tiny_ddim(args.image_size)
    sched = make_schedule("linear", args.T)
    gen = torch.Generator().manual_seed(args.seed)
    q_params, plan, hubs, router = build_quantized(
        cfg, sched, gen, plan_mode="absmax", talora_cfg=TALORA_CFG,
        seed=args.seed, device=device)
    act_qps = {"*": QuantizerParams(KIND_FP_SIGNED, 2, 1, 4,
                                    torch.tensor(6.0, device=device))}

    placement = PLACEMENT_ALIASES[args.placement]
    sims: list[SimClock] = []
    if args.clock == "virtual":
        clock = VirtualClock()
        fleet = FleetRouter(placement=placement, clock=clock, obs=obs)
        eng_kw_for = lambda i: {"clock": clock}             # noqa: E731
    elif args.clock == "sim":
        # per-replica clocks: each host charges compute on its own
        # parallel axis; the router's fleet clock is their minimum
        fleet = FleetRouter(placement=placement, max_idle_sleep=0.0,
                            obs=obs)
        sims = [SimClock(build_s=args.build_s)
                for _ in range(args.replicas)]
        eng_kw_for = lambda i: {"now_fn": sims[i].now,       # noqa: E731
                                "max_idle_sleep": 0.0}
    else:
        t0 = wall_clock()
        now_fn = lambda: wall_clock() - t0   # noqa: E731 — shared origin
        fleet = FleetRouter(placement=placement, now_fn=now_fn, obs=obs)
        eng_kw_for = lambda i: {"now_fn": now_fn}           # noqa: E731

    for i in range(args.replicas):
        bank = WeightBank(q_params, plan, hubs, router, TALORA_CFG, args.T,
                          max_cached=args.bank_cap, device=device)
        engine = DiffusionServingEngine(
            cfg, sched, bank, act_qps=act_qps,
            max_batch=args.fleet_max_batch, policy=args.policy, obs=obs,
            device=device, **eng_kw_for(i))
        if sims:
            sims[i].attach(engine)
        fleet.add_replica(engine)
    return fleet, sims


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The reference's --kernels has no counterpart here: --device "
               "picks the CUDA kernels (cuda) or their plain versions (cpu).")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--placement", default="affinity",
                    choices=sorted(PLACEMENT_ALIASES),
                    help="rr=round_robin, affinity=segment_affinity")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None,
                     help="replay a recorded JSONL trace file")
    src.add_argument("--scenario", default="deadline_mix",
                     choices=list_scenarios())
    ap.add_argument("--save-trace", default=None,
                    help="capture the run (fleet gids) to a trace file")
    ap.add_argument("--clock", default="sim",
                    choices=["wall", "virtual", "sim"],
                    help="virtual: deterministic replay on one shared "
                         "clock; sim: one simulated service axis per "
                         "replica (parallel hosts, machine-independent "
                         "SLOs); wall: real timing")
    ap.add_argument("--build-s", type=float, default=0.3,
                    help="simulated seconds charged per cold bank build "
                         "(sim clock only) — the cost affinity routing "
                         "avoids paying once per replica")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"])
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--steps-jitter", type=int, default=None)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--samplers", default=None)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="per-replica in-flight slots "
                         "(default: scenario hint)")
    ap.add_argument("--bank-cap", type=int, default=2,
                    help="per-replica bank LRU cap; below the segment "
                         "count so placement decides what stays warm")
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--trace-out", default=None,
                    help="span trace (per-replica tracks + router "
                         "route instants) — .json/.jsonl")
    ap.add_argument("--metrics-out", default=None,
                    help="metrics registry text exposition "
                         "({replica=...} labeled series)")
    ap.add_argument("--report-json", default=None,
                    help="machine-readable run report")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny everything (CI shaping)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.smoke:
        args.image_size = min(args.image_size, 8)
        args.T = min(args.T, 50)

    scn = _scenario_from_args(args)
    mb = args.max_batch if args.max_batch is not None else scn.max_batch
    if args.smoke:
        mb = min(mb, 2)
    args.fleet_max_batch = mb

    obs = (Observability() if (args.trace_out or args.metrics_out
                               or args.report_json) else NULL_OBS)
    obs.install_kernels()
    t0 = wall_clock()
    fleet, _sims = build_fleet(args, obs=obs)
    bank0 = fleet.replicas[0].bank
    print(f"fleet ready: {args.replicas} replicas "
          f"({wall_clock() - t0:.1f}s) [placement={fleet.placement}, "
          f"clock={args.clock}, policy={args.policy}, device={args.device}; "
          f"{bank0.n_segments} segments/bank, cap {bank0.max_cached}, "
          f"max_batch {mb}]")
    print(f"workload: {scn.name} — {scn.desc}")

    writer = None
    if args.save_trace:
        writer = TraceWriter(args.save_trace,
                             meta={"scenario": scn.name, "seed": args.seed,
                                   "replicas": args.replicas,
                                   "placement": fleet.placement}
                             ).attach(fleet)

    collector = MetricsCollector()
    try:
        summary = run_scenario(scn, fleet, seed=args.seed,
                               collector=collector)
    finally:
        obs.uninstall_kernels()
        if writer is not None:
            writer.close()
    if writer is not None:
        print(f"captured {writer.n} requests -> {args.save_trace}")

    for gid, rs in fleet.results.items():
        if not rs.expired and not bool(torch.isfinite(rs.x0).all()):
            raise FloatingPointError(f"non-finite x0 gid={gid}")

    fs = fleet.stats()
    agg = fs["aggregate"]
    digest = outcome_digest(fleet.results)
    print(f"served {agg['requests']} requests ({agg['expired']} expired) "
          f"across {args.replicas} replicas in {summary['wall_s']:.2f}s; "
          f"pooled bank hit rate {agg['bank_hit_rate']:.2f}, "
          f"placements {agg['placement_reasons']}")
    reconciled = {}
    for rep in fleet.replicas:
        p = fs["per_replica"][rep.name]
        bank = rep.bank
        ok = (bank.builds + bank.build_failures
              == bank.misses + bank.prefetches)
        reconciled[rep.name] = ok
        print(f"  {rep.name}: {p['engine']['requests']} done / "
              f"{p['engine']['expired']} expired, "
              f"{p['placed']} placed, "
              f"goodput {p['summary']['goodput_frac']:.2f}, "
              f"bank {bank.builds} builds = {bank.misses} misses + "
              f"{bank.prefetches} prefetches "
              f"[{'reconciled' if ok else 'MISMATCH'}]")
        if not ok:
            raise RuntimeError(f"bank counters do not reconcile for "
                               f"{rep.name}")
    print(f"outcome digest: {digest} ({len(fleet.results)} requests)")

    for rep in fleet.replicas:
        obs.finalize(rep.engine, rep.collector)
    if args.trace_out:
        n = obs.tracer.export(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.metrics.to_text())
        print(f"metrics: -> {args.metrics_out}")
    report = {
        "scenario": scn.name,
        "replicas": args.replicas,
        "placement": fleet.placement,
        "clock": args.clock,
        "build_s": args.build_s if args.clock == "sim" else None,
        "policy": args.policy,
        "kernels": "cuda" if args.device.type == "cuda" else "plain",
        "seed": args.seed,
        "outcome_digest": digest,
        "n_requests": len(fleet.results),
        "summary": {k: v for k, v in summary.items() if k != "slo"},
        "slo": summary["slo"],
        "aggregate": agg,
        "per_replica": {
            rep.name: {
                "goodput_frac":
                    fs["per_replica"][rep.name]["summary"]["goodput_frac"],
                "summary": fs["per_replica"][rep.name]["summary"],
                "engine": fs["per_replica"][rep.name]["engine"],
                "placed": fs["per_replica"][rep.name]["placed"],
                "bank_reconciled": reconciled[rep.name],
            } for rep in fleet.replicas},
        "obs": obs.metrics.snapshot() if obs.enabled else {},
    }
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True, default=float)
        print(f"report: -> {args.report_json}")
    return report


if __name__ == "__main__":
    main()
