"""Multi-model gateway launcher: mixed-model traffic over per-model banks;
port of ``repro.launch.serve_gateway``.

Registers the requested models (``--models tiny-ddim,smollm-135m``) from
the gateway registry's curated entries, builds one engine + weight bank
per model — the diffusion preset through the same quantize/pack path as
``serve_diffusion`` (``build_quantized``, abs-max plan, the launcher's
TALoRA shaping), the LM through ``quantize_lm_for_serving`` via the
bank's ``build_fn`` seam — and drives a named traffic scenario through
one ``ServingGateway``. Runs on the card unless ``--device cpu`` is given:

    python -m repro_torch.launch.serve_gateway --smoke \\
        --models tiny-ddim,smollm-135m --scenario mixed_model --clock virtual

Clocks: ``--clock virtual`` replays deterministically (two runs of the
same scenario on one device print the same outcome digest); ``--clock
sim`` scores SLOs under simulated service time shared across every
engine; ``--clock wall`` is real timing on a shared origin.

Identity check: with a single diffusion model the gateway adds zero
behavior — ``--models tiny-ddim --scenario golden --clock virtual``
prints ``serve_diffusion``'s golden outcome digest on the same device and
``--image-size``.

The LM engine serves W4 abs-max weights with acts off and the config's
own KV cache (bf16), as the reference's builder does: on the card every
dense site runs K2's weight-only mode. The report (``--report-json``)
carries the reference's fields: per-model goodput/SLO verdicts, per-bank
counters with their reconciliation check (``builds + build_failures ==
misses + prefetches`` *per bank*), the aggregate outcome digest over
gateway-wide request ids, and per-model digests.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.common.clock import wall_clock
from repro_torch.common.device import resolve_device
from repro_torch.configs.diffusion_presets import DIFFUSION_PRESETS, tiny_ddim
from repro_torch.configs.registry import get_config
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.launch.serve_diffusion import (TALORA_CFG,
                                                _scenario_from_args,
                                                build_quantized,
                                                outcome_digest)
from repro_torch.launch.steps import quantize_lm_for_serving
from repro_torch.models.lm import lm_init
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank)
from repro_torch.serving.gateway import (LMServingEngine, ServingGateway,
                                         default_entries, default_registry)
from repro_torch.serving.obs import NULL_OBS, Observability
from repro_torch.serving.traffic import (MetricsCollector, SimClock,
                                         TraceWriter, list_scenarios,
                                         run_scenario)


def build_diffusion_engine(entry, args, eng_kw, obs, max_batch):
    """The exact quantize -> bank -> engine path ``serve_diffusion``
    takes with ``--plan absmax --act-quant fp4`` — same seed, same
    TALoRA shaping — so a single-model gateway run is digest-identical
    to the standalone launcher on the same device."""
    device = args.device
    cfg = (tiny_ddim(args.image_size) if entry.config == "tiny-ddim"
           else DIFFUSION_PRESETS[entry.config]())
    sched = make_schedule("linear", args.T)
    gen = torch.Generator().manual_seed(args.seed)
    params, plan, hubs, router = build_quantized(
        cfg, sched, gen, plan_mode="absmax", talora_cfg=TALORA_CFG,
        seed=args.seed, device=device)
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, args.T,
                      max_cached=args.bank_cap or entry.bank_cap,
                      device=device)
    act_qps = {"*": QuantizerParams(KIND_FP_SIGNED, 2, 1, 4,
                                    torch.tensor(6.0, device=device))}
    return DiffusionServingEngine(cfg, sched, bank, act_qps=act_qps,
                                  max_batch=max_batch, policy=args.policy,
                                  obs=obs, model=entry.name, device=device,
                                  **eng_kw)


def build_lm_engine(entry, args, eng_kw, obs, max_batch):
    """LM adapter path: init -> quantize_lm_for_serving (calibration-free
    abs-max W4) through the bank's build_fn seam; one weight segment."""
    device = args.device
    cfg = get_config(entry.config, smoke=entry.smoke)
    params = lm_init(torch.Generator().manual_seed(args.seed), cfg, device)
    bank = WeightBank(params, None, {}, None, None, 1,
                      max_cached=args.bank_cap or entry.bank_cap,
                      build_fn=lambda p: quantize_lm_for_serving(
                          p, searched=False), device=device)
    return LMServingEngine(cfg, bank, max_batch=max_batch,
                           policy=args.policy, obs=obs, model=entry.name,
                           device=device, **eng_kw)


BUILDERS = {"diffusion": build_diffusion_engine, "lm": build_lm_engine}


def build_gateway(model_names, args, obs=NULL_OBS, registry=None):
    """(gateway, sim_clock | None): registry-resolved engines behind one
    routing surface, all on one shared clock, on ``args.device``.
    ``registry`` defaults to ``default_registry()``."""
    registry = registry if registry is not None else default_registry()
    entries = [registry.resolve(n) for n in model_names]
    args.device = resolve_device(args.device)
    sim = None
    if args.clock == "virtual":
        clock = VirtualClock()
        gw = ServingGateway(clock=clock)
        eng_kw = {"clock": clock}
    elif args.clock == "sim":
        sim = SimClock()
        gw = ServingGateway(now_fn=sim.now, max_idle_sleep=0.0)
        eng_kw = {"now_fn": sim.now, "max_idle_sleep": 0.0}
    else:
        t0 = wall_clock()
        now_fn = lambda: wall_clock() - t0   # noqa: E731 — shared origin
        gw = ServingGateway(now_fn=now_fn)
        eng_kw = {"now_fn": now_fn}
    for entry in entries:
        mb = min(args.gateway_max_batch, entry.max_batch)
        engine = BUILDERS[entry.family](entry, args, eng_kw, obs, mb)
        if sim is not None:
            sim.attach(engine)
        gw.add_model(entry, engine)
    return gw, sim


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The reference's --kernels has no counterpart here: --device "
               "picks the CUDA kernels (cuda) or their plain versions (cpu).")
    ap.add_argument("--models", default="tiny-ddim,smollm-135m",
                    help="comma list of registered model names "
                         f"(registry: {[e.name for e in default_entries()]})")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None,
                     help="replay a recorded JSONL trace file (v1 files "
                          "route every request to the default model)")
    src.add_argument("--scenario", default="mixed_model",
                     choices=list_scenarios())
    ap.add_argument("--save-trace", default=None,
                    help="capture the run (gateway-wide rids + model "
                         "routing) to a v2 trace file")
    ap.add_argument("--clock", default="wall",
                    choices=["wall", "virtual", "sim"],
                    help="virtual: deterministic replay; sim: simulated "
                         "service time shared across models (machine-"
                         "independent SLOs); wall: real timing")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"])
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--steps-jitter", type=int, default=None)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--samplers", default=None)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="cap on any model engine's in-flight slots "
                         "(default: scenario hint; each entry's own "
                         "max_batch still applies)")
    ap.add_argument("--bank-cap", type=int, default=None,
                    help="override every bank's LRU cap (default: each "
                         "registry entry's)")
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--trace-out", default=None,
                    help="span trace (per-model tracks) — .json/.jsonl")
    ap.add_argument("--metrics-out", default=None,
                    help="metrics registry text exposition (per-model "
                         "labeled series)")
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
    if args.smoke:
        args.image_size = min(args.image_size, 8)
        args.T = min(args.T, 50)

    scn = _scenario_from_args(args)
    mb = args.max_batch if args.max_batch is not None else scn.max_batch
    if args.smoke:
        mb = min(mb, 2)
    args.gateway_max_batch = mb

    model_names = [s.strip() for s in args.models.split(",") if s.strip()]
    if not model_names:
        raise SystemExit("--models needs at least one registered name")

    obs = (Observability() if (args.trace_out or args.metrics_out
                               or args.report_json) else NULL_OBS)
    obs.install_kernels()
    t0 = wall_clock()
    gw, _sim = build_gateway(model_names, args, obs=obs)
    for name in gw.list_models():
        e = gw.engine(name)
        print(f"model {name}: {e.bank.n_segments} segments, "
              f"cap {e.bank.max_cached}, max_batch {e.batcher.max_batch}")
    print(f"gateway ready: {len(model_names)} models "
          f"({wall_clock() - t0:.1f}s) [clock={args.clock}, "
          f"policy={args.policy}, device={args.device}]")
    print(f"workload: {scn.name} — {scn.desc}")

    writer = None
    if args.save_trace:
        writer = TraceWriter(args.save_trace,
                             meta={"scenario": scn.name, "seed": args.seed,
                                   "models": model_names}).attach(gw)

    collector = MetricsCollector()
    try:
        summary = run_scenario(scn, gw, seed=args.seed, collector=collector)
    finally:
        obs.uninstall_kernels()
        if writer is not None:
            writer.close()
    if writer is not None:
        print(f"captured {writer.n} requests -> {args.save_trace}")

    for gid, rs in gw.results.items():
        if not rs.expired and not bool(torch.isfinite(
                torch.as_tensor(rs.x0)).all()):
            raise FloatingPointError(f"non-finite x0 gid={gid}")

    gs = gw.stats()
    agg = gs["aggregate"]
    digest = outcome_digest(gw.results)
    wall = summary["wall_s"]
    print(f"served {agg['requests']} requests ({agg['expired']} expired) "
          f"across {len(model_names)} models in {wall:.2f}s")
    per_model_digest = {}
    reconciled = {}
    for name in gw.list_models():
        p = gs["per_model"][name]
        bank = gw.engine(name).bank
        ok = (bank.builds + bank.build_failures
              == bank.misses + bank.prefetches)
        reconciled[name] = ok
        per_model_digest[name] = outcome_digest(gw.engine(name).results)
        slo = p["slo"]
        verdict = ("PASS" if slo["passed"] else "FAIL") if slo["checks"] \
            else "n/a"
        print(f"  {name} [{p['family']}]: "
              f"{p['engine']['requests']} done / "
              f"{p['engine']['expired']} expired, "
              f"goodput {p['summary']['goodput_frac']:.2f}, "
              f"p95 {p['summary']['p95_s']:.2f}s, SLO {verdict}; "
              f"bank {bank.builds} builds = {bank.misses} misses + "
              f"{bank.prefetches} prefetches "
              f"[{'reconciled' if ok else 'MISMATCH'}]")
        if not ok:
            raise RuntimeError(f"bank counters do not reconcile for {name}")
    print(f"outcome digest: {digest} ({len(gw.results)} requests)")

    for name in gw.list_models():
        obs.finalize(gw.engine(name), gw._models[name].collector)
    if args.trace_out:
        n = obs.tracer.export(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.metrics.to_text())
        print(f"metrics: -> {args.metrics_out}")
    report = {
        "scenario": scn.name,
        "models": model_names,
        "clock": args.clock,
        "policy": args.policy,
        "kernels": "cuda" if args.device.type == "cuda" else "plain",
        "seed": args.seed,
        "outcome_digest": digest,
        "n_requests": len(gw.results),
        "summary": {k: v for k, v in summary.items() if k != "slo"},
        "slo": summary["slo"],
        "aggregate": agg,
        "per_model": {
            name: {
                "digest": per_model_digest[name],
                "family": gs["per_model"][name]["family"],
                "goodput_frac":
                    gs["per_model"][name]["summary"]["goodput_frac"],
                "summary": gs["per_model"][name]["summary"],
                "slo": gs["per_model"][name]["slo"],
                "engine": gs["per_model"][name]["engine"],
                "bank_reconciled": reconciled[name],
            } for name in gw.list_models()},
        "obs": obs.metrics.snapshot() if obs.enabled else {},
    }
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True, default=float)
        print(f"report: -> {args.report_json}")
    return report


if __name__ == "__main__":
    main()
