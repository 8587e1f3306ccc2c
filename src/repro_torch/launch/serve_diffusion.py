"""Diffusion serving launcher: trace replay / scenario runs on the engine;
port of ``repro.launch.serve_diffusion``.

Quantizes a UNet preset (random weights from ``--seed``) to real packed
FP4, TALoRA-merged per routing segment by the weight bank, then feeds the
continuous-batching engine one of:

  * ``--trace file.jsonl``  — replay a recorded/generated trace file,
  * ``--scenario name``     — a named workload from the traffic registry
    (``steady`` | ``burst`` | ``diurnal`` | ``heavy_tail`` |
    ``closed_loop`` | ``deadline_mix`` | ``tight_deadlines`` | ``golden``
    | ``mixed_model`` | ``per_model_slo``; default steady; this engine
    serves every request of the two-model scenarios itself),

and reports sliding-window + whole-run SLO metrics (throughput, latency
percentiles from arrival, goodput vs per-request deadlines, queue depth,
segment-cache and prefetch behavior), the dispatch routes, plus a
deterministic outcome digest — two replays of the same trace under
``--replay-clock virtual`` on one device print the same digest. Runs on
the card unless ``--device cpu`` is given; on the CPU every kernel wrapper
takes its plain PyTorch version.

    PYTHONPATH=src python -m repro_torch.launch.serve_diffusion \\
        --preset ddim-cifar10 --scenario deadline_mix --policy slo

``--requests N`` overrides the scenario's open-loop request count (N
arrivals of its generator, not N requests at t=0: write those as a trace
and replay it with ``--trace``). ``--policy slo`` swaps the
largest-group-wins scheduler for the slack-aware one. ``--save-trace
out.jsonl`` captures whatever workload actually ran back into a
replayable trace.

``--preset sd15`` serves Stable Diffusion v1.5's text-to-image UNet on its
``scaled_linear`` schedule: each request's text context is drawn from its
seed (the text encoder is not served), and each runs guided at
``--guidance-scale`` (default 7.5), its uncond and cond rows in one
forward.

``--plan absmax`` (the default) builds the calibration-free abs-max FP4
plan; ``--plan search`` runs the paper's calibrate + MSE-search pipeline
first (``diffusion.pipeline.quantize_diffusion``: 4 FP trajectories of 8
x 20 steps, 8 calibration forwards, every site searched) and serves its
searched 4-bit formats through the kernels. The pipeline's own dispatch
routes print on a line of their own, and ``routes:`` counts the serve
run's.

Observability (``serving/obs``) switches on when any of ``--trace-out``
(Perfetto-loadable span trace), ``--metrics-out`` (text exposition of the
metrics registry) or ``--report-json`` (machine-readable run report:
summary, SLO verdict, engine stats, kernel route counts, outcome digest)
is given; otherwise the engine runs with the no-op ``NULL_OBS``, which
records nothing and opens no profiler range. The span trace follows the
engine clock, so a virtual-clock replay's trace is deterministic; each
span (the tick, its phases, a bank build's merge and pack) is also a
``torch.profiler`` range on the profiler's clock, for a run under the
profiler or ``emit_nvtx``. With obs on, the kernel profiler times each
dispatch (CUDA events on the card) into ``kernel_call_seconds``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json

import numpy as np
import torch

from repro_torch.common.clock import wall_clock
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import (DIFFUSION_PRESETS,
                                                   SCHEDULES, tiny_ddim)
from repro_torch.core import talora
from repro_torch.diffusion.pipeline import quantize_diffusion
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels import ops
from repro_torch.nn.unet import io_sites, unet_init
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, absmax_talora_setup,
                                 act_qps_from_plan)
from repro_torch.serving.obs import NULL_OBS, Observability
from repro_torch.serving.traffic import (MetricsCollector, Scenario,
                                         TraceWriter, get_scenario,
                                         list_scenarios, run_scenario)

TALORA_CFG = talora.TALoRAConfig(hub_size=2, rank=4, t_emb_dim=32,
                                 router_hidden=16)

# a text preset's context: CLIP's 77 tokens, and the seed of the null
# prompt's (a request's own is drawn from the request's seed)
CONTEXT_TOKENS = 77
NULL_CONTEXT_SEED = -1


def drawn_context(seed: int, context_dim: int) -> torch.Tensor:
    """A (CONTEXT_TOKENS, context_dim) f32 text context drawn from
    ``seed`` on a CPU generator (seeded by a 32-bit hash of ``seed``, a
    stream apart from the request's x_T): what stands in for a prompt's
    encoding, since the text encoder is not served."""
    gen = torch.Generator().manual_seed(
        (seed * 0x9E3779B1 + 0x7F4A7C15) % 2**32)
    return torch.randn((CONTEXT_TOKENS, context_dim), generator=gen)


def text_submit(submit, context_dim: int, guidance_scale: float):
    """``submit`` of a text preset's engine as the workload drives it:
    every request guided at ``guidance_scale`` (0: unguided), with the
    context drawn from its seed."""
    def submit_text(*, seed: int = 0, **kw):
        kw["guidance_scale"] = guidance_scale
        return submit(seed=seed, context=drawn_context(seed, context_dim),
                      **kw)
    return submit_text


def build_quantized(cfg, sched, gen: torch.Generator, *, plan_mode: str,
                    talora_cfg, seed: int, device):
    """(params, plan, hubs, router) for the weight bank: the random UNet
    with the abs-max plan, or (``search``) the pipeline's fake-quantized
    tree with its searched plan and fresh TALoRA hubs and router."""
    params = unet_init(gen, cfg, device)
    if plan_mode == "search":
        bundle = quantize_diffusion(params, cfg, sched, seed=seed,
                                    talora_cfg=talora_cfg)
        return bundle.q_params, bundle.plan, bundle.hubs, bundle.router
    plan, hubs, router = absmax_talora_setup(params, talora_cfg, gen,
                                             io_sites=io_sites(params))
    return params, plan, hubs, router


def _routes_line() -> str:
    return ", ".join(f"{op}/{route}={n}"
                     for (op, route), n in sorted(ops.ROUTES.items()))


def outcome_digest(results) -> str:
    """Digest of per-request outcomes (step counts, expiry, final results:
    a diffusion request's latents, an LM request's token ids), each result
    hashed as its float32 bytes, as the reference hashes
    ``np.asarray(x0, np.float32)``."""
    h = hashlib.sha256()
    for rid in sorted(results):
        rs = results[rid]
        h.update(f"{rid}:{rs.n_evals}:{int(rs.expired)}".encode())
        if rs.x0 is not None:
            x0 = (rs.x0.detach().to("cpu", torch.float32).numpy()
                  if isinstance(rs.x0, torch.Tensor) else rs.x0)
            h.update(np.asarray(x0, np.float32).tobytes())
    return h.hexdigest()[:16]


def _warn_ignored_shaping(args) -> None:
    ignored = [f for f, v in (("--steps", args.steps),
                              ("--steps-jitter", args.steps_jitter),
                              ("--eta", args.eta),
                              ("--samplers", args.samplers),
                              ("--requests", args.requests),
                              ("--rate", args.rate)) if v is not None]
    if ignored:
        print(f"note: {', '.join(ignored)} ignored — a trace replays its "
              "recorded requests verbatim")


def _scenario_from_args(args) -> Scenario:
    if args.trace:
        _warn_ignored_shaping(args)
        return Scenario(name=f"trace:{args.trace}", kind="trace",
                        desc="ad-hoc trace replay", trace_path=args.trace)
    scn = get_scenario(args.scenario)
    if scn.kind == "trace":        # e.g. the golden fixture scenario
        _warn_ignored_shaping(args)
        return scn
    mix = scn.mix
    if args.steps is not None:
        mix = dataclasses.replace(mix, steps=args.steps)
    if args.steps_jitter is not None:
        mix = dataclasses.replace(mix, steps_jitter=args.steps_jitter)
    if args.eta is not None:
        mix = dataclasses.replace(mix, eta=args.eta)
    if args.samplers is not None:
        mix = dataclasses.replace(mix, samplers=tuple(
            args.samplers.split(",")))
    scn = dataclasses.replace(scn, mix=mix)
    if args.requests is not None:
        scn = dataclasses.replace(scn, n_requests=args.requests)
    if args.rate is not None and scn.kind == "open":
        kw = dict(scn.gen_kw)
        if "rate" in kw:
            kw["rate"] = args.rate
            scn = dataclasses.replace(scn, gen_kw=tuple(kw.items()))
        else:
            print(f"note: --rate ignored for generator {scn.gen!r} "
                  f"(tune {sorted(kw)} via the registry)")
    if args.smoke and scn.kind != "trace":
        scn = dataclasses.replace(
            scn, n_requests=min(scn.n_requests, 2), n_users=2,
            requests_per_user=1,
            mix=dataclasses.replace(scn.mix, steps=min(scn.mix.steps, 3),
                                    steps_jitter=min(scn.mix.steps_jitter,
                                                     1)))
    return scn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The reference's --kernels (Pallas, interpret or XLA) has no "
               "counterpart here: the port has no Pallas or interpret mode; "
               "--device picks the CUDA kernels (cuda) or their plain "
               "versions (cpu).")
    ap.add_argument("--preset", default="tiny-ddim",
                    choices=sorted(DIFFUSION_PRESETS))
    ap.add_argument("--image-size", type=int, default=16,
                    help="tiny-ddim only; other presets fix their size")
    ap.add_argument("--T", type=int, default=100, help="schedule length")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None,
                     help="replay a recorded JSONL trace file")
    src.add_argument("--scenario", default="steady",
                     choices=list_scenarios(),
                     help="named workload from the traffic registry")
    ap.add_argument("--save-trace", default=None,
                    help="capture the run's submissions to a trace file")
    ap.add_argument("--replay-clock", default="wall",
                    choices=["wall", "virtual"],
                    help="virtual: deterministic admission/batching "
                         "(replay checks); wall: real SLO timing")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"],
                    help="group selection: fifo = largest-group-wins "
                         "baseline; slo = slack-aware EDF vs segment-"
                         "switch cost with preemptive group splits")
    ap.add_argument("--sync-prefetch", action="store_true",
                    help="build prefetched segments inline instead of on "
                         "the bank's background thread (virtual-clock "
                         "replay is always synchronous)")
    ap.add_argument("--requests", type=int, default=None,
                    help="override the scenario's open-loop request count")
    ap.add_argument("--rate", type=float, default=None,
                    help="override the scenario's arrival rate (req/s), "
                         "generators with a 'rate' knob only")
    ap.add_argument("--steps", type=int, default=None,
                    help="override base sampler steps per request")
    ap.add_argument("--steps-jitter", type=int, default=None)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--samplers", default=None,
                    help="comma list cycled across requests "
                         "(ddim,plms,dpm_solver2)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="in-flight slots (default: the scenario's "
                         "max_batch hint)")
    ap.add_argument("--max-idle-sleep", type=float, default=0.25,
                    help="cap (s) on one idle sleep while waiting for the "
                         "next arrival")
    ap.add_argument("--metrics-window", type=float, default=1.0,
                    help="sliding-window width (s) for the metrics report")
    ap.add_argument("--bank-cap", type=int, default=4,
                    help="LRU cap on cached segment weight-sets")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable eager next-segment weight-bank builds")
    ap.add_argument("--plan", default="absmax", choices=["absmax", "search"],
                    help="absmax: the calibration-free abs-max FP4 plan; "
                         "search: the paper's calibrate + MSFP search "
                         "(diffusion.pipeline.quantize_diffusion) first, "
                         "its 4-bit act sites fused into the kernels")
    ap.add_argument("--act-quant", default="fp4", choices=["off", "fp4"],
                    help="fp4 = fuse E2M1 act quant into packed matmuls")
    ap.add_argument("--act-maxval", type=float, default=6.0)
    ap.add_argument("--guidance-scale", type=float, default=7.5,
                    help="text-conditioned presets: the classifier-free "
                         "guidance scale of every request (0: unguided)")
    ap.add_argument("--conv-route", default="auto",
                    choices=["auto", "implicit", "im2col"],
                    help="packed conv route: implicit-GEMM kernel "
                         "(implicit; auto is the same) or unfold + matmul "
                         "kernel")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's span trace here: .json = Chrome "
                         "trace-event format (open in Perfetto / "
                         "chrome://tracing), .jsonl = one event per line")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry's text exposition "
                         "(Prometheus-style) here at run end")
    ap.add_argument("--report-json", default=None,
                    help="write a machine-readable run report (summary, "
                         "SLO verdict, engine stats, kernel route counts, "
                         "obs counters, outcome digest) here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny everything (2 concurrent requests)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ops.CONV_ROUTE = ("implicit" if args.conv_route == "auto"
                      else args.conv_route)
    if args.smoke:
        args.image_size = min(args.image_size, 8)
        args.T = min(args.T, 50)

    scn = _scenario_from_args(args)
    max_batch = (args.max_batch if args.max_batch is not None
                 else scn.max_batch)
    if args.smoke:
        max_batch = min(max_batch, 2)

    cfg = (tiny_ddim(args.image_size) if args.preset == "tiny-ddim"
           else DIFFUSION_PRESETS[args.preset]())
    sched = make_schedule(SCHEDULES.get(args.preset, "linear"), args.T)
    gen = torch.Generator().manual_seed(args.seed)

    t0 = wall_clock()
    params, plan, hubs, router = build_quantized(
        cfg, sched, gen, plan_mode=args.plan, talora_cfg=TALORA_CFG,
        seed=args.seed, device=device)
    if args.plan == "search":
        # the pipeline's FP forwards (dense f32 weights, as the reference's
        # lax.conv): reported apart, so that ``routes:`` is the serve run's
        print(f"pipeline routes: {_routes_line()}")
        ops.reset_routes()
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, args.T,
                      max_cached=args.bank_cap, device=device)
    act_qps = act_qps_from_plan(plan) if args.plan == "search" else {}
    if args.act_quant == "fp4":
        act_qps.setdefault("*", QuantizerParams(
            KIND_FP_SIGNED, 2, 1, 4,
            torch.tensor(args.act_maxval, device=device)))
    else:
        act_qps = {}
    clock = VirtualClock() if args.replay_clock == "virtual" else None
    null_context = (drawn_context(NULL_CONTEXT_SEED, cfg.context_dim)
                    if cfg.context_dim else None)
    obs = (Observability() if (args.trace_out or args.metrics_out
                               or args.report_json) else NULL_OBS)
    obs.install_kernels()
    engine = DiffusionServingEngine(cfg, sched, bank, act_qps=act_qps,
                                    max_batch=max_batch, clock=clock,
                                    policy=args.policy,
                                    max_idle_sleep=args.max_idle_sleep,
                                    prefetch=not args.no_prefetch,
                                    async_prefetch=not args.sync_prefetch,
                                    obs=obs, device=device,
                                    null_context=null_context)
    if cfg.context_dim:
        engine.submit = text_submit(engine.submit, cfg.context_dim,
                                    args.guidance_scale)
    print(f"bank ready: {bank.n_segments} routing segments, plan={args.plan}, "
          f"device={device} ({wall_clock() - t0:.1f}s)")
    print(f"workload: {scn.name} — {scn.desc} [clock={args.replay_clock}, "
          f"policy={args.policy}, max_batch={max_batch}]")

    writer = None
    if args.save_trace:
        writer = TraceWriter(args.save_trace,
                             meta={"scenario": scn.name,
                                   "seed": args.seed}).attach(engine)

    collector = MetricsCollector(window_s=args.metrics_window)
    try:
        summary = run_scenario(scn, engine, seed=args.seed,
                               collector=collector)
    finally:
        obs.uninstall_kernels()
        if writer is not None:
            writer.close()
    if writer is not None:
        print(f"captured {writer.n} requests -> {args.save_trace}")
    results = engine.results
    for rs in results.values():
        if not rs.expired and not bool(torch.isfinite(rs.x0).all()):
            raise FloatingPointError(f"non-finite x0 rid={rs.req.rid}")

    s = engine.stats()
    evals = sum(rs.n_evals for rs in results.values())
    wall = summary["wall_s"]
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
    for row in collector.windows()[:8]:
        hr = row.get("cache_hit_rate")
        print(f"  window t={row['t']:5.1f}s: {row['throughput_rps']:6.2f} "
              f"req/s, p95 {row['p95_s']:6.2f}s, goodput "
              f"{row['goodput_rps']:6.2f}/s, queue {row['queue_depth']:4.1f}"
              + (f", cache hit {hr:.2f}" if hr is not None else ""))
    slo = summary["slo"]
    if slo["checks"]:
        verdict = "PASS" if slo["passed"] else "FAIL"
        detail = ", ".join(f"{k}={c['actual']:.3g} (limit {c['limit']:.3g})"
                           for k, c in slo["checks"].items())
        print(f"SLO {verdict}: {detail}")
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
    print(f"routes: {_routes_line()}")
    digest = outcome_digest(results)
    print(f"outcome digest: {digest} "
          f"({len(results)} requests, {summary['expired']} expired)")

    obs.finalize(engine, collector)
    if args.trace_out:
        n = obs.tracer.export(args.trace_out)
        dropped = (f" ({obs.tracer.dropped} dropped)"
                   if obs.tracer.dropped else "")
        print(f"trace: {n} events -> {args.trace_out}{dropped}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.metrics.to_text())
        print(f"metrics: -> {args.metrics_out}")
    if args.report_json:
        report = {
            "scenario": scn.name,
            "policy": args.policy,
            "replay_clock": args.replay_clock,
            "kernels": "cuda" if device.type == "cuda" else "plain",
            "seed": args.seed,
            "outcome_digest": digest,
            "n_requests": len(results),
            "summary": {k: v for k, v in summary.items() if k != "slo"},
            "slo": summary["slo"],
            "engine": s,
            "kernel_routes": (obs.kernel_profiler.route_counts()
                              if obs.kernel_profiler is not None else {}),
            "obs": obs.metrics.snapshot(),
        }
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True, default=float)
        print(f"report: -> {args.report_json}")
    return {"summary": summary, "engine": s, "wall_s": wall, "evals": evals,
            "digest": digest, "collector_summary": collector.summary()}


if __name__ == "__main__":
    main()
