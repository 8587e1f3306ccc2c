"""Port tests for the obs layer (``repro_torch.serving.obs``) and the
serving stack's wall-clock rule.

What is held, in order:

  * the metrics registry's instrument semantics (get-or-create by
    (name, labels), kind collisions rejected) and its exposition, equal
    to the reference registry's ``to_text()`` / ``snapshot()`` for the
    same calls;
  * span tracer invariants: nesting, clock-bound timestamps, ring-buffer
    overflow accounting, export round-trips;
  * ``NULL_OBS`` inert;
  * a traced golden replay at tiny_ddim(8) on the CPU under the virtual
    clock: the full span taxonomy (every busy tick's phases once each, in
    order; every bank build's merge and pack), the engine counters in the
    registry, a deterministic trace, and the same tick log, outcomes and
    x0 with obs on and off;
  * the tracer's spans as profiler ranges: one for one, named
    ``<cat>.<name>`` and nested as in the buffer, a leaked span's range
    closed by the outer ``end``, none with ``NULL_OBS``;
  * the kernel profiler's route counts equal to ``ops.ROUTES``;
  * bank spans from threads churning the prefetch path reconcile, under
    the order-tracking lock monitor;
  * the MetricsCollector's retention caps and folded counters;
  * no direct wall-clock read under ``repro_torch/serving/`` or
    ``repro_torch/launch/`` outside clock classes.
"""
import ast
import json
import pathlib
import re
import threading

import numpy as np
import pytest
import torch

from repro.serving.obs.metrics import MetricsRegistry as JRegistry
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.convert import from_numpy_tree
from repro_torch.core import talora
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels import ops
from repro_torch.launch.serve_diffusion import TALORA_CFG
from repro_torch.nn.unet import io_sites, unet_init
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, absmax_talora_setup,
                                 default_serving_plan)
from repro_torch.serving.obs import NULL_OBS, Observability, SpanTracer
from repro_torch.serving.obs.metrics import MetricsRegistry
from repro_torch.serving.replay import replay, replay_mismatches
from repro_torch.serving.traffic import load_trace
from repro_torch.serving.traffic.metrics import MetricsCollector, _Event
from tools.analysis.lockcheck import LockMonitor, serving_discipline

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = str(ROOT / "tests" / "data" / "golden_trace.jsonl")


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------


def test_registry_instruments_and_labels():
    m = MetricsRegistry()
    c = m.counter("requests_total", help="n requests", route="a")
    c.inc()
    c.inc(2)
    assert m.counter("requests_total", route="a") is c      # get-or-create
    assert m.counter("requests_total", route="b") is not c  # new label set
    m.set("queue_depth", 7)
    h = m.histogram("lat_s")
    h.observe(0.5)
    h.observe(1.5)
    snap = m.snapshot()
    assert snap['requests_total{route="a"}'] == 3
    assert snap['requests_total{route="b"}'] == 0
    assert snap["queue_depth"] == 7
    assert snap["lat_s_count"] == 2
    assert snap["lat_s_sum"] == pytest.approx(2.0)
    assert snap["lat_s_mean"] == pytest.approx(1.0)


def test_registry_rejects_kind_collisions():
    m = MetricsRegistry()
    m.counter("x")
    with pytest.raises(ValueError, match="already registered as counter"):
        m.gauge("x")
    m.histogram("h")
    with pytest.raises(ValueError, match="already registered as histogram"):
        m.counter("h")


def _exercise(m):
    """One sequence of registry calls: counters, labelled series, gauges,
    histograms with default and custom buckets, the overflow bucket."""
    m.counter("calls_total", help="total calls", op="mm").inc(4)
    m.counter("calls_total", op="conv", route="cuda:implicit").inc()
    m.set("depth", 2)
    m.set("engine_ticks", 17, model="tiny-ddim")
    h = m.histogram("dur_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    d = m.histogram("kernel_call_seconds", help="per dispatch",
                    op="w4a4_matmul", route="plain")
    for v in (3e-6, 2e-4, 0.02, 70.0):
        d.observe(v)
    m.gauge("ratio").set(0.25)


def test_registry_exposition_equals_reference():
    port, ref = MetricsRegistry(), JRegistry()
    _exercise(port)
    _exercise(ref)
    text = port.to_text()
    assert text == ref.to_text()
    assert port.snapshot() == ref.snapshot()
    assert "# TYPE calls_total counter" in text
    assert 'calls_total{op="mm"} 4' in text
    assert 'dur_s_bucket{le="0.1"} 2' in text       # cumulative, le is <=
    assert 'dur_s_bucket{le="+Inf"} 4' in text


# ---------------------------------------------------------------------------
# Span tracer.
# ---------------------------------------------------------------------------


def test_tracer_nesting_and_deterministic_clock():
    t = [0.0]
    tr = SpanTracer(clock=lambda: t[0])
    outer = tr.begin("tick", args={"n": 1})
    t[0] = 1.0
    with tr.span("forward", cat="engine") as sp:
        sp.set("rows", 4)
        t[0] = 3.0
    t[0] = 5.0
    tr.end(outer)
    fwd, tick = tr.events()                      # inner ends first
    assert (fwd["name"], tick["name"]) == ("forward", "tick")
    assert tick["ts"] == 0.0 and tick["dur"] == 5e6         # us
    assert fwd["ts"] == 1e6 and fwd["dur"] == 2e6
    assert fwd["args"]["rows"] == 4


def test_tracer_end_tolerates_leaked_inner_span():
    tr = SpanTracer(clock=lambda: 0.0)
    outer = tr.begin("outer")
    tr.begin("leaked")              # never ended (error path)
    tr.end(outer)
    nxt = tr.begin("next")
    tr.end(nxt)
    assert [e["name"] for e in tr.events()] == ["outer", "next"]


def test_tracer_ring_buffer_drops_oldest():
    tr = SpanTracer(clock=lambda: 0.0, max_events=3)
    for i in range(5):
        tr.instant(f"i{i}")
    assert tr.dropped == 2
    assert [e["name"] for e in tr.events()] == ["i2", "i3", "i4"]


def test_tracer_export_round_trips(tmp_path):
    tr = SpanTracer(clock=lambda: 1.0)
    tr.async_begin("request", 7, args={"steps": 3})
    tr.instant("admit", cat="sched")
    tr.counter("queue", {"pending": 2})
    tr.async_end("request", 7)
    chrome, jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    n1 = tr.export(str(chrome))
    n2 = tr.export(str(jsonl))
    doc = json.loads(chrome.read_text())
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "b", "i", "C", "e"}
    lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert n1 == n2 == len(lines) == len(doc["traceEvents"])
    assert lines == doc["traceEvents"]
    b = next(e for e in lines if e["ph"] == "b")
    assert b["id"] == "7" and b["args"]["steps"] == 3


def test_null_obs_is_inert():
    assert not NULL_OBS.enabled and not NULL_OBS.tracer.enabled
    assert NULL_OBS.tracer.begin("x") is None
    NULL_OBS.tracer.end(None)
    NULL_OBS.tracer.instant("x")
    NULL_OBS.tracer.async_begin("x", 1)
    assert NULL_OBS.tracer.events() == []
    assert NULL_OBS.kernel_profiler is None
    NULL_OBS.install_kernels()
    assert ops.PROFILER is None


# ---------------------------------------------------------------------------
# The engine traced: a golden replay at tiny_ddim(8) on the CPU.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_setup():
    """tiny_ddim(8) as the launcher builds it from --seed 0."""
    cfg = tiny_ddim(8)
    gen = torch.Generator().manual_seed(0)
    params = unet_init(gen, cfg, "cpu")
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=io_sites(params))
    return cfg, params, plan, hubs, router


def _replay_golden(setup, obs=None):
    cfg, params, plan, hubs, router = setup
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 100,
                      device="cpu")
    eng = DiffusionServingEngine(
        cfg, make_schedule("linear", 100), bank,
        act_qps={"*": QuantizerParams(KIND_FP_SIGNED, 2, 1, 4,
                                      torch.tensor(6.0))},
        max_batch=2, clock=VirtualClock(), device="cpu", obs=obs)
    return eng, replay(eng, load_trace(GOLDEN)[0])


def test_traced_golden_replay_has_full_taxonomy_and_identical_outcomes(
        tiny_setup):
    obs = Observability()
    obs.install_kernels()
    try:
        eng, traced = _replay_golden(tiny_setup, obs)
    finally:
        obs.uninstall_kernels()
    _, plain = _replay_golden(tiny_setup)
    assert replay_mismatches(traced, plain) == []
    assert all(torch.equal(traced["x0"][r], plain["x0"][r])
               for r in plain["x0"])

    evs = obs.tracer.events()
    by_name = {}
    for e in evs:
        by_name.setdefault(e["name"], []).append(e)
    begins = [e for e in by_name["request"] if e["ph"] == "b"]
    ends = [e for e in by_name["request"] if e["ph"] == "e"]
    assert len(begins) == len(ends) == len(plain["outcomes"]) == 6
    assert {e["id"] for e in begins} == {str(r) for r in plain["outcomes"]}
    assert all(e["args"]["outcome"] == "complete" for e in ends)
    assert len([e for e in by_name["admit"] if e["cat"] == "request"]) == 6
    assert len(by_name["eval"]) == sum(n for n, _ in
                                       plain["outcomes"].values())
    ticks = by_name["tick"]
    busy = [e for e in ticks if not e["args"].get("idle")]
    assert len(busy) == len(plain["ticks"])
    assert [(e["args"]["seg"], tuple(e["args"]["members"])) for e in busy] \
        == [(seg, tuple(dict.fromkeys(rids))) for seg, rids in plain["ticks"]]
    assert eng.tick_count == len(ticks)
    spans = sorted(ticks, key=lambda e: e["ts"])
    for a, b in zip(spans, spans[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    for name in ("forward", "bank_fetch"):
        assert len(by_name[name]) == len(busy)
        for e in by_name[name]:
            assert any(t["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= t["ts"] + t["dur"]
                       for t in ticks), f"{name} span outside every tick"
    assert len(by_name["bank_build"]) == eng.bank.builds > 0
    # the buffer holds spans in the order they end: every busy tick holds
    # its phases once each, in order, a stage and a launch a partition;
    # every bank build its merge and pack
    build = "(?:merge pack bank_build )*"
    tick = (f"admit (?:group {build}bank_fetch (?:stage launch )+sync "
            f"forward advance {build}prefetch )?tick ")
    order = "".join(e["name"] + " " for e in evs if e["ph"] == "X")
    assert re.fullmatch(f"(?:{tick})+", order)
    assert len(by_name["launch"]) == eng.n_forwards
    assert len(by_name["merge"]) == len(by_name["pack"]) == eng.bank.builds
    assert len(by_name["select"]) == len(busy)
    kernel = [e for e in evs if e["cat"] == "kernel"]
    assert {e["name"] for e in kernel} == {
        "conv2d[plain]", "w4a4_conv2d[plain:implicit]", "w4a4_matmul[plain]"}
    assert {e["cat"] for e in evs} >= {"request", "engine", "bank", "sched",
                                       "metrics", "kernel"}
    # the engine's virtual clock stamps the trace: a second replay traces
    # the same events (the kernel spans' shapes included)
    obs2 = Observability()
    obs2.install_kernels()
    try:
        _replay_golden(tiny_setup, obs2)
    finally:
        obs2.uninstall_kernels()
    assert obs2.tracer.events() == evs


def test_obs_registry_tracks_engine_counters(tiny_setup):
    obs = Observability()
    eng, _ = _replay_golden(tiny_setup, obs)
    obs.finalize(eng)
    snap = obs.metrics.snapshot()
    assert snap["engine_ticks"] == eng.tick_count
    assert snap["engine_finished"] == eng.n_finished == 6
    assert snap["engine_forwards"] == eng.n_forwards
    assert snap["engine_compiled_forwards"] == len(eng._shapes)
    assert snap["bank_builds"] == eng.bank.builds
    assert snap["bank_hits"] == eng.bank.hits
    assert snap["sched_preemptions"] == eng.batcher.preemptions
    assert snap["engine_forward_seconds_count"] >= 0
    assert snap["bank_fetch_seconds_count"] == len(
        [e for e in obs.tracer.events() if e["name"] == "bank_fetch"])
    assert snap["trace_events"] == len(obs.tracer.events())
    text = obs.metrics.to_text()
    assert "engine_ticks" in text and "bank_builds" in text


def test_kernel_profiler_route_counts_equal_dispatch_counts(tiny_setup):
    ops.reset_routes()
    obs = Observability()
    with obs.kernel_profiler:
        eng, _ = _replay_golden(tiny_setup, obs)
    assert ops.PROFILER is None             # the context uninstalls
    counts = obs.kernel_profiler.route_counts()
    assert counts == {f"{op}:{r}": n for (op, r), n in ops.ROUTES.items()}
    assert counts["conv2d:plain"] == 2 * eng.n_forwards   # the io sites
    snap = obs.metrics.snapshot()
    for key, n in counts.items():
        op, route = key.split(":", 1)
        lab = f'{{mode="eager",op="{op}",route="{route}"}}'
        assert snap[f"kernel_calls_total{lab}"] == n
        hist = f'kernel_call_seconds{{op="{op}",route="{route}"}}'
        assert snap[f"{hist}_count"] == n and snap[f"{hist}_sum"] > 0


# ---------------------------------------------------------------------------
# Thread safety: bank spans from the prefetch worker under churn.
# ---------------------------------------------------------------------------


def _multi_segment_bank(lock_factory):
    rng = np.random.default_rng(1)
    params = from_numpy_tree(
        {"l0": {"w": rng.normal(size=(8, 8)).astype(np.float32)},
         "l1": {"w": rng.normal(size=(8, 6)).astype(np.float32)}}, "cpu")
    weights = {"l0/w": params["l0"]["w"], "l1/w": params["l1"]["w"]}
    tcfg = talora.TALoRAConfig(hub_size=2, rank=2, t_emb_dim=16,
                               router_hidden=8)
    gen = torch.Generator().manual_seed(1)
    hubs = talora.init_lora_hub(
        gen, talora.lora_target_dims_from_weights(weights), tcfg)
    router = talora.init_router(gen, len(weights), tcfg)
    return WeightBank(params, default_serving_plan(weights), hubs, router,
                      tcfg, 40, max_cached=8, lock_factory=lock_factory,
                      device="cpu")


def test_bank_spans_from_threaded_churn_reconcile():
    mon = serving_discipline(LockMonitor())
    bank = _multi_segment_bank(mon)
    assert bank.n_segments >= 2
    bank.max_cached = bank.n_segments
    obs = Observability(lock_factory=mon)
    bank.obs = obs
    segs = list(range(bank.n_segments))
    errs = []
    bank.prefetch(0, block=False)       # one build on the worker, at least

    def worker(wid):
        rng = np.random.default_rng(wid)
        try:
            for _ in range(30):
                seg = int(rng.choice(segs))
                if rng.random() < 0.5:
                    bank.prefetch(seg, block=bool(rng.random() < 0.3))
                else:
                    bank.params_for_segment(seg)
        except Exception as e:      # surfaced by the assert below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    bank.drain()
    assert not errs
    evs = obs.tracer.events()
    builds = [e for e in evs if e["name"] == "bank_build"]
    assert len(builds) == bank.builds == len(segs)
    for e in builds:
        assert e["ph"] == "X" and e["dur"] >= 0 and "seg" in e["args"]
        json.dumps(e)
    # on each track a build's merge and pack end before it, so they nest
    # in their bank_build, the prefetch worker's included
    names = dict((m["tid"], m["args"]["name"])
                 for m in obs.tracer._metadata_events())
    for tid in names:
        order = "".join(e["name"] + " " for e in evs
                        if e["tid"] == tid and e["ph"] == "X")
        assert re.fullmatch("(?:merge pack bank_build )*", order), order
    assert any(n.startswith("weight-bank-prefetch") and any(
        e["tid"] == tid and e["name"] == "merge" for e in evs)
        for tid, n in names.items())
    tids = {e["tid"] for e in evs}
    assert len(tids) >= 2
    assert tids <= {m["tid"] for m in obs.tracer._metadata_events()}
    counts = mon.acquire_counts()
    assert counts.get("bank._lock", 0) > 0
    assert counts.get("tracer._lock", 0) > 0
    mon.assert_clean()


# ---------------------------------------------------------------------------
# Spans as profiler ranges.
# ---------------------------------------------------------------------------


def _profiled_ranges(tmp_path, fn) -> list[tuple]:
    """(start, end, name) of the ``user_annotation`` events a CPU
    ``torch.profiler`` run of ``fn`` records, on the profiler's clock."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation"]


def _with_parents(spans) -> list[tuple]:
    """(name, innermost enclosing name) of each (start, end, name), in
    start order."""
    out, stack = [], []
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((a, b, name))
    return out


def test_spans_are_profiler_ranges_nested_as_in_the_buffer(tiny_setup,
                                                            tmp_path):
    cfg, params, plan, hubs, router = tiny_setup

    def ticks(obs):
        bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 100,
                          device="cpu")
        eng = DiffusionServingEngine(
            cfg, make_schedule("linear", 100), bank, max_batch=2,
            async_prefetch=False, device="cpu", obs=obs)
        for i in range(3):
            eng.submit(steps=2, seed=i)
        return lambda: [eng.tick() for _ in range(4)]

    obs = Observability()
    ranges = _profiled_ranges(tmp_path, ticks(obs))
    spans = [(e["ts"], e["ts"] + e["dur"], f"{e['cat']}.{e['name']}")
             for e in obs.tracer.events() if e["ph"] == "X"]
    assert {n for *_, n in spans} >= {
        "engine.tick", "engine.admit", "engine.group", "bank.bank_fetch",
        "engine.forward", "engine.stage", "engine.launch", "engine.sync",
        "engine.advance", "engine.prefetch", "bank.bank_build",
        "bank.merge", "bank.pack"}
    assert _with_parents(ranges) == _with_parents(spans)

    # a leaked inner span's range is closed by the outer end, first
    tr = SpanTracer(clock=lambda: 0.0)

    def leak():
        outer = tr.begin("outer")
        tr.begin("leaked")
        tr.end(outer)
        tr.end(tr.begin("next"))
    got = {n: (a, b) for a, b, n in _profiled_ranges(tmp_path, leak)}
    assert got["engine.outer"][0] <= got["engine.leaked"][0]
    assert got["engine.leaked"][1] <= got["engine.outer"][1]
    assert got["engine.next"][0] >= got["engine.outer"][1]

    assert not [n for *_, n in _profiled_ranges(tmp_path, ticks(None))
                if n.startswith(("engine.", "bank."))]


def test_text_model_ranges_and_guided_rows(tmp_path):
    """A text-conditioned model's spatial transformers open
    ``unet.transformer`` (holding ``unet.self_attn``, ``unet.cross_attn``,
    ``unet.ff``) under the engine's ``launch`` with obs on, as buffer spans
    and as profiler ranges; none under ``NULL_OBS``. ``guided_rows``
    counts the uncond rows run for guidance, in the stats and the
    ``forward`` span's args."""
    from repro_torch.configs.diffusion_presets import tiny_sd
    cfg = tiny_sd()
    gen = torch.Generator().manual_seed(0)
    params = unet_init(gen, cfg, "cpu")
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=io_sites(params))

    def ticks(obs):
        bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 20,
                          device="cpu")
        ctx = torch.randn((4, 3, cfg.context_dim),
                          generator=torch.Generator().manual_seed(1))
        eng = DiffusionServingEngine(
            cfg, make_schedule("scaled_linear", 20), bank, max_batch=2,
            async_prefetch=False, device="cpu", obs=obs,
            null_context=ctx[3])
        eng.submit(steps=2, seed=0, guidance_scale=7.5, context=ctx[0])
        eng.submit(steps=2, seed=1, context=ctx[1])
        eng.submit(steps=2, seed=2, guidance_scale=3.0, context=ctx[2])
        return eng, lambda: [eng.tick() for _ in range(4)]

    obs = Observability()
    eng, run = ticks(obs)
    ranges = _profiled_ranges(tmp_path, run)
    unet_names = {"unet.transformer", "unet.self_attn", "unet.cross_attn",
                  "unet.ff"}
    parents = set(_with_parents(ranges))
    assert {("unet.transformer", "engine.launch"),
            ("unet.self_attn", "unet.transformer"),
            ("unet.cross_attn", "unet.transformer"),
            ("unet.ff", "unet.transformer")} <= parents
    spans = [e for e in obs.tracer.events() if e["ph"] == "X"]
    # tiny_sd's one transformer level (one down, two up) and the middle
    n_fwd = eng.n_forwards
    assert sum(e["cat"] == "unet" and e["name"] == "transformer"
               for e in spans) == 4 * n_fwd
    # ticks of 2 members (the guided seed 0 with seed 1, then seed 2)
    fwd = [e["args"]["guided_rows"] for e in spans
           if e["cat"] == "engine" and e["name"] == "forward"]
    assert fwd == [1, 1, 1, 1] and eng.stats()["guided_rows"] == 4
    assert eng.n_samples_batched == 3 + 3 + 2 + 2

    eng, run = ticks(NULL_OBS)
    assert not {n for *_, n in _profiled_ranges(tmp_path, run)} & unet_names
    assert eng.stats()["guided_rows"] == 4


# ---------------------------------------------------------------------------
# MetricsCollector retention + folded counters.
# ---------------------------------------------------------------------------


def _feed(col, n):
    for i in range(n):
        col.events.append(_Event(arrival=float(i), finished=i + 0.5,
                                 latency=0.5, met_deadline=(i % 3 != 0),
                                 expired=(i % 7 == 0)))
        col.ticks.append((float(i), i % 5, i % 3, 0, 0))


def test_retention_cap_keeps_summary_totals_exact():
    capped = MetricsCollector(max_events=6, max_ticks=4)
    unbounded = MetricsCollector(max_events=None, max_ticks=None)
    _feed(capped, 20)
    _feed(unbounded, 20)
    assert len(capped.events) == 6 and len(capped.ticks) == 4
    s_c, s_u = capped.summary(), unbounded.summary()
    for k in ("requests", "expired", "deadline_misses", "duration_s",
              "throughput_rps", "goodput_rps", "goodput_frac",
              "peak_queue_depth", "mean_inflight"):
        assert s_c[k] == pytest.approx(s_u[k]), k
    assert s_c["compacted_events"] == 14 and s_c["compacted_ticks"] == 16
    assert s_u["compacted_events"] == 0
    assert s_c["p95_s"] == 0.5


def test_summary_folds_scheduler_and_bank_counters(tiny_setup):
    col = MetricsCollector()
    s = col.summary()                      # unattached: zero defaults
    assert (s["preemptions"], s["deadline_saves"], s["bank_builds"],
            s["bank_build_joins"], s["prefetch_hits"]) == (0, 0, 0, 0, 0)
    cfg, params, plan, hubs, router = tiny_setup
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 100,
                      device="cpu")
    eng = DiffusionServingEngine(cfg, make_schedule("linear", 100), bank,
                                 max_batch=2, clock=VirtualClock(),
                                 device="cpu")
    col.attach(eng)
    for i in range(3):
        eng.submit(steps=2 + i % 2, seed=i)
    eng.run()
    s = col.summary()
    assert s["bank_builds"] == eng.bank.builds > 0
    assert s["prefetch_hits"] == eng.bank.prefetch_hits
    assert s["preemptions"] == eng.batcher.preemptions
    assert s["requests"] == 3


# ---------------------------------------------------------------------------
# The wall-clock rule (the reference's repolint clock-discipline, whose
# scope does not reach the port).
# ---------------------------------------------------------------------------

BANNED_ALWAYS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.process_time", "time.process_time_ns",
    "time.monotonic_ns"}
BANNED_ARGLESS = {
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today", "date.today"}


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def wall_clock_reads(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, call) of every banned wall-clock read outside a class whose
    name contains ``Clock``."""
    out = []

    def rec(node, in_clock):
        in_clock = in_clock or (isinstance(node, ast.ClassDef)
                                and "Clock" in node.name)
        if isinstance(node, ast.Call) and not in_clock:
            chain = _dotted(node.func)
            if chain in BANNED_ALWAYS or (
                    chain in BANNED_ARGLESS and not node.args
                    and not node.keywords):
                out.append((node.lineno, chain))
        for child in ast.iter_child_nodes(node):
            rec(child, in_clock)
    rec(tree, False)
    return out


def test_wall_clock_rule_flags_what_it_should():
    src = ("import time, datetime\n"
           "t = time.perf_counter()\n"
           "d = datetime.datetime.now()\n"
           "z = datetime.datetime.now(tz)\n"
           "class SimClock:\n"
           "    def now(self):\n"
           "        return time.time()\n")
    assert wall_clock_reads(ast.parse(src)) == [(2, "time.perf_counter"),
                                                (3, "datetime.datetime.now")]


def test_serving_and_launch_read_no_wall_clock_directly():
    pkg = ROOT / "src" / "repro_torch"
    files = sorted((pkg / "serving").rglob("*.py")) + sorted(
        (pkg / "launch").rglob("*.py"))
    assert len(files) > 15
    found = {str(f.relative_to(ROOT)): hits for f in files
             if (hits := wall_clock_reads(ast.parse(f.read_text())))}
    assert found == {}
    # the sanctioned seam is where the reads go
    clock = ast.parse((pkg / "common" / "clock.py").read_text())
    assert wall_clock_reads(clock) == [(28, "time.perf_counter")]
