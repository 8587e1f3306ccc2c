"""The port's multi-model gateway (``repro_torch.serving.gateway``): the
reference's ``tests/test_gateway.py`` on the port, then parity with the JAX
package.

Gateway-hosted engines are mostly stubs (``apply_fn`` short-circuits the
UNet), as in the reference's suite: what is pinned is the routing/identity
layer — gid assignment, ``rs.model``/``rs.gid`` annotations, per-bank
counter reconciliation, deterministic two-model replay, the LM adapter and
trace v2 back-compat.

Parity (exact unless stated): the same v2 trace through the JAX gateway
and the port's gives the same gids, models, tick logs, outcomes and digest
(each port request starts from the reference's x_T). The LM adapter on the
reference's tiny LM params (``steps.dyadic_weights``, W4 abs-max, acts off)
fed the reference's prompts gives its token ids, ``n_evals``, expiry,
per-model digest and stats keys; its logits are held within the rule
``tests/test_torch_lm.py`` holds ``decode_step`` to in f32 (1e-4 of the
step's largest logit: the sums run in another order), so a greedy flip
could only come from a near-tie, which the test would name. Then the
one-model identity on the golden trace, the launcher on the CPU and the
registry's refusal of archs the port does not run yet.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_layout, np_tree, ref_x_T, report_layout)
from repro.common.tree import flatten_paths as j_flatten
from repro.configs.diffusion_presets import tiny_ddim as j_tiny
from repro.configs.registry import list_models as j_list_models
from repro.diffusion.schedule import make_schedule as j_sched
from repro.launch.serve_diffusion import outcome_digest as j_digest
from repro.launch.steps import quantize_lm_for_serving as j_quantize
from repro.models.lm import LMConfig as JLMConfig
from repro.models.lm import decode_step as j_decode_step
from repro.models.lm import lm_init as j_lm_init
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import VirtualClock as JClock
from repro.serving import WeightBank as JBank
from repro.serving import default_serving_plan as j_plan
from repro.serving import traffic as jt
from repro.serving.gateway import LMServingEngine as JLMEngine
from repro.serving.gateway import ServingGateway as JGateway
from repro.serving.gateway import default_entries as j_default_entries
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.configs.registry import (PENDING_ARCHS, get_config,
                                          list_models)
from repro_torch.convert import from_numpy_tree
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.launch import serve_gateway
from repro_torch.launch.serve_diffusion import outcome_digest
from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                      quantize_lm_for_serving)
from repro_torch.models.lm import LMConfig, lm_init
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, default_serving_plan)
from repro_torch.serving import traffic as tt
from repro_torch.serving.gateway import (FAMILIES, DecodeState,
                                         LMServingEngine, ModelEntry,
                                         ServingGateway, default_entries,
                                         default_registry)
from repro_torch.serving.replay import record_ticks
from repro_torch.serving.traffic import (MetricsCollector, RequestMix,
                                         TraceWriter, get_scenario,
                                         list_scenarios, load_trace,
                                         open_loop_trace, run_scenario,
                                         save_trace, submit_trace)
from repro_torch.serving.traffic.scenarios import (build_trace,
                                                   resolve_trace_path)
from repro_torch.serving.traffic.sim import SimClock

ROOT = pathlib.Path(__file__).resolve().parents[1]
T = 40
GOLDEN = str(ROOT / "tests" / "data" / "golden_trace.jsonl")


def _bank():
    params = {"l0": {"w": torch.ones(4, 4)}}
    plan = default_serving_plan(flatten_paths(params))
    return WeightBank(params, plan, {}, None, None, T, device="cpu")


def _stub_engine(max_batch=3, scale=0.1, **kw):
    sched = make_schedule("linear", T)
    return DiffusionServingEngine(
        tiny_ddim(4), sched, _bank(), max_batch=max_batch, device="cpu",
        apply_fn=lambda params, x, tb, y, ctx, s=scale: s * x, **kw)


def _two_model_gateway(clock=None, **eng_kw):
    """Both default registry names hosted on stub engines (distinct
    apply scales so cross-routing would change outputs)."""
    gw = ServingGateway(clock=clock)
    entries = {e.name: e for e in default_entries()}
    kw = dict(eng_kw)
    if clock is not None:
        kw["clock"] = clock
    gw.add_model(entries["tiny-ddim"],
                 _stub_engine(max_batch=2, scale=0.1, **kw))
    gw.add_model(entries["smollm-135m"],
                 _stub_engine(max_batch=2, scale=0.3, **kw))
    return gw


# ---------------------------------------------------------------------------
# Registry validation.
# ---------------------------------------------------------------------------


def test_model_entry_validation():
    ok = ModelEntry(name="tiny-ddim", family="diffusion", config="tiny-ddim")
    ok.validate()
    with pytest.raises(ValueError, match="family"):
        ModelEntry(name="x", family="vision", config="tiny-ddim").validate()
    with pytest.raises(ValueError, match="preset"):
        ModelEntry(name="x", family="diffusion", config="nope").validate()
    with pytest.raises(ValueError, match="arch"):
        ModelEntry(name="x", family="lm", config="nope").validate()
    with pytest.raises(ValueError, match="name"):
        ModelEntry(name="", family="diffusion", config="tiny-ddim").validate()
    with pytest.raises(ValueError, match="bank_cap"):
        ModelEntry(name="x", family="diffusion", config="tiny-ddim",
                   bank_cap=0).validate()
    assert set(FAMILIES) == {"diffusion", "lm"}


def test_model_registry_register_resolve_list():
    reg = default_registry()
    assert reg.list() == ["smollm-135m", "tiny-ddim"]
    assert "tiny-ddim" in reg and len(reg) == 2
    e = reg.resolve("smollm-135m")
    assert e.family == "lm" and e.config in list_models()
    with pytest.raises(ValueError, match="already registered"):
        reg.register(e)
    with pytest.raises(KeyError, match="unknown model"):
        reg.resolve("missing")
    for entry in default_entries():
        entry.validate()


def test_configs_registry_exposes_models():
    models = list_models()
    assert models == sorted(models)
    assert "smollm-135m" in models


def test_registry_refuses_unported_archs_naming_item_12b():
    """Every arch of the reference's registry is either run by the port or
    refused as not ported yet (ROADMAP Queue A item 12b) — by the model
    entry and by ``get_config`` — never called unknown; the reference's
    own entries carry over unchanged."""
    assert sorted(list_models() + list(PENDING_ARCHS)) == j_list_models()
    for arch in PENDING_ARCHS:
        entry = ModelEntry(name=arch, family="lm", config=arch)
        with pytest.raises(NotImplementedError, match="item 12b"):
            entry.validate()
        with pytest.raises(NotImplementedError, match="item 12b"):
            get_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")
    assert [dataclasses.asdict(e) for e in default_entries()] == \
        [dataclasses.asdict(e) for e in j_default_entries()]


# ---------------------------------------------------------------------------
# Routing + gid identity.
# ---------------------------------------------------------------------------


def test_gateway_routes_by_model_and_assigns_gids():
    gw = _two_model_gateway(clock=VirtualClock())
    assert gw.routes_models
    assert gw.list_models() == ["tiny-ddim", "smollm-135m"]
    g0 = gw.submit(model="tiny-ddim", steps=1, seed=0)
    g1 = gw.submit(model="smollm-135m", steps=1, seed=1)
    g2 = gw.submit(steps=1, seed=1)            # None -> default (first added)
    assert (g0, g1, g2) == (0, 1, 2)
    assert gw.route[g1][0] == "smollm-135m"
    assert gw.route[g2][0] == "tiny-ddim"
    # engine-local rids overlap across engines; gids never do
    assert gw.route[g0][1] == gw.route[g1][1] == 0
    with pytest.raises(KeyError, match="unknown model"):
        gw.submit(model="missing", steps=1)
    res = gw.run()
    assert set(res) == {0, 1, 2}
    for gid, rs in res.items():
        assert rs.gid == gid
        assert rs.model == gw.route[gid][0]
    # distinct apply scales prove requests ran on their routed engine
    x2 = gw.pop_result(g2).x0
    assert not torch.allclose(gw.results[g1].x0[..., 0, 0, 0],
                              x2[..., 0, 0, 0])


def test_gateway_rejects_duplicate_and_busy_engines():
    gw = ServingGateway()
    entry = default_entries()[0]
    gw.add_model(entry, _stub_engine())
    with pytest.raises(ValueError, match="already hosted"):
        gw.add_model(entry, _stub_engine())
    busy = _stub_engine()
    busy.submit(steps=1)
    with pytest.raises(ValueError, match="already has requests"):
        gw.add_model(default_entries()[1], busy)
    with pytest.raises(RuntimeError, match="no models"):
        ServingGateway().submit(steps=1)


def test_gateway_single_model_is_behavior_identical():
    """Hosting one engine behind the gateway must not change outcomes:
    same trace, same virtual clock -> same digest as the bare engine."""
    mix = RequestMix(samplers=("ddim", "plms"), steps=2, steps_jitter=1,
                     priorities=(1, 0))
    reqs = open_loop_trace("poisson", 6, seed=4, mix=mix, rate=30.0)

    eng = _stub_engine(max_batch=2, clock=VirtualClock())
    submit_trace(eng, reqs)
    direct = outcome_digest(eng.run())

    clock = VirtualClock()
    gw = ServingGateway(clock=clock)
    gw.add_model(default_entries()[0],
                 _stub_engine(max_batch=2, clock=clock))
    submit_trace(gw, reqs)
    via_gateway = outcome_digest(gw.run())
    assert via_gateway == direct


def test_gateway_two_model_replay_is_deterministic():
    mix = RequestMix(samplers=("ddim",), steps=2, steps_jitter=1,
                     models=("tiny-ddim", "smollm-135m"))
    reqs = open_loop_trace("poisson", 8, seed=7, mix=mix, rate=40.0)

    def once():
        gw = _two_model_gateway(clock=VirtualClock())
        submit_trace(gw, reqs)
        res = gw.run()
        for name in gw.list_models():
            bank = gw.engine(name).bank
            assert (bank.builds + bank.build_failures
                    == bank.misses + bank.prefetches), name
        return outcome_digest(res), gw.stats()

    d1, s1 = once()
    d2, s2 = once()
    assert d1 == d2
    assert s1["aggregate"]["requests"] == 8
    # both models actually served traffic, goodput reported per model
    for name in ("tiny-ddim", "smollm-135m"):
        assert s1["per_model"][name]["engine"]["requests"] == 4
        assert s1["per_model"][name]["summary"]["goodput_frac"] == \
            s2["per_model"][name]["summary"]["goodput_frac"]


def test_gateway_shared_collector_and_scenarios():
    assert {"mixed_model", "per_model_slo"} <= set(list_scenarios())
    scn = get_scenario("mixed_model")
    scn = dataclasses.replace(
        scn, n_requests=4,
        mix=dataclasses.replace(scn.mix, steps=1, steps_jitter=0))
    gw = _two_model_gateway(clock=VirtualClock())
    collector = MetricsCollector()
    summary = run_scenario(scn, gw, seed=0, collector=collector)
    assert summary["requests"] == 4
    assert summary["scenario"] == "mixed_model"
    # the shared collector saw completions from both engines
    assert len(collector.events) == 4


def test_per_model_slo_scenario_deadlines_follow_models():
    trace = build_trace(get_scenario("per_model_slo"), seed=0, n=6)
    for tr in trace:
        if tr.model == "tiny-ddim":
            assert tr.deadline is not None
        else:
            assert tr.model == "smollm-135m" and tr.deadline is None


def test_gateway_pop_result_prunes_all_bookkeeping():
    """pop_result drops ``results``, the gid route entry, the model's
    rid->gid map and the engine-local result of every request."""
    gw = _two_model_gateway(clock=VirtualClock())
    gids = [gw.submit(model=m, steps=1, seed=i)
            for i, m in enumerate(("tiny-ddim", "smollm-135m") * 2)]
    res = gw.run()
    assert len(res) == 4
    for g in gids:
        rs = gw.pop_result(g)
        assert rs.gid == g
    assert gw.results == {} and gw.route == {}
    for name in gw.list_models():
        assert gw._models[name].gid_of == {}
        assert gw.engine(name).results == {}
    with pytest.raises(KeyError):
        gw.pop_result(gids[0])


def test_gateway_under_shared_sim_clock():
    """One SimClock across both engines: time advances for each engine's
    compute on a single axis, and the run still drains deterministically."""
    sim = SimClock(tick_base_s=0.01, sample_s=0.005)
    gw = ServingGateway(now_fn=sim.now, max_idle_sleep=0.0)
    entries = {e.name: e for e in default_entries()}
    e1 = _stub_engine(max_batch=2, now_fn=sim.now, max_idle_sleep=0.0)
    e2 = _stub_engine(max_batch=2, scale=0.3, now_fn=sim.now,
                      max_idle_sleep=0.0)
    sim.attach(e1)
    sim.attach(e2)
    gw.add_model(entries["tiny-ddim"], e1)
    gw.add_model(entries["smollm-135m"], e2)
    mix = RequestMix(steps=1, steps_jitter=0,
                     models=("tiny-ddim", "smollm-135m"))
    submit_trace(gw, open_loop_trace("poisson", 4, seed=3, mix=mix,
                                     rate=50.0))
    res = gw.run()
    assert len(res) == 4
    assert sim.now() > 0.0
    assert all(rs.finished_at <= sim.now() for rs in res.values())


# ---------------------------------------------------------------------------
# LM engine adapter.
# ---------------------------------------------------------------------------


def _tiny_lm():
    cfg = LMConfig(name="tiny-test-lm", n_layers=1, d_model=16, n_heads=2,
                   n_kv=2, d_ff=32, vocab=32, dtype=torch.float32)
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    bank = WeightBank(params, None, {}, None, None, 1, max_cached=1,
                      build_fn=lambda p: p, device="cpu")
    return cfg, bank


def test_lm_engine_serves_and_reconciles():
    cfg, bank = _tiny_lm()
    eng = LMServingEngine(cfg, bank, max_batch=2, prompt_len=3, device="cpu")
    r0 = eng.submit(steps=4, seed=1)
    r1 = eng.submit(steps=2, seed=2)
    res = eng.run()
    assert set(res) == {r0, r1}
    out0 = res[r0].x0
    assert out0.shape == (4,) and out0.dtype == torch.int32
    assert res[r1].x0.shape == (2,)
    assert res[r0].n_evals == 4 and res[r1].n_evals == 2
    assert res[r0].state.caches is None       # released with the request
    assert (bank.builds + bank.build_failures
            == bank.misses + bank.prefetches)
    s = eng.stats()
    assert s["requests"] == 2 and s["buckets"] == [1]
    assert s["padded_samples"] == 0 and s["compiled_forwards"] == 1
    assert "bank_builds" in s


def test_lm_engine_deterministic_and_deadline_expiry():
    cfg, bank = _tiny_lm()

    def decode(seed):
        eng = LMServingEngine(cfg, bank, max_batch=1, clock=VirtualClock(),
                              device="cpu")
        rid = eng.submit(steps=3, seed=seed)
        rs = eng.run()[rid]
        return rs.state.prompt.tolist(), rs.x0.tolist()

    assert decode(5) == decode(5)
    # the seed draws the prompt, and the prompt decides the tokens (the
    # port's seeded init maps seeds 5 and 6 to the same tokens, so the
    # tokens are held over eight seeds)
    assert decode(5)[0] != decode(6)[0]
    assert len({tuple(decode(s)[1]) for s in range(8)}) > 1

    eng = LMServingEngine(cfg, bank, max_batch=1, clock=VirtualClock(),
                          device="cpu")
    rid = eng.submit(steps=2, seed=0, arrival=0.0, deadline=-1.0)
    res = eng.run()
    assert res[rid].expired and res[rid].x0 is None


def test_decode_state_steps_left_counts_prefill():
    cfg, _ = _tiny_lm()
    dec = DecodeState(cfg, seed=0, gen_len=3, prompt_len=2)
    assert dec.kind == "lm"
    assert dec.steps_left == 5      # prompt not yet prefetched into cache
    assert not dec.done


# ---------------------------------------------------------------------------
# Trace v2 back-compat: v1 loads + round-trips; mixed-model capture
# round-trips.
# ---------------------------------------------------------------------------


def test_v1_golden_trace_loads_with_default_model_and_roundtrips(tmp_path):
    reqs, header = load_trace(resolve_trace_path(GOLDEN))
    assert header["version"] == 1
    assert all(tr.model is None for tr in reqs)
    out = str(tmp_path / "resaved.jsonl")
    save_trace(out, reqs)
    again, header2 = load_trace(out)
    assert header2["version"] == 2
    assert again == reqs
    # v1 requests have no model field, so their encoded lines are
    # identical before and after the version bump
    v1_lines = open(resolve_trace_path(GOLDEN)).read().splitlines()[1:]
    v2_lines = open(out).read().splitlines()[1:]
    assert sorted(json.loads(ln)["seed"] for ln in v1_lines) == \
        sorted(json.loads(ln)["seed"] for ln in v2_lines)


def test_v1_header_without_model_field_accepted(tmp_path):
    p = tmp_path / "v1.jsonl"
    p.write_text(
        json.dumps({"format": "repro.traffic.trace", "version": 1,
                    "meta": {}}) + "\n"
        + json.dumps({"arrival": 0.1, "steps": 2}) + "\n")
    reqs, header = load_trace(str(p))
    assert header["version"] == 1
    assert reqs[0].model is None and reqs[0].steps == 2


def test_trace_rejects_bad_model_field():
    from repro_torch.serving.traffic import validate_trace
    from repro_torch.serving.traffic.trace import TraceRequest
    with pytest.raises(ValueError, match="model"):
        validate_trace([TraceRequest(arrival=0.0, steps=1, model="")])


def test_mixed_model_capture_roundtrips(tmp_path):
    mix = RequestMix(steps=1, steps_jitter=0,
                     models=("tiny-ddim", "smollm-135m"))
    reqs = open_loop_trace("poisson", 6, seed=11, mix=mix, rate=40.0)
    path = str(tmp_path / "cap.jsonl")

    gw = _two_model_gateway(clock=VirtualClock())
    writer = TraceWriter(path, meta={"src": "gw"}).attach(gw)
    submit_trace(gw, reqs)
    gw.run()
    writer.close()

    captured, header = load_trace(path)
    assert header["version"] == 2
    assert len(captured) == 6
    # gateway-wide gids, not per-engine rids, land in the capture —
    # unique, and routing survives the round-trip
    assert sorted(tr.rid for tr in captured) == list(range(6))
    assert [tr.model for tr in captured] == [tr.model for tr in reqs]
    assert [tr.seed for tr in captured] == [tr.seed for tr in reqs]

    gw2 = _two_model_gateway(clock=VirtualClock())
    submit_trace(gw2, captured)
    res = gw2.run()
    assert len(res) == 6
    by_model = {}
    for gid, rs in res.items():
        by_model.setdefault(rs.model, 0)
        by_model[rs.model] += 1
    assert by_model == {"tiny-ddim": 3, "smollm-135m": 3}


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------


def _j_stub(scale, **kw):
    params = {"l0": {"w": jnp.ones((4, 4))}}
    bank = JBank(params, j_plan(j_flatten(params)), {}, None, None, T)
    return JEngine(j_tiny(4), j_sched("linear", T), bank,
                   apply_fn=lambda params, x, tb, y, ctx, s=scale: s * x,
                   **kw)


def _t_stub(scale, **kw):
    shape = (1, 4, 4, 3)
    return _stub_engine(scale=scale, noise_fn=lambda req: torch.from_numpy(
        np.array(ref_x_T(jax.random.PRNGKey(req.seed), shape))), **kw)


def test_gateway_routing_equals_reference():
    """A v2 trace over both default names (priorities, deadlines, two
    samplers) through the JAX gateway and the port's on a shared virtual
    clock: identical gids, models, per-engine tick logs, outcomes, bank
    counters and digest, overall and per model."""
    reqs = tt.open_loop_trace("poisson", 10, 5, tt.RequestMix(
        samplers=("ddim", "plms"), steps=3, steps_jitter=1,
        priorities=(1, 0), models=("tiny-ddim", "smollm-135m")), rate=30.0)
    recs = []
    for pkg, gw_cls, clock_cls, stub, digest in (
            (jt, JGateway, JClock, _j_stub, j_digest),
            (tt, ServingGateway, VirtualClock, _t_stub, outcome_digest)):
        clock = clock_cls()
        gw = gw_cls(clock=clock)
        logs = {}
        for entry, scale in zip(default_entries(), (0.1, 0.3)):
            eng = stub(scale, max_batch=2, clock=clock)
            logs[entry.name] = record_ticks(eng)
            gw.add_model(entry, eng)
        pkg.submit_trace(gw, [pkg.TraceRequest(**tr.to_obj())
                              for tr in reqs])
        res = gw.run()
        recs.append({
            "route": dict(gw.route), "ticks": logs,
            "outcomes": {g: (rs.gid, rs.model, rs.n_evals, rs.expired)
                         for g, rs in res.items()},
            "banks": {n: gw.engine(n).bank.describe()
                      for n in gw.list_models()},
            "digest": digest(res),
            "per_model": {n: digest(gw.engine(n).results)
                          for n in gw.list_models()}})
    assert recs[1] == recs[0]
    assert len(recs[0]["outcomes"]) == 10


def test_gateway_shared_sim_clock_equals_reference():
    """Both models on one SimClock (each engine's compute charges the one
    axis, so the order in which the gateway ticks its engines shows in
    every finish time): the same tick logs, outcomes, finish times and
    collector summary as the JAX gateway."""
    reqs = tt.open_loop_trace("poisson", 8, 3, tt.RequestMix(
        steps=2, steps_jitter=1, deadline_s=(0.05, None),
        models=("tiny-ddim", "smollm-135m")), rate=40.0)
    recs = []
    for pkg, gw_cls, stub in ((jt, JGateway, _j_stub),
                              (tt, ServingGateway, _t_stub)):
        sim = pkg.SimClock(tick_base_s=0.01, sample_s=0.005)
        gw = gw_cls(now_fn=sim.now, max_idle_sleep=0.0)
        logs = {}
        for entry, scale in zip(default_entries(), (0.1, 0.3)):
            eng = stub(scale, max_batch=2, now_fn=sim.now,
                       max_idle_sleep=0.0)
            sim.attach(eng)
            logs[entry.name] = record_ticks(eng)
            gw.add_model(entry, eng)
        collector = pkg.MetricsCollector().attach(gw)
        pkg.submit_trace(gw, [pkg.TraceRequest(**tr.to_obj())
                              for tr in reqs])
        res = gw.run()
        recs.append({"ticks": logs, "t_end": sim.now(),
                     "outcomes": {g: (rs.model, rs.n_evals, rs.expired,
                                      rs.finished_at)
                                  for g, rs in res.items()},
                     "summary": collector.summary()})
    assert recs[1] == recs[0]
    assert recs[0]["summary"]["deadline_misses"] + \
        recs[0]["summary"]["expired"] > 0      # the deadlines bite


def _lm_pair(seed=0):
    """The reference's tiny LM params through ``dyadic_weights`` (exact
    W4 grid scales), as (JAX tree, port tree), and both configs."""
    jcfg = JLMConfig(name="tiny-test-lm", n_layers=2, d_model=16, n_heads=2,
                     n_kv=2, d_ff=32, vocab=32, dtype=jnp.float32)
    tcfg = LMConfig(name="tiny-test-lm", n_layers=2, d_model=16, n_heads=2,
                    n_kv=2, d_ff=32, vocab=32, dtype=torch.float32)
    tp = dyadic_weights(from_numpy_tree(
        np_tree(j_lm_init(jax.random.PRNGKey(seed), jcfg)), "cpu"))
    jp = jax.tree.map(lambda v: jnp.asarray(v.numpy()), tp)
    return jcfg, tcfg, jp, tp


def _logged(step, log):
    def run(p, c, tok, pos):
        logits, c = step(p, c, tok, pos)
        log.append(np.asarray(logits, np.float32).reshape(-1))
        return logits, c
    return run


def test_lm_engine_equals_reference_on_dyadic_weights():
    """Four requests (prompt 3, 2-5 tokens) at max-batch 2 through the JAX
    LM engine and the port's, each bank packing W4 abs-max with its own
    package's ``quantize_lm_for_serving``, the port fed the reference's
    prompts: the same token ids, n_evals, expiry, tick logs, digest and
    stats keys; every decode step's logits within 1e-4 of its largest."""
    jcfg, tcfg, jp, tp = _lm_pair()
    prompt_len = 3
    reqs = [tt.TraceRequest(arrival=0.1 * i, steps=2 + i, seed=10 + i,
                            rid=i) for i in range(4)]
    jlog, tlog = [], []
    jbank = JBank(jp, None, {}, None, None, 1, max_cached=1,
                  build_fn=lambda p: j_quantize(p, searched=False))
    jeng = JLMEngine(jcfg, jbank, max_batch=2, clock=JClock(),
                     prompt_len=prompt_len)
    jeng._jit[("decode",)] = _logged(jax.jit(
        lambda p, c, tok, pos: j_decode_step(p, jcfg, c, tok, pos)), jlog)
    tbank = WeightBank(tp, None, {}, None, None, 1, max_cached=1,
                       build_fn=lambda p: quantize_lm_for_serving(
                           p, searched=False), device="cpu")
    teng = LMServingEngine(
        tcfg, tbank, max_batch=2, clock=VirtualClock(),
        prompt_len=prompt_len, device="cpu",
        prompt_fn=lambda req: torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(req.seed), (1, prompt_len), 0, jcfg.vocab))))
    teng._shapes[("decode",)] = _logged(make_decode_fn(tcfg), tlog)
    ticks = []
    for pkg, eng in ((jt, jeng), (tt, teng)):
        ticks.append(record_ticks(eng))
        pkg.submit_trace(eng, [pkg.TraceRequest(**tr.to_obj())
                               for tr in reqs])
        eng.run()

    assert ticks[1] == ticks[0] and len(ticks[0]) > 4
    assert len(tlog) == len(jlog) == sum(prompt_len + tr.steps
                                         for tr in reqs)
    for i, (got, want) in enumerate(zip(tlog, jlog)):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (i, err)
    for rid, jrs in jeng.results.items():
        trs = teng.results[rid]
        want, got = np.asarray(jrs.x0), trs.x0.numpy()
        assert got.dtype == want.dtype == np.int32
        if not np.array_equal(got, want):
            pytest.fail(f"request {rid}: tokens {got} != {want}")
        assert (trs.n_evals, trs.expired) == (jrs.n_evals, jrs.expired)
    assert outcome_digest(teng.results) == j_digest(jeng.results)
    ts, js = teng.stats(), jeng.stats()
    assert sorted(ts) == sorted(js)
    for k in ("requests", "ticks", "expired", "forwards", "mean_batch",
              "compiled_forwards", "buckets", "padded_samples",
              "bank_builds", "bank_hits", "bank_misses"):
        assert ts[k] == js[k], k


def test_outcome_digest_hashes_token_ids_as_reference():
    """An LM result's x0 is token ids: the port's digest hashes them as
    the reference's does (their float32 bytes), whether they come as the
    reference's numpy int32 array or the port engine's int32 tensor."""
    class RS:
        def __init__(self, x0, n_evals=3, expired=False):
            self.x0, self.n_evals, self.expired = x0, n_evals, expired

    toks = np.array([5, 0, 31, 17], np.int32)
    ref = {0: RS(toks), 1: RS(None, 0, True), 2: RS(toks[::-1].copy())}
    want = j_digest(ref)
    assert outcome_digest(ref) == want
    assert outcome_digest({k: RS(None if v.x0 is None
                                 else torch.from_numpy(v.x0),
                                 v.n_evals, v.expired)
                           for k, v in ref.items()}) == want


def test_one_model_gateway_golden_is_bare_engine():
    """The golden trace on tiny-ddim at the launcher's shaping (random
    weights, abs-max plan, TALoRA bank, E2M1 acts): a one-model gateway
    built by ``build_gateway`` gives the bare engine's tick log and
    digest."""
    args = serve_gateway.build_parser().parse_args([
        "--models", "tiny-ddim", "--clock", "virtual", "--device", "cpu",
        "--image-size", "8", "--T", "50"])
    args.gateway_max_batch = 2
    gw, _ = serve_gateway.build_gateway(["tiny-ddim"], args)
    eng = gw.engine("tiny-ddim")
    bare = DiffusionServingEngine(eng.cfg, eng.sched, WeightBank(
        eng.bank.q_params, eng.bank.plan, eng.bank.hubs, eng.bank.router,
        eng.bank.talora_cfg, eng.bank.T, max_cached=4, device="cpu"),
        act_qps=eng.ctx.act_qps, max_batch=2, clock=VirtualClock(),
        device="cpu")
    reqs = load_trace(GOLDEN)[0]
    logs = [record_ticks(e) for e in (bare, eng)]
    submit_trace(bare, reqs)
    direct = outcome_digest(bare.run())
    submit_trace(gw, reqs)
    assert outcome_digest(gw.run()) == direct
    assert logs[0] == logs[1] and len(logs[0]) > 0


def test_gateway_launcher_is_deterministic_with_the_reference_report(
        tmp_path, capsys):
    """``serve_gateway --device cpu --smoke --clock virtual`` twice: the
    same digest; the report carries the reference launcher's fields
    (its report literal, ``report_layout``) and aggregate keys, every bank
    reconciles, and only plain routes run."""
    from repro_torch.kernels import ops
    ops.reset_routes()
    path = tmp_path / "report.json"
    argv = ["--device", "cpu", "--smoke", "--clock", "virtual"]
    out = serve_gateway.main(argv + ["--report-json", str(path)])
    again = serve_gateway.main(argv)
    text = capsys.readouterr().out
    assert "gateway ready: 2 models" in text and "outcome digest:" in text
    assert out["outcome_digest"] == again["outcome_digest"]
    assert {n: p["digest"] for n, p in out["per_model"].items()} == \
        {n: p["digest"] for n, p in again["per_model"].items()}
    assert json.loads(path.read_text())["outcome_digest"] == \
        out["outcome_digest"]
    assert_layout(out, report_layout(
        ROOT / "src/repro/launch/serve_gateway.py"))
    assert_layout(out["aggregate"], report_layout(
        ROOT / "src/repro/serving/gateway/gateway.py", "stats", "agg"))
    assert all(p["bank_reconciled"] for p in out["per_model"].values())
    assert {p["family"] for p in out["per_model"].values()} == {"diffusion",
                                                                "lm"}
    assert {r for _, r in ops.ROUTES} <= {"plain", "plain:implicit",
                                          "torch"}
    assert ops.ROUTES[("w4_matmul", "plain")] > 0     # the LM, acts off
