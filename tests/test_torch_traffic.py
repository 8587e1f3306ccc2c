"""Port parity for the traffic layer: each module of
``repro_torch.serving.traffic`` against ``repro.serving.traffic`` on the
same inputs.

Exact equality throughout: generators draw from a numpy
``default_rng(seed)`` in both packages, traces are JSON text, and the
metrics and ``SimClock`` rows are host arithmetic on the same event times
(the engines run a stub ``apply_fn``: what is compared is who runs when,
not numerics).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.common.tree import flatten_paths as j_flatten
from repro.configs.diffusion_presets import tiny_ddim as j_tiny
from repro.core import talora as jtalora
from repro.diffusion.schedule import make_schedule as j_sched
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import WeightBank as JBank
from repro.serving import default_serving_plan as j_plan
from repro.serving import traffic as jt
from repro.serving.traffic.scenarios import SCENARIOS as J_SCENARIOS
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.convert import from_numpy_tree
from repro_torch.core import talora
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.serving import (DiffusionServingEngine, WeightBank,
                                 default_serving_plan)
from repro_torch.serving import traffic as tt
from repro_torch.serving.replay import record_ticks
from repro_torch.serving.traffic.scenarios import SCENARIOS

T = 40
TCFG = dict(hub_size=2, rank=2, t_emb_dim=16, router_hidden=8)


def _objs(reqs):
    return [tr.to_obj() for tr in reqs]


# ---------------------------------------------------------------------------
# Generators and scenarios.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(tt.OPEN_LOOP))
def test_open_loop_trace_equals_reference(kind, seed):
    mix = dict(samplers=("ddim", "plms", "dpm_solver2"), steps=7,
               steps_jitter=3, eta=0.5, seed0=11,
               deadline_s=(1.5, None, 30.0), priorities=(2, 0),
               models=("a", None))
    got = tt.open_loop_trace(kind, 17, seed, tt.RequestMix(**mix))
    want = jt.open_loop_trace(kind, 17, seed, jt.RequestMix(**mix))
    assert _objs(got) == _objs(want)
    assert sorted(tt.OPEN_LOOP) == sorted(jt.OPEN_LOOP)


def test_scenario_registry_equals_reference():
    assert tt.list_scenarios() == jt.list_scenarios()
    assert len(SCENARIOS) == 10
    for name in SCENARIOS:
        assert (dataclasses.asdict(tt.get_scenario(name))
                == dataclasses.asdict(J_SCENARIOS[name])), name


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_trace_equals_reference(name):
    scn, jscn = tt.get_scenario(name), jt.get_scenario(name)
    if scn.kind == "closed":
        for build, s in ((tt.build_trace, scn), (jt.build_trace, jscn)):
            with pytest.raises(ValueError, match="driving an engine"):
                build(s)
        return
    for seed in (0, 3):
        assert (_objs(tt.build_trace(scn, seed=seed))
                == _objs(jt.build_trace(jscn, seed=seed)))
    assert _objs(tt.build_trace(scn, seed=1, n=5)) == _objs(
        jt.build_trace(jscn, seed=1, n=5))


# ---------------------------------------------------------------------------
# Trace files.
# ---------------------------------------------------------------------------


def _rich_trace():
    """Requests that set every field, closed-loop links and models too."""
    reqs = tt.open_loop_trace("bursty", 9, 4, tt.RequestMix(
        samplers=("ddim", "plms"), deadline_s=(None, 2.5),
        priorities=(0, 3), models=(None, "tiny-ddim")))
    return [dataclasses.replace(tr, user=i % 2, parent=i - 2, think_s=0.125)
            if i >= 2 else tr for i, tr in enumerate(reqs)]


def test_trace_files_are_byte_identical_both_ways(tmp_path):
    reqs = _rich_trace()
    meta = {"scenario": "x", "seed": 4}
    port, ref = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    tt.save_trace(str(port), reqs, meta)
    jt.save_trace(str(ref), [jt.TraceRequest(**tr.to_obj()) for tr in reqs],
                  meta)
    assert port.read_bytes() == ref.read_bytes()
    assert tt.VERSION == jt.VERSION and tt.FORMAT == jt.FORMAT
    # each package reads the other's file
    got, ghead = tt.load_trace(str(ref))
    want, whead = jt.load_trace(str(port))
    assert _objs(got) == _objs(want) == _objs(reqs)
    assert ghead == whead
    # the golden fixture (v1) reads the same in both
    gold = "tests/data/golden_trace.jsonl"
    assert _objs(tt.load_trace(gold)[0]) == _objs(jt.load_trace(gold)[0])


def _single_segment_banks():
    params = {"l0": {"w": np.ones((4, 4), np.float32)}}
    jp = {"l0": {"w": jnp.asarray(params["l0"]["w"])}}
    tp = from_numpy_tree(params, "cpu")
    return (JBank(jp, j_plan(j_flatten(jp)), {}, None, None, T),
            WeightBank(tp, default_serving_plan(flatten_paths(tp)), {}, None,
                       None, T, device="cpu"))


def _stub(x):
    return 0.1 * x


def _j_engine(bank, **kw):
    return JEngine(j_tiny(4), j_sched("linear", T), bank,
                   apply_fn=lambda params, x, tb, y, ctx: _stub(x), **kw)


def _t_engine(bank, **kw):
    return DiffusionServingEngine(
        tiny_ddim(4), make_schedule("linear", T), bank, device="cpu",
        apply_fn=lambda params, x, tb, y, ctx: _stub(x), **kw)


def _engines(jbank, tbank, **kw):
    return _j_engine(jbank, **kw), _t_engine(tbank, **kw)


def test_trace_writer_captures_the_same_bytes(tmp_path):
    reqs = _rich_trace()
    jeng, teng = _engines(*_single_segment_banks(), max_batch=3)
    paths = []
    for eng, pkg, trace_req in ((jeng, jt, jt.TraceRequest),
                                (teng, tt, tt.TraceRequest)):
        path = tmp_path / f"{pkg.__name__}.jsonl"
        with pkg.TraceWriter(str(path), meta={"k": 1}) as w:
            w.attach(eng)
            pkg.submit_trace(eng, [trace_req(**tr.to_obj()) for tr in reqs])
        assert w.n == len(reqs)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()


# ---------------------------------------------------------------------------
# MetricsCollector: one event stream fed to both.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("caps", [(None, None), (5, 7)])
def test_metrics_collector_equals_reference(caps):
    """Both collectors attached to one engine run (SimClock, deadlines
    tight enough to miss and to expire, windows of two widths); with caps
    the retention buffers compact in both."""
    clock = tt.SimClock()
    teng = _t_engine(_single_segment_banks()[1], max_batch=2,
                     max_idle_sleep=0.0, now_fn=clock.now)
    clock.attach(teng)
    cols = [pkg.MetricsCollector(window_s=0.25, max_events=caps[0],
                                 max_ticks=caps[1]).attach(teng)
            for pkg in (tt, jt)]
    reqs = tt.open_loop_trace("poisson", 12, 5, tt.RequestMix(
        steps=3, steps_jitter=2, deadline_s=(0.3, None, 0.9),
        priorities=(1, 0)), rate=30.0)
    tt.submit_trace(teng, reqs)
    teng.run()
    tc, jc = cols
    s = tc.summary()
    assert s["expired"] + s["deadline_misses"] > 0   # deadlines bite
    assert s == jc.summary()
    for w in (None, 0.1):
        assert tc.windows(w) == jc.windows(w)
    for slo in ((0.5, 0.9, None), (None, 0.25, 1.0), (2.0, None, 100.0)):
        assert tc.evaluate(tt.SLO(*slo)) == jc.evaluate(jt.SLO(*slo))
    if caps[0] is not None:
        assert s["compacted_events"] > 0 and s["compacted_ticks"] > 0
    assert tt.percentile([3.0, 1.0, 2.0], 50) == jt.percentile(
        [3.0, 1.0, 2.0], 50)


# ---------------------------------------------------------------------------
# SimClock policy rows: who runs when, fifo vs slo.
# ---------------------------------------------------------------------------


def _multi_segment_banks():
    """One bank for each package from numpy-seeded params, hubs (B != 0)
    and router: the untrained router fragments [0, T) into several routing
    segments, in both packages alike."""
    rng = np.random.default_rng(7)
    params = {"l0": {"w": rng.normal(size=(8, 8)).astype(np.float32)},
              "l1": {"w": rng.normal(size=(8, 6)).astype(np.float32)}}
    h, r = TCFG["hub_size"], TCFG["rank"]
    hubs = {k: {"A": (rng.normal(size=(h, d_in, r)) / r ** 0.5
                      ).astype(np.float32),
                "B": (rng.normal(size=(h, r, d_out)) * 0.1).astype(np.float32)}
            for k, (d_in, d_out) in talora.lora_target_dims_from_weights(
                {k: v for k, v in (("l0/w", params["l0"]["w"]),
                                   ("l1/w", params["l1"]["w"]))}).items()}
    e, hid = TCFG["t_emb_dim"], TCFG["router_hidden"]
    router = {"w1": (rng.normal(size=(e, hid)) / e ** 0.5).astype(np.float32),
              "b1": np.zeros(hid, np.float32),
              "w2": (rng.normal(size=(hid, 2 * h)) / hid ** 0.5
                     ).astype(np.float32),
              "b2": np.zeros(2 * h, np.float32)}

    def banks():
        jtree = [{k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                  for k, v in t.items()} for t in (params, hubs)]
        jbank = JBank(jtree[0], j_plan(j_flatten(jtree[0])), jtree[1],
                      {k: jnp.asarray(v) for k, v in router.items()},
                      jtalora.TALoRAConfig(**TCFG), T)
        tp = from_numpy_tree(params, "cpu")
        tbank = WeightBank(tp, default_serving_plan(flatten_paths(tp)),
                           from_numpy_tree(hubs, "cpu"),
                           from_numpy_tree(router, "cpu"),
                           talora.TALoRAConfig(**TCFG), T, device="cpu")
        for b in (jbank, tbank):
            b.max_cached = b.n_segments
        return jbank, tbank
    return banks


# (scenario, max_batch, tight-tier override): the policy comparison rows of
# benchmarks/serving_bench.py (12 requests, steps 5, jitter 1)
POLICY_ROWS = [("deadline_mix", 4, (0.6, 10.0, None)),
               ("tight_deadlines", 8, None)]


def _policy_scenario(pkg, name, max_batch, deadlines):
    mix = dataclasses.replace(pkg.get_scenario(name).mix, steps=5,
                              steps_jitter=1)
    if deadlines is not None:
        mix = dataclasses.replace(mix, deadline_s=deadlines)
    return dataclasses.replace(pkg.get_scenario(name), n_requests=12,
                               max_batch=max_batch, mix=mix)


@pytest.mark.parametrize("policy", ["fifo", "slo"])
@pytest.mark.parametrize("name,max_batch,deadlines", POLICY_ROWS)
def test_simclock_policy_rows_equal_reference(name, max_batch, deadlines,
                                              policy):
    jbank, tbank = _multi_segment_banks()()
    assert ([(s.t_lo, s.t_hi) for s in tbank.segments]
            == [(s.t_lo, s.t_hi) for s in jbank.segments])
    assert tbank.n_segments >= 2
    rows = []
    for pkg, bank, engine in ((jt, jbank, _j_engine), (tt, tbank, _t_engine)):
        clock = pkg.SimClock()
        eng = engine(bank, max_batch=max_batch, policy=policy,
                     max_idle_sleep=0.0, now_fn=clock.now)
        clock.attach(eng)
        ticks = record_ticks(eng)
        summary = pkg.run_scenario(_policy_scenario(pkg, name, max_batch,
                                                    deadlines), eng, seed=0)
        summary.pop("wall_s")
        rows.append((summary, ticks, clock.t,
                     {rid: (rs.n_evals, rs.expired)
                      for rid, rs in eng.results.items()}))
    (jsum, jticks, jt_end, jout), (tsum, tticks, tt_end, tout) = rows
    assert tticks == jticks
    assert tout == jout
    assert tt_end == jt_end
    assert tsum == jsum
    print(f"{name} {policy}: goodput {tsum['goodput_frac']:.4f}, "
          f"preemptions {tsum['preemptions']}, deadline saves "
          f"{tsum['deadline_saves']}, bank builds {tsum['bank_builds']}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_loop_generator_equals_reference(seed):
    """N users with think time under a SimClock: the realized trace
    (arrivals from completions + think draws) and outcomes agree."""
    out = []
    for pkg, bank, engine in zip((jt, tt), _single_segment_banks(),
                                 (_j_engine, _t_engine)):
        clock = pkg.SimClock()
        eng = engine(bank, max_batch=2, max_idle_sleep=0.0, now_fn=clock.now)
        clock.attach(eng)
        gen = pkg.ClosedLoopGenerator(
            n_users=3, requests_per_user=3, think_mean_s=0.15,
            mix=pkg.RequestMix(steps=2, steps_jitter=1,
                               deadline_s=(0.4, None)), seed=seed)
        sent = gen.drive(eng)
        out.append((_objs(sent), {rid: (rs.n_evals, rs.expired)
                                    for rid, rs in eng.results.items()}))
    assert out[0] == out[1]
    assert len(out[1][0]) == 9
