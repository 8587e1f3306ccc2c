"""The port's fleet router (``repro_torch.serving.fleet``): the reference's
``tests/test_fleet.py`` on the port, then parity with the JAX package.

Replica engines are stubs (``apply_fn`` short-circuits the UNet), as in
the reference's suite: what is pinned is the routing layer — placement
decisions per policy, ``rs.replica``/``rs.gid`` annotations and their
``pop_result`` cleanup, the 1-replica identity against a bare engine, and
deterministic replay under shared-virtual and per-replica-sim clocks.

Parity (exact equality throughout): the same traces through the JAX
router and the port's, each replica on its own ``SimClock``, under every
placement, give the same placements, reasons, tick logs and outcomes; the
reference's ``benchmarks/fleet_bench.py`` fixture beside the port's copy
gives the same rows at 1, 2 and 3 replicas, digests included (each port
request starts from the reference's x_T, and the stub's sampler
arithmetic is the same f32 operations in both packages). Then the
launcher on the CPU, and the one-replica identity on the golden trace.
"""
import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_layout, ref_x_T, report_layout
from repro.common.tree import flatten_paths as j_flatten
from repro.configs.diffusion_presets import tiny_ddim as j_tiny
from repro.diffusion.schedule import make_schedule as j_sched
from repro.launch.serve_diffusion import outcome_digest as j_digest
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import WeightBank as JBank
from repro.serving import default_serving_plan as j_plan
from repro.serving import traffic as jt
from repro.serving.fleet import FleetRouter as JFleet
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.diffusion.schedule import make_schedule, sample_timesteps
from repro_torch.launch import serve_fleet
from repro_torch.launch.serve_diffusion import outcome_digest
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, default_serving_plan)
from repro_torch.serving import traffic as tt
from repro_torch.serving.fleet import PLACEMENTS, EngineReplica, FleetRouter
from repro_torch.serving.fleet.fleet import _Queued
from repro_torch.serving.obs import Observability
from repro_torch.serving.replay import record_ticks
from repro_torch.serving.traffic import (MetricsCollector, RequestMix,
                                         open_loop_trace, submit_trace)
from repro_torch.serving.traffic.sim import SimClock

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import fleet_bench  # noqa: E402  (the reference's bench)

T = 40
GOLDEN = str(ROOT / "tests" / "data" / "golden_trace.jsonl")


def _bank(*, per_timestep=False, max_cached=8, t=T):
    """Toy single-tensor bank; ``per_timestep`` injects a T-segment
    routing signature through the WeightBank seam so every timestep is
    its own segment (affinity tests need >1 segment to say anything)."""
    params = {"l0": {"w": torch.ones(4, 4)}}
    plan = default_serving_plan(flatten_paths(params))
    sig = np.arange(t, dtype=np.int32)[:, None] if per_timestep else None
    return WeightBank(params, plan, {}, None, None, t,
                      max_cached=max_cached, signatures=sig, device="cpu")


def _stub_engine(max_batch=3, scale=0.1, per_timestep=False, **kw):
    sched = make_schedule("linear", T)
    return DiffusionServingEngine(
        tiny_ddim(4), sched, _bank(per_timestep=per_timestep),
        max_batch=max_batch, device="cpu",
        apply_fn=lambda params, x, tb, y, ctx, s=scale: s * x, **kw)


def _fleet(n=2, placement="round_robin", clock=None, per_timestep=False,
           **eng_kw):
    fleet = FleetRouter(placement=placement, clock=clock)
    kw = dict(eng_kw)
    if clock is not None:
        kw["clock"] = clock
    for _ in range(n):
        fleet.add_replica(_stub_engine(per_timestep=per_timestep, **kw))
    return fleet


def _seg0(steps=2):
    """The first routing segment every request shares: samplers start at
    the top of their subsequence, so seg0 = segment_of(T - 1)."""
    return int(sample_timesteps(T, steps)[0])


# ---------------------------------------------------------------------------
# Placement policies.
# ---------------------------------------------------------------------------


def test_fleet_round_robin_cycles_replicas():
    fleet = _fleet(2, "round_robin", clock=VirtualClock())
    gids = [fleet.submit(steps=1, seed=i) for i in range(4)]
    res = fleet.run()
    assert set(res) == set(gids)
    names = [fleet.route[g][0] for g in gids]
    assert names == ["r0", "r1", "r0", "r1"]
    s = fleet.stats()["aggregate"]
    assert s["placements"] == {"r0": 2, "r1": 2}
    assert s["placement_reasons"] == {"rr": 4}
    for gid, rs in res.items():
        assert rs.gid == gid
        assert rs.replica == fleet.route[gid][0]


def test_fleet_least_loaded_avoids_busy_replica():
    fleet = _fleet(2, "least_loaded", clock=VirtualClock())
    # load r0 directly (bypassing the router is allowed; such requests
    # just never get gids) so the policy has an imbalance to react to
    r0 = fleet.replica("r0")
    for i in range(3):
        r0.engine.submit(steps=1, seed=10 + i)
    assert r0.load == 3 and fleet.replica("r1").load == 0
    g0 = fleet.submit(steps=1, seed=0)
    g1 = fleet.submit(steps=1, seed=1)
    res = fleet.run()
    # only routed requests surface fleet-side
    assert set(res) == {g0, g1}
    assert fleet.route[g0][0] == "r1" and fleet.route[g1][0] == "r1"
    assert fleet.stats()["aggregate"]["placement_reasons"] == \
        {"least_loaded": 2}


def test_fleet_segment_affinity_routes_to_warm_bank():
    fleet = _fleet(2, "segment_affinity", clock=VirtualClock(),
                   per_timestep=True)
    r1 = fleet.replica("r1")
    seg = r1.bank.segment_of(_seg0())
    r1.bank.prefetch(seg, block=True)
    assert r1.holds(seg) == "cached"
    assert fleet.replica("r0").holds(seg) is None
    g = fleet.submit(steps=2, seed=0)
    fleet.run()
    assert fleet.route[g][0] == "r1"
    assert fleet.stats()["aggregate"]["placement_reasons"]["affinity_hit"] \
        == 1


def test_fleet_segment_affinity_universal_miss_falls_back():
    fleet = _fleet(2, "segment_affinity", clock=VirtualClock(),
                   per_timestep=True)
    g = fleet.submit(steps=2, seed=0)
    fleet.run()
    assert fleet.route[g][0] == "r0"     # least-loaded tiebreak by index
    reasons = fleet.stats()["aggregate"]["placement_reasons"]
    assert reasons["affinity_miss"] >= 1


def test_fleet_segment_affinity_ready_beats_building_beats_load():
    fleet = _fleet(3, "segment_affinity", clock=VirtualClock(),
                   per_timestep=True)
    q = _Queued(gid=0, arrival=0.0, kw={}, seg0=7)
    # monkeypatch holds() so the ranking is tested without racing real
    # background builds
    states = {"r0": "building", "r1": "cached", "r2": "cached"}
    for rep in fleet.replicas:
        rep.holds = lambda seg, s=states[rep.name]: s
    fleet.replica("r2").engine.submit(steps=1, seed=0)   # r2 heavier
    i, reason = fleet._choose(q)
    assert fleet.replicas[i].name == "r1" and reason == "affinity_hit"
    states["r1"] = states["r2"] = None
    for rep in fleet.replicas:
        rep.holds = lambda seg, s=states[rep.name]: s
    i, reason = fleet._choose(q)
    assert fleet.replicas[i].name == "r0" and reason == "affinity_building"
    # a ready replica beats a lighter one mid-build
    states.update(r0="building", r2="cached")
    for rep in fleet.replicas:
        rep.holds = lambda seg, s=states[rep.name]: s
    i, reason = fleet._choose(q)
    assert fleet.replicas[i].name == "r2" and reason == "affinity_hit"


def test_fleet_stub_bank_degrades_affinity_gracefully():
    # a single-segment toy bank answers segment 0 for everything; a bank
    # with no schedule at all (seg0 None) must fall back to least-loaded
    # instead of raising
    fleet = _fleet(2, "segment_affinity", clock=VirtualClock())
    q_seg = fleet._first_segment({"steps": 2})
    assert q_seg == 0      # single-segment bank: everything is segment 0
    g = fleet.submit(steps=2, seed=0)
    res = fleet.run()
    assert g in res


# ---------------------------------------------------------------------------
# Registration + submit surface.
# ---------------------------------------------------------------------------


def test_fleet_rejects_model_routing_duplicates_and_busy_engines():
    with pytest.raises(RuntimeError, match="no replicas"):
        FleetRouter().submit(steps=1)
    with pytest.raises(ValueError, match="placement"):
        FleetRouter(placement="sticky")
    fleet = FleetRouter()
    fleet.add_replica(_stub_engine(), name="a")
    with pytest.raises(ValueError, match="already registered"):
        fleet.add_replica(_stub_engine(), name="a")
    busy = _stub_engine()
    busy.submit(steps=1)
    with pytest.raises(ValueError, match="already has requests"):
        fleet.add_replica(busy)
    with pytest.raises(ValueError, match="gateway"):
        fleet.submit(model="tiny-ddim", steps=1)
    with pytest.raises(KeyError, match="unknown replica"):
        fleet.replica("zzz")
    assert isinstance(fleet.replica("a"), EngineReplica)


def test_fleet_pop_result_prunes_all_bookkeeping():
    fleet = _fleet(2, "round_robin", clock=VirtualClock())
    gids = [fleet.submit(steps=1, seed=i) for i in range(4)]
    res = fleet.run()
    assert len(res) == 4
    for g in gids:
        rs = fleet.pop_result(g)
        assert rs.gid == g
    assert fleet.results == {} and fleet.route == {}
    for rep in fleet.replicas:
        assert rep.gid_of == {}
        assert rep.engine.results == {}
    with pytest.raises(KeyError):
        fleet.pop_result(gids[0])


# ---------------------------------------------------------------------------
# Determinism + the 1-replica identity.
# ---------------------------------------------------------------------------


def _trace():
    mix = RequestMix(samplers=("ddim", "plms"), steps=2, steps_jitter=1,
                     priorities=(1, 0))
    return open_loop_trace("poisson", 6, seed=4, mix=mix, rate=30.0)


def test_fleet_one_replica_round_robin_is_bare_engine():
    """The run() driver's advance condition: at N=1 the fleet adds zero
    behavior — identical digest to engine.run()."""
    reqs = _trace()
    eng = _stub_engine(max_batch=2, clock=VirtualClock())
    submit_trace(eng, reqs)
    direct = outcome_digest(eng.run())

    fleet = _fleet(1, "round_robin", clock=VirtualClock(), max_batch=2)
    submit_trace(fleet, reqs)
    assert outcome_digest(fleet.run()) == direct


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_fleet_replay_is_deterministic(placement):
    reqs = _trace()

    def once():
        fleet = _fleet(2, placement, clock=VirtualClock(), max_batch=2,
                       per_timestep=True)
        collector = MetricsCollector()
        collector.attach(fleet)
        submit_trace(fleet, reqs)
        res = fleet.run()
        for rep in fleet.replicas:
            b = rep.bank
            assert (b.builds + b.build_failures
                    == b.misses + b.prefetches), rep.name
        return (outcome_digest(res), fleet.stats()["aggregate"],
                collector.summary()["goodput_frac"])

    d1, a1, g1 = once()
    d2, a2, g2 = once()
    assert d1 == d2
    assert a1["placements"] == a2["placements"]
    assert a1["placement_reasons"] == a2["placement_reasons"]
    assert a1["bank_hit_rate"] == a2["bank_hit_rate"]
    assert g1 == g2
    assert a1["requests"] + a1["expired"] == 6


def test_fleet_per_replica_sim_clocks_drain():
    """Each replica on its own SimClock axis (parallel hosts): the fleet
    clock is their minimum, the run drains, and per-replica stats
    reconcile with the aggregate."""
    fleet = FleetRouter(placement="round_robin", max_idle_sleep=0.0)
    sims = []
    for _ in range(2):
        sim = SimClock(tick_base_s=0.01, sample_s=0.005)
        eng = _stub_engine(max_batch=2, now_fn=sim.now, max_idle_sleep=0.0)
        sim.attach(eng)
        fleet.add_replica(eng)
        sims.append(sim)
    mix = RequestMix(steps=1, steps_jitter=0)
    submit_trace(fleet, open_loop_trace("poisson", 4, seed=3, mix=mix,
                                        rate=50.0))
    res = fleet.run()
    assert len(res) == 4
    assert all(sim.now() > 0.0 for sim in sims)
    s = fleet.stats()
    assert s["aggregate"]["requests"] == 4
    assert sum(s["aggregate"]["placements"].values()) == 4
    assert sum(p["engine"]["requests"]
               for p in s["per_replica"].values()) == 4


def test_fleet_route_instants_and_replica_labels():
    obs = Observability()
    clock = VirtualClock()
    fleet = FleetRouter(placement="round_robin", clock=clock, obs=obs)
    for _ in range(2):
        fleet.add_replica(_stub_engine(max_batch=2, clock=clock, obs=obs))
    gids = [fleet.submit(steps=1, seed=i) for i in range(3)]
    fleet.run()
    routes = [e for e in obs.tracer.events()
              if e.get("ph") == "i" and e["name"] == "route"]
    assert len(routes) == 3
    assert {e["args"]["gid"] for e in routes} == set(gids)
    assert {e["args"]["replica"] for e in routes} == {"r0", "r1"}
    for e in routes:
        assert e["cat"] == "fleet"
        assert e["args"]["placement"] == "round_robin"
        assert e["args"]["reason"] == "rr"


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------


def _ref_noise(shape):
    """Each port request's x_T: the reference sampler's draw for its seed."""
    return lambda req: torch.from_numpy(np.array(ref_x_T(
        jax.random.PRNGKey(req.seed), shape)))


def _j_stub(bank, t, **kw):
    return JEngine(j_tiny(4), j_sched("linear", t), bank,
                   apply_fn=lambda params, x, tb, y, ctx: 0.1 * x, **kw)


def _t_stub(bank, t, **kw):
    return DiffusionServingEngine(
        tiny_ddim(4), make_schedule("linear", t), bank, device="cpu",
        noise_fn=_ref_noise((1, 4, 4, 3)),
        apply_fn=lambda params, x, tb, y, ctx: 0.1 * x, **kw)


def _j_bank(t, max_cached, per_timestep=True):
    params = {"l0": {"w": jax.numpy.ones((4, 4))}}
    sig = np.arange(t, dtype=np.int32)[:, None] if per_timestep else None
    return JBank(params, j_plan(j_flatten(params)), {}, None, None, t,
                 max_cached=max_cached, signatures=sig)


def _sim_fleet(pkg_fleet, make_engine, make_bank, sim_cls, placement, n,
               t, max_batch, build_s=0.0):
    """A fleet of ``n`` stub replicas, each on its own SimClock; each
    engine's tick log recorded."""
    fleet = pkg_fleet(placement=placement, max_idle_sleep=0.0)
    logs = []
    for _ in range(n):
        sim = sim_cls(build_s=build_s)
        eng = make_engine(make_bank(), t, max_batch=max_batch,
                          now_fn=sim.now, max_idle_sleep=0.0)
        sim.attach(eng)
        logs.append(record_ticks(eng))
        fleet.add_replica(eng)
    return fleet, logs


def _fleet_record(fleet, logs, summary=None) -> dict:
    agg = fleet.stats()["aggregate"]
    return {"route": dict(fleet.route), "ticks": logs,
            "outcomes": {g: (rs.n_evals, rs.expired, rs.replica)
                         for g, rs in fleet.results.items()},
            "placements": agg["placements"],
            "reasons": agg["placement_reasons"],
            "hit_rate": agg["bank_hit_rate"], "builds": agg["bank_builds"],
            "summary": summary}


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_fleet_routing_equals_reference(placement):
    """One trace with deadlines through the JAX router and the port's, two
    replicas on per-replica SimClocks with a per-timestep segmentation:
    the same placements and reasons, gid routes, per-replica tick logs,
    outcomes, bank counters and x0 digest."""
    reqs = tt.open_loop_trace("poisson", 10, 2, tt.RequestMix(
        samplers=("ddim", "plms"), steps=4, steps_jitter=2,
        deadline_s=(0.5, None)), rate=20.0)
    recs, digests = [], []
    for pkg, fleet_cls, engine, bank in (
            (jt, JFleet, _j_stub, lambda: _j_bank(T, 3)),
            (tt, FleetRouter, _t_stub, lambda: _bank(per_timestep=True,
                                                     max_cached=3))):
        fleet, logs = _sim_fleet(fleet_cls, engine, bank, pkg.SimClock,
                                 placement, 2, T, 2, build_s=0.05)
        pkg.submit_trace(fleet, [pkg.TraceRequest(**tr.to_obj())
                                 for tr in reqs])
        fleet.run()
        recs.append(_fleet_record(fleet, logs))
        digests.append((j_digest if pkg is jt else outcome_digest)(
            fleet.results))
    jrec, trec = recs
    assert trec == jrec
    assert digests[0] == digests[1]
    assert sum(jrec["placements"].values()) == 10


def _t_bench_fleet(placement, n):
    """The port's copy of ``benchmarks/fleet_bench.py:_fleet``."""
    sched = make_schedule("linear", fleet_bench.T)
    fleet = FleetRouter(placement=placement, max_idle_sleep=0.0)
    for _ in range(n):
        sim = SimClock(build_s=fleet_bench.BUILD_S)
        engine = DiffusionServingEngine(
            tiny_ddim(4), sched, _bank(per_timestep=True,
                                       max_cached=fleet_bench.BANK_CAP,
                                       t=fleet_bench.T),
            max_batch=4, device="cpu", noise_fn=_ref_noise((1, 4, 4, 3)),
            apply_fn=lambda params, x, tb, y, ctx: 0.1 * x,
            now_fn=sim.now, max_idle_sleep=0.0)
        sim.attach(engine)
        fleet.add_replica(engine)
    return fleet


def _t_bench_scenario():
    scn = tt.get_scenario("deadline_mix")
    return dataclasses.replace(
        scn, n_requests=fleet_bench.N_REQUESTS, max_batch=4,
        mix=dataclasses.replace(scn.mix,
                                steps_jitter=fleet_bench.STEPS_JITTER),
        gen_kw=(("rate", fleet_bench.RATE),))


def _bench_row(pkg, fleet, scn, digest) -> dict:
    summary = pkg.run_scenario(scn, fleet, seed=0)
    agg = fleet.stats()["aggregate"]
    for rep in fleet.replicas:
        b = rep.bank
        assert b.builds + b.build_failures == b.misses + b.prefetches
    return {"hit_rate": agg["bank_hit_rate"],
            "goodput": summary["goodput_frac"],
            "builds": agg["bank_builds"], "expired": summary["expired"],
            "placements": agg["placements"],
            "reasons": agg["placement_reasons"],
            "duration": summary["duration_s"],
            "digest": digest(fleet.results)}


@pytest.mark.parametrize("n_replicas", fleet_bench.REPLICAS)
def test_fleet_bench_rows_equal_reference(n_replicas):
    """The fleet bench's fixture (per-timestep segmentation over T = 50,
    bank cap 6, SimClock(build_s=0.6), deadline_mix at 20 requests, 6
    req/s, steps jitter 4) in both packages: each row's hit rate,
    goodput, builds, expiries, placements, reasons, simulated duration
    and digest equal; segment affinity beats round robin on hit rate and
    goodput at 2 and 3 replicas."""
    policies = PLACEMENTS if n_replicas > 1 else ("round_robin",)
    rows = {}
    for placement in policies:
        jrow = _bench_row(jt, fleet_bench._fleet(placement, n_replicas),
                          fleet_bench._scenario(), j_digest)
        trow = _bench_row(tt, _t_bench_fleet(placement, n_replicas),
                          _t_bench_scenario(), outcome_digest)
        assert trow == jrow, placement
        rows[placement] = trow
        print(f"fleet r={n_replicas} {placement}: {trow}")
    if n_replicas > 1:
        aff, rr = rows["segment_affinity"], rows["round_robin"]
        assert aff["hit_rate"] > rr["hit_rate"]
        assert aff["goodput"] > rr["goodput"]


def test_fleet_one_replica_golden_is_bare_engine():
    """The golden trace on tiny-ddim at the launcher's shaping (random
    weights, abs-max plan, TALoRA bank, E2M1 acts): a one-replica
    round-robin fleet gives the bare engine's tick log and digest."""
    args = serve_fleet.build_parser().parse_args([
        "--replicas", "1", "--placement", "rr", "--clock", "virtual",
        "--device", "cpu", "--image-size", "8", "--T", "50"])
    args.fleet_max_batch = 2
    fleet, _ = serve_fleet.build_fleet(args)
    eng = fleet.replicas[0].engine
    bare = DiffusionServingEngine(eng.cfg, eng.sched, WeightBank(
        eng.bank.q_params, eng.bank.plan, eng.bank.hubs, eng.bank.router,
        eng.bank.talora_cfg, eng.bank.T, max_cached=2, device="cpu"),
        act_qps=eng.ctx.act_qps, max_batch=2, clock=VirtualClock(),
        device="cpu")
    reqs = tt.load_trace(GOLDEN)[0]
    logs = [record_ticks(e) for e in (bare, eng)]
    submit_trace(bare, reqs)
    direct = outcome_digest(bare.run())
    submit_trace(fleet, reqs)
    assert outcome_digest(fleet.run()) == direct
    assert logs[0] == logs[1] and len(logs[0]) > 0


def test_fleet_launcher_reconciles_every_bank(capsys):
    out = serve_fleet.main(["--device", "cpu", "--smoke", "--replicas", "2",
                            "--placement", "affinity", "--clock", "sim"])
    text = capsys.readouterr().out
    assert "fleet ready: 2 replicas" in text and "outcome digest:" in text
    assert all(r["bank_reconciled"] for r in out["per_replica"].values())
    agg = out["aggregate"]
    assert sum(agg["placements"].values()) == out["n_requests"] == 2
    assert agg["requests"] + agg["expired"] == 2
    assert out["kernels"] == "plain"


def test_fleet_launcher_report_keys_match_reference(tmp_path):
    """``--report-json`` carries the reference launcher's fields (its
    report literal, ``report_layout``), the aggregate ``FleetRouter.stats``
    gives, and the reference's per-replica engine stats."""
    path = tmp_path / "report.json"
    out = serve_fleet.main(["--device", "cpu", "--smoke", "--replicas", "2",
                            "--placement", "rr", "--clock", "sim",
                            "--report-json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(
        out, sort_keys=True, default=float))
    assert_layout(out, report_layout(ROOT / "src/repro/launch/serve_fleet.py"))
    assert_layout(out["aggregate"], report_layout(
        ROOT / "src/repro/serving/fleet/fleet.py", "stats", "agg"))
