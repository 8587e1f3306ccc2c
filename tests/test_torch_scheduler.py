"""Port parity for the scheduler (fifo and slo) and the weight bank's
threading contract.

Both engines run over the same random traces with a stub forward and the
same simulated clock, charged through the ``on_forward``/``on_build``
hooks, so only scheduling is compared: the per-tick (segment, member
rids), each request's outcome and timestamps, and the preemption and bank
counters must be identical. The seeds are picked so that the traces
expire requests and, under slo, preempt and save deadlines. The port's bank is the
reference's toy TALoRA bank carried across by ``convert``. The threading
tests are the reference's prefetch contract run against the port's bank:
one build per segment under concurrent fetches and prefetches, and
``builds + build_failures == misses + prefetches`` once drained.
"""
import dataclasses
import threading

import numpy as np
import pytest

from _torch_parity import np_tree, t_plan
from repro.configs.diffusion_presets import tiny_ddim as j_tiny
from repro.serving import DiffusionServingEngine as JEngine
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.convert import from_numpy_tree
from repro_torch.core import talora
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.serving import DiffusionServingEngine, WeightBank
from tests._serving_fixtures import SCHED as J_SCHED
from tests._serving_fixtures import T, multi_segment_bank


def _port_bank(jbank, max_cached=8):
    """The reference bank's params, plan, hubs and router in the port."""
    return WeightBank(
        from_numpy_tree(np_tree(jbank.q_params), "cpu"), t_plan(jbank.plan),
        from_numpy_tree(np_tree(jbank.hubs), "cpu"),
        from_numpy_tree(np_tree(jbank.router), "cpu"),
        talora.TALoRAConfig(**dataclasses.asdict(jbank.talora_cfg)),
        T, max_cached=max_cached, device="cpu")


def _stub_engine(cls, cfg, sched, bank, policy, max_batch, starve, **kw):
    """An engine whose forward is 0.1 * x on a simulated clock: a forward
    costs 0.02 s + 0.01 s per padded row, a segment build 0.03 s and a tick
    0.01 s, so the cost model learns real service times."""
    clock = [0.0]

    def charge(dt):
        clock[0] += dt
    eng = cls(cfg, sched, bank, max_batch=max_batch, starvation_ticks=starve,
              policy=policy, apply_fn=lambda p, x, tb, y, ctx: 0.1 * x,
              now_fn=lambda: clock[0], max_idle_sleep=0.0,
              async_prefetch=False, **kw)
    eng.on_tick_end.append(lambda e: charge(0.01))
    eng.on_forward.append(lambda e, rows: charge(0.02 + 0.01 * rows))
    bank.on_build.append(lambda b, seg: charge(0.03))
    log = []
    run = eng._run_partitions

    def recorded(params, items):
        log.append((eng.tick_count, eng.batcher.current_seg,
                    tuple(it[0].req.rid for it in items)))
        return run(params, items)
    eng._run_partitions = recorded
    return eng, log


def _outcomes(eng):
    res = eng.run()
    b = eng.bank
    return ({rid: (rs.n_evals, rs.expired, rs.admitted_at, rs.finished_at)
             for rid, rs in res.items()},
            (eng.batcher.preemptions, eng.batcher.deadline_saves,
             eng.tick_count),
            (b.hits, b.misses, b.prefetches, b.builds, b.evictions))


@pytest.mark.parametrize("seed", [1, 3, 7, 9])
@pytest.mark.parametrize("policy", ["fifo", "slo"])
def test_random_trace_schedule_matches_reference(policy, seed):
    rng = np.random.default_rng(seed)
    max_batch = int(rng.integers(1, 5))
    starve = int(rng.integers(2, 5))
    cap = int(rng.integers(1, 4))       # small LRU: evictions and rebuilds
    reqs = []
    for i in range(int(rng.integers(6, 12))):
        arrival = float(rng.uniform(0.0, 0.4))
        deadline = (None if rng.random() < 0.3
                    else arrival + float(rng.uniform(0.05, 1.0)))
        reqs.append(dict(steps=int(rng.integers(1, 6)), seed=i,
                         sampler=str(rng.choice(["ddim", "plms",
                                                 "dpm_solver2"])),
                         arrival=arrival, deadline=deadline,
                         priority=int(rng.integers(0, 4))))
    jbank = multi_segment_bank(max_cached=cap)
    assert jbank.n_segments >= 2
    tbank = _port_bank(jbank, max_cached=cap)
    assert [(s.t_lo, s.t_hi, s.slots) for s in tbank.segments] == \
        [(s.t_lo, s.t_hi, s.slots) for s in jbank.segments]
    jeng, jlog = _stub_engine(JEngine, j_tiny(4), J_SCHED, jbank, policy,
                              max_batch, starve)
    teng, tlog = _stub_engine(DiffusionServingEngine, tiny_ddim(4),
                              make_schedule("linear", T), tbank, policy,
                              max_batch, starve, device="cpu")
    for r in reqs:
        jeng.submit(**r)
        teng.submit(**r)
    want = _outcomes(jeng)
    got = _outcomes(teng)
    assert tlog == jlog
    assert got == want
    if (policy, seed) == ("slo", 9):
        assert got[1][:2] == (5, 1)        # preemptions, deadline saves


def test_async_prefetch_matches_sync_and_reconciles():
    def run(async_prefetch):
        bank = _port_bank(multi_segment_bank())
        eng = DiffusionServingEngine(
            tiny_ddim(4), make_schedule("linear", T), bank, max_batch=2,
            apply_fn=lambda p, x, tb, y, ctx: 0.1 * x,
            async_prefetch=async_prefetch, device="cpu")
        for i in range(4):                 # staggered submit/retire
            eng.submit(steps=5 + i % 3, seed=i)
        res = eng.run()
        return bank, {r: rs.x0.numpy().tobytes() for r, rs in res.items()}

    bank_a, out_a = run(True)
    bank_s, out_s = run(False)
    assert out_a == out_s                  # threading never changes outputs
    for bank in (bank_a, bank_s):
        assert not bank._building          # run() drains
        assert bank.builds == bank.misses + bank.prefetches
    assert bank_a.prefetches >= 1


def test_threaded_churn_builds_each_segment_once():
    bank = _port_bank(multi_segment_bank())
    bank.max_cached = bank.n_segments      # no evictions -> one build each
    n_built = {}
    built_lock = threading.Lock()
    orig_build = bank._build

    def counting_build(seg):
        with built_lock:
            n_built[seg.index] = n_built.get(seg.index, 0) + 1
        return orig_build(seg)

    bank._build = counting_build
    segs = list(range(bank.n_segments))
    errs = []

    def worker(wid):
        rng = np.random.default_rng(wid)
        try:
            for _ in range(30):
                seg = int(rng.choice(segs))
                if rng.random() < 0.5:
                    bank.prefetch(seg, block=bool(rng.random() < 0.3))
                else:
                    bank.params_for_segment(seg)
        except Exception as e:             # surface from the thread
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    bank.drain()
    assert not errs
    assert n_built == {s: 1 for s in segs}
    assert bank.builds == bank.misses + bank.prefetches == len(segs)


def test_failed_background_build_keeps_reconciliation():
    bank = _port_bank(multi_segment_bank())
    orig_build = bank._build
    bank._build = lambda seg: (_ for _ in ()).throw(RuntimeError("boom"))
    assert bank.prefetch(0, block=False)
    bank.drain()                           # swallows the ownerless error
    assert bank.build_failures == 1 and bank.builds == 0
    assert not bank.is_cached(0)
    bank._build = orig_build               # the segment builds on retry
    bank.params_for_segment(0)
    assert bank.is_cached(0)
    assert bank.builds + bank.build_failures == (bank.misses
                                                 + bank.prefetches) == 2
