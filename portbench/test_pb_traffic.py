"""The traffic generator and the frozen copies of the port's Poisson
process and percentile."""
import numpy as np

from portbench import loadgen

ONLINE = {"process": "poisson", "rate": 2.0, "samplers": ["ddim", "plms"],
          "steps": 20, "steps_jitter": 3, "eta": 0.0, "max_batch": 16}


def test_poisson_copy_is_deterministic_from_the_seed():
    from repro_torch.serving.traffic.generators import poisson_arrivals
    big = 2**31 + 12345
    a = loadgen.poisson_arrivals(50, np.random.default_rng(big), rate=3.0)
    b = loadgen.poisson_arrivals(50, np.random.default_rng(big), rate=3.0)
    c = loadgen.poisson_arrivals(50, np.random.default_rng(big + 1), rate=3.0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(
        a, poisson_arrivals(50, np.random.default_rng(big), rate=3.0))


def test_percentile_copy_matches_the_port():
    from repro_torch.serving.traffic.metrics import percentile
    vals = sorted(np.random.default_rng(0).exponential(size=37).tolist())
    for p in (0, 10, 50, 90, 95, 99, 100):
        assert loadgen.percentile(vals, p) == percentile(vals, p)
    assert loadgen.percentile([], 90) == 0.0


def test_generate_is_deterministic_and_offers_every_seed_the_same_work():
    a = loadgen.generate(ONLINE, 7, 30.0, tail_seconds=10.0)
    assert a == loadgen.generate(ONLINE, 7, 30.0, tail_seconds=10.0)
    b = loadgen.generate(ONLINE, 8, 30.0, tail_seconds=10.0)
    win_a = [r for r in a if r.in_window]
    win_b = [r for r in b if r.in_window]
    assert len(win_a) == len(win_b) == 60
    assert all(0 <= r.due < 30.0 for r in win_a)
    assert all(r.due >= 30.0 for r in a if not r.in_window)
    sizes = sorted((r.sampler, r.steps) for r in win_a)
    assert sizes == sorted((r.sampler, r.steps) for r in win_b)
    assert [r.due for r in win_a] != [r.due for r in win_b]


def test_a_trace_seed_fixes_the_arrivals():
    fixed = dict(ONLINE, trace_seed=3)
    a = loadgen.generate(fixed, 7, 30.0)
    assert a == loadgen.generate(fixed, 8, 30.0)


def test_backlog_and_buckets():
    batch = {"process": "backlog", "backlog": 5, "samplers": ["ddim"],
             "steps": 100, "steps_jitter": 0, "max_batch": 128}
    reqs = loadgen.generate(batch, 1, 10.0)
    assert [r.due for r in reqs] == [0.0] * 5
    assert {(r.sampler, r.steps) for r in reqs} == {("ddim", 100)}
    assert loadgen.buckets(batch) == [128]
    assert loadgen.buckets(ONLINE) == [1, 2, 4, 8, 16]
