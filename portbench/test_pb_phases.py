"""``portbench/phases.py`` on the CPU: idle time by phase on a hand-built
Chrome trace, set-up's merge spans told from the window's by the mark at
the clock's restart, and a tiny traced run through the harness's pieces
with the engine's tracer on, off and overflowing."""
import pytest
import torch

from portbench import harness, phases
from portbench.test_pb_cells import tiny_root


def _x(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_idle_by_phase_splits_a_gap_between_the_phases_it_crosses():
    events = [
        _x("portbench.window", 0, 100),
        _x("portbench.tick", 2, 95),
        _x("engine.tick", 5, 90),
        _x("engine.advance", 20, 20),
        _x("engine.prefetch", 40, 15),
        # another thread's range over the same gap is no phase of the tick
        _x("bank.bank_build", 15, 50, tid=2),
        # the device: busy before the window and to 10, then 60 to 97
        _x("kernel_a", -5, 15, tid=7, cat="kernel"),
        _x("kernel_b", 60, 37, tid=7, cat="kernel"),
    ]
    got = dict(phases.idle_phases(events))
    # the gap 10-60 crosses the tick's own code (10-20, 55-60), advance
    # (20-40) and prefetch (40-55); 97-100 lies outside the engine
    assert got == pytest.approx({"engine.tick": 15e-6,
                                 "engine.advance": 20e-6,
                                 "engine.prefetch": 15e-6,
                                 phases.OUTSIDE: 3e-6})
    assert phases.idle_share(phases.idle_phases(events), "engine.advance",
                             100e-6) == pytest.approx(20.0)
    assert phases.idle_in(events, "portbench.tick") == pytest.approx(50e-6)
    # a trace of a program without ranges has nothing to read
    plain = [e for e in events if not e["name"].startswith(("engine.",
                                                            "bank."))]
    assert phases.idle_phases(plain) is None
    assert phases.idle_share(None, "engine.advance", 1.0) is None


def _span(name, ts, dur, cat="engine", tid=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_setup_merges_come_from_before_the_clock_restart_only():
    setup = [_span("merge", 9e6, 2e5, "bank"), _span("pack", 9.2e6, 3e5,
                                                     "bank"),
             _span("bank_build", 9e6, 5e5, "bank"),
             _span("merge", 9.5e6, 1e5, "bank")]
    window = [
        # the clock restarts: a build in the window is no set-up's
        _span("merge", 1e3, 4e5, "bank"),
        _span("sync", 1.5e4, 4e3), _span("tick", 1e4, 1e4),
        {"ph": "i", "name": "eval", "cat": "request", "ts": 2e4, "tid": 0,
         "args": {}},
        _span("tick", 3e4, 2e3, idle=True),
        _span("sync", 4.2e4, 1e3), _span("tick", 4e4, 6e3),
        # begun past the window's end (0.05 s)
        _span("sync", 6e4, 5e4), _span("tick", 6e4, 6e4)]
    spans = phases.split(setup + window, len(setup), 0.05, dropped=0)
    assert phases.merge_s(spans) == pytest.approx(0.3)
    # busy ticks of 10 and 6 ms less their syncs of 4 and 1
    assert phases.host_ms(spans) == pytest.approx(5.5)
    assert phases.split(setup + window, len(setup), 0.05, dropped=3) is None
    assert phases.merge_s(None) is None and phases.host_ms(None) is None


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path_factory.mktemp("tiny"))
    return harness.load_cell("tiny.batch", root)


def test_a_tiny_traced_run_reads_every_number(tiny_cell):
    from repro_torch.serving.obs import NULL_OBS, Observability
    seed = 2**31 + 7
    out = phases.traced_run(tiny_cell, seed, 1.5, Observability(), "cpu")
    assert out["tracer"]["dropped"] == 0
    for k in ("host_ms", "bank_merge_s", "idle_advance_pct",
              "idle_launch_pct", "tick_self_pct"):
        assert isinstance(out[k], float) and out[k] >= 0, k
    assert out["host_ms"] > 0 and out["bank_merge_s"] > 0
    assert out["bank_merge_s"] < out["bank_build_s"]
    # the idle by phase adds up to the window's idle (all of it on a CPU)
    assert out["idle_phases_sum_s"] == pytest.approx(out["idle_s"])
    names = {n for n, _ in out["idle_phases"]}
    assert {"engine.advance", "engine.launch", "engine.stage"} <= names
    assert out["phase_ms"]["tick"] >= out["phase_ms"]["forward"] > 0

    off = phases.traced_run(tiny_cell, seed, 1.5, NULL_OBS, "cpu")
    for k in ("host_ms", "bank_merge_s", "idle_advance_pct",
              "idle_launch_pct", "idle_phases"):
        assert off[k] is None, k
    assert off["device_idle_pct"] > 0

    small = phases.traced_run(tiny_cell, seed, 1.5,
                              Observability(max_events=200), "cpu")
    assert small["tracer"]["dropped"] > 0
    assert small["host_ms"] is None and small["bank_merge_s"] is None
    # the profiler's ranges do not pass through the ring
    assert small["idle_advance_pct"] is not None
