"""The harness end to end on the CPU at tiny-ddim: a cell found from new
files alone, the faults and the control that must come out not correct,
and the runs that must print no result."""
import itertools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import control, harness

HERE = pathlib.Path(__file__).resolve().parent
TINY_BATCH = {"process": "backlog", "backlog": 400, "samplers": ["ddim"],
              "steps": 5, "steps_jitter": 0, "eta": 0.0, "max_batch": 4}
TINY_ONLINE = {"process": "poisson", "rate": 30.0, "trace_seed": 5,
               "samplers": ["ddim", "plms", "dpm_solver2"], "steps": 3,
               "steps_jitter": 4, "eta": 0.0, "max_batch": 4}
NEW_METRIC = '''"""Evals per tick over the window."""


def read(run):
    return run.evals / run.ticks if run.ticks else None
'''


def tiny_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout's benchmark files plus a tiny cell that exists only in
    new files: a configuration, a traffic mix, a limit and a metric."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp)
    shutil.copytree(HERE, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "portbench"
    cfg = json.loads((bench / "configs" / "ddim-cifar10.json").read_text())
    cfg.update(image_size=8, ch=32, ch_mult=[1, 2], num_res_blocks=1,
               attn_resolutions=[4], gn_groups=8, T=20)
    (bench / "configs" / "tiny-ddim.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_batch.json").write_text(json.dumps(TINY_BATCH))
    (bench / "traffic" / "tiny_online.json").write_text(json.dumps(
        TINY_ONLINE))
    for cell in ("tiny.batch", "tiny.online"):
        (bench / "limits" / f"{cell}.json").write_text(
            '{"trajectory_gap": 1e-6, "layer_gap": 1e-5}')
    (bench / "metrics" / "evals_per_tick.tiny.py").write_text(NEW_METRIC)
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ddim", "source": "test",
                            "file": "portbench/configs/tiny-ddim.json",
                            "reduced": [], "why": "test"})
    for cell, traffic in (("tiny.batch", "tiny_batch"),
                          ("tiny.online", "tiny_online")):
        spec["workloads"].append({"name": cell, "config": "tiny-ddim",
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        for old, new in (("cifar10.fid_batch", "tiny.batch"),
                         ("bedroom.online", "tiny.online")):
            if old in m.get("workloads", []):
                m["workloads"].append(new)
    spec["per_layer"].append({
        "name": "evals_per_tick.tiny", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "images_per_s", "workloads": ["tiny.batch"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny_root(tmp_path)


def run(root, trace=False, seed=2**31 + 99, cell="tiny.batch"):
    cell = harness.load_cell(cell, root)
    return harness.run_cell(cell, seed, 1.5, trace, "cpu", 0.0)


def test_a_cell_from_new_files_alone(root):
    out = run(root, trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    metrics = out["metrics"]
    assert metrics["evals_per_tick.tiny"]["value"] == 4.0
    assert {"bank_build_s", "mfu.batch"} <= set(metrics)
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"trajectory_gap", "layer_gap"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    plain = run(root)
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}


def test_an_open_loop_cell_past_its_knee(root):
    out = run(root, cell="tiny.online")
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] >= len(out["checks"]) and out["attempted"] < 45
    assert set(out["metrics"]) == {"images_per_s.online", "setup_s"}
    traced = run(root, trace=True, cell="tiny.online")
    assert {"mean_batch.online", "tick_ms.online"} <= set(traced["metrics"])


def test_set_up_builds_the_segments_the_traffic_routes_to(root):
    """A backlog, whose queue is known, builds the segments its requests'
    timesteps route to; open-loop traffic, every segment. Neither misses
    in the window."""
    batch = run(root)["engine"]
    assert batch["bank_misses"] == 0
    assert 0 < batch["bank_builds"] < batch["bank_segments"]
    online = run(root, cell="tiny.online")["engine"]
    assert online["bank_builds"] == online["bank_segments"]
    assert online["bank_misses"] == 0


def _noisy(root):
    cell = harness.load_cell("tiny.batch", root)
    cell.traffic = dict(cell.traffic, eta=1.0)
    return cell


def test_a_cell_at_eta_1_is_held_to_its_noise(root, monkeypatch):
    """At eta 1 each step adds noise drawn from the request's seed: the
    reference draws it again, and noise from another seed is a fault."""
    out = harness.run_cell(_noisy(root), 2**31 + 99, 1.5, False, "cpu", 0.0)
    assert out["correct"]
    assert out["checks"]["trajectory_gap"]["value"] == 0.0
    from repro_torch.serving import engine
    init = engine.sampler_init

    def other_seed(*args, seed=0, **kw):
        return init(*args, seed=seed + 1, **kw)
    monkeypatch.setattr(engine, "sampler_init", other_seed)
    out = harness.run_cell(_noisy(root), 2**31 + 99, 1.5, False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["trajectory_gap"]["value"] > 1e-3


def _group_seam(monkeypatch, after):
    """Wrap the engine's group advance, the path the cells time: ``after``
    sees each call's states and their latents from before it. Returns the
    rows of each call made, a list the run fills."""
    from repro_torch.serving import engine
    orig, calls = engine.sampler_advance_group, []

    def advance_group(states, eps):
        xs = [st.x for st in states]
        n = orig(states, eps)
        after(states, xs)
        calls.append(len(states))
        return n
    monkeypatch.setattr(engine, "sampler_advance_group", advance_group)
    return calls


def _stale_step(monkeypatch):
    rows = itertools.count()

    def after(states, xs):
        for st, x in zip(states, xs):
            if next(rows) % 4 == 3:
                st.x = x      # this row's step returns its state unchanged
    return _group_seam(monkeypatch, after)


def _half_batch(monkeypatch):
    from repro_torch.serving.engine import DiffusionServingEngine
    orig = DiffusionServingEngine._forward

    def forward(self, params, x, tb, y):
        n = x.shape[0]
        k = max(n // 2, 1)
        eps = orig(self, params, x[:k], tb[:k], y)
        rest = eps.mean(0, keepdim=True).expand(n - k, *eps.shape[1:])
        return torch.cat([eps, rest])
    monkeypatch.setattr(DiffusionServingEngine, "_forward", forward)


def _altered_answer(monkeypatch):
    def after(states, xs):
        for st in states:
            if st.done:
                st.x = st.x * 1.01    # the answer, altered where it is made
    return _group_seam(monkeypatch, after)


@pytest.mark.parametrize("fault", [_stale_step, _half_batch,
                                   _altered_answer])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    calls = fault(monkeypatch)
    out = run(root)
    assert not out["correct"]
    assert out["checks"]["trajectory_gap"]["value"] > 1e-3
    if calls is not None:     # the group advance ran, broken
        assert calls and max(calls) > 1


class _SteppedClock:
    """Advances 0.1 s each time it is read."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        self.t += 0.1
        return self.t


class _OneTickBatches:
    """A backlog engine whose every tick admits, runs and retires one
    batch, so nothing is in flight between ticks; a forward after the
    system's ``close`` is the one it records."""

    def __init__(self, system):
        self.sys = system
        self.batcher = types.SimpleNamespace(inflight=[],
                                             pending=list(range(20)))
        self.on_forward, self.n_forwards, self.n_samples_batched = [], 0, 0

    def tick(self):
        self.batcher.pending.pop()
        self.n_forwards += 1
        self.n_samples_batched += 4
        self.sys.recorded |= self.sys.closed
        for cb in self.on_forward:
            cb(self, 4)


def test_a_backlog_window_closing_between_batches_still_records():
    system = types.SimpleNamespace(device=torch.device("cpu"), closed=False,
                                   recorded=False)
    system.engine = _OneTickBatches(system)
    system.close = lambda: setattr(system, "closed", True)
    system.ready = lambda follow: system.recorded
    # the clock reads 0.8 in the window's fourth tick and 0.9 when the loop
    # looks again: the window closes between two batches
    win = harness.Window(system, _SteppedClock(), 0.85, False)
    win.run_backlog(set())
    assert win.ticks == 4 and system.closed and system.recorded
    assert system.engine.n_forwards == 5


def test_the_control_is_not_correct(root):
    cell = harness.load_cell("tiny.batch", root)
    gaps = control.control_gaps(cell, 3, 1.5, "cpu")
    for k in ("layer_gap", "trajectory_gap"):
        assert gaps[k] > cell.limits[k] and gaps[k] > 1e-4


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.nn",
                                      "torch", "jaxtyping", "reprox"]) == []
    assert harness.forbidden_modules(["repro.core"]) == ["repro"]
    assert harness.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib"]


def _bare_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "cifar10.fid_batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, env=_bare_env(), timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    root = tiny_root(tmp_path)
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from portbench import harness; "
            "cell = harness.load_cell('tiny.batch', harness.ROOT); "
            "print(harness.run_cell(cell, 1, 1.0, False, 'cpu', 0.0))")
    p = subprocess.run([sys.executable, "-c", code, str(root)],
                       capture_output=True, text=True, cwd=root,
                       env=_bare_env(), timeout=300)
    assert p.returncode != 0
    assert "repro_torch" in p.stderr
    assert "{" not in p.stdout
