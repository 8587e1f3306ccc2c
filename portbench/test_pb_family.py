"""A model family added as new files alone: a toy family that drives the
port's LM serving engine, not the diffusion engine, through the same
harness, window, trace reader and result line; and ``load_cell``'s
messages where a configuration names no family, or one with no file."""
import json
import pathlib

import pytest
import torch

from portbench import devtrace, harness, measures
from portbench.test_pb_cells import tiny_root

TOY = '''"""A toy family for the harness's tests: greedy decode on the
port's LM serving engine (``LMServingEngine``) at smollm-135m's smoke
sizes, with float32 weights drawn from the seed and one weight segment.

Model: ``repro_torch.models.lm`` at ``configs.smollm_135m.smoke()``.
Reference: the same model's full-sequence forward (``lm.forward``, no
cache) over each followed request's prompt and served tokens; a family
of the benchmark brings a plain reference of its own.
Check: ``token_gap``, the widest gap by which a served token's logit lies
below the reference's best at its position.
"""
import time

import torch

from portbench import loadgen
from portbench.harness import TAIL_S

KERNELS = {r"toy_gemm": "TOY"}
PROMPT = 4
PEAK = 989e12


def flops_per_eval(cfg):
    from repro_torch.configs import smollm_135m
    from repro_torch.models import lm
    tree = lm.lm_init(None, smollm_135m.smoke(), "meta")
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif node is not None:
            leaves.append(node.numel())
    walk(tree)
    return 2 * sum(leaves)


def kernel_bound_seconds(cfg, kernel, batch):
    return batch * flops_per_eval(cfg) / PEAK if kernel == "TOY" else 0.0


def evals_per_image(cell, reqs):
    return sum(r.steps for r in reqs) / len(reqs)


class Toy:
    def __init__(self, cell, seed, seconds, device, clock):
        from repro_torch.configs import smollm_135m
        from repro_torch.models import lm
        from repro_torch.serving import WeightBank
        from repro_torch.serving.gateway.lm_engine import LMServingEngine
        traffic = cell.traffic
        self.device, self.lm = device, smollm_135m.smoke()
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = lm.lm_init(gen, self.lm, device)
        self.reqs = loadgen.generate(
            traffic, seed, seconds,
            0 if traffic["process"] == "backlog" else TAIL_S)
        self.prompts = torch.randint(0, self.lm.vocab,
                                     (len(self.reqs), PROMPT),
                                     generator=gen, device=device)
        self.follow = [r.index for r in self.reqs[:traffic["max_batch"]]]
        bank = WeightBank(self.params, None, {}, None, None, 1,
                          max_cached=1, build_fn=lambda p: p, device=device)
        self.engine = LMServingEngine(
            self.lm, bank, max_batch=traffic["max_batch"],
            prompt_len=PROMPT, now_fn=clock.now, device=device,
            prompt_fn=lambda req: self.prompts[req.seed:req.seed + 1])
        self.closed = False

    def set_up(self):
        t0 = time.perf_counter()
        self.engine.bank.params_for_segment(0)
        return time.perf_counter() - t0

    def submit(self, r):
        return self.engine.submit(steps=r.steps, seed=r.index,
                                  arrival=r.due)

    def close(self):
        self.closed = True

    def ready(self, follow):
        return self.closed and follow <= {
            rs.req.seed for rs in self.engine.results.values()}


def build(cell, seed, seconds, device, clock):
    return Toy(cell, seed, seconds, device, clock)


def compare(system):
    from repro_torch.models import lm
    served = {rs.req.seed: rs.x0 for rs in system.engine.results.values()}
    system.engine = None
    gap = 0.0
    with torch.inference_mode():
        for i in system.follow:
            if served.get(i) is None:
                return {"token_gap": float("inf")}
            toks = served[i].long().to(system.device)
            seq = torch.cat([system.prompts[i], toks])[None]
            logits = lm.forward(system.params, system.lm,
                                seq)[0, PROMPT - 1:-1].float()
            got = logits.gather(-1, toks[:, None])[:, 0]
            gap = max(gap, float((logits.max(-1).values - got).max()))
    return {"token_gap": gap}
'''
TOY_ROOFLINE = '''"""The toy kernel: bound over device time, traced window."""
from portbench.measures import roofline_percent


def read(run):
    return roofline_percent(run, "TOY")
'''
# prompt and served tokens fill 8 positions: a multiple of the smoke
# config's query chunk, as the reference's full forward needs
TOY_TRAFFIC = {"process": "backlog", "backlog": 400, "samplers": ["greedy"],
               "steps": 4, "steps_jitter": 0, "eta": 0.0, "max_batch": 4}


def toy_root(tmp: pathlib.Path) -> pathlib.Path:
    """``tiny_root`` plus a cell of a new family, in new files and new
    entries only: the family, a configuration, a traffic mix, a limit and
    a metric."""
    root = tiny_root(tmp)
    bench = root / "portbench"
    (bench / "families" / "toy.py").write_text(TOY)
    (bench / "configs" / "toy-lm.json").write_text(json.dumps(
        {"model": "smollm-135m smoke, greedy decode", "family": "toy"}))
    (bench / "traffic" / "toy_batch.json").write_text(json.dumps(
        TOY_TRAFFIC))
    (bench / "limits" / "toy.batch.json").write_text('{"token_gap": 1e-3}')
    (bench / "metrics" / "toy_roofline.py").write_text(TOY_ROOFLINE)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-lm", "source": "test",
                            "file": "portbench/configs/toy-lm.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "toy.batch", "config": "toy-lm",
                              "traffic": "toy_batch", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("toy.batch")
    spec["per_layer"].append({
        "name": "toy_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels",
        "moves": "images_per_s", "workloads": ["toy.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return toy_root(tmp_path)


def run(root, trace=False):
    cell = harness.load_cell("toy.batch", root)
    return harness.run_cell(cell, 2**31 + 7, 1.5, trace, "cpu", 0.0)


def test_a_family_from_new_files_alone(root):
    out = run(root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert out["checks"] == {"token_gap": {"value": 0.0, "limit": 1e-3}}
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}
    assert out["engine"]["buckets"] == [1]     # the LM engine's stats
    traced = run(root, trace=True)
    assert traced["correct"] and "window_s" in traced["device"]
    assert "toy_roofline" not in traced["metrics"]   # no kernel on a CPU


def test_a_toy_token_altered_is_not_correct(root, monkeypatch):
    from repro_torch.serving.gateway import lm_engine
    orig = lm_engine.DecodeState.step

    def step(self, params, dec):
        orig(self, params, dec)
        if self.done:      # the last token, altered where it is produced
            self.output[-1] = (self.output[-1] + 1) % 128
    monkeypatch.setattr(lm_engine.DecodeState, "step", step)
    out = run(root)
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > 1e-3


@pytest.mark.parametrize("returned", [{}, {"token_gap": 0.0, "extra": 0.0}],
                         ids=["a_check_left_out", "a_check_not_limited"])
def test_a_comparison_unlike_the_limits_file_is_not_correct(root, returned):
    """Each number that the limits file names, and no other, is compared:
    a family's ``compare`` that drops one, or adds one, fails the run."""
    cell = harness.load_cell("toy.batch", root)
    compare = cell.family.compare

    def unlike(system):
        compare(system)
        return dict(returned)
    cell.family.compare = unlike
    out = harness.run_cell(cell, 2**31 + 7, 1.5, False, "cpu", 0.0)
    assert not out["correct"]
    assert set(out["checks"]) == {"token_gap"} | set(returned)
    assert out["checks"]["token_gap"]["limit"] == 1e-3


class _Exported:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        pathlib.Path(path).write_text(json.dumps({"traceEvents":
                                                  self.events}))


def test_the_family_names_its_kernels_and_bounds_them(root):
    """A trace's kernels go to the family's classes, and the roofline
    takes the family's bound."""
    cell = harness.load_cell("toy.batch", root)
    events = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "void toy_gemm<float>(int)",
         "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "ts": 400, "dur": 50,
         "name": "void w4gemm::w4_gemm_kernel<float, 0, w4gemm::Large, "
                 "w4gemm::ConvA<float> >(w4gemm::ConvA<float>)"}]
    trace = devtrace.read(_Exported(events), cell.family.KERNELS)
    assert trace.kernel_s == {"TOY": pytest.approx(200e-6)}
    assert devtrace.read(_Exported(events), harness.load_family(
        root, "unet").KERNELS).kernel_s == {"K3": pytest.approx(50e-6)}
    r = harness.Run(cell, trace=trace)
    r.traced_buckets[4] = 3
    bound = 3 * 4 * cell.family.flops_per_eval(cell.cfg) / 989e12
    assert measures.roofline_percent(r, "TOY") == pytest.approx(
        100 * bound / 200e-6)
    assert harness.load_reader(root, "toy_roofline")(r) == \
        measures.roofline_percent(r, "TOY")


def test_load_cell_names_a_missing_family(root):
    bench = root / "portbench"
    (bench / "families" / "toy.py").unlink()
    with pytest.raises(SystemExit, match=r"toy.*families/toy\.py"):
        harness.load_cell("toy.batch", root)
    (bench / "configs" / "toy-lm.json").write_text('{"model": "toy"}')
    with pytest.raises(SystemExit,
                       match=r'configs/toy-lm\.json has no "family" key'):
        harness.load_cell("toy.batch", root)
