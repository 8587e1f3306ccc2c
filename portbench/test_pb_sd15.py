"""The ``sd15`` family end to end on the CPU at a tiny size: a sound run
is correct, and each way of breaking the guided path is not."""
import json
import pathlib
import shutil

import pytest
import torch

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parent
SEED = 2**31 + 99
TINY_SD = dict(image_size=8, ch=32, ch_mult=[1, 2], num_res_blocks=1,
               attn_resolutions=[4], gn_groups=8, num_heads=2, context_dim=16,
               context_len=3, T=20)


def tiny_root(tmp: pathlib.Path, max_batch: int = 2) -> pathlib.Path:
    """A checkout's benchmark files plus the cell ``tiny.t2i``: the
    ``sd15`` configuration cut to channels 32, one transformer level of 2
    heads and a 3 x 16 context, under its traffic at 5 steps and
    ``max_batch`` prompts a batch."""
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp)
    shutil.copytree(HERE, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "portbench"
    cfg = json.loads((bench / "configs" / "sd15-txt2img.json").read_text())
    cfg.update(TINY_SD)
    (bench / "configs" / "tiny-sd.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "t2i_batch_cfg.json")
                         .read_text())
    traffic.update(backlog=40, steps=5, max_batch=max_batch)
    (bench / "traffic" / "tiny_t2i.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny.t2i.json").write_text(
        '{"trajectory_gap": 1e-6, "layer_gap": 1e-5}')
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-sd", "source": "test",
                            "file": "portbench/configs/tiny-sd.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.t2i", "config": "tiny-sd",
                              "traffic": "tiny_t2i", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sd15.t2i_batch" in m.get("workloads", []):
            m["workloads"].append("tiny.t2i")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny_root(tmp_path)


def run(root, trace=False):
    cell = harness.load_cell("tiny.t2i", root)
    return harness.run_cell(cell, SEED, 1.5, trace, "cpu", 0.0)


def test_a_guided_cell_is_correct(root):
    out = run(root, trace=True)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["trajectory_gap"]["value"] == 0.0
    assert out["checks"]["layer_gap"]["value"] < 1e-5
    # each forward: 2 prompts, their uncond and cond rows together
    assert out["engine"]["mean_batch"] == 4.0
    assert out["engine"]["buckets"] == [4]
    assert {"mfu.batch", "bank_build_s"} <= set(out["metrics"])
    plain = run(root)
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}


def test_the_work_counts_the_published_model():
    fam = harness.load_family(harness.ROOT, "sd15")
    cfg = json.loads((HERE / "configs" / "sd15-txt2img.json").read_text())
    from portbench import reference_sd15
    assert reference_sd15.n_params(cfg) == cfg["parameters"] == 859520964
    by_kind = {}
    for layer in fam.layers(cfg, 1):
        key = ("attn_" + layer.site.rsplit("/", 1)[1]
               if isinstance(layer, fam.Attn) else layer.kind)
        by_kind[key] = by_kind.get(key, 0) + layer.flops
    assert round(fam.flops_per_eval(cfg) / 1e9, 1) == 803.3
    assert round(by_kind["conv"] / 1e9, 1) == 443.9
    assert round(by_kind["dense"] / 1e9, 1) == 233.3
    assert round(by_kind["attn_attn1"] / 1e9, 1) == 122.5
    assert round(by_kind["attn_attn2"] / 1e9, 1) == 3.6
    att = fam.kernel_bound_seconds(cfg, "ATT", 16)
    assert by_kind["attn_attn1"] * 16 / fam.PEAK_F32_FLOPS < att


def _stale_rows(monkeypatch):
    """Some rows' x restored at the group advance, the path the cell
    times."""
    from repro_torch.serving import engine
    orig, n = engine.sampler_advance_group, [0]

    def advance_group(states, eps):
        xs = [st.x for st in states]
        out = orig(states, eps)
        for st, x in zip(states, xs):
            n[0] += 1
            if n[0] % 4 == 3:
                st.x = x
        return out
    monkeypatch.setattr(engine, "sampler_advance_group", advance_group)


def _other_scale(monkeypatch):
    """Guidance combined at 6.5, where the traffic asks 7.5."""
    from repro_torch.serving.engine import DiffusionServingEngine
    orig = DiffusionServingEngine.submit

    def submit(self, **kw):
        kw["guidance_scale"] = 6.5
        return orig(self, **kw)
    monkeypatch.setattr(DiffusionServingEngine, "submit", submit)


def _swapped(monkeypatch):
    """Each member's uncond row served its prompt's context, and its cond
    row the null context."""
    from repro_torch.serving.engine import DiffusionServingEngine
    orig = DiffusionServingEngine._forward

    def forward(self, params, x, tb, y, context=None):
        n = context.shape[0] // 2 * 2
        idx = torch.arange(context.shape[0])
        idx[:n] = idx[:n].view(-1, 2).flip(1).reshape(-1)
        return orig(self, params, x, tb, y, context[idx])
    monkeypatch.setattr(DiffusionServingEngine, "_forward", forward)


def _other_seed(monkeypatch):
    """Each request served the context drawn for its neighbour (seed ^ 1)."""
    fam = harness.load_family(harness.ROOT, "sd15")

    def submit(self, r):
        return self.engine.submit(
            steps=r.steps, eta=r.eta, seed=r.index, sampler=r.sampler,
            arrival=r.due, guidance_scale=self.scale,
            context=self.drawn.contexts[r.index ^ 1])
    monkeypatch.setattr(fam.System, "submit", submit)
    _use(monkeypatch, fam)


def _use(monkeypatch, fam):
    """Cells load the family ``fam`` (its attributes patched)."""
    load = harness.load_family

    def load_family(root, name):
        return fam if name == "sd15" else load(root, name)
    monkeypatch.setattr(harness, "load_family", load_family)


def _key_left_out(monkeypatch):
    """The family's comparison leaves out a key of the limits file."""
    fam = harness.load_family(harness.ROOT, "sd15")
    orig = fam.compare
    monkeypatch.setattr(fam, "compare", lambda system: {
        k: v for k, v in orig(system).items() if k != "layer_gap"})
    _use(monkeypatch, fam)


@pytest.mark.parametrize("fault,check", [
    (_stale_rows, "trajectory_gap"), (_other_scale, "trajectory_gap"),
    (_swapped, "layer_gap"), (_other_seed, "layer_gap"),
    (_key_left_out, None)])
def test_a_broken_guided_path_is_not_correct(root, monkeypatch, fault,
                                             check):
    fault(monkeypatch)
    out = run(root)
    assert not out["correct"]
    if check is not None:
        assert out["checks"][check]["value"] > 1e-3
    else:
        assert out["checks"]["layer_gap"]["value"] is None


def test_a_middle_member_served_another_context_is_not_correct(
        tmp_path, monkeypatch):
    """Four prompts a forward; the cond rows of the two middle members
    (rows 3 and 5 of 8) swap contexts, the first and last rows keep
    theirs."""
    torch.set_num_threads(2)
    root = tiny_root(tmp_path, max_batch=4)
    from repro_torch.serving.engine import DiffusionServingEngine
    orig, swapped = DiffusionServingEngine._forward, [0]

    def forward(self, params, x, tb, y, context=None):
        if context.shape[0] == 8:
            idx = torch.arange(8)
            idx[3], idx[5] = 5, 3
            context = context[idx]
            swapped[0] += 1
        return orig(self, params, x, tb, y, context)
    monkeypatch.setattr(DiffusionServingEngine, "_forward", forward)
    out = run(root)
    assert swapped[0] > 0 and not out["correct"]
    assert out["checks"]["layer_gap"]["value"] > 1e-3


def test_the_control_is_not_correct(root):
    from portbench import control_sd15
    cell = harness.load_cell("tiny.t2i", root)
    gaps = control_sd15.control_gaps(cell, 3, 1.5, "cpu")
    for k in ("layer_gap", "trajectory_gap"):
        assert gaps[k] > cell.limits[k] and gaps[k] > 1e-4


def test_the_reference_is_plain_torch_with_tf32_off(monkeypatch):
    import ast
    from portbench import reference_sd15
    tree = ast.parse((HERE / "reference_sd15.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {f"{node.module}.{a.name}" for a in node.names}
    assert names <= {"__future__.annotations", "contextlib", "numpy",
                     "torch", "torch.nn.functional", "portbench.reference"}
    flags = []
    orig = reference_sd15.UNet._attention

    def attention(self, q, k, v):
        flags.append((torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
        return orig(self, q, k, v)
    monkeypatch.setattr(reference_sd15.UNet, "_attention", attention)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    fam = harness.load_family(harness.ROOT, "sd15")
    cfg = json.loads((HERE / "configs" / "sd15-txt2img.json").read_text())
    cfg.update(TINY_SD)
    gen = torch.Generator().manual_seed(0)
    weights = reference_sd15.Weights(fam.draw_params(cfg, gen),
                                     fam.draw_hubs(cfg, gen),
                                     fam.draw_router(cfg, gen), cfg)
    x = torch.randn((1, 8, 8, 4), generator=gen)
    ctx = torch.randn((1, 3, 16), generator=gen)
    out = reference_sd15.UNet(cfg)(weights.at(3), x, torch.tensor([3.0]),
                                   ctx)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert flags and all(f == (False, False) for f in flags)
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("name,cls", [
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
     "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "ATT"),
    ("at::native::cunn_SoftMaxForwardReg<float, float, float, "
     "at::native::SoftMaxForwardEpilogue, long, 4>", "ATT"),
    ("void splitKreduce_kernel<32, 16, int, float, float, float>", "ATT"),
    ("w4gemm::w4_gemm_kernel<float, 0, w4gemm::Large, ConvA<float> >", "K3"),
    ("w4gemm::splitk_reduce<float, DenseA<float> >", "K2"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x8", None),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5>", None),
    ("qdq_conv2d_kernel<float>", None)])
def test_kernel_classes_by_name(name, cls):
    import re
    fam = harness.load_family(harness.ROOT, "sd15")
    got = next((k for pat, k in fam.KERNELS.items() if re.search(pat, name)),
               None)
    assert got == cls
