"""Port parity for the serving slice: weight-bank segments and per-segment
packed bytes, the golden-trace replay (per-request outcomes and per-tick
decisions identical, x0 within the forward tolerance), the launcher, and
the port's import purity."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from repro.common.tree import flatten_paths as j_flatten
from _torch_parity import (assert_forward_close, np_tree, t_plan,
                           tiny_unet_params)
from repro.configs.diffusion_presets import tiny_ddim as j_tiny
from repro.core import talora as jtalora
from repro.diffusion.schedule import make_schedule as j_sched
from repro.nn.unet import io_sites as j_io_sites
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import VirtualClock as JClock
from repro.serving import WeightBank as JBank
from repro.serving.weight_bank import default_serving_plan as j_plan
from repro.serving.weight_bank import pack_param_tree as j_pack
from repro.serving.traffic import load_trace as j_load
from repro.serving.traffic import submit_trace as j_submit
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.convert import from_numpy_tree
from repro_torch.core import talora
from repro_torch.core.qmodule import PackedW4
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve_diffusion
from repro_torch.quant.fakequant import KIND_FP_SIGNED, QuantizerParams
from repro_torch.serving import DiffusionServingEngine, VirtualClock, WeightBank
from repro_torch.serving.replay import record_ticks
from repro_torch.serving.traffic.trace import load_trace, submit_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = str(ROOT / "tests" / "data" / "golden_trace.jsonl")
T = 100
TCFG = dict(hub_size=2, rank=4, t_emb_dim=32, router_hidden=16)


def _setup(seed=0):
    """JAX params, abs-max plan and router, and the port's trees: the same
    params and router, and hubs with B = 0 (the merge is then a no-op, so
    the reference bank needs no hubs; the bank test covers B != 0)."""
    cfg = j_tiny(8)
    params, tparams = tiny_unet_params(8, seed)
    weights = {k: v for k, v in j_flatten(params).items()
               if k.endswith("/w") and v.ndim >= 2}
    plan = j_plan(weights, io_sites=j_io_sites(params))
    jcfg = jtalora.TALoRAConfig(**TCFG)
    router = jtalora.init_router(jax.random.PRNGKey(seed), len(weights), jcfg)
    hubs = {k: {"A": torch.zeros(TCFG["hub_size"], d_in, TCFG["rank"]),
                "B": torch.zeros(TCFG["hub_size"], TCFG["rank"], d_out)}
            for k, (d_in, d_out) in talora.lora_target_dims_from_weights(
                weights).items()}
    port = {"params": tparams, "hubs": hubs,
            "router": from_numpy_tree(np_tree(router), "cpu")}
    return cfg, jcfg, params, plan, router, port


def test_weight_bank_segments_and_packed_bytes_identical(rng):
    """Converted hubs and router with a non-zero B (so the merge is not a
    no-op): identical segments and byte-identical per-segment packs, on a
    toy tree of dense and HWIO conv sites (the reference's eager merge +
    pack is slow on a whole UNet)."""
    params = {"l0": {"w": rng.normal(size=(16, 8)).astype(np.float32)},
              "c1": {"w": rng.normal(size=(3, 3, 4, 6)).astype(np.float32),
                     "b": np.zeros(6, np.float32)},
              "l2": {"w": rng.normal(size=(8, 10)).astype(np.float32)}}
    jparams = jax.tree.map(jax.numpy.asarray, params)
    jcfg = jtalora.TALoRAConfig(**TCFG)
    weights = {k: v for k, v in j_flatten(jparams).items() if k.endswith("/w")}
    plan = j_plan(weights)
    router = jtalora.init_router(jax.random.PRNGKey(1), len(weights), jcfg)
    h, r = TCFG["hub_size"], TCFG["rank"]
    hubs = {k: {"A": jax.numpy.asarray(rng.normal(size=(h, d_in, r)),
                                       np.float32),
                "B": jax.numpy.asarray(rng.normal(size=(h, r, d_out)) * 0.05,
                                       np.float32)}
            for k, (d_in, d_out) in jtalora.lora_target_dims_from_weights(
                weights).items()}
    jbank = JBank(jparams, plan, hubs, router, jcfg, T)
    tbank = WeightBank(from_numpy_tree(params, "cpu"), t_plan(plan),
                       from_numpy_tree(np_tree(hubs), "cpu"),
                       from_numpy_tree(np_tree(router), "cpu"),
                       talora.TALoRAConfig(**TCFG), T, device="cpu")
    assert [(s.t_lo, s.t_hi, s.slots) for s in tbank.segments] == \
        [(s.t_lo, s.t_hi, s.slots) for s in jbank.segments]
    assert tbank.n_segments >= 2
    for seg in (0, 1, tbank.n_segments - 1):
        jflat = flatten_paths(jbank.params_for_segment(seg))
        tflat = flatten_paths(tbank.params_for_segment(seg))
        packed = [k for k, v in tflat.items() if isinstance(v, PackedW4)]
        assert sorted(packed) == ["c1/w", "l0/w", "l2/w"]
        for k in packed:
            np.testing.assert_array_equal(
                tflat[k].packed.numpy(), np.asarray(jflat[k].packed),
                err_msg=f"segment {seg} {k}")
    d = tbank.describe()
    assert d["builds"] + d["build_failures"] == d["misses"] + d["prefetches"]


def test_golden_replay_matches_reference_engine():
    """Same params and x_T: identical per-request n_evals / expiry and
    per-tick (segment, member rids); x0 within the forward tolerance."""
    cfg, jcfg, params, plan, router, port = _setup()
    shape = (1, cfg.image_size, cfg.image_size, cfg.in_ch)
    # B = 0, so every segment serves the same packs: the reference bank
    # takes its routing as a precomputed signature sweep and a build_fn
    # handing out one pack compiled once (its eager merge + pack of a whole
    # UNet per segment would dominate the suite); the port's bank runs the
    # full router sweep + merge + pack path it serves with.
    sig = jtalora.routing_signatures(router, jax.numpy.arange(T),
                                     sorted(port["hubs"]), jcfg)
    jpacked = jax.jit(lambda p: j_pack(p, plan)[0])(params)
    old = jops.FORCE
    jops.FORCE = "xla"
    try:
        jbank = JBank(params, plan, {}, None, jcfg, T, signatures=sig,
                      build_fn=lambda p: jpacked)
        jeng = JEngine(cfg, j_sched("linear", T), jbank,
                       act_qps={"*": serve_act_qp_jax()}, max_batch=2,
                       clock=JClock())
        jlog = record_ticks(jeng)
        j_submit(jeng, j_load(GOLDEN)[0])
        jres = jeng.run()
    finally:
        jops.FORCE = old

    def noise(req):
        k0 = jax.random.split(jax.random.PRNGKey(req.seed))[1]
        return torch.from_numpy(np.asarray(jax.random.normal(k0, shape)))

    tbank = WeightBank(port["params"], t_plan(plan), port["hubs"],
                       port["router"], talora.TALoRAConfig(**TCFG), T,
                       device="cpu")
    teng = DiffusionServingEngine(
        tiny_ddim(8), make_schedule("linear", T), tbank,
        act_qps={"*": QuantizerParams(KIND_FP_SIGNED, 2, 1, 4,
                                      torch.tensor(6.0))},
        max_batch=2, clock=VirtualClock(), device="cpu", noise_fn=noise)
    tlog = record_ticks(teng)
    submit_trace(teng, load_trace(GOLDEN)[0])
    tres = teng.run()

    assert tlog == jlog
    assert sorted(tres) == sorted(jres)
    for rid, rs in tres.items():
        assert (rs.n_evals, rs.expired) == (jres[rid].n_evals,
                                            jres[rid].expired)
        assert_forward_close(rs.x0.numpy(), np.asarray(jres[rid].x0))
    assert teng.stats()["bank_builds"] == jeng.stats()["bank_builds"]


def serve_act_qp_jax():
    from repro.quant.fakequant import QuantizerParams as JQP
    return JQP(KIND_FP_SIGNED, 2, 1, 4, jax.numpy.float32(6.0))


def test_launcher_serves_tiny_preset_on_cpu(capsys):
    tops.reset_routes()
    out = serve_diffusion.main([
        "--device", "cpu", "--preset", "tiny-ddim", "--image-size", "8",
        "--trace", GOLDEN, "--replay-clock", "virtual", "--max-batch", "2"])
    text = capsys.readouterr().out
    for line in ("bank ready:", "served 6 requests (0 expired)", "latency",
                 "batching:", "weight bank:", "conv sites:", "routes:",
                 "outcome digest:"):
        assert line in text
    assert out["summary"]["requests"] == 6
    again = serve_diffusion.main([
        "--device", "cpu", "--preset", "tiny-ddim", "--image-size", "8",
        "--trace", GOLDEN, "--replay-clock", "virtual", "--max-batch", "2"])
    assert again["digest"] == out["digest"]     # deterministic replay
    off_kernel = {k for k in tops.ROUTES
                  if k[1] not in ("plain", "plain:implicit")}
    assert off_kernel == set()


def test_launcher_requests_mode_and_device_checks(capsys, monkeypatch):
    out = serve_diffusion.main([
        "--device", "cpu", "--preset", "tiny-ddim", "--image-size", "8",
        "--requests", "3", "--steps", "2", "--steps-jitter", "0",
        "--max-batch", "4"])
    assert out["summary"]["requests"] == 3 and out["evals"] == 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        serve_diffusion.main(["--device", "cuda", "--requests", "1"])


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)
