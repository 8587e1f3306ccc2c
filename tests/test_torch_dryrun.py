"""The port's dry run (``repro_torch.launch.dryrun``) and its abstract trees
against the JAX package's (``repro.launch.dryrun``, ``repro.launch.steps``).

The abstract trees are compared leaf for leaf (path, shape, dtype) at the
ten archs' full sizes with ``jax.eval_shape``'s; the HLO parser and the
cell helpers on the reference test's sample; the per-device argument and
output bytes of six smoke cells on a (4, 2) world against the
reference's ``_compile_cell`` on a (4, 2) mesh of 8 XLA host devices; a
fake world's collectives against bytes counted by hand; the meta trace's
flops against ``FlopCounterMode`` over a real CPU run; the full-depth
counts against the reference's two-point extrapolation; and
``kv4_attend``'s choice of where its logits live. Each dry run owns its
world, so both run in processes of their own
(``tests/_torch_dryrun_worker.py``), started together once for the file.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import all_cells as ref_all_cells
from repro.configs.registry import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.core.qmodule import PackedW4 as RefPackedW4
from repro.launch import steps as ref_steps
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro_torch.configs.registry import ARCH_IDS, all_cells, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import build
from repro_torch.kernels import kv4 as tkv4
from repro_torch.kernels import meta
from repro_torch.launch import dryrun, steps
from repro_torch.launch.dryrun import StepTrace
from repro_torch.optim.adam import AdamConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dryrun_worker.py"


def _ref_dryrun():
    """The reference's dry-run module. Its import sets XLA_FLAGS for 512
    host devices (it expects a process of its own); the flag is put back
    before any backend starts in this process."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


# ---------------------------------------------------------------------------
# the two worlds, run once for the file
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {
        "port": subprocess.Popen([sys.executable, str(WORKER), "port"],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
        "ref": subprocess.Popen([sys.executable, str(WORKER), "ref"],
                                env=dict(env, REPRO_DRYRUN_DEVICES="8"),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)}
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        lines = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
        assert p.returncode == 0 and lines, f"{name} worker:\n{stderr[-3000:]}"
        out[name] = json.loads(lines[-1][len("RESULT "):])
    return out


# ---------------------------------------------------------------------------
# (1) abstract trees, leaf for leaf, at full size
# ---------------------------------------------------------------------------


def _port_leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_leaves(sub, f"{path}/#{i}").items()}
    if isinstance(tree, PackedW4):
        return {k: v for f in ("packed", "scale", "zero_point")
                for k, v in _port_leaves(getattr(tree, f),
                                         f"{path}/{f}").items()}
    assert isinstance(tree, torch.Tensor) and tree.is_meta, (path, tree)
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def _ref_leaves(tree, path="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _ref_leaves(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _ref_leaves(sub, f"{path}/#{i}").items()}
    if isinstance(tree, RefPackedW4):
        return {k: v for f in ("packed", "scale", "zero_point")
                for k, v in _ref_leaves(getattr(tree, f),
                                        f"{path}/{f}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype))}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_match_reference(arch):
    """abstract_params, quantize_abstract, abstract_opt (bf16 moments for
    the kimi class, as the dry run picks) and input_specs of every shape
    of the arch's cells, at full size, against the reference's
    ``jax.eval_shape`` trees."""
    assert ARCH_IDS == REF_ARCH_IDS and all_cells() == ref_all_cells()
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    big = cfg.param_count() > 3e11
    assert big == (rcfg.param_count() > 3e11)
    ap = steps.abstract_params(cfg)
    rap = ref_steps.abstract_params(rcfg)
    assert _port_leaves(ap) == _ref_leaves(rap)
    assert _port_leaves(steps.quantize_abstract(ap)) == _ref_leaves(
        ref_steps.quantize_abstract(rap))
    opt = steps.abstract_opt(ap, AdamConfig(
        lr=3e-4, moment_dtype=torch.bfloat16 if big else torch.float32))
    ropt = ref_steps.abstract_opt(rap, RefAdamConfig(
        lr=3e-4, moment_dtype=jnp.bfloat16 if big else jnp.float32))
    assert _port_leaves(opt) == _ref_leaves(ropt)
    for a, s in all_cells():
        if a != arch:
            continue
        scfg, rscfg = cfg, rcfg
        if SHAPES[s].kind == "decode":
            scfg = dataclasses.replace(cfg, kv_dtype="fp4")
            rscfg = dataclasses.replace(rcfg, kv_dtype="fp4")
        assert _port_leaves(steps.input_specs(scfg, SHAPES[s])) == \
            _ref_leaves(ref_steps.input_specs(rscfg, REF_SHAPES[s])), s


def test_abstract_kimi_tree_is_cheap():
    """kimi-k2's 1.03e12 parameters as meta leaves in seconds: no draw,
    no storage."""
    cfg = get_config("kimi-k2-1t-a32b")
    t0 = time.perf_counter()
    ap = steps.abstract_params(cfg)
    took = time.perf_counter() - t0
    assert took < 5.0, took
    # every leaf a meta tensor (``_port_leaves`` checks), the count the
    # config's analytic one but for the norms
    n = sum(math.prod(shape) for shape, _ in _port_leaves(ap).values())
    assert abs(n / cfg.param_count() - 1) < 1e-3


# ---------------------------------------------------------------------------
# (2) the HLO parser and the cell helpers
# ---------------------------------------------------------------------------

HLO_SAMPLES = (
    # the reference test's sample (tests/test_distribution.py)
    """
  %ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %x), dimensions={0}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %y), to_apply=%add
  %a2a = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-to-all(f32[8,8] %a, f32[8,8] %b)
""",
    "",
    "%rs = f32[4,4]{1,0} reduce-scatter(f32[16,4]{1,0} %p), dimensions={0}\n"
    "%cp = u8[128]{0} collective-permute-start(u8[128]{0} %q)\n"
    "%x = s32[2,3]{1,0} all-gather-start(s32[1,3] %r)\n",
    "%n = token[] all-reduce(token[] %t)\n%m = pred[7] all-reduce(pred[7] %u)",
)


@pytest.mark.parametrize("i", range(len(HLO_SAMPLES)))
def test_parse_collectives_matches_reference(i):
    assert dryrun.parse_collectives(HLO_SAMPLES[i]) == \
        _ref_dryrun().parse_collectives(HLO_SAMPLES[i])


@pytest.mark.parametrize("rec", [
    {"arch": "gemma3-27b", "shape": "decode_32k", "mesh": "single",
     "quant": "w4", "kv": "fp4"},
    {"arch": "kimi-k2-1t-a32b", "shape": "train_4k", "mesh": "multi",
     "opts": ["accum4", "headfix"]},
    {"arch": "smollm-135m", "shape": "prefill_32k", "mesh": "single",
     "quant": "bf16", "kv": "bf16", "opts": []},
])
def test_cell_helpers_match_reference(rec):
    ref = _ref_dryrun()
    assert dryrun.cell_id(rec) == ref.cell_id(rec)
    for arch in ("gemma3-4b", "zamba2-2.7b", "kimi-k2-1t-a32b"):
        for g in (1, 2):
            mine = dryrun.with_depth(get_config(arch), g)
            theirs = ref.with_depth(ref_get_config(arch), g)
            assert (mine.n_layers, mine.n_groups) == (theirs.n_layers,
                                                      theirs.n_groups)


# ---------------------------------------------------------------------------
# (3)-(6) the worlds
# ---------------------------------------------------------------------------

MEMORY_CELLS = [f"{a}/{k}" for a in ("smollm-135m", "llama4-scout-17b-a16e")
                for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("cell", MEMORY_CELLS)
def test_per_device_bytes_match_reference(worlds, cell):
    """Train bf16, prefill W4 and decode W4 with the FP4 cache, S 64 x
    B 8 on a (4, 2) world: the per-device argument and output bytes are
    the reference's to the byte."""
    assert worlds["port"]["memory"][cell] == worlds["ref"][cell]


@pytest.mark.parametrize("op, nbytes, count", [
    ("all-gather", 512 + 512 + 256, 3), ("all-reduce", 2 * 1024, 1),
    ("reduce-scatter", 512, 1), ("all-to-all", 256, 1)])
def test_collectives_by_hand(worlds, op, nbytes, count):
    """On the fake (4, 2) world: (8, 16) f32 gathered whole over data
    (512 B) and a (64, 16) pack gathered over data for its product (FSDP,
    512 B of codes), the product's (8, 32) f32 output, whose columns the
    pack's byte-column cut gives each rank as split-half pairs, gathered
    over model for its view (256 B, rank 0's (2, 32) rows); an (8, 32) f32 partial sum reduced whole (1024 B,
    counted twice) and scattered over model (512 B); a c10d all-to-all of
    (4, 16) f32 (256 B)."""
    hand = worlds["port"]["hand"]
    assert hand["collectives"]["bytes_by_op"][op] == nbytes
    assert hand["collectives"]["count_by_op"][op] == count
    # the product's rows stay cut over data, its columns over model
    assert hand["y_local"] == [2, 16]
    assert hand["y_placements"] == ["S(0)", "S(1)"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_meta_flops_equal_flop_counter(worlds, kind):
    """smollm-135m smoke, train bf16 and decode W4 with the FP4 cache:
    the meta trace's flops (the kernels' meta routes included) equal
    FlopCounterMode over a real CPU run through the plain routes."""
    traced, counted = worlds["port"]["flops"][kind]
    assert counted > 0 and traced == counted


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_full_depth_equals_extrapolation(worlds, kind):
    """The full-depth trace equals the reference's extrapolation from a
    1-group and a 2-group clone, ``lin(a, b) = a + (G - 1) (b - a)``, for
    every count the reference extrapolates."""
    d = worlds["port"]["depth"][kind]
    r1, r2, full = d["recs"]
    g = d["n_groups"]
    assert g > 2
    for key in ("flops", "bytes accessed", "transcendentals",
                "collective_bytes"):
        assert r1[key] + (g - 1) * (r2[key] - r1[key]) == full[key], key


# ---------------------------------------------------------------------------
# (7) kv4_attend's logits: shared memory or the global workspace
# ---------------------------------------------------------------------------

# (G, hd) of the attention archs' decode (kimi-k2, llama4-scout,
# llava-next, smollm, gemma3-4b, gemma3-27b, qwen/musicgen, zamba2)
HEAD_SHAPES = [(8, 112), (5, 128), (4, 128), (3, 64), (2, 256), (2, 128),
               (1, 64), (1, 80)]


@pytest.mark.parametrize("g, hd", HEAD_SHAPES)
def test_attend_logits_path(g, hd):
    """Shared memory up to BLOCK_SMEM_LIMIT, the workspace above it; the
    meta route allocates the workspace (B x K x G x slots f32) there and
    nothing beside its output below."""
    most = max(s for s in range(1, 60_000, 64)
               if tkv4.attend_smem_bytes(g, hd, s) <= build.BLOCK_SMEM_LIMIT)
    while tkv4.attend_smem_bytes(g, hd, most + 1) <= build.BLOCK_SMEM_LIMIT:
        most += 1
    assert tkv4.attend_logits_shared(g, hd, most)
    assert not tkv4.attend_logits_shared(g, hd, most + 1)
    b, k = 2, 2
    for slots, ws in ((most, 0), (most + 1, b * k * g * (most + 1) * 4)):
        tkv4.check_attend_shape(g, hd, slots)
        m = dict(device="meta")
        q = torch.empty(b, k, g, hd, dtype=torch.bfloat16, **m)
        codes = torch.empty(b, slots, k, hd // 2, dtype=torch.uint8, **m)
        sc = torch.empty(b, slots, k, dtype=torch.float16, **m)
        meta.reset()
        with StepTrace([q, codes, sc]) as tr:
            out = tkv4.kv4_attend(q, codes, codes, sc, sc, slots, 0.1)
        assert out.is_meta and out.shape == q.shape
        assert tr.peak == out.numel() * 2 + ws
        assert meta.COUNTS["flops"] == 4 * b * k * g * slots * hd


def test_attend_shape_still_refuses_bad_heads():
    with pytest.raises(ValueError, match="multiple of 16"):
        tkv4.check_attend_shape(2, 72, 40_000)
    with pytest.raises(ValueError, match="1 to 8"):
        tkv4.check_attend_shape(9, 128, 40_000)
    with pytest.raises(ValueError, match="1 to 8"):
        tkv4.check_attend_shape(0, 128, 64)
