"""Port parity for every arch of the reference's registry: the configs
(field for field, ``param_count``/``active_param_count``, the registry's
``_validate`` and ``all_cells``), each family's parameter and cache
layout, the decode of the dense, gemma3 (``first_k_dense`` and ring
slots), audio and vlm smoke configs against the JAX package, and the
launcher on every arch's smoke config (the ssm, hybrid and moe families'
decodes: test_torch_ssm.py and test_torch_moe.py).

Tolerances: configs, counts and layouts exact; decodes as
``_torch_decode.py`` states (F32_LIMIT, BF16_LIMIT).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_decode import (  # noqa: F401 (fixtures)
    CASES, decode_parity, j_tree, jax_interpret, k2_per_step,
    one_torch_thread, same_specs, t_config)
from repro.configs import registry as jreg
from repro.launch.steps import quantize_lm_for_serving as j_quantize
from repro.models.lm import cache_specs as j_cache_specs
from repro.models.lm import lm_init as j_lm_init
from repro_torch.common.tree import flatten_paths
from repro_torch.configs import registry as treg
from repro_torch.convert import from_numpy_tree
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import quantize_lm_for_serving
from repro_torch.models import lm as tlm

ARCHS = list(jreg.ARCHS)


def test_registry_matches_reference():
    """The same ids in the same order, the same cells, the same
    validation, and every config equal to the reference's field for field
    (dtypes mapped), full and smoke."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.list_models() == jreg.list_models()
    assert treg.all_cells() == jreg.all_cells()
    treg._validate()
    for arch in ARCHS:
        for smoke in (False, True):
            want = t_config(jreg.get_config(arch, smoke=smoke))
            assert treg.get_config(arch, smoke=smoke) == want, (arch, smoke)
    with pytest.raises(KeyError):
        treg.get_config("nope")


def test_registry_validation_refuses_a_duplicate_name(monkeypatch):
    monkeypatch.setitem(treg.ARCHS, "smollm-copy", treg.ARCHS["smollm-135m"])
    with pytest.raises(ImportError, match="duplicate config name"):
        treg._validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for smoke in (False, True):
        j = jreg.get_config(arch, smoke=smoke)
        tc = treg.get_config(arch, smoke=smoke)
        assert tc.param_count() == j.param_count()
        assert tc.active_param_count() == j.active_param_count()
        assert (tc.n_scanned, tc.n_groups, tc.hd) == \
            (j.n_scanned, j.n_groups, j.hd)
        assert dataclasses.asdict(tc.ssm_cfg()) == \
            dataclasses.asdict(j.ssm_cfg())
        assert dataclasses.asdict(tc.moe_cfg()) == \
            dataclasses.asdict(j.moe_cfg())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_layout_match_reference(arch):
    """The smoke config's parameter tree (paths, shapes, dtypes: the
    router f32 in any model) and cache specs (fp4 and bf16 caches) are the
    reference's; ``param_count`` counts the tree's matrices and vectors
    as the reference does for its own."""
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = t_config(jcfg)
    jshape = flatten_paths(jax.tree.map(
        lambda s: f"{tuple(s.shape)} {s.dtype}",
        jax.eval_shape(lambda: j_lm_init(jax.random.PRNGKey(0), jcfg))))
    tp = tlm.lm_init(torch.Generator().manual_seed(0), tcfg)
    tshape = {k: f"{tuple(v.shape)} {str(v.dtype).split('.')[-1]}"
              for k, v in flatten_paths(tp).items()}
    assert tshape == jshape
    for kv in ("fp4", "bf16"):
        same_specs(tlm.cache_specs(dataclasses.replace(tcfg, kv_dtype=kv),
                                   2, 8),
                   j_cache_specs(dataclasses.replace(jcfg, kv_dtype=kv),
                                 2, 8))


# smollm-135m's smoke decode: tests/test_torch_lm.py (DECODE_CASES)
OTHER_ARCHS = ["qwen1.5-0.5b", "gemma3-4b", "gemma3-27b", "musicgen-large",
               "llava-next-mistral-7b"]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_family_decode_matches(arch, case, jax_interpret):
    """8 teacher-forced steps of the arch's smoke config, the port against
    the reference: qkv bias (qwen), ``first_k_dense`` layers decoding over
    the whole cache and 5 ring layers of window 8 per group (gemma3, 8
    steps fill the ring), sinusoidal positions (musicgen), the vlm's
    backbone (llava: decode reads no patch embeddings)."""
    decode_parity(jreg.get_config(arch, smoke=True), *CASES[case])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_every_arch_on_cpu(arch):
    """``launch/serve.py --smoke --device cpu`` on every arch: W4A4, FP4
    cache; only plain versions and the plain products the reference
    computes outside any kernel (the tied readout, an untied head's and
    the MoE router's f32 products, the head's act snap) run."""
    tops.reset_routes()
    out = tserve.main(["--arch", arch, "--smoke", "--quant", "w4",
                       "--act-quant", "fp4", "--kv", "fp4", "--batch", "2",
                       "--prompt-len", "2", "--gen-len", "2",
                       "--device", "cpu"])
    cfg = treg.get_config(arch, smoke=True)
    assert out["tokens"].shape == (2, 2)
    assert out["params"] == cfg.param_count()
    steps = 4
    dense, expert = k2_per_step(cfg)
    routes = dict(tops.ROUTES)
    assert routes.pop(("w4a4_matmul", "plain")) == dense * steps
    assert routes.pop(("w4_matmul", "plain"), 0) == expert * steps
    n_attn = cfg.first_k_dense + cfg.n_groups * (
        sum(k == "attn" for k, _, _ in cfg.layer_pattern)
        + bool(cfg.shared_attn_every))
    for op in ("kv4_store", "kv4_attend"):
        assert routes.pop((op, "plain"), 0) == n_attn * steps
    if cfg.tie_embeddings:
        assert routes.pop(("tied_logits", "torch")) == steps
    else:
        assert routes.pop(("msfp_quantize", "plain")) == steps
    routers = cfg.n_groups * cfg.period if cfg.family == "moe" else 0
    assert routes.pop(("matmul", "torch_f32"), 0) == \
        (routers + (not cfg.tie_embeddings)) * steps
    assert not routes, routes


def _same_tree(got: dict, want: dict) -> int:
    """Two flat port trees equal leaf for leaf (packs byte for byte);
    returns the number of packs."""
    assert sorted(got) == sorted(want)
    n_packed = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, PackedW4):
            n_packed += 1
            assert isinstance(g, PackedW4) and g.shape == w.shape, k
            for f in ("packed", "scale", "zero_point"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (k, f)
            assert (g.exp_bits, g.man_bits, g.signed) == \
                (w.exp_bits, w.man_bits, w.signed)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), k
    return n_packed


def test_convert_carries_packed_family_trees():
    """``convert`` brings the reference's packed trees across: llama4's
    (G, E, K, N/2) expert stacks and f32 router, packed by the reference
    per tensor and per channel, equal the port's own packing of the same
    numbers byte for byte; a whole packed zamba2 and llama4 tree (SSM
    leaves ``A_log``, ``conv_w``, ``D``, ...; stacked packs) makes the
    round trip through the reference's types unchanged."""
    jcfg = jreg.get_config("llama4-scout-17b-a16e", smoke=True)
    tp = tlm.lm_init(torch.Generator().manual_seed(4), t_config(jcfg))
    moe = {k: v for k, v in tp["blocks"][0]["moe"].items() if k != "shared"}
    for pc in (False, True):
        jq = j_quantize(j_tree(moe), searched=False, per_channel=pc)
        got = from_numpy_tree(jax.tree.map(np.asarray, jq), "cpu")
        assert _same_tree(flatten_paths(got), flatten_paths(
            quantize_lm_for_serving(moe, per_channel=pc, searched=False))) == 3
    for arch in ("zamba2-2.7b", "llama4-scout-17b-a16e"):
        tq = quantize_lm_for_serving(tlm.lm_init(
            torch.Generator().manual_seed(4),
            t_config(jreg.get_config(arch, smoke=True))), searched=False)
        got = from_numpy_tree(jax.tree.map(np.asarray, j_tree(tq)), "cpu")
        assert _same_tree(flatten_paths(got), flatten_paths(tq)) == 10
