"""Port parity for the distribution layer's rules, in process with no
devices: the port's ``param_shardings`` / ``param_spec``, ``cache_spec``,
``data_spec``, ``logical_spec`` and ``_filter_entry`` against the JAX
package's on fake meshes of 8, 256 and 512 ranks (a mesh is read through
its axis names and sizes only: ``jax.sharding.AbstractMesh`` on the
reference's side, an object with ``mesh_dim_names`` and ``shape`` on the
port's); the spec-to-placements map; and item 14's leftovers
(``common/tree.py``'s helpers, ``lora_target_sites``, ``embed_*``,
``gaussian_bump_images`` fed the reference's draws).

Every spec must equal the reference's after trailing ``None`` entries are
dropped (``P('model', None)`` and ``P('model')`` shard alike); numbers
within 1e-6 (the bump images) or bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from _torch_decode import j_tree, one_torch_thread, t_config  # noqa: F401
from _torch_parity import tiny_unet_params
from repro.common import sharding as jshard
from repro.common import tree as jtree
from repro.configs import registry as jreg
from repro.data import synthetic as jdata
from repro.launch import sharding as jsh
from repro.models import lm as jlm
from repro.nn import layers as jlayers
from repro.nn import unet as junet
from repro_torch.common import sharding as tshard
from repro_torch.common import tree as ttree
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.qmodule import PackedW4
from repro_torch.data import synthetic as tdata
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import mesh_scope
from repro_torch.launch.steps import quantize_lm_for_serving
from repro_torch.models import lm as tlm
from repro_torch.nn import layers as tlayers
from repro_torch.nn import unet as tunet

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OPTIONS = ({}, {"fsdp": False}, {"fsdp_over_pod": True}, {"cfg": True},
           {"tp": False})


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """What the port reads of a DeviceMesh."""
    shape: tuple
    mesh_dim_names: tuple


def meshes(name):
    shape, axes = MESHES[name]
    return FakeMesh(shape, axes), AbstractMesh(shape, axes)


def norm(spec) -> tuple:
    """A spec as a tuple without trailing None entries."""
    s = list(tuple(spec))
    while s and s[-1] is None:
        s.pop()
    return tuple(s)


def j_specs(tree) -> dict:
    """path -> spec of a JAX tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsh.path_str(p): norm(s.spec) for p, s in flat}


def t_specs(tree) -> dict:
    return {tsh.path_str(p): norm(s.spec)
            for p, s in tsh._leaves_with_path(tree)}


def smoke(arch):
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = t_config(jcfg)
    tp = tlm.lm_init(torch.Generator().manual_seed(0), tcfg)
    return jcfg, tcfg, tp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch):
    """Every leaf path of the arch's smoke params, float and W4-packed,
    on each mesh under each option."""
    jcfg, tcfg, tp = smoke(arch)
    trees = {"float": (tp, j_tree(tp))}
    tq = quantize_lm_for_serving(tp, searched=False)
    trees["w4"] = (tq, j_tree(tq))
    n = 0
    for name in MESHES:
        tm, jm = meshes(name)
        for kind, (t_params, j_params) in trees.items():
            for opt in OPTIONS:
                tkw = {**opt, "cfg": tcfg} if "cfg" in opt else opt
                jkw = {**opt, "cfg": jcfg} if "cfg" in opt else opt
                got = t_specs(tsh.param_shardings(t_params, tm, **tkw))
                want = j_specs(jsh.param_shardings(j_params, jm, **jkw))
                assert got == want, (name, kind, opt)
                n += len(got)
    assert n > 0
    # the packed trees reach the packed-path rule
    assert any(p.endswith("/packed") for p in got)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kv", ["bf16", "fp4"])
def test_cache_specs_match_reference(arch, kv):
    jcfg = dataclasses.replace(jreg.get_config(arch, smoke=True), kv_dtype=kv)
    tcfg = t_config(jcfg)
    tc = tlm.init_caches(tcfg, 32, 16)
    jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, 32, 16))
    for name in MESHES:
        tm, jm = meshes(name)
        got = {p: norm(s.spec) for p, s in
               ttree.flatten_paths(tsh.cache_shardings(tc, tm)).items()}
        want = {p: norm(jsh.cache_spec(p, tuple(l.shape), jm))
                for p, l in jtree.flatten_paths(jc).items()}
        assert got == want, name


def test_data_spec_matches_reference():
    for name in MESHES:
        tm, jm = meshes(name)
        for shape in ((8, 16), (512, 4096), (1, 128), (64, 1), (32, 576, 8)):
            for bd in range(len(shape)):
                for axes in (tsh.DP_AXES, ("data",), ("data", "model")):
                    assert norm(tsh.data_spec(shape, tm, batch_dim=bd,
                                              axes=axes)) == \
                        norm(jsh.data_spec(shape, jm, batch_dim=bd,
                                           axes=axes))


def test_logical_spec_and_filter_entry_match_reference():
    entries = [(tshard.DP, None, tshard.MODEL), (None, tshard.MODEL),
               ((tshard.DP, "model"), None), ("data", "pod"),
               ("model", "model"), (None,)]
    shapes = [(8, 16, 64), (512, 4096, 32), (1, 2, 3), (256, 256, 256)]
    for name in MESHES:
        tm, jm = meshes(name)
        sizes = dict(zip(jm.axis_names, jm.axis_sizes))
        with mesh_scope(tm), jax.sharding.use_abstract_mesh(jm):
            for e in entries:
                for shape in shapes:
                    shape = shape[:len(e)]
                    assert norm(tshard.logical_spec(shape, e)) == \
                        norm(jshard.logical_spec(shape, e)), (name, e, shape)
                    for ent, dim in zip(e, shape):
                        assert tshard._filter_entry(
                            tshard._expand(ent), dim, sizes) == \
                            jshard._filter_entry(jshard._expand(ent), dim,
                                                 sizes)
    assert tshard.logical_spec((8, 16), (tshard.DP, None)) == tshard.P()


def test_spec_to_placements():
    m = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert tshard.placements(tshard.P(("pod", "data"), None, "model"), m) \
        == (Shard(0), Shard(0), Shard(2))
    assert tshard.placements(tshard.P(), m) == (Replicate(),) * 3
    assert tshard.spec_of((Shard(0), Shard(0), Shard(2)), m) == \
        tshard.P(("pod", "data"), None, "model")
    with pytest.raises(ValueError, match="mesh order"):
        tshard.placements(tshard.P(("data", "pod")), m)
    with pytest.raises(ValueError, match="shards two dims"):
        tshard.placements(tshard.P("model", "model"), m)
    # no mesh and plain tensors: the hint passes its input through
    x = torch.ones(4, 8)
    assert tshard.shard_hint(x, tshard.DP, None) is x
    with mesh_scope(m):
        assert tshard.shard_hint(x, tshard.DP, None) is x


def test_tree_helpers_match_reference():
    _, _, tp = smoke("smollm-135m")
    tp = {**tp, "blocks": tp["blocks"][0]}
    tq = quantize_lm_for_serving(tp, searched=False)
    for tree in (tp, tq):
        jt = j_tree(tree)
        assert ttree.tree_bytes(tree) == jtree.tree_bytes(jt)
        assert ttree.count_params(tree) == jtree.count_params(jt)
        tc, jc = (ttree.cast_tree(tree, torch.bfloat16),
                  jtree.cast_tree(jt, jnp.bfloat16))
        assert ttree.tree_bytes(tc) == jtree.tree_bytes(jc)
        for (p, a), (q, b) in zip(tsh._leaves_with_path(tc),
                                  jax.tree_util.tree_flatten_with_path(jc)[0]):
            assert tsh.path_str(p) == jsh.path_str(q)
            assert str(a.dtype)[6:] == str(b.dtype), tsh.path_str(p)
    paths = ttree.map_with_path(lambda p, l: p, tp)
    assert paths == jtree.map_with_path(lambda p, l: p, j_tree(tp))
    w = ttree.get_path(tp, "blocks/attn/wq/w")
    assert w is tp["blocks"]["attn"]["wq"]["w"]
    new = ttree.set_path(tp, "blocks/attn/wq/w", 7)
    assert new["blocks"]["attn"]["wq"]["w"] == 7
    assert tp["blocks"]["attn"]["wq"]["w"] is w
    assert new["blocks"]["attn"]["wk"] is tp["blocks"]["attn"]["wk"]


def test_lora_target_sites_match_reference():
    jp, tp = tiny_unet_params()
    assert tunet.lora_target_sites(tp) == junet.lora_target_sites(jp)


def test_embed_layers_match_reference():
    p = tlayers.embed_init(torch.Generator().manual_seed(0), 50, 16)
    assert p["table"].shape == (50, 16) and p["table"].dtype == torch.float32
    jp = {"table": jnp.asarray(p["table"].numpy())}
    ids = np.random.default_rng(0).integers(0, 50, (3, 7))
    x = np.random.default_rng(1).standard_normal((3, 7, 16)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tlayers.embed_apply(p, torch.from_numpy(ids)).numpy(),
        np.asarray(jlayers.embed_apply(jp, jnp.asarray(ids))))
    np.testing.assert_allclose(
        tlayers.embed_attend(p, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.embed_attend(jp, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_gaussian_bump_images_match_reference_draws():
    """The reference's five draws (its own key splits) into the port's
    bump arithmetic, against the reference's images, within 1e-6; the
    port's own draws lie in the same ranges."""
    n, size, ch = 5, 12, 3
    key = jax.random.PRNGKey(4)
    ks = jax.random.split(key, 5)
    draws = [jax.random.uniform(ks[0], (n, 1, 1, 1), minval=0.2,
                                maxval=0.8) * size,
             jax.random.uniform(ks[1], (n, 1, 1, 1), minval=0.2,
                                maxval=0.8) * size,
             jax.random.uniform(ks[2], (n, 1, 1, 1), minval=0.08,
                                maxval=0.25) * size,
             jax.random.uniform(ks[3], (n, 1, 1, ch), minval=0.5,
                                maxval=1.0),
             jnp.where(jax.random.bernoulli(ks[4], 0.5, (n, 1, 1, ch)),
                       1.0, -1.0)]
    got = tdata.bump_images(*(torch.from_numpy(np.array(d))
                              for d in draws), size)
    want = np.asarray(jdata.gaussian_bump_images(key, n, size, ch))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    imgs = next(tdata.image_batches(torch.Generator().manual_seed(0), 64,
                                    size))
    assert imgs.shape == (64, size, size, 3)
    assert float(imgs.min()) >= -1 and float(imgs.max()) <= 1
    a = tdata.gaussian_bump_images(torch.Generator().manual_seed(1), 4, 8)
    b = tdata.gaussian_bump_images(torch.Generator().manual_seed(1), 4, 8)
    assert torch.equal(a, b)


def test_packed_leaves_descend_like_the_reference():
    """A packed tree's shardings keep PackedW4 nodes, each with the
    dense weight's spec on its codes and replicated scales."""
    _, tcfg, tp = smoke("qwen1.5-0.5b")
    tq = quantize_lm_for_serving(tp, searched=False)
    tm, _ = meshes("4x2")
    sh = tsh.param_shardings(tq, tm)
    wq = sh["blocks"][0]["attn"]["wq"]["w"]
    assert isinstance(wq, PackedW4)
    assert norm(wq.packed.spec) == (None, "data", "model")
    assert norm(wq.scale.spec) == norm(wq.zero_point.spec) == ()
