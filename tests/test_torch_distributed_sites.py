"""The distribution layer's explicit sites across ranks: a world of 4
gloo processes on the CPU, a (2, 2) ("data", "model") mesh
(``tests/_torch_dist_worker.py`` runs it; ``tests/test_torch_distributed.py``
holds the sharded train step of a dense model).

Limits, stated before the runs:
  * one sharded train step of mamba2-370m's f32 smoke config, its mixer
    on each rank's batch shard (``common/sharding.py:over_batch``), against
    the meshless port step: the loss within 1e-5 relative, every
    parameter within 0.1 * lr (as tests/test_torch_distributed.py);
  * ``moe_apply_ep`` against the reference's ``moe_apply`` on the
    reference's case (E 4, top-2, one shared expert, capacity factor 8,
    x (8, 6, 32)) within 1e-4, its gradients finite and within 1e-4 of
    each leaf's largest of the meshless port's;
  * a checkpoint saved from (2, 2) restores onto (1, 4) with the same
    values and the new placements;
  * ``ShardedLoader``'s streams differ across data ranks and agree within
    one;
  * ``nn/partition.py``'s W4A4 products (the pack cut over FSDP rows and
    byte columns, over its contraction, over its byte columns with a
    per-channel scale) within 1e-5 relative of the same product on whole
    tensors (the contraction's partial sums add in another order), and
    its act snap of a partial sum, kv4_store and kv4_attend on a cache cut
    over batch and slots, bit for bit.

The world is spawned once for the file, and the references are computed
while it runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_decode import one_torch_thread  # noqa: F401
from repro.nn.moe import MoEConfig as JMoEConfig
from repro.nn.moe import moe_apply as j_moe_apply
from repro.nn.moe import moe_init as j_moe_init
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import ShardedLoader, zipf_tokens
from repro_torch.models.lm import lm_init
from repro_torch.nn.moe import MoEConfig, moe_apply
from test_torch_distributed import (LOSS_LIMIT, PARAM_LIMIT, max_param_err,
                                    meshless_step)

NAMES = ("train_ssm", "moe_ep", "checkpoint", "loader", "kernels_on_mesh")
KERNEL_CASES = ("fsdp rows, byte columns", "contraction",
                "byte columns, per-channel scale",
                "act snap of a partial sum", "kv4_store, slots 1 and 5",
                "kv4_attend over 6 slots")
PRODUCT_LIMIT = 1e-5
MOE_LIMIT = 1e-4
MOE_CFG = dict(d_model=32, d_ff=16, n_experts=4, top_k=2, n_shared=1,
               capacity_factor=8.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results by scenario, with the references: the meshless
    mamba2 step ("ssm"), the reference's moe_apply ("jax_moe") and the
    meshless port's MoE gradients ("moe_grads")."""
    d = tmp_path_factory.mktemp("world")
    key = jax.random.PRNGKey(0)
    jp = j_moe_init(key, JMoEConfig(**MOE_CFG), jnp.float32)
    cfg = get_config(W.SSM_ARCH, smoke=True)
    inputs = {
        "ssm_params": lm_init(torch.Generator().manual_seed(2), cfg),
        "tokens": torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, W.TRAIN_BATCH)),
        "moe_cfg": MOE_CFG,
        "moe_params": jax.tree.map(lambda v: torch.from_numpy(np.array(v)),
                                   jp),
        "moe_x": torch.from_numpy(np.array(jax.random.normal(
            key, (8, 6, 32))))}
    procs = W.spawn(d, inputs, NAMES)
    try:
        refs = {"ssm": meshless_step(inputs["ssm_params"], inputs["tokens"],
                                     W.SSM_ARCH),
                "jax_moe": np.asarray(jax.jit(
                    lambda p, x: j_moe_apply(p, x, JMoEConfig(**MOE_CFG)))(
                    jp, jnp.asarray(inputs["moe_x"].numpy())))}
        p = tree_map(lambda t: t.clone().requires_grad_(),
                     inputs["moe_params"])
        y = moe_apply(p, inputs["moe_x"], MoEConfig(**MOE_CFG))
        refs["moe_grads"] = torch.autograd.grad((y ** 2).sum(),
                                                tree_leaves(p))
    finally:
        out = W.collect(d, procs, NAMES)
    return {**out, **refs}


def test_sharded_ssm_train_step_matches_meshless(world):
    params, _, m = world["ssm"]
    for r in world["train_ssm"]:
        assert abs(r["loss"] - float(m["loss"])) <= \
            LOSS_LIMIT * abs(float(m["loss"]))
        assert max_param_err(r["params"], params) <= PARAM_LIMIT


def test_moe_apply_ep_matches_reference_moe_apply(world):
    """The output against the reference's; the gradients of sum(y^2)
    finite and (every rank's, reduced over the ranks whose tokens reached
    each weight) those of the meshless port's moe_apply within 1e-4 of
    each leaf's largest."""
    want, gw = world["jax_moe"], world["moe_grads"]
    for r in world["moe_ep"]:
        assert float(np.abs(r["y"].numpy() - want).max()) < MOE_LIMIT
        for g, w in zip(r["grads"], gw):
            assert bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= \
                MOE_LIMIT * float(w.abs().max())


def test_checkpoint_restores_onto_a_different_mesh(world):
    for rank, r in enumerate(world["checkpoint"]):
        w, b = r["w"], r["b"]
        assert torch.equal(w["full"], torch.arange(64.0).reshape(8, 8))
        assert torch.equal(b["full"], torch.arange(6, dtype=torch.bfloat16))
        for leaf in (w, b):
            assert leaf["placements"] == leaf["want"]
            assert leaf["mesh_shape"] == (1, 4)
        # (1, 4): the model axis cuts w's 8 columns into 2 a rank
        assert torch.equal(w["local"], w["full"][:, 2 * rank:2 * rank + 2])


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernels_on_mesh_match_whole_tensors(world, case):
    for r in world["kernels_on_mesh"]:
        got, want = r[case]["got"], r[case]["want"]
        assert got.shape == want.shape and got.dtype == want.dtype
        if case in KERNEL_CASES[:3]:
            assert float((got - want).abs().max()) <= \
                PRODUCT_LIMIT * float(want.abs().max())
        else:
            assert torch.equal(got, want)


def test_sharded_loader_streams_are_disjoint_across_ranks(world):
    rs = world["loader"]
    by_data = {}
    for r in rs:
        by_data.setdefault(r["data_rank"], []).append(r)
    assert sorted(by_data) == [0, 1]
    for host, group in by_data.items():
        it = iter(ShardedLoader(batch=2, make_batch=lambda g: zipf_tokens(
            g, 2, 8, 100), seed=3, host_id=host, n_hosts=2))
        for i in range(2):
            w = next(it)
            for r in group:
                assert torch.equal(r["local"][i], w)
    for i in range(2):
        a, b = by_data[0][0]["local"][i], by_data[1][0]["local"][i]
        assert not torch.equal(a, b)
        for r in rs:
            assert torch.equal(r["full"][i], torch.cat([a, b]))
