"""The distribution layer's train step across ranks: a world of 4 gloo
processes on the CPU, a (2, 2) ("data", "model") mesh, qwen1.5-0.5b's
f32 smoke config (``tests/_torch_dist_worker.py`` runs it; this file
holds what each rank wrote against the meshless port and the JAX
package; ``tests/test_torch_distributed_sites.py`` holds the rest of the
layer across ranks).

Limits, stated before the runs:
  * one sharded train step (lr 1e-2, Adam, clip 1.0) against the meshless
    port step and the reference's meshless step: the loss within 1e-5
    relative, every parameter within 0.1 * lr (the first Adam step moves
    a weight by lr * g / (|g| + eps), so a sum-order ulp of a gradient
    near 0, as the key bias's, moves it by a share of lr); the same step
    without the data-parallel gradient reduction (the control fault) must
    break the parameter limit;
  * every DTensor leaf, placed and after the step, holds on each rank its
    whole bytes over its shard count.

The world is spawned once for the file (its rendezvous a FileStore under
the test's temporary directory, each process joined with a timeout), and
the references are computed while it runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_decode import j_tree, one_torch_thread  # noqa: F401
from repro.configs import registry as jreg
from repro.launch.steps import make_train_step as j_make_train_step
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.optim.adam import adam_init as j_adam_init
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.registry import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import lm_init
from repro_torch.optim.adam import AdamConfig, adam_init

NAMES = ("train", "train_no_dp_reduction")
LOSS_LIMIT = 1e-5
PARAM_LIMIT = 0.1 * W.TRAIN_LR


def np_flat(tree) -> dict:
    """path -> float64 numpy, for a tree of tensors or a JAX tree."""
    return {k: v.double().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float64)
            for k, v in flatten_paths(tree).items()}


def max_param_err(got, want) -> float:
    g, w = np_flat(got), np_flat(want)
    assert set(g) == set(w)
    return max(float(np.abs(g[k] - w[k]).max()) for k in w)


def meshless_step(params, tokens, arch):
    cfg = get_config(arch, smoke=True)
    acfg = AdamConfig(lr=W.TRAIN_LR)
    return make_train_step(cfg, acfg)(params, adam_init(params, acfg),
                                      {"tokens": tokens})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results by scenario, with the inputs' meshless port
    step and the reference's step under "port" and "jax"."""
    d = tmp_path_factory.mktemp("world")
    cfg = get_config(W.TRAIN_ARCH, smoke=True)
    inputs = {"params": lm_init(torch.Generator().manual_seed(0), cfg),
              "tokens": torch.from_numpy(np.random.default_rng(1).integers(
                  0, cfg.vocab, W.TRAIN_BATCH))}
    procs = W.spawn(d, inputs, NAMES)
    try:
        port = meshless_step(inputs["params"], inputs["tokens"],
                             W.TRAIN_ARCH)
        jcfg = jreg.get_config(W.TRAIN_ARCH, smoke=True)
        jp, jacfg = j_tree(inputs["params"]), JAdamConfig(lr=W.TRAIN_LR)
        jax_step = jax.jit(j_make_train_step(jcfg, jacfg))(
            jp, j_adam_init(jp, jacfg),
            {"tokens": jnp.asarray(inputs["tokens"].numpy())})
    finally:
        out = W.collect(d, procs, NAMES)
    return {**out, "port": port, "jax": jax_step}


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_sharded_train_step_matches_meshless(world, ref):
    """Against the meshless port step and the reference's."""
    params, _, m = world[ref]
    for r in world["train"]:
        assert abs(r["loss"] - float(m["loss"])) <= \
            LOSS_LIMIT * abs(float(m["loss"]))
        assert max_param_err(r["params"], params) <= PARAM_LIMIT


def test_control_without_dp_reduction_breaks_the_limit(world):
    params, _, _ = world["port"]
    errs = [max_param_err(r["params"], params)
            for r in world["train_no_dp_reduction"]]
    assert min(errs) > PARAM_LIMIT, errs


def test_every_sharded_leaf_is_held_as_a_shard(world):
    for r in world["train"]:
        rows = r["placed"] + r["stepped"]
        for path, local, whole, shards in rows:
            assert local * shards == whole, (path, local, whole, shards)
        sharded = {path for path, _, _, shards in r["placed"] if shards > 1}
        # every weight matrix of the model is cut; norms replicate
        assert {"embed", "blocks/#0/attn/wq/w", "blocks/#0/attn/wo/w",
                "blocks/#0/mlp/down/w"} <= sharded, sharded
        assert len(sharded) == 11
        assert sum(whole // shards for _, _, whole, shards in r["placed"]) \
            < sum(whole for _, _, whole, _ in r["placed"]) / 2
