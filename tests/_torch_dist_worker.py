"""The multi-rank half of ``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_sites.py``: a world of WORLD gloo
processes on the CPU runs the scenarios a test file names (SCENARIOS) in
turn and writes what each rank saw; the test file holds those results
against the meshless port and the JAX package.

Imports torch and the port only (the test process holds JAX). ``spawn``
starts ``run(rank, world, store_path, out_dir, inputs_path, names)`` in
each process (the rendezvous a FileStore in the test's temporary
directory), ``collect`` joins them within a timeout and loads the
results.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pathlib

import torch
import torch.distributed as dist

WORLD = 4
JOIN_S = 120                       # a hang fails the test, not the suite
MESH = (2, 2)                      # ("data", "model")
TRAIN_ARCH = "qwen1.5-0.5b"
SSM_ARCH = "mamba2-370m"          # its mixer runs per batch shard
TRAIN_BATCH = (8, 16)
TRAIN_LR = 1e-2


def _dump(out_dir: str, name: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out_dir, f"{name}.{rank}.pt"))


def shard_count(t) -> int:
    """How many pieces a DTensor's placements cut it into."""
    from torch.distributed.tensor import Shard
    n = 1
    for size, pl in zip(t.device_mesh.shape, t.placements):
        if isinstance(pl, Shard):
            n *= size
    return n


def local_bytes(tree) -> list:
    """(path, local bytes, whole bytes, shard count) of every DTensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.common.tree import flatten_paths
    return [(p, t.to_local().numel() * t.element_size(),
             t.numel() * t.element_size(), shard_count(t))
            for p, t in flatten_paths(tree).items()
            if isinstance(t, DTensor)]


def train_step(inputs: dict, mesh, *, arch: str = TRAIN_ARCH,
               reduce: bool = True) -> dict:
    """One sharded train step of ``arch``'s smoke config from the
    inputs' parameters and tokens; ``reduce=False`` leaves out the
    data-parallel gradient reduction (a control fault: each rank keeps
    its own partial gradient as if it were the whole)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.common.sharding import to_full
    from repro_torch.common.tree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import mesh_scope
    from repro_torch.launch.sharding import param_shardings, place
    from repro_torch.launch.train import placed_batch
    from repro_torch.optim.adam import AdamConfig, adam_init
    cfg = get_config(arch, smoke=True)
    acfg = AdamConfig(lr=TRAIN_LR)
    start = inputs["params" if arch == TRAIN_ARCH else "ssm_params"]

    def unreduced(g, p):
        # each rank's partial sum taken for the whole, then put on the
        # parameter's placements (slicing only)
        pls = [Replicate() if pl.is_partial() else pl for pl in g.placements]
        return DTensor.from_local(g.to_local(), g.device_mesh, pls,
                                  run_check=False).redistribute(
            p.device_mesh, p.placements)

    orig = steps.reduce_grad
    if not reduce:
        steps.reduce_grad = unreduced
    try:
        with mesh_scope(mesh):
            params = place(start, param_shardings(start, mesh))
            placed = local_bytes(params)
            opt = adam_init(params, acfg)
            params, opt, m = steps.make_train_step(cfg, acfg)(
                params, opt, placed_batch({"tokens": inputs["tokens"]},
                                          mesh))
            return {"params": tree_map(to_full, params),
                    "loss": float(m["loss"]), "placed": placed,
                    "stepped": local_bytes(params) + local_bytes(opt)}
    finally:
        steps.reduce_grad = orig


def moe_ep(inputs: dict, mesh) -> dict:
    """``moe_apply_ep`` on the reference's case, tokens placed over the
    data axis, and the gradient of sum(y^2) to every parameter."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.sharding import P, placements
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import mesh_scope
    from repro_torch.nn.moe import MoEConfig, moe_apply_ep
    cfg = MoEConfig(**inputs["moe_cfg"])
    p = tree_map(lambda t: t.clone().requires_grad_(), inputs["moe_params"])
    with mesh_scope(mesh):
        x = distribute_tensor(inputs["moe_x"], mesh,
                              placements(P("data", None, None), mesh))
        y = moe_apply_ep(p, x, cfg)
        grads = torch.autograd.grad((y ** 2).sum().full_tensor(),
                                    tree_leaves(p))
        return {"y": y.full_tensor().detach(), "grads": grads}


def checkpoint_remesh(mesh, ckpt_dir: str) -> dict:
    """A tree saved from ``mesh`` (2, 2), restored onto (1, 4)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.common.sharding import NamedSharding, P
    m2 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "b": torch.arange(6, dtype=torch.bfloat16)}
    sh1 = {"w": NamedSharding(mesh, P("data", "model")),
           "b": NamedSharding(mesh, P())}
    sh2 = {"w": NamedSharding(m2, P("data", "model")),
           "b": NamedSharding(m2, P("model"))}
    placed = {k: distribute_tensor(v, sh1[k].mesh, sh1[k].placements)
              for k, v in tree.items()}
    cm = CheckpointManager(ckpt_dir)
    cm.save(1, placed)
    _, back, _ = cm.restore(1, shardings=sh2)
    return {k: {"full": v.full_tensor(), "local": v.to_local(),
                "placements": tuple(v.placements),
                "want": tuple(sh2[k].placements),
                "mesh_shape": tuple(v.device_mesh.shape)}
            for k, v in back.items()}


def loader(mesh) -> dict:
    """Two batches of a ShardedLoader whose host id is this rank's data
    coordinate."""
    from repro_torch.common.sharding import NamedSharding, P
    from repro_torch.data.synthetic import ShardedLoader, zipf_tokens
    data_rank = mesh.get_coordinate()[0]
    it = iter(ShardedLoader(
        batch=2, make_batch=lambda g: zipf_tokens(g, 2, 8, 100),
        sharding=NamedSharding(mesh, P("data", None)), seed=3,
        host_id=data_rank, n_hosts=mesh.shape[0]))
    batches = [next(it) for _ in range(2)]
    return {"data_rank": data_rank,
            "local": [b.to_local() for b in batches],
            "full": [b.full_tensor() for b in batches]}


def kernels_on_mesh(mesh) -> dict:
    """``nn/partition.py``'s ops on real tensors (the plain versions on the
    CPU): W4A4 products whose (32, 16) weight's pack is cut over FSDP rows
    and byte columns, over its contraction, and over its byte columns
    with a per-channel scale, x cut over data; the act snap of a partial
    sum; ``kv4_store`` and ``kv4_attend`` on a cache cut over its batch
    (data) and slots (model). Each result whole ("got") beside the same
    op on whole tensors ("want")."""
    import dataclasses

    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    from repro_torch.core.qmodule import pack_weight
    from repro_torch.kernels import ops
    from repro_torch.nn import partition
    from repro_torch.quant.fakequant import QuantizerParams
    g = torch.Generator().manual_seed(7)
    rep = Replicate()
    x = torch.randn(4, 3, 32, generator=g)
    w = torch.randn(32, 16, generator=g)
    act = QuantizerParams(0, 2, 1, 4, torch.tensor(4.0))
    xd = distribute_tensor(x, mesh, [Shard(0), rep])
    out = {}
    for name, maxval, pls in (
            ("fsdp rows, byte columns", torch.tensor(2.0), [Shard(0),
                                                            Shard(1)]),
            ("contraction", torch.tensor(2.0), [rep, Shard(0)]),
            ("byte columns, per-channel scale", w.abs().amax(0),
             [rep, Shard(1)])):
        pw = pack_weight(w, QuantizerParams(0, 2, 1, 4, maxval))
        cut = [Shard(0) if maxval.ndim and p == Shard(1) else rep
               for p in pls]
        placed = dataclasses.replace(
            pw, packed=distribute_tensor(pw.packed, mesh, pls),
            scale=distribute_tensor(pw.scale, mesh, cut),
            zero_point=distribute_tensor(pw.zero_point, mesh, cut))
        y = partition.w4a4_matmul(xd, placed, act)
        out[name] = {"got": y.full_tensor(),
                     "want": ops.w4a4_matmul(x, pw, act)}
    half = DTensor.from_local(x * 0.5, mesh, [rep, Partial()],
                              run_check=False)
    out["act snap of a partial sum"] = {
        "got": partition.msfp_quantize(half, act).full_tensor(),
        "want": ops.msfp_quantize(x, act)}
    b, s, n_kv, hd = 2, 8, 2, 16
    cache = [torch.randint(0, 256, (b, s, n_kv, hd // 2), generator=g,
                           dtype=torch.uint8) for _ in range(2)] + [
        torch.rand(b, s, n_kv, generator=g).half() for _ in range(2)]
    k_new, v_new = (torch.randn(b, n_kv, hd, generator=g) for _ in range(2))
    q = torch.randn(b, n_kv, 3, hd, generator=g)
    cut = [Shard(0), Shard(1)]
    placed = [distribute_tensor(t, mesh, cut) for t in cache]
    for pos in (1, 5):
        partition.kv4_store(*(distribute_tensor(t, mesh, [Shard(0), rep])
                              for t in (k_new, v_new)), *placed, pos)
        ops.kv4_store(k_new, v_new, *cache, pos)
    out["kv4_store, slots 1 and 5"] = {
        "got": torch.cat([t.full_tensor().reshape(-1).float()
                          for t in placed]),
        "want": torch.cat([t.reshape(-1).float() for t in cache])}
    o = partition.kv4_attend(distribute_tensor(q, mesh, [Shard(0), rep]),
                             *placed, 6, hd ** -0.5)
    out["kv4_attend over 6 slots"] = {
        "got": o.full_tensor(),
        "want": ops.kv4_attend(q, *cache, 6, hd ** -0.5)}
    return out


SCENARIOS = {
    "train": lambda inputs, mesh, d: train_step(inputs, mesh),
    "train_no_dp_reduction": lambda inputs, mesh, d: train_step(
        inputs, mesh, reduce=False),
    "train_ssm": lambda inputs, mesh, d: train_step(inputs, mesh,
                                                    arch=SSM_ARCH),
    "moe_ep": lambda inputs, mesh, d: moe_ep(inputs, mesh),
    "checkpoint": lambda inputs, mesh, d: checkpoint_remesh(
        mesh, os.path.join(d, "ckpt")),
    "loader": lambda inputs, mesh, d: loader(mesh),
    "kernels_on_mesh": lambda inputs, mesh, d: kernels_on_mesh(mesh),
}


def run(rank: int, world: int, store_path: str, out_dir: str,
        inputs_path: str, names: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import compat_make_mesh
        inputs = torch.load(inputs_path)
        mesh = compat_make_mesh(MESH, ("data", "model"))
        for name in names:
            _dump(out_dir, name, rank, SCENARIOS[name](inputs, mesh,
                                                       out_dir))
    finally:
        dist.destroy_process_group()


def spawn(d: pathlib.Path, inputs: dict, names: tuple) -> list:
    """The world started on ``names`` (keys of SCENARIOS), its inputs
    written under ``d`` and its rendezvous a FileStore there."""
    torch.save(inputs, d / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, WORLD, str(d / "store"), str(d),
                                           str(d / "inputs.pt"), names))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def collect(d: pathlib.Path, procs: list, names: tuple) -> dict:
    """Each process joined within JOIN_S (the ones still running are
    killed and fail the caller); name -> [each rank's result]."""
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, f"{len(alive)} ranks still running after {JOIN_S}s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return {n: [torch.load(d / f"{n}.{r}.pt") for r in range(WORLD)]
            for n in names}
