"""The two dry runs ``tests/test_torch_dryrun.py`` compares, each in a
process of its own (each owns its world: the port's a fake process group,
the reference's jax's 8 host devices), printing one JSON object.

  python tests/_torch_dryrun_worker.py ref    # REPRO_DRYRUN_DEVICES=8 set
  python tests/_torch_dryrun_worker.py port
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

ARCHS = ("smollm-135m", "llama4-scout-17b-a16e")
# (kind, quant, kv) of the smoke cells: S 64 x B 8 on a (4, 2) mesh
CELLS = (("train", "bf16", "bf16"), ("prefill", "w4", "bf16"),
         ("decode", "w4", "fp4"))
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes")


def _smoke(get_config, arch, kind, kv):
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, kv_dtype=kv) if kind == "decode" else cfg


def ref() -> dict:
    from repro.configs.registry import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.launch import dryrun
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        for kind, quant, kv in CELLS:
            rec = dryrun._compile_cell(
                _smoke(get_config, arch, kind, kv),
                ShapeSpec("smoke", 64, 8, kind), mesh, quant=quant, kv=kv,
                big=False, multi_pod=False)
            out[f"{arch}/{kind}"] = {k: rec["memory"][k] for k in MEMORY_KEYS}
    return out


def _hand_collectives(mesh) -> dict:
    """Collectives of known bytes on the (4, 2) fake world: each op's
    bytes and count under the trace."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    from repro_torch.core.qmodule import PackedW4
    from repro_torch.launch.dryrun import StepTrace
    from repro_torch.nn import partition

    m = dict(device="meta")

    def dt(local, pls, shape):
        return DTensor.from_local(local, mesh, pls, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, **m).stride())

    rep = Replicate()
    with StepTrace([]) as tr:
        # x (8, 16) f32 cut over data -> whole: an all-gather of 512 B
        x = dt(torch.empty(2, 16, **m), [Shard(0), rep], (8, 16))
        x.redistribute(mesh, [rep, rep])
        # a (8, 32) f32 partial sum over model -> whole: an all-reduce,
        # 1024 B moved twice
        p = dt(torch.empty(8, 32, **m), [rep, Partial()], (8, 32))
        p.redistribute(mesh, [rep, rep])
        # the same -> cut over model: a reduce-scatter of 512 B
        p.redistribute(mesh, [rep, Shard(0)])
        # the EP exchange's c10d all-to-all over model: 256 B
        t = torch.empty(4, 16, **m)
        dist.all_to_all_single(torch.empty_like(t), t,
                               group=mesh.get_group("model"))
        # a W4 product whose (64, 16) pack is cut over data (FSDP) and
        # model (byte columns): the pack gathered over data, 512 B of
        # codes; the (8, 32) f32 output's split-half columns gathered over
        # model for the view, 256 B (a (2, 32) row shard), then cut again
        pw = PackedW4(dt(torch.empty(16, 8, dtype=torch.uint8, **m),
                         [Shard(0), Shard(1)], (64, 16)),
                      torch.empty((), **m), torch.empty((), **m), 2, 1,
                      True, (64, 32))
        y = partition.w4_matmul(dt(torch.empty(2, 64, **m), [Shard(0), rep],
                             (8, 64)), pw)
    return {"collectives": tr.collectives(), "y_local": list(
        y.to_local().shape), "y_placements": [str(p) for p in y.placements]}


def port() -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import compat_make_mesh, fake_world
    from repro_torch.launch.steps import (make_decode_fn, make_train_step,
                                          quantize_lm_for_serving)
    from repro_torch.models.lm import init_caches, lm_init
    from repro_torch.optim.adam import AdamConfig, adam_init

    out: dict = {"memory": {}, "flops": {}, "depth": {}}
    with fake_world(8):
        mesh = compat_make_mesh((4, 2), ("data", "model"))
        for arch in ARCHS:
            for kind, quant, kv in CELLS:
                rec = dryrun._compile_cell(
                    _smoke(get_config, arch, kind, kv),
                    ShapeSpec("smoke", 64, 8, kind), mesh, quant=quant,
                    kv=kv, big=False, multi_pod=False)
                out["memory"][f"{arch}/{kind}"] = {
                    k: rec["memory"][k] for k in MEMORY_KEYS}
        out["hand"] = _hand_collectives(mesh)

    # (5) the meta trace's flops on a one-rank world against
    # FlopCounterMode over a real CPU run of the same step (plain routes)
    arch = "smollm-135m"
    for kind, quant, kv in (("train", "bf16", "bf16"),
                            ("decode", "w4", "fp4")):
        cfg = _smoke(get_config, arch, kind, kv)
        shape = ShapeSpec("smoke", 64, 8, kind)
        rec = dryrun.run_cell(arch, "smoke", multi_pod=False, quant=quant,
                              kv=kv, cfg=cfg, shape=shape, mesh_shape=(1, 1))
        params = lm_init(torch.Generator().manual_seed(0), cfg)
        tokens = torch.randint(0, cfg.vocab, (8, 64),
                               generator=torch.Generator().manual_seed(1),
                               dtype=torch.int32)
        fc = FlopCounterMode(display=False)
        if kind == "train":
            acfg = AdamConfig(lr=3e-4)
            step = make_train_step(cfg, acfg)
            opt = adam_init(params, acfg)
            with fc:
                step(params, opt, {"tokens": tokens})
        else:
            params = quantize_lm_for_serving(params, searched=False)
            caches = init_caches(cfg, 8, 64)
            with fc:
                make_decode_fn(cfg)(params, caches, tokens[:, :1], 63)
        ops.reset_routes()
        out["flops"][kind] = [rec["cost"]["flops"], fc.get_total_flops()]

    # (6) full depth against the reference's two-point extrapolation
    base = get_config(arch, smoke=True)
    for kind, quant, kv in (("prefill", "w4", "bf16"),
                            ("decode", "w4", "fp4")):
        recs = []
        for g in (1, 2, base.n_groups):
            cfg = dryrun.with_depth(base, g)
            recs.append(dryrun.run_cell(
                arch, "smoke", multi_pod=False, quant=quant, kv=kv, cfg=cfg,
                shape=ShapeSpec("smoke", 64, 8, kind), mesh_shape=(4, 2)))
        out["depth"][kind] = {
            "n_groups": base.n_groups,
            "recs": [{**r["cost"], "collective_bytes":
                      r["collectives"]["total_bytes"]} for r in recs]}
    return out


if __name__ == "__main__":
    fn = {"ref": ref, "port": port}[sys.argv[1]]
    if sys.argv[1] == "port":
        import torch
        torch.set_num_threads(1)
    assert sys.argv[1] == "port" or os.environ.get("REPRO_DRYRUN_DEVICES")
    print("RESULT " + json.dumps(fn()))
