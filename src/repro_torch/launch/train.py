"""Training launcher: ``--arch <id> [--smoke]`` through the
fault-tolerant trainer, on a device mesh; port of
``repro.launch.train``.

Random parameters from ``--seed``, drawn on the run's device; Adam under
the reference's ``linear_warmup_cosine`` schedule (warm-up
``max(10, steps // 20)`` steps); the zipf token stream; a checkpoint every
``--ckpt-every`` steps and at the end under ``<ckpt-dir>/<config
name>``, from which a restarted run resumes. Runs on the card unless
``--device cpu`` is given.

The mesh is the reference's: ``--production-mesh`` the (16, 16) pod, or
with ``--multi-pod`` the (2, 16, 16) one; else the host mesh over the
world, ``--model-parallel`` ranks on its model axis. The world is the
process group ``launch/mesh.py:init_world`` makes: under ``torchrun`` the
launcher's ranks, else one rank. A mesh the world cannot hold raises. The
parameters are placed by ``param_shardings`` and each batch by
``data_spec`` as DTensors, and the step runs under ``mesh_scope``.

    python -m repro_torch.launch.train --arch smollm-135m --batch 8 \\
        --seq 512 --steps 200
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --arch qwen1.5-0.5b --smoke --model-parallel 2 --steps 4

Unlike the reference, whose token stream starts again from its first
batch when a run resumes, the batch of step ``i`` is drawn whole on every
rank from its own generator (seed ``data_seed(--seed, i)``) and handed to
the trainer by step, so a resumed run, whether the launcher was restarted
or the trainer restored a checkpoint after a crash, trains on the batches
the uninterrupted run would have (ROADMAP Queue C), on any mesh.
``main(argv, cfg=...)`` trains a given config in place of the arch's (the
seam ``chip_smoke.py`` uses) and returns the run's history and its final
state gathered whole into plain tensors, with the mesh, the train step and
the batch function it ran.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.common.clock import wall_clock
from repro_torch.common.device import resolve_device
from repro_torch.common.sharding import placements, to_full
from repro_torch.common.tree import tree_map
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.synthetic import zipf_tokens
from repro_torch.launch.mesh import (init_world, make_host_mesh,
                                     make_production_mesh, mesh_scope)
from repro_torch.launch.sharding import data_spec, param_shardings, place
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import lm_init
from repro_torch.optim.adam import AdamConfig, adam_init
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) pod mesh: a world of 256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: the (2, 16, 16) mesh, "
                         "512 ranks")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the host mesh's model axis (it must divide the "
                         "world)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def data_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s batch."""
    return 1_000_003 * (seed + 1) + step


def batch_of(cfg, args, device, step: int) -> dict:
    """The batch of step ``step``."""
    gen = torch.Generator(device=device).manual_seed(
        data_seed(args.seed, step))
    batch = {"tokens": zipf_tokens(gen, args.batch, args.seq, cfg.vocab)}
    if cfg.family == "vlm":
        batch["extra"] = torch.zeros(
            (args.batch, cfg.n_img_tokens, cfg.d_vision),
            dtype=torch.bfloat16, device=device)
    return batch


def placed_batch(batch: dict, mesh) -> dict:
    """The batch's tokens distributed over the mesh by ``data_spec`` (the
    vlm's patch embeddings stay a plain tensor, replicated, as the
    reference leaves them)."""
    toks = batch["tokens"]
    spec = data_spec(tuple(toks.shape), mesh)
    return {**batch, "tokens": distribute_tensor(toks, mesh,
                                                 placements(spec, mesh))}


def main(argv=None, cfg=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    made = init_world(device)
    try:
        mesh = (make_production_mesh(multi_pod=args.multi_pod)
                if args.production_mesh
                else make_host_mesh(args.model_parallel))
        with mesh_scope(mesh):
            return _train(args, cfg, device, mesh)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, cfg, device, mesh) -> dict:
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    acfg = AdamConfig(lr=args.lr, schedule="linear_warmup_cosine",
                      warmup_steps=max(10, args.steps // 20),
                      total_steps=args.steps)
    ckpt = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name), keep=3)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    params = lm_init(torch.Generator(device=device).manual_seed(args.seed),
                     cfg, device)
    params = place(params, param_shardings(params, mesh))
    opt = adam_init(params, acfg)
    step = make_train_step(cfg, acfg)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = step(params, opt, batch)
        return (params, opt), metrics

    tcfg = TrainerConfig(max_steps=args.steps, ckpt_every=args.ckpt_every,
                         log_every=20)
    trainer = Trainer(tcfg, ckpt, step_fn)
    start = ckpt.latest_step() or 0

    def data(step: int) -> dict:
        # batch_of looked up at call time, so a control can replace it
        return placed_batch(batch_of(cfg, args, device, step), mesh)

    t0 = wall_clock()
    state, history = trainer.run((params, opt), data)
    wall = wall_clock() - t0
    losses = [r.metrics.get("loss", float("nan")) for r in history]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    print(f"arch={cfg.name} device={device} steps={len(history)} "
          f"(from step {start}) batch={args.batch} seq={args.seq} mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if losses:
        print(f"arch={cfg.name} steps={len(history)} "
              f"loss[0]={losses[0]:.4f} loss[-1]={losses[-1]:.4f} "
              f"stragglers={trainer.straggler_steps()}")
    print(f"wall {wall:.2f}s, restarts {trainer.restarts}, "
          "max_memory_allocated "
          + ("-" if peak is None else f"{peak / 2**30:.2f} GiB"))
    return {"history": history, "losses": losses, "start": start,
            "restarts": trainer.restarts,
            "stragglers": trainer.straggler_steps(),
            "state": tree_map(to_full, state),
            "wall_s": wall, "peak_bytes": peak,
            "tokens_per_step": args.batch * args.seq, "step": step,
            "data": data, "mesh": mesh}


if __name__ == "__main__":
    main()
