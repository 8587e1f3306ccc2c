"""Training launcher on one device: ``--arch <id> [--smoke]`` through the
fault-tolerant trainer; port of ``repro.launch.train``.

Random parameters from ``--seed``, drawn on the run's device; Adam under
the reference's ``linear_warmup_cosine`` schedule (warm-up
``max(10, steps // 20)`` steps); the zipf token stream; a checkpoint every
``--ckpt-every`` steps and at the end under ``<ckpt-dir>/<config
name>``, from which a restarted run resumes. Runs on the card unless
``--device cpu`` is given.

    python -m repro_torch.launch.train --arch smollm-135m --batch 8 \\
        --seq 512 --steps 200

Unlike the reference, whose token stream starts again from its first
batch when a run resumes, the batch of step ``i`` is drawn from its own
generator (seed ``data_seed(--seed, i)``) and handed to the trainer by
step, so a resumed run, whether the launcher was restarted or the trainer
restored a checkpoint after a crash, trains on the batches the
uninterrupted run would have (ROADMAP Queue C). The mesh
flags (``--production-mesh``, ``--multi-pod``, ``--model-parallel`` above
1) are the distribution layer, ROADMAP Queue A item 13, and raise.
``main(argv, cfg=...)`` trains a given config in place of the arch's (the
seam ``chip_smoke.py`` uses) and returns the run's history, with the
train step and the batch function it ran.
"""
from __future__ import annotations

import argparse
import functools
import os

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.common.clock import wall_clock
from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.synthetic import zipf_tokens
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
                    help="not ported: ROADMAP Queue A item 13")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: ROADMAP Queue A item 13")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="1 only; more is ROADMAP Queue A item 13")
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


def main(argv=None, cfg=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.production_mesh or args.multi_pod or args.model_parallel > 1:
        raise NotImplementedError(
            "--production-mesh, --multi-pod and --model-parallel > 1 need "
            "the distribution layer, ROADMAP Queue A item 13; this launcher "
            "trains on one device")
    device = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    acfg = AdamConfig(lr=args.lr, schedule="linear_warmup_cosine",
                      warmup_steps=max(10, args.steps // 20),
                      total_steps=args.steps)
    ckpt = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name), keep=3)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    params = lm_init(torch.Generator(device=device).manual_seed(args.seed),
                     cfg, device)
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
    data = functools.partial(batch_of, cfg, args, device)
    t0 = wall_clock()
    state, history = trainer.run((params, opt), data)
    wall = wall_clock() - t0
    losses = [r.metrics.get("loss", float("nan")) for r in history]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    print(f"arch={cfg.name} device={device} steps={len(history)} "
          f"(from step {start}) batch={args.batch} seq={args.seq}")
    if losses:
        print(f"arch={cfg.name} steps={len(history)} "
              f"loss[0]={losses[0]:.4f} loss[-1]={losses[-1]:.4f} "
              f"stragglers={trainer.straggler_steps()}")
    print(f"wall {wall:.2f}s, restarts {trainer.restarts}, "
          "max_memory_allocated "
          + ("-" if peak is None else f"{peak / 2**30:.2f} GiB"))
    return {"history": history, "losses": losses, "start": start,
            "restarts": trainer.restarts,
            "stragglers": trainer.straggler_steps(), "state": state,
            "wall_s": wall, "peak_bytes": peak,
            "tokens_per_step": args.batch * args.seq, "step": step,
            "data": data}


if __name__ == "__main__":
    main()
