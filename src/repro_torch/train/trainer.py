"""Fault-tolerant training loop; port of ``repro.train.trainer``.

  * auto-restore: on (re)start the trainer resumes from the newest intact
    checkpoint, onto the device of the state it was given, and a DTensor
    leaf onto that leaf's mesh and placements;
  * periodic and preemption checkpoints: a background save every
    ``ckpt_every`` steps; ``request_stop()`` (the preemption hook) ends the
    run at the next step boundary with a synchronous save, as the end of
    the run does;
  * crash containment: a step that raises (a device error, bad data, an
    injected fault) is caught, the run restores the last checkpoint and
    goes on, at most ``max_restarts`` times; the data is a function of the
    step, so the steps after the restore take their own batches again
    (the reference's trainer draws from an iterator, whose next batches
    belong to the steps after the crash);
  * straggler watchdog: each step's wall time against an EMA of the steps
    before it; a step slower than ``straggler_factor`` times it is flagged.

A step's wall ends with ``torch.cuda.synchronize`` when the state lives on
the card (the reference's ``block_until_ready``), and is read on
``common/clock.py:wall_clock``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.common.clock import wall_clock
from repro_torch.common.sharding import is_distributed, sharding_of
from repro_torch.common.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ema_beta: float = 0.9


@dataclasses.dataclass
class StepRecord:
    step: int
    wall: float
    is_straggler: bool
    metrics: dict


def _device_of(state: Any) -> torch.device:
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


class Trainer:
    def __init__(self, cfg: TrainerConfig, ckpt: CheckpointManager,
                 step_fn: Callable[[Any, Any], tuple[Any, dict]],
                 *, fault_hook: Callable[[int], None] | None = None):
        """``step_fn(state, batch) -> (state, metrics)`` must not change
        its inputs in place (a restore hands back the saved state).
        ``fault_hook(step)`` (tests only) may raise to simulate a crash."""
        self.cfg = cfg
        self.ckpt = ckpt
        self.step_fn = step_fn
        self.fault_hook = fault_hook
        self.history: list[StepRecord] = []
        self.restarts = 0
        self._stop = False

    def request_stop(self):
        """Preemption signal: save and exit at the next step boundary."""
        self._stop = True

    def _restore_or(self, state: Any) -> tuple[int, Any]:
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, state
        shardings = (tree_map(sharding_of, state)
                     if is_distributed(tree_leaves(state)) else None)
        step, tree, _ = self.ckpt.restore(latest, device=_device_of(state),
                                          shardings=shardings)
        return step, tree

    def run(self, state: Any, data: Callable[[int], Any]
            ) -> tuple[Any, list[StepRecord]]:
        """Train to ``max_steps`` from the newest checkpoint, or from
        ``state`` where there is none; ``data(step)`` is the batch of step
        ``step`` (0-based)."""
        step, state = self._restore_or(state)
        device = _device_of(state)
        ema_wall = None
        while step < self.cfg.max_steps and not self._stop:
            batch = data(step)
            t0 = wall_clock()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state, metrics = self.step_fn(state, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            except Exception as e:  # crash containment: restore and retry
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}") from e
                self.ckpt.wait()
                step, state = self._restore_or(state)
                continue
            wall = wall_clock() - t0
            is_straggler = (ema_wall is not None
                            and wall > self.cfg.straggler_factor * ema_wall)
            ema_wall = (wall if ema_wall is None
                        else self.cfg.ema_beta * ema_wall
                        + (1 - self.cfg.ema_beta) * wall)
            step += 1
            self.history.append(StepRecord(step, wall, is_straggler,
                                           {k: float(v) for k, v in
                                            metrics.items()}))
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step, state)
        # final (preemption or completion) save: synchronous
        self.ckpt.wait()
        self.ckpt.save(step, state)
        return state, self.history

    def straggler_steps(self) -> list[int]:
        return [r.step for r in self.history if r.is_straggler]
