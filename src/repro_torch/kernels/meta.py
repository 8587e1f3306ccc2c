"""The kernels' ``meta`` route: what a kernel would allocate and compute,
with no launch, for the dry run (``launch/dryrun.py``).

A kernel entry point given a meta tensor runs its CUDA wrapper's checks
and allocations (outputs and the kernel's own workspaces: K2's split-K
partials, ``kv4_attend``'s logits workspace) on the meta device and
returns before the launch, after ``record`` has added its cost to
``COUNTS``: the flops of its products as its plain version's aten ops
would count them (``torch.utils.flop_counter``'s rule, 2 M N K a
product), its operands' and results' bytes, and its transcendentals
(exp, tanh); the storages of the operands the kernel reads go into
``READ`` (a signed pack's zero-point is not read). Neither the plain
version nor its temporaries run: the plain versions decode whole weights
and caches into f32 or bf16 tensors that the card's path never
allocates.

``plain_routes()`` is the control: inside it a meta tensor takes the
plain version instead, so a dry run shows what those temporaries would
cost. A CUDA tensor still launches the kernel or raises, a CPU tensor
still takes the plain version.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch

# "flops", "bytes accessed", "transcendentals" of the meta launches since
# the last reset
COUNTS: collections.Counter = collections.Counter()
READ: weakref.WeakSet = weakref.WeakSet()
PLAIN = False


def route(t: torch.Tensor, what: str) -> str:
    """``"cuda"`` (the kernel), ``"meta"`` (this module's route) or
    ``"plain"`` (the kernel's plain version) for a kernel input ``t``."""
    kind = t.device.type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu" or (kind == "meta" and PLAIN):
        return "plain"
    if kind == "meta":
        return "meta"
    raise ValueError(f"{what}: no route for device {t.device}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def record(*, flops: int = 0, operands=(), results=(),
           transcendentals: int = 0) -> None:
    """One meta launch's cost into ``COUNTS``."""
    COUNTS["flops"] += int(flops)
    COUNTS["bytes accessed"] += nbytes(*operands) + nbytes(*results)
    COUNTS["transcendentals"] += int(transcendentals)
    for t in operands:
        if isinstance(t, torch.Tensor):
            READ.add(t.untyped_storage())


def reset() -> None:
    COUNTS.clear()
    READ.clear()


@contextlib.contextmanager
def plain_routes():
    """Meta tensors take the plain versions while the context is open."""
    global PLAIN
    old, PLAIN = PLAIN, True
    try:
        yield
    finally:
        PLAIN = old
