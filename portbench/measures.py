"""Arithmetic shared by the metric readers (``metrics/*.py``)."""
from __future__ import annotations

from portbench import flops


def images_per_s(run) -> float | None:
    """The window's completed evals over the mean evals an image of the
    traffic takes, over the window (a batch ending at the window's edge
    counts its share)."""
    if not run.window_s or not run.evals_per_image:
        return None
    return run.evals / run.evals_per_image / run.window_s


def mfu_percent(run) -> float | None:
    """Model FLOPs of the window's useful rows over the window at the
    card's bf16 dense peak."""
    if not run.window_s or not run.evals:
        return None
    return (100.0 * run.evals * run.flops_per_eval
            / (run.window_s * flops.PEAK_FLOPS))


def roofline_percent(run, kernel: str) -> float | None:
    """``kernel``'s bound time over its device time in the traced window:
    the bound (the family's ``kernel_bound_seconds``) summed over the
    traced forwards at their padded batch."""
    if run.trace is None or not run.trace.kernel_s.get(kernel):
        return None
    bound = sum(n * run.family.kernel_bound_seconds(run.cfg, kernel, b)
                for b, n in run.traced_buckets.items())
    return 100.0 * bound / run.trace.kernel_s[kernel]


def idle_percent(run) -> float | None:
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
