"""Port-local copy of ``repro.serving.traffic.metrics.percentile``."""
from __future__ import annotations


def percentile(sorted_vals, p: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sequence."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            int(round(p / 100 * (len(sorted_vals) - 1))))
    return sorted_vals[max(k, 0)]
