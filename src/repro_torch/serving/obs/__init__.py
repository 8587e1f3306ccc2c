"""Observability seam of the serving stack; port-local stand-in.

The engine, scheduler and weight bank guard every instrumentation point
with ``obs.enabled``, as in ``repro.serving.obs``. This slice ports only
the disabled bundle ``NULL_OBS``; the tracer, the metrics registry and the
kernel profiler come with the traffic/obs slice (ROADMAP Queue A item 9).
"""
from __future__ import annotations


class NullObservability:
    """The disabled bundle: every guarded instrumentation point is skipped."""

    enabled = False


NULL_OBS = NullObservability()

__all__ = ["NULL_OBS", "NullObservability"]
