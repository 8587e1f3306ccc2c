"""Multi-host serving fleet: N engine replicas, pluggable placement; port
of ``repro.serving.fleet``.

See ``fleet.fleet`` for the router design (placement-at-arrival,
segment-affinity routing against per-replica weight banks, the shared
clock run() driver, and the 1-replica golden identity).
"""
from repro_torch.serving.fleet.fleet import (PLACEMENTS, EngineReplica,
                                             FleetRouter)

__all__ = ["FleetRouter", "EngineReplica", "PLACEMENTS"]
