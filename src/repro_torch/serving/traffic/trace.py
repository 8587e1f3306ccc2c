"""Replayable JSONL traces (v1/v2); port-local copy of the loader and
submitter of ``repro.serving.traffic.trace``.

Line 1 is a header ``{"format": "repro.traffic.trace", "version": N,
"meta": {...}}``; every following line is one request. Times (``arrival``,
``deadline``) are absolute seconds from trace start.
"""
from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.diffusion.samplers import STEP_SAMPLERS

FORMAT = "repro.traffic.trace"
_READABLE_VERSIONS = (1, 2)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One generation request as recorded in a trace line."""

    arrival: float
    steps: int = 10
    eta: float = 0.0
    seed: int = 0
    sampler: str = "ddim"
    y: int | None = None
    guidance_scale: float = 0.0
    deadline: float | None = None
    priority: int = 0
    user: int | None = None
    parent: int | None = None
    think_s: float | None = None
    rid: int | None = None
    model: str | None = None


def request_from_obj(obj: dict) -> TraceRequest:
    known = {f.name for f in dataclasses.fields(TraceRequest)}
    extra = set(obj) - known
    if extra:
        raise ValueError(f"unknown trace fields {sorted(extra)}")
    return TraceRequest(**obj)


def validate_trace(reqs: list[TraceRequest]) -> None:
    """Raise ValueError on the first malformed request."""
    rids = [tr.rid for tr in reqs if tr.rid is not None]
    if len(rids) != len(set(rids)):
        dupes = sorted({r for r in rids if rids.count(r) > 1})
        raise ValueError(f"duplicate rids in trace: {dupes}")
    for i, tr in enumerate(reqs):
        where = f"trace line {i} (rid={tr.rid})"
        if not (math.isfinite(tr.arrival) and tr.arrival >= 0):
            raise ValueError(f"{where}: bad arrival {tr.arrival}")
        if not (isinstance(tr.steps, int) and tr.steps >= 1):
            raise ValueError(f"{where}: steps must be a positive int, "
                             f"got {tr.steps!r}")
        if tr.sampler not in STEP_SAMPLERS:
            raise ValueError(f"{where}: unknown sampler {tr.sampler!r} "
                             f"(known: {STEP_SAMPLERS})")
        if tr.eta < 0 or tr.guidance_scale < 0:
            raise ValueError(f"{where}: eta/guidance_scale must be >= 0")
        if tr.guidance_scale > 0 and tr.y is None:
            raise ValueError(f"{where}: guidance_scale > 0 needs a class "
                             "label y")
        if tr.deadline is not None and tr.deadline <= tr.arrival:
            raise ValueError(f"{where}: deadline {tr.deadline} not after "
                             f"arrival {tr.arrival}")
        if not isinstance(tr.priority, int):
            raise ValueError(f"{where}: priority must be an int")


def load_trace(path: str, *, validate: bool = True
               ) -> tuple[list[TraceRequest], dict]:
    """Load (requests sorted by arrival, header). rids are assigned by
    arrival order when the file carries none."""
    with open(path) as f:
        lines = [ln for ln in (raw.strip() for raw in f) if ln]
    if not lines:
        raise ValueError(f"{path}: empty trace")
    header = json.loads(lines[0])
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} file "
                         f"(header {header.get('format')!r})")
    if header.get("version") not in _READABLE_VERSIONS:
        raise ValueError(f"{path}: unsupported trace version "
                         f"{header.get('version')!r}")
    reqs = [request_from_obj(json.loads(ln)) for ln in lines[1:]]
    reqs.sort(key=lambda tr: (tr.arrival,
                              tr.rid if tr.rid is not None else 0))
    used = {tr.rid for tr in reqs if tr.rid is not None}
    nxt = 0
    filled = []
    for tr in reqs:
        if tr.rid is None:
            while nxt in used:
                nxt += 1
            used.add(nxt)
            tr = dataclasses.replace(tr, rid=nxt)
        filled.append(tr)
    if validate:
        validate_trace(filled)
    return filled, header


def submit_trace(engine, reqs: list[TraceRequest]) -> dict[int, int]:
    """Submit every trace request to the engine; {trace rid: engine rid}."""
    mapping = {}
    for tr in sorted(reqs, key=lambda t: (t.arrival, t.rid or 0)):
        rid = engine.submit(steps=tr.steps, eta=tr.eta, seed=tr.seed,
                            sampler=tr.sampler, y=tr.y,
                            guidance_scale=tr.guidance_scale,
                            arrival=tr.arrival, deadline=tr.deadline,
                            priority=tr.priority, user=tr.user,
                            parent=tr.parent, think_s=tr.think_s)
        mapping[tr.rid if tr.rid is not None else rid] = rid
    return mapping
