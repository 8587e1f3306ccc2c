"""Replayable traffic traces: a versioned JSONL format for the engine;
port of ``repro.serving.traffic.trace``.

A trace file is the unit of workload reproducibility: every load
generator (``generators.py``) emits it, the launcher replays it, and a
live engine run can be captured back into one (``TraceWriter``). The port
writes the same bytes as the reference for the same requests and meta, and
each package reads the other's files.

Layout — line 1 is a header object, every following line one request::

    {"format": "repro.traffic.trace", "version": 2, "meta": {...}}
    {"arrival": 0.013, "deadline": 60.0, "eta": 0.0, "guidance_scale": 0.0,
     "priority": 1, "rid": 0, "sampler": "ddim", "seed": 7, "steps": 3}

Times (``arrival``, ``deadline``) are absolute seconds from trace start.
``deadline`` is the SLO cutoff the metrics collector scores goodput
against and past which the scheduler refuses admission. ``user`` /
``parent`` / ``think_s`` are the think-time links a closed-loop
generator leaves behind.

Version history: v1 — original schema (single-model engines); v2 — adds
the optional ``model`` field (the gateway routing target). A v1 file
loads unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

from repro_torch.diffusion.samplers import STEP_SAMPLERS

FORMAT = "repro.traffic.trace"
VERSION = 2
_READABLE_VERSIONS = (1, 2)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One generation request as recorded in a trace line."""

    arrival: float                  # seconds from trace start
    steps: int = 10
    eta: float = 0.0
    seed: int = 0
    sampler: str = "ddim"
    y: int | None = None            # class label (class-conditional models)
    guidance_scale: float = 0.0
    deadline: float | None = None   # absolute SLO cutoff, seconds
    priority: int = 0               # higher admits first under contention
    user: int | None = None         # closed-loop user id
    parent: int | None = None       # rid whose completion triggered this one
    think_s: float | None = None    # think time preceding this request
    rid: int | None = None          # assigned on load / capture
    model: str | None = None        # gateway routing target (v2); None =
    #                                 the submission surface's default model

    def to_obj(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


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
        if tr.model is not None and (not isinstance(tr.model, str)
                                     or not tr.model):
            raise ValueError(f"{where}: model must be a non-empty string "
                             f"or absent, got {tr.model!r}")


def save_trace(path: str, reqs: list[TraceRequest],
               meta: dict | None = None) -> None:
    validate_trace(reqs)
    with open(path, "w") as f:
        f.write(json.dumps({"format": FORMAT, "version": VERSION,
                            "meta": meta or {}}) + "\n")
        for tr in reqs:
            f.write(json.dumps(tr.to_obj(), sort_keys=True) + "\n")


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
                         f"{header.get('version')!r} "
                         f"(readable: {_READABLE_VERSIONS})")
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
    """Submit every trace request to the engine; {trace rid: engine rid}.

    A routing surface (a multi-model gateway) advertises
    ``routes_models = True`` and receives each request's ``model`` field;
    a plain single-model engine never sees the kwarg.
    """
    routes = getattr(engine, "routes_models", False)
    mapping = {}
    for tr in sorted(reqs, key=lambda t: (t.arrival, t.rid or 0)):
        kw = {"model": tr.model} if routes else {}
        rid = engine.submit(steps=tr.steps, eta=tr.eta, seed=tr.seed,
                            sampler=tr.sampler, y=tr.y,
                            guidance_scale=tr.guidance_scale,
                            arrival=tr.arrival, deadline=tr.deadline,
                            priority=tr.priority, user=tr.user,
                            parent=tr.parent, think_s=tr.think_s, **kw)
        mapping[tr.rid if tr.rid is not None else rid] = rid
    return mapping


class TraceWriter:
    """Capture a live engine run back into a trace file.

    Attach to an engine before submitting; every ``engine.submit`` —
    including requests a closed-loop generator sends mid-run — appends
    one line, so the realized workload (actual arrivals) replays later
    via ``load_trace`` + ``submit_trace``.
    """

    def __init__(self, path: str, meta: dict | None = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w")
        self._f.write(json.dumps({"format": FORMAT, "version": VERSION,
                                  "meta": meta or {}}) + "\n")
        self.n = 0

    def record(self, tr: TraceRequest) -> None:
        self._f.write(json.dumps(tr.to_obj(), sort_keys=True) + "\n")
        self.n += 1

    def attach(self, engine) -> "TraceWriter":
        engine.on_submit.append(self._on_submit)
        return self

    def _on_submit(self, rs) -> None:
        req = rs.req
        # ``rs.model`` / ``rs.gid`` are a gateway's routing annotations;
        # a plain engine's requests carry neither
        self.record(TraceRequest(
            arrival=req.arrival, steps=req.steps, eta=req.eta,
            seed=req.seed, sampler=req.sampler, y=req.y,
            guidance_scale=req.guidance_scale, deadline=req.deadline,
            priority=req.priority, user=req.user, parent=req.parent,
            think_s=req.think_s, rid=getattr(rs, "gid", req.rid),
            model=getattr(rs, "model", None)))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
