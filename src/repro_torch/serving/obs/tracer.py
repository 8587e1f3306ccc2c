"""Structured span tracer for the serving stack; port of
``repro.serving.obs.tracer``.

Event model is the Chrome trace-event format (the JSON Perfetto and
``chrome://tracing`` load directly): duration spans (``ph="X"``), async
request-lifecycle events (``ph="b"/"n"/"e"`` keyed by ``cat`` + ``id``),
instant annotations (``ph="i"``) and counter series (``ph="C"``). The
tracer buffers plain event dicts and serializes on demand — either as
one Chrome JSON object (``export_chrome``) or as newline-delimited JSON
(``export_jsonl``) for ad-hoc grepping/stream processing.

Design constraints (see ``serving/obs/__init__``):

  * **Deterministic timestamps** — the tracer never reads a wall clock
    itself; ``set_clock`` binds it to the *engine's* clock, so a
    ``VirtualClock`` replay emits the same timestamps on every machine
    and tracing can never perturb the golden-replay digest (the clock is
    only read, never advanced).
  * **Thread safety** — spans arrive from the engine thread *and* the
    weight bank's background prefetch worker. Every buffer mutation
    happens under one lock; an event dict is fully built before it is
    published, so a reader can never observe a torn event.
  * **Bounded memory** — the buffer is a ring (``max_events``); overflow
    drops the oldest events and counts them in ``dropped``.
  * **Cheap when disabled** — every public method early-returns on
    ``self.enabled`` (and the instrumentation points in engine/bank/
    scheduler guard with a single ``obs.enabled`` branch before even
    building the args dict).

Thread identity: the first thread to emit gets tid 0 (the engine thread
in practice), later threads get ascending tids in first-emission order;
``thread_name`` metadata events carry the Python thread names (the bank
worker shows up as ``weight-bank-prefetch_0``).
"""
from __future__ import annotations

import collections
import json
import threading

_PID = 1


class Span:
    """An open duration span; ``end()`` (via the tracer) publishes it as
    one complete ``ph="X"`` event. ``args`` may be mutated until then —
    annotations discovered mid-span (chosen segment, padded rows) attach
    to the span they describe."""

    __slots__ = ("name", "cat", "ts", "tid", "args")

    def __init__(self, name: str, cat: str, ts: float, tid: int,
                 args: dict | None):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.tid = tid
        self.args = args if args is not None else {}


class SpanTracer:
    def __init__(self, clock=None, max_events: int = 500_000,
                 lock_factory=None):
        self.enabled = True
        self._clock = clock or (lambda: 0.0)
        # lock_factory: lockcheck instrumentation seam (see weight_bank)
        self._lock = (lock_factory("tracer._lock")
                      if lock_factory is not None else threading.Lock())
        self._events: collections.deque = collections.deque()
        self.max_events = max_events
        self.dropped = 0
        # track key: (thread ident, track-name override). The override
        # (``set_track``) lets one thread emit onto several named tracks —
        # the multi-model gateway runs every engine on one thread
        # and labels each model's spans with its own track.
        self._tids: dict[tuple, int] = {}     # (ident, track) -> stable tid
        self._tid_names: dict[int, str] = {}  # tid -> track/thread name
        self._stacks: dict[int, list] = {}    # tid -> open-span stack
        self._local = threading.local()

    def set_clock(self, clock) -> None:
        self._clock = clock

    def now_us(self) -> float:
        return self._clock() * 1e6

    # -- internals -----------------------------------------------------------

    def set_track(self, name: str | None) -> None:
        """Name the current thread's track: events emitted by this thread
        land on a tid labeled ``name`` until the next ``set_track``
        (``None`` restores the plain thread track). Tids still assign in
        first-emission order; the call is a thread-local write, so it is
        cheap enough for once-per-tick use and safe from any thread."""
        if not self.enabled:
            return
        self._local.track = name

    def _tid(self) -> int:
        track = getattr(self._local, "track", None)
        key = (threading.get_ident(), track)
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.get(key)
                if tid is None:
                    tid = len(self._tids)
                    self._tids[key] = tid
                    self._tid_names[tid] = (
                        track if track is not None
                        else threading.current_thread().name)
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._events.popleft()
                self.dropped += 1
            self._events.append(ev)

    # -- duration spans ------------------------------------------------------

    def begin(self, name: str, *, cat: str = "engine",
              args: dict | None = None) -> Span | None:
        if not self.enabled:
            return None
        sp = Span(name, cat, self.now_us(), self._tid(), args)
        with self._lock:
            self._stacks.setdefault(sp.tid, []).append(sp)
        return sp

    def end(self, span: Span | None) -> None:
        if not self.enabled or span is None:
            return
        with self._lock:
            stack = self._stacks.get(span.tid, [])
            # pop through (tolerates a leaked inner span on error paths
            # rather than corrupting every later span's nesting)
            while stack and stack.pop() is not span:
                pass
        self._emit({"ph": "X", "name": span.name, "cat": span.cat,
                    "pid": _PID, "tid": span.tid, "ts": span.ts,
                    "dur": max(self.now_us() - span.ts, 0.0),
                    "args": span.args})

    class _SpanCtx:
        __slots__ = ("_tr", "span")

        def __init__(self, tr, span):
            self._tr = tr
            self.span = span

        def set(self, key, val):
            if self.span is not None:
                self.span.args[key] = val

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self._tr.end(self.span)
            return False

    def span(self, name: str, *, cat: str = "engine",
             args: dict | None = None) -> "_SpanCtx":
        """``with tracer.span("bank_build", cat="bank") as sp: ...``"""
        return self._SpanCtx(self, self.begin(name, cat=cat, args=args))

    # -- instants / counters -------------------------------------------------

    def instant(self, name: str, *, cat: str = "engine",
                args: dict | None = None) -> None:
        if not self.enabled:
            return
        self._emit({"ph": "i", "name": name, "cat": cat, "pid": _PID,
                    "tid": self._tid(), "ts": self.now_us(), "s": "t",
                    "args": args or {}})

    def counter(self, name: str, values: dict) -> None:
        """One sample of a counter track (Perfetto renders a time series)."""
        if not self.enabled:
            return
        self._emit({"ph": "C", "name": name, "cat": "metrics", "pid": _PID,
                    "tid": self._tid(), "ts": self.now_us(), "args": values})

    # -- async (request-lifecycle) events ------------------------------------
    # Perfetto groups b/n/e events by (cat, id) onto one async track, so a
    # request's whole lifecycle reads as one slice with instant marks.

    def _async(self, ph: str, name: str, aid, cat: str,
               args: dict | None) -> None:
        self._emit({"ph": ph, "name": name, "cat": cat, "id": str(aid),
                    "pid": _PID, "tid": self._tid(), "ts": self.now_us(),
                    "args": args or {}})

    def async_begin(self, name: str, aid, *, cat: str = "request",
                    args: dict | None = None) -> None:
        if self.enabled:
            self._async("b", name, aid, cat, args)

    def async_instant(self, name: str, aid, *, cat: str = "request",
                      args: dict | None = None) -> None:
        if self.enabled:
            self._async("n", name, aid, cat, args)

    def async_end(self, name: str, aid, *, cat: str = "request",
                  args: dict | None = None) -> None:
        if self.enabled:
            self._async("e", name, aid, cat, args)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def _metadata_events(self) -> list[dict]:
        with self._lock:
            names = dict(self._tid_names)
        return [{"ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                 "ts": 0, "args": {"name": name}}
                for tid, name in sorted(names.items())]

    def export_chrome(self, path: str) -> int:
        """Write one Chrome trace-event JSON object (Perfetto-loadable);
        returns the event count."""
        evs = self._metadata_events() + self.events()
        with open(path, "w") as f:
            json.dump({"traceEvents": evs,
                       "displayTimeUnit": "ms",
                       "otherData": {"producer": "repro_torch.serving.obs"}}, f)
        return len(evs)

    def export_jsonl(self, path: str) -> int:
        """Write newline-delimited JSON, one event per line."""
        evs = self._metadata_events() + self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)

    def export(self, path: str) -> int:
        """Format by extension: ``.jsonl`` -> JSONL, else Chrome JSON."""
        if path.endswith(".jsonl"):
            return self.export_jsonl(path)
        return self.export_chrome(path)


class NullTracer(SpanTracer):
    """Disabled tracer: every method is a no-op behind one branch."""

    def __init__(self):
        super().__init__(max_events=0)
        self.enabled = False
