"""Per-route kernel profiling hooks for ``kernels/ops`` dispatch; port of
``repro.serving.obs.kernel_profile``.

``kernels/ops`` stays dependency-free: it exposes a module-level
``PROFILER`` slot (``None`` by default — one global read + branch per
dispatch) and calls ``PROFILER.call(op, route, thunk, probe=x)`` around
the chosen route when a profiler is installed. This module provides that
profiler, backed by the obs metrics registry and span tracer.

The port runs eagerly: there is no jit trace whose dispatch decisions are
counted once per compile, as in the reference, so every call is recorded
as ``mode="eager"``. At dispatch the route counter increments and an
instant span marks the decision (op, route, shape). The call is then
timed by where its ``probe`` operand lies:

  * **on the card** — a pair of ``torch.cuda.Event(enable_timing=True)``
    recorded on the current stream around the dispatch. The pair is
    queued, and its ``elapsed_time`` is read only when results are read
    (``route_counts``, ``Observability.finalize``): no device synchronise
    per call (the engine already ends each tick in one), so the profiler
    does not change what the host and the card overlap. The span lands in
    the ``kernel_call_seconds`` histogram per (op, route) when the events
    are read. It is the stream's time from the dispatch to the kernel's
    end: the kernel's device time where the card is behind the host, but
    where the card waits for the host (a host-bound path, as the engine's
    forwards are) it includes the host's time to reach the launch through
    the wrapper. ``torch.profiler`` gives kernel time alone.
  * **on the CPU** — the call's wall time through ``wall_clock``.

Route label vocabulary (the port's own, ``kernels/ops``): ``cuda``,
``cuda:implicit``, ``cuda:im2col`` (a kernel), ``plain`` / ``plain:*`` (a
kernel's plain version on the CPU), ``ref`` (an off-kernel oracle),
``torch_f32`` and ``torch`` (dense products no kernel covers).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.common.clock import wall_clock
from repro_torch.kernels import ops as _ops

# queued event pairs beyond which completed ones are read without waiting
_MAX_PENDING = 1 << 16


class KernelProfiler:
    """Counts + times ops-dispatch routes into an obs bundle."""

    def __init__(self, obs, lock_factory=None):
        self.obs = obs
        # lock_factory: lockcheck instrumentation seam (see weight_bank)
        self._lock = (lock_factory("kernel_profiler._lock")
                      if lock_factory is not None else threading.Lock())
        self._counts: dict[tuple, int] = {}     # (op, route) -> n
        self._pending: list[tuple] = []         # (op, route, start, end)

    # -- installation --------------------------------------------------------

    def install(self) -> "KernelProfiler":
        _ops.PROFILER = self
        return self

    def uninstall(self) -> None:
        if _ops.PROFILER is self:
            _ops.PROFILER = None

    def __enter__(self) -> "KernelProfiler":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- the ops hook --------------------------------------------------------

    def call(self, op: str, route: str, thunk, probe=None):
        with self._lock:
            key = (op, route)
            self._counts[key] = self._counts.get(key, 0) + 1
        m = self.obs.metrics
        m.counter("kernel_calls_total",
                  help="ops dispatch decisions by route",
                  op=op, route=route, mode="eager").inc()
        tr = self.obs.tracer
        if tr.enabled:
            tr.instant(f"{op}[{route}]", cat="kernel",
                       args={"op": op, "route": route, **_shape_args(probe)})
        if isinstance(probe, torch.Tensor) and probe.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = thunk()
            end.record()
            with self._lock:
                self._pending.append((op, route, start, end))
                full = len(self._pending) >= _MAX_PENDING
            if full:
                self._read_events(wait=False)
            return out
        t0 = wall_clock()
        out = thunk()
        self._observe(op, route, wall_clock() - t0)
        return out

    def _observe(self, op: str, route: str, seconds: float) -> None:
        self.obs.metrics.histogram(
            "kernel_call_seconds",
            help="per ops dispatch: the stream's span from dispatch to "
                 "kernel end (CUDA events) on the card, wall seconds on "
                 "the CPU",
            op=op, route=route).observe(seconds)

    def _read_events(self, wait: bool = True) -> None:
        """Move queued event pairs into the histogram. Events complete in
        stream order, so without ``wait`` the completed prefix is read;
        with it, one synchronise settles the rest first."""
        with self._lock:
            pending = self._pending
            self._pending = []
        if not pending:
            return
        if wait:
            torch.cuda.synchronize()
        done = 0
        for op, route, start, end in pending:
            if not wait and not end.query():
                break
            self._observe(op, route, start.elapsed_time(end) / 1e3)
            done += 1
        if done < len(pending):
            with self._lock:
                self._pending[:0] = pending[done:]

    # -- read side -----------------------------------------------------------

    def route_counts(self) -> dict[str, int]:
        """``{"op:route": n}``; reads the queued device timings first."""
        self._read_events()
        with self._lock:
            return {f"{op}:{route}": n
                    for (op, route), n in self._counts.items()}


def _shape_args(probe) -> dict:
    shape = getattr(probe, "shape", None)
    return {"shape": list(shape)} if shape is not None else {}
