"""The one sanctioned wall-clock seam for serving/launch code; port of
``repro.common.clock``.

Everything inside ``serving/`` and ``launch/`` that needs a timestamp for
*scheduling or replay* goes through the engine's clock (the ``now_fn`` /
``clock`` constructor seams on ``DiffusionServingEngine``) so
``VirtualClock``/``SimClock`` replays stay bit-identical; the port's
wall-clock test (``tests/test_torch_obs.py``) bans ``time.time()`` /
``time.perf_counter()`` / argless ``datetime.now()`` there outside clock
classes, as the reference's ``clock-discipline`` rule does.

Human-facing *diagnostic* timing (startup prints, ``wall_s`` report
fields) is the one legitimate wall-clock consumer left, and it funnels
through ``wall_clock()`` here. Never feed ``wall_clock()`` into
admission, batching, deadlines, or anything a replay digest covers.
"""
from __future__ import annotations

import time


def wall_clock() -> float:
    """Monotonic seconds for diagnostic durations (``t1 - t0``).

    Deliberately ``perf_counter`` (not ``time.time``): it never jumps on
    NTP adjustments, so startup/report durations can't go negative.
    """
    return time.perf_counter()
