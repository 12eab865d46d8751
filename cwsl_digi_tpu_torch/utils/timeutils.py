"""Wall-clock helpers (reference: source/TimeUtils.hpp:7-21)."""

from __future__ import annotations

import time


def get_epoch_time_ms() -> int:
    return int(time.time() * 1000)


def get_epoch_time() -> int:
    return int(time.time())


def seconds_since_epoch() -> float:
    return time.time()


def next_period_boundary(period_s: float, now: float | None = None) -> float:
    """Next UTC instant that is an integer multiple of ``period_s``.

    This is the timer-wheel replacement for the reference's eight busy-wait
    cadence threads (source/CWSL_DIGI.cpp:174-451), which fire at UTC
    multiples of each mode's T/R period (e.g. FT8 at :00/:15/:30/:45,
    FT4 at 7.5 s multiples with sub-second alignment).
    """
    if now is None:
        now = time.time()
    k = int(now / period_s)
    boundary = (k + 1) * period_s
    # Guard against float edge where now is exactly on a boundary.
    if boundary - now < 1e-9:
        boundary += period_s
    return boundary
