"""UTC cadence scheduling: one timer wheel instead of eight busy-wait threads.

The reference spawns a detached thread per cadence group (FT8 @ 15 s,
FT4 @ 7.5 s, 30/60/120/300/900/1800 s), each polling UTC and flipping
per-channel atomic SyncPredicates (source/CWSL_DIGI.cpp:174-451,
source/CWSL_DIGI_Types.hpp:65-145).  Here a single scheduler computes every
next boundary exactly and sleeps until the earliest one, with the
reference's sleep quanta as bounds (MAX_SLEEP_MS=250 / MIN_SLEEP_MS=25,
source/CWSL_DIGI.hpp:59-60).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

from cwsl_digi_tpu_torch.constants import MAX_SLEEP_MS, MIN_SLEEP_MS
from cwsl_digi_tpu_torch.utils.timeutils import next_period_boundary


class CadenceScheduler:
    """Fires callbacks at UTC multiples of each registered period."""

    def __init__(self) -> None:
        self._subs: list[tuple[float, Callable[[float], None]]] = []
        self._thread: threading.Thread | None = None
        self._terminate = threading.Event()
        self._last_fired: dict[float, float] = {}

    def subscribe(self, period_s: float, callback: Callable[[float], None]) -> None:
        """callback(boundary_epoch) runs at every UTC multiple of period_s."""
        self._subs.append((float(period_s), callback))

    @property
    def periods(self) -> set[float]:
        return {p for p, _ in self._subs}

    def run_once(self, now: float | None = None) -> float:
        """Fire every boundary that became due since the previous call (at
        first call: boundaries landing exactly on ``now``); returns the next
        due time."""
        if now is None:
            now = time.time()
        next_due = float("inf")
        for period, cb in self._subs:
            if period not in self._last_fired:
                # first call: treat the boundary strictly before `now` as done
                self._last_fired[period] = next_period_boundary(period, now) - period
                if abs(self._last_fired[period] - now) < 1e-9:
                    self._last_fired[period] -= period
            boundary = self._last_fired[period] + period
            while boundary <= now + 1e-9:
                cb(boundary)
                self._last_fired[period] = boundary
                boundary += period
            next_due = min(next_due, boundary)
        return next_due

    def start(self) -> None:
        self._terminate.clear()
        self._thread = threading.Thread(target=self._loop, name="cadence",
                                        daemon=True)
        self._thread.start()

    def terminate(self) -> None:
        self._terminate.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        # single source of truth: run_once handles firing state, including
        # subscriptions added after start()
        while not self._terminate.is_set():
            next_due = self.run_once()
            now = time.time()
            if next_due == float("inf"):
                next_due = now + MAX_SLEEP_MS / 1000.0
            sleep = min(max(next_due - now, MIN_SLEEP_MS / 1000.0),
                        MAX_SLEEP_MS / 1000.0)
            self._terminate.wait(sleep)
