"""Per-decoder spot statistics.

Reference parity: source/Stats.hpp:47-114 — per-decoder vectors of spot
timestamps, queried for counts in the last 1 min / 5 min / 1 h / 24 h,
pruned beyond 24 h; printed as a status table on a configurable interval
(source/CWSL_DIGI.cpp:470-519, default 300 s).
"""

from __future__ import annotations

import threading
import time


DEFAULT_INTERVALS = (60, 300, 3600, 86400)


class Stats:
    def __init__(self, keep_seconds: int = 86400, num_decoders: int = 0) -> None:
        self.keep_seconds = keep_seconds
        self._times: list[list[int]] = [[] for _ in range(num_decoders)]
        self._lock = threading.Lock()

    def ensure(self, n: int) -> None:
        with self._lock:
            while len(self._times) < n:
                self._times.append([])

    def handle_report(self, decoder_index: int,
                      epoch_time: float | None = None) -> None:
        if epoch_time is None:
            epoch_time = int(time.time())
        self.ensure(decoder_index + 1)
        with self._lock:
            self._times[decoder_index].append(epoch_time)

    def prune(self, now: int | None = None) -> None:
        now = now or int(time.time())
        cutoff = now - self.keep_seconds
        with self._lock:
            for v in self._times:
                while v and v[0] < cutoff:
                    v.pop(0)

    def get_counts(self, decoder_index: int, interval_s: int,
                   now: int | None = None) -> int:
        now = now or int(time.time())
        with self._lock:
            if decoder_index >= len(self._times):
                return 0
            return sum(1 for t in self._times[decoder_index] if now - t <= interval_s)

    def table(self, labels: list[str], statuses: list[str] | None = None,
              now: int | None = None) -> str:
        """The periodic status table (reference: CWSL_DIGI.cpp:470-519)."""
        self.prune(now)
        # status column width matches the reference's setw(16)
        # (CWSL_DIGI.cpp:486-510) so 'Uninitialized' fits
        lines = [f"{'Decoder':<24}{'Status':<16}"
                 + "".join(f"{s:>8}" for s in ("1m", "5m", "1h", "24h"))]
        for i, label in enumerate(labels):
            status = statuses[i] if statuses else "Running"
            counts = [self.get_counts(i, iv, now) for iv in DEFAULT_INTERVALS]
            lines.append(f"{label:<24}{status:<16}"
                         + "".join(f"{c:>8}" for c in counts))
        return "\n".join(lines)
