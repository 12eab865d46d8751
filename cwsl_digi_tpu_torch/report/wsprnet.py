"""WSPRNet client: per-spot HTTP POST, field-compatible with the reference
(source/WSPRNet.{hpp,cpp}).

Form fields and formats from WSPRNet.cpp:188-306: function=wspr, rcall,
rgrid, rqrg (MHz, 6 decimals), date (yymmdd UTC), time (hhmm UTC), sig, dt,
drift, tcall, tgrid, tqrg (MHz), dbm, version, mode.  Mode codes
(WSPRNet.cpp:80-98): WSPR->2, FST4W-120->3, FST4W-300->5, FST4W-900->16,
FST4W-1800->30 (the reference's comment says 15 for FST4W-900 but its code
sends 16 — we match the code).  Connect-per-report with x3 retry
(WSPRNet.cpp:308-327,360-381).
"""

from __future__ import annotations

import datetime as _dt
import threading
import time
import urllib.parse
import urllib.request
from typing import Callable, Optional

from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.report.spot import Spot
from cwsl_digi_tpu_torch.version import PROGRAM_NAME, __version__

URL = "http://wsprnet.org/post"
RETRIES = 3
IDLE_SLEEP_S = 10.0

# WSPRNet mode codes (reference: source/WSPRNet.cpp:80-98).
MODE_CODES = {
    Mode.WSPR: 2,
    Mode.FST4W_120: 3,
    Mode.FST4W_300: 5,
    Mode.FST4W_900: 16,   # NB: comment in reference says 15, code sends 16
    Mode.FST4W_1800: 30,
}


def build_post_fields(
    spot: Spot,
    reporter_callsign: str,
    reporter_grid: str,
    recv_freq_hz: int,
    dbm: int = 0,
    drift: int = 0,
) -> dict[str, str]:
    """The form-urlencoded fields (reference: WSPRNet.cpp:195-247)."""
    utc = _dt.datetime.fromtimestamp(spot.epoch_time, _dt.timezone.utc)
    return {
        "function": "wspr",
        "rcall": reporter_callsign,
        "rgrid": reporter_grid,
        "rqrg": f"{recv_freq_hz / 1e6:.6f}",
        "date": utc.strftime("%y%m%d"),
        "time": utc.strftime("%H%M"),
        "sig": str(spot.snr_db),
        "dt": f"{spot.dt_s:.2f}",
        "drift": str(drift),
        "tcall": spot.callsign,
        "tgrid": spot.locator,
        "tqrg": f"{spot.freq_hz / 1e6:.6f}",
        "dbm": str(dbm),
        "version": f"{PROGRAM_NAME} {__version__}",
        "mode": str(MODE_CODES.get(spot.mode, 2)),
    }


class WSPRNet:
    """Queueing sender; one POST per report with retries."""

    def __init__(
        self,
        operator_grid: str,
        default_callsign: str,
        post_fn: Optional[Callable[[dict[str, str]], bool]] = None,
        start_thread: bool = True,
        log: Callable[[str], None] | None = None,
    ) -> None:
        self.operator_grid = operator_grid
        self.default_callsign = default_callsign
        self._pending: list[tuple[Spot, str]] = []
        self._lock = threading.Lock()
        self._terminate = False
        self.log = log or (lambda s: None)
        self.count_ok = 0
        self.count_err = 0
        self._post = post_fn or self._post_http
        if start_thread:
            threading.Thread(target=self._loop, name="wsprnet", daemon=True).start()

    def handle(self, spot: Spot, reporter_callsign: str = "") -> None:
        """The per-decoder WSPR reporter callsign override rides on the spot
        (decoder line field 5, source/CWSL_DIGI.cpp:822)."""
        if spot.mode not in MODE_CODES:
            return
        rcall = (reporter_callsign or spot.wspr_reporter_call
                 or self.default_callsign)
        with self._lock:
            self._pending.append((spot, rcall))

    def terminate(self) -> None:
        self._terminate = True

    def flush(self) -> int:
        with self._lock:
            items = self._pending
            self._pending = []
        n = 0
        for spot, rcall in items:
            try:
                dbm = int(spot.report)
            except (TypeError, ValueError):
                dbm = 0
            fields = build_post_fields(spot, rcall, self.operator_grid,
                                       spot.base_freq_hz, dbm=dbm,
                                       drift=int(round(spot.drift_hz)))
            ok = False
            for _ in range(RETRIES):
                if self._post(fields):
                    ok = True
                    break
            if ok:
                self.count_ok += 1
                n += 1
            else:
                self.count_err += 1
                self.log("Failed to send WSPR report to WSPRNet")
        return n

    def _post_http(self, fields: dict[str, str]) -> bool:  # pragma: no cover
        data = urllib.parse.urlencode(fields).encode()
        try:
            with urllib.request.urlopen(URL + "?", data, timeout=15) as resp:
                return 200 <= resp.status < 300
        except Exception as e:
            self.log(f"WSPRNet post error: {e}")
            return False

    def _loop(self) -> None:  # pragma: no cover - timing loop
        from cwsl_digi_tpu_torch.utils import qos

        qos.set_current_thread_nice(qos.BEST_EFFORT)   # ≙ WSPRNet.cpp:54
        while not self._terminate:
            time.sleep(IDLE_SLEEP_S)
            self.flush()
