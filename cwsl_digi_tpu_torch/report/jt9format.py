"""jt9/wsprd text-format compatibility: format and parse decoder lines.

The reference never sees structured decodes — it parses the fixed-column
stdout of jt9.exe/wsprd.exe (source/OutputHandler.cpp:505-779 for the
jt9 modes, :314-401 for wsprd's 8-field lines).  Native decoders hand
structured ``DecodeResult``s directly, but the text format remains useful:

- for users' downstream tooling that tails jt9-style logs;
- as the compatibility surface for column-parsing tests (SURVEY.md §4a).

jt9-style line:   ``HHMMSS SNR DT FREQ <marker> MESSAGE``
wsprd-style line: ``HHMM SNR DT FREQ_MHZ DRIFT CALL GRID PWR``
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional

from cwsl_digi_tpu_torch.constants import Mode, is_mode_fst4, is_mode_fst4w
from cwsl_digi_tpu_torch.modes.base import DecodeResult

# jt9 mode markers (one char between freq and message)
_MARKERS = {
    Mode.FT8: "~",
    Mode.FT4: "+",
    Mode.JT65: "#",
    Mode.Q65_30: ":",
    Mode.JS8: "@",
}


def _marker(mode: Mode) -> str:
    if is_mode_fst4(mode) or is_mode_fst4w(mode):
        return "`"
    return _MARKERS.get(mode, "~")


def format_jt9(result: DecodeResult, epoch_time: float) -> str:
    """One jt9-style decode line for the capture window at ``epoch_time``."""
    utc = _dt.datetime.fromtimestamp(epoch_time, _dt.timezone.utc)
    return (f"{utc:%H%M%S} {result.snr_db:3.0f} {result.dt_s:4.1f} "
            f"{result.freq_hz:4.0f} {_marker(result.mode)}  {result.message}")


def parse_jt9(line: str, mode: Mode = Mode.FT8) -> Optional[DecodeResult]:
    """Parse a jt9-style line back into a DecodeResult (None if malformed)."""
    parts = line.split()
    if len(parts) < 5:
        return None
    try:
        snr = float(parts[1])
        dt = float(parts[2])
        freq = float(parts[3])
    except ValueError:
        return None
    # marker column then message text
    msg_idx = 5 if parts[4] in set("~+#:@`*") else 4
    message = " ".join(parts[msg_idx:]) if len(parts) > msg_idx else ""
    if not message:
        return None
    return DecodeResult(message=message, snr_db=snr, dt_s=dt, freq_hz=freq,
                        mode=mode)


def format_wsprd(result: DecodeResult, epoch_time: float,
                 dial_freq_hz: int, drift: int = 0) -> str:
    """One wsprd-style 8-field line (freq as absolute MHz)."""
    utc = _dt.datetime.fromtimestamp(epoch_time, _dt.timezone.utc)
    parts = result.message.split()
    call = parts[0] if parts else ""
    grid = parts[1] if len(parts) > 1 else ""
    pwr = parts[2] if len(parts) > 2 else "0"
    freq_mhz = (dial_freq_hz + result.freq_hz) / 1e6
    return (f"{utc:%H%M} {result.snr_db:4.0f} {result.dt_s:5.1f} "
            f"{freq_mhz:11.6f} {drift:2d}  {call} {grid} {pwr}")


def parse_wsprd(line: str) -> Optional[DecodeResult]:
    """Parse a wsprd-style 8-field line (reference columns:
    OutputHandler.cpp:318-377)."""
    parts = line.split()
    if len(parts) < 8:
        return None
    try:
        snr = float(parts[1])
        dt = float(parts[2])
        freq_mhz = float(parts[3])
        int(parts[4])                       # drift
    except ValueError:
        return None
    call, grid, pwr = parts[5], parts[6], parts[7]
    return DecodeResult(
        message=f"{call} {grid} {pwr}",
        snr_db=snr, dt_s=dt,
        freq_hz=freq_mhz * 1e6,             # absolute; caller re-bases
        mode=Mode.WSPR,
    )
