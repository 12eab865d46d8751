"""Spot extraction: decoded messages -> validated spots -> reporter fan-out.

Reference parity: OutputHandler's universal message grammar and gates
(source/OutputHandler.cpp:924-1128):

- ignores error-flagged suffixes (``? a1 a2 q0..q5``);
- handles ``CQ CALL [GRID]``, ``CQ TAG CALL [GRID]``,
  ``CALL1 CALL2 {GRID | R GRID | RPT | R RPT | RRR | RR73 | 73}``,
  Fox/Hound ``;``-combined messages, bracketed hashed calls ``<CALL>``;
- validates the sender callsign with checkCall
  (source/OutputHandler.cpp:802-874) and locators with isValidLocator
  (source/HamUtils.hpp:26-43);
- applies a per-call ignore list (source/OutputHandler.cpp:876-887);
- fans valid spots out to PSK Reporter / WSPRNet / RBN + Stats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

from cwsl_digi_tpu_torch.constants import Mode, is_mode_fst4, is_mode_fst4w
from cwsl_digi_tpu_torch.modes.base import DecodeResult
from cwsl_digi_tpu_torch.utils.hamutils import check_call, is_valid_locator

# Error/quality flags jt9 appends that the reference strips
# (source/OutputHandler.cpp:955-962).
_ERROR_FLAGS = {"?", "a1", "a2", "a3", "a4", "a5", "a6", "a7",
                "q0", "q1", "q2", "q3", "q4", "q5"}


@dataclasses.dataclass
class Spot:
    """One reportable reception."""

    callsign: str           # sender
    freq_hz: int            # RF frequency (dial + audio offset)
    base_freq_hz: int       # channel dial frequency
    snr_db: int
    dt_s: float
    mode: Mode
    message: str
    locator: str = ""
    report: str = ""        # numeric report if the message carried one
    epoch_time: float = 0
    decoder_index: int = 0
    drift_hz: float = 0.0   # WSPR/FST4W linear drift estimate
    # per-decoder WSPR reporter callsign override (decoder line field 5,
    # reference: source/CWSL_DIGI.cpp:822)
    wspr_reporter_call: str = ""

    def __post_init__(self) -> None:
        if not self.epoch_time:
            self.epoch_time = int(time.time())  # wall clock fallback


def reporting_mode_name(mode: Mode) -> str:
    """PSK Reporter mode label: FST4-xxx -> FST4, FST4W-xxx -> FST4W
    (reference: source/PSKReporter.hpp:68-78)."""
    if is_mode_fst4(mode):
        return "FST4"
    if is_mode_fst4w(mode):
        return "FST4W"
    return str(mode.value)


def extract_spot(
    result: DecodeResult,
    base_freq_hz: int,
    decoder_index: int = 0,
    epoch_time: float | None = None,
) -> Optional[Spot]:
    """Apply the universal message grammar to one decode.

    Returns None when no reportable sender can be extracted (the reference
    logs these to badmsglog, source/OutputHandler.cpp:781-786).
    """
    text = result.message.strip()
    if not text:
        return None
    # Fox/Hound: two messages joined by ';' — take each part, report first
    # valid (reference: source/OutputHandler.cpp:589-603).
    for part in text.split(";"):
        words = [w for w in part.strip().split() if w not in _ERROR_FLAGS]
        spot = _spot_from_words(words, part.strip(), result,
                                base_freq_hz, decoder_index, epoch_time)
        if spot is not None:
            return spot
    return None


# SOTAmat message prefixes (reference: OutputHandler.cpp:889-922)
_SOTAMAT_PREFIXES = ("S", "SM", "STM", "STMT", "SOTAM", "SOTAMT", "SOTAMAT")


def is_sotamat_message(words: list[str]) -> bool:
    """Reference: isSOTAMATMessage (OutputHandler.cpp:889-922): 13-char
    'PREFIX CALL/sfx' with a 2-4 char suffix on a valid base call."""
    if len(words) != 2:
        return False
    prefix, call_sfx = words
    if len(prefix) + len(call_sfx) + 1 != 13:
        return False
    if prefix not in _SOTAMAT_PREFIXES:
        return False
    pos = call_sfx.find("/")
    if pos < 0:
        return False
    suffix = call_sfx[pos + 1:]
    if not (2 <= len(suffix) <= 4):
        return False
    return check_call(call_sfx[:pos])


def _spot_from_words(words, text, result, base_freq_hz, decoder_index,
                     epoch_time) -> Optional[Spot]:
    if len(words) < 2:
        return None
    sender = ""
    locator = ""
    report = ""
    if result.mode == Mode.JS8:
        # JS8 sender is the "FROM:" station (reference classifies via
        # js8call DecodedText, OutputHandler.cpp:403-503)
        from cwsl_digi_tpu_torch.modes.js8 import classify

        c = classify(text)
        sender, locator = c.from_call, c.grid
        if c.kind == "DIRECTED" and c.arg is not None:
            report = str(c.arg)
    elif result.mode == Mode.WSPR or is_mode_fst4w(result.mode):
        # beacon grammar: 'CALL GRID PWR' (the reference parses wsprd's
        # 8-field lines instead, OutputHandler.cpp:314-401)
        sender = words[0]
        if len(words) >= 2 and is_valid_locator(words[1]):
            locator = words[1]
        if len(words) >= 3 and words[2].lstrip("+-").isdigit():
            report = words[2]   # transmitted power, dBm
    elif is_sotamat_message(words):
        sender = words[1].split("/")[0]
    elif words[0] == "CQ":
        # CQ [TAG] CALL [GRID]
        rest = words[1:]
        if len(rest) >= 2 and not _plausible_call(rest[0]) and _plausible_call(rest[1]):
            rest = rest[1:]
        if not rest:
            return None
        sender = rest[0]
        if len(rest) >= 2 and is_valid_locator(rest[1]):
            locator = rest[1]
    elif words[0] in ("DE", "QRZ"):
        sender = words[1]
        if len(words) >= 3 and is_valid_locator(words[2]):
            locator = words[2]
    else:
        # CALL1 CALL2 [suffix] — the *second* call is the transmitting station
        sender = words[1]
        tail = words[2:]
        if tail:
            t = tail[-1]
            if _is_locator_4or6(t) and t not in ("RR73",):
                locator = t
            elif t.lstrip("R").lstrip("+-").isdigit():
                report = t
            # contest exchanges ('579 WI', 'R 16A EMA', 'R 570007 JO22DB'):
            # the RST/serial becomes the report; never mistaken for a grid
            if len(tail) >= 2 and tail[-2].isdigit() and not report:
                report = tail[-2]
    sender = sender.strip("<>")
    if not check_call(sender):
        return None
    freq = int(round(base_freq_hz + result.freq_hz))
    return Spot(
        callsign=sender,
        freq_hz=freq,
        base_freq_hz=base_freq_hz,
        snr_db=int(round(result.snr_db)),
        dt_s=result.dt_s,
        mode=result.mode,
        message=text,
        locator=locator,
        report=report,
        epoch_time=epoch_time or int(time.time()),
        decoder_index=decoder_index,
        drift_hz=result.drift_hz,
    )


def _is_locator_4or6(t: str) -> bool:
    """Reference checkLocator is 4-char only (HamUtils.hpp:26-43); EU VHF
    type-5 messages carry 6-char grids, which PSK Reporter accepts."""
    if len(t) == 6:
        return (is_valid_locator(t[:4])
                and all("A" <= c <= "X" for c in t[4:]))
    return is_valid_locator(t)


def _plausible_call(w: str) -> bool:
    return check_call(w.strip("<>"))


class SpotHandler:
    """Fan-out of validated spots to reporters + stats + logs.

    Replaces the OutputHandler processing thread
    (source/OutputHandler.cpp:83-145); here decoders hand DecodeResults
    directly (already structured, no text re-parsing needed).
    """

    def __init__(
        self,
        reporters: Iterable = (),
        stats=None,
        ignored_calls: Iterable[str] = (),
        decodes_file: str | None = None,
        bad_msg_log: str | None = None,
        log: Callable[[str], None] | None = None,
    ) -> None:
        self.reporters = list(reporters)
        self.stats = stats
        self.ignored = {c.strip().upper() for c in ignored_calls}
        self.decodes_file = decodes_file
        self.bad_msg_log = bad_msg_log
        self.log = log or (lambda s: None)

    def handle(
        self,
        result: DecodeResult,
        base_freq_hz: int,
        decoder_index: int = 0,
        epoch_time: float | None = None,
        wspr_reporter_call: str = "",
    ) -> Optional[Spot]:
        spot = extract_spot(result, base_freq_hz, decoder_index, epoch_time)
        if spot is not None and wspr_reporter_call:
            spot.wspr_reporter_call = wspr_reporter_call
        if spot is None:
            if self.bad_msg_log:
                with open(self.bad_msg_log, "a") as f:
                    f.write(result.message + "\n")
            return None
        if spot.callsign.upper() in self.ignored:
            return None
        if self.decodes_file:
            with open(self.decodes_file, "a") as f:
                f.write(
                    f"{spot.epoch_time:g} {spot.mode.value} {spot.freq_hz} "
                    f"{spot.snr_db:+d} {spot.dt_s:+.2f} {spot.message}\n"
                )
        for rep in self.reporters:
            rep.handle(spot)
        if self.stats is not None:
            self.stats.handle_report(decoder_index, spot.epoch_time)
        self.log(
            f"{spot.mode.value:>9} {spot.freq_hz:>10} Hz {spot.snr_db:+3d} dB "
            f"{spot.dt_s:+5.2f} s  {spot.message}"
        )
        return spot
