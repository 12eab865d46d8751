"""Global constants and the mode table.

Reference parity: source/CWSL_DIGI.hpp:44-113 (periods, rates, getRXPeriod).
"""

from __future__ import annotations

import enum

# Audio pipeline rates (reference: source/CWSL_DIGI.hpp:51-55).
WAVE_SR = 12_000          # channelizer output rate, real samples/s
SSB_BW = 6_000            # demodulator bandwidth, Hz
USB = True                # all digi modes are upper sideband
AUDIO_CLIP_VAL = 2.0**15 - 1.0

# Scheduler sleep quanta (reference: source/CWSL_DIGI.hpp:59-62).
MAX_SLEEP_MS = 250
MIN_SLEEP_MS = 25
MAIN_LOOP_SLEEP_MS = 1000


class Mode(str, enum.Enum):
    """Every decoder mode the reference supports.

    Reference: source/CWSL_DIGI.hpp:64-113 and source/CWSL_DIGI.cpp:744-798.
    """

    FT8 = "FT8"
    FT4 = "FT4"
    WSPR = "WSPR"
    JT65 = "JT65"
    Q65_30 = "Q65-30"
    JS8 = "JS8"
    FST4_60 = "FST4-60"
    FST4_120 = "FST4-120"
    FST4_300 = "FST4-300"
    FST4_900 = "FST4-900"
    FST4_1800 = "FST4-1800"
    FST4W_120 = "FST4W-120"
    FST4W_300 = "FST4W-300"
    FST4W_900 = "FST4W-900"
    FST4W_1800 = "FST4W-1800"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


# T/R period in seconds per mode (reference: source/CWSL_DIGI.hpp:44-49,64-113).
RX_PERIODS: dict[Mode, float] = {
    Mode.FT8: 15.0,
    Mode.FT4: 7.5,
    Mode.WSPR: 120.0,
    Mode.JT65: 60.0,
    Mode.Q65_30: 30.0,
    Mode.JS8: 15.0,
    Mode.FST4_60: 60.0,
    Mode.FST4_120: 120.0,
    Mode.FST4_300: 300.0,
    Mode.FST4_900: 900.0,
    Mode.FST4_1800: 1800.0,
    Mode.FST4W_120: 120.0,
    Mode.FST4W_300: 300.0,
    Mode.FST4W_900: 900.0,
    Mode.FST4W_1800: 1800.0,
}

# Modes whose decode windows are "long" and must not starve the fast FT8/FT4
# cadence (reference: toDecodeLong queue, source/DecoderPool.hpp:339-354).
LONG_MODES = frozenset(
    m for m, p in RX_PERIODS.items() if p >= 120.0 and m is not Mode.FT4
)


def get_rx_period(mode: Mode | str) -> float:
    """Reference: getRXPeriod, source/CWSL_DIGI.hpp:64-113."""
    mode = Mode(mode)
    return RX_PERIODS[mode]


def is_mode_fst4(mode: Mode | str) -> bool:
    """Reference: isModeFST4, source/CWSL_DIGI.hpp:151-153."""
    return str(Mode(mode).value).startswith("FST4-")


def is_mode_fst4w(mode: Mode | str) -> bool:
    """Reference: isModeFST4W, source/CWSL_DIGI.hpp:155-157."""
    return str(Mode(mode).value).startswith("FST4W-")


def parse_mode(text: str) -> Mode:
    """Parse a config-file mode string, case-insensitively.

    Reference accepts the exact uppercase strings in decoder lines
    (source/CWSL_DIGI.cpp:744-798); we also tolerate lowercase.
    """
    return Mode(text.strip().upper().replace("FST4W_", "FST4W-").replace("FST4_", "FST4-"))
