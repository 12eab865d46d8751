"""Amateur-radio helpers: locator & callsign validation, band mapping.

Reference parity:
- isValidLocator: source/HamUtils.hpp:26-43 (letter,letter,digit,digit).
- checkCall:      source/OutputHandler.cpp:802-874.
"""

from __future__ import annotations

_BAD_CALL_CHARS = set(". + - ? ; = ~".split()) | {" ", "\t"}


def is_valid_locator(loc: str) -> bool:
    """4-character Maidenhead check (reference: source/HamUtils.hpp:26-43)."""
    if len(loc) != 4:
        return False
    return (
        loc[0].isalpha()
        and loc[1].isalpha()
        and loc[2].isdigit()
        and loc[3].isdigit()
    )


def check_call(call: str) -> bool:
    """Callsign sanity filter (reference: source/OutputHandler.cpp:802-874).

    Rules: at least 3 chars; contains at least one digit AND one letter;
    rejects the characters ``. + - ? ; = ~`` and whitespace; rejects 4-char
    strings that look like grid locators (letter,letter,digit,digit).
    """
    if len(call) < 3:
        return False
    has_digit = any(c.isdigit() for c in call)
    has_alpha = any(c.isalpha() for c in call)
    if not (has_digit and has_alpha):
        return False
    if any(c in _BAD_CALL_CHARS for c in call):
        return False
    if len(call) == 4 and is_valid_locator(call):
        return False
    return True


# Amateur band edges in Hz -> band name, for reporter band labelling.
# (The reference maps dial frequency to a CWSL shared memory by LO range,
# source/CWSL_Utils.hpp:27-53; band names are only used in reporting.)
_BANDS: list[tuple[int, int, str]] = [
    (135_700, 137_800, "2200m"),
    (472_000, 479_000, "630m"),
    (1_800_000, 2_000_000, "160m"),
    (3_500_000, 4_000_000, "80m"),
    (5_250_000, 5_450_000, "60m"),
    (7_000_000, 7_300_000, "40m"),
    (10_100_000, 10_150_000, "30m"),
    (14_000_000, 14_350_000, "20m"),
    (18_068_000, 18_168_000, "17m"),
    (21_000_000, 21_450_000, "15m"),
    (24_890_000, 24_990_000, "12m"),
    (28_000_000, 29_700_000, "10m"),
    (50_000_000, 54_000_000, "6m"),
    (144_000_000, 148_000_000, "2m"),
]


def band_name(freq_hz: int) -> str:
    for lo, hi, name in _BANDS:
        if lo <= freq_hz <= hi:
            return name
    return "?"


def grid_to_latlon(grid: str) -> tuple[float, float]:
    """Maidenhead grid centre -> (lat, lon). Used for distance/az metrics."""
    grid = grid.upper().ljust(6, "M")
    lon = (ord(grid[0]) - ord("A")) * 20 - 180
    lat = (ord(grid[1]) - ord("A")) * 10 - 90
    lon += int(grid[2]) * 2
    lat += int(grid[3]) * 1
    lon += (ord(grid[4]) - ord("A")) * (2 / 24) + (1 / 24)
    lat += (ord(grid[5]) - ord("A")) * (1 / 24) + (0.5 / 24)
    return lat, lon
