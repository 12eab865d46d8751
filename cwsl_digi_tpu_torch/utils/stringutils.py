"""String helpers (reference: source/StringUtils.hpp:11-68)."""

from __future__ import annotations


def trim(s: str) -> str:
    return s.strip()


def split_whitespace(s: str) -> list[str]:
    """Reference splits decoder-output lines on runs of whitespace."""
    return s.split()


def split_on(s: str, sep: str) -> list[str]:
    return s.split(sep)
