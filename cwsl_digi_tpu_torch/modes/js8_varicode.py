"""JS8 huffman varicode: variable-length text coding for JS8 data frames.

The reference does not parse JS8 text itself — it compiles js8call's
``varicode.cpp``/``jsc.cpp`` straight into the binary
(source/CWSL_DIGI.vcxproj:22-24) and calls them via DecodedText
(source/OutputHandler.cpp:403-503).  JS8Call's text layer huffman-codes
each character (short codes for common letters), appends an EOT mark,
and zero-pads the frame tail; that structure is implemented here exactly.

Interop status: the *machinery* (prefix-free huffman stream, EOT
termination, zero padding, frame-budget packing) matches JS8Call; the
default *codebook* is a deterministic canonical-huffman stand-in built
from a published English letter-frequency table, because the exact
js8call codebook could not be reproduced bit-exactly from memory in
this zero-egress environment.  Drop the real table in via
``CWSL_DIGI_TPU_TABLES_DIR/js8_varicode.txt`` (one ``<token> <bits>``
pair per line; ``SP`` = space, ``EOT`` = end-of-transmission, anything
else a literal character) and the text layer becomes on-air compatible
with no code change — the loader validates the table is prefix-free
before accepting it (modes/tables_ext.py discipline).
"""

from __future__ import annotations

import functools
import heapq

EOT = "\x04"

# Characters JS8Call's huffman alphabet covers (its varicode.cpp table):
# space, A-Z, 0-9, common punctuation, and the EOT mark.
ALPHABET = EOT + " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789./?+-@#:!\"'$%&()*;<=>[]^_{|}~"

# Relative letter/digit/punctuation frequencies (per mille, English text;
# the classic Lewand/Cornell ordering used by most amateur varicodes).
# Only the RANKING shapes the stand-in codebook; JS8Call's real codebook
# replaces the whole table via the override above.
_FREQ: dict[str, float] = {
    " ": 190.0, "E": 120.2, "T": 91.0, "A": 81.2, "O": 76.8, "I": 73.1,
    "N": 69.5, "S": 62.8, "R": 60.2, "H": 59.2, "D": 43.2, "L": 39.8,
    "U": 28.8, "C": 27.1, "M": 26.1, "F": 23.0, "Y": 21.1, "W": 20.9,
    "G": 20.3, "P": 18.2, "B": 14.9, "V": 11.1, "K": 6.9, "X": 1.7,
    "Q": 1.1, "J": 1.0, "Z": 0.7,
    "0": 5.0, "1": 5.0, "2": 4.0, "3": 3.5, "4": 3.0, "5": 3.0,
    "6": 2.5, "7": 2.5, "8": 2.5, "9": 2.5,
    ".": 6.0, "/": 3.0, "?": 3.0, "+": 1.5, "-": 2.0, "@": 0.8,
    "#": 0.4, ":": 1.2, "!": 0.8, '"': 0.5, "'": 1.2, "$": 0.3,
    "%": 0.3, "&": 0.4, "(": 0.5, ")": 0.5, "*": 0.4, ";": 0.5,
    "<": 0.2, "=": 0.5, ">": 1.0, "[": 0.2, "]": 0.2, "^": 0.2,
    "_": 0.3, "{": 0.1, "|": 0.1, "}": 0.1, "~": 0.2,
    EOT: 8.0,
}
assert set(_FREQ) == set(ALPHABET)


def _canonical(code_lengths: dict[str, int]) -> dict[str, str]:
    """Canonical huffman assignment: shorter codes first, ties by the
    ALPHABET order, each next code = (prev + 1) << length delta."""
    order = sorted(code_lengths, key=lambda c: (code_lengths[c],
                                                ALPHABET.index(c)))
    table: dict[str, str] = {}
    code = 0
    prev_len = 0
    for ch in order:
        ln = code_lengths[ch]
        code <<= (ln - prev_len)
        table[ch] = format(code, f"0{ln}b")
        code += 1
        prev_len = ln
    return table


@functools.lru_cache(maxsize=1)
def default_table() -> dict[str, str]:
    """Deterministic canonical-huffman codebook over ``_FREQ``."""
    # standard huffman construction for the code lengths
    heap: list[tuple[float, int, tuple[str, ...]]] = [
        (w, i, (c,)) for i, (c, w) in enumerate(sorted(_FREQ.items()))]
    heapq.heapify(heap)
    lengths = {c: 0 for c in _FREQ}
    n = len(heap)
    while len(heap) > 1:
        w1, _, c1 = heapq.heappop(heap)
        w2, _, c2 = heapq.heappop(heap)
        for c in c1 + c2:
            lengths[c] += 1
        n += 1
        heapq.heappush(heap, (w1 + w2, n, c1 + c2))
    return _canonical(lengths)


def validate_table(table: dict[str, str]) -> None:
    """Raise unless ``table`` is a usable prefix-free 0/1 codebook."""
    if EOT not in table:
        raise ValueError("varicode table must include the EOT mark")
    codes = sorted(table.values())
    for c in codes:
        if not c or set(c) - {"0", "1"}:
            raise ValueError(f"varicode code {c!r} must be nonempty 0/1")
    for a, b in zip(codes, codes[1:]):
        if b.startswith(a):
            raise ValueError(f"varicode codes not prefix-free: {a} <= {b}")


@functools.lru_cache(maxsize=1)
def _active() -> tuple[dict[str, str], bool]:
    """(codebook, is_external).  External table overrides the stand-in."""
    from cwsl_digi_tpu_torch.modes import tables_ext

    ext = tables_ext.js8_varicode()
    if ext is not None:
        return ext, True
    return default_table(), False


def table() -> dict[str, str]:
    return _active()[0]


def is_external() -> bool:
    return _active()[1]


def encode(text: str, budget: int | None = None) -> list[int] | None:
    """text -> bit list ``[huffman chars..., EOT, zero padding]``.

    Returns None when a character is outside the codebook or, with a
    ``budget``, when the stream (including EOT) does not fit — callers
    fall back to the fixed 6-bit charset frame (modes/js8.py).
    """
    t = table()
    bits: list[int] = []
    for ch in text:
        code = t.get(ch.upper())
        if code is None:
            return None
        bits.extend(int(b) for b in code)
    bits.extend(int(b) for b in t[EOT])
    if budget is not None:
        if len(bits) > budget:
            return None
        bits.extend([0] * (budget - len(bits)))
    return bits


def decode(bits) -> str:
    """bit sequence -> text; stops at EOT (the tail is frame padding)."""
    inv = {v: k for k, v in table().items()}
    longest = max(len(v) for v in inv)
    out: list[str] = []
    cur = ""
    for b in bits:
        cur += "1" if int(b) else "0"
        ch = inv.get(cur)
        if ch is not None:
            if ch == EOT:
                break
            out.append(ch)
            cur = ""
        elif len(cur) > longest:
            break                      # malformed tail: stop, keep prefix
    return "".join(out)
