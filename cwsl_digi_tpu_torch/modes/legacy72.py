"""Legacy WSJT 72-bit source encoding (JT65) and WSPR 50-bit packing.

The reference gets these codecs for free from the external jt9/wsprd
binaries (spawn sites source/DecoderPool.hpp:648,1023-1026);
a native decoder needs the bit-exact source encoding to interoperate with
on-air transmissions.

Published structure (K1JT, "The JT65 Communications Protocol", QEX 2005;
WSJT lib packcall/packgrid/packtext; G4JNT "The WSPR Coding Process"):

* **packcall** (28 bits): 6-char callsign aligned so the 3rd char is the
  digit; the legacy character values are '0'-'9' -> 0-9, 'A'-'Z' -> 10-35,
  space -> 36 (G4JNT "The WSPR Coding Process": "Treating the characters
  0-9 as values 0-9, A-Z as 10 to 35, and [space] as 36"); packed as
  n = ((((c1*36 + c2)*10 + c3)*27 + (c4-10))*27 + (c5-10))*27 + (c6-10),
  i.e. the last three positions map A..Z -> 0..25, space -> 26.  NOTE this
  is NOT the 77-bit-era convention (FT8's packjt77 alphabets put space
  FIRST, message77.py) — the legacy codes predate it.  Values above
  NBASE = 37*36*10*27^3 = 262177560 are tokens: CQ = NBASE+1, QRZ = NBASE+2,
  "CQ nnn" = NBASE+3+nnn, and DE = 267796945.
* **packgrid** (15 bits): 4-char Maidenhead AAnn ->
  ng = (179 - 10*lonA - lonD)*180 + 10*latA + latD  (identical formula for
  JT65's grid2deg/packgrid path and WSPR's G4JNT M1 —  both reduce to this).
  JT65 specials above NGBASE = 32400: blank = +1, "-NN" = +1+NN,
  "R-NN" = +31+NN, "RO" = +62, "RRR" = +63, "73" = +64.
* **JT65 payload** (72 bits): [nc1:28][nc2:28][ng:16]; bit 15 of ng set
  means free text: 13 chars from a 42-char alphabet packed 5+5+3, the two
  overflow bits of the last group carried in bit 27 of nc1/nc2.
* **WSPR payload** (50 bits): [packcall:28][grid15:15][pwr+64:7]; the +64
  offset is G4JNT's N2 = M1*128 + pwr + 64 (wsprd's ntype convention).
"""

from __future__ import annotations

NBASE = 37 * 36 * 10 * 27 * 27 * 27          # 262_177_560
NGBASE = 180 * 180                           # 32_400
DE_TOKEN = 267_796_945

# Legacy (pre-77-bit) character values: digits first, SPACE LAST — the
# G4JNT/packjt convention (digit->0-9, letter->10-35, space->36; trailing
# positions subtract 10 so A->0..Z->25, space->26).  Round-4 used the
# 77-bit space-first alphabets here by mistake; that round-tripped
# internally but would mis-decode every real on-air JT65/WSPR callsign.
_A1 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "   # 37 (first char, space=36)
_A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"    # 36
_A3 = "0123456789"                              # 10
_A4 = "ABCDEFGHIJKLMNOPQRSTUVWXYZ "             # 27 (A=0..Z=25, space=26)
TEXT_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ +-./?"  # 42


def align_call(call: str) -> str | None:
    """Left-pad so char 3 is the digit; return the 6-char form or None."""
    c = call.strip().upper()
    if not 2 <= len(c) <= 6:
        return None
    if len(c) >= 3 and c[2].isdigit():
        a = c
    elif len(c) >= 2 and c[1].isdigit():
        a = " " + c
    else:
        return None
    a = a.ljust(6)
    if len(a) > 6:
        return None
    if a[0] not in _A1 or a[1] not in _A2 or a[2] not in _A3:
        return None
    if any(ch not in _A4 for ch in a[3:]):
        return None
    return a


def packcall(call: str) -> int | None:
    """Callsign/token -> 28-bit nc (None if not packable)."""
    c = call.strip().upper()
    if c == "CQ":
        return NBASE + 1
    if c == "QRZ":
        return NBASE + 2
    if c == "DE":
        return DE_TOKEN
    if c.startswith("CQ ") and c[3:].isdigit() and len(c[3:]) == 3:
        return NBASE + 3 + int(c[3:])
    a = align_call(c)
    if a is None:
        return None
    n = _A1.index(a[0])
    n = n * 36 + _A2.index(a[1])
    n = n * 10 + _A3.index(a[2])
    n = n * 27 + _A4.index(a[3])
    n = n * 27 + _A4.index(a[4])
    n = n * 27 + _A4.index(a[5])
    return n


def unpackcall(nc: int) -> str | None:
    if nc == NBASE + 1:
        return "CQ"
    if nc == NBASE + 2:
        return "QRZ"
    if nc == DE_TOKEN:
        return "DE"
    if NBASE + 3 <= nc <= NBASE + 1002:
        return f"CQ {nc - NBASE - 3:03d}"
    if nc > NBASE:
        return None
    c6 = _A4[nc % 27]; nc //= 27
    c5 = _A4[nc % 27]; nc //= 27
    c4 = _A4[nc % 27]; nc //= 27
    c3 = _A3[nc % 10]; nc //= 10
    c2 = _A2[nc % 36]; nc //= 36
    if nc >= 37:
        return None
    return (_A1[nc] + c2 + c3 + c4 + c5 + c6).strip() or None


def packgrid15(grid: str) -> int | None:
    """4-char grid -> the shared 15-bit field (no specials)."""
    g = grid.strip().upper()
    if len(g) != 4 or not (g[0].isalpha() and g[1].isalpha()
                           and g[2].isdigit() and g[3].isdigit()):
        return None
    i1, i2 = ord(g[0]) - 65, ord(g[1]) - 65
    if i1 > 17 or i2 > 17:
        return None
    return (179 - 10 * i1 - int(g[2])) * 180 + 10 * i2 + int(g[3])


def unpackgrid15(ng: int) -> str | None:
    if not 0 <= ng < NGBASE:
        return None
    col, rem = divmod(ng, 180)
    i1, i3 = divmod(179 - col, 10)
    i2, i4 = divmod(rem, 10)
    if i1 > 17 or i2 > 17:
        return None
    return f"{chr(65 + i1)}{chr(65 + i2)}{i3}{i4}"


def pack_third_field(word: str) -> int | None:
    """JT65 third word -> 16-bit ng (grid, report, or special)."""
    w = word.strip().upper()
    if w == "":
        return NGBASE + 1
    if w == "RO":
        return NGBASE + 62
    if w == "RRR":
        return NGBASE + 63
    if w == "73":
        return NGBASE + 64
    if w.startswith("R-") and w[2:].isdigit() and 1 <= int(w[2:]) <= 30:
        return NGBASE + 31 + int(w[2:])
    if w.startswith("-") and w[1:].isdigit() and 1 <= int(w[1:]) <= 30:
        return NGBASE + 1 + int(w[1:])
    return packgrid15(w)


def unpack_third_field(ng: int) -> str | None:
    """16-bit ng (text flag already stripped) -> third word ('' = blank)."""
    if ng < NGBASE:
        return unpackgrid15(ng)
    d = ng - NGBASE
    if d == 1:
        return ""
    if 2 <= d <= 31:
        return f"-{d - 1:02d}"
    if 32 <= d <= 61:
        return f"R-{d - 31:02d}"
    if d == 62:
        return "RO"
    if d == 63:
        return "RRR"
    if d == 64:
        return "73"
    return None


# --- free text (13 chars, 71 bits) -----------------------------------------

def packtext(text: str) -> tuple[int, int, int]:
    """13-char free text -> (nc1, nc2, ng) with ng bit 15 set."""
    msg = text.upper().ljust(13)[:13]
    msg = "".join(ch if ch in TEXT_ALPHABET else " " for ch in msg)
    idx = [TEXT_ALPHABET.index(ch) for ch in msg]
    nc1 = 0
    for i in idx[:5]:
        nc1 = nc1 * 42 + i
    nc2 = 0
    for i in idx[5:10]:
        nc2 = nc2 * 42 + i
    ng = 0
    for i in idx[10:]:
        ng = ng * 42 + i
    # 42^3 = 74088 needs 17 bits; the two overflow bits ride in bit 27 of
    # nc1 and nc2, the low 15 bits in ng with bit 15 (text flag) set.
    nc1 |= ((ng >> 16) & 1) << 27
    nc2 |= ((ng >> 15) & 1) << 27
    return nc1, nc2, (ng & 0x7FFF) | 0x8000


def unpacktext(nc1: int, nc2: int, ng: int) -> str:
    n3 = (ng & 0x7FFF) | ((nc2 >> 27) & 1) << 15 | ((nc1 >> 27) & 1) << 16
    nc1 &= (1 << 27) - 1
    nc2 &= (1 << 27) - 1
    chars = []
    for _ in range(5):
        chars.append(TEXT_ALPHABET[nc1 % 42]); nc1 //= 42
    for _ in range(5):
        chars.append(TEXT_ALPHABET[nc2 % 42]); nc2 //= 42
    for _ in range(3):
        chars.append(TEXT_ALPHABET[n3 % 42]); n3 //= 42
    out = "".join(chars[4::-1]) + "".join(chars[9:4:-1]) + \
        "".join(chars[12:9:-1])
    return out.rstrip()


# --- JT65 72-bit payload ----------------------------------------------------

def pack72(text: str) -> tuple[int, int, int]:
    """Message text -> (nc1, nc2, ng16).  Falls back to free text."""
    words = text.strip().upper().split()
    if 2 <= len(words) <= 4:
        w = list(words)
        # "CQ DX CALL [GRID]" and "CQ nnn CALL [GRID]" merge the first pair
        if w[0] == "CQ" and len(w) >= 3 and w[1].isdigit() and len(w[1]) == 3:
            w = [f"CQ {w[1]}"] + w[2:]
        if 2 <= len(w) <= 3:
            nc1 = packcall(w[0])
            nc2 = packcall(w[1])
            ng = pack_third_field(w[2] if len(w) == 3 else "")
            if nc1 is not None and nc2 is not None and ng is not None:
                return nc1, nc2, ng
    return packtext(text.strip()[:13])


def unpack72(nc1: int, nc2: int, ng: int) -> str | None:
    if ng & 0x8000:
        return unpacktext(nc1, nc2, ng) or None
    w1 = unpackcall(nc1)
    w2 = unpackcall(nc2)
    w3 = unpack_third_field(ng)
    if w1 is None or w2 is None or w3 is None:
        return None
    return " ".join(w for w in (w1, w2, w3) if w)
