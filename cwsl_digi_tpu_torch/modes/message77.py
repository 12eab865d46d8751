"""77-bit message payload pack/unpack for FT8/FT4 (and JS8-normal framing).

The reference never packs messages itself — it parses the *text* output of
jt9.exe and re-validates it (source/OutputHandler.cpp:505-621, 924-1128).
A native decoder needs the actual bit-level codec.  This implements the
FT8-style 77-bit payload structure:

    i3 (3 bits, message type) stored in bits 74..76;
    type 1 "standard":  c28 r1 c28 r1 R1 g15   (28+1+28+1+1+15 = 74)
    type 0.0 "free text": 71-bit base-42 packing of 13 chars

c28 field layout (standard-call packing identical in structure to the FT8
protocol: tokens, then a 22-bit hash region, then base-37/36/10/27^3 packed
standard calls):

    0=DE, 1=QRZ, 2=CQ, 3..1002 = "CQ nnn",
    1003..532443             = "CQ A".."CQ ZZZZ" (base-27 letter tags)
    NTOKENS..NTOKENS+MAX22-1 = 22-bit hashed nonstandard calls <CALL>
    NTOKENS+MAX22 + n        = standard callsign, n = packed 6 chars

g15: 0..32399 = 4-char grid; 32400 = blank; 32401=RRR, 32402=RR73,
32403=73; 32404+(report+50) = numeric SNR report (-50..+49 dB).

Every encode/decode path here round-trips by construction and is covered by
tests; the grammar of produced text matches what the reference's
OutputHandler expects to parse (CQ/grid/report/RRR/73 forms,
source/OutputHandler.cpp:924-1128).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cwsl_digi_tpu_torch.modes import tables

NTOKENS = 2_063_592
MAX22 = 4_194_304
MAXGRID4 = 32_400

_C1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"   # 37
_C2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"    # 36
_C3 = "0123456789"                              # 10
_C4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"             # 27
_FREE = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ+-./?"  # 42 chars

# Hash tables for calls seen this session (hash value -> call).  The
# reference relies on jt9's equivalent cache; `<...>` displays when the hash
# is unknown (cf. packed-call handling OutputHandler.cpp:788-799).  Every
# call that passes through pack/unpack is registered so later hashed
# references resolve, mirroring WSJT-X's behavior of hashing all calls heard.
_HASH_TABLE: dict[int, str] = {}     # 22-bit
_HASH12_TABLE: dict[int, str] = {}   # 12-bit (type-4 messages)
_HASH10_TABLE: dict[int, str] = {}   # 10-bit (DXpedition fox reference)

# base-38 charset for type-4 nonstandard calls (11 chars, 58 bits)
_C58 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/"


def bits_from_int(v: int, width: int) -> list[int]:
    return [(v >> (width - 1 - i)) & 1 for i in range(width)]


def int_from_bits(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def hash22(call: str) -> int:
    """WSJT-X 22-bit callsign hash (packjt77.f90 ihashcall, m=22).

    Matches on-air <CALL> hash references from real WSJT-X stations
    (the interop contract behind OutputHandler.cpp:788-799).
    """
    h22 = tables.ihashcall(call.strip(), 22)
    _HASH_TABLE[h22] = call.strip().upper()
    return h22


def hash12(call: str) -> int:
    """WSJT-X 12-bit hash (ihashcall m=12) for type-4 'other call' refs."""
    h12 = tables.ihashcall(call.strip(), 12)
    _HASH12_TABLE[h12] = call.strip().upper()
    return h12


def hash10(call: str) -> int:
    """WSJT-X 10-bit hash (ihashcall m=10), used by the DXpedition (0.1)
    fox-call reference and Q65/i3=5 formats."""
    h10 = tables.ihashcall(call.strip(), 10)
    _HASH10_TABLE[h10] = call.strip().upper()
    return h10


def register_call(call: str) -> None:
    """Record a heard call in every hash table."""
    c = call.strip().strip("<>").upper()
    if len(c) >= 3:
        hash22(c)
        hash12(c)
        hash10(c)


def _is_standard_call(call: str) -> bool:
    c = call.upper()
    if not (2 <= len(c) <= 6):
        return False
    # align so 3rd char is a digit
    if len(c) >= 3 and c[2].isdigit():
        a = c
    elif len(c) >= 2 and c[1].isdigit():
        a = " " + c
    else:
        return False
    a = a.ljust(6)
    if len(a) != 6:
        return False
    return (
        a[0] in _C1 and a[1] in _C2 and a[2] in _C3
        and all(ch in _C4 for ch in a[3:])
    )


def pack_call28(call: str) -> int:
    """Callsign/token -> c28."""
    c = call.strip().upper()
    if c == "DE":
        return 0
    if c == "QRZ":
        return 1
    if c == "CQ":
        return 2
    if c.startswith("CQ "):
        tag = c[3:].strip()
        if tag.isdigit() and len(tag) <= 3:
            return 3 + int(tag)
        if tag.isalpha() and 1 <= len(tag) <= 4:
            v = 0
            for ch in tag.rjust(4):
                v = v * 27 + _C4.index(ch if ch != " " else " ")
            return 1003 + v
        raise ValueError(f"unencodable CQ tag: {call!r}")
    if c.startswith("<") and c.endswith(">"):
        return NTOKENS + hash22(c[1:-1])
    if _is_standard_call(c):
        a = c if (len(c) >= 3 and c[2].isdigit()) else " " + c
        a = a.ljust(6)
        n = _C1.index(a[0])
        n = n * 36 + _C2.index(a[1])
        n = n * 10 + _C3.index(a[2])
        n = n * 27 + _C4.index(a[3])
        n = n * 27 + _C4.index(a[4])
        n = n * 27 + _C4.index(a[5])
        return NTOKENS + MAX22 + n
    # nonstandard -> hashed
    return NTOKENS + hash22(c)


def unpack_call28(c28: int) -> str:
    if c28 == 0:
        return "DE"
    if c28 == 1:
        return "QRZ"
    if c28 == 2:
        return "CQ"
    if 3 <= c28 <= 1002:
        return f"CQ {c28 - 3:03d}"
    if 1003 <= c28 < NTOKENS:
        v = c28 - 1003
        chars = []
        for _ in range(4):
            chars.append(_C4[v % 27])
            v //= 27
        tag = "".join(reversed(chars)).strip()
        return f"CQ {tag}"
    if NTOKENS <= c28 < NTOKENS + MAX22:
        h = c28 - NTOKENS
        call = _HASH_TABLE.get(h)
        return f"<{call}>" if call else "<...>"
    n = c28 - NTOKENS - MAX22
    c6 = _C4[n % 27]; n //= 27
    c5 = _C4[n % 27]; n //= 27
    c4 = _C4[n % 27]; n //= 27
    c3 = _C3[n % 10]; n //= 10
    c2 = _C2[n % 36]; n //= 36
    c1 = _C1[n % 37]
    return (c1 + c2 + c3 + c4 + c5 + c6).strip()


def pack_grid15(text: str) -> tuple[int, int]:
    """Third-word -> (g15, R-flag)."""
    t = text.strip().upper()
    r = 0
    if t.startswith("R ") and len(t) == 6:
        r = 1
        t = t[2:]
    if t == "":
        return MAXGRID4, r
    if t == "RRR":
        return MAXGRID4 + 1, r
    if t == "RR73":
        return MAXGRID4 + 2, r
    if t == "73":
        return MAXGRID4 + 3, r
    if (len(t) == 4 and t[0] in "ABCDEFGHIJKLMNOPQR" and t[1] in "ABCDEFGHIJKLMNOPQR"
            and t[2].isdigit() and t[3].isdigit()):
        g = ((ord(t[0]) - 65) * 18 + (ord(t[1]) - 65)) * 100 + int(t[2]) * 10 + int(t[3])
        return g, r
    if t.startswith("R+") or t.startswith("R-"):
        r = 1
        t = t[1:]
    if t.startswith(("+", "-")):
        rpt = int(t)
        if -50 <= rpt <= 49:
            return MAXGRID4 + 4 + (rpt + 50), r
    raise ValueError(f"unencodable grid/report: {text!r}")


def unpack_grid15(g15: int, r: int) -> str:
    prefix = "R " if r else ""
    if g15 < MAXGRID4:
        d = g15 % 100
        ab = g15 // 100
        a, b = divmod(ab, 18)
        s = chr(65 + a) + chr(65 + b) + f"{d:02d}"
        return prefix + s
    if g15 == MAXGRID4:
        return prefix.strip()
    if g15 == MAXGRID4 + 1:
        return "RRR"
    if g15 == MAXGRID4 + 2:
        return "RR73"
    if g15 == MAXGRID4 + 3:
        return "73"
    rpt = g15 - MAXGRID4 - 4 - 50
    sign = "+" if rpt >= 0 else "-"
    return f"{'R' if r else ''}{sign}{abs(rpt):02d}"


@dataclasses.dataclass
class Message:
    """A decoded message: text plus structured fields for reporting."""

    text: str
    call1: str = ""      # addressee (or CQ)
    call2: str = ""      # sender
    grid: str = ""       # sender grid if present
    report: str = ""
    i3: int = 1
    is_cq: bool = False
    is_free_text: bool = False


def _is_nonstandard_call(w: str) -> bool:
    c = w.strip("<>")
    return (
        3 <= len(c) <= 11
        and not _is_standard_call(c)
        and all(ch in _C58 for ch in c)
        and any(ch.isdigit() for ch in c)
        and any(ch.isalpha() for ch in c)
    )


def pack77(text: str) -> np.ndarray:
    """Message text -> 77-bit payload (uint8 array).

    Type precedence mirrors WSJT-X packjt77: standard (1/2), then the
    special contest/beacon forms (0.1 DXpedition, 0.3/0.4 Field Day,
    3 RTTY RU, 5 EU VHF, 0.5 telemetry), then nonstandard-call type 4,
    then free text (0.0)."""
    stripped = text.strip().upper()
    words = stripped.split()
    for packer in (_pack_standard, _pack_dxpedition, _pack_fieldday,
                   _pack_rtty_ru, _pack_euvhf, _pack_telemetry,
                   _pack_nonstandard):
        try:
            return packer(words)
        except ValueError:
            pass
    return _pack_free_text(stripped)


_R2 = {"": 0, "RRR": 1, "RR73": 2, "73": 3}
_R2_INV = {v: k for k, v in _R2.items()}


def _pack_nonstandard(words: list[str]) -> np.ndarray:
    """Type 4: h12 | c58 | flip | r2 | cq | i3=4."""
    if not words:
        raise ValueError("empty")
    cq = 0
    flip = 0
    other = ""
    r2 = 0
    if words[0] == "CQ" and len(words) == 2 and _is_nonstandard_call(words[1]):
        cq = 1
        nonstd = words[1]
    elif len(words) in (2, 3):
        tail = words[2] if len(words) == 3 else ""
        if tail not in _R2:
            raise ValueError("type-4 carries only RRR/RR73/73 suffixes")
        r2 = _R2[tail]
        if _is_nonstandard_call(words[0]):
            nonstd, other, flip = words[0], words[1], 1
        elif _is_nonstandard_call(words[1]):
            nonstd, other, flip = words[1], words[0], 0
        else:
            raise ValueError("no nonstandard call")
        other = other.strip("<>")
        register_call(other)
    else:
        raise ValueError("not a type-4 message")
    nonstd = nonstd.strip("<>")
    register_call(nonstd)
    h12 = hash12(other) if other else 0
    v = 0
    for ch in nonstd.rjust(11):
        v = v * 38 + _C58.index(ch)
    bits = (
        bits_from_int(h12, 12) + bits_from_int(v, 58)
        + [flip] + bits_from_int(r2, 2) + [cq] + bits_from_int(4, 3)
    )
    return np.array(bits, dtype=np.uint8)


def _unpack_nonstandard(bits: np.ndarray) -> Message:
    h12 = int_from_bits(bits[0:12])
    v = int_from_bits(bits[12:70])
    flip = int(bits[70])
    r2 = int_from_bits(bits[71:73])
    cq = int(bits[73])
    chars = []
    for _ in range(11):
        chars.append(_C58[v % 38])
        v //= 38
    nonstd = "".join(reversed(chars)).strip()
    register_call(nonstd)
    if cq:
        text = f"CQ {nonstd}"
        return Message(text=text, call1="CQ", call2=nonstd, i3=4, is_cq=True)
    other = _HASH12_TABLE.get(h12)
    other_disp = f"<{other}>" if other else "<...>"
    suffix = _R2_INV[r2]
    if flip:
        wordsout = [nonstd, other_disp]
        call1, call2 = nonstd, other or ""
    else:
        wordsout = [other_disp, nonstd]
        call1, call2 = other or "", nonstd
    if suffix:
        wordsout.append(suffix)
    return Message(text=" ".join(wordsout), call1=wordsout[0],
                   call2=wordsout[1].strip("<>"), i3=4)


def _pack_call28_strict(call: str) -> int:
    """pack_call28, but a *bare* nonstandard call raises so pack77 prefers
    the type-4 encoding (which carries the call verbatim); explicit
    ``<CALL>`` still packs as a 22-bit hash."""
    c = call.strip().upper()
    if not (c.startswith("<") or c in ("DE", "QRZ", "CQ")
            or c.startswith("CQ ") or _is_standard_call(c)):
        raise ValueError(f"nonstandard call {call!r} needs type 4")
    return pack_call28(c)


def _pack_standard(words: list[str]) -> np.ndarray:
    # /R (i3=1) and /P (i3=2, EU VHF) suffixes on standard calls
    suffixes = [w[-2:] if w.endswith(("/R", "/P")) else "" for w in words]
    if any(suffixes):
        sfx = [s for s in suffixes if s]
        if len(set(sfx)) > 1 or any(suffixes[2:]):
            raise ValueError("mixed or misplaced /R,/P suffixes")
        bare = [w[:-2] if s else w for w, s in zip(words, suffixes)]
        base = _pack_standard(bare)
        if sfx[0] == "/P":
            base[74:77] = bits_from_int(2, 3)    # i3=2 (EU VHF)
        for wi, s in enumerate(suffixes[:2]):
            if s and wi == 0 and words[0] != "CQ":
                base[28] = 1                      # r1a/p1a
            elif s:
                base[57] = 1                      # r1b/p1b
        return base
    if not words:
        raise ValueError("empty")
    if words[0] == "CQ":
        # CQ [TAG] CALL [GRID] — a tag is 1-3 digits or 1-4 letters followed
        # by a valid callsign ("CQ DX", "CQ POTA", "CQ 021", ...)
        if len(words) >= 3 and len(words[1]) <= 4 \
                and (words[1].isdigit() or words[1].isalpha()) \
                and _is_standard_call(words[2]):
            c1 = pack_call28(f"CQ {words[1]}")
            rest = words[2:]
        else:
            c1 = pack_call28("CQ")
            rest = words[1:]
        if not rest:
            raise ValueError("CQ without call")
        c2 = _pack_call28_strict(rest[0])
        r2 = 0
        g15, rr = pack_grid15(" ".join(rest[1:])) if len(rest) > 1 else (MAXGRID4, 0)
        return _assemble77(c1, 0, c2, r2, rr, g15, i3=1)
    if len(words) >= 2:
        c1 = _pack_call28_strict(words[0])
        c2 = _pack_call28_strict(words[1])
        tail = " ".join(words[2:])
        g15, rr = pack_grid15(tail) if tail else (MAXGRID4, 0)
        return _assemble77(c1, 0, c2, 0, rr, g15, i3=1)
    raise ValueError("not a standard message")


def _assemble77(c28a: int, r1a: int, c28b: int, r1b: int, rr: int,
                g15: int, i3: int) -> np.ndarray:
    bits = (
        bits_from_int(c28a, 28) + [r1a] + bits_from_int(c28b, 28) + [r1b]
        + [rr] + bits_from_int(g15, 15) + bits_from_int(i3, 3)
    )
    return np.array(bits, dtype=np.uint8)


def _pack_free_text(text: str) -> np.ndarray:
    t = text[:13].rjust(13)
    v = 0
    for ch in t:
        v = v * 42 + (_FREE.index(ch) if ch in _FREE else 0)
    bits = bits_from_int(v, 71) + [0, 0, 0] + bits_from_int(0, 3)
    return np.array(bits, dtype=np.uint8)


# --- contest / special formats (QEX "The FT4 and FT8 Communication
# Protocols" Table 1; reference consumes these via jt9 stdout,
# source/OutputHandler.cpp:924-1128) -----------------------------------

# ARRL/RAC sections for Field Day (S7), alphabetized with DX last — the
# ordering convention of WSJT-X packjt77.
ARRL_SECTIONS = (
    "AB", "AK", "AL", "AR", "AZ", "BC", "CO", "CT", "DE", "EB", "EMA",
    "ENY", "EPA", "EWA", "GA", "GTA", "IA", "ID", "IL", "IN", "KS", "KY",
    "LA", "LAX", "MAR", "MB", "MDC", "ME", "MI", "MN", "MO", "MS", "MT",
    "NC", "ND", "NE", "NFL", "NH", "NL", "NLI", "NM", "NNJ", "NNY", "NT",
    "NTX", "NV", "OH", "OK", "ONE", "ONN", "ONS", "OR", "ORG", "PAC",
    "PR", "QC", "RI", "SB", "SC", "SCV", "SD", "SDG", "SF", "SFL", "SJV",
    "SK", "SNJ", "STX", "SV", "TN", "TX", "UT", "VA", "VI", "VT", "WCF",
    "WI", "WMA", "WNY", "WPA", "WTX", "WV", "WWA", "WY", "DX",
)

# RTTY Roundup s13 states/provinces (serial numbers occupy 1..8000;
# 8001+index selects a state) — US states in conventional order, then
# Canadian provinces, then DC, per the WSJT-X RTTY RU convention.
RU_STATES = (
    "AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA", "HI",
    "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA", "MI",
    "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ", "NM", "NY", "NC",
    "ND", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX", "UT",
    "VT", "VA", "WA", "WV", "WI", "WY", "NB", "NS", "QC", "ON", "MB",
    "SK", "AB", "BC", "NWT", "NF", "LB", "NU", "YT", "PEI", "DC",
)


def _pack_dxpedition(words: list[str]) -> np.ndarray:
    """Type 0.1: 'K1ABC RR73; W9XYZ <KH1/KH7Z> -08'
    = c28 c28 h10 r5 n3=1 i3=0 (Fox multi-stream acknowledgment)."""
    if len(words) != 5 or words[1] != "RR73;":
        raise ValueError("not a DXpedition message")
    c1, c2, fox, rpt = words[0], words[2], words[3], words[4]
    if not (fox.startswith("<") and fox.endswith(">")):
        raise ValueError("fox call must be hashed <CALL>")
    try:
        r = int(rpt)
    except ValueError:
        raise ValueError("bad report") from None
    if not (-30 <= r <= 32) or (r + 30) % 2:
        raise ValueError("report out of range (-30..+32 even)")
    bits = (bits_from_int(_pack_call28_strict(c1), 28)
            + bits_from_int(_pack_call28_strict(c2), 28)
            + bits_from_int(hash10(fox.strip("<>")), 10)
            + bits_from_int((r + 30) // 2, 5)
            + bits_from_int(1, 3) + bits_from_int(0, 3))
    return np.array(bits, dtype=np.uint8)


def _unpack_dxpedition(bits: np.ndarray) -> Message:
    c1 = unpack_call28(int_from_bits(bits[0:28]))
    c2 = unpack_call28(int_from_bits(bits[28:56]))
    fox = _HASH10_TABLE.get(int_from_bits(bits[56:66]))
    rpt = 2 * int_from_bits(bits[66:71]) - 30
    fox_disp = f"<{fox}>" if fox else "<...>"
    text = f"{c1} RR73; {c2} {fox_disp} {rpt:+03d}"
    return Message(text=text, call1=c2, call2=fox or "", i3=0,
                   report=f"{rpt:+03d}")


def _pack_fieldday(words: list[str]) -> np.ndarray:
    """Types 0.3/0.4: 'WA9XYZ KA1ABC R 16A EMA'
    = c28 c28 R1 n4 k3 S7 n3=3 (transmitters 17-32 -> n3=4).

    Class/section are stored 1-based, matching Fortran packjt77's
    natural 1-based ``index('ABCDEF', class)`` / section-table lookup
    (class A -> k3=1, first section -> S7=1); round-trip tested here,
    not yet validated against a WSJT-X ft8code bit vector."""
    if len(words) == 5 and words[2] == "R":
        r1, cls, sec = 1, words[3], words[4]
    elif len(words) == 4:
        r1, cls, sec = 0, words[2], words[3]
    else:
        raise ValueError("not a Field Day message")
    if sec not in ARRL_SECTIONS or len(cls) < 2 or not cls[:-1].isdigit() \
            or cls[-1] not in "ABCDEF":
        raise ValueError("not a Field Day exchange")
    ntx = int(cls[:-1])
    if not 1 <= ntx <= 32:
        raise ValueError("transmitter count 1..32")
    n3 = 3 if ntx <= 16 else 4
    bits = (bits_from_int(_pack_call28_strict(words[0]), 28)
            + bits_from_int(_pack_call28_strict(words[1]), 28)
            + [r1] + bits_from_int((ntx - 1) % 16, 4)
            + bits_from_int("ABCDEF".index(cls[-1]) + 1, 3)
            + bits_from_int(ARRL_SECTIONS.index(sec) + 1, 7)
            + bits_from_int(n3, 3) + bits_from_int(0, 3))
    return np.array(bits, dtype=np.uint8)


def _unpack_fieldday(bits: np.ndarray, n3: int) -> Message:
    c1 = unpack_call28(int_from_bits(bits[0:28]))
    c2 = unpack_call28(int_from_bits(bits[28:56]))
    r1 = int(bits[56])
    ntx = int_from_bits(bits[57:61]) + 1 + (16 if n3 == 4 else 0)
    k3 = int_from_bits(bits[61:64])
    s7 = int_from_bits(bits[64:71])
    cls = "ABCDEF"[k3 - 1] if 1 <= k3 <= 6 else "?"
    sec = ARRL_SECTIONS[s7 - 1] if 1 <= s7 <= len(ARRL_SECTIONS) else "?"
    ex = f"{ntx}{cls} {sec}"
    text = " ".join(w for w in (c1, c2, "R" if r1 else "", ex) if w)
    return Message(text=text, call1=c1, call2=c2, i3=0, report=ex)


def _pack_rtty_ru(words: list[str]) -> np.ndarray:
    """Type 3: '[TU;] K1ABC W9XYZ [R] 579 WI|0123'
    = t1 c28 c28 R1 r3 s13 (ARRL RTTY Roundup)."""
    w = list(words)
    tu = 0
    if w and w[0] == "TU;":
        tu = 1
        w = w[1:]
    if len(w) == 5 and w[2] == "R":
        r1, rst, ex = 1, w[3], w[4]
    elif len(w) == 4:
        r1, rst, ex = 0, w[2], w[3]
    else:
        raise ValueError("not an RTTY RU message")
    if len(rst) != 3 or not rst.isdigit() or rst[0] != "5" \
            or rst[2] != "9" or not "2" <= rst[1] <= "9":
        raise ValueError("RST must be 529..599")
    if ex in RU_STATES:
        s13 = 8001 + RU_STATES.index(ex)
    elif ex.isdigit() and 1 <= int(ex) <= 7999:
        s13 = int(ex)
    else:
        raise ValueError("exchange must be serial 1..7999 or state")
    bits = ([tu] + bits_from_int(_pack_call28_strict(w[0]), 28)
            + bits_from_int(_pack_call28_strict(w[1]), 28)
            + [r1] + bits_from_int(int(rst[1]) - 2, 3)
            + bits_from_int(s13, 13) + bits_from_int(3, 3))
    return np.array(bits, dtype=np.uint8)


def _unpack_rtty_ru(bits: np.ndarray) -> Message:
    tu = int(bits[0])
    c1 = unpack_call28(int_from_bits(bits[1:29]))
    c2 = unpack_call28(int_from_bits(bits[29:57]))
    r1 = int(bits[57])
    rst = f"5{int_from_bits(bits[58:61]) + 2}9"
    s13 = int_from_bits(bits[61:74])
    if s13 >= 8001 and s13 - 8001 < len(RU_STATES):
        ex = RU_STATES[s13 - 8001]
    else:
        ex = f"{s13:04d}"
    text = " ".join(w for w in (("TU;" if tu else ""), c1, c2,
                                ("R" if r1 else ""), rst, ex) if w)
    return Message(text=text, call1=c1, call2=c2, i3=3,
                   report=f"{rst} {ex}")


def _grid25(grid: str) -> int:
    g = grid.upper()
    if len(g) != 6 or not all(c in "ABCDEFGHIJKLMNOPQR" for c in g[:2]) \
            or not g[2:4].isdigit() \
            or not all("A" <= c <= "X" for c in g[4:]):
        raise ValueError("need a 6-char locator")
    v = (ord(g[0]) - 65) * 18 + (ord(g[1]) - 65)
    v = v * 10 + int(g[2])
    v = v * 10 + int(g[3])
    v = v * 24 + (ord(g[4]) - 65)
    v = v * 24 + (ord(g[5]) - 65)
    return v


def _ungrid25(v: int) -> str:
    e2 = v % 24; v //= 24
    e1 = v % 24; v //= 24
    d2 = v % 10; v //= 10
    d1 = v % 10; v //= 10
    a2 = v % 18; v //= 18
    return (chr(65 + v) + chr(65 + a2) + str(d1) + str(d2)
            + chr(65 + e1) + chr(65 + e2))


def _pack_euvhf(words: list[str]) -> np.ndarray:
    """Type 5: '<G4ABC> <PA9XYZ> R 570007 JO22DB'
    = h12 h22 R1 r3 s11 g25 (EU VHF contest, 6-digit report+serial)."""
    if len(words) == 5 and words[2] == "R":
        r1, ex, grid = 1, words[3], words[4]
    elif len(words) == 4:
        r1, ex, grid = 0, words[2], words[3]
    else:
        raise ValueError("not an EU VHF message")
    c1, c2 = words[0], words[1]
    if not (c1.startswith("<") and c2.startswith("<")):
        raise ValueError("EU VHF carries hashed calls")
    if len(ex) != 6 or not ex.isdigit() or not 52 <= int(ex[:2]) <= 59:
        raise ValueError("exchange must be RSdddd with RS 52..59")
    if int(ex[2:]) > 2047:
        # the s11 field holds 0..2047; wrapping would corrupt the serial,
        # so reject and let the message ride as free text instead
        raise ValueError("EU VHF serial exceeds 2047")
    g25 = _grid25(grid)
    c1b, c2b = c1.strip("<>"), c2.strip("<>")
    register_call(c1b)
    register_call(c2b)
    bits = (bits_from_int(hash12(c1b), 12) + bits_from_int(hash22(c2b), 22)
            + [r1] + bits_from_int(int(ex[:2]) - 52, 3)
            + bits_from_int(int(ex[2:]), 11)
            + bits_from_int(g25, 25) + bits_from_int(5, 3))
    return np.array(bits, dtype=np.uint8)


def _unpack_euvhf(bits: np.ndarray) -> Message:
    h12 = int_from_bits(bits[0:12])
    h22 = int_from_bits(bits[12:34])
    r1 = int(bits[34])
    rs = int_from_bits(bits[35:38]) + 52
    serial = int_from_bits(bits[38:49])
    grid = _ungrid25(int_from_bits(bits[49:74]))
    c1 = _HASH12_TABLE.get(h12)
    c2 = _HASH_TABLE.get(h22)
    c1d = f"<{c1}>" if c1 else "<...>"
    c2d = f"<{c2}>" if c2 else "<...>"
    ex = f"{rs}{serial:04d}"
    text = " ".join(w for w in (c1d, c2d, ("R" if r1 else ""), ex, grid)
                    if w)
    return Message(text=text, call1=c1 or "", call2=c2 or "", i3=5,
                   grid=grid[:4], report=ex)


def _pack_telemetry(words: list[str]) -> np.ndarray:
    """Type 0.5: up to 18 hex digits (71 bits, first digit <= 7)."""
    if len(words) != 1:
        raise ValueError("telemetry is one token")
    t = words[0]
    if not (6 <= len(t) <= 18) or not all(c in "0123456789ABCDEF"
                                          for c in t):
        raise ValueError("not telemetry hex")
    v = int(t, 16)
    if v >> 71:
        raise ValueError("telemetry exceeds 71 bits")
    bits = bits_from_int(v, 71) + bits_from_int(5, 3) + bits_from_int(0, 3)
    return np.array(bits, dtype=np.uint8)


def _unpack_telemetry(bits: np.ndarray) -> Message:
    v = int_from_bits(bits[0:71])
    # pad to the 6-hex-digit pack minimum so unpack -> pack is stable
    # (telemetry bits carry no length, so longer leading zeros are lost)
    return Message(text=f"{v:06X}", i3=0, is_free_text=True)


def unpack77(bits: np.ndarray) -> Message:
    bits = np.asarray(bits).astype(np.uint8)
    assert bits.shape == (77,)
    i3 = int_from_bits(bits[74:77])
    if i3 == 1 or i3 == 2:
        c28a = int_from_bits(bits[0:28])
        c28b = int_from_bits(bits[29:57])
        rr = int(bits[58])
        g15 = int_from_bits(bits[59:74])
        w1 = unpack_call28(c28a)
        w2 = unpack_call28(c28b)
        # record heard calls so later hashed references resolve
        for w in (w1, w2):
            if _is_standard_call(w):
                register_call(w)
        # r1a/r1b (i3=1) mark /R rovers; p1a/p1b (i3=2) mark /P (EU VHF)
        sfx = "/R" if i3 == 1 else "/P"
        if bits[28] and _is_standard_call(w1):
            w1 += sfx
        if bits[57] and _is_standard_call(w2):
            w2 += sfx
        w3 = unpack_grid15(g15, rr)
        text = " ".join(w for w in (w1, w2, w3) if w)
        msg = Message(text=text, call1=w1, call2=w2, i3=i3)
        msg.is_cq = w1.startswith("CQ")
        if g15 < MAXGRID4:
            msg.grid = w3[-4:]
        elif g15 >= MAXGRID4 + 4:
            msg.report = w3
        return msg
    if i3 == 3:
        return _unpack_rtty_ru(bits)
    if i3 == 4:
        return _unpack_nonstandard(bits)
    if i3 == 5:
        return _unpack_euvhf(bits)
    if i3 == 0:
        n3 = int_from_bits(bits[71:74])
        if n3 == 0:
            v = int_from_bits(bits[0:71])
            chars = []
            for _ in range(13):
                chars.append(_FREE[v % 42])
                v //= 42
            text = "".join(reversed(chars)).strip()
            return Message(text=text, i3=0, is_free_text=True)
        if n3 == 1:
            return _unpack_dxpedition(bits)
        if n3 in (3, 4):
            return _unpack_fieldday(bits, n3)
        if n3 == 5:
            return _unpack_telemetry(bits)
        return Message(text=f"<unsupported i3=0.{n3}>", i3=0,
                       is_free_text=True)
    return Message(text=f"<unsupported i3={i3}>", i3=i3, is_free_text=True)
