"""JS8 (normal speed): FT8-derived 8-GFSK physical layer with free-form
text framing — batched PyTorch decoder.

Counterpart of ``cwsl_digi_tpu/modes/js8.py``, whose protocol code this
module repeats: the FT8 PHY (79 symbols x 1920 samples, 15 s T/R, 8-GFSK,
the 7x7 Costas sync at symbols 0/36/72, overridable through
``tables_ext.js8_costas``); LDPC(174,87) (the same-profile stand-in unless
``CWSL_DIGI_TPU_TABLES_DIR`` supplies the published table); 87 info bits =
75 payload + 12 CRC (poly 0xC06); the payload is a 3-bit frame type and 72
bits of content (6-bit or huffman-varicode text, directed, heartbeat and
compound frames).  JS8 and FT8 share the sync; only the code and the CRC
keep one from decoding the other.  :func:`classify` is the sender
extraction the spot grammar uses.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.modes import message77
from cwsl_digi_tpu_torch.modes.crc import crc_remainder
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu_torch.modes.gfsk_engine import GFSKDecoder, ModeSpec
from cwsl_digi_tpu_torch.modes.ldpc import BPDecoder, make_ldpc_code

NSYM = 79
SPS = 1920
T_R = 15.0


def _costas_rows() -> tuple[tuple[int, ...], ...]:
    """Three 7-tone sync rows (start/middle/end).

    JS8 normal mode inherits WSJT-X 1.8's FT8 PHY wholesale — including
    the 7x7 Costas array icos7 = (3,1,4,0,6,5,2) at symbols 0/36/72 (the
    array FT8 still uses; this repo's FT8 is on-air-exact against it).
    Cross-decode between JS8 and FT8 is prevented by the different LDPC
    code + CRC, not by the sync.  A published js8call override can still
    be supplied via CWSL_DIGI_TPU_TABLES_DIR/js8_costas.txt."""
    from cwsl_digi_tpu_torch.modes import tables_ext

    ext = tables_ext.js8_costas()
    if ext is not None:
        return tuple(tuple(int(t) for t in row) for row in ext)
    return ((3, 1, 4, 0, 6, 5, 2),) * 3


_COSTAS_ROWS = _costas_rows()
COSTAS_JS8 = _COSTAS_ROWS[0]
GRAY = (0, 1, 3, 2, 5, 6, 4, 7)
PAYLOAD_BITS = 75
CRC_BITS = 12
CRC_POLY = 0xC06

VARICODE = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789./?+-@#:!\"'$%&()*;<=>[]^_{}"
assert len(VARICODE) == 64

_sync_cells = tuple(
    (off + i, int(t))
    for off, row in zip((0, 36, 72), _COSTAS_ROWS)
    for i, t in enumerate(row)
)
DATA_SYMS = tuple(s for s in range(NSYM) if not (s < 7 or 36 <= s < 43 or s >= 72))

SPEC = ModeSpec(
    name="JS8",
    n_sym=NSYM,
    sps=SPS,
    n_tones=8,
    bits_per_sym=3,
    sync_cells=_sync_cells,
    data_syms=DATA_SYMS,
    gray_map=GRAY,
    trperiod=T_R,
    signal_start_s=0.5,
    top_k=96,
    bp_iters=30,
    max_hops=128,
    pad_hops=64,
    refine=True,
)

FRAME_TEXT = 0
FRAME_DIRECTED = 1
FRAME_HEARTBEAT = 2
FRAME_COMPOUND = 3
FRAME_TEXT_HUFF = 4       # huffman-varicode text (modes/js8_varicode.py)

# directed-message commands (JS8Call's directed grammar, classified by the
# reference via js8call's DecodedText/varicode, OutputHandler.cpp:403-503).
# 8-bit command + 8-bit numeric argument (e.g. 'SNR -12', 'HEARING' counts);
# '>' is the relay operator ("A> B> text").
DIRECTED_CMDS = ("", "SNR?", "SNR", "ACK", "73", "HEARTBEAT", "HB", "QSL?",
                 "QSL", "CQ", "AGN?", "INFO?", "INFO", "GRID?", "GRID",
                 "MSG", "MSG TO:", "QUERY", "QUERY MSGS", "QUERY CALL",
                 "STATUS?", "STATUS", "HEARING?", "HEARING", "DIT DIT",
                 "FB", "HW CPY?", "SK", "RR", "YES", "NO", ">")
# commands that carry a numeric argument in the arg8 field
_ARG_CMDS = frozenset({"SNR"})  # commands whose trailing number is an argument


@functools.lru_cache(maxsize=1)
def js8_code():
    """LDPC(174,87) — 87 info bits, 87 checks.

    Uses the published WSJT-X 1.8-era parity matrix when supplied via
    ``CWSL_DIGI_TPU_TABLES_DIR/js8_ldpc_174_87.txt`` (modes/tables_ext.py;
    columns must be in codeword bit order, info bits first), else the
    documented same-profile stand-in."""
    from cwsl_digi_tpu_torch.modes import tables_ext
    from cwsl_digi_tpu_torch.modes.ldpc import Code

    h = tables_ext.js8_parity()
    if h is not None:
        return Code.from_parity_matrix(h)
    return make_ldpc_code(174, 87, seed=87)


def js8_crc(payload: np.ndarray) -> np.ndarray:
    payload = np.asarray(payload, np.uint8)
    msg = np.concatenate([payload, np.zeros(5, np.uint8)])  # pad to 80
    return crc_remainder(msg, poly=CRC_POLY, crc_bits=CRC_BITS)


@functools.lru_cache(maxsize=1)
def js8_crc_matrix() -> np.ndarray:
    m = np.zeros((PAYLOAD_BITS, CRC_BITS), np.uint8)
    for i in range(PAYLOAD_BITS):
        e = np.zeros(PAYLOAD_BITS, np.uint8)
        e[i] = 1
        m[i] = js8_crc(e)
    return m


# ---------------------------------------------------------------------------
# Payload codec
# ---------------------------------------------------------------------------

def _pack_c58(call: str) -> int:
    v = 0
    for ch in call.rjust(11):
        v = v * 38 + message77._C58.index(ch)
    return v


def _unpack_c58(v: int) -> str:
    chars = []
    for _ in range(11):
        chars.append(message77._C58[v % 38])
        v //= 38
    return "".join(reversed(chars)).strip()


def pack_payload(text: str) -> np.ndarray:
    """Pack a message.

    - ``FROM: HB [GRID]`` / ``FROM: CQ [GRID]`` -> heartbeat frame
      (JS8Call's FrameHeartbeat: announce + optional 4-char grid);
    - ``FROM: TO CMD [arg]`` -> directed frame (both calls + command +
      8-bit numeric argument, e.g. ``KN4CRD: J1Y SNR -12``);
    - ``FROM:`` with a compound (nonstandard) callsign -> compound
      announce frame (base-38 c58, like JS8Call's two-frame compound
      flow — grid/text follows in the next frame);
    - anything else -> free text: huffman-varicode frame when the whole
      text fits the 72-bit budget (modes/js8_varicode.py), else the
      fixed 6-bit charset frame truncated to 12 chars (relay paths
      ``A> B> text`` ride as text, classified by :func:`classify`;
      multi-frame conversations go through :func:`pack_text_frames`).
    """
    t = text.strip().upper()
    words = t.split()
    if len(words) >= 2 and words[0].endswith(":"):
        from_call = words[0][:-1]
        rest = words[1:]
        if rest[0] in ("HB", "HEARTBEAT", "CQ") and len(rest) <= 2:
            grid = rest[1] if len(rest) == 2 else ""
            try:
                g15, _ = (message77.pack_grid15(grid) if grid
                          else (message77.MAXGRID4, 0))
                if g15 >= message77.MAXGRID4 and grid:
                    raise ValueError("heartbeat grid must be a locator")
                if message77._is_standard_call(from_call):
                    c1 = message77.pack_call28(from_call)
                    bits = (message77.bits_from_int(FRAME_HEARTBEAT, 3)
                            + [1 if rest[0] != "CQ" else 0]
                            + message77.bits_from_int(c1, 28)
                            + message77.bits_from_int(g15, 15)
                            + [0] * 28)
                    return np.asarray(bits, np.uint8)
                # compound call: announce frame (c58), grid rides separately
                bits = (message77.bits_from_int(FRAME_COMPOUND, 3)
                        + [1 if rest[0] != "CQ" else 0]
                        + message77.bits_from_int(_pack_c58(from_call), 58)
                        + [0] * 13)
                message77.register_call(from_call)
                return np.asarray(bits, np.uint8)
            except ValueError:
                pass
        if len(rest) >= 1:
            to_call = rest[0]
            cmd_words = rest[1:]
            arg = None
            # a trailing number is an argument only when what precedes it
            # is itself a command ("SNR -12"); bare "73" IS the command
            if (len(cmd_words) >= 2
                    and cmd_words[-1].lstrip("+-").isdigit()
                    and " ".join(cmd_words[:-1]) in DIRECTED_CMDS):
                arg = int(cmd_words[-1])
                cmd_words = cmd_words[:-1]
            cmd = " ".join(cmd_words)
            # arg byte: 0 = absent, else arg+64 (so -63..63 representable)
            if cmd in DIRECTED_CMDS and (arg is None or -63 <= arg <= 63):
                try:
                    c1 = message77.pack_call28(from_call)
                    c2 = message77.pack_call28(to_call)
                    bits = (message77.bits_from_int(FRAME_DIRECTED, 3)
                            + message77.bits_from_int(c1, 28)
                            + message77.bits_from_int(c2, 28)
                            + message77.bits_from_int(
                                DIRECTED_CMDS.index(cmd), 8)
                            + message77.bits_from_int(
                                0 if arg is None else arg + 64, 8))
                    return np.asarray(bits, np.uint8)
                except ValueError:
                    pass
    # free text: huffman varicode first (JS8Call's text layer — variable
    # code lengths fit ~18-24 common chars in the 72-bit budget vs the
    # fixed charset's 12); the 6-bit charset frame remains the fallback
    # for text the codebook cannot carry
    from cwsl_digi_tpu_torch.modes import js8_varicode

    hbits = js8_varicode.encode(t, budget=72)
    if hbits is not None:
        return np.asarray(
            message77.bits_from_int(FRAME_TEXT_HUFF, 3) + hbits, np.uint8)
    bits = [0, 0, 0]  # frame type TEXT
    content = t[:12].ljust(12)
    v = 0
    for ch in content:
        v = v * 64 + (VARICODE.index(ch) if ch in VARICODE else 0)
    bits += message77.bits_from_int(v, 72)
    return np.asarray(bits, np.uint8)


def pack_text_frames(text: str) -> list[np.ndarray]:
    """Chunk free text into as few huffman text frames as fit (JS8Call
    sends long conversations across consecutive 15 s frames).  Each frame
    is self-delimiting (EOT-terminated); reassembly is concatenation of
    the per-frame decodes in cadence order."""
    from cwsl_digi_tpu_torch.modes import js8_varicode

    t = text.strip().upper()
    frames: list[np.ndarray] = []
    while t:
        take = len(t)
        while take > 0 and js8_varicode.encode(t[:take], budget=72) is None:
            take -= 1
        if take == 0:       # leading char outside the codebook: 6-bit frame
            # Emit a raw FRAME_TEXT frame directly — routing the chunk back
            # through pack_payload could reclassify a mid-conversation
            # fragment that happens to look like "CALL: ..." as a directed/
            # heartbeat frame, corrupting reassembly.
            content = t[:12].ljust(12)
            v = 0
            for ch in content:
                v = v * 64 + (VARICODE.index(ch) if ch in VARICODE else 0)
            frames.append(np.asarray(
                message77.bits_from_int(FRAME_TEXT, 3)
                + message77.bits_from_int(v, 72), np.uint8))
            t = t[12:]
            continue
        frames.append(np.asarray(
            message77.bits_from_int(FRAME_TEXT_HUFF, 3)
            + js8_varicode.encode(t[:take], budget=72), np.uint8))
        t = t[take:]
    return frames or [pack_payload("")]


def unpack_payload(bits: np.ndarray) -> str | None:
    bits = np.asarray(bits, np.uint8)
    ftype = message77.int_from_bits(bits[:3])
    if ftype == FRAME_TEXT:
        v = message77.int_from_bits(bits[3:75])
        chars = []
        for _ in range(12):
            chars.append(VARICODE[v % 64])
            v //= 64
        return "".join(reversed(chars)).strip()
    if ftype == FRAME_TEXT_HUFF:
        from cwsl_digi_tpu_torch.modes import js8_varicode

        # No strip: the EOT mark already delimits the payload exactly, and
        # a chunk boundary in a multi-frame conversation may legitimately
        # fall on a space (pack_text_frames).  Display-layer trimming is
        # the spot parser's business (classify() strips).
        return js8_varicode.decode(bits[3:75])
    if ftype == FRAME_DIRECTED:
        c1 = message77.int_from_bits(bits[3:31])
        c2 = message77.int_from_bits(bits[31:59])
        cmd = message77.int_from_bits(bits[59:67])
        raw = message77.int_from_bits(bits[67:75])   # 0 = no argument
        if cmd >= len(DIRECTED_CMDS):
            return None
        w1 = message77.unpack_call28(c1)
        w2 = message77.unpack_call28(c2)
        tail = f" {DIRECTED_CMDS[cmd]}" if DIRECTED_CMDS[cmd] else ""
        if raw:
            tail += f" {raw - 64}"
        return f"{w1}: {w2}{tail}"
    if ftype == FRAME_HEARTBEAT:
        hb = int(bits[3])
        c1 = message77.int_from_bits(bits[4:32])
        g15 = message77.int_from_bits(bits[32:47])
        w1 = message77.unpack_call28(c1)
        grid = message77.unpack_grid15(g15, 0) if g15 < message77.MAXGRID4 \
            else ""
        kind = "HB" if hb else "CQ"
        return f"{w1}: {kind} {grid}".strip()
    if ftype == FRAME_COMPOUND:
        hb = int(bits[3])
        call = _unpack_c58(message77.int_from_bits(bits[4:62]))
        if not call:
            return None
        message77.register_call(call)
        return f"{call}: {'HB' if hb else 'CQ'}"
    return None


@dataclasses.dataclass(frozen=True)
class JS8Class:
    """Classification of one decoded JS8 text — the fields the reference
    pulls out of js8call's DecodedText for reporting/printing
    (OutputHandler.cpp:403-503): who sent it, whom it addresses, whether
    it is a CQ/heartbeat, any grid, and the relay path."""

    kind: str                 # "CQ" | "HB" | "DIRECTED" | "RELAY" | "TEXT"
    from_call: str = ""
    to_call: str = ""
    cmd: str = ""
    arg: int | None = None
    grid: str = ""
    relay_path: tuple[str, ...] = ()


def classify(text: str) -> JS8Class:
    """Classify a decoded JS8 message (sender extraction for spots)."""
    from cwsl_digi_tpu_torch.utils.hamutils import is_valid_locator

    t = text.strip().upper()
    words = t.split()
    if not words:
        return JS8Class(kind="TEXT")
    # relay path: "A> B> text"
    if words[0].endswith(">") and len(words[0]) > 1:
        path = []
        rest = words
        while rest and rest[0].endswith(">") and len(rest[0]) > 1:
            path.append(rest[0][:-1])
            rest = rest[1:]
        return JS8Class(kind="RELAY", from_call=path[0],
                        relay_path=tuple(path))
    if words[0].endswith(":") and len(words) >= 2:
        frm = words[0][:-1]
        rest = words[1:]
        if rest[0] in ("CQ", "HB", "HEARTBEAT"):
            grid = rest[1] if len(rest) > 1 and is_valid_locator(
                rest[1]) else ""
            kind = "CQ" if rest[0] == "CQ" else "HB"
            return JS8Class(kind=kind, from_call=frm, grid=grid)
        arg = None
        cmd_words = rest[1:]
        if (len(cmd_words) >= 2 and cmd_words[-1].lstrip("+-").isdigit()
                and " ".join(cmd_words[:-1]) in DIRECTED_CMDS):
            arg = int(cmd_words[-1])
            cmd_words = cmd_words[:-1]
        return JS8Class(kind="DIRECTED", from_call=frm, to_call=rest[0],
                        cmd=" ".join(cmd_words), arg=arg)
    if words[0] in ("CQ", "CQCQ") or t.startswith("CQ CQ"):
        # bare-text CQ ("CQCQ K1ABC" / "CQ CQ CQ K1ABC EN50")
        rest = [w for w in words if w not in ("CQ", "CQCQ")]
        frm = rest[0] if rest else ""
        grid = rest[1] if len(rest) > 1 and is_valid_locator(rest[1]) else ""
        return JS8Class(kind="CQ", from_call=frm, grid=grid)
    return JS8Class(kind="TEXT")


def encode_message(text: str) -> np.ndarray:
    payload = pack_payload(text)
    info = np.concatenate([payload, js8_crc(payload)])
    codeword = js8_code().encode(info)
    return SPEC.tones_from_codeword(codeword)


def synthesize(text: str, f0_hz: float = 1500.0, amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = 0.5) -> np.ndarray:
    from cwsl_digi_tpu_torch.modes.gfsk import place_burst

    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          SPEC.tone_spacing, bt=2.0)
    return place_burst(burst, window_len, start_s, amplitude)


class JS8Decoder(GFSKDecoder):
    """Batched JS8 windows in, DecodeResult lists out; its own
    LDPC(174,87) BP decoder, no AP; tables on ``device``."""

    def __init__(self, top_k: int | None = None, bp_iters: int | None = None,
                 fmax_hz: float | None = None,
                 device: torch.device | str | None = None):
        spec = SPEC
        if top_k or bp_iters or fmax_hz:
            # fmax_hz is jt9's -H highest decode frequency
            spec = dataclasses.replace(SPEC, top_k=top_k or SPEC.top_k,
                                       bp_iters=bp_iters or SPEC.bp_iters,
                                       fmax_hz=fmax_hz or SPEC.fmax_hz)

        def _unpack(bits):
            # a malformed frame (None) differs from an empty text frame ("")
            text = unpack_payload(bits[:PAYLOAD_BITS])
            return "<bad frame>" if text is None else text

        super().__init__(
            spec,
            BPDecoder(js8_code(), iters=spec.bp_iters, device=device),
            js8_crc_matrix(),
            Mode.JS8,
            unpack=_unpack,
            device=device,
        )
