"""Cyclic redundancy checks over GF(2) for the digital-mode codecs.

FT8/FT4 protect the 77-bit payload with a 14-bit CRC (the 91 information
bits of LDPC(174,91) are payload+CRC).  The polynomial used here is 0x2757
(x^14+x^13+x^10+x^9+x^8+x^6+x^4+x^2+x^1+1), the value documented for the
FT8 protocol; the CRC is computed over the 77 payload bits zero-padded to
82 bits, matching the protocol's definition.

Implementation note: CRC over a fixed-length message is a *linear* map
GF(2)^n -> GF(2)^r, so for the batched device-side check we precompute the
n x r matrix once and the check becomes a masked XOR-matmul (parity via
sum mod 2) — no bit-serial loops on device.
"""

from __future__ import annotations

import numpy as np

FT8_CRC_POLY = 0x2757
FT8_CRC_BITS = 14
FT8_PAYLOAD_BITS = 77
# The protocol computes the 14-bit CRC over the payload extended to 82 bits.
FT8_CRC_MSG_BITS = 82


def crc_remainder(bits: np.ndarray, poly: int = FT8_CRC_POLY,
                  crc_bits: int = FT8_CRC_BITS) -> np.ndarray:
    """Bit-serial CRC of a 0/1 vector (MSB first). Returns ``crc_bits`` bits."""
    reg = 0
    top = 1 << (crc_bits - 1)
    mask = (1 << crc_bits) - 1
    for b in np.asarray(bits, dtype=np.uint8):
        high = (reg & top) != 0
        reg = ((reg << 1) & mask) | int(b)
        if high:
            reg ^= poly & mask
    # flush
    for _ in range(crc_bits):
        high = (reg & top) != 0
        reg = (reg << 1) & mask
        if high:
            reg ^= poly & mask
    return np.array([(reg >> (crc_bits - 1 - i)) & 1 for i in range(crc_bits)],
                    dtype=np.uint8)


def ft8_crc(payload77: np.ndarray) -> np.ndarray:
    """14-bit CRC of a 77-bit FT8/FT4 payload (padded to 82 bits)."""
    payload77 = np.asarray(payload77, dtype=np.uint8)
    assert payload77.shape == (FT8_PAYLOAD_BITS,)
    msg = np.concatenate([payload77, np.zeros(FT8_CRC_MSG_BITS - FT8_PAYLOAD_BITS,
                                              np.uint8)])
    return crc_remainder(msg)


def ft8_crc_matrix() -> np.ndarray:
    """[77, 14] GF(2) matrix M with crc(payload) = payload @ M mod 2.

    CRC of a zero-padded message is linear with zero offset, so M's rows are
    the CRCs of the unit vectors.  Used by the batched device-side CRC check.
    """
    m = np.zeros((FT8_PAYLOAD_BITS, FT8_CRC_BITS), dtype=np.uint8)
    for i in range(FT8_PAYLOAD_BITS):
        e = np.zeros(FT8_PAYLOAD_BITS, np.uint8)
        e[i] = 1
        m[i] = ft8_crc(e)
    return m


def check_ft8_crc(bits91: np.ndarray) -> bool:
    """True if bits91 = [payload77 | crc14] is consistent."""
    bits91 = np.asarray(bits91, dtype=np.uint8)
    return bool(np.all(ft8_crc(bits91[:FT8_PAYLOAD_BITS]) == bits91[FT8_PAYLOAD_BITS:]))
