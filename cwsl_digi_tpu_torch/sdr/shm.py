"""POSIX shared-memory IQ ring, mirroring the reference's CWSL contract.

The reference opens Win32 named file mappings ``CWSL<band>Band[<n>]`` whose
first page holds ``SM_HDR{SampleRate, BlockInSamples, L0}`` followed by a
circular buffer of IQ blocks, with a named event signalling new data
(source/SharedMemory.h:10-21, SharedMemory.cpp:101-246;
names source/CWSL_Utils.hpp:13-23).

This is the POSIX equivalent: ``/dev/shm`` segment with a small header and
a block ring; the event is replaced by a monotonically increasing write
counter the reader polls (cheap at SDR block rates).  A writer class is
included so feeders/tests can produce the stream.

Header layout (little-endian, 64 bytes):
    0:  u32 magic 0x43575344 ("CWSD")
    4:  u32 sample_rate
    8:  u32 block_in_samples
    12: i64 l0  (center frequency, Hz)
    20: u32 num_blocks
    24: u64 write_counter  (blocks written so far)
    32..64: reserved
Payload: num_blocks * block_in_samples complex64.
"""

from __future__ import annotations

import struct
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

MAGIC = 0x43575344
HEADER_SIZE = 64
MAX_CWSL = 32   # reference probes band indices 0..31 (CWSL_Utils.hpp:27)


def shm_name(band_index: int, sm_number: int = -1) -> str:
    """Reference naming: "CWSL<band>Band[<n>]" (source/CWSL_Utils.hpp:13-23)."""
    base = f"CWSL{band_index}Band"
    if sm_number >= 0:
        base += str(sm_number)
    return base


class ShmWriter:
    """Create + fill a shared IQ ring (the CWSL-writer role)."""

    def __init__(self, name: str, sample_rate: int, block_in_samples: int,
                 l0: int, num_blocks: int = 32) -> None:
        size = HEADER_SIZE + num_blocks * block_in_samples * 8
        try:
            self._shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        except FileExistsError:
            legacy = shared_memory.SharedMemory(name=name)
            legacy.close()
            legacy.unlink()
            self._shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        self.name = name
        self.sample_rate = sample_rate
        self.block_in_samples = block_in_samples
        self.l0 = l0
        self.num_blocks = num_blocks
        self._count = 0
        struct.pack_into("<IIIqIQ", self._shm.buf, 0, MAGIC, sample_rate,
                         block_in_samples, l0, num_blocks, 0)
        self._ring = np.ndarray(
            (num_blocks, block_in_samples), dtype=np.complex64,
            buffer=self._shm.buf, offset=HEADER_SIZE,
        )

    def write_block(self, iq: np.ndarray) -> None:
        iq = np.asarray(iq, np.complex64)
        assert iq.shape == (self.block_in_samples,)
        self._ring[self._count % self.num_blocks] = iq
        self._count += 1
        struct.pack_into("<Q", self._shm.buf, 24, self._count)

    def close(self, unlink: bool = True) -> None:
        self._ring = None
        self._shm.close()
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class ShmSource:
    """Open + read a shared IQ ring (the reference's CSharedMemory::Open/
    Read/WaitForNewData role, source/SharedMemory.cpp:101-246)."""

    POLL_S = 0.002

    def __init__(self, name: str) -> None:
        self._shm = shared_memory.SharedMemory(name=name)
        magic, sr, bis, l0, nb, wc = struct.unpack_from("<IIIqIQ", self._shm.buf, 0)
        if magic != MAGIC:
            self._shm.close()
            raise ValueError(f"shm segment {name!r} is not a CWSL-DIGI-TPU ring")
        self.name = name
        self.sample_rate = sr
        self.block_size = bis
        self.lo_freq = int(l0)
        self.num_blocks = nb
        self.live = True    # a timeout just means the writer is idle
        self.overruns = 0   # blocks lost to writer lapping (metric)
        self._read_count = wc   # start at current head (like opening mid-stream)
        self._ring = np.ndarray(
            (nb, bis), dtype=np.complex64, buffer=self._shm.buf,
            offset=HEADER_SIZE,
        )

    def _write_counter(self) -> int:
        return struct.unpack_from("<Q", self._shm.buf, 24)[0]

    def bytes_to_read(self) -> int:
        """Pending blocks * bytes (reference: BytesToRead)."""
        return (self._write_counter() - self._read_count) * self.block_size * 8

    def read_block(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        """Block until the next IQ block or timeout (reference:
        WaitForNewData + Read)."""
        deadline = time.monotonic() + timeout
        while self._write_counter() <= self._read_count:
            if time.monotonic() >= deadline:
                return None
            time.sleep(self.POLL_S)
        wc = self._write_counter()
        # overrun: if the writer lapped us, skip to the oldest safe block
        # and COUNT the loss — silent skips were a round-2 finding
        if wc - self._read_count >= self.num_blocks:
            skip_to = wc - self.num_blocks + 1
            self.overruns += skip_to - self._read_count
            self._read_count = skip_to
        block = np.array(self._ring[self._read_count % self.num_blocks])
        self._read_count += 1
        return block

    def close(self) -> None:
        self._ring = None
        self._shm.close()


def find_band(freq_hz: float, sm_number: int = -1,
              candidates: int = MAX_CWSL) -> Optional[str]:
    """Scan shared memories for one whose [L0-SR/2, L0+SR/2] covers freq.

    Reference: findBand (source/CWSL_Utils.hpp:27-53).
    """
    for band in range(candidates):
        name = shm_name(band, sm_number)
        try:
            src = ShmSource(name)
        except (FileNotFoundError, ValueError):
            continue
        lo, sr = src.lo_freq, src.sample_rate
        src.close()
        if lo - sr / 2 <= freq_hz <= lo + sr / 2:
            return name
    return None
