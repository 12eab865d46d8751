"""IQ intake sources.

Replaces the reference's L0-L2 ingest stack (CW Skimmer shared memory +
Receiver threads, source/SharedMemory.cpp, source/Receiver.hpp) with a
source abstraction:

- :class:`ReplaySource` — file replay (.npy complex64 / raw interleaved
  float32 IQ / 2-channel WAV), the primary test/bench path;
- :class:`SyntheticSource` — generated band noise with embedded mode
  signals, for self-test;
- :class:`cwsl_digi_tpu_torch.sdr.shm.ShmSource` — POSIX shared-memory ring
  mirroring the reference's ``SM_HDR{SampleRate, BlockInSamples, L0}``
  contract (source/SharedMemory.h:10-21);
- socket streaming (:class:`SocketSource`) for networked SDRs.

Every source yields fixed-size complex64 blocks and exposes the metadata the
reference reads from the CWSL header: sample rate, block size, and LO (center)
frequency (source/Receiver.hpp:87-91).
"""

from __future__ import annotations

import socket as _socket
import time
from pathlib import Path
from typing import Optional, Protocol

import numpy as np


class IQSource(Protocol):
    sample_rate: int
    lo_freq: int            # center frequency of the IQ stream, Hz
    block_size: int         # complex samples per block
    live: bool              # True: read_block None means timeout, not EOF

    def read_block(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        """Next block of complex64 IQ, or None on timeout/end."""
        ...

    def close(self) -> None: ...


class ReplaySource:
    """File replay with optional real-time pacing and looping."""

    def __init__(
        self,
        path: str | Path,
        sample_rate: int,
        lo_freq: int,
        block_size: int = 0,
        realtime: bool = False,
        loop: bool = False,
    ) -> None:
        self.sample_rate = int(sample_rate)
        self.lo_freq = int(lo_freq)
        self.block_size = int(block_size) or self.sample_rate // 4
        self.realtime = realtime
        self.loop = loop
        self.live = False       # replay: None from read_block = end of file
        self._data = self._load(Path(path))
        self._pos = 0
        self._t0 = time.monotonic()
        self._emitted = 0

    @staticmethod
    def _load(path: Path) -> np.ndarray:
        suffix = path.suffix.lower()
        if suffix == ".npy":
            data = np.load(path)
            if not np.iscomplexobj(data):
                data = data[..., 0] + 1j * data[..., 1]
            return data.astype(np.complex64)
        if suffix in (".raw", ".iq", ".cf32"):
            flat = np.fromfile(path, dtype=np.float32)
            return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)
        if suffix == ".wav":
            import wave

            with wave.open(str(path), "rb") as w:
                assert w.getnchannels() == 2, "IQ WAV must be 2-channel"
                sw = w.getsampwidth()
                raw = w.readframes(w.getnframes())
            if sw == 2:
                flat = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
            else:
                flat = np.frombuffer(raw, np.float32)
            return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)
        raise ValueError(f"unsupported IQ file: {path}")

    def read_block(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        if self._pos + self.block_size > len(self._data):
            if not self.loop:
                return None
            self._pos = 0
        block = self._data[self._pos : self._pos + self.block_size]
        self._pos += self.block_size
        if self.realtime:
            self._emitted += self.block_size
            due = self._t0 + self._emitted / self.sample_rate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, timeout))
        return block

    def close(self) -> None:
        pass


class SyntheticSource:
    """Band noise with optional embedded signals; for self-test and demos."""

    def __init__(
        self,
        sample_rate: int,
        lo_freq: int,
        block_size: int = 0,
        noise_amplitude: float = 0.01,
        seed: int = 0,
        realtime: bool = False,
    ) -> None:
        self.sample_rate = int(sample_rate)
        self.lo_freq = int(lo_freq)
        self.block_size = int(block_size) or self.sample_rate // 4
        self.noise = noise_amplitude
        # realtime-paced synthetic streams emulate a live SDR: flagging
        # them live turns on UTC alignment + per-window re-anchoring in
        # the Receiver, so soak latency is measured against true wall
        # cadence (not a stream clock offset by the startup delay)
        self.live = bool(realtime)
        self._rng = np.random.default_rng(seed)
        self.realtime = realtime
        self._signals: list[tuple[int, np.ndarray]] = []  # (abs start sample, iq)
        self._utc_signals: list[tuple[float, np.ndarray]] = []
        self._pos = 0
        # pacing clock starts at the FIRST read, not construction: a real
        # SDR has no backlog before streaming starts, and construction-time
        # anchoring let the stream run ahead of wall clock by the
        # open->init gap (receiver compile), which made soak latencies
        # negative (stream-time windows closed before their UTC stamps)
        self._t0: float | None = None

    def inject(self, start_sample: int, iq: np.ndarray) -> None:
        """Schedule a complex burst at an absolute sample offset."""
        self._signals.append((int(start_sample), np.asarray(iq, np.complex64)))

    def inject_at_utc(self, utc_s: float, iq: np.ndarray) -> None:
        """Schedule a burst at an absolute UTC time (realtime sources).

        Resolved lazily at the first read: sample position =
        (utc_s - utc_of_first_sample) * fs.  This is the only alignment a
        UTC-anchored consumer (Receiver window framing) can rely on — the
        stream's sample clock starts at an arbitrary wall offset, so
        sample-indexed injections land at an arbitrary phase within the
        capture windows.  Bursts whose UTC already passed are clipped.
        """
        self._utc_signals.append((float(utc_s), np.asarray(iq, np.complex64)))

    def read_block(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        if self._t0 is None:
            self._t0 = time.monotonic()
            utc0 = time.time()
            for u, sig in self._utc_signals:
                start = int(round((u - utc0) * self.sample_rate))
                if start + len(sig) > 0:
                    self._signals.append((start, sig))
            self._utc_signals = []
        n = self.block_size
        block = (
            self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n)
        ).astype(np.complex64) * self.noise
        lo, hi = self._pos, self._pos + n
        for start, sig in self._signals:
            s0, s1 = max(start, lo), min(start + len(sig), hi)
            if s0 < s1:
                block[s0 - lo : s1 - lo] += sig[s0 - start : s1 - start]
        self._pos += n
        if self.realtime:
            due = self._t0 + self._pos / self.sample_rate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(min(delay, timeout))
        return block

    def close(self) -> None:
        pass


class SocketSource:
    """Raw interleaved-float32 IQ over TCP (simple network feeder)."""

    def __init__(self, host: str, port: int, sample_rate: int, lo_freq: int,
                 block_size: int = 0) -> None:
        self.sample_rate = int(sample_rate)
        self.lo_freq = int(lo_freq)
        self.block_size = int(block_size) or self.sample_rate // 4
        self.live = True        # timeouts are not end-of-stream
        self._sock = _socket.create_connection((host, port), timeout=5.0)
        self._buf = b""         # partial block carried across timeouts
        self._eof = False

    def read_block(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        if self._eof:
            return None
        self._sock.settimeout(timeout)
        need = self.block_size * 8
        try:
            while len(self._buf) < need:
                chunk = self._sock.recv(need - len(self._buf))
                if not chunk:
                    self._eof = True
                    self.live = False   # peer closed: None now means EOF
                    return None
                self._buf += chunk
        except TimeoutError:
            # keep the partial block; the stream stays byte-aligned
            return None
        flat = np.frombuffer(self._buf[:need], np.float32)
        self._buf = self._buf[need:]
        return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)

    def close(self) -> None:
        self._sock.close()


def open_source(spec: str, sample_rate: int = 0, lo_freq: int = 0,
                block_size: int = 0) -> IQSource:
    """Open a source from a spec string.

    ``file:/path/x.npy?sr=192000&lo=14000000`` | ``shm:NAME`` |
    ``tcp:host:port?sr=...&lo=...`` | ``synthetic:?sr=...&lo=...`` —
    the config-level analogue of the reference's shared-memory discovery
    (source/CWSL_Utils.hpp:27-53).  ``sr``/``lo``/``block`` query params
    override the keyword arguments; shm carries its own metadata.
    """
    spec, _, query = spec.partition("?")
    loop = realtime = False
    if query:
        for kv in query.split("&"):
            k, _, v = kv.partition("=")
            if k == "sr":
                sample_rate = int(v)
            elif k == "lo":
                lo_freq = int(v)
            elif k == "block":
                block_size = int(v)
            elif k == "loop":
                loop = v not in ("0", "false", "")
            elif k == "rt":
                realtime = v not in ("0", "false", "")
    kind, _, rest = spec.partition(":")
    if kind == "file":
        return ReplaySource(rest, sample_rate, lo_freq, block_size,
                            realtime=realtime, loop=loop)
    if kind == "shm":
        # prefer the native C++ reader (reference's ingest is native too);
        # fall back to the pure-Python reader — identical wire layout
        try:
            from cwsl_digi_tpu_torch.native import NativeShmSource

            return NativeShmSource(rest)
        except Exception:
            from cwsl_digi_tpu_torch.sdr.shm import ShmSource

            return ShmSource(rest)
    if kind == "tcp":
        host, _, port = rest.rpartition(":")
        return SocketSource(host, int(port), sample_rate, lo_freq, block_size)
    if kind == "synthetic":
        return SyntheticSource(sample_rate, lo_freq, block_size,
                               realtime=realtime)
    raise ValueError(f"unknown source spec: {spec}")
