"""Receiver: one IQ source -> ingest ring -> batched channelizer -> jobs.

Counterpart of ``cwsl_digi_tpu/runtime/receiver.py`` (see its docstring for
the stream-time framing and live re-anchoring rules, kept here as they
are).  An ingest thread fills a ~3 s block ring; the channelize thread
drains it in fixed 0.25 s chunks through :class:`BatchChannelizer` on the
receiver's device and frames per-mode capture windows in device buffers
``[C_mode, N_mode + 2*G]`` (G = audio samples per chunk).  Each framed
window is pushed to the pool as a tensor on the device.

PyTorch tensors are mutable where JAX arrays are not: the framing buffer
is written in place, so every pushed window is a clone (the pool's worker
decodes it while the next chunks are framed), and the rotate that moves a
window's tail to the front copies through a temporary.  All work is issued
on the device's default stream, which orders the clone before any decode
of it in a worker thread.
"""

from __future__ import annotations

import collections
import enum
import threading
import time
from typing import Callable

import numpy as np
import torch

from cwsl_digi_tpu_torch.config import DecoderLine
from cwsl_digi_tpu_torch.constants import WAVE_SR, Mode, get_rx_period
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu_torch.runtime.decoderpool import DecodeJob, DecoderPool
from cwsl_digi_tpu_torch.sdr.source import IQSource


class Status(enum.Enum):
    """Reference: source/Receiver.hpp:45-50."""

    NOT_INITIALIZED = "Uninitialized"
    RUNNING = "Running"
    STOPPED = "Stopped"
    FINISHED = "Finished"


_EOF = object()   # end-of-stream sentinel between ingest and channelize


# --- device window framing ---------------------------------------------------
# The reference's dynamic_slice/dynamic_update_slice clamp their start so
# the slice fits; the framers clamp the same way.

def _framer_write(buf: torch.Tensor, chunk: torch.Tensor, rows: torch.Tensor,
                  w: int, off: int) -> None:
    """Write chunk[rows, off:] at buf[:, w:] in place; the zero tail past
    the valid samples is overwritten by the next chunk."""
    g = chunk.shape[1]
    w = max(0, min(w, buf.shape[1] - g))
    sel = chunk.index_select(0, rows)
    off = max(0, min(off, g))
    buf[:, w : w + g - off] = sel[:, off:]
    buf[:, w + g - off : w + g] = 0.0


def _framer_rotate(buf: torch.Tensor, start: int, g2: int) -> None:
    """Move buf[:, start:start+g2] to the front (leftover + carry)."""
    start = max(0, min(start, buf.shape[1] - g2))
    buf[:, :g2] = buf[:, start : start + g2].clone()


def _framer_zero_tail(buf: torch.Tensor, w: int) -> torch.Tensor:
    """A copy of buf with everything at/after the write cursor zeroed."""
    out = buf.clone()
    out[:, max(0, w):] = 0.0
    return out


class _IngestRing:
    """Bounded block ring between the ingest and channelize threads
    (copied from the reference, whose module imports JAX): ~3 s deep,
    ``push`` blocks when full, each push stamped with the ingest wall
    clock for the re-anchoring estimator."""

    def __init__(self, n_blocks: int) -> None:
        self.n_blocks = max(2, n_blocks)
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._samples = 0           # IQ samples ever pushed
        self._wall = None           # wall stamp of the newest push

    def push(self, block, wall: float, timeout: float = 1.0) -> bool:
        with self._cv:
            if len(self._dq) >= self.n_blocks:
                self._cv.wait_for(lambda: len(self._dq) < self.n_blocks,
                                  timeout)
                if len(self._dq) >= self.n_blocks:
                    return False
            self._dq.append(block)
            if block is not _EOF:
                self._samples += len(block)
                self._wall = wall
            self._cv.notify_all()
            return True

    def full(self) -> bool:
        with self._cv:
            return len(self._dq) >= self.n_blocks

    def pop(self, timeout: float = 1.0):
        with self._cv:
            if not self._dq:
                self._cv.wait_for(lambda: bool(self._dq), timeout)
                if not self._dq:
                    return None
            item = self._dq.popleft()
            self._cv.notify_all()
            return item

    def stamp(self) -> tuple[int, float] | None:
        """(IQ samples ingested, wall clock at the newest arrival)."""
        with self._cv:
            if self._wall is None:
                return None
            return self._samples, self._wall


class Receiver:
    """One capture source and every decoder line tuned within it."""

    # fixed channelize chunk (s), rounded to the channelizer's sub-block
    CHANNELIZE_CHUNK_S = 0.25
    # re-anchoring: correct only past this misalignment (s)
    REANCHOR_THRESH_S = 0.02

    def __init__(
        self,
        source: IQSource,
        lines: list[DecoderLine],
        pool: DecoderPool,
        utc_anchor: float = 0.0,
        log: Callable[[str], None] | None = None,
        decoder_index_base: int = 0,
        line_indices: list[int] | None = None,
        align_live: bool = False,
        channelizer: str = "xla",
        wall_fn: Callable[[], float] | None = None,
        ring_seconds: float = 3.0,
        device: torch.device | str | None = None,
    ) -> None:
        self.source = source
        self.lines = list(lines)
        self.pool = pool
        self.log = log or (lambda s: None)
        self.utc_anchor = utc_anchor
        self.align_live = align_live
        self.device = as_device(device)
        self._drop_remaining = 0
        self._dropped_iq = 0        # IQ discarded by the align-to-anchor drop
        self.status = Status.NOT_INITIALIZED
        self._terminate = threading.Event()
        self._thread: threading.Thread | None = None
        self._ingest_thread: threading.Thread | None = None
        self._wall = wall_fn or time.time
        blk = max(1, getattr(source, "block_size", 0) or
                  source.sample_rate // 4)
        self._ring = _IngestRing(int(ring_seconds * source.sample_rate
                                     / blk) + 1)
        self._pump = None           # native shm->ring pump when applicable
        self._full_arrivals = 0     # source blocks that found the ring full
        self.line_indices = line_indices or [
            decoder_index_base + i for i in range(len(lines))
        ]

        fs = source.sample_rate
        lo = source.lo_freq
        freqs = [line.calibrated_freq - lo for line in lines]
        for line, f in zip(lines, freqs):
            if abs(f) > fs / 2:
                raise ValueError(
                    f"decoder {line.freq} {line.mode.value} outside source band")
        # ``[tpu] channelizer``: the reference accepts only "xla", and so
        # does the port, whose one channelizer is the CUDA kernel (the
        # plain version on CPU tensors); the error is the reference's own
        if channelizer != "xla":
            raise ValueError(
                f"unknown channelizer backend {channelizer!r} (only 'xla'; "
                "the pallas kernel lost the bench-off and was demoted)")
        self.chan = BatchChannelizer(fs, freqs, device=self.device)
        self._sub_gran = self.chan._sub

        self._mode_rows: dict[Mode, list[int]] = {}
        for i, line in enumerate(lines):
            self._mode_rows.setdefault(line.mode, []).append(i)
        self._g_iq = max(self._sub_gran,
                         int(round(self.CHANNELIZE_CHUNK_S * fs
                                   / self._sub_gran)) * self._sub_gran)
        self._g_a = self._g_iq // self.chan.spec.decimation
        self._dev_buf: dict[Mode, torch.Tensor] = {}
        self._rows_dev: dict[Mode, torch.Tensor] = {}
        self._win_len: dict[Mode, int] = {}
        self._written: dict[Mode, int] = {}
        self._window_index: dict[Mode, int] = {}
        self._skip: dict[Mode, int] = {}
        self._epoch0: dict[Mode, float] = {}
        for mode, rows in self._mode_rows.items():
            n = int(round(get_rx_period(mode) * WAVE_SR))
            self._win_len[mode] = n
            self._dev_buf[mode] = torch.zeros(
                (len(rows), n + 2 * self._g_a), dtype=torch.float32,
                device=self.device)
            self._rows_dev[mode] = torch.as_tensor(rows, device=self.device)
            self._written[mode] = 0
            self._window_index[mode] = 0
        self.set_anchor(utc_anchor)
        self._stage_iq: list[np.ndarray] = []   # blocks awaiting a chunk
        self._stage_n = 0
        self._dec_ratio = source.sample_rate / WAVE_SR
        self._audio_pos = 0     # audio samples fed to framing so far
        self.stage = {
            "channelize_wall_s": 0.0,     # total wall in chan.process
            "channelized_audio_s": 0.0,   # audio seconds produced
            "emit_lag": collections.deque(maxlen=4096),  # close lag [s]
        }

    # -- reference API ------------------------------------------------------

    def warm(self) -> None:
        """Run one zero chunk through the channelizer and every framer
        before the stream starts (first-use kernel build, allocator),
        restoring the channelizer state afterwards."""
        saved = self.chan.state
        try:
            audio = self.chan.process(np.zeros(self._g_iq, np.complex64))
            for mode in self._mode_rows:
                buf = self._dev_buf[mode].clone()
                _framer_write(buf, audio, self._rows_dev[mode], 0, 0)
                _framer_rotate(buf, self._win_len[mode], 2 * self._g_a)
                _framer_zero_tail(buf, 0)
            audio[0, :1].cpu()            # wait for the device
        finally:
            self.chan.state = saved

    def set_anchor(self, utc_anchor: float) -> None:
        """(Re-)anchor window framing at a UTC instant: each mode's windows
        start on its own period boundary at/after the anchor."""
        self.utc_anchor = utc_anchor
        for mode in self._mode_rows:
            trp = get_rx_period(mode)
            k = int(np.ceil((utc_anchor - 1e-6) / trp))
            boundary = max(k, 0) * trp
            self._epoch0[mode] = boundary
            self._skip[mode] = int(round((boundary - utc_anchor) * WAVE_SR))
            self._window_index[mode] = 0

    def init(self) -> None:
        self.status = Status.RUNNING
        try:
            from cwsl_digi_tpu_torch.native import (NativePump, NativeRing,
                                              NativeShmSource)

            if isinstance(self.source, NativeShmSource):
                nring = NativeRing(self.source.block_size * 8,
                                   self._ring.n_blocks)
                self._native_reader = nring.add_reader()
                self._pump = NativePump(self.source, nring)
                self._native_ring = nring
        except Exception as e:   # no native pump: the Python ring serves
            self.log(f"native intake unavailable ({e!r}); using Python ring")
            self._pump = None
        if self._pump is None:
            self._ingest_thread = threading.Thread(
                target=self._ingest_loop, name="receiver-ingest", daemon=True)
            self._ingest_thread.start()
        self._thread = threading.Thread(target=self._run,
                                        name="receiver-channelize",
                                        daemon=True)
        self._thread.start()

    def terminate(self) -> None:
        self._terminate.set()
        if self._pump is not None:
            self._pump.stop()
            self._pump = None
        if self._ingest_thread is not None:
            self._ingest_thread.join(timeout=3.0)
            self._ingest_thread = None
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            self._thread = None
        if self.status == Status.RUNNING:
            self.status = Status.STOPPED

    def get_status(self) -> Status:
        return self.status

    @property
    def overruns(self) -> int:
        """Source blocks lost to ring overrun (0 in healthy operation); for
        a live source read through the Python ring, the blocks that found
        it full: the channelizer was a ring (~3 s) behind the stream, and a
        live SDR's own buffer would lose them, as the native pump does."""
        n = int(getattr(self.source, "overruns", 0))
        if self._pump is not None:
            n += self._pump.dropped
        elif getattr(self.source, "live", False):
            n += self._full_arrivals
        return n

    # -- processing ---------------------------------------------------------

    def _ingest_loop(self) -> None:
        """Source -> ring; never blocks on the device."""
        from cwsl_digi_tpu_torch.utils import qos

        qos.set_current_thread_nice(qos.INGEST)
        try:
            while not self._terminate.is_set():
                block = self.source.read_block(timeout=1.0)
                if block is None:
                    if getattr(self.source, "live", False):
                        continue
                    break
                wall = self._wall()
                if self._ring.full():
                    self._full_arrivals += 1
                while not self._terminate.is_set():
                    if self._ring.push(block, wall, timeout=0.5):
                        break
        except Exception as e:
            self.log(f"### receiver ingest error: {e!r}")
        while not self._terminate.is_set():
            if self._ring.push(_EOF, 0.0, timeout=0.5):
                break

    def _next_block(self):
        if self._pump is not None:
            blk = self._native_ring.pop(self._native_reader, timeout=1.0)
            if blk is None and not getattr(self.source, "live", False):
                return _EOF
            return blk
        return self._ring.pop(timeout=1.0)

    def _ingest_stamp(self) -> tuple[int, float] | None:
        if self._pump is not None:
            n = self._native_ring.write_count * self.source.block_size
            return (n, self._wall()) if n else None
        return self._ring.stamp()

    def _run(self) -> None:
        if self.align_live:
            delay = self.utc_anchor - self._wall()
            if delay > 0:
                self._drop_remaining = int(delay * self.source.sample_rate)
        try:
            eof = False
            while not self._terminate.is_set() and not eof:
                block = self._next_block()
                if block is None:
                    continue
                if block is _EOF:
                    eof = True
                    continue
                if self._drop_remaining > 0:
                    n = min(self._drop_remaining, len(block))
                    self._drop_remaining -= n
                    self._dropped_iq += n
                    block = block[n:]
                if len(block):
                    self.process_iq(block)
            if eof:
                self.status = Status.FINISHED
                self._flush_stream()
                self._flush_partials()
        except Exception as e:
            self.log(f"### receiver error: {e!r}")
            self.status = Status.STOPPED

    def process_iq(self, block: np.ndarray) -> None:
        """Feed one IQ block (any length); channelize in fixed chunks."""
        self._stage_iq.append(np.asarray(block, np.complex64))
        self._stage_n += len(block)
        while self._stage_n >= self._g_iq:
            iq = (np.concatenate(self._stage_iq) if len(self._stage_iq) > 1
                  else self._stage_iq[0])
            rest = iq[self._g_iq:]
            self._stage_iq = [rest] if len(rest) else []
            self._stage_n = len(rest)
            self._process_chunk(iq[: self._g_iq])

    def _flush_stream(self) -> None:
        """End-of-stream: pad the staged remainder to one chunk."""
        if self._stage_n == 0:
            return
        iq = np.concatenate(self._stage_iq) if len(self._stage_iq) > 1 \
            else self._stage_iq[0]
        self._stage_iq = []
        n_valid_audio = self._stage_n // self.chan.spec.decimation
        self._stage_n = 0
        pad = self._g_iq - len(iq)
        if pad > 0:
            iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
        self._process_chunk(iq, valid_audio=n_valid_audio)

    def _process_chunk(self, iq_fixed: np.ndarray,
                       valid_audio: int | None = None) -> None:
        t0 = time.monotonic()
        audio = self.chan.process(iq_fixed)       # [C, G_a] on the device
        self.stage["channelize_wall_s"] += time.monotonic() - t0
        self.stage["channelized_audio_s"] += audio.shape[1] / WAVE_SR
        self._accumulate(audio, valid=valid_audio)

    def _accumulate(self, audio, valid: int | None = None) -> None:
        """Frame one channelized [C, G_a] chunk into the per-mode buffers.
        Host arrays of any length (tests) are cut into zero-padded G_a
        pieces whose padding is never counted as written."""
        if not isinstance(audio, torch.Tensor) or audio.shape[1] != self._g_a:
            a = np.asarray(audio, np.float32)
            for pos in range(0, a.shape[1], self._g_a):
                piece = a[:, pos : pos + self._g_a]
                v = piece.shape[1]
                if v < self._g_a:
                    piece = np.pad(piece, ((0, 0), (0, self._g_a - v)))
                self._accumulate(torch.from_numpy(piece).to(self.device),
                                 valid=v)
            return
        v = self._g_a if valid is None else valid
        if v == 0:
            return
        chunk_start = self._audio_pos
        self._audio_pos += v
        for mode in self._mode_rows:
            if self._skip[mode] >= v:
                self._skip[mode] -= v
                continue
            off = self._skip[mode]
            self._skip[mode] = 0
            w = self._written[mode]
            buf = self._dev_buf[mode]
            _framer_write(buf, audio, self._rows_dev[mode], w, off)
            w += v - off
            n_m = self._win_len[mode]
            while w >= n_m:
                leftover = w - n_m
                end_abs = chunk_start + v - leftover
                # the buffer is rewritten in place next: push a copy
                carry = self._emit(mode, buf[:, :n_m].clone(), end_abs)
                _framer_rotate(buf, n_m - carry, 2 * self._g_a)
                w = leftover + carry
            self._written[mode] = w

    def _reanchor_samples(self, mode: Mode, end_pos: int) -> int:
        """Window-boundary correction in audio samples (+carry / -skip),
        from the ingest thread's (samples, wall) stamps; live sources only.
        The align-to-anchor drop is subtracted from the stamp's count."""
        if not getattr(self.source, "live", False):
            return 0
        stamp = self._ingest_stamp()
        if stamp is None:
            return 0
        iq_in, wall = stamp
        iq_in -= self._dropped_iq
        audio_in = iq_in / self._dec_ratio
        if audio_in < end_pos:
            return 0
        wall_at_end = wall - (audio_in - end_pos) / WAVE_SR
        trp = get_rx_period(mode)
        nominal_end = self._epoch0[mode] + self._window_index[mode] * trp
        mis = wall_at_end - nominal_end
        if abs(mis) < self.REANCHOR_THRESH_S:
            return 0
        max_corr = int(trp * WAVE_SR) // 8
        n = int(round(mis * WAVE_SR))
        n = max(-max_corr, min(max_corr, n))
        self.log(f"re-anchor {mode.value}: stream {'late' if n > 0 else 'early'}"
                 f" {abs(mis):.3f}s, {'carrying' if n > 0 else 'skipping'}"
                 f" {abs(n)} samples")
        return n

    def _emit(self, mode: Mode, window: torch.Tensor,
              end_pos: int | None = None) -> int:
        """Push one framed device window to the pool; returns the carry
        (tail samples the next window reuses when the stream runs slow)."""
        rows = self._mode_rows[mode]
        k = self._window_index[mode]
        trp = get_rx_period(mode)
        job = DecodeJob(
            mode=mode,
            audio=window,
            base_freqs=[self.lines[i].freq for i in rows],
            decoder_indices=[self.line_indices[i] for i in rows],
            epoch_time=self._epoch0[mode] + k * trp,
            wspr_callsigns=[self.lines[i].wspr_call for i in rows],
        )
        self.pool.push(job)
        if getattr(self.source, "live", False):
            self.stage["emit_lag"].append(
                round(self._wall() - (job.epoch_time + trp), 3))
        self._window_index[mode] = k + 1
        if end_pos is None:
            return 0
        n = self._reanchor_samples(mode, end_pos)
        if n < 0:
            self._skip[mode] += -n
            return 0
        return min(n, self._g_a)

    def _flush_partials(self) -> None:
        """On end-of-stream, emit any window at least half filled."""
        for mode in self._mode_rows:
            n_m = self._win_len[mode]
            if self._written[mode] >= n_m // 2:
                buf = _framer_zero_tail(self._dev_buf[mode],
                                        self._written[mode])
                self._written[mode] = 0
                self._emit(mode, buf[:, :n_m])
