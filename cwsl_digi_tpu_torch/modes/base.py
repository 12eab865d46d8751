"""Mode decoder protocol and registry of the port (counterpart of
``cwsl_digi_tpu/modes/base.py``).

``DecodeResult`` and the ``ModeDecoder`` protocol are copied from the
reference as they are.  Every mode of the reference is ported: FT8, FT4,
JS8, FST4 and FST4W at every period, WSPR, JT65 and Q65-30.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Protocol

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, is_mode_fst4, is_mode_fst4w
from cwsl_digi_tpu_torch.device import as_device


@dataclasses.dataclass
class DecodeResult:
    """One decoded signal in one capture window.

    Mirrors the information the reference parses out of jt9 stdout lines
    (source/OutputHandler.cpp:505-621): SNR, dt, audio frequency, message.
    """

    message: str
    snr_db: float
    dt_s: float
    freq_hz: float        # audio frequency within the channel passband
    score: float = 0.0    # sync/decoder confidence metric
    mode: Mode = Mode.FT8
    payload_bits: np.ndarray | None = None
    drift_hz: float = 0.0  # linear drift over the burst (WSPR/FST4W)


class ModeDecoder(Protocol):
    mode: Mode

    def decode(self, audio: np.ndarray) -> list[list[DecodeResult]]:
        """audio: [batch, n_samples] at 12 kHz -> per-window decode lists."""
        ...


class DecoderRegistry:
    """Lazily constructed decoders on one device, cached by mode and
    construction kwargs (differently configured decoders coexist)."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.device = as_device(device)
        self._cache: dict[tuple, ModeDecoder] = {}
        self._lock = threading.Lock()

    def get(self, mode: Mode | str, **kwargs) -> ModeDecoder:
        mode = Mode(mode)
        key = (mode,) + tuple(sorted(kwargs.items()))
        with self._lock:
            if key not in self._cache:
                self._cache[key] = _construct(mode, self.device, **kwargs)
            return self._cache[key]


class DeviceLock:
    """One decode at a time on one device.

    A decode is a long sequence of small launches and a few host syncs.
    Threads that issue such sequences at once on one device share one
    interpreter lock and one stream, and slow each other more than they
    overlap (four pool workers took 16x as long a batch as one).  So every
    decoder's public entry holds its device's lock; the lock is reentrant,
    since one entry may call another (WSPR's ``decode`` calls
    ``decode_arrays``).  ``wait_s`` is the time callers spent waiting for
    it, all threads together; :meth:`thread_wait_s` that of the calling
    thread.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._local = threading.local()
        self.wait_s = 0.0

    def thread_wait_s(self) -> float:
        return getattr(self._local, "wait_s", 0.0)

    def __enter__(self) -> "DeviceLock":
        t0 = time.monotonic()
        self._lock.acquire()
        waited = time.monotonic() - t0
        self.wait_s += waited          # under the lock: no lost update
        self._local.wait_s = self.thread_wait_s() + waited
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()


# one lock per device of the process: a device is shared by every decoder
# on it, whoever built them
_DEVICE_LOCKS: dict[torch.device, DeviceLock] = {}
_DEVICE_LOCKS_LOCK = threading.Lock()


def device_lock(device: torch.device | str) -> DeviceLock:
    """The lock of ``device`` (equal devices, one lock; ``cuda`` means the
    current CUDA device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _DEVICE_LOCKS_LOCK:
        return _DEVICE_LOCKS.setdefault(device, DeviceLock())


def on_device_lock(method):
    """Run a decoder method under the lock of the decoder's ``device``."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with device_lock(self.device):
            return method(self, *args, **kwargs)
    return locked


def window_batch(audio, device: torch.device) -> torch.Tensor:
    """Capture windows as a float32 [n, N] tensor on ``device``: host audio
    is copied there as it is (no rescaling); a tensor must already be on
    ``device``."""
    if isinstance(audio, torch.Tensor):
        if audio.device != device:
            raise ValueError(f"audio on {audio.device}, decoder on {device}")
        audio = audio.to(torch.float32)
    else:
        audio = torch.from_numpy(
            np.ascontiguousarray(audio, np.float32)).to(device)
    return audio[None, :] if audio.ndim == 1 else audio


_REGISTERED: dict[Mode, ModeDecoder] = {}


def register_decoder(mode: Mode, decoder: ModeDecoder) -> None:
    """Make ``decoder`` what ``get_decoder(mode)`` returns when it is given
    no other argument."""
    _REGISTERED[Mode(mode)] = decoder


def get_decoder(mode: Mode | str, device: torch.device | str | None = None,
                **kwargs) -> ModeDecoder:
    """The registered decoder for ``mode`` when no other argument is given,
    else a new decoder for ``mode`` on ``device`` (default: the card)."""
    mode = Mode(mode)
    if device is None and not kwargs and mode in _REGISTERED:
        return _REGISTERED[mode]
    return _construct(mode, as_device(device), **kwargs)


def warmup_window(mode: Mode | str) -> np.ndarray:
    """One capture window holding a strong protocol-exact signal: decoding
    it runs every pass, the subtraction and OSD once."""
    mode = Mode(mode)
    text = "K1ABC W9XYZ EN37"
    if mode == Mode.FT8:
        from cwsl_digi_tpu_torch.modes import ft8

        return ft8.synthesize(text)
    if mode == Mode.FT4:
        from cwsl_digi_tpu_torch.modes import ft4

        return ft4.synthesize(text)
    if mode == Mode.JS8:
        from cwsl_digi_tpu_torch.modes import js8

        return js8.synthesize("HELLO WORLD")
    if mode == Mode.JT65:
        from cwsl_digi_tpu_torch.modes import jt65

        return jt65.synthesize(text)
    if mode == Mode.Q65_30:
        from cwsl_digi_tpu_torch.modes import q65

        return q65.synthesize(text)
    if mode == Mode.WSPR:
        from cwsl_digi_tpu_torch.modes import wspr

        return wspr.synthesize("K1ABC", "FN42", 37)
    if is_mode_fst4(mode) or is_mode_fst4w(mode):
        from cwsl_digi_tpu_torch.modes import fst4

        return fst4.synthesize(
            "K1ABC FN42 30" if is_mode_fst4w(mode) else text, mode)
    raise NotImplementedError(f"no warmup signal for {mode}")


def _construct(mode: Mode, device: torch.device, **kwargs) -> ModeDecoder:
    if mode == Mode.FT8:
        from cwsl_digi_tpu_torch.modes.ft8 import FT8Decoder

        return FT8Decoder(device=device, **kwargs)
    if mode == Mode.FT4:
        from cwsl_digi_tpu_torch.modes.ft4 import FT4Decoder

        return FT4Decoder(device=device, **kwargs)
    if mode == Mode.JS8:
        from cwsl_digi_tpu_torch.modes.js8 import JS8Decoder

        return JS8Decoder(device=device, **kwargs)
    if mode == Mode.WSPR:
        from cwsl_digi_tpu_torch.modes.wspr import WSPRDecoder

        return WSPRDecoder(device=device, **kwargs)
    if mode == Mode.JT65:
        from cwsl_digi_tpu_torch.modes.jt65 import JT65Decoder

        return JT65Decoder(device=device, **kwargs)
    if mode == Mode.Q65_30:
        from cwsl_digi_tpu_torch.modes.q65 import Q65Decoder

        return Q65Decoder(device=device, **kwargs)
    if is_mode_fst4(mode) or is_mode_fst4w(mode):
        from cwsl_digi_tpu_torch.modes.fst4 import FST4Decoder

        return FST4Decoder(mode, device=device, **kwargs)
    raise NotImplementedError(f"no decoder for {mode}")
