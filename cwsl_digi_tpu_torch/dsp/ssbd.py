"""Reference-parity single-channel SSB demodulator (NumPy, vectorized).

This is the *oracle / compatibility* implementation of the reference's SSBD
(source/SSBD.hpp:42-221): complex NCO mix at ``-(F + sign*B/2)``, normalized
windowed-sinc FIR of ``latency*2*Fs/B`` taps, decimation by ``Fs/(2B)``, and
the output selection ``+Re, -Im*sign, -Re, +Im*sign`` — which equals
up-conversion by B/2 at the output rate followed by taking the real part.

The production path is the batched device implementation in
``channelizer.py``; both are tested against each other.

Derivation of the closed form implemented here (from the reference's
workspace recurrence at SSBD.hpp:159-183): with BlockSize = Fs/(2B),
NumWS = FiltOrder/BlockSize, output sample t is

    y[t] = sum_{j=0}^{FiltOrder-1} filter[j] * mixed[(t+1-NumWS)*BlockSize + j]

with ``mixed[u] = x[u] * exp(-j*2*pi*(F+sign*B/2)*u/Fs)`` and zero padding for
negative input indices, then ``audio[t] = Re(y[t] * exp(+j*sign*pi*t/2))``.
"""

from __future__ import annotations

import numpy as np

from cwsl_digi_tpu_torch.dsp.lowpass import build_ssb_filter


class SSBD:
    """Streaming single-channel SSB demodulator with reference semantics."""

    def __init__(
        self,
        fs: int,
        bw: int,
        freq: float = 0.0,
        is_usb: bool = True,
        latency_log2: int = 3,
    ) -> None:
        if bw == 0 or (fs // bw // 2) * 2 * bw != fs or fs < 4 * bw:
            raise ValueError("Fs/B must be an even integer >= 4")
        if not (1 <= latency_log2 <= 16):
            raise ValueError("log2(latency) must be in [1, 16]")
        self.fs = fs
        self.bw = bw
        self.latency = 1 << latency_log2
        self.block_size = fs // bw // 2
        self.filter = build_ssb_filter(fs, bw, latency_log2)
        self.filt_order = len(self.filter)
        self.num_ws = self.filt_order // self.block_size
        self.tune(freq, is_usb)

    # -- reference API ------------------------------------------------------

    def tune(self, freq: float, is_usb: bool, reset: bool = True) -> None:
        """Reference: SSBD::Tune (source/SSBD.hpp:97-123)."""
        if abs(freq) > self.fs / 2:
            raise ValueError("Signal outside of band (low)")
        sign = 1.0 if is_usb else -1.0
        if abs(freq + self.bw * sign) > self.fs / 2:
            raise ValueError("Signal outside of band (high)")
        self.fc = freq
        self.is_usb = is_usb
        self.sign = sign
        self.phase_delta = -2.0 * np.pi * (freq + sign * self.bw / 2.0) / self.fs
        if reset:
            self.reset()

    def reset(self) -> None:
        """Zero filter history and NCO phase — the reference resets per
        capture window by reconstructing SSBD (source/Instance.cpp:251)."""
        # History = the (FiltOrder - BlockSize) input samples preceding the
        # next block, already mixed to baseband.
        self._history = np.zeros(self.filt_order - self.block_size, np.complex128)
        self._in_count = 0   # absolute input sample counter (for NCO phase)
        self._out_count = 0  # absolute output sample counter (for B/2 shift)

    @property
    def in_rate(self) -> int:
        return self.fs

    @property
    def out_rate(self) -> int:
        return 2 * self.bw

    @property
    def in_size(self) -> int:
        """Input complex samples per Iterate (reference: GetInSize)."""
        return 2 * self.fs // self.bw

    @property
    def delay(self) -> int:
        """Group delay at the output rate (reference: GetDelay)."""
        return self.latency

    # -- processing ---------------------------------------------------------

    def process(self, iq: np.ndarray) -> np.ndarray:
        """Consume complex IQ (length a multiple of BlockSize) and return
        real audio at 2*B. Equivalent to repeated reference Iterate calls."""
        iq = np.asarray(iq, dtype=np.complex128)
        bs = self.block_size
        if len(iq) % bs != 0:
            raise ValueError(f"input length must be a multiple of {bs}")
        n = len(iq)
        # NCO mix with absolute-phase continuity.
        u = self._in_count + np.arange(n)
        mixed = iq * np.exp(1j * self.phase_delta * u)
        self._in_count += n

        # FIR + decimate via sliding windows over [history, mixed].
        buf = np.concatenate([self._history, mixed])
        n_out = n // bs
        # windows[t] = buf[t*bs : t*bs + filt_order]
        idx = np.arange(self.filt_order)[None, :] + (np.arange(n_out) * bs)[:, None]
        y = buf[idx] @ self.filter
        self._history = buf[n:]

        # Output selection: Re(y * exp(+j*sign*pi*t/2))
        t = self._out_count + np.arange(n_out)
        self._out_count += n_out
        rot = np.exp(1j * self.sign * np.pi / 2.0 * t)
        return np.real(y * rot)
