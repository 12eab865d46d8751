"""Windowed-sinc low-pass FIR tap designer (NumPy, float64).

A copy of ``cwsl_digi_tpu/dsp/lowpass.py``: importing that module runs
``cwsl_digi_tpu/dsp/__init__.py``, which imports the JAX channelizer.
Numerical parity with the reference designer (source/LowPass.hpp:16-35):
``order`` taps, tap[0] = 0, tap[order/2] = 1, symmetric; for
1 <= n < order/2::

    x   = (-order/2 + n)
    tap = sin(x*pi*bw)/(x*pi*bw) * (0.54 - 0.46*cos(2*pi*n/order))
"""

from __future__ import annotations

import numpy as np


def build_lowpass(order: int, bandwidth: float) -> np.ndarray:
    """Return ``order`` float64 taps matching BuildLowPass exactly."""
    if order < 2 or order % 2 != 0:
        raise ValueError("order must be an even integer >= 2")
    taps = np.zeros(order, dtype=np.float64)
    taps[order // 2] = 1.0
    n = np.arange(1, order // 2)
    if n.size:
        x = (-order / 2.0 + n) * np.pi * bandwidth
        y = np.sin(x) / x * (0.54 - 0.46 * np.cos(2.0 * np.pi * n / order))
        taps[1 : order // 2] = y
        taps[order - n] = y
    return taps


def build_ssb_filter(fs: int, bw: int, latency_log2: int = 3) -> np.ndarray:
    """The normalized SSBD channelizer filter (source/SSBD.hpp:62-68):
    ``latency*2*Fs/B`` taps at fractional bandwidth ``B/Fs``, unit DC gain."""
    latency = 1 << latency_log2
    if bw == 0 or (fs // bw // 2) * 2 * bw != fs or fs < 4 * bw:
        raise ValueError("Fs/B must be an even integer >= 4")
    filt_order = latency * 2 * fs // bw
    taps = build_lowpass(filt_order, bw / float(fs))
    return taps / np.sum(taps)
