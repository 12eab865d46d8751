"""Continuous-phase (G)FSK tone synthesis.

Used for test-fixture generation (the reference's `keepwav` analogue,
SURVEY.md §4), SNR-calibrated recall benchmarks, and multi-pass signal
subtraction.  Host-side NumPy float64 for exactness; the subtraction path
re-synthesizes on device from the same tone tables.
"""

from __future__ import annotations

import numpy as np


def gaussian_frequency_pulse(sps: int, bt: float) -> np.ndarray:
    """Gaussian-smoothed rectangular frequency pulse spanning 3 symbols."""
    k = np.arange(3 * sps, dtype=np.float64)
    t = (k - 1.5 * sps + 0.5) / sps
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    from math import erf as _erf
    erf = np.vectorize(_erf)
    pulse = 0.5 * (
        erf((t + 0.5) / (sigma * np.sqrt(2.0)))
        - erf((t - 0.5) / (sigma * np.sqrt(2.0)))
    )
    return pulse


def gfsk_modulate(
    tones: np.ndarray,
    f0_hz: float,
    sps: int,
    sample_rate: int,
    tone_spacing_hz: float,
    bt: float = 2.0,
    ramp_symbols: float = 0.125,
) -> np.ndarray:
    """Synthesize a real GFSK burst.

    tones: integer tone indices per symbol.  Returns ``len(tones)*sps`` real
    samples with raised-cosine amplitude ramps at both ends.
    """
    tones = np.asarray(tones, dtype=np.float64)
    n_sym = len(tones)
    n = n_sym * sps

    # instantaneous frequency: sum of per-symbol Gaussian pulses.  Virtual
    # symbols repeating the edge tones are added before/after so the pulse
    # tails at the burst edges hold the edge tone steady.
    pulse = gaussian_frequency_pulse(sps, bt)
    dphi = np.zeros(n + 2 * sps)
    hmod = tone_spacing_hz / sample_rate  # cycles/sample per tone step
    for i, tone in enumerate(tones):
        dphi[i * sps : i * sps + 3 * sps] += 2.0 * np.pi * hmod * tone * pulse
    dphi[: 2 * sps] += 2.0 * np.pi * hmod * tones[0] * pulse[sps:]
    dphi[-2 * sps :] += 2.0 * np.pi * hmod * tones[-1] * pulse[: 2 * sps]
    dphi = dphi[sps : sps + n]
    dphi += 2.0 * np.pi * f0_hz / sample_rate

    phase = np.cumsum(dphi) - dphi[0]
    sig = np.sin(phase)  # audio-band real signal

    # amplitude ramps (keeps spectra clean like the protocol waveform)
    n_ramp = max(1, int(ramp_symbols * sps))
    ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(n_ramp) / n_ramp))
    sig[:n_ramp] *= ramp
    sig[-n_ramp:] *= ramp[::-1]
    return sig


def gfsk_modulate_iq(
    tones: np.ndarray,
    f0_hz: float,
    sps: int,
    sample_rate: int,
    tone_spacing_hz: float,
    bt: float = 2.0,
) -> np.ndarray:
    """Complex (analytic) GFSK burst — for IQ-domain synthesis/subtraction.

    Same instantaneous-frequency trajectory as :func:`gfsk_modulate` but
    returns ``exp(j*phase)`` so it can be placed anywhere in a wideband IQ
    stream (f0 may be negative).
    """
    tones = np.asarray(tones, dtype=np.float64)
    n = len(tones) * sps
    pulse = gaussian_frequency_pulse(sps, bt)
    dphi = np.zeros(n + 2 * sps)
    hmod = tone_spacing_hz / sample_rate
    for i, tone in enumerate(tones):
        dphi[i * sps : i * sps + 3 * sps] += 2.0 * np.pi * hmod * tone * pulse
    dphi[: 2 * sps] += 2.0 * np.pi * hmod * tones[0] * pulse[sps:]
    dphi[-2 * sps :] += 2.0 * np.pi * hmod * tones[-1] * pulse[: 2 * sps]
    dphi = dphi[sps : sps + n] + 2.0 * np.pi * f0_hz / sample_rate
    phase = np.cumsum(dphi) - dphi[0]
    return np.exp(1j * phase)


def place_burst(
    burst: np.ndarray,
    window_len: int,
    start_s: float,
    amplitude: float = 1.0,
    sample_rate: int = 12_000,
) -> np.ndarray:
    """Place a modulated burst into a zeroed capture window (shared by every
    mode's ``synthesize``)."""
    out = np.zeros(window_len)
    start = int(round(start_s * sample_rate))
    if start >= window_len or start + len(burst) <= 0:
        return out
    s0 = max(0, start)
    n = min(len(burst) - (s0 - start), window_len - s0)
    out[s0 : s0 + n] = amplitude * burst[s0 - start : s0 - start + n]
    return out


def fsk_modulate(
    tones: np.ndarray,
    f0_hz: float,
    sps: int,
    sample_rate: int,
    tone_spacing_hz: float,
) -> np.ndarray:
    """Plain continuous-phase FSK (no Gaussian smoothing)."""
    tones = np.asarray(tones, dtype=np.float64)
    freqs = f0_hz + tones * tone_spacing_hz
    dphi = 2.0 * np.pi * np.repeat(freqs, sps) / sample_rate
    phase = np.cumsum(dphi) - dphi[0]
    return np.sin(phase)


def add_noise_at_snr(
    signal: np.ndarray,
    snr_db: float,
    sample_rate: int,
    rng: np.random.Generator,
    ref_bandwidth_hz: float = 2500.0,
    total_len: int | None = None,
    start: int = 0,
) -> np.ndarray:
    """Embed a unit-ish signal in white noise at the WSJT-X SNR convention.

    SNR is signal power over noise power in ``ref_bandwidth_hz`` (2.5 kHz),
    the convention all the reference's reported SNRs use.
    """
    if total_len is None:
        total_len = len(signal)
    sig_power = np.mean(signal**2)
    # noise density so that power in ref bandwidth gives requested SNR
    noise_power_ref = sig_power / (10.0 ** (snr_db / 10.0))
    noise_density = noise_power_ref / ref_bandwidth_hz
    noise_power_total = noise_density * (sample_rate / 2.0)
    out = rng.standard_normal(total_len) * np.sqrt(noise_power_total)
    out[start : start + len(signal)] += signal
    return out
