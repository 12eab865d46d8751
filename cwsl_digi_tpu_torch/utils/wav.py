"""16-bit PCM mono WAV read/write.

Reference parity: source/WaveFile.hpp:19-135 — RIFF writer for 12 kHz
16-bit mono used for wsprd/js8 hand-off and `keepwav` debugging.  Needed
here for test fixtures and the jt9-compat export path.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np

from cwsl_digi_tpu_torch.constants import AUDIO_CLIP_VAL, WAVE_SR


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int = WAVE_SR) -> None:
    """Write float or int16 audio as 16-bit PCM mono."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = float_to_int16(audio)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.tobytes())


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read 16-bit PCM mono WAV -> (int16 array, sample_rate)."""
    with wave.open(str(path), "rb") as w:
        assert w.getsampwidth() == 2, "only 16-bit PCM supported"
        assert w.getnchannels() == 1, "only mono supported"
        sr = w.getframerate()
        data = w.readframes(w.getnframes())
    return np.frombuffer(data, dtype=np.int16), sr


def float_to_int16(audio: np.ndarray, clip: float = AUDIO_CLIP_VAL) -> np.ndarray:
    """Clamp and convert (reference: Instance.cpp:238-241 float->int16)."""
    a = np.clip(np.asarray(audio, dtype=np.float64), -clip, clip)
    return a.astype(np.int16)


def prepare_audio(
    audio: np.ndarray, scale_factor: float, clip: float = AUDIO_CLIP_VAL
) -> np.ndarray:
    """Peak-normalize then scale, the reference's int16-compat path.

    Reference: Instance::prepareAudio (source/Instance.cpp:294-338) —
    multiplies by ``32767/(maxabs+1)`` then by a per-mode factor
    (0.90 for FT modes, 0.20 for WSPR; source/CWSL_DIGI.cpp:100-101).
    Native decoders work in float; this exists for WAV export / jt9 compat.
    """
    a = np.asarray(audio, dtype=np.float64)
    maxabs = float(np.max(np.abs(a))) if a.size else 0.0
    a = a * (clip / (maxabs + 1.0)) * scale_factor
    return a


# Per-mode prepareAudio scale factors (reference: source/CWSL_DIGI.cpp:100-101).
AUDIO_SCALE_FACTOR_FT = 0.90
AUDIO_SCALE_FACTOR_WSPR = 0.20


def raw_wav_header(num_samples: int, sample_rate: int = WAVE_SR) -> bytes:
    """Standalone RIFF header bytes (reference: WavHdr, WaveFile.hpp:19-44)."""
    data_bytes = num_samples * 2
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF",
        36 + data_bytes,
        b"WAVE",
        b"fmt ",
        16,
        1,  # PCM
        1,  # mono
        sample_rate,
        sample_rate * 2,
        2,
        16,
        b"data",
        data_bytes,
    )
