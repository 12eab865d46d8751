"""Mode decoder registry of the port (counterpart of
``cwsl_digi_tpu/modes/base.py``).

``DecodeResult`` and the ``ModeDecoder`` protocol are the reference's own
(that module imports JAX only inside ``get_decoder``/``warmup_window``).
Only FT8 is ported so far; every other mode raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from cwsl_digi_tpu.constants import Mode
from cwsl_digi_tpu.modes.base import DecodeResult, ModeDecoder  # noqa: F401


class DecoderRegistry:
    """Lazily constructed decoders on one device, cached by mode and
    construction kwargs (differently configured decoders coexist)."""

    def __init__(self, device: torch.device | str = "cpu") -> None:
        self.device = torch.device(device)
        self._cache: dict[tuple, ModeDecoder] = {}
        self._lock = threading.Lock()

    def get(self, mode: Mode | str, **kwargs) -> ModeDecoder:
        mode = Mode(mode)
        key = (mode,) + tuple(sorted(kwargs.items()))
        with self._lock:
            if key not in self._cache:
                self._cache[key] = _construct(mode, self.device, **kwargs)
            return self._cache[key]


def get_decoder(mode: Mode | str, device: torch.device | str = "cpu",
                **kwargs) -> ModeDecoder:
    """A new decoder for ``mode`` on ``device``."""
    return _construct(Mode(mode), torch.device(device), **kwargs)


def warmup_window(mode: Mode | str) -> np.ndarray:
    """One capture window holding a strong protocol-exact signal: decoding
    it runs every pass, the subtraction and OSD once."""
    mode = Mode(mode)
    if mode == Mode.FT8:
        from cwsl_digi_tpu_torch.modes import ft8

        return ft8.synthesize("K1ABC W9XYZ EN37")
    raise NotImplementedError(f"{mode.value} is not ported yet")


def _construct(mode: Mode, device: torch.device, **kwargs) -> ModeDecoder:
    if mode == Mode.FT8:
        from cwsl_digi_tpu_torch.modes.ft8 import FT8Decoder

        return FT8Decoder(device=device, **kwargs)
    raise NotImplementedError(f"{mode.value} is not ported yet")
