"""Device selection for the port.

Nothing in the package keeps a global device: every object that owns
tensors takes a ``device`` argument, and ``None`` means the card
(:func:`cuda_device`), which raises where there is none instead of falling
back to the CPU.  The CPU runs only when the caller asks for it
(``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch

# float32 matrix products and convolutions run in full float32 on the card:
# TF32 keeps ~3 decimal digits, and the decoder's spectrogram, CRC and OSD
# matmuls are held to the reference's float32 results.  (PyTorch's matmul
# default is already False; cuDNN's is True.)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def cuda_device() -> torch.device:
    """``cuda:0``; raises when no CUDA device is present (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the GPU path cannot run here")
    return torch.device("cuda", 0)


def as_device(device: torch.device | str | None) -> torch.device:
    """Normalise a device argument; ``None`` means :func:`cuda_device`."""
    return cuda_device() if device is None else torch.device(device)
