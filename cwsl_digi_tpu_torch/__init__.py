"""CWSL_DIGI on PyTorch and CUDA — the port of ``cwsl_digi_tpu`` to an
NVIDIA Hopper GPU.

The JAX package ``cwsl_digi_tpu`` stays the reference: every module here has
a counterpart of the same name there and is tested against it on the same
NumPy input.  This package imports ``torch`` and never ``jax``; the
JAX-free host modules of the reference (config, message packing, CRC, GFSK
synthesis, reporters, sources, scheduler, decoder pool) are imported from
it rather than copied.

- ``dsp/``     — the batched channelizer; on CUDA tensors it runs the
                 hand-written kernel in ``dsp/csrc/channelizer.cu``.
- ``modes/``   — the FT8 decoder (sync search, coherent LLRs, BP, OSD,
                 multi-pass subtraction) as PyTorch tensor code.
- ``runtime/`` — receiver framing, decoder pool and the app entry point
                 (``python -m cwsl_digi_tpu_torch.runtime.app``).
- ``convert``  — carries the reference's precomputed tables across.
"""

from cwsl_digi_tpu.version import PROGRAM_NAME, __version__

__all__ = ["__version__", "PROGRAM_NAME"]
