"""CWSL_DIGI on PyTorch and CUDA — the port of ``cwsl_digi_tpu`` to an
NVIDIA Hopper GPU.

The JAX package ``cwsl_digi_tpu`` stays the reference: every module here has
a counterpart of the same name there and is tested against it on the same
NumPy input.  This package imports ``torch`` and nothing of ``jax`` or of
the JAX package: the reference's host modules that it needs (constants,
config, message packing, CRC, GFSK synthesis, reporters, sources,
scheduler, decoder pool, utilities) are kept here as copies, which
``tests/test_torch_host_copies.py`` holds equal to their originals.  Every
entry point runs on the card unless the caller passes ``device="cpu"``.

- ``dsp/``     — the batched channelizer; on CUDA tensors it runs the
                 hand-written kernel in ``dsp/csrc/channelizer.cu``.
- ``modes/``   — every mode's decoder (FT8, FT4, JS8, FST4/FST4W, WSPR,
                 JT65, Q65-30) as PyTorch tensor code.
- ``runtime/`` — receiver framing, decoder pool and the app entry point
                 (``python -m cwsl_digi_tpu_torch.runtime.app``).
- ``parallel/`` — device meshes, the channel-sharded skim, the
                 time-sharded channelizer and the TCP window/spot cluster;
                 ``entry`` drives them (``entry()``,
                 ``dryrun_multichip()``).
- ``convert``  — carries the reference's precomputed tables across.
"""

from cwsl_digi_tpu_torch.version import PROGRAM_NAME, __version__

__all__ = ["__version__", "PROGRAM_NAME"]
