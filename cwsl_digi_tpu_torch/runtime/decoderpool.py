"""Decoder pool of the port: the reference's JAX-free ``DecoderPool``.

Jobs carry their audio as a tensor on the receiver's device; only
``keepwav`` needs it on the host, where the reference's ``np.asarray``
cannot read a CUDA tensor.  Construct it with the port's
``decoder_factory`` (the reference's default factory builds JAX decoders).
"""

from __future__ import annotations

import dataclasses

import torch

from cwsl_digi_tpu.runtime.decoderpool import DecodeJob
from cwsl_digi_tpu.runtime.decoderpool import DecoderPool as _HostPool

__all__ = ["DecodeJob", "DecoderPool"]


class DecoderPool(_HostPool):
    """The reference pool; ``keepwav`` copies device windows to the host."""

    def _keep_wav(self, job: DecodeJob) -> None:
        if isinstance(job.audio, torch.Tensor):
            job = dataclasses.replace(job, audio=job.audio.cpu().numpy())
        super()._keep_wav(job)
