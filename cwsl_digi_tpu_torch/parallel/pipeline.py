"""The sharded skim step: wideband IQ -> channelize -> decode, over a mesh.

Counterpart of ``cwsl_digi_tpu/parallel/pipeline.py``: one T/R capture
window of wideband IQ in, per-channel decode candidates out, with the
channel bank split over the mesh axis ``ch``.  Each position of the axis
owns a contiguous block of channel rows and holds its own
:class:`BatchChannelizer` over them (on a CUDA entry each block is one
launch of the channelizer kernel) and an FT8 decoder on its device.  The
wideband IQ goes to every device once; every entry mixes the channels it
owns from it and runs one ``decode_program`` pass over them, as the
reference's ``_skim_program`` does, with no collectives.  Under a process
group each process runs only its own entries and returns their rows.
"""

from __future__ import annotations

import numpy as np
import torch

from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.modes.base import DecodeResult
from cwsl_digi_tpu_torch.parallel.mesh import Mesh


class ShardedSkimStep:
    """Channel-sharded channelize+decode for one receiver's channel bank."""

    def __init__(
        self,
        fs: int,
        freqs_hz,
        mesh: Mesh,
        axis: str = "ch",
        decoder: ft8.FT8Decoder | None = None,
    ) -> None:
        self.mesh = mesh
        self.axis = axis
        freqs = list(np.atleast_1d(freqs_hz))
        self.n_channels = len(freqs)
        # pad the bank to a multiple of the axis: pad rows channelize 0 Hz
        # and their outputs are dropped in step()
        n_dev = mesh.shape[axis]
        self._pad_channels = (-len(freqs)) % n_dev
        freqs = freqs + [0.0] * self._pad_channels
        self.n_total = len(freqs)
        self._blocks = mesh.blocks(axis, self.n_total)
        self._local = mesh.local_positions(axis)
        owners = mesh.owners(axis)
        # the decoder's spec (the reference's default FT8Decoder() without
        # one), built once on each device this process runs
        spec = decoder.spec if decoder is not None else None
        self._decoders = {}
        self._chans = {}
        for p in self._local:
            dev = owners[p][0]
            if dev not in self._decoders:
                self._decoders[dev] = ft8.FT8Decoder(spec=spec, device=dev)
            self._chans[p] = BatchChannelizer(
                fs, freqs[self._blocks[p]], device=dev)

    @property
    def local_channels(self) -> list[int]:
        """Channel indices this process's decode outputs correspond to (all
        channels in one process); pad rows are no one's."""
        return [i for p in self._local
                for i in range(self._blocks[p].start, self._blocks[p].stop)
                if i < self.n_channels]

    def step(self, iq) -> dict[str, np.ndarray]:
        """One capture window of wideband IQ -> decode outputs per channel.

        Under a process group the arrays cover this process's
        ``local_channels`` (each host reports the channels it owns)."""
        iq = iq.detach().cpu().numpy() if isinstance(iq, torch.Tensor) \
            else np.asarray(iq)
        chan0 = next(iter(self._chans.values()), None)
        if chan0 is None:
            return {}
        bs = chan0.spec.block_size
        # outputs depend on IQ up to their own block only: the reference's
        # floor(T/BS) outputs are those of the first floor(T/BS) blocks
        x = np.ascontiguousarray(iq[: iq.shape[0] // bs * bs], np.complex64)
        on_dev: dict[torch.device, torch.Tensor] = {}
        owners = self.mesh.owners(self.axis)
        for p in self._local:
            dev = owners[p][0]
            if dev not in on_dev:
                on_dev[dev] = torch.from_numpy(x).to(dev)

        def shard(p, dev):
            audio = self._chans[p].process_window(on_dev[dev])
            out = self._decoders[dev].decode_arrays_device(audio)
            return {k: v.cpu().numpy() for k, v in out.items()}

        outs = self.mesh.run(self.axis, shard)
        rows = [outs[p] for p in self._local]
        n_local = len(self.local_channels)
        return {k: np.concatenate([r[k] for r in rows])[:n_local]
                for k in rows[0]}

    def decode_window(self, iq) -> list[list[DecodeResult]]:
        """Full host-level result: channelize + decode + unpack messages.

        Returns one DecodeResult list per channel of ``local_channels``."""
        out = self.step(iq)
        if not out:
            return []
        return ft8.results_from_arrays(out)
