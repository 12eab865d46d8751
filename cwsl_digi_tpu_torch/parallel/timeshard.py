"""Time-sharded channelizer: one long capture window split over devices.

Counterpart of ``cwsl_digi_tpu/parallel/timeshard.py``.  The reference's
"long sequence" is the capture window, up to 1800 s for FST4-1800 (21.6 M
audio samples).  Its time axis is sharded over the mesh axis ``t``, and
each shard needs the ``FO - BS`` samples before it (the FIR halo).

The reference mixes first and passes the *mixed* halo to its neighbour
with ``ppermute``.  The port's channelizer mixes inside the FIR, from the
raw IQ and the absolute sample index (``dsp/channelizer.py``), so the halo
here is *raw* IQ: shard ``s`` takes its slice ``[s*T_loc, (s+1)*T_loc)``
with the ``H = FO - BS`` raw samples before it attached from the host
window (zeros for shard 0; 496 samples at 192 kHz), and channelizes it as
one block at absolute index ``s*T_loc - H`` and output phase
``(s*T_loc/BS) % 4`` (:meth:`BatchChannelizer.channelize_block`: the
kernel on a CUDA entry, the plain version on a CPU one).  Its NCO
rotations come from float64 host arithmetic, so no shard's phase drifts
however far into the window it starts.
"""

from __future__ import annotations

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import SSB_BW
from cwsl_digi_tpu_torch.dsp.channelizer import (BatchChannelizer,
                                                 ChannelizerSpec)
from cwsl_digi_tpu_torch.parallel.mesh import Mesh


class TimeShardedChannelizer:
    """Channelize one long window with the time axis sharded over a mesh."""

    def __init__(
        self,
        fs: int,
        freqs_hz,
        mesh: Mesh,
        axis: str = "t",
        bw: int = SSB_BW,
        latency_log2: int = 3,
        is_usb: bool = True,
    ) -> None:
        self.spec = ChannelizerSpec(fs, len(np.atleast_1d(freqs_hz)), bw,
                                    latency_log2, is_usb)
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self._local = mesh.local_positions(axis)
        owners = mesh.owners(axis)
        # one channelizer (tables only: shards pass their own tail, index
        # and phase) on each device this process runs
        self._chans: dict[torch.device, BatchChannelizer] = {}
        for p in self._local:
            dev = owners[p][0]
            if dev not in self._chans:
                self._chans[dev] = BatchChannelizer(
                    fs, freqs_hz, bw, latency_log2, is_usb, device=dev)
        self.local_span: tuple[int, int] | None = None

    def channelize(self, iq) -> torch.Tensor:
        """iq: complex [T], T a multiple of n_shards*BlockSize; returns
        audio [C, T/BS] on the first shard's device.  Under a process group
        it returns this process's shards only, and ``local_span`` says
        which outputs they are (``(start, stop)`` in output samples)."""
        iq = np.asarray(iq, np.complex64)
        t = iq.shape[0]
        bs = self.spec.block_size
        n = self.n_shards
        if t % (n * bs) != 0:
            raise ValueError(f"window length must be a multiple of {n * bs}")
        t_loc = t // n
        h = self.spec.filt_order - bs
        if h > t_loc:
            raise ValueError(f"shards of {t_loc} samples are shorter than "
                             f"the {h}-sample halo")
        local = self._local
        if local and local != list(range(local[0], local[-1] + 1)):
            raise ValueError("this process's time shards are not contiguous")

        def shard(s, dev):
            a0 = s * t_loc - h
            # the shard and its halo: a view of the host window, one copy
            x = torch.from_numpy(iq[max(a0, 0) : (s + 1) * t_loc]).to(dev)
            if s == 0:
                x = torch.cat([x.new_zeros(h), x])
            return self._chans[dev].channelize_block(
                x, a0, (s * t_loc // bs) % 4)

        outs = self.mesh.run(self.axis, shard)
        if not local:
            self.local_span = (0, 0)
            return torch.empty(self.spec.num_channels, 0)
        first = outs[local[0]].device
        self.local_span = (local[0] * t_loc // bs,
                           (local[-1] + 1) * t_loc // bs)
        return torch.cat([outs[s].to(first) for s in local], dim=1)
