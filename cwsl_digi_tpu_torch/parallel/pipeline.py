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

Where this process's positions span two or more distinct CUDA cards (and
no process group is initialised) each card's positions run in a worker
process of their own (:class:`~cwsl_digi_tpu_torch.parallel.workers.
CardWorkers`), which one process needs to keep several cards busy: the
decode is bound by host work that threads of one interpreter serialise.
A virtual mesh that repeats one device, a CPU mesh and a process group's
rank run in this process, as before.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from cwsl_digi_tpu_torch.dsp.channelizer import (BatchChannelizer,
                                                 ChannelizerSpec)
from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.modes.base import DecodeResult
from cwsl_digi_tpu_torch.modes.gfsk_engine import ModeSpec
from cwsl_digi_tpu_torch.parallel.mesh import Mesh
from cwsl_digi_tpu_torch.parallel.workers import CardWorkers


def _kernel_modules() -> tuple:
    """The kernel libraries the skim launches: the channelizer's and the
    FT8 decode's (LDPC, sync search, GFSK, median)."""
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.modes import (_gfsk_kernels, _median_kernels,
                                           _sync_kernels)
    from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels

    return (_kernels, ldpc_kernels, _sync_kernels, _gfsk_kernels,
            _median_kernels)


def build_skim_libraries() -> None:
    """Build each kernel library of the skim, one nvcc each, started
    together (a library already built for its source is kept); raises the
    first failure."""
    errors = []

    def build(mod):
        try:
            mod.build_library()
        except BaseException as e:       # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m,))
               for m in _kernel_modules()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _launch_counts() -> dict[str, int]:
    return {k: n for mod in _kernel_modules() for k, n in mod.launches.items()}


class SkimShard:
    """The skim's work on one device: a channelizer for each position's
    channel block and one FT8 decoder.  In this process it serves
    :meth:`run` per position; built by :func:`skim_worker` it serves a
    worker's steps."""

    def __init__(self, device: torch.device, fs: int,
                 blocks: dict[int, list[float]], spec: ModeSpec) -> None:
        self.device = torch.device(device)
        self.decoder = ft8.FT8Decoder(spec=spec, device=self.device)
        self.chans = {p: BatchChannelizer(fs, freqs, device=self.device)
                      for p, freqs in blocks.items()}

    def run(self, p: int, x: torch.Tensor) -> dict[str, np.ndarray]:
        """Position ``p``'s rows from the window ``x`` on this device."""
        audio = self.chans[p].process_window(x)
        out = self.decoder.decode_arrays_device(audio)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def __call__(self, window: torch.Tensor) -> dict:
        """A worker's step: every position's rows, and the kernel launches
        the step made in this process."""
        before = _launch_counts()
        x = window.to(self.device)
        rows = {p: self.run(p, x) for p in self.chans}
        after = _launch_counts()
        return {"rows": rows,
                "launches": {k: after[k] - before[k] for k in after}}


def skim_worker(device: torch.device, fs: int, blocks: dict[int, list[float]],
                spec: ModeSpec, warm_len: int) -> SkimShard:
    """A :class:`CardWorkers` build: the device's :class:`SkimShard`,
    warmed up on ``warm_len`` samples of silence."""
    shard = SkimShard(device, fs, blocks, spec)
    if warm_len:
        shard(torch.zeros(warm_len, dtype=torch.complex64))
    return shard


class ShardedSkimStep:
    """Channel-sharded channelize+decode for one receiver's channel bank.

    ``workers`` is the pool (a worker a card), where the mesh takes one;
    ``worker_launches`` the workers' kernel launches in the last step."""

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
        # one), built once on each device (or worker) that runs positions
        spec = decoder.spec if decoder is not None else ft8.SPEC
        by_dev: dict[torch.device, list[int]] = {}
        for p in self._local:
            by_dev.setdefault(owners[p][0], []).append(p)
        self._bs = ChannelizerSpec(fs, self.n_total).block_size
        self.worker_launches: dict[str, int] = {}
        self.workers: CardWorkers | None = None
        self._shards: dict[torch.device, SkimShard] = {}

        def blocks(ps):
            return {p: freqs[self._blocks[p]] for p in ps}

        # a worker process for each card where this process's positions
        # span two or more, else a SkimShard a device in this process
        n_cards = sum(d.type == "cuda" for d in by_dev)
        if n_cards >= 2 and not dist.is_initialized():
            build_skim_libraries()
            warm = int(ft8.T_R * fs) // self._bs * self._bs
            self.workers = CardWorkers(
                list(by_dev), skim_worker,
                [(fs, blocks(ps), spec, warm) for ps in by_dev.values()])
        else:
            for dev, ps in by_dev.items():
                self._shards[dev] = SkimShard(dev, fs, blocks(ps), spec)

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
        if not self._local:
            return {}
        bs = self._bs
        # outputs depend on IQ up to their own block only: the reference's
        # floor(T/BS) outputs are those of the first floor(T/BS) blocks
        x = np.ascontiguousarray(iq[: iq.shape[0] // bs * bs], np.complex64)
        if self.workers is not None:
            outs, launches = {}, {}
            for r in self.workers.step(x):
                outs.update(r["rows"])
                for k, n in r["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            self.worker_launches = launches
        else:
            on_dev = {dev: torch.from_numpy(x).to(dev)
                      for dev in self._shards}

            def shard(p, dev):
                return self._shards[dev].run(p, on_dev[dev])

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

    def close(self) -> None:
        """Stop the worker processes, if this step has any."""
        if self.workers is not None:
            self.workers.close()
