"""Device meshes: named axes over a grid of devices.

Counterpart of ``cwsl_digi_tpu/parallel/mesh.py``.  The axes carry:

- ``ch`` — channel-parallelism (rows of the batched channelizer and of the
           decode batch), the throughput axis;
- ``t``  — time-sharding of one long capture window (FST4-900/1800), each
           shard with the raw-IQ halo it needs (see timeshard.py).

PyTorch has no mesh, so :class:`Mesh` is a small one: a grid of
``torch.device`` entries, each tagged with the rank of the process that
owns it.  The reference's ``channel_sharding``/``replicated`` shardings have
no PyTorch meaning; their job, which rows and which positions of an axis an
entry owns, is done by :meth:`Mesh.blocks` and :meth:`Mesh.owners`, and
:meth:`Mesh.run` runs a function on this process's positions (one host
thread per distinct device, positions that share a device in turn; the
skim's worker processes take over from these threads, see
``pipeline.py``).

A ``devices=`` list may repeat one device: a *virtual* mesh on one card or
on the CPU (the counterpart of the JAX tests' virtual CPU devices).  Under
an initialised ``torch.distributed`` process group the mesh holds every
rank's entries, gathered with ``all_gather_object``, and each process runs
only the entries it owns.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cwsl_digi_tpu_torch.device import cuda_device


def _this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Devices on a grid with named axes, and the rank owning each."""

    def __init__(self, devices, ranks, axis_names: Sequence[str]) -> None:
        self.devices = np.asarray(devices, dtype=object)
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.devices.shape != self.ranks.shape \
                or self.devices.ndim != len(axis_names):
            raise ValueError("devices, ranks and axis names disagree")
        self.axis_names = tuple(axis_names)
        self.rank = _this_rank()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def owners(self, axis: str) -> list[tuple[torch.device, int]]:
        """(device, rank) that runs each position of ``axis``: the entry at
        index 0 of every other axis (replicas along the other axes do not
        repeat the work)."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for p in range(self.devices.shape[k]):
            idx[k] = p
            out.append((self.devices[tuple(idx)], int(self.ranks[tuple(idx)])))
        return out

    def local_positions(self, axis: str) -> list[int]:
        """Positions of ``axis`` that this process runs."""
        return [p for p, (_, r) in enumerate(self.owners(axis))
                if r == self.rank]

    def blocks(self, axis: str, n_rows: int) -> list[slice]:
        """The contiguous rows of an ``[n_rows, ...]`` array that each
        position of ``axis`` owns (``n_rows`` a multiple of its size)."""
        n = self.shape[axis]
        if n_rows % n:
            raise ValueError(f"{n_rows} rows do not split over {n} entries")
        m = n_rows // n
        return [slice(p * m, (p + 1) * m) for p in range(n)]

    def run(self, axis: str, fn: Callable[[int, torch.device], object]
            ) -> dict[int, object]:
        """``fn(position, device)`` for each position of ``axis`` this
        process owns: positions on distinct devices concurrently (one host
        thread per device), positions that share a device in turn.
        Returns ``{position: result}``; an exception in any is raised.

        The threads share the interpreter lock, so work that is bound by
        the host's launches (the FT8 decode) does not scale this way
        across cards: the channel-sharded skim runs each card's positions
        in a worker process instead (``parallel/workers.py``) wherever
        this process's positions span two or more cards and no process
        group is initialised.  Kernel-bound work, the time-sharded
        channelizer, keeps these threads; it scales with them."""
        owners = self.owners(axis)
        by_dev: dict[torch.device, list[int]] = {}
        for p in self.local_positions(axis):
            by_dev.setdefault(owners[p][0], []).append(p)

        def on_device(dev, positions):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return {p: fn(p, dev) for p in positions}
            return {p: fn(p, dev) for p in positions}

        if len(by_dev) <= 1:
            return {p: r for dev, ps in by_dev.items()
                    for p, r in on_device(dev, ps).items()}
        out: dict[int, object] = {}
        with concurrent.futures.ThreadPoolExecutor(len(by_dev)) as ex:
            futures = [ex.submit(on_device, dev, ps)
                       for dev, ps in by_dev.items()]
            for f in futures:
                out.update(f.result())
        return out


def _local_devices(devices) -> list[torch.device]:
    """The given devices, else every visible CUDA device (under a process
    group: this rank's current CUDA device); raises without a card."""
    def current_card() -> torch.device:
        cuda_device()                  # raises "no CUDA device" without one
        return torch.device("cuda", torch.cuda.current_device())

    if devices is not None:
        devs = [torch.device(d) for d in devices]
        # "cuda" means the current card, by its index (tensors carry one)
        return [current_card() if d.type == "cuda" and d.index is None
                else d for d in devs]
    if dist.is_initialized():
        return [current_card()]
    cuda_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: int | None = None,
    axes: Sequence[str] = ("ch",),
    shape: Sequence[int] | None = None,
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` entries.

    With one axis, all entries go to it.  With two axes, ``shape`` picks
    the factorization (default: all on the first axis).  Entries are the
    given ``devices`` (which may repeat one device), else the visible CUDA
    devices; under a process group, every rank's, in rank order.
    """
    local = _local_devices(devices)
    if dist.is_initialized():
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        entries = [(torch.device(d), r) for r, ds in enumerate(gathered)
                   for d in ds]
    else:
        entries = [(d, 0) for d in local]
    if n_devices is not None:
        if len(entries) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(entries)}")
        entries = entries[:n_devices]
    n = len(entries)
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    devs = np.empty(n, dtype=object)
    devs[:] = [d for d, _ in entries]
    ranks = np.array([r for _, r in entries])
    return Mesh(devs.reshape(tuple(shape)), ranks.reshape(tuple(shape)), axes)
