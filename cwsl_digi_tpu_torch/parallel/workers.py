"""A worker process per card: one process drives several cards.

The reference drives every chip of a host from one program: JAX
dispatches its ``shard_map``'d skim asynchronously, so one Python thread
keeps all chips busy.  The port's decode is bound by the host's launches
and glue, which threads of one interpreter run one at a time, so one
process with a thread per card does not scale across cards.
:class:`CardWorkers` gives each entry of a device list a process of its
own instead, started once and kept:

- each worker (``spawn``: CUDA cannot be forked once the parent has used
  it) sets its card, builds its state with ``build(device, *args)`` from
  picklable arguments and warms up there, once;
- a step's input is one complex64 host window in shared memory
  (:meth:`step` writes it once; it grows only when a longer window comes),
  which each worker reads from its own mapping (page-locked for its card
  in a CUDA worker), and each worker's small result comes back through
  its pipe;
- a worker's exception is raised in the parent with the worker's device
  and traceback; a worker that dies, or gives no reply within
  ``timeout_s``, raises too and closes the pool; a pool that cannot start
  raises.  Nothing falls back to running in this process.

``build`` must be importable by name from a module (a spawned child
imports it, never the caller's test or script file) and return the
callable that serves each step: ``serve(window) -> result``, ``window`` a
view of the shared buffer.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import time
import traceback
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from cwsl_digi_tpu_torch.device import cuda_device

START_TIMEOUT_S = 600.0   # spawn, import, build and warm-up of every worker
STEP_TIMEOUT_S = 120.0    # one step of every worker
_CLOSE_WAIT_S = 10.0      # a worker's exit after "close", before it is killed
# torch's threads in a worker on the CPU: the tests run several workers
# beside the suite's own processes
_CPU_THREADS = 1


def _register(buf: torch.Tensor) -> int:
    """Page-lock this process's mapping of ``buf`` for the current card
    (``cudaHostRegister``); returns its address (0 if none)."""
    ptr, n = buf.data_ptr(), buf.numel() * buf.element_size()
    if n == 0:
        return 0
    err = torch.cuda.cudart().cudaHostRegister(ptr, n, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister failed ({int(err)})")
    return ptr


def _unregister(ptr: int) -> None:
    if ptr:
        torch.cuda.cudart().cudaHostUnregister(ptr)


def _serve(conn, device: str, build: Callable, args: tuple) -> None:
    """A worker's life: build, report ready, then serve steps until
    "close" (or the parent's end of the pipe closes)."""
    dev = torch.device(device)
    t = time.perf_counter()
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(_CPU_THREADS)
        serve = build(dev, *args)
    except BaseException:
        conn.send(("error", traceback.format_exc(), 0.0))
        return
    conn.send(("ready", None, time.perf_counter() - t))
    buf, pinned = None, 0
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            if msg[0] == "close":
                return
            if msg[0] == "buffer":
                _unregister(pinned)
                buf, pinned = msg[1], 0
                if dev.type == "cuda":
                    pinned = _register(buf)
                continue
            t = time.perf_counter()
            try:
                out = serve(buf[: msg[1]])
            except BaseException:
                conn.send(("error", traceback.format_exc(), 0.0))
            else:
                conn.send(("ok", out, time.perf_counter() - t))
    finally:
        _unregister(pinned)


def _shutdown(procs, conns, wait_s: float = _CLOSE_WAIT_S) -> None:
    """Ask every worker to exit, then kill whichever has not within
    ``wait_s``."""
    for c in conns:
        try:
            c.send(("close",))
        except (OSError, ValueError):
            pass
    deadline = time.monotonic() + wait_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    for c in conns:
        c.close()


class CardWorkers:
    """One worker process for each entry of ``devices``.

    ``devices``: the entries (a device may repeat: two workers on one
    card); ``None`` means every visible CUDA card, and raises "no CUDA
    device" without one.  ``args``: one tuple of picklable arguments for
    each entry's ``build``.  Each CUDA worker page-locks its mapping of
    the window (``cudaHostRegister``) for its copies to the card (PERF.md,
    section 6: 2.3-4.5 ms a step on four cards).  ``timeout_s`` bounds
    each step; the start has ``START_TIMEOUT_S``.

    ``start_s`` is the wall of the start (spawn, build and warm-up);
    ``write_s`` the last step's write of the window into shared memory;
    ``worker_s`` each worker's own seconds in its last reply (its build
    and warm-up after the start, its ``serve`` after a step)."""

    def __init__(self, devices: Sequence[torch.device | str] | None,
                 build: Callable, args: Sequence[tuple],
                 timeout_s: float = STEP_TIMEOUT_S) -> None:
        if devices is None:
            cuda_device()              # raises "no CUDA device" without one
            devices = range(torch.cuda.device_count())
        self.devices = [torch.device("cuda", d) if isinstance(d, int)
                        else torch.device(d) for d in devices]
        if len(args) != len(self.devices):
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{len(self.devices)} workers")
        self.timeout_s = timeout_s
        self.write_s = 0.0
        self.worker_s: list[float] = []
        self._buf = torch.empty(0, dtype=torch.complex64)
        ctx = multiprocessing.get_context("spawn")
        self._procs, self._conns = [], []
        self._finalize = weakref.finalize(self, _shutdown, self._procs,
                                          self._conns)
        t = time.monotonic()
        try:
            for dev, a in zip(self.devices, args):
                ours, theirs = ctx.Pipe()
                p = ctx.Process(target=_serve, daemon=True,
                                args=(theirs, str(dev), build, tuple(a)))
                p.start()
                theirs.close()
                self._procs.append(p)
                self._conns.append(ours)
            self._gather(START_TIMEOUT_S, "start")
        except BaseException:
            self.close()
            raise
        self.start_s = time.monotonic() - t

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def _gather(self, timeout_s: float, what: str) -> list:
        """Each worker's reply, in worker order; raises (naming the device)
        for a worker's exception once every reply is in, and closes the
        pool before raising for a worker that died or timed out."""
        replies: dict[int, tuple] = {}
        deadline = time.monotonic() + timeout_s
        while len(replies) < len(self._conns):
            waiting = [i for i in range(len(self._conns)) if i not in replies]
            ready = multiprocessing.connection.wait(
                [self._conns[i] for i in waiting]
                + [self._procs[i].sentinel for i in waiting],
                max(0.0, deadline - time.monotonic()))
            for i in waiting:
                conn, proc = self._conns[i], self._procs[i]
                if conn in ready or conn.poll():
                    try:
                        replies[i] = conn.recv()
                        continue
                    except (EOFError, OSError):    # the worker is gone
                        pass
                if proc.sentinel in ready or not proc.is_alive():
                    proc.join()
                    self._stop(0.0)
                    raise RuntimeError(
                        f"worker on {self.devices[i]} died in {what} "
                        f"(exit code {proc.exitcode})")
            if not ready and len(replies) < len(self._conns):
                late = [str(self.devices[i]) for i in range(len(self._conns))
                        if i not in replies]
                self._stop(0.0)
                raise TimeoutError(f"worker(s) on {', '.join(late)} gave no "
                                   f"reply to {what} within {timeout_s:g} s")
        errors = [(self.devices[i], r[1]) for i, r in sorted(replies.items())
                  if r[0] == "error"]
        if errors:
            if what == "start":
                self.close()
            dev, tb = errors[0]
            raise RuntimeError(f"worker on {dev} failed in {what}:\n{tb}")
        self.worker_s = [replies[i][2] for i in range(len(self._conns))]
        return [replies[i][1] for i in range(len(self._conns))]

    def _send(self, msg) -> None:
        for dev, conn in zip(self.devices, self._conns):
            try:
                conn.send(msg)
            except (OSError, ValueError) as e:
                self._stop(0.0)
                raise RuntimeError(f"worker on {dev} is gone: {e!r}") from e

    def step(self, window) -> list:
        """Write ``window`` (complex [T], host) into the shared buffer and
        run every worker's ``serve`` on it; returns their results in
        worker order."""
        if not self._procs:
            raise RuntimeError("the worker pool is closed")
        x = window.detach().cpu().numpy() if isinstance(window, torch.Tensor) \
            else np.asarray(window)
        n = x.shape[0]
        if n > self._buf.numel():
            self._buf = torch.empty(n, dtype=torch.complex64).share_memory_()
            self._send(("buffer", self._buf))
        t = time.perf_counter()
        self._buf[:n].numpy()[...] = x
        self.write_s = time.perf_counter() - t
        self._send(("step", n))
        return self._gather(self.timeout_s, "step")

    def close(self) -> None:
        """Stop every worker (killing any that does not exit)."""
        self._stop(_CLOSE_WAIT_S)

    def _stop(self, wait_s: float) -> None:
        if self._finalize.detach() is not None:
            _shutdown(self._procs, self._conns, wait_s)
        self._procs.clear()
        self._conns.clear()

    def __enter__(self) -> "CardWorkers":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
