"""The worker pool of the port's parallel layer (``parallel/workers.py``),
on the CPU.

The skim's worker code (two worker processes, a position of the 2-entry
mesh each, with its own channelizer and FT8 decoder) against the
in-process skim on the same mesh, bit for bit; the choice of the pool by
the mesh and the merge of the workers' rows in position order; a worker's
exception, death and silence raised in the parent; no child process left
behind; no pool without a card unless the caller names CPU entries.  The
in-process skim is held to the JAX package's in
``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import dataclasses
import gc
from concurrent.futures import ThreadPoolExecutor
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.parallel import make_mesh
from cwsl_digi_tpu_torch.parallel import pipeline
from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep, skim_worker
from cwsl_digi_tpu_torch.parallel.workers import CardWorkers
from test_torch_parallel import _skim_window

FS = 48_000
BS = 4                       # the channelizer's block at 48 kHz
# the decoder of tests/test_torch_parallel.py's skim
SPEC = dataclasses.replace(ft8.SPEC, top_k=16, bp_iters=20)
# one channel, a small decode and no warm-up: a worker that starts in a few
# seconds and serves a step in one
SMALL = (FS, {0: [1000.0]}, dataclasses.replace(SPEC, bp_iters=5), 0)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _no_children(pids) -> None:
    live = {p.pid for p in multiprocessing.active_children()}
    assert not [p for p in pids if p in live or _alive(p)]


def _position_args(freqs, n: int) -> list[tuple]:
    """``skim_worker``'s arguments for each position of an n-entry mesh:
    the position's channel block, no warm-up."""
    blocks = make_mesh(n, devices=["cpu"] * n).blocks("ch", len(freqs))
    return [(FS, {p: list(freqs[b])}, SPEC, 0) for p, b in enumerate(blocks)]


def _merged(results) -> dict[str, np.ndarray]:
    """The workers' rows (a position each, in worker order) as one skim."""
    rows = [r["rows"][p] for p, r in enumerate(results)]
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


@pytest.fixture(scope="module")
def pair():
    """Two CPU workers, a position of the 2-entry mesh each, on the skim
    window's channels; closed after the module, leaving no child."""
    freqs, _ = _skim_window()
    pool = CardWorkers(["cpu", "cpu"], skim_worker, _position_args(freqs, 2))
    pids = pool.pids
    yield pool
    pool.close()
    _no_children(pids)


@pytest.fixture(scope="module")
def spares():
    """Three one-worker pools on SMALL for the tests that kill, stop or
    drop theirs, started together (a start is mostly the child's
    imports); a test takes one with ``pop()``."""
    with ThreadPoolExecutor(3) as ex:
        pools = list(ex.map(lambda _: CardWorkers(["cpu"], skim_worker,
                                                  [SMALL]), range(3)))
    yield pools
    for pool in pools:
        pool.close()


@pytest.fixture
def one_thread():
    """The in-process reference on one thread, as each CPU worker runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_worker_skim_matches_in_process_bit_for_bit(pair, one_thread):
    """The skim's worker code on two CPU workers, after a failed step,
    against the 2-entry mesh in this process on the window of
    tests/test_torch_parallel.py: every array identical, the burst decoded
    on its channel, no kernel launched on the CPU."""
    freqs, iq = _skim_window()
    assert len(pair.pids) == 2 and pair.start_s > 0
    with pytest.raises(RuntimeError, match="worker on cpu failed in step"):
        pair.step(np.zeros(7 * BS + 1, np.complex64))
    # the reference decodes here while the workers decode theirs
    with ThreadPoolExecutor(1) as ex:
        pending = ex.submit(pair.step, iq)
        want = ShardedSkimStep(FS, freqs, make_mesh(2, devices=["cpu"] * 2),
                               decoder=ft8.FT8Decoder(spec=SPEC,
                                                      device="cpu")).step(iq)
        res = pending.result()
    got = _merged(res)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert [r.message for r in ft8.results_from_arrays(got)[5]] == \
        ["CQ W2AXR FN13"]
    assert not any(n for r in res for n in r["launches"].values())
    assert len(pair.worker_s) == 2 and pair.write_s >= 0


def test_worker_exception_is_raised_naming_its_device(pair):
    """A worker's exception in a step raises in the parent with its device
    and traceback (the pool goes on serving: the test above); one in its
    build raises from the constructor and leaves no child."""
    with pytest.raises(RuntimeError, match=r"(?s)worker on cpu failed "
                       r"in step.*Traceback.*must be a multiple of 4"):
        pair.step(np.zeros(7 * BS + 1, np.complex64))
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(RuntimeError, match=r"(?s)worker on cpu failed in "
                       r"start.*Fs/B must be an even integer"):
        CardWorkers(["cpu"], skim_worker, [(50_000, {0: [0.0]}, ft8.SPEC,
                                            0)])
    assert {p.pid for p in multiprocessing.active_children()} <= before


def test_killed_worker_raises(spares):
    """A worker killed between steps: the next step raises at once, names
    the device, and the pool is closed with no child left."""
    pool = spares.pop()
    pids = pool.pids
    os.kill(pids[0], signal.SIGKILL)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="worker on cpu died in step"):
        pool.step(np.zeros(100 * BS, np.complex64))
    assert time.monotonic() - t < pool.timeout_s
    _no_children(pids)
    with pytest.raises(RuntimeError, match="closed"):
        pool.step(np.zeros(100 * BS, np.complex64))


def test_silent_worker_times_out(spares):
    """A worker that gives no reply (stopped) raises within the step's
    time limit, naming its device, and the pool kills it."""
    pool = spares.pop()
    pool.timeout_s = 1.0
    pids = pool.pids
    os.kill(pids[0], signal.SIGSTOP)
    t = time.monotonic()
    with pytest.raises(TimeoutError, match=r"worker\(s\) on cpu gave no "
                       r"reply to step within 1 s"):
        pool.step(np.zeros(100 * BS, np.complex64))
    assert 1.0 <= time.monotonic() - t < 10.0
    _no_children(pids)


def test_dropped_pool_leaves_no_child(spares):
    """A pool that is dropped without close() stops its workers."""
    pool = spares.pop()
    pids = pool.pids
    assert all(_alive(p) for p in pids)
    del pool
    gc.collect()
    _no_children(pids)


class _PoolHere:
    """A stand-in for :class:`CardWorkers` that builds and serves each
    entry in this process, on the CPU whatever the entry's device."""

    def __init__(self, devices, build, args) -> None:
        self.devices = [torch.device(d) for d in devices]
        self.args = args
        self.serves = [build(torch.device("cpu"), *a) for a in args]

    def step(self, window) -> list:
        x = torch.from_numpy(np.asarray(window))
        return [serve(x) for serve in self.serves]

    def close(self) -> None:
        pass


@pytest.fixture
def pool_here(monkeypatch):
    """ShardedSkimStep with the stand-in pool, no kernel library built
    and no SkimShard built in this process: what its constructor chose."""
    built = []
    monkeypatch.setattr(pipeline, "CardWorkers", _PoolHere)
    monkeypatch.setattr(pipeline, "build_skim_libraries",
                        lambda: built.append(True))
    return built


@pytest.mark.parametrize("devices, group, pool", [
    (["cuda:0", "cuda:1"], False, True),
    (["cuda:0", "cuda:0"], False, False),
    (["cpu", "cpu"], False, False),
    (["cuda:0", "cuda:1"], True, False),
], ids=["two_cards", "virtual_mesh", "cpu_mesh", "process_group"])
def test_the_mesh_decides_the_pool(monkeypatch, pool_here, devices, group,
                                   pool):
    """A worker a card where this process's positions span two or more
    CUDA cards and no process group is initialised; a SkimShard a device
    in this process otherwise."""
    shards = []
    mesh = make_mesh(2, devices=devices)
    dec = ft8.FT8Decoder(spec=SPEC, device="cpu")
    monkeypatch.setattr(pipeline, "SkimShard",
                        lambda dev, *a: shards.append(dev))
    monkeypatch.setattr(pipeline, "skim_worker", lambda dev, *a: None)
    monkeypatch.setattr(pipeline.dist, "is_initialized", lambda: group)
    step = ShardedSkimStep(FS, [1000.0, 2000.0], mesh, decoder=dec)
    assert (step.workers is not None) is pool
    assert pool_here == ([True] if pool else [])
    if pool:
        assert step.workers.devices == [torch.device(d) for d in devices]
        assert [a[1] for a in step.workers.args] == [{0: [1000.0]},
                                                    {1: [2000.0]}]
        assert [a[2] for a in step.workers.args] == [SPEC, SPEC]
        assert not shards
    else:
        assert shards == list(dict.fromkeys(torch.device(d)
                                            for d in devices))


def test_pool_rows_come_back_in_position_order(pool_here):
    """A 4-entry mesh over two cards: a worker a card, each holding every
    other position (a channel each of the window's channels 2-5); the
    step's arrays, the rows merged in position order, bit for bit the
    4-entry CPU mesh's in this process, and the workers' launches
    summed."""
    freqs, iq = _skim_window()
    freqs = freqs[2:6]
    mesh = make_mesh(4, devices=["cuda:0", "cuda:1"] * 2)
    dec = ft8.FT8Decoder(spec=SPEC, device="cpu")
    step = ShardedSkimStep(FS, freqs, mesh, decoder=dec)
    assert [sorted(a[1]) for a in step.workers.args] == [[0, 2], [1, 3]]
    got = step.step(iq)
    want = ShardedSkimStep(FS, freqs, make_mesh(4, devices=["cpu"] * 4),
                           decoder=dec).step(iq)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert step.local_channels == list(range(4))
    assert [r.message for r in ft8.results_from_arrays(got)[3]] == \
        ["CQ W2AXR FN13"]
    assert step.worker_launches and not any(step.worker_launches.values())


def test_card_workers_default_to_the_card(monkeypatch):
    """devices=None means the visible CUDA cards: none here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CardWorkers(None, skim_worker, [])


def test_argument_tuples_must_match_the_workers():
    with pytest.raises(ValueError, match="1 argument tuples for 2 workers"):
        CardWorkers(["cpu", "cpu"], skim_worker, [SMALL])
