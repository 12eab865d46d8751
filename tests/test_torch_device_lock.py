"""One decode at a time per device (``modes/base.py:DeviceLock``).

Pool workers that decode on one device at once slow each other more than
they overlap, so every decoder's public entry holds its device's lock:
at most one decode is in flight per device, whatever the number of pool
workers; entries that call each other do not deadlock; decoders on
different devices never share a lock.  The time spent waiting for it is
counted apart from the pool's queue wait.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import base
from cwsl_digi_tpu_torch.modes.base import (device_lock, get_decoder,
                                            warmup_window)
from cwsl_digi_tpu_torch.runtime.decoderpool import DecodeJob, DecoderPool

torch.set_num_threads(1)


def pool_run(device, n_jobs: int = 8, workers: int = 4,
             hold_s: float = 0.1) -> dict:
    """``n_jobs`` one-window FT8 jobs through a pool of ``workers`` on
    ``device``, with a real port decoder whose device call (``_passes``)
    records how many calls are in flight at once and holds each for
    ``hold_s``."""
    dec = get_decoder("FT8", device=device, top_k=8, depth=1)
    inner, state = dec._passes, {"now": 0, "most": 0, "calls": 0}
    guard = threading.Lock()

    def passes(audio_dev, depth):
        with guard:
            state["now"] += 1
            state["calls"] += 1
            state["most"] = max(state["most"], state["now"])
        try:
            time.sleep(hold_s)
            return inner(audio_dev, depth)
        finally:
            with guard:
                state["now"] -= 1

    dec._passes = passes
    found = []
    pool = DecoderPool(num_workers=workers, decoder_factory=lambda m: dec,
                       on_result=lambda job, ci, res: found.append(
                           res.message))
    window = warmup_window("FT8")[None].astype(np.float32)
    lock = device_lock(device)
    wait0 = lock.wait_s
    pool.init()
    try:
        for k in range(n_jobs):
            pool.push(DecodeJob(Mode.FT8, window, [14_074_000], [k],
                                epoch_time=15.0 * k))
        deadline = time.monotonic() + 120
        while pool.count_decoded_windows < n_jobs \
                and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        pool.terminate()
    return {**state, "decoded": pool.count_decoded_windows,
            "found": found, "lock_wait_s": lock.wait_s - wait0,
            "stage_log": list(pool.stage_log)}


def test_four_pool_workers_decode_one_at_a_time_per_device():
    """4 workers, 8 FT8 jobs on the CPU: every job decoded with its
    message, never two in the decoder's device call at once; the workers
    waited for the device's lock, and the pool's queue wait stays the
    wait for a worker (4 workers take the first 4 jobs at once)."""
    got = pool_run(torch.device("cpu"))
    assert got["decoded"] == 8 and got["calls"] == 8
    assert got["found"] == ["K1ABC W9XYZ EN37"] * 8
    assert got["most"] == 1
    assert got["lock_wait_s"] > 0.1
    waits = sorted(j["queue_wait_s"] for j in got["stage_log"])
    assert waits[0] < 0.5


def test_equal_devices_share_one_lock_and_others_do_not():
    a, b = torch.device("cuda:0"), torch.device("cuda:1")
    assert device_lock(a) is not device_lock(b)
    assert device_lock(a) is device_lock(torch.device("cuda", 0))
    assert device_lock("cuda:1") is device_lock(b)
    assert device_lock("cpu") is device_lock(torch.device("cpu"))
    assert device_lock("cpu") is not device_lock(a)


def test_locks_of_two_devices_never_wait_on_each_other():
    """A thread holding cuda:1's lock does not hold up a decode entry on
    cuda:0 (``torch.device`` objects need no card)."""
    held, release = threading.Event(), threading.Event()

    def hold():
        with device_lock("cuda:1"):
            held.set()
            release.wait(10)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    try:
        assert held.wait(10)
        ok = []

        def enter():
            with device_lock("cuda:0"):
                ok.append(True)

        u = threading.Thread(target=enter, daemon=True)
        u.start()
        u.join(5)
        assert ok, "cuda:0's lock waited on cuda:1's"
    finally:
        release.set()
        t.join(10)


def test_lock_wait_is_counted_per_thread_and_per_device():
    lock = base.DeviceLock()
    holding, release = threading.Event(), threading.Event()

    def hold():
        with lock:
            holding.set()
            release.wait(10)

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert holding.wait(10)
    threading.Timer(0.2, release.set).start()
    before = lock.thread_wait_s()
    with lock:
        with lock:                      # reentrant: no second wait
            pass
    t.join(10)
    waited = lock.thread_wait_s() - before
    assert 0.15 < waited < 5
    assert lock.wait_s == pytest.approx(waited, abs=0.01)


@pytest.mark.parametrize("mode,kwargs", [
    ("WSPR", dict(top_k=2, beam_width=8)),     # decode -> decode_arrays
    ("FT8", dict(top_k=8, depth=2)),           # decode -> decode_arrays_device
    ("JT65", dict(top_k=2)),                   # decode -> decode_arrays_device
])
def test_nested_entries_complete_under_the_lock(mode, kwargs, monkeypatch):
    """A decoder entry that calls another finishes (on a thread with a
    timeout: a deadlock fails instead of hanging), and its inner entry
    runs while the calling thread holds the device's lock."""
    dec = get_decoder(mode, device="cpu", **kwargs)
    lock = device_lock("cpu")
    held_inside = []
    inner = type(dec).decode_arrays_device

    def spy(self, *a, **kw):
        held_inside.append(lock._lock._is_owned())
        return inner(self, *a, **kw)

    monkeypatch.setattr(type(dec), "decode_arrays_device", spy)
    out = []
    t = threading.Thread(target=lambda: out.append(
        dec.decode(warmup_window(mode)[None])), daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "nested decoder entries deadlocked"
    assert [r.message for r in out[0][0]][:1] == [
        "K1ABC FN42 37" if mode == "WSPR" else "K1ABC W9XYZ EN37"]
    assert held_inside and all(held_inside)
