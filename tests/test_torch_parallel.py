"""The port's parallel layer against the JAX package's, on the CPU.

Meshes here are virtual: ``devices=["cpu"] * n`` (the JAX side runs on the
suite's 8 virtual CPU devices).  The two-process test runs the port under
a ``gloo`` process group in two subprocesses, as ``tests/test_multihost.py``
runs the reference under ``jax.distributed``.  Also here: the App refusing
an unknown ``[tpu] channelizer`` as the reference's does, and
``dryrun_multichip`` at a small size.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.config import load_config as jload_config
from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.parallel.mesh import make_mesh as jmake_mesh
from cwsl_digi_tpu.parallel.pipeline import ShardedSkimStep as JaxSkimStep
from cwsl_digi_tpu.parallel.timeshard import (
    TimeShardedChannelizer as JaxTimeShards)
from cwsl_digi_tpu_torch.config import load_config
from cwsl_digi_tpu_torch.dsp import SSBD, BatchChannelizer
from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq
from cwsl_digi_tpu_torch.parallel import make_mesh
from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer
from test_torch_parity import assert_same_batch_decodes

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


def test_mesh_construction():
    """make_mesh's factorisation rules, on a virtual CPU mesh."""
    mesh = make_mesh(8, axes=("ch",), devices=CPU8)
    assert mesh.shape["ch"] == 8
    mesh2 = make_mesh(8, axes=("ch", "t"), shape=(4, 2), devices=CPU8)
    assert mesh2.shape == {"ch": 4, "t": 2}
    assert mesh2.shape == dict(jmake_mesh(8, axes=("ch", "t"),
                                          shape=(4, 2)).shape)
    assert make_mesh(3, axes=("t", "ch"), devices=CPU8).shape == \
        {"t": 3, "ch": 1}
    assert mesh2.ranks.tolist() == [[0, 0]] * 4 and mesh2.rank == 0
    # each position of an axis is run by the entry at index 0 of the others
    assert mesh2.owners("t") == [(torch.device("cpu"), 0)] * 2
    assert mesh.blocks("ch", 16)[3] == slice(6, 8)
    with pytest.raises(RuntimeError, match="need 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="do not split"):
        mesh.blocks("ch", 12)


def test_mesh_runs_entries_on_distinct_devices_concurrently():
    """Mesh.run: one host thread per distinct device, positions that share
    a device in turn and in order, every result returned."""
    import threading

    mesh = make_mesh(4, devices=["cpu", "meta", "cpu", "meta"])
    seen = []
    # the first position of each device waits for the other device's:
    # run in turn, this would time out
    both = threading.Barrier(2, timeout=10)

    def fn(p, dev):
        seen.append((dev.type, p, threading.current_thread().name))
        if p < 2:
            both.wait()
        return p * 10

    assert mesh.run("ch", fn) == {0: 0, 1: 10, 2: 20, 3: 30}
    by_dev = {}
    for dev, p, thread in seen:
        by_dev.setdefault(dev, []).append((p, thread))
    assert [p for p, _ in by_dev["cpu"]] == [0, 2]
    assert [p for p, _ in by_dev["meta"]] == [1, 3]
    threads = {d: {t for _, t in v} for d, v in by_dev.items()}
    assert all(len(t) == 1 for t in threads.values())
    assert threads["cpu"] != threads["meta"]

    def boom(p, dev):
        raise ZeroDivisionError(p)

    with pytest.raises(ZeroDivisionError):
        mesh.run("ch", boom)


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("usb", [True, False], ids=["usb", "lsb"])
def test_time_sharded_channelizer_matches_jax(n_shards, usb):
    """The raw-halo time shards against the JAX package's mixed-halo
    ``ppermute`` version on a JAX mesh of as many devices (atol 1e-4),
    against one device's ``process_window`` (atol 1e-4) and against the
    float64 SSBD oracle (atol 2e-3, as the reference's own test).  Each
    shard's block starts its 124-sample halo before its slice, at no
    multiple of the channelizer's 4096-sample sub-block, with n_out =
    2048 / 1024 / 512, no multiple of the kernel's 48-output tile."""
    fs, bw = 48_000, 6_000
    freqs = [5_000.0, -9_000.0] if usb else [9_000.0, -5_000.0]
    t_len = 4 * 4 * 512
    iq = _iq(t_len, seed=n_shards)
    tsc = TimeShardedChannelizer(
        fs, freqs, make_mesh(n_shards, axes=("t",),
                             devices=["cpu"] * n_shards), is_usb=usb)
    audio = tsc.channelize(iq)
    assert tuple(audio.shape) == (2, t_len // tsc.spec.block_size)
    assert tsc.local_span == (0, t_len // tsc.spec.block_size)
    want = np.asarray(JaxTimeShards(
        fs, freqs, jmake_mesh(n_shards, axes=("t",)),
        is_usb=usb).channelize(iq))
    np.testing.assert_allclose(audio.numpy(), want, rtol=0, atol=1e-4)
    whole = BatchChannelizer(fs, freqs, is_usb=usb,
                             device="cpu").process_window(iq)
    np.testing.assert_allclose(audio.numpy(), whole.numpy(), rtol=0,
                               atol=1e-4)
    for i, f in enumerate(freqs):
        gold = SSBD(fs, bw, f, is_usb=usb).process(iq.astype(np.complex128))
        np.testing.assert_allclose(audio[i].numpy(), gold, rtol=0, atol=2e-3)


def test_time_shard_checks_lengths():
    tsc = TimeShardedChannelizer(48_000, [5_000.0], make_mesh(
        4, axes=("t",), devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="multiple of 16"):
        tsc.channelize(_iq(4 * 4 * 100 + 8, 0))
    with pytest.raises(ValueError, match="halo"):
        tsc.channelize(_iq(4 * 4 * 30, 0))


def _skim_window() -> tuple[np.ndarray, np.ndarray]:
    """tests/test_parallel.py's window: 8 channels at 48 kHz, one FT8
    burst at 1.5 kHz in channel 5, noise burying the FIR stopband."""
    fs = 48_000
    freqs = np.linspace(-18_000, 10_000, 8)
    burst = gfsk_modulate_iq(ft8.encode_message("CQ W2AXR FN13"),
                             freqs[5] + 1500.0,
                             int(round(ft8.SPS * fs / ft8.WAVE_SR)), fs,
                             ft8.TONE_SPACING)
    iq = np.zeros(int(ft8.T_R * fs), dtype=np.complex128)
    start = int(0.5 * fs)
    iq[start : start + len(burst)] = burst
    rng = np.random.default_rng(3)
    iq += 0.02 * (rng.standard_normal(len(iq))
                  + 1j * rng.standard_normal(len(iq)))
    return freqs, iq.astype(np.complex64)


@pytest.mark.parametrize("rows", [list(range(8)), [0, 2, 3, 5, 6, 7]],
                         ids=["8ch", "6ch_padded"])
def test_sharded_skim_step_matches_jax(rows):
    """The channel-sharded skim on a virtual 4-entry CPU mesh against the
    JAX package's on 4 JAX devices, on the same window: the same valid
    candidates with the same payloads, SNR within 0.5 dB, f within one
    bin and dt within one hop (PERF.md section 2), identical messages;
    the burst on its own channel only.  6 channels pad to 8 rows, and the
    pad rows are dropped."""
    freqs, iq = _skim_window()
    freqs = freqs[rows]
    target = rows.index(5)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    step = ShardedSkimStep(48_000, freqs, mesh, decoder=ft8.FT8Decoder(
        top_k=16, bp_iters=20, device="cpu"))
    assert step.n_total == 8 and step.local_channels == list(range(len(rows)))
    got = step.step(iq)
    jstep = JaxSkimStep(48_000, freqs, jmake_mesh(4, axes=("ch",)),
                        decoder=jft8.FT8Decoder(top_k=16, bp_iters=20))
    want = {k: np.asarray(v) for k, v in jstep.step(iq).items()}
    assert got.keys() == want.keys()
    assert got["valid"].shape == want["valid"].shape == (len(rows), 16)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v[target].any() and not np.delete(v, target, axis=0).any()
    np.testing.assert_array_equal(got["payload"][v], want["payload"][v])
    np.testing.assert_allclose(got["snr"][v], want["snr"][v], atol=0.5)
    np.testing.assert_allclose(got["f0_bin"][v], want["f0_bin"][v], atol=1)
    np.testing.assert_allclose(got["t0_hop"][v], want["t0_hop"][v], atol=1)
    results = ft8.results_from_arrays(got)
    assert [r.message for r in results[target]] == ["CQ W2AXR FN13"]
    assert_same_batch_decodes(results, jft8.results_from_arrays(want))


_WORKER = r"""
import json, sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(2)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%(port)d",
                        world_size=2, rank=rank)
from cwsl_digi_tpu_torch.dsp import BatchChannelizer
from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq
from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer

fs = 192_000
n_ch = 8
freqs = np.linspace(-80_000, 80_000, n_ch)
text = "CQ W2AXR FN13"
target = 5                                  # channel carrying the burst

rng = np.random.default_rng(7)              # same IQ on both processes
n = fs * 15
iq = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
burst = gfsk_modulate_iq(ft8.encode_message(text), freqs[target] + 1500.0,
                         ft8.SPS * fs // 12_000, fs, ft8.TONE_SPACING)
start = int(0.5 * fs)
iq[start : start + len(burst)] += 0.1 * burst
iq = iq.astype(np.complex64)

# two entries a process: one 4-entry mesh over both
mesh = make_mesh(axes=("ch",), devices=["cpu", "cpu"])
assert mesh.size == 4 and mesh.ranks.tolist() == [0, 0, 1, 1], mesh.ranks
step = ShardedSkimStep(fs, freqs, mesh, decoder=ft8.FT8Decoder(
    top_k=16, bp_iters=20, device="cpu"))
results = step.decode_window(iq)
local = step.local_channels
assert len(results) == len(local), (len(results), len(local))
got = {ch: [r.message for r in rl] for ch, rl in zip(local, results)}

# one time shard a process, against one process's whole window
tfreqs = [5_000.0, -9_000.0]
iq2 = (rng.standard_normal(2 * 4 * 1500)
       + 1j * rng.standard_normal(2 * 4 * 1500)).astype(np.complex64)
tsc = TimeShardedChannelizer(48_000, tfreqs, make_mesh(
    axes=("t",), devices=["cpu"]))
audio = tsc.channelize(iq2)
lo, hi = tsc.local_span
whole = BatchChannelizer(48_000, tfreqs, device="cpu").process_window(iq2)
err = float((audio - whole[:, lo:hi]).abs().max())
dist.destroy_process_group()
print("RESULT " + json.dumps({"pid": rank, "local": local, "decodes": got,
                              "span": [lo, hi], "n_out": whole.shape[1],
                              "err": err}), flush=True)
"""


def test_two_process_gloo_skim_and_time_shard():
    """Two processes under a gloo process group: the skim's channels split
    between them with full, disjoint coverage, the burst decodes on its
    own channel and nowhere else, and the two time shards are the two
    halves of the one-process output (atol 1e-4)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = _WORKER % {"repo": str(REPO), "port": port}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out[-3000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    assert [o["local"] for o in outs] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    decodes = {int(ch): msgs for o in outs
               for ch, msgs in o["decodes"].items()}
    assert sorted(decodes) == list(range(8))
    assert decodes[5] == ["CQ W2AXR FN13"]
    assert all(not decodes[ch] for ch in range(8) if ch != 5)
    n_out = outs[0]["n_out"]
    assert [o["span"] for o in outs] == [[0, n_out // 2], [n_out // 2, n_out]]
    assert max(o["err"] for o in outs) <= 1e-4


def test_app_refuses_unknown_channelizer_as_the_reference():
    """``[tpu] channelizer=pallas``: the port's App, like the reference's,
    logs the same "cannot attach decoders" line and attaches no receiver;
    the default ``xla`` attaches one."""
    from cwsl_digi_tpu.runtime.app import App as JaxApp
    from cwsl_digi_tpu_torch.runtime.app import App

    over = ["radio.source=synthetic:?sr=48000&lo=14070000",
            "decoders.decoder=14074000 FT8", "tpu.channelizer=pallas"]
    logs = {}
    for name, app in [("port", App(load_config(None, over), device="cpu")),
                      ("ref", JaxApp(jload_config(None, over)))]:
        lines = []
        app.printer = types.SimpleNamespace(
            err=lines.append, info=lines.append, warn=lines.append,
            print=lines.append)
        app.setup_receivers(0.0)
        assert app.receivers == {}
        logs[name] = lines
    assert logs["port"] == logs["ref"]
    assert logs["port"] == [
        "cannot attach decoders to synthetic:?sr=48000&lo=14070000: "
        "unknown channelizer backend 'pallas' (only 'xla'; the pallas "
        "kernel lost the bench-off and was demoted)"]
    app = App(load_config(None, over[:2]), device="cpu")
    app.printer = types.SimpleNamespace(err=print, info=print, warn=print,
                                        print=print)
    app.setup_receivers(0.0)
    try:
        assert len(app.receivers) == 1
    finally:
        for rx in app.receivers.values():
            rx.terminate()


def test_dryrun_multichip_on_a_virtual_cpu_mesh(monkeypatch):
    """The port's dry run on 4 virtual CPU entries, with FST4W-120 as the
    long window (FST4W-900's 43 M samples are for the card): the skim
    decodes its burst on channel 5 only, the time-sharded window decodes,
    the 2-D mesh agrees with one device."""
    from cwsl_digi_tpu_torch import entry

    monkeypatch.setattr(entry, "LONG_MODE", "FST4W-120")
    out = entry.dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["skim"][5] == ["CQ W2AXR FN13"]
    assert not any(m for ch, m in out["skim"].items() if ch != 5)
    assert "K1ABC FN42 30" in out["long_decodes"]
    assert out["shape2d"] == (4, 512)


def test_entry_forward_step_matches_the_reference_shapes():
    """entry() on the CPU: the FT8 decode program over four 15 s windows
    with top_k 32, the reference's example shapes."""
    from cwsl_digi_tpu_torch.entry import entry

    fn, (audio,) = entry("cpu")
    assert tuple(audio.shape) == (4, 180_000)
    out = fn(audio)
    assert tuple(out["valid"].shape) == (4, 32)
    assert tuple(out["payload"].shape) == (4, 32, 91)
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
