"""The port's live soak (``tools/torch_soak.py``) and multi-receiver App.

On the CPU, at a tiny size: the soak's config routes each dial to its own
synthetic source, its bursts land at ``anchor + 15 p + dt`` in the samples
the source returns, and a 2-receiver x 2-dial live run finds each burst on
its own receiver only.  The App with two file sources routes decoder
lines by source number (the reference's ``test_app_multi_radio_source_
routing``, judged here by the injected messages and by the windows the
pool decoded).  A live source whose ring fills counts overruns.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import soak as jsoak  # noqa: E402  (the JAX tool)
import torch_soak  # noqa: E402
from cwsl_digi_tpu_torch.config import load_config  # noqa: E402
from cwsl_digi_tpu_torch.modes import ft8  # noqa: E402
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq  # noqa: E402
from cwsl_digi_tpu_torch.runtime.app import App  # noqa: E402
from cwsl_digi_tpu_torch.runtime.decoderpool import DecoderPool  # noqa: E402
from cwsl_digi_tpu_torch.runtime.receiver import Receiver  # noqa: E402
from cwsl_digi_tpu_torch.sdr import source as source_mod  # noqa: E402

torch.set_num_threads(1)

FS, LO = 48_000, 14_096_000


def test_one_receiver_layout_is_the_jax_tools(tmp_path):
    """receivers=1 gives the JAX tool's 512 dials, 344 Hz apart."""
    (tmp_path / "j").mkdir()
    _, want = jsoak.build_config(tmp_path / "j", 512, 192_000, LO)
    cfg, dials = torch_soak.build_config(tmp_path, 512, 192_000, LO)
    assert dials == [[int(f) for f in want]]
    assert [d.freq for d in cfg.decoders] == dials[0]
    assert round(float(np.diff(dials[0]).mean()), 1) == 344.4


@pytest.mark.parametrize("receivers", [2, 8])
def test_build_config_routes_each_dial_to_its_own_source(tmp_path,
                                                         receivers):
    cfg, dials = torch_soak.build_config(tmp_path, 4 * receivers, FS, LO,
                                         receivers)
    groups = App(cfg, device="cpu")._group_lines(warn=False)
    assert len(groups) == receivers
    for r in range(receivers):
        spec = cfg.get("radio", f"source{r}")
        assert spec == f"synthetic:?sr={FS}&lo={LO + r * FS}&rt=1"
        assert [cfg.decoders[i].freq for i in groups[spec]] == dials[r]
        assert all(abs(d - (LO + r * FS)) <= FS // 2 - torch_soak.EDGE_HZ
                   for d in dials[r])
    with pytest.raises(ValueError, match="do not split"):
        torch_soak.build_config(tmp_path, 5, FS, LO, 2)


def test_bursts_land_at_the_anchor_offsets(monkeypatch):
    """Bursts scheduled from a fixed anchor are found at ``anchor + 15 p +
    dt`` in the samples a noiseless ``SyntheticSource`` returns, whatever
    the wall clock of its first read (here 2.5 s before the anchor)."""
    dials = [[LO - 10_000, LO + 10_000], [LO + FS - 10_000, LO + FS + 10_000]]
    plan = torch_soak.plan_bursts(dials, FS, LO, 2, 2, seed=3)
    assert [(b.receiver, b.period) for b in plan] == [(0, 0), (1, 0),
                                                      (0, 1), (1, 1)]
    assert len({b.text for b in plan}) == 4
    anchor = 1_800_000_000.0
    src = source_mod.SyntheticSource(FS, LO, noise_amplitude=0.0)
    torch_soak.inject_bursts(src, plan, 0, anchor)
    monkeypatch.setattr(source_mod.time, "time", lambda: anchor - 2.5)
    n = int(35 * FS)
    iq = np.concatenate([src.read_block() for _ in range(
        -(-n // src.block_size))])
    for b in plan:
        if b.receiver != 0:
            continue
        s = int(round((2.5 + 15 * b.period + b.dt) * FS))
        np.testing.assert_array_equal(iq[s : s + len(b.iq)], b.iq)
        assert not iq[s - 1] and not iq[s + len(b.iq)]
    mine = sum(len(b.iq) for b in plan if b.receiver == 0)
    assert np.count_nonzero(iq) == mine


def test_live_soak_finds_each_burst_on_its_own_receiver():
    """2 receivers x 2 dials, 1 live window at 48 kHz: every window
    decoded, each burst of that window found on its own receiver and no
    spot on the other, no drop or overrun, the audio on the CPU."""
    r = torch_soak.run_soak(4, 1, 2, 2, "cpu", fs=FS)
    assert r["decoded_windows"] >= 4
    assert r["bursts_due"] >= 2 and r["bursts_found"] == r["bursts_due"]
    assert r["missing"] == [] and r["misrouted"] == 0
    assert r["false_spots"] == []
    assert r["stale_drops"] == 0 and r["ingest_overruns"] == 0
    assert r["audio_devices"] == ["cpu"] and r["channelize_launches"] == 0
    assert r["receivers"] == 2 and r["pool_workers"] == 1
    assert 0 < r["latency_s"]["p50"] <= r["latency_s"]["max"]
    assert r["card"] == "cpu" and r["peak_device_bytes"] is None


def test_judge_spots_counts_misrouted_and_false_spots():
    dials = [[1000, 2000], [9000]]
    plan = [torch_soak.Burst(0, 0, 0.5, 2500.0, -5.0, "CQ K1ABC FN42",
                             np.zeros(1, np.complex64)),
            torch_soak.Burst(1, 0, 0.5, 10000.0, -5.0, "CQ W9XYZ EN37",
                             np.zeros(1, np.complex64)),
            torch_soak.Burst(1, 1, 0.5, 10000.0, -5.0, "CQ G4ABC IO91",
                             np.zeros(1, np.complex64))]
    spots = [{"msg": "CQ K1ABC FN42", "dial": 1000},   # found
             {"msg": "CQ K1ABC FN42", "dial": 2000},   # found, again
             {"msg": "CQ K1ABC FN42", "dial": 9000},   # misrouted
             {"msg": "CQ W9XYZ EN37", "dial": 2000},   # misrouted
             {"msg": "CQ W9XYZ EN37", "dial": 9000},   # 1000 Hz: found
             {"msg": "CQ DL7ACA JO40", "dial": 9000}]  # never injected
    got = torch_soak.judge_spots(spots, plan, dials, {(0, 0), (1, 0)})
    assert (got["bursts_due"], got["bursts_found"], got["misrouted"]) == \
        (2, 2, 2)
    assert got["false_spots"] == ["CQ DL7ACA JO40"]
    got = torch_soak.judge_spots(spots[:1], plan, dials,
                                 {(0, 0), (1, 0), (1, 1)})
    assert [m["text"] for m in got["missing"]] == ["CQ W9XYZ EN37",
                                                    "CQ G4ABC IO91"]


def _band_file(tmp_path, lo, dial, text, name, seed):
    rng = np.random.default_rng(seed)
    iq = 0.01 * (rng.standard_normal(FS * 16)
                 + 1j * rng.standard_normal(FS * 16)).astype(np.complex64)
    b = 0.3 * gfsk_modulate_iq(ft8.encode_message(text), dial + 1500.0 - lo,
                               ft8.SPS * 4, FS, ft8.SPEC.tone_spacing)
    iq[int(0.5 * FS) : int(0.5 * FS) + len(b)] += b.astype(np.complex64)
    p = tmp_path / name
    np.save(p, iq)
    return p


def test_app_two_file_sources_route_by_source_number(tmp_path):
    """Two file sources, one FT8 line on each by its source number: each
    injected message is spotted on its own line's dial and on no other;
    waits on the pool's decoded windows (reference:
    tests/test_app_e2e.py::test_app_multi_radio_source_routing)."""
    p20 = _band_file(tmp_path, 14_077_000, 14_074_000, "CQ W2AXR FN13",
                     "b20.npy", 1)
    p40 = _band_file(tmp_path, 7_077_000, 7_074_000, "CQ DX VE3XYZ EN93",
                     "b40.npy", 2)
    ini = tmp_path / "two.ini"
    ini.write_text(f"""
[radio]
source0=file:{p20}?sr={FS}&lo=14077000
source1=file:{p40}?sr={FS}&lo=7077000
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
decoder=14074000 FT8 0
decoder=7074000 FT8 1
[logging]
loglevel=2
logimmediately=true
""")
    app = App(load_config(ini), max_runtime_s=150, device="cpu")
    spots, jobs = [], []
    orig_handle, orig_push = app.spots.handle, app.pool.push

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s:
            spots.append(s)
        return s

    def push(job):
        jobs.append((job.base_freqs, job.audio.device.type))
        orig_push(job)

    app.spots.handle = capture
    app.pool.push = push
    runner = threading.Thread(target=app.run, daemon=True)
    runner.start()
    deadline = time.monotonic() + 140
    while app.pool.count_decoded_windows < 2 \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    app._terminate = True
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert app.pool.count_decoded_windows == 2
    assert sorted(jobs) == [([7_074_000], "cpu"), ([14_074_000], "cpu")]
    assert len(app.receivers) == 2
    got = sorted((s.message, s.base_freq_hz) for s in spots)
    assert got == [("CQ DX VE3XYZ EN93", 7_074_000),
                   ("CQ W2AXR FN13", 14_074_000)]


class _LiveSource:
    """A live source that never waits: its blocks outrun any consumer."""
    sample_rate, lo_freq, block_size, live = 48_000, LO, 12_000, True

    def read_block(self, timeout: float = 1.0):
        return np.zeros(self.block_size, np.complex64)

    def close(self) -> None:
        pass


@pytest.mark.parametrize("live", [True, False])
def test_a_full_ring_counts_overruns_for_live_sources(live):
    """With nothing draining the ring, a live source's blocks find it full
    and count as overruns; a file-like source is held back and counts
    none."""
    src = _LiveSource()
    src.live = live
    cfg = load_config(None, [f"decoders.decoder={LO + 1000} FT8"])
    rx = Receiver(src, cfg.decoders, DecoderPool(decoder_factory=lambda m:
                                                 None),
                  device="cpu", ring_seconds=0.5)
    t = threading.Thread(target=rx._ingest_loop, daemon=True)
    t.start()
    time.sleep(1.5)
    rx._terminate.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert rx._ring.full()
    assert (rx.overruns > 0) == live
