"""The port's recall and SNR tools against the JAX package's.

``tools/torch_parity.py`` rebuilds ``tools/parity.py``'s sweep on the
port's modules; on the same seed it must draw the same trials (the same
message, the same window within 1e-6), and its sweep must give the same
recall, false-decode rate and threshold.  ``tools/torch_soak_merge.py``'s
summary must not call a channel count met when a lower count failed.
Every tool runs on the card unless told otherwise, and raises without one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import parity as jparity  # noqa: E402  (the JAX tool)
import parity_logparse  # noqa: E402
import torch_parity  # noqa: E402
import torch_snr_check  # noqa: E402
import torch_soak  # noqa: E402
import torch_soak_merge  # noqa: E402
from cwsl_digi_tpu_torch.constants import get_rx_period  # noqa: E402

torch.set_num_threads(1)


def test_sweeps_and_fixtures_are_the_jax_tools():
    assert torch_parity.SWEEPS == jparity.SWEEPS
    assert torch_parity.FIXTURES == jparity.FIXTURES


@pytest.mark.parametrize("mode", list(torch_parity.SWEEPS))
def test_make_trial_matches_the_jax_tool(mode):
    """Same seed, same trial: the message, and the window within 1e-6 (the
    900 s and 1800 s rows by their length); the generators end in the same
    state."""
    cfg = torch_parity.SWEEPS[mode]
    rj, rp = np.random.default_rng(11), np.random.default_rng(11)
    want, want_msg = jparity.make_trial(mode, rj, cfg["f0"], cfg["dt"])
    got, got_msg = torch_parity.make_trial(mode, rp, cfg["f0"], cfg["dt"])
    assert got_msg == want_msg
    assert len(got) == len(want) == int(get_rx_period(mode) * 12_000)
    if get_rx_period(mode) <= 300:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    assert rp.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("recall", [
    {},
    {"-10.0": 1.0, "-15.0": 1.0},                      # never crosses
    {"-10.0": 0.25, "-15.0": 0.0},                     # below at the top
    {"-10.0": 1.0, "-20.0": 0.0},                      # interpolated
    {"-18.0": 0.75, "-19.0": 0.5, "-20.0": 0.125},     # exactly at level
    {"-10.0": 0.4, "-12.0": 0.4, "-14.0": 0.2},        # flat below
    {"-21.0": 0.25, "-20.0": 0.875, "-22.0": 0.0},     # unsorted keys
    {"-17.0": 0.6, "-18.0": 0.3, "-19.0": 0.7},        # not monotonic
    {"-10.0": 0.5, "-12.0": 0.5},
])
def test_threshold_matches_the_jax_tool(recall):
    assert torch_parity._threshold(recall) == jparity._threshold(recall)
    assert torch_parity._threshold(recall, 0.9) == \
        jparity._threshold(recall, 0.9)


@pytest.mark.parametrize("fixture", torch_parity.FIXTURES,
                         ids=[f[0] for f in torch_parity.FIXTURES])
def test_synth_named_matches_the_jax_tool(fixture):
    _, mode, message, _, f0, dt, _ = fixture
    want = np.asarray(jparity.synth_named(mode, message, f0, dt))
    got = torch_parity.synth_named(mode, message, f0, dt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sweep_mode_matches_the_jax_tool(capsys, tmp_path):
    """FT8, 3 trials at -10 and -22 dB, on the CPU: the same recall, CI,
    false-decode rate and threshold as the JAX tool; the progress lines
    parse back with ``tools/parity_logparse.py``."""
    want = jparity.sweep_mode("FT8", 3, snrs=(-10, -22))
    capsys.readouterr()
    got = torch_parity.sweep_mode("FT8", 3, snrs=(-10, -22), device="cpu")
    log = capsys.readouterr().out
    for key in ("trials", "recall", "recall_ci95", "false_per_noise_window",
                "threshold_db"):
        assert got[key] == want[key], key
    assert got["recall"]["-10.0"] == 1.0
    assert got["false_messages"] == [] and got["peak_device_bytes"] is None
    (tmp_path / "sweep.log").write_text(log)
    parsed = parity_logparse.parse(str(tmp_path / "sweep.log"))["FT8"]
    assert parsed["recall"] == got["recall"]
    assert parsed["threshold_db"] == got["threshold_db"]


def test_check_fixtures_reports_hit_miss_and_the_known_fault(tmp_path,
                                                             monkeypatch):
    """A committed fixture decodes to its message (hit); the same WAV under
    another message is a miss; a decode of the reference's known false
    message is reported as that fault."""
    shutil.copy(REPO / "tests" / "fixtures" / "ft8_m10db.wav",
                tmp_path / "ft8_m10db.wav")
    (tmp_path / "manifest.json").write_text(json.dumps([
        {"file": "ft8_m10db.wav", "mode": "FT8",
         "message": "K1ABC W9XYZ EN37"},
        {"file": "ft8_m10db.wav", "mode": "FT8", "message": "CQ DL7ACA JO40"},
    ]))
    got = torch_parity.check_fixtures("cpu", tmp_path)
    assert [g["verdict"] for g in got] == ["hit", "miss"]
    assert got[0]["decoded"] == ["K1ABC W9XYZ EN37"]
    monkeypatch.setattr(torch_parity, "KNOWN_FIXTURE_FAULTS",
                        {"ft8_m10db.wav": "K1ABC W9XYZ EN37"})
    again = torch_parity.check_fixtures("cpu", tmp_path)
    assert [g["verdict"] for g in again] == ["hit", "known fault"]


def _run(channels, receivers=1, spots=5, misses=0, stale=0, overruns=0):
    return {"channels": channels, "receivers": receivers, "spots": spots,
            "deadline_misses": misses, "stale_drops": stale,
            "ingest_overruns": overruns, "latency_s": {"p95": 1.0},
            "card": "NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.mark.parametrize("runs,want", [
    ([_run(64), _run(256), _run(512)], 512),
    ([_run(512), _run(64), _run(256, misses=3)], 64),      # lower count fails
    ([_run(64, stale=1), _run(256), _run(512)], None),
    ([_run(64), _run(256, overruns=2), _run(512)], 64),
    ([_run(64), _run(512, 1), _run(512, 8, misses=1)], 64),  # one of two
    ([_run(64), _run(256, spots=0)], 64),
    ([_run(64), _run(256), _run(512, 8)], 512),
])
def test_soak_merge_needs_every_lower_count_to_pass(runs, want, tmp_path):
    paths = []
    for i, r in enumerate(runs):
        paths.append(tmp_path / f"r{i}.json")
        paths[-1].write_text(json.dumps(r))
    out = torch_soak_merge.main([str(p) for p in paths]
                                + ["--out", str(tmp_path / "m.json")])
    s = out["summary"]
    assert s["max_channels_meeting_deadline"] == want
    assert sorted((r["channels"], r["receivers"], r["pass"])
                  for r in s["per_run"]) == sorted(
        (r["channels"], r["receivers"], torch_soak_merge.run_passes(r))
        for r in runs)
    assert json.loads((tmp_path / "m.json").read_text())["summary"] == s


@pytest.mark.parametrize("tool,argv", [
    (torch_parity.main, ["--modes", "FT8"]),
    (torch_parity.main, ["--check-fixtures"]),
    (torch_snr_check.main, ["FT8"]),
    (torch_soak.main, ["--channels", "4", "--receivers", "2"]),
])
def test_tools_default_to_the_card(monkeypatch, tool, argv, tmp_path):
    """``--device`` defaults to ``cuda:0``, which raises "no CUDA device"
    where there is none, before any work; ``tool_device`` gives the CPU
    when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool(argv + ["--out", str(tmp_path / "x.json")]
             if tool is not torch_snr_check.main else argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool(argv + ["--device", "cuda:1"]
             if tool is torch_snr_check.main
             else argv + ["--device", "cuda", "--out", str(tmp_path / "x")])
    assert not (tmp_path / "x.json").exists()
    assert torch_parity.tool_device("cpu") == torch.device("cpu")
    assert torch_parity.device_line(torch.device("cpu")) == "cpu"


def test_keep_false_saves_what_the_decoder_got(tmp_path):
    """``torch_soak.keep_false`` writes one channel of a job as the float32
    window the decoder was given (no rescaling) with its sidecar, and
    ``torch_ap_false`` decodes it again alone with the sidecar's kwargs."""
    import torch_ap_false

    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes.base import warmup_window
    from cwsl_digi_tpu_torch.runtime.decoderpool import DecodeJob

    audio = torch.from_numpy(np.stack(
        [np.zeros(180_000, np.float32),
         1e-3 * warmup_window("FT8").astype(np.float32)]))
    job = DecodeJob(Mode.FT8, audio, [14_074_000, 14_077_000], [0, 1],
                    epoch_time=1_792_219_500.0)
    kwargs = {"my_call": "W2AXR", "depth": 1, "fmax_hz": 3000.0}
    stem = torch_soak.keep_false(tmp_path, job, 1, ["K1ABC W9XYZ EN37", "X"],
                                 ["X"], 3, kwargs)
    assert stem == "FT8_1792219500_14077000"
    saved = np.load(tmp_path / f"{stem}.npy")
    assert saved.dtype == np.float32
    np.testing.assert_array_equal(saved, audio[1].numpy())
    (path, side), = torch_ap_false.fixtures(tmp_path)
    assert path == tmp_path / f"{stem}.npy"
    assert side == {"mode": "FT8", "dial": 14_077_000, "receiver": 3,
                    "epoch": 1_792_219_500.0, "false": ["X"],
                    "messages": ["K1ABC W9XYZ EN37", "X"],
                    "batch_channels": 2, "channel_index": 1,
                    "decoder": kwargs}
    got = torch_ap_false.decode_window(saved, side, torch.device("cpu"))
    assert got == ["K1ABC W9XYZ EN37"]
    assert torch_ap_false.decode_window(saved, side, torch.device("cpu"),
                                        companion=True) == got
