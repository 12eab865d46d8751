"""The port's benchmark (``bench_cuda.py``, ``tools/torch_bench_sections.py``)
against the JAX package's (``bench.py``, ``tools/bench_sections.py``).

The busy-band windows and their int16 upload must be the JAX sections'
(atol 1e-6), the headline and mixed-mode formulas ``bench.py``'s on the
same inputs, and the busy-band decode list at batch 2 the JAX
``FT8Decoder``'s on the same windows (unpadded: its device batch set to the
window count).  Each section runs on the CPU at a tiny size.  The bench
itself substitutes nothing: a section that raises or returns nothing ends
it with a non-zero exit and no metric line, and it needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench as jbench  # noqa: E402  (the JAX bench)
import bench_cuda  # noqa: E402
import bench_sections as jsections  # noqa: E402
import torch_bench_sections as sections  # noqa: E402
from cwsl_digi_tpu.modes import ft8 as jft8  # noqa: E402

torch.set_num_threads(1)


def test_busy_windows_are_the_jax_sections(monkeypatch):
    """Same windows within 1e-6 and the same injected messages, recorded
    from the JAX section's own synthesis calls."""
    texts = []
    orig = jft8.synthesize

    def record(text, *a, **kw):
        texts.append(text)
        return orig(text, *a, **kw)

    monkeypatch.setattr(jft8, "synthesize", record)
    want = jsections.make_busy_windows(2, seed=5)
    got, injected = sections.make_busy_windows(2, seed=5)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 180_000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert injected == [texts[:6], texts[6:]]
    assert len(set(texts)) == 12


def test_upload_int16_is_the_jax_sections():
    wins, _ = sections.make_busy_windows(2, per_window=2, seed=9)
    wins[1] *= 1e-3                       # the peak scaling is per window
    got = sections.upload_int16(wins, "cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jsections._upload_int16(wins))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.abs().max()) == 32000.0


# (t_chan, t_dec) pairs: the reference bench's fallbacks, card-like values,
# and a decode slower than real time
_TIMES = [(4.4e-6, 1.0), (5.4e-7, 0.0187), (1.1e-5, 0.022), (1e-6, 16.0)]


def _all_modes(t_dec: float, scale: float) -> dict:
    return {m: t_dec * scale * (1 + 0.1 * i)
            for i, m in enumerate(bench_cuda.TEMPLATE_MIX)}


@pytest.mark.parametrize("t_chan,t_dec", _TIMES)
def test_formulas_are_bench_py(t_chan, t_dec):
    """The headline is ``bench.py``'s 15 / (t_chan*15 + t_dec) and the
    mixed-mode capacity its ``_mixed_mode_channels`` when every mode of the
    mix is measured."""
    assert bench_cuda.TEMPLATE_MIX == jbench.TEMPLATE_MIX
    assert bench_cuda.FT8_T_R == jft8.T_R
    assert bench_cuda.realtime_channels(t_chan, t_dec) == int(
        jft8.T_R / (t_chan * jft8.T_R + t_dec))
    for scale in (0.5, 1.0, 7.0):
        s = _all_modes(t_dec, scale)
        assert bench_cuda._mixed_mode_channels(t_chan, s) == \
            jbench._mixed_mode_channels(t_chan, s)


@pytest.mark.parametrize("missing", ["FT4", "FST4-1800", "FST4W-900",
                                     "Q65-30"])
def test_a_mode_without_a_measurement_raises(missing):
    """Where ``bench.py`` models the long periods from FST4-120 or reaches
    ``float("FT4")``, the port raises, naming the mode."""
    s = _all_modes(0.02, 1.0)
    del s[missing]
    with pytest.raises(ValueError, match=f"no decode measurement for "
                                         f"{missing}$"):
        bench_cuda._mixed_mode_channels(1e-6, s)
    s[missing] = None
    with pytest.raises(ValueError, match=missing):
        bench_cuda._mixed_mode_channels(1e-6, s)


def test_channelizer_section_on_the_cpu(capsys):
    """The section's command line prints one JSON line; on the CPU the
    plain version runs, nothing launches and no device time is claimed."""
    out = sections.main(["channelizer", "8", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == out
    assert out["n_channels"] == 8 and out["backend"] == "plain"
    assert out["samples"] % 4096 == 0 and out["samples"] <= 192_000
    assert out["s_per_channel_second"] > 0 and out["kernel_launches"] == 0
    assert out["device_ms"] is None and out["device_bound_ms"] is None
    assert out["peak_device_bytes"] is None
    assert out["wall_s"] > 0


def test_busy_decode_section_matches_jax():
    """Batch 2, one timed run: its decode lists (warm-up batch, seed 5;
    timed batch, seed 6) equal the JAX FT8Decoder's on the same windows,
    every injected message is found and none other."""
    out = sections.section_decode_production(2, 1, device="cpu")
    ref = jft8.FT8Decoder()
    ref.max_device_batch = 2          # unpadded (ROADMAP, e2e margin)
    want = [[sorted(r.message for r in rl)
             for rl in ref.decode(jsections.make_busy_windows(2, seed=s))]
            for s in (5, 6)]
    assert out["decodes"] == want
    assert out["batch"] == 2 and out["max_device_batch"] == 24
    assert len(out["runs_s_per_window"]) == 1
    assert out["s_per_window"] == out["runs_s_per_window"][0]
    assert out["s_per_window_hostfed"] > 0
    assert out["decodes_per_window"] == 6.0
    assert out["found_share"] == 1.0 and out["false_messages"] == []
    assert out["lock_wait_s"] < 0.1


def test_busy_decode_section_raises_on_a_false_message(monkeypatch):
    """A decoded message that was never injected fails the section."""
    real = sections.make_busy_windows

    def one_lie(batch, per_window=6, seed=5):
        wins, injected = real(batch, per_window, seed)
        injected[0] = injected[0][1:]      # the decoder finds one "extra"
        return wins, injected

    monkeypatch.setattr(sections, "make_busy_windows", one_lie)
    with pytest.raises(AssertionError, match="never injected"):
        sections.section_decode_production(1, 1, device="cpu")


@pytest.mark.parametrize("mode,fed", [("FT4", True), ("WSPR", False),
                                      ("JT65", False)])
def test_mode_decode_section_on_the_cpu(mode, fed):
    out = sections.section_mode_decode(mode, 1, 1, device="cpu")
    assert out["batch"] == 1 and out["device_fed"] is fed
    assert out["s_per_window"] == min(out["runs_s_per_window"]) > 0
    assert out["found_share"] == 1.0 and out["false_messages"] == []


@pytest.mark.parametrize("mode,want", [("FST4W-1800", 9), ("FST4-900", 18),
                                       ("FST4-300", 24), ("WSPR", 24)])
def test_mode_decode_batch_holds_at_most_group_samples(mode, want,
                                                       monkeypatch):
    """The default batch is min(max_device_batch, 24), capped at
    ``GROUP_SAMPLES`` samples: 9 windows of 1800 s, 18 of 900 s."""
    class Dec:
        max_device_batch = 64

    class Stop(Exception):
        pass

    seen = []

    def stop(mode_, batch, rng):
        seen.append(batch)
        raise Stop

    monkeypatch.setattr(sections, "_mode_windows", stop)
    monkeypatch.setattr("cwsl_digi_tpu_torch.modes.base.get_decoder",
                        lambda mode, device: Dec())
    with pytest.raises(Stop):
        sections.section_mode_decode(mode, device="cpu")
    assert seen == [want]


def _fake_sections(monkeypatch, broken: str | None = None, result=None):
    """Replace every section with a fixed result; ``broken`` raises or
    returns ``result`` instead."""
    base = {"wall_s": 1.0, "peak_device_bytes": 1 << 20}
    fakes = {
        "section_channelizer": dict(
            base, s_per_channel_second=1e-6, device_s_per_channel_second=1e-7,
            device_ms=0.14, device_bound_ms=0.02, backend="cuda",
            n_channels=256),
        "section_decode_production": dict(
            base, s_per_window=0.02, runs_s_per_window=[0.021, 0.02, 0.019],
            s_per_window_hostfed=0.021, batch=24, decodes_per_window=5.5,
            found_share=0.9, false_messages=[], lock_wait_s=0.0),
        "section_recall": dict(
            base, recall={"-18.0": 1.0}, trials=100, threshold_db=-21.5,
            false_per_noise_window=0.0),
        "section_mode_decode": dict(base, s_per_window=0.01, batch=4,
                                    found_share=1.0),
        "section_qary_host_fraction": dict(base, host_fraction=0.25),
    }
    for name, r in fakes.items():
        def fake(*args, _name=name, _r=r, device=None):
            if _name == broken:
                if result == "raise":
                    raise RuntimeError("section broke")
                return result
            return dict(_r)
        monkeypatch.setattr(sections, name, fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_cuda, "device_info", lambda dev: {
        "name": "card", "power_limit": "700.00 W", "count": 1,
        "torch": torch.__version__, "cuda": None})
    monkeypatch.setattr(bench_cuda, "load_kernels", lambda: 0.5)


def test_bench_line_from_every_section(monkeypatch, capsys):
    _fake_sections(monkeypatch)
    assert bench_cuda.main([]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "ft8_realtime_channels_per_chip"
    assert line["value"] == int(15 / (1e-6 * 15 + 0.02)) == 749
    assert line["vs_baseline"] == 749 / 512
    d = line["detail"]
    assert sorted(d["mode_decode_s_per_window"]) == sorted(
        bench_cuda.TEMPLATE_MIX)
    assert d["mode_decode_s_per_window"]["FT8"] == 0.02
    assert d["qary_host_fraction"] == {"JT65": 0.25, "Q65-30": 0.25}
    assert d["channelizer_backend"] == "cuda"
    assert d["busy_false_messages"] == []
    assert len(d["section_walls_s"]) == len(d["peak_device_bytes"]) == 19
    assert d["kernel_library_load_s"] == 0.5
    assert line["device"]["power_limit"] == "700.00 W"


@pytest.mark.parametrize("broken", ["section_channelizer",
                                    "section_decode_production",
                                    "section_recall", "section_mode_decode",
                                    "section_qary_host_fraction"])
@pytest.mark.parametrize("result", ["raise", None, {}])
def test_a_failed_section_ends_the_bench(monkeypatch, capsys, broken,
                                         result):
    """No fallback value: the bench exits non-zero, names the section and
    prints no metric line."""
    _fake_sections(monkeypatch, broken, result)
    assert bench_cuda.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    name = broken.removeprefix("section_")
    assert f"section {name}" in cap.err and "bench failed" in cap.err


def test_bench_needs_a_cuda_device():
    """Run as the chip machine runs it, without a card: "no CUDA device",
    a non-zero exit, nothing on stdout."""
    out = subprocess.run([sys.executable, "bench_cuda.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout == ""


def test_bench_measures_only_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CUDA device"):
        bench_cuda.main(["--device", "cpu"])
