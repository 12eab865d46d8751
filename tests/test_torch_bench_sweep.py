"""The port's bench sections that sweep on the CPU at a tiny size: the FT8
recall curve (``torch_parity.sweep_mode`` at -18 to -22 dB, the JAX
section's seed) and the q-ary modes' host share.  Apart from
``tests/test_torch_bench.py`` so the two run on separate workers."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import torch_bench_sections as sections  # noqa: E402
import torch_parity  # noqa: E402

torch.set_num_threads(1)


def test_recall_section_is_the_sweep(monkeypatch):
    """Two trials: the section reports what ``sweep_mode`` returns for
    FT8 at -18..-22 dB on seed 42, without printing progress."""
    calls = []
    real = torch_parity.sweep_mode

    def spy(*args, **kw):
        calls.append((args, kw))
        r = real(*args, **kw)
        calls.append(r)
        return r

    monkeypatch.setattr(torch_parity, "sweep_mode", spy)
    out = sections.section_recall(2, device="cpu")
    (args, kw), r = calls
    assert args == ("FT8", 2)
    assert kw["snrs"] == [-18.0, -19.0, -20.0, -21.0, -22.0]
    assert kw["verbose"] is False and "seed" not in kw     # seed 42
    assert out["recall"] == r["recall"]
    assert sorted(out["recall"]) == ["-18.0", "-19.0", "-20.0", "-21.0",
                                     "-22.0"]
    assert out["recall"]["-18.0"] == 1.0
    assert out["trials"] == 2 and out["threshold_db"] == r["threshold_db"]
    assert out["false_per_noise_window"] == 0.0 == r["false_per_noise_window"]
    assert out["false_messages"] == []
    assert out["peak_device_bytes"] is None and out["wall_s"] > 0


@pytest.mark.parametrize("mode", ["JT65"])
def test_qary_host_fraction_section(mode):
    out = sections.section_qary_host_fraction(mode, 1, device="cpu")
    assert 0.0 <= out["host_fraction"] < 1.0
    assert out["host_fraction"] == max(0.0, round(
        1.0 - out["decode_arrays_s"] / out["decode_s"], 3))
    assert out["batch"] == 1
