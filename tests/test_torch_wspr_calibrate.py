"""``tools/torch_wspr_calibrate.py`` against ``tools/wspr_calibrate.py``.

The same command must build the same trials and, on the CPU, print the
same result lines: the true codeword's OSD and beam statistics at each
SNR, and every OSD fit's statistics on noise windows.  The beam sweep
writes its own JSON, never ``WSPR_CALIBRATION.json`` (the JAX package's
record).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import torch_wspr_calibrate  # noqa: E402
import wspr_calibrate as jtool  # noqa: E402  (the JAX tool)

torch.set_num_threads(1)

ARGV = ["--trials", "2", "--noise", "12", "--snrs", "-29"]


def test_same_trials_and_result_lines(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["wspr_calibrate.py"] + ARGV)
    jtool.main()
    want = capsys.readouterr().out.splitlines()
    got = torch_wspr_calibrate.main(ARGV + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device cpu: cpu"
    assert lines[1:] == want
    assert want[0] == "SNR  -29.0: true-OSD 2/2 (true-beam 2)"
    assert got["true_osd"] == {"-29.0": 2}
    assert got["noise_windows"] == 12 and got["near_gate_offenders"] == 0


def test_beam_sweep_writes_its_own_file(tmp_path, capsys, monkeypatch):
    record = REPO / "WSPR_CALIBRATION.json"
    before = hashlib.sha256(record.read_bytes()).hexdigest()
    assert torch_wspr_calibrate.BEAM_SWEEP_OUT == \
        REPO / "chiprun_out" / "torch_wspr_calibration.json"
    monkeypatch.setattr(torch_wspr_calibrate.beam_sweep, "__defaults__",
                        ((8, 16), torch_wspr_calibrate.BEAM_SWEEP_OUT))
    out = tmp_path / "sweep.json"
    got = torch_wspr_calibrate.main(["--beam-sweep", "--trials", "1",
                                     "--snrs", "-10", "--device", "cpu",
                                     "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["widths"]["8"]["recall"] == {"-10.0": 1.0}
    assert got["trials"] == 1 and got["card"] == "cpu"
    assert hashlib.sha256(record.read_bytes()).hexdigest() == before
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {out}"
