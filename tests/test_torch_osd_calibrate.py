"""``tools/torch_osd_calibrate.py`` against ``tools/osd_calibrate.py``.

The same command must build the same trials (seed, draws, order) and, on
the CPU, print the same result lines: recall per SNR, the false decodes
on noise windows and their messages.  The port's tools run on the card
unless told otherwise, and raise "no CUDA device" without one.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import bench_cuda  # noqa: E402
import osd_calibrate as jtool  # noqa: E402  (the JAX tool)
import torch_ap_false  # noqa: E402
import torch_bench_sections  # noqa: E402
import torch_osd_calibrate  # noqa: E402
import torch_tune_topk  # noqa: E402
import torch_wspr_calibrate  # noqa: E402

torch.set_num_threads(1)

ARGV = ["--trials", "2", "--noise", "25", "--snrs", "-10"]


def test_same_trials_and_result_lines(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["osd_calibrate.py"] + ARGV)
    jtool.main()
    want = capsys.readouterr().out.splitlines()
    got = torch_osd_calibrate.main(ARGV + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device cpu: cpu"
    assert lines[1:] == want
    assert want[0] == "SNR  -10.0: 2/2 = 100%"
    assert got["recall"] == {"-10.0": 1.0}
    assert got["false_messages"] == []


@pytest.mark.parametrize("tool,argv", [
    (torch_osd_calibrate.main, ARGV),
    (torch_wspr_calibrate.main, ["--trials", "1"]),
    (torch_wspr_calibrate.main, ["--beam-sweep"]),
    (torch_tune_topk.main, ["2", "64"]),
    (torch_ap_false.main, ["chiprun_out/ap_false"]),
    (torch_bench_sections.main, ["channelizer"]),
    (torch_bench_sections.main, ["mode_decode", "FT4"]),
    (bench_cuda.main, []),
])
def test_tools_default_to_the_card(monkeypatch, tool, argv):
    """``--device`` defaults to ``cuda:0``, which raises "no CUDA device"
    where there is none, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool(argv + ["--device", "cuda:1"])
