"""``tools/torch_tune_topk.py`` against ``tools/tune_topk.py``.

The same seeds must build the same trials from ``tools/torch_parity.py``'s
helpers: on the CPU, at one top-K and 2 trials, the recall at -18 and
-21 dB and the busy band's decodes per window equal the JAX tool's, and
the port's result line has the JAX tool's form.
"""

from __future__ import annotations

import functools
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import torch_tune_topk  # noqa: E402
from cwsl_digi_tpu import jaxcache  # noqa: E402
from cwsl_digi_tpu.modes import ft8 as jft8  # noqa: E402
from cwsl_digi_tpu_torch.modes.gfsk_engine import GFSKDecoder  # noqa: E402

torch.set_num_threads(1)


def _jax_tool(monkeypatch):
    # the JAX tool turns on JAX's persistent compile cache in $HOME when it
    # is imported
    monkeypatch.setattr(jaxcache, "enable", lambda *a, **k: None)
    import tune_topk

    return tune_topk


def test_same_trials_and_result_line(monkeypatch, capsys):
    jtool = _jax_tool(monkeypatch)
    jdec = jft8.FT8Decoder(top_k=64)
    want = {"recall_-18": jtool.recall_at(jdec, -18.0, 2),
            "recall_-21": jtool.recall_at(jdec, -21.0, 2),
            "busy_decodes_per_window": jtool.busy(jdec, batch=4)}
    # a CPU-sized run: 2-window latency batches, a 4-window busy band
    monkeypatch.setattr(GFSKDecoder, "MAX_DEVICE_BATCH", 2)
    monkeypatch.setattr(torch_tune_topk, "busy",
                        functools.partial(torch_tune_topk.busy, batch=4))
    rows = torch_tune_topk.main(["2", "64", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(rows) == 1 and rows[0]["top_k"] == 64
    assert {k: rows[0][k] for k in want} == want
    assert want["recall_-18"] == 1.0
    assert lines[0] == "device cpu: cpu"
    assert re.fullmatch(
        r"top_k=  64: +\d+\.\d ms/win  recall -18=1\.000 -21=\d\.\d{3}  "
        r"busy=\d\.\d\d/6", lines[1]), lines[1]
