"""The decode-list comparison the port's tests share, and its tolerances.

Candidate order may differ where bf16 sync scores tie, so two decoders are
compared on the decode list of each window: the same messages and modes,
SNR within 0.5 dB, frequency within one bin and dt within one hop of the
mode's spec (FT8 by default: 1.5625 Hz and 20 ms).

This file imports no JAX, so ``test_torch_cuda.py`` can use it on the
machine with the card.
"""

from __future__ import annotations

import dataclasses

import pytest

from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes.base import DecodeResult
from cwsl_digi_tpu_torch.modes import ft8, wspr
from cwsl_digi_tpu_torch.modes.gfsk_engine import ModeSpec

SNR_DB = 0.5
FREQ_HZ = ft8.SPEC.bin_hz
DT_S = ft8.SPEC.hop / 12_000


class WSPRTolerance:
    """WSPR's tolerances for ``spec``: one 0.73 Hz bin, one 0.17 s hop."""
    bin_hz = wspr.BIN_HZ
    hop = wspr.HOP


def assert_same_decodes(got: list[DecodeResult],
                        want: list[DecodeResult],
                        spec: ModeSpec = ft8.SPEC) -> None:
    """One window's decode lists agree within the stated tolerances (the
    frequency bin and hop of ``spec``)."""
    freq_hz = spec.bin_hz
    dt_s = spec.hop / 12_000
    g = {r.message: r for r in got}
    w = {r.message: r for r in want}
    assert set(g) == set(w), (sorted(g), sorted(w))
    for msg, r in w.items():
        assert abs(g[msg].snr_db - r.snr_db) <= SNR_DB, msg
        assert abs(g[msg].freq_hz - r.freq_hz) <= freq_hz + 1e-9, msg
        assert abs(g[msg].dt_s - r.dt_s) <= dt_s + 1e-9, msg
        assert g[msg].mode == r.mode, msg


def assert_same_batch_decodes(got: list[list[DecodeResult]],
                              want: list[list[DecodeResult]],
                              spec: ModeSpec = ft8.SPEC) -> None:
    """Every window of a batch agrees, and the batches are equally long."""
    assert len(got) == len(want)
    for g_win, w_win in zip(got, want):
        assert_same_decodes(g_win, w_win, spec)


_REF = [DecodeResult("CQ W2AXR FN13", -12.0, 0.50, 1500.0),
        DecodeResult("K1ABC W9XYZ -15", 3.0, 0.74, 700.0)]


def _moved(**change) -> list[DecodeResult]:
    return [dataclasses.replace(_REF[0], **change), _REF[1]]


def test_decode_lists_within_tolerance_agree():
    assert_same_batch_decodes(
        [_moved(snr_db=-12.0 + SNR_DB, freq_hz=1500.0 - FREQ_HZ,
                dt_s=0.50 + DT_S)[::-1]],
        [_REF])


@pytest.mark.parametrize("got", [
    _moved(message="CQ W2AXR FN12"),
    _moved(snr_db=-12.0 - 1.01 * SNR_DB),
    _moved(freq_hz=1500.0 + 1.01 * FREQ_HZ),
    _moved(dt_s=0.50 - 1.01 * DT_S),
    _moved(mode=Mode.FT4),
    _REF[:1],
], ids=["message", "snr", "freq", "dt", "mode", "missing"])
def test_decode_lists_outside_tolerance_differ(got):
    with pytest.raises(AssertionError):
        assert_same_decodes(got, _REF)
    with pytest.raises(AssertionError):
        assert_same_batch_decodes([_REF, got], [_REF, _REF])
