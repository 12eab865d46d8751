"""The port's multi-host layer: window dispatch and spot aggregation over
TCP (mirrors tests/test_cluster.py), plus a window whose audio is a
tensor, as the port's receiver hands them to the pool."""

import time

import numpy as np
import pytest
import torch

from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes.base import DecodeResult
from cwsl_digi_tpu_torch.parallel.cluster import (
    SpotAggregator,
    SpotForwarder,
    WindowClient,
    WindowServer,
)
from cwsl_digi_tpu_torch.report.spot import Spot
from cwsl_digi_tpu_torch.runtime.decoderpool import DecodeJob, DecoderPool


class _FakeDecoder:
    def __init__(self, mode):
        self.mode = mode

    def decode(self, audio):
        return [[DecodeResult("CQ W2AXR FN13", -10, 0.0, 1500.0,
                              mode=self.mode)]
                for _ in range(audio.shape[0])]


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_window_dispatch_end_to_end(as_tensor):
    got, audio_in = [], []

    class Recording(_FakeDecoder):
        def decode(self, audio):
            audio_in.append(np.array(audio))
            return super().decode(audio)

    pool = DecoderPool(
        num_workers=1,
        on_result=lambda j, ci, r: got.append((j.epoch_time, ci)),
        decoder_factory=Recording)
    pool.init()
    server = WindowServer(0, pool, host="127.0.0.1")
    try:
        client = WindowClient("127.0.0.1", server.port)
        rng = np.random.default_rng(0)
        audio = rng.standard_normal((3, 4000)).astype(np.float32)
        job = DecodeJob(
            mode=Mode.FT8,
            audio=torch.from_numpy(audio) if as_tensor else audio,
            base_freqs=[14_074_000] * 3,
            decoder_indices=[0, 1, 2],
            epoch_time=1_700_000_000,
        )
        client.send(job)
        client.send(job)
        deadline = time.monotonic() + 5
        while len(got) < 6 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(got) == 6
        assert server.count_received == 2
        # the window arrives as the host array that was sent
        assert len(audio_in) == 2
        for a in audio_in:
            np.testing.assert_array_equal(a, audio)
        client.close()
    finally:
        server.close()
        pool.terminate()


def test_spot_aggregation_roundtrip():
    got = []
    agg = SpotAggregator(0, got.append, host="127.0.0.1")
    try:
        fwd = SpotForwarder("127.0.0.1", agg.port)
        s = Spot(callsign="W9XYZ", freq_hz=14_075_500,
                 base_freq_hz=14_074_000, snr_db=-12, dt_s=0.1,
                 mode=Mode.FT8, message="K1ABC W9XYZ -15", locator="EN34",
                 epoch_time=1_700_000_000, decoder_index=3)
        fwd.handle(s)
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(got) == 1
        r = got[0]
        assert r.callsign == "W9XYZ" and r.mode == Mode.FT8
        assert r.freq_hz == 14_075_500 and r.decoder_index == 3
        fwd.terminate()
    finally:
        agg.close()
