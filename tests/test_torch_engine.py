"""Stages of the port's GFSK engine against the JAX package on the same
seeded inputs: coherent multi-symbol LLRs, burst subtraction, the
subtraction pick and the packed output buffer."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.modes import gfsk_engine as jeng
from cwsl_digi_tpu.modes import subtract as jsub
from cwsl_digi_tpu.modes.crc import ft8_crc
from cwsl_digi_tpu.modes.message77 import pack77
from cwsl_digi_tpu_torch.modes import ft8, gfsk_engine, subtract
from cwsl_digi_tpu_torch.modes.ldpc import ft8_code

torch.set_num_threads(1)
SPEC = ft8.SPEC


def test_multisym_llrs_match_jax():
    """Same csym/rot: LLRs within atol 1e-3 after the std-3 scaling
    (float32 max-log sums in another order)."""
    rng = np.random.default_rng(21)
    m = 40
    tones = rng.integers(0, 8, size=(m, SPEC.n_sym))
    for s, t in SPEC.sync_cells:
        tones[:, s] = t
    amp = np.linspace(0.2, 3.0, m)[:, None, None]
    csym = (rng.standard_normal((m, SPEC.n_sym, 8))
            + 1j * rng.standard_normal((m, SPEC.n_sym, 8)))
    csym += amp * np.exp(1j * rng.uniform(0, 2 * np.pi, (m, SPEC.n_sym, 1))) \
        * (np.arange(8) == tones[:, :, None])
    csym = csym.astype(np.complex64)
    rot = np.exp(-1j * rng.uniform(-np.pi, np.pi, m)).astype(np.complex64)
    bitmaps = SPEC.bitmaps()
    want = np.asarray(jeng._multisym_llrs(jft8.SPEC, jnp.asarray(csym),
                                          jnp.asarray(rot),
                                          jnp.asarray(bitmaps)))
    got = gfsk_engine._multisym_llrs(SPEC, torch.from_numpy(csym),
                                     torch.from_numpy(rot),
                                     torch.from_numpy(bitmaps)).numpy()
    assert got.shape == (m, SPEC.n_bits)
    np.testing.assert_allclose(got, want, atol=1e-3)


def _info_bits(text: str) -> np.ndarray:
    p = pack77(text)
    return np.concatenate([p, ft8_crc(p)]).astype(np.int32)


def test_subtract_known_matches_jax():
    """Same params: residual within 1e-3 of the window peak (float32
    phase accumulation over a 12.6 s burst in another summation order)."""
    rng = np.random.default_rng(4)
    bursts = [[("CQ W2AXR FN13", 1500.0, 0.5), ("K1ABC W9XYZ -15", 900.0, 1.0),
               ("CQ DX VE3XYZ EN93", 2200.0, 0.3)],
              [("G4ABC K1ABC RR73", 1200.0, 0.8)]]
    n = int(15 * 12_000)
    audio = np.zeros((2, n), np.float32)
    params = np.zeros((2, 4, 94), np.int32)
    for w, bl in enumerate(bursts):
        for j, (text, f0, start) in enumerate(bl):
            audio[w] += ft8.synthesize(text, f0, amplitude=1.0 / (j + 1),
                                       start_s=start).astype(np.float32)
            params[w, j, :91] = _info_bits(text)
            params[w, j, 91] = int(round(start * 12_000 / SPEC.hop))
            params[w, j, 92] = int(round(f0 / SPEC.bin_hz))
            params[w, j, 93] = 1
        audio[w] += 0.1 * rng.standard_normal(n).astype(np.float32)
    gp = ft8_code().gen_parity.astype(np.float32)
    want = np.asarray(jsub.subtract_known(jft8.SPEC, jnp.asarray(audio),
                                          jnp.asarray(params),
                                          jnp.asarray(gp)))
    got = subtract.subtract_known(SPEC, torch.from_numpy(audio),
                                  torch.from_numpy(params),
                                  torch.from_numpy(gp)).numpy()
    peak = np.abs(audio).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-3 * peak)
    # the bursts really went: residual power near the noise floor
    assert np.mean(got ** 2) < 0.1 * np.mean(audio ** 2)
    assert subtract.GAIN_SMOOTH_SYMS == jsub.GAIN_SMOOTH_SYMS


def test_select_subtract_params_and_pack_match_jax():
    """The subtraction pick (hash dedup, score order) and the packed
    output buffer are identical to the reference's."""
    rng = np.random.default_rng(8)
    b, k = 3, 64
    base = rng.integers(0, 2, size=(b, 8, 91)).astype(np.int8)
    payload = base[:, rng.integers(0, 8, size=k)]    # duplicates to dedup
    valid = rng.random((b, k)) < 0.4
    score = np.round(rng.uniform(1, 30, (b, k)), 1).astype(np.float32)
    t0 = rng.integers(-100, 200, (b, k)).astype(np.int32)
    f0 = rng.integers(128, 1921, (b, k)).astype(np.int32)
    snr = rng.uniform(-25, 10, (b, k)).astype(np.float32)
    hash_w = np.asarray(jft8.FT8Decoder(top_k=64)._hash_w)
    want = np.asarray(jeng.select_subtract_params(
        16, jnp.asarray(payload), jnp.asarray(valid), jnp.asarray(score),
        jnp.asarray(t0), jnp.asarray(f0), jnp.asarray(hash_w)))
    got = gfsk_engine.select_subtract_params(
        16, torch.from_numpy(payload), torch.from_numpy(valid),
        torch.from_numpy(score), torch.from_numpy(t0), torch.from_numpy(f0),
        torch.from_numpy(hash_w.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, :, -1].sum() > 0

    jp = np.asarray(jeng._pack_outputs(
        jnp.asarray(valid), jnp.asarray(payload), jnp.asarray(t0),
        jnp.asarray(f0), jnp.asarray(score), jnp.asarray(snr)))
    tp = gfsk_engine._pack_outputs(
        torch.from_numpy(valid), torch.from_numpy(payload),
        torch.from_numpy(t0), torch.from_numpy(f0), torch.from_numpy(score),
        torch.from_numpy(snr)).numpy()
    np.testing.assert_array_equal(tp, jp)
    parsed = gfsk_engine._parse_packed(tp, 91)
    ref = jeng.GFSKDecoder._parse_packed(jp, 91)
    for key in ref:
        np.testing.assert_array_equal(parsed[key], ref[key])


def test_results_from_arrays_match_jax():
    """Host unpack of validated candidate arrays: same deduped lists."""
    texts = ["CQ W2AXR FN13", "K1ABC W9XYZ -15", "CQ W2AXR FN13",
             "G4ABC K1ABC RR73", "CQ DX VE3XYZ EN93"]
    k = len(texts)
    out = {
        "valid": np.array([[True, True, True, False, True]] * 2),
        "payload": np.stack([np.stack([_info_bits(t) for t in texts])] * 2
                            ).astype(np.int8),
        "t0_hop": np.array([[25, 30, 26, 10, -4]] * 2),
        "f0_bin": np.array([[960, 576, 961, 700, 1408]] * 2),
        "score": np.array([[9.5, 4.0, 12.25, 3.0, 2.5],
                           [1.0, 2.0, 3.0, 4.0, 5.0]], np.float32),
        "snr": np.linspace(-20, 5, 2 * k, dtype=np.float32).reshape(2, k),
    }
    want = jft8.results_from_arrays(out)
    got = ft8.results_from_arrays(out)
    assert [[r.message for r in w] for w in got] == \
        [[r.message for r in w] for w in want]
    for gw, ww in zip(got, want):
        for g, w in zip(gw, ww):
            assert (g.snr_db, g.dt_s, g.freq_hz, g.score) == \
                (w.snr_db, w.dt_s, w.freq_hz, w.score)
    assert len(got[0]) == 3
