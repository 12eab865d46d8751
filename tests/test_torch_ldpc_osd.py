"""Min-sum BP and OSD of the port against the JAX package on the same
LLR batches (noisy LDPC(174,91) codewords made from a seed)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import ldpc as jldpc
from cwsl_digi_tpu.modes import osd as josd
from cwsl_digi_tpu_torch.modes import ldpc, osd

torch.set_num_threads(1)


def _noisy_llrs(n_words: int, seed: int) -> np.ndarray:
    """LLRs of random codewords over BPSK+AWGN at Eb/N0 from 0 to 4 dB,
    scaled to the decoder's std-3 operating range."""
    code = ldpc.ft8_code()
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(n_words, code.k), dtype=np.uint8)
    cw = np.stack([code.encode(i) for i in info])
    snr = 10 ** (np.linspace(0.0, 4.0, n_words) / 10)[:, None]
    sigma = np.sqrt(1.0 / (2 * snr * code.k / code.n))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = 2 * y / sigma ** 2
    llr = llr / llr.std(axis=1, keepdims=True) * 3.0
    return llr.astype(np.float32)


@pytest.mark.parametrize("iters", [10, 30])
def test_bp_decode_full_matches_jax(iters):
    """hard and parity_ok identical; post_llr within atol 1e-3 (float32
    min-sum, sums of <= 3 check messages in another order)."""
    llr = _noisy_llrs(96, seed=iters)
    jd = jldpc.BPDecoder(jldpc.ft8_code(), iters=iters)
    td = ldpc.BPDecoder(ldpc.ft8_code(), iters=iters, device="cpu")
    jh, jok, jpost = (np.asarray(x) for x in jd.decode_full(jnp.asarray(llr)))
    th, tok, tpost = td.decode_full(torch.from_numpy(llr))
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(tpost.numpy(), jpost, atol=1e-3)
    assert 0 < jok.sum() < len(jok)       # both converged and failed words


def test_osd_matches_jax():
    """Codeword and hard-error count exact; soft distance within rtol
    1e-5 (float32 dot products in another order)."""
    code = ldpc.ft8_code()
    llr = _noisy_llrs(48, seed=3)
    llr[:4, :20] = np.round(llr[:4, :20])      # ties in |LLR|: stable sort
    gen = np.concatenate([np.eye(code.k, dtype=np.uint8), code.gen_parity],
                         axis=1)
    pats = osd.flip_patterns(code.k, 91, 16, 8).astype(np.float32)
    jcw, jdist, jnh = (np.asarray(x) for x in josd.osd_decode(
        jnp.asarray(gen), jnp.asarray(llr), jnp.asarray(pats)))
    tcw, tdist, tnh = osd.osd_decode(torch.from_numpy(gen),
                                     torch.from_numpy(llr),
                                     torch.from_numpy(pats))
    np.testing.assert_array_equal(tcw.numpy(), jcw)
    np.testing.assert_array_equal(tnh.numpy(), jnh)
    np.testing.assert_allclose(tdist.numpy(), jdist, rtol=1e-5)
    # every output is a codeword
    cw = tcw.numpy().astype(np.uint8)
    np.testing.assert_array_equal((cw @ code.h.T) % 2, 0)


def test_code_encode_and_gf2():
    code = ldpc.ft8_code()
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, size=code.k, dtype=np.uint8)
    np.testing.assert_array_equal(code.encode(info),
                                  jldpc.ft8_code().encode(info))
    m = rng.integers(0, 2, size=(12, 20), dtype=np.uint8)
    a, pa = ldpc.gf2_row_reduce(m)
    b, pb = jldpc.gf2_row_reduce(m)
    np.testing.assert_array_equal(a, b)
    assert pa == pb
    t, jt = ldpc.build_bp_tables(code.h), jldpc.build_bp_tables(code.h)
    for name in ("row_cols", "row_mask", "col_slots", "col_mask"):
        np.testing.assert_array_equal(getattr(t, name), getattr(jt, name))
