"""JT65 and Q65-30 in the port against the JAX package.

Each stage on the same seeded NumPy inputs, then whole decodes:

- threefry: the port's draws are bit for bit ``jax.random``'s (the JT65
  Chase erasure patterns come from them);
- ``rs_ee_decode``: corrected words and ``ok`` flags identical on 2,000
  seeded words (errors and erasures inside and beyond capacity, noise);
- ``rs_chase_program``: ``info`` and ``ok`` identical, score within 1e-5,
  on demod outputs of a JAX JT65 decode, also stage by stage: the plain
  erasure flags bit for bit the JAX program's ``u < p`` (its weights, depths
  and windowed row sums bit for bit), the plain score and selection on the
  reference's flags;
- the tone gather and top-4 (``_symbol_energies_plain``) on the decoders'
  own power maps of both spectrogram branches, with planted tone ties:
  energies, top-4 and tones bit for bit JAX's gather and ``lax.top_k``, the
  sum and margin within float rounding;
- ``qary_decode_program``: t0, f0 and the top tones identical; energies
  within 1e-4 relative on the rfft branch and within 2^-7 relative + 1e-5
  of the peak on the bf16 DFT branch;
- ``_mp_priors`` within 1e-6; ``QaryMPDecoder.decode``: syndrome flags
  identical, and hard symbols identical and confidence within 1e-4 where
  the syndrome holds; the packed output of the converging variants
  identical;
- decode lists equal to the reference's (``test_torch_parity``
  tolerances: SNR 0.5 dB, one bin, one hop of the mode) on the committed
  fixtures and on seeded windows, noise-only windows included.

The App replay with JT65 and Q65-30 lines is in ``test_torch_app_modes.py``.

The JAX references decode unpadded (window counts below their device
batch).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import jt65 as jjt65
from cwsl_digi_tpu.modes import q65 as jq65
from cwsl_digi_tpu.modes import qary_engine as jqe
from cwsl_digi_tpu.modes import qra as jqra
from cwsl_digi_tpu.modes import rs64 as jrs64
from cwsl_digi_tpu.modes import rs_device as jrs
from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
from cwsl_digi_tpu.utils.wav import read_wav
from cwsl_digi_tpu_torch.modes import jt65, q65, qary_engine, rs_device
from cwsl_digi_tpu_torch.modes import threefry
from test_torch_parity import assert_same_batch_decodes

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
MANIFEST = {e["file"]: e for e in json.loads(
    (FIXTURES / "manifest.json").read_text())}
CPU = torch.device("cpu")


# --------------------------------------------------------------------------
# threefry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [
    (0, (5,)), (17, (1,)), (12345, (3, 250, 63)), (2**31 - 1, (7, 3)),
    (987654, (2, 4, 5, 3))])
def test_threefry_matches_jax_random(seed, shape):
    """Keys, raw bits and uniforms of fold_in(PRNGKey(17), seed) equal
    jax.random's bit for bit, and a slice drawn from an offset equals the
    same slice of the whole draw."""
    kj = jax.random.fold_in(jax.random.PRNGKey(17), seed)
    kp = threefry.fold_in(threefry.prng_key(17), seed)
    assert [int(x) for x in kp] == [int(x) for x in np.asarray(kj)]
    want = np.asarray(jax.random.uniform(kj, shape))
    got = threefry.uniform(kp, shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    bits = np.asarray(jax.random.bits(kj, shape, jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(kp, shape).numpy(),
                                  bits.astype(np.int64))
    if len(shape) > 1:
        part = threefry.uniform(kp, shape[1:],
                                offset=int(np.prod(shape[1:]))).numpy()
        np.testing.assert_array_equal(part.view(np.uint32),
                                      want[1].view(np.uint32))
    # a tensor seed (as the decoder passes it) folds in the same
    kt = threefry.fold_in(threefry.prng_key(17), torch.tensor(seed))
    assert [int(x) for x in kt] == [int(x) for x in kp]


# --------------------------------------------------------------------------
# Reed-Solomon
# --------------------------------------------------------------------------

def _rs_words(rng, n_words: int, k: int, fcr: int):
    """Codewords with random errors and erasures, a tenth pure noise."""
    rs = jrs64.RS63(k, fcr=fcr)
    words = np.zeros((n_words, 63), np.int64)
    eras = np.zeros((n_words, 63), bool)
    for i in range(n_words):
        w = rs.encode(rng.integers(0, 64, k))
        n_err, n_era = rng.integers(0, 30), rng.integers(0, 52)
        pos = rng.permutation(63)
        w[pos[:n_err]] ^= rng.integers(1, 64, n_err)
        eras[i, pos[n_err // 2 : n_err // 2 + n_era]] = True
        words[i] = rng.integers(0, 64, 63) if i % 10 == 0 else w
    return words, eras


def test_rs_ee_decode_matches_jax():
    k, fcr = 12, 3                                # JT65's RS(63,12)
    words, eras = _rs_words(np.random.default_rng(k), 2000, k, fcr)
    cj, okj = jrs.rs_ee_decode((63, k, fcr), (), None,
                               jnp.asarray(words, jnp.int32),
                               jnp.asarray(eras))
    cp, okp = rs_device.rs_ee_decode((63, k, fcr), torch.from_numpy(words),
                                     torch.from_numpy(eras))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    # both outcomes occur, and every ok word is a codeword
    assert 0.2 < okp.float().mean() < 0.95


def test_gf_tables_match_jax():
    a = jnp.arange(64)
    mul, inv = rs_device.gf_tables()
    np.testing.assert_array_equal(
        mul, np.asarray(jrs.gmul(a[:, None], a[None, :])))
    np.testing.assert_array_equal(inv, np.asarray(jrs.ginv(a)))
    np.testing.assert_array_equal(mul, jqra._mul_table())
    t = torch.arange(64)
    np.testing.assert_array_equal(
        rs_device.gmul(t[:, None], t[None, :]).numpy(), mul)
    np.testing.assert_array_equal(rs_device.ginv(t).numpy(), inv)


def _jt65_windows() -> np.ndarray:
    """Two seeded JT65 windows: two signals (about -19 dB each), noise
    only."""
    rng = np.random.default_rng(65)
    w0 = (jjt65.synthesize("K1ABC W9XYZ EN37", 1270.5)
          + jjt65.synthesize("CQ W2AXR FN13", 800.0, start_s=1.5))
    w0 = add_noise_at_snr(w0, -16.0, 12_000, rng)
    w1 = rng.standard_normal(w0.shape[0])
    return np.stack([w0, w1]).astype(np.float32)


@pytest.fixture(scope="module")
def jt65_demod():
    """A JAX JT65 decode's demod outputs in the codeword domain, and the
    reference's seed for them."""
    out = jjt65.JT65Decoder(top_k=8).decode_arrays(_jt65_windows())
    p, dm = jjt65.ILV, jjt65.UNGRAY
    syms = dm[out["symbols"][:, :, p]]
    top_tone = dm[out["top_tone"][:, :, p]]
    c = syms.shape[0] * syms.shape[1]
    seed = int(np.sum(out["t0_hop"], dtype=np.int32)) & 0x7FFFFFFF
    return (syms.reshape(c, -1).astype(np.int32),
            out["margin"][:, :, p].reshape(c, -1),
            out["top_e"][:, :, p].reshape(c, 63, 4),
            top_tone.reshape(c, 63, 4).astype(np.int32),
            out["e_sum"][:, :, p].reshape(c, -1), seed)


def test_rs_chase_program_matches_jax(jt65_demod):
    syms, margin, top_e, top_tone, e_sum, seed = jt65_demod
    ij, sj, okj = jrs.rs_chase_program((63, 12, 3), 256, 6, 0.4, syms, margin,
                                       top_e, top_tone, e_sum, seed)
    args = [torch.from_numpy(np.asarray(x)) for x in
            (syms.astype(np.int64), margin, top_e,
             top_tone.astype(np.int64), e_sum)]
    ip, sp, okp = rs_device.rs_chase_program((63, 12, 3), 256, 6, 0.4,
                                             *args, torch.tensor(seed))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert okp.sum() >= 2                      # both signals' candidates
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    sj = np.asarray(sj)
    fin = np.isfinite(sj)
    np.testing.assert_array_equal(np.isfinite(sp.numpy()), fin)
    np.testing.assert_allclose(sp.numpy()[fin], sj[fin], rtol=0, atol=1e-5)


def test_rs_chase_patterns_chunk_invariant(jt65_demod, monkeypatch):
    """Decoding the candidates in several chunks draws each chunk's slice
    of the one stochastic draw: the same outputs as one chunk."""
    syms, margin, top_e, top_tone, e_sum, seed = jt65_demod
    args = [torch.from_numpy(np.asarray(x)) for x in
            (syms.astype(np.int64), margin, top_e,
             top_tone.astype(np.int64), e_sum)]
    whole = rs_device.rs_chase_program((63, 12, 3), 256, 6, 0.4, *args, seed)
    monkeypatch.setattr(rs_device, "TRIALS_PER_CALL", 256 * 5)
    parts = rs_device.rs_chase_program((63, 12, 3), 256, 6, 0.4, *args, seed)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@jax.jit
def _jax_chase_flags(margin, seed):
    """The JAX package's erasure flags (``rs_chase_program``'s lines
    :245-262 for JT65's 256 trials, 6 deterministic), compiled as there."""
    n, nroots, n_trials = 63, 51, 256
    c = margin.shape[0]
    order = jnp.argsort(margin, axis=1)
    rank = jnp.zeros((c, n), jnp.int32).at[
        jnp.arange(c)[:, None], order].set(jnp.arange(n, dtype=jnp.int32))
    det = jnp.stack([rank < f for f in jrs.DET_TIERS[:6]], axis=1)
    n_sto = n_trials - det.shape[1]
    key = jax.random.fold_in(jax.random.PRNGKey(17), seed)
    u = jax.random.uniform(key, (c, n_sto, n))
    depth = jnp.linspace(nroots - 14.0, nroots - 2.0, n_sto)
    p = (0.9 - 0.8 * rank.astype(jnp.float32) / (n - 1))[:, None, :]
    psum = jnp.sum(p, axis=2, keepdims=True)
    p = p * (depth[None, :, None] / psum)
    return jnp.concatenate([det, u < p], axis=1), depth, psum[:, 0, 0]


def _planted_margins(margin: np.ndarray) -> np.ndarray:
    """The demod's margins with ties planted: equal margins inside a row,
    a row of one value, zeros of both signs."""
    m = margin.copy()
    m[0, 5:25] = m[0, 5]
    m[1] = 0.25
    m[2, ::3] = 0.0
    m[2, 1::3] = -0.0
    return m


def test_chase_erasures_match_jax_bitwise(jt65_demod):
    """The plain erasure flags of the demod's candidates (ties planted),
    whole and as the chunks the program draws (c0 > 0), bit for bit the
    JAX program's ``u < p`` and deterministic tiers; its depths, rank
    weights and windowed row sums are the compiled program's."""
    _syms, margin, *_rest, seed = jt65_demod
    margin = _planted_margins(margin)
    want, depth, psum = (np.asarray(x) for x in
                         _jax_chase_flags(jnp.asarray(margin), seed))
    np.testing.assert_array_equal(rs_device.chase_depth(51, 250).view(
        np.uint32), depth.view(np.uint32))
    rank = rs_device.confidence_rank(torch.from_numpy(margin))
    got_sum = rs_device.windowed_row_sum(
        torch.from_numpy(rs_device.chase_base_p(63))[rank]).numpy()
    np.testing.assert_array_equal(got_sum.view(np.uint32),
                                  psum.view(np.uint32))
    got = rs_device.chase_erasures_plain(51, 256, 6, torch.from_numpy(margin),
                                         torch.tensor(seed))
    np.testing.assert_array_equal(got.numpy(), want)
    c0 = 5
    part = rs_device.chase_erasures_plain(
        51, 256, 6, torch.from_numpy(margin[c0 : c0 + 4]), seed, c0)
    np.testing.assert_array_equal(part.numpy(), want[c0 : c0 + 4])


def test_chase_weights_match_jax_on_every_order():
    """The rank weights' row sum in the fixed window order equals the JAX
    program's on 2,000 random confidence orders (the weights are one set;
    only the order of the sum moves its last bit)."""
    rng = np.random.default_rng(25)
    margin = rng.standard_normal((2000, 63)).astype(np.float32)
    _flags, _depth, psum = _jax_chase_flags(jnp.asarray(margin), 3)
    rank = rs_device.confidence_rank(torch.from_numpy(margin))
    got = rs_device.windowed_row_sum(
        torch.from_numpy(rs_device.chase_base_p(63))[rank]).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(psum).view(np.uint32))
    # the sum does move with the order: one fixed order is needed
    assert len(np.unique(got)) > 1


def test_chase_stages_match_jax(jt65_demod):
    """The three plain stages on the demod's candidates: the flags, the RS
    decode and the score with its selection give the JAX program's info
    and ok, and its score within 1e-5."""
    syms, margin, top_e, top_tone, e_sum, seed = jt65_demod
    ij, sj, okj = jrs.rs_chase_program((63, 12, 3), 256, 6, 0.4, syms, margin,
                                       top_e, top_tone, e_sum, seed)
    era = rs_device.chase_erasures_plain(51, 256, 6, torch.from_numpy(margin),
                                         seed)
    corrected, ok = rs_device.rs_ee_trials_plain(
        (63, 12, 3), torch.from_numpy(syms.astype(np.int64)), era)
    ip, sp, okp = rs_device.chase_score_plain(
        12, 0.4, corrected, ok, era, torch.from_numpy(top_e),
        torch.from_numpy(top_tone.astype(np.int64)), torch.from_numpy(e_sum))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    sj = np.asarray(sj)
    fin = np.isfinite(sj)
    np.testing.assert_array_equal(np.isfinite(sp.numpy()), fin)
    np.testing.assert_allclose(sp.numpy()[fin], sj[fin], rtol=0, atol=1e-5)


def _jax_symbols(spec, power, t0, f0):
    """The JAX package's tone gather and top-4 (``qary_decode_program``'s
    lines :123-135) on a given power map."""
    data_syms = jnp.asarray(spec.data_syms, jnp.int32)
    sym_hops = t0[:, :, None] + spec.os_t * data_syms[None, None, :]
    tone_bins = (f0[:, :, None] + spec.os_f * (
        spec.tone_offset + jnp.arange(spec.n_tones, dtype=jnp.int32))[
            None, None, :])
    bb = jnp.arange(power.shape[0])[:, None, None, None]
    e = power[bb, sym_hops[:, :, :, None], tone_bins[:, :, None, :]]
    top_e, top_tone = jax.lax.top_k(e, 4)
    margin = (jnp.log(top_e[..., 0] + 1e-30)
              - jnp.log(top_e[..., 1] + 1e-30))
    return e, top_e, top_tone, jnp.sum(e, axis=-1), margin


@pytest.mark.parametrize("branch", ["jt65-rfft", "q65-dft"])
def test_symbol_energies_match_jax(branch, monkeypatch):
    """The plain tone gather and top-4 on the power map and candidates the
    decoder hands it (each spectrogram branch), with a planted tie of the
    two best tones and a tie below them: e, top_e and top_tone bit for bit
    JAX's, e_sum (the halving sum) within 2^-22 relative and the margin
    within 1e-6 of JAX's."""
    if branch == "jt65-rfft":
        wins, pd = _jt65_windows()[:1], _Rfft(top_k=4, device="cpu")
    else:
        wins, pd = _q65_windows()[:1], q65.Q65Decoder(top_k=4, device="cpu")
    assert pd.spectrogram_branch == branch.split("-")[1]
    seen = []
    energies = qary_engine._symbol_energies

    def record(spec, power, t0, f0, data_syms):
        seen.append((spec, power, t0, f0))
        return energies(spec, power, t0, f0, data_syms)

    monkeypatch.setattr(qary_engine, "_symbol_energies", record)
    pd.decode_arrays(wins)
    spec, power, t0, f0 = seen[0]
    power = power.clone()
    # plant: candidate 0's first data symbol gets tones 7 and 3 equal and
    # largest, tones 20 and 40 equal below them
    h = int(t0[0, 0]) + spec.os_t * spec.data_syms[0]
    bins = int(f0[0, 0]) + spec.os_f * (spec.tone_offset + np.arange(64))
    row = power[0, h, bins]
    top = float(row.max()) * 2
    power[0, h, bins[[3, 7]]] = top
    power[0, h, bins[[20, 40]]] = top * 0.75
    tabs = {"data_syms": torch.tensor(spec.data_syms, dtype=torch.int32)}
    e, top_e, top_tone, e_sum, margin = qary_engine._symbol_energies_plain(
        spec, power, t0, f0, tabs["data_syms"])
    want = [np.asarray(x) for x in _jax_symbols(
        spec, jnp.asarray(power.numpy()), jnp.asarray(t0.numpy()),
        jnp.asarray(f0.numpy()))]
    assert (e is not None) == spec.full_e
    if e is not None:
        np.testing.assert_array_equal(e.numpy(), want[0])
    np.testing.assert_array_equal(top_e.numpy(), want[1])
    np.testing.assert_array_equal(top_tone.numpy(), want[2])
    assert top_tone[0, 0, 0].tolist() == [3, 7, 20, 40]
    np.testing.assert_allclose(e_sum.numpy(), want[3], rtol=2.0 ** -22)
    np.testing.assert_allclose(margin.numpy(), want[4], rtol=0, atol=1e-6)
    assert margin[0, 0, 0] == 0.0


# --------------------------------------------------------------------------
# demod, priors, message passing
# --------------------------------------------------------------------------

class _JaxRfft(jjt65.JT65Decoder):
    DFT_MAT_BYTES_MAX = 0


class _Rfft(jt65.JT65Decoder):
    DFT_MAT_BYTES_MAX = 0


def _q65_windows() -> np.ndarray:
    """Two seeded Q65-30 windows: a -21 dB signal, noise only."""
    rng = np.random.default_rng(30)
    w0 = add_noise_at_snr(jq65.synthesize("CQ W2AXR FN13", 1200.0), -21.0,
                          12_000, rng)
    return np.stack([w0, rng.standard_normal(w0.shape[0])]).astype(np.float32)


@pytest.mark.parametrize("branch", ["jt65-rfft", "q65-dft"])
def test_qary_decode_program_matches_jax(branch):
    if branch == "jt65-rfft":
        wins = _jt65_windows()[:1]
        jd, pd = _JaxRfft(top_k=8), _Rfft(top_k=8, device="cpu")
    else:
        wins = _q65_windows()
        jd, pd = jq65.Q65Decoder(top_k=8), q65.Q65Decoder(top_k=8,
                                                          device="cpu")
    assert pd.spectrogram_branch == branch.split("-")[1]
    assert (jd._dft_mat is None) == (branch == "jt65-rfft")
    assert pd.max_device_batch == jd.max_device_batch
    want = jd.decode_arrays(wins)
    got = pd.decode_arrays(wins)
    assert set(got) == set(want)
    for key in ("t0_hop", "f0_bin", "top_tone", "symbols"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    energies = ["top_e", "e_sum"] + (["e"] if "e" in want else [])
    for key in energies + ["score"]:
        w = want[key]
        if branch == "jt65-rfft":
            np.testing.assert_allclose(got[key], w, rtol=1e-4, err_msg=key)
        else:
            tol = 2.0 ** -7 * np.abs(w) + 1e-5 * np.abs(w).max()
            assert np.all(np.abs(got[key] - w) <= tol), key
    np.testing.assert_allclose(got["snr"], want["snr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["margin"], want["margin"], rtol=0,
                               atol=2e-2 if branch == "q65-dft" else 1e-3)


@pytest.fixture(scope="module")
def q65_energies():
    return jq65.Q65Decoder(top_k=8).decode_arrays(_q65_windows())["e"]


def test_mp_priors_match_jax(q65_energies):
    v = qary_engine.QaryDecoder.MP_VARIANTS
    assert v == jqe.QaryDecoder.MP_VARIANTS
    want = np.asarray(jqe._mp_priors(v, jnp.asarray(q65_energies)))
    got = qary_engine._mp_priors(v, torch.from_numpy(q65_energies)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_qary_mp_decode_matches_jax(q65_energies):
    """Message passing on the priors of a Q65 decode (a converging signal
    candidate among noise candidates): syndrome flags identical; where the
    syndrome holds, hard decisions identical and confidence within 1e-4;
    and the decoder's packed output (best converging variant's codeword,
    flag, metadata) identical.  A candidate that does not converge keeps
    hard decisions that hang on the float32 summation order of 60
    iterations; ``_mp_score_pack`` discards it."""
    probs = np.asarray(jqe._mp_priors(jqe.QaryDecoder.MP_VARIANTS,
                                      jnp.asarray(q65_energies)))
    probs = probs.reshape(-1, 63, 64)
    hj, okj, cj = (np.asarray(x) for x in
                   jq65._mp().decode(jnp.asarray(probs)))
    hp, okp, cp = (x.numpy() for x in
                   q65._mp(CPU).decode(torch.from_numpy(probs.copy())))
    np.testing.assert_array_equal(okp, okj)
    assert okp.any() and not okp.all()
    np.testing.assert_array_equal(hp[okj], hj[okj])
    np.testing.assert_allclose(cp[okj], cj[okj], rtol=0, atol=1e-4)

    bsz, top_k, n_data, _ = q65_energies.shape
    n_var = len(jqe.QaryDecoder.MP_VARIANTS)
    meta = [np.arange(bsz * top_k, dtype=np.float32).reshape(bsz, top_k),
            np.zeros((bsz, top_k), np.int32), np.ones((bsz, top_k), np.int32),
            np.full((bsz, top_k), -20.0, np.float32)]
    want = np.asarray(jqe._mp_score_pack(
        0.4, jnp.asarray(q65_energies),
        jnp.asarray(hj.reshape(bsz, top_k, n_var, n_data)),
        jnp.asarray(okj.reshape(bsz, top_k, n_var)),
        *(jnp.asarray(m) for m in meta)))
    got = qary_engine._mp_score_pack(
        0.4, torch.from_numpy(q65_energies),
        torch.from_numpy(hp.reshape(bsz, top_k, n_var, n_data)),
        torch.from_numpy(okp.reshape(bsz, top_k, n_var)),
        *(torch.from_numpy(m) for m in meta)).numpy()
    ok = want[..., n_data] > 0.5
    assert ok.any()
    np.testing.assert_array_equal(got[..., n_data], want[..., n_data])
    np.testing.assert_array_equal(got[ok], want[ok])


def test_protocol_code_matches_jax():
    """Encoders, message codecs and the RS code of both modes."""
    for text in ["K1ABC W9XYZ EN37", "CQ W2AXR FN13", "W9XYZ K1ABC -11",
                 "G4ABC K1ABC RR73"]:
        np.testing.assert_array_equal(jt65.encode_message(text),
                                      jjt65.encode_message(text))
        np.testing.assert_array_equal(q65.encode_message(text),
                                      jq65.encode_message(text))
        assert jt65.unpack_message(jt65.pack_message(text)) == \
            jjt65.unpack_message(jjt65.pack_message(text))
        assert q65.unpack_message(q65.pack_message(text)) == \
            jq65.unpack_message(jq65.pack_message(text))
    rng = np.random.default_rng(12)
    rs = jt65._RS
    for info in rng.integers(0, 64, (8, 12)):
        cw = rs.encode(info)
        np.testing.assert_array_equal(cw, jjt65._RS.encode(info))
        bad = cw.copy()
        bad[rng.permutation(63)[:10]] ^= 5
        np.testing.assert_array_equal(rs.decode(bad), info)
    assert jt65.SPEC == jt65.QarySpec(**{
        f: getattr(jjt65.SPEC, f) for f in jjt65.SPEC.__dataclass_fields__})
    assert q65.SPEC == q65.QarySpec(**{
        f: getattr(jq65.SPEC, f) for f in jq65.SPEC.__dataclass_fields__})


# --------------------------------------------------------------------------
# decode lists
# --------------------------------------------------------------------------

def _fixture(name: str) -> np.ndarray:
    audio, sr = read_wav(FIXTURES / name)
    assert sr == 12_000
    return np.asarray(audio, np.float32)


@pytest.mark.parametrize("mode", ["JT65", "Q65-30"])
def test_fixture_decode_lists_match_jax(mode):
    """The default decoders on the committed fixture: the reference's
    decode list, with the manifest message in it."""
    name = {"JT65": "jt65_m22db.wav", "Q65-30": "q65_m24db.wav"}[mode]
    jd, pd = {"JT65": (jjt65.JT65Decoder, jt65.JT65Decoder),
              "Q65-30": (jq65.Q65Decoder, q65.Q65Decoder)}[mode]
    jd, pd = jd(), pd(device="cpu")
    audio = _fixture(name)[None]
    want = jd.decode(audio)
    got = pd.decode(audio)
    assert MANIFEST[name]["message"] in [r.message for r in got[0]]
    assert_same_batch_decodes(got, want, pd.spec)


@pytest.mark.parametrize("mode", ["JT65", "Q65-30"])
def test_seeded_decode_lists_match_jax(mode):
    """Seeded windows at top_k 8 (signals, and a noise-only window that
    decodes nothing): the reference's decode lists.  JT65 goes in as a
    tensor (used as is), Q65-30 as host audio; both are float32 as the
    reference takes them."""
    if mode == "JT65":
        wins = _jt65_windows()
        jd, pd = jjt65.JT65Decoder(top_k=8), jt65.JT65Decoder(top_k=8,
                                                              device="cpu")
        got = pd.decode(torch.from_numpy(wins))
        n_min = 2
    else:
        wins = _q65_windows()
        jd, pd = jq65.Q65Decoder(top_k=8), q65.Q65Decoder(top_k=8,
                                                          device="cpu")
        got = pd.decode(wins)
        n_min = 1
    assert len(wins) <= jd.max_device_batch          # unpadded
    want = jd.decode(wins)
    assert sum(len(w) for w in want) >= n_min
    assert got[-1] == want[-1] == []                 # noise only
    assert_same_batch_decodes(got, want, pd.spec)


def test_decoders_refuse_audio_on_another_device():
    pd = q65.Q65Decoder(top_k=6, device="cpu")
    with pytest.raises(ValueError, match="decoder on"):
        pd.decode(torch.zeros(1, 360_000, device="meta"))
