"""The coherent LLRs' spectrogram entry on the CPU: its plain version
(``gfsk_engine.candidate_llrs_plain``: block gather, rotation, LLRs)
against the JAX package's own expressions at FT8, FT4, JS8 and FST4W-120
with the clamps' edge cases; NumPy models of the LLR kernel's block staging
and of its cut (a group of T lanes a data symbol, the shared x_pn table,
the masked neighbours, the bit maxima of lane pairs) held bit for bit to
the plain version; and the entry's refusals, which come before any
build."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cwsl_digi_tpu.modes import fst4 as jfst4
from cwsl_digi_tpu.modes import ft4 as jft4
from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.modes import gfsk_engine as jeng
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import (_gfsk_kernels, fst4, ft4, ft8,
                                       gfsk_engine, js8)

F32 = np.float32

torch.set_num_threads(1)


def _cases():
    """name: (port spec, JAX spec, os_t_eff, fold_pairs): the refine
    branch's half hops (FT8, FT4, JS8) and FST4W-120's hops (coh4, the
    frequency correction without refine)."""
    fw = fst4.make_spec(Mode.FST4W_120)
    return {"ft8": (ft8.SPEC, jft8.SPEC, 2 * ft8.SPEC.os_t, True),
            "ft4": (ft4.SPEC, jft4.SPEC, 2 * ft4.SPEC.os_t, True),
            "js8": (js8.SPEC, jjs8.SPEC, 2 * js8.SPEC.os_t, True),
            "fst4w-120": (fw, jfst4.make_spec(jfst4.Mode.FST4W_120),
                          fw.os_t, True)}


def _jax_candidate_llrs(jspec, demod, tt, f0, os_t_eff, fold, bitmaps):
    """The reference's stage 4b (gfsk_engine.py:492-516: the relayout and
    the dynamic_slice gather), its rotation (:555-579) and its
    _multisym_llrs, with jnp on the same operands."""
    b = demod.shape[0]
    n_hops_src = demod.shape[1]
    hq = -(-n_hops_src // os_t_eff)
    fq = -(-demod.shape[2] // jspec.os_f)
    stft_r = jnp.pad(jnp.asarray(demod),
                     ((0, 0), (0, hq * os_t_eff - n_hops_src),
                      (0, fq * jspec.os_f - demod.shape[2])))
    stft_r = stft_r.reshape(b, hq, os_t_eff, fq, jspec.os_f)
    stft_r = stft_r.transpose(0, 2, 4, 3, 1)

    def slice_block(planes, tt_, ff):
        blk = jax.lax.dynamic_slice(
            planes, (tt_ % os_t_eff, ff % jspec.os_f,
                     ff // jspec.os_f, tt_ // os_t_eff),
            (1, 1, jspec.n_tones, jspec.n_sym))
        return blk[0, 0]

    csym = jax.vmap(jax.vmap(slice_block, in_axes=(None, 0, 0)))(
        stft_r, jnp.asarray(tt), jnp.asarray(f0)).transpose(0, 1, 3, 2)
    fmin_bin = int(jspec.fmin_hz / jspec.bin_hz)
    abs_bin = (jnp.asarray(f0) + fmin_bin).astype(jnp.float32)
    rot = jnp.exp(-2j * jnp.pi * abs_bin / jspec.os_f)
    if fold:
        by_sym = {int(s): int(t) for s, t in jspec.sync_cells}
        pairs = [(s, by_sym[s + 1], by_sym[s])
                 for s in sorted(by_sym) if s + 1 in by_sym]
        p_sym = jnp.asarray([p[0] for p in pairs], jnp.int32)
        p_tn = jnp.asarray([p[2] for p in pairs], jnp.int32)
        p_tn1 = jnp.asarray([p[1] for p in pairs], jnp.int32)
        z = jnp.sum(jnp.conj(csym[:, :, p_sym, p_tn])
                    * csym[:, :, p_sym + 1, p_tn1], axis=-1) * rot
        rot = rot * jnp.exp(-1j * jnp.angle(z))
    k = tt.shape[1]
    llr = jeng._multisym_llrs(
        jspec, csym.reshape(b * k, jspec.n_sym, jspec.n_tones),
        rot.reshape(-1), jnp.asarray(bitmaps))
    return np.asarray(llr).reshape(b, k, -1)


@pytest.mark.parametrize("name", list(_cases()))
def test_fused_plain_matches_jax(name):
    """Seeded spectrograms (noise and tone tracks) and candidates, the first
    five of each window at hop 0 and H - 1 and bin 0 and F - 1 (where the
    block start clamps and the zero padding is read): LLRs within atol 1e-3
    after the std-3 scaling (float32 max-log sums in another order)."""
    spec, jspec, os_t_eff, fold = _cases()[name]
    demod, tt, f0 = chip_smoke.noisy_demod(spec, 2, 12, os_t_eff, seed=71)
    bitmaps = spec.bitmaps()
    want = _jax_candidate_llrs(jspec, demod, tt, f0, os_t_eff, fold,
                               bitmaps)
    got = gfsk_engine.candidate_llrs(
        spec, torch.from_numpy(demod), torch.from_numpy(tt),
        torch.from_numpy(f0), os_t_eff, fold,
        torch.from_numpy(bitmaps)).numpy()
    assert got.shape == (2, 12, spec.n_bits)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-3)


# ---------------------------------------------------------------------------
# NumPy models of the LLR kernel (csrc/gfsk.cu k_llr)


def _floor_div(a: np.ndarray, b: int) -> np.ndarray:
    return np.floor_divide(a, b)


def _model_stage(spec, demod: np.ndarray, tt: np.ndarray, f0: np.ndarray,
                 os_t: int, os_f: int) -> np.ndarray:
    """The kernel's staging of each candidate's [n_sym, T] cells: the start
    hop and bin from its clamped quotient and remainder, every cell at
    h0 + os_t * s, b0 + os_f * t, 0 outside [H, F]."""
    b, h, f = demod.shape
    k = tt.shape[1]
    t = spec.n_tones
    hq, fq = -(-h // os_t), -(-f // os_f)
    qt, qf = _floor_div(tt, os_t), _floor_div(f0, os_f)
    h0 = np.clip(qt, 0, hq - spec.n_sym) * os_t + (tt - qt * os_t)
    b0 = np.clip(qf, 0, fq - t) * os_f + (f0 - qf * os_f)
    hops = h0[:, :, None, None] + os_t * np.arange(spec.n_sym)[:, None]
    bins = b0[:, :, None, None] + os_f * np.arange(t)
    inside = (hops < h) & (bins < f)
    w = np.arange(b)[:, None, None, None]
    cells = demod[w, np.minimum(hops, h - 1), np.minimum(bins, f - 1)]
    return np.where(inside, cells, 0).astype(np.complex64).reshape(
        b * k, spec.n_sym, t)


@pytest.mark.parametrize("name", list(_cases()))
def test_staging_model_equals_the_plain_gather(name):
    """The kernel's index arithmetic gives the plain gather's cells, bit for
    bit, edges included."""
    spec, _, os_t_eff, _ = _cases()[name]
    demod, tt, f0 = chip_smoke.noisy_demod(spec, 2, 12, os_t_eff, seed=72)
    want = gfsk_engine.gather_candidates(
        spec, torch.from_numpy(demod), torch.from_numpy(tt),
        torch.from_numpy(f0), os_t_eff).numpy().reshape(24, spec.n_sym, -1)
    got = _model_stage(spec, demod, tt, f0, os_t_eff, spec.os_f)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    # the third edge candidate reads the padding: some of its cells are 0
    assert np.all(np.any(got.reshape(2, 12, -1)[:, 2] == 0, axis=-1))


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cross(ar, ai, wr, wi):
    """2 Re(conj(a) w) in float32, as the kernel and the plain version."""
    return F32(2) * (ar * wr + ai * wi)


def _model_llrs(spec, csym: np.ndarray, rot: np.ndarray,
                bitmaps: np.ndarray) -> np.ndarray:
    """The LLR kernel's cut, vectorised over candidates: the data symbols
    in groups of T lanes, lane sm the middle tone sm.  A lane holds its
    column of x_ps and row of x_sn; the group shares x_pn (each lane
    writes its row) and, with coh4, x_p_nn, x_n_nn, x_pp_p and x_pp_n;
    |C|^2 is the plain version's abs() ** 2 of each cell; a tone the sync
    cells rule out is -inf; each window's terms are summed in the kernel's
    order, maxima in any; lane 2b + z takes the metrics' maxima over the
    tones whose bit b is z and lane 2b subtracts its partner's.  Returns
    the unscaled LLRs [M, n_bits]."""
    m, n_sym, t = csym.shape
    tabs = _gfsk_kernels._spec_tables(spec, torch.device("cpu"))
    allow = tabs["allow"].numpy()
    pad = 2
    cp_ = np.pad(csym, ((0, 0), (pad, pad), (0, 0)))
    re, im = cp_.real.astype(F32), cp_.imag.astype(F32)
    e1 = (torch.from_numpy(cp_).abs() ** 2).numpy()
    rr, ri = rot.real.astype(F32)[:, None], rot.imag.astype(F32)[:, None]
    r2 = _cmul(rr, ri, rr, ri)
    r3 = _cmul(*r2, rr, ri)
    r1 = (rr, ri)
    bit0 = bitmaps < 0.5                                  # [bps, T]
    tone = np.arange(t)
    out = np.zeros((m, len(spec.data_syms), spec.bits_per_sym), F32)

    def row(k):                                           # [M, T] x2
        return re[:, k + pad], im[:, k + pad]

    def e1_row(k, mask):                                  # masked |C|^2
        bits = (int(mask) >> tone) & 1
        return np.where(bits[None] == 1, e1[:, k + pad], F32(-np.inf))

    def table(a, b, rq):
        """rows a (lane p = row index), b (columns), rot rq: [M, T, T]."""
        w = _cmul(rq[0], rq[1], b[0], b[1])        # shared, a tone a lane
        return _cross(a[0][:, :, None], a[1][:, :, None], w[0][:, None, :],
                      w[1][:, None, :])

    for d, s in enumerate(spec.data_syms):
        ap, an, ap2, an2 = (allow[q, d] for q in range(4))
        cs, cp, cn = row(s), row(s - 1), row(s + 1)
        e1s = e1[:, s + pad]                              # lane sm's own
        e1p, e1n = e1_row(s - 1, ap), e1_row(s + 1, an)
        w = _cmul(rr, ri, cs[0], cs[1])                   # lane sm: r c_s[sm]
        xps = _cross(cp[0][:, None, :], cp[1][:, None, :], w[0][:, :, None],
                     w[1][:, :, None])                    # [M, sm, i]
        xsn = table(cs, cn, r1)                           # [M, sm, j]
        xpn = table(cp, cn, r2)                           # shared [p, n]
        e2p = e1s + np.max(e1p[:, None, :] + xps, axis=2)
        e2n = e1s + np.max(e1n[:, None, :] + xsn, axis=2)
        h = e1p[:, :, None] + e1s[:, None, :]             # [M, p, sm]
        tri = (h[:, :, :, None] + e1n[:, None, None, :]
               + xps.transpose(0, 2, 1)[:, :, :, None]
               + xsn[:, None, :, :] + xpn[:, :, None, :])  # [M, p, sm, n]
        mets = [e1s, e2p, e2n, np.max(tri, axis=(1, 3))]
        if spec.coh4:
            cp2, cn2 = row(s - 2), row(s + 2)
            e1p2, e1n2 = e1_row(s - 2, ap2), e1_row(s + 2, an2)
            xsnn = table(cs, cn2, r2)                     # [M, sm, q]
            w2 = _cmul(*r2, cs[0], cs[1])
            xpps = _cross(cp2[0][:, None, :], cp2[1][:, None, :],
                          w2[0][:, :, None], w2[1][:, :, None])  # [M, sm, q2]
            xpnn, xnnn = table(cp, cn2, r3), table(cn, cn2, r1)
            xppp, xppn = table(cp2, cp, r1), table(cp2, cn, r3)
            # window [s-1, s, s+1, s+2]: [M, p, sm, n, q]
            h4 = (e1p[:, :, None, None] + e1s[:, None, :, None]
                  + e1n[:, None, None, :])
            w4n = (h4[..., None] + e1n2[:, None, None, None, :]
                   + xps.transpose(0, 2, 1)[:, :, :, None, None]
                   + xpn[:, :, None, :, None] + xpnn[:, :, None, None, :]
                   + xsn[:, None, :, :, None] + xsnn[:, None, :, None, :]
                   + xnnn[:, None, None, :, :])
            # window [s-2, s-1, s, s+1]: [M, q2, p, sm, n]
            h4 = (e1p2[:, :, None, None] + e1p[:, None, :, None]
                  + e1s[:, None, None, :])
            w4p = (h4[..., None] + e1n[:, None, None, None, :]
                   + xppp[:, :, :, None, None]
                   + xpps.transpose(0, 2, 1)[:, :, None, :, None]
                   + xppn[:, :, None, None, :]
                   + xps.transpose(0, 2, 1)[:, None, :, :, None]
                   + xpn[:, None, :, None, :] + xsn[:, None, None, :, :])
            mets += [np.max(w4n, axis=(1, 3, 4)), np.max(w4p, axis=(1, 2, 4))]
        for b in range(spec.bits_per_sym):
            l = None
            for f in mets:
                m0 = np.max(np.where(bit0[b][None], f, F32(-1e30)), axis=1)
                m1 = np.max(np.where(~bit0[b][None], f, F32(-1e30)), axis=1)
                l = m0 - m1 if l is None else l + (m0 - m1)
            out[:, d, b] = l
    return out.reshape(m, -1)


def _scaled(l: np.ndarray) -> torch.Tensor:
    """The plain version's per-candidate scaling, on the model's LLRs."""
    llr = torch.from_numpy(l)
    peak = llr.abs().amax(dim=-1, keepdim=True)
    llr = llr / (peak + 1e-20)
    std = llr.std(dim=-1, correction=0, keepdim=True)
    return llr / (std + 1e-20) * 3.0


@pytest.mark.parametrize("name", ["ft8", "ft4", "js8", "fst4-60"])
def test_llr_kernel_model_equals_plain_bit_for_bit(name):
    """The model of the kernel's cut gives _multisym_llrs_plain's LLRs bit
    for bit on the same CPU operands (seeded symbol spectra and
    rotations); FST4-60 with its 4-symbol windows."""
    spec = {"ft8": ft8.SPEC, "ft4": ft4.SPEC, "js8": js8.SPEC,
            "fst4-60": fst4.make_spec(Mode.FST4_60)}[name]
    csym, rot = chip_smoke.noisy_csym(spec, 16, seed=73)
    bitmaps = spec.bitmaps()
    want = gfsk_engine._multisym_llrs_plain(
        spec, torch.from_numpy(csym), torch.from_numpy(rot),
        torch.from_numpy(bitmaps))
    got = _scaled(_model_llrs(spec, csym, rot, bitmaps))
    assert spec.coh4 == (name == "fst4-60")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# refusals


@pytest.fixture
def no_build(monkeypatch):
    def build():
        raise AssertionError("the library was built")

    monkeypatch.setattr(_gfsk_kernels, "load_library", build)


def test_fused_llr_wrapper_refusals(no_build):
    """candidate_llrs refuses a CPU tensor, a wrong dtype or shape of the
    spectrogram or the candidates, a spectrogram too short for a block at
    the hop stride, a stride below 1, too many symbols, and coh4 with
    T = 8, before any build."""
    spec = ft8.SPEC
    demod = torch.zeros((2, 1300, 50), dtype=torch.complex64)
    tt = torch.zeros((2, 4), dtype=torch.int64)
    bm = torch.from_numpy(spec.bitmaps())
    llr = _gfsk_kernels.candidate_llrs
    with pytest.raises(ValueError, match="CUDA"):
        llr(spec, demod, tt, tt, 16, True, bm)
    with pytest.raises(ValueError, match="dtype"):
        llr(spec, demod.to(torch.complex128), tt, tt, 16, True, bm)
    with pytest.raises(ValueError, match="dtype"):
        llr(spec, demod, tt.int(), tt, 16, True, bm)
    with pytest.raises(ValueError, match="shape"):
        llr(spec, demod, tt, torch.zeros((2, 5), dtype=torch.int64), 16,
            True, bm)
    with pytest.raises(ValueError, match="shape"):
        llr(spec, demod, torch.zeros((3, 4), dtype=torch.int64),
            torch.zeros((3, 4), dtype=torch.int64), 16, True, bm)
    with pytest.raises(ValueError, match="must be 3-"):
        llr(spec, demod[0], tt, tt, 16, True, bm)
    with pytest.raises(ValueError, match="holds no 79 x 8 block"):
        llr(spec, demod, tt, tt, 17, True, bm)
    with pytest.raises(ValueError, match="holds no 79 x 8 block"):
        llr(spec, demod[:, :, :28], tt, tt, 16, True, bm)
    with pytest.raises(ValueError, match="holds no"):
        llr(spec, demod, tt, tt, 0, True, bm)
    with pytest.raises(ValueError, match="at most 256"):
        llr(dataclasses.replace(spec, n_sym=257), demod, tt, tt, 16, True,
            bm)
    with pytest.raises(ValueError, match="coh4 with T=8"):
        llr(dataclasses.replace(spec, coh4=True), demod, tt, tt, 16, True,
            bm)
    with pytest.raises(ValueError, match="does not fit"):
        llr(spec, demod, tt, tt, 16, True, bm[:2])


def test_cpu_spectrogram_runs_the_plain_version(no_build):
    """On CPU tensors candidate_llrs runs the plain version (equal
    results), loads no library and counts no launch; on another device it
    goes to the kernel wrapper, which refuses a device that is not CUDA."""
    spec, _, os_t_eff, fold = _cases()["js8"]
    demod, tt, f0 = (torch.from_numpy(x) for x in
                     chip_smoke.noisy_demod(spec, 2, 6, os_t_eff, seed=74))
    bm = torch.from_numpy(spec.bitmaps())
    before = dict(_gfsk_kernels.launches)
    assert torch.equal(
        gfsk_engine.candidate_llrs(spec, demod, tt, f0, os_t_eff, fold, bm),
        gfsk_engine.candidate_llrs_plain(spec, demod, tt, f0, os_t_eff, fold,
                                         bm))
    assert _gfsk_kernels.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gfsk_engine.candidate_llrs(spec, demod.to("meta"), tt.to("meta"),
                                   f0.to("meta"), os_t_eff, fold,
                                   bm.to("meta"))
