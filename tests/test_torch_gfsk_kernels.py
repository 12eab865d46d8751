"""The GFSK kernels' host side, on the CPU: their oracles (the plain burst
subtraction and coherent LLRs) against the JAX package at FT8, FT4, JS8 and
FST4-60 shapes, a NumPy model of the subtraction kernel's cumsum tree and
per-window burst loop held bit for bit to the plain version, CPU dispatch
to the plain versions, and the wrappers' refusals, which come before any
build."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

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
from cwsl_digi_tpu.modes import subtract as jsub
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import (_gfsk_kernels, fst4, ft4, ft8,
                                       gfsk_engine, js8, ldpc, subtract)

REPO = Path(__file__).resolve().parents[1]
F32 = np.float32
SCAN = 16

torch.set_num_threads(1)


def _modes():
    """(name, port spec, JAX spec, LDPC code) of each GFSK code shape."""
    return {"ft8": (ft8.SPEC, jft8.SPEC, ldpc.ft8_code()),
            "ft4": (ft4.SPEC, jft4.SPEC, ldpc.ft8_code()),
            "js8": (js8.SPEC, jjs8.SPEC, js8.js8_code()),
            "fst4-60": (fst4.make_spec(Mode.FST4_60),
                        jfst4.make_spec(jfst4.Mode.FST4_60),
                        ldpc.fst4_code())}


# (mode, bursts in each window): FT4 with 3 bursts in a window
SUB_CASES = [("ft8", (2, 1)), ("ft4", (3, 1)), ("js8", (1, 2)),
             ("fst4-60", (2,))]


@pytest.mark.parametrize("name,counts", SUB_CASES,
                         ids=[c[0] for c in SUB_CASES])
def test_subtract_plain_matches_jax(name, counts):
    """Same audio and params (bursts at -6 to -14 dB in noise, as the
    decoder hands them over): residual within 1e-3 of the window peak
    (float32 phase accumulation in another summation order), and the
    bursts really went."""
    spec, jspec, code = _modes()[name]
    audio, params, gp, clean = chip_smoke.burst_case(spec, code, counts,
                                                     seed=7)
    want = np.asarray(jsub.subtract_known(jspec, jnp.asarray(audio),
                                          jnp.asarray(params),
                                          jnp.asarray(gp)))
    got = subtract.subtract_known_plain(spec, torch.from_numpy(audio),
                                        torch.from_numpy(params),
                                        torch.from_numpy(gp)).numpy()
    peak = np.abs(audio).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-3 * peak)
    _assert_bursts_went(got, audio, clean)


def _assert_bursts_went(res, audio, clean):
    """What is left of the bursts is under a tenth of their energy."""
    left = res - (audio - clean)
    assert np.mean(left ** 2) < 0.1 * np.mean(clean ** 2)


@pytest.mark.parametrize("name", list(_modes()))
def test_llrs_plain_match_jax(name):
    """Same csym/rot: LLRs within atol 1e-3 after the std-3 scaling
    (float32 max-log sums in another order); FST4-60 with coh4."""
    spec, jspec, _ = _modes()[name]
    m = 24
    csym, rot = chip_smoke.noisy_csym(spec, m, seed=41)
    bitmaps = spec.bitmaps()
    want = np.asarray(jeng._multisym_llrs(jspec, jnp.asarray(csym),
                                          jnp.asarray(rot),
                                          jnp.asarray(bitmaps)))
    got = gfsk_engine._multisym_llrs_plain(
        spec, torch.from_numpy(csym), torch.from_numpy(rot),
        torch.from_numpy(bitmaps)).numpy()
    assert got.shape == (m, spec.n_bits)
    assert spec.coh4 == (name == "fst4-60")
    np.testing.assert_allclose(got, want, atol=1e-3)


# ---------------------------------------------------------------------------
# NumPy model of the subtraction kernel (csrc/gfsk.cu)


def _lib(fn, *xs) -> np.ndarray:
    """torch's CPU function on arrays of the plain version's shapes and
    layouts: the model takes the plain version's trig, square roots and
    short sums, whose rounding depends on the library and on an element's
    place in the tensor, so that it isolates the kernel's own structure."""
    return fn(*[torch.from_numpy(np.asarray(x)) for x in xs]).numpy()


def _seq_blocks(x: np.ndarray) -> np.ndarray:
    """[B, n] -> [B, ceil(n/16), 16] within-block sequential prefix sums,
    zero padded (a thread's level-0 block)."""
    b, n = x.shape
    nb = -(-n // SCAN)
    xp = np.zeros((b, nb * SCAN), F32)
    xp[:, :n] = x
    return np.add.accumulate(xp.reshape(b, nb, SCAN), axis=2)


def _tree_scan(v: np.ndarray) -> np.ndarray:
    """tree_scan: one block's reference-order cumsum of [B, n]."""
    n = v.shape[1]
    if n <= SCAN:
        return np.add.accumulate(v, axis=1)
    w = _seq_blocks(v)
    up = _tree_scan(w[:, :, -1])
    e = np.concatenate([np.zeros((v.shape[0], 1), F32), up[:, :-1]], axis=1)
    return (e[:, :, None] + w).reshape(v.shape[0], -1)[:, :n]


def _exclusive(p: np.ndarray) -> np.ndarray:
    return np.concatenate([np.zeros((p.shape[0], 1), F32), p[:, :-1]], axis=1)


def _span_cumsum(x: np.ndarray, n1: int, n2: int, n3: int) -> np.ndarray:
    """The kernel's decomposition of the cumsum over a span [B, S]: V1 per
    thread, V2 and V3 per block of 4096 samples (zero padded), the scan of
    V3, then E + W at levels 2, 1 and 0."""
    b, s = x.shape
    w0 = _seq_blocks(x)                                  # [B, n1, 16]
    v1 = np.zeros((b, n3 * 256), F32)
    v1[:, :n1] = w0[:, :, -1]
    w1 = np.add.accumulate(v1.reshape(b, n3 * SCAN, SCAN), axis=2)
    v2 = w1[:, :, -1]                                    # [B, n3 * 16]
    v3 = np.add.accumulate(v2.reshape(b, n3, SCAN), axis=2)[:, :, -1]
    p3 = _tree_scan(v3)
    w2 = np.add.accumulate(v2[:, :n2 + (-n2) % SCAN].reshape(b, -1, SCAN),
                           axis=2)
    p2 = (_exclusive(p3)[:, : w2.shape[1], None] + w2).reshape(b, -1)[:, :n2]
    p1 = (_exclusive(p2)[:, :, None] + w1[:, : -(-n1 // SCAN)]
          ).reshape(b, -1)[:, :n1]
    return (_exclusive(p1)[:, :, None] + w0).reshape(b, -1)[:, :s]


def _model_subtract(spec, audio: np.ndarray, params: np.ndarray,
                    gen_parity: np.ndarray) -> np.ndarray:
    """The subtraction kernel in NumPy float32: per burst step every
    window's setup, two fit passes (phase levels and scan, correlations,
    estimate) and the subtraction, each window stopping at its own first
    invalid burst; index arithmetic per sample as the kernel's."""
    b_n, t_n = audio.shape
    k = gen_parity.shape[0]
    n_m = params.shape[1]
    dims, consts = _gfsk_kernels.subtract_dims(
        spec, b_n, t_n, k, gen_parity.shape[1], n_m)
    (_, _, row, hop, sps, n_sym, s_n, l_n, n_blk_seg, margin, nb_pad, _, _,
     n_data, bps, _, _) = dims
    c_hmod, c_w, bin_hz, c_df, two_pi, t_sym, c_den, sr, sps_f = map(
        F32, consts)
    n1 = -(-s_n // SCAN)
    n2 = -(-n1 // SCAN)
    n3 = -(-n2 // SCAN)
    tabs = {key: v.numpy() for key, v in _gfsk_kernels._spec_tables(
        spec, torch.device("cpu")).items()}
    pulse, gray = tabs["pulse_pad"], tabs["gray"]
    res = np.zeros((b_n, row), F32)
    res[:, margin * hop : margin * hop + t_n] = audio
    u = np.arange(s_n)
    q_u, r_u = u // sps, u % sps
    rows = np.arange(b_n)[:, None]
    alive = np.ones(b_n, bool)

    def synth(tpad, fine, cf):
        acc = np.zeros((b_n, s_n), F32)
        for dd in (-1, 0, 1, 2):
            idx = np.clip((3 - dd) * sps + r_u[None] - fine[:, None], 0,
                          5 * sps - 1)
            acc = acc + tpad[rows, q_u[None] + dd + 1] * pulse[idx]
        phase = _span_cumsum(acc * c_hmod + cf[:, None], n1, n2, n3)
        mask = ((u[None] >= fine[:, None])
                & (u[None] < fine[:, None] + l_n)).astype(F32)
        return _lib(torch.cos, phase) * mask, _lib(torch.sin, phase) * mask

    def correlate(m_blk, zr, zi, fine):
        seg = res[rows, m_blk[:, None] * hop + u[None]]
        pr = _span_cumsum(seg * zr, n1, n2, n3)
        pi = _span_cumsum((-seg) * zi, n1, n2, n3)
        bpos = fine[:, None] + sps * np.arange(n_sym + 1)[None]
        idx = np.maximum(bpos - 1, 0)
        vr = np.where(bpos > 0, pr[rows, idx], F32(0))
        vi = np.where(bpos > 0, pi[rows, idx], F32(0))
        return vr[:, 1:] - vr[:, :-1], vi[:, 1:] - vi[:, :-1]

    def df_same(cr, ci, same):
        pr = cr[:, 1:] * cr[:, :-1] + ci[:, 1:] * ci[:, :-1]
        pi = ci[:, 1:] * cr[:, :-1] - cr[:, 1:] * ci[:, :-1]
        srr = _lib(lambda x: x.sum(-1), pr * same)
        sri = _lib(lambda x: x.sum(-1), pi * same)
        df = _lib(torch.atan2, sri, srr) / c_df
        keep = (same.sum(-1) > 0) & (np.abs(df) < bin_hz)
        return np.where(keep, df, F32(0)), pr, pi

    def movsum(x):
        cs = _tree_scan(np.pad(x, ((0, 0), (4, 3))))
        return cs[:, 7:] - cs[:, :-7]

    for mi in range(n_m):
        p = params[:, mi]
        alive &= p[:, k + 2] != 0
        if not alive.any():
            continue                      # every block returns at once
        # setup: tones from the info bits
        info = p[:, :k].astype(F32)
        par = np.remainder(info @ gen_parity, F32(2))
        cw = np.concatenate([info, par], axis=1)[:, : n_data * bps]
        v = np.zeros((b_n, n_data), np.int64)
        for bb in range(bps):
            v = 2 * v + cw[:, bb::bps].astype(np.int64)
        tones = np.tile(tabs["template"], (b_n, 1))
        tones[:, tabs["data_idx"]] = gray[v]
        tpad = np.concatenate([np.zeros((b_n, 1), F32), tones[:, :1], tones,
                               tones[:, -1:], np.zeros((b_n, 1), F32)], 1)
        dtone = tones[:, 1:] - tones[:, :-1]
        same = (dtone == 0).astype(F32)
        sel = ((np.abs(dtone) >= 1) & (np.abs(dtone) <= 3)).astype(F32)
        t0 = p[:, k].astype(np.int64)
        f0 = p[:, k + 1].astype(F32) * bin_hz
        start0 = t0 * hop
        m0 = np.clip(t0 + margin, 0, nb_pad - n_blk_seg)
        fine0 = np.zeros(b_n, np.int64)

        # pass 0: df1, then dt and the refined start
        zr, zi = synth(tpad, fine0, c_w * f0)
        cr, ci = correlate(m0, zr, zi, fine0)
        df1, pr, pi = df_same(cr, ci, same)
        ang = two_pi * df1[:, None] * t_sym
        th = _lib(torch.atan2, pi, pr) - ang
        th = _lib(torch.atan2, _lib(torch.sin, th), _lib(torch.cos, th))
        w = _lib(torch.sqrt, pr * pr + pi * pi) * sel
        den = c_den * _lib(lambda x: x.sum(-1), w * dtone * dtone)
        dt = _lib(lambda x: x.sum(-1), w * th * dtone) / np.maximum(
            den, F32(1e-20))
        shift = np.clip(np.rint(dt * sr).astype(np.int64), -(sps - 1),
                        sps - 1)
        start1 = start0 - shift
        blk1 = np.floor_divide(start1, hop)
        fine1 = start1 - blk1 * hop
        m1 = np.clip(blk1 + margin, 0, nb_pad - n_blk_seg)

        # pass 1: df2 and the gain
        zr, zi = synth(tpad, fine1, c_w * (f0 + df1))
        cr, ci = correlate(m1, zr, zi, fine1)
        df2, _, _ = df_same(cr, ci, same)
        cdf2 = c_w * df2
        uc = fine1[:, None].astype(F32) \
            + (np.arange(n_sym, dtype=F32)[None] + F32(0.5)) * sps_f
        thc = cdf2[:, None] * (uc + F32(1))
        cc, sc = _lib(torch.cos, thc), _lib(torch.sin, thc)
        ctr = cr * cc + ci * sc
        cti = ci * cc - cr * sc
        s_lo = start1[:, None] + np.arange(n_sym)[None] * sps
        cnt = (np.clip(s_lo + sps, 0, t_n) - np.clip(s_lo, 0, t_n)
               ).astype(F32)
        den = np.maximum(movsum(cnt), F32(1))
        g_re = F32(2) * movsum(ctr) / den
        g_im = F32(2) * movsum(cti) / den

        # the subtraction
        th2 = cdf2[:, None] * (u[None].astype(F32) + F32(1))
        ct, st = _lib(torch.cos, th2), _lib(torch.sin, th2)
        zr2 = zr * ct - zi * st
        zi2 = zi * ct + zr * st
        gk = np.where(r_u[None] >= fine1[:, None], q_u[None], q_u[None] - 1)
        gin = (gk >= 0) & (gk < n_sym)
        gkc = np.clip(gk, 0, n_sym - 1)
        amp_re = np.where(gin, g_re[rows, gkc], F32(0))
        amp_im = np.where(gin, g_im[rows, gkc], F32(0))
        sub = amp_re * zr2 - amp_im * zi2
        pos = blk1[:, None] * hop + u[None]
        sub = sub * ((pos >= 0) & (pos < t_n)).astype(F32)
        for b in np.flatnonzero(alive):
            wpos = m1[b] * hop + u
            res[b, wpos] = res[b, wpos] - sub[b]
    return res[:, margin * hop : margin * hop + t_n]


def _ft4_580():
    """An FT4-like spec with 580 samples a symbol (hop 145): its span,
    106 * 580 samples, is no multiple of 16, so the last level-0 block and
    the levels above it are zero padded."""
    return dataclasses.replace(ft4.SPEC, name="FT4-580", sps=580, os_t=4)


# (name, spec, code, bursts in each window): FT8's span holds 38 blocks of
# 4096 samples (a two-level scan of V3), FT4's 15 (one sequential level),
# FST4-60's 153; the FT4-580 span is ragged.  One window's bursts run out
# before the others'.
MODEL_CASES = [("ft8", ft8.SPEC, ldpc.ft8_code, (3, 1, 2)),
               ("ft4", ft4.SPEC, ldpc.ft8_code, (1, 3)),
               ("ft4-580", _ft4_580(), ldpc.ft8_code, (2, 1)),
               ("fst4-60", fst4.make_spec(Mode.FST4_60), ldpc.fst4_code,
                (1, 2))]


@pytest.mark.parametrize("name,spec,code,counts", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_kernel_model_equals_plain_bit_for_bit(name, spec, code, counts):
    """The NumPy model of the subtraction kernel (the cumsum tree cut into
    thread blocks, span blocks and one scan; each window's burst loop with
    its own early stop) gives the plain version's residual bit for bit."""
    audio, params, gp, clean = chip_smoke.burst_case(
        spec, code(), counts, seed=3, n_slots=max(counts) + 1)
    want = subtract.subtract_known_plain(
        spec, torch.from_numpy(audio), torch.from_numpy(params),
        torch.from_numpy(gp)).numpy()
    got = _model_subtract(spec, audio, params, gp)
    assert got.dtype == np.float32 and got.shape == audio.shape
    np.testing.assert_array_equal(got, want)
    _assert_bursts_went(got, audio, clean)


def test_model_tree_equals_the_reference_cumsum():
    """The span decomposition and the scan equal subtract._cumsum bit for
    bit at ragged lengths, for spans of 1 to 200 blocks of 4096."""
    rng = np.random.default_rng(5)
    for s in (4097, 61_480, 153_600, 625_968, 819_217):
        x = rng.uniform(-2, 2, (2, s)).astype(F32)
        n1 = -(-s // SCAN)
        n2 = -(-n1 // SCAN)
        n3 = -(-n2 // SCAN)
        want = subtract._cumsum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(_span_cumsum(x, n1, n2, n3), want)
    for n in (1, 16, 17, 255, 257, 5283):
        v = rng.uniform(-2, 2, (2, n)).astype(F32)
        np.testing.assert_array_equal(
            _tree_scan(v), subtract._cumsum(torch.from_numpy(v)).numpy())


# ---------------------------------------------------------------------------
# dispatch and refusals


@pytest.fixture
def no_build(monkeypatch):
    """Every refusal, and every CPU call, must come before the library is
    built or loaded."""
    def build():
        raise AssertionError("the library was built")

    monkeypatch.setattr(_gfsk_kernels, "load_library", build)


def test_cpu_tensors_run_the_plain_versions(no_build):
    """On CPU tensors the dispatchers run the plain versions (equal
    results), load no library and count no launch."""
    before = dict(_gfsk_kernels.launches)
    spec, code = ft4.SPEC, ldpc.ft8_code()
    audio, params, gp, _ = chip_smoke.burst_case(spec, code, (1,), seed=9)
    a, p, g = (torch.from_numpy(x) for x in (audio, params, gp))
    assert torch.equal(subtract.subtract_known(spec, a, p, g),
                       subtract.subtract_known_plain(spec, a, p, g))
    csym, rot = (torch.from_numpy(x) for x in chip_smoke.noisy_csym(spec, 6,
                                                                     seed=2))
    bm = torch.from_numpy(spec.bitmaps())
    assert torch.equal(gfsk_engine._multisym_llrs(spec, csym, rot, bm),
                       gfsk_engine._multisym_llrs_plain(spec, csym, rot, bm))
    assert _gfsk_kernels.launches == before
    assert _gfsk_kernels._lib is None


def test_non_cpu_tensors_never_run_the_plain_versions(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel wrappers,
    which refuse a device that is not CUDA: no fallback."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(subtract, "subtract_known_plain", plain)
    monkeypatch.setattr(gfsk_engine, "_multisym_llrs_plain", plain)
    spec = ft8.SPEC
    audio = torch.zeros((2, 180_000), device="meta")
    params = torch.zeros((2, 4, 94), dtype=torch.int32, device="meta")
    gp = torch.zeros((91, 83), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        subtract.subtract_known(spec, audio, params, gp)
    csym = torch.zeros((4, 79, 8), dtype=torch.complex64, device="meta")
    rot = torch.zeros(4, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gfsk_engine._multisym_llrs(spec, csym, rot,
                                   torch.zeros((3, 8), device="meta"))


def test_subtract_wrapper_refusals(no_build):
    """subtract_known refuses a CPU tensor, a wrong dtype or shape, a
    non-contiguous input, more than 64 bursts and a span of one block."""
    spec = ft8.SPEC
    audio = torch.zeros((2, 180_000))
    params = torch.zeros((2, 4, 94), dtype=torch.int32)
    gp = torch.zeros((91, 83))
    sub = _gfsk_kernels.subtract_known
    with pytest.raises(ValueError, match="CUDA"):
        sub(spec, audio, params, gp)
    with pytest.raises(ValueError, match="dtype"):
        sub(spec, audio.double(), params, gp)
    with pytest.raises(ValueError, match="dtype"):
        sub(spec, audio, params.long(), gp)
    with pytest.raises(ValueError, match="shape"):
        sub(spec, audio, torch.zeros((2, 4, 93), dtype=torch.int32), gp)
    with pytest.raises(ValueError, match="shape"):
        sub(spec, audio, torch.zeros((3, 4, 94), dtype=torch.int32), gp)
    with pytest.raises(ValueError, match="contiguous"):
        sub(spec, torch.zeros((180_000, 2)).T, params, gp)
    with pytest.raises(ValueError, match="at most 64"):
        sub(spec, audio, torch.zeros((2, 65, 94), dtype=torch.int32), gp)
    tiny = dataclasses.replace(spec, sps=48, n_sym=79)
    with pytest.raises(ValueError, match="span above 4096"):
        sub(tiny, audio, params, gp)


def test_llr_wrapper_refusals(no_build):
    """multisym_llrs refuses a CPU tensor, a wrong dtype or shape, T = 8
    with coh4, T outside {4, 8} and bits_per_sym outside {2, 3}."""
    spec = ft8.SPEC
    csym = torch.zeros((4, 79, 8), dtype=torch.complex64)
    rot = torch.zeros(4, dtype=torch.complex64)
    bm = torch.zeros((3, 8))
    llr = _gfsk_kernels.multisym_llrs
    with pytest.raises(ValueError, match="CUDA"):
        llr(spec, csym, rot, bm)
    with pytest.raises(ValueError, match="dtype"):
        llr(spec, csym.to(torch.complex128), rot, bm)
    with pytest.raises(ValueError, match="dtype"):
        llr(spec, csym, rot, bm.double())
    with pytest.raises(ValueError, match="shape"):
        llr(spec, csym, torch.zeros(5, dtype=torch.complex64), bm)
    with pytest.raises(ValueError, match="does not fit"):
        llr(spec, torch.zeros((4, 80, 8), dtype=torch.complex64), rot, bm)
    with pytest.raises(ValueError, match="coh4 with T=8"):
        llr(dataclasses.replace(spec, coh4=True), csym, rot, bm)
    with pytest.raises(ValueError, match="T in"):
        llr(spec, torch.zeros((4, 79, 16), dtype=torch.complex64), rot,
            torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="bits_per_sym"):
        llr(spec, csym, rot, torch.zeros((1, 8)))


def test_importing_the_kernel_module_builds_nothing():
    """A fresh interpreter imports the GFSK kernel module and decodes FT8
    on the CPU through two passes (the subtraction runs) with every build
    made to fail: no build, no library loaded, no launch counted."""
    code = (
        "from cwsl_digi_tpu_torch import kernel_build\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('built a library')\n"
        "kernel_build.build_library = kernel_build.nvcc = boom\n"
        "import torch\n"
        "from cwsl_digi_tpu_torch.modes import _gfsk_kernels, ft8\n"
        "d = ft8.FT8Decoder(top_k=16, device='cpu')\n"
        "w = ft8.synthesize('CQ K1ABC FN42', 1500.0)\n"
        "r = d.decode(torch.from_numpy(w[None]).float() * 1000, depth=2)\n"
        "assert [x.message for x in r[0]] == ['CQ K1ABC FN42'], r\n"
        "assert _gfsk_kernels._lib is None\n"
        "assert _gfsk_kernels.launches == "
        "{'subtract_known': 0, 'multisym_llrs': 0}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
