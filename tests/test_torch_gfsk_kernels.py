"""The GFSK kernels' host side, on the CPU: their oracles (the plain burst
subtraction and coherent LLRs) against the JAX package at FT8, FT4, JS8 and
FST4-60 shapes, a NumPy model of the subtraction kernel's cumsum tree and
per-window burst loop held bit for bit to the plain version, a model of
its work queue, CPU dispatch to the plain versions, and the wrappers'
refusals, which come before any build."""

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
CHUNK = 256 * SCAN         # samples of one span block

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


def _levels(x: np.ndarray, n3: int):
    """span_levels over one window's span [S]: each thread's within-block
    prefixes [n3 * 256, 16] (zero padded), V1 [n3 * 256], V2 [n3 * 16] and
    V3 [n3], every sum sequential."""
    w0 = np.zeros(n3 * CHUNK, F32)
    w0[: x.size] = x
    w0 = np.add.accumulate(w0.reshape(-1, SCAN), axis=1)
    v1 = w0[:, -1]
    v2 = np.add.accumulate(v1.reshape(-1, SCAN), axis=1)[:, -1]
    v3 = np.add.accumulate(v2.reshape(-1, SCAN), axis=1)[:, -1]
    return w0, v1, v2, v3


def _block_prefix(v1, v2, p3, c: int, n1: int, n2: int) -> np.ndarray:
    """block_prefix: the exclusive level-1 prefix of each of span block c's
    256 threads, from the V1 and V2 entries it stages (V1 from 16 before
    the block, V2 from one V3 entry before) and the block's own scan P3 of
    V3: the level-2 prefixes at 16 c - 2 ... 16 c + 14 (E3 + W2), then
    each thread's E2 + W1."""
    j0, q0 = c * 256 - SCAN, c * SCAN - SCAN
    j = np.arange(j0, j0 + 256 + SCAN)
    st1 = np.where((j >= 0) & (j < n1), v1[np.clip(j, 0, v1.size - 1)],
                   F32(0))
    q = np.arange(q0, q0 + 2 * SCAN)
    st2 = np.where((q >= 0) & (q < n2), v2[np.clip(q, 0, v2.size - 1)],
                   F32(0))
    w2 = np.add.accumulate(st2.reshape(2, SCAN), axis=1)
    w1 = np.add.accumulate(st1.reshape(-1, SCAN), axis=1)
    qs = c * SCAN - 2 + np.arange(SCAN + 1)
    blk = np.maximum(qs, 0) // SCAN
    e3 = np.where(blk > 0, p3[np.maximum(blk - 1, 0)], F32(0))
    p2s = np.where(qs >= 0, e3 + w2[np.clip(blk - (c - 1), 0, 1), qs % SCAN],
                   F32(0))
    jt = c * 256 + np.arange(256)
    i = np.maximum(jt - 1, 0)
    g = i // SCAN
    e2 = np.where(g > 0, p2s[np.clip(g - 1 - (c * SCAN - 2), 0, SCAN)],
                  F32(0))
    e0 = e2 + w1[np.clip(g - (c * SCAN - 1), 0, SCAN), i % SCAN]
    return np.where((jt > 0) & (jt < n1), e0, F32(0))


def _p1_points(v1, v2, p3, idx: np.ndarray) -> np.ndarray:
    """p1_point at V1 indices idx: E2 + W1 with E2 = E3 + W2 from P3."""
    w1 = np.add.accumulate(v1.reshape(-1, SCAN), axis=1).reshape(-1)
    w2 = np.add.accumulate(v2.reshape(-1, SCAN), axis=1).reshape(-1)
    p2 = _exclusive(p3[None])[0].repeat(SCAN) + w2
    return _exclusive(p2[None])[0].repeat(SCAN)[idx] + w1[idx]


def _model_subtract(spec, audio: np.ndarray, params: np.ndarray,
                    gen_parity: np.ndarray, blocks: int = 3) -> np.ndarray:
    """The subtraction kernel in NumPy float32, as its blocks compute it:
    each window alone, burst by burst up to its first invalid burst, with
    ``blocks`` blocks a window.  A span pass gives each block the span
    blocks rank, rank + blocks, ...; between passes every block scans V3
    itself and makes its span blocks' level-1 prefixes (block_prefix); the
    estimates, which every block repeats on the same sums, run once here.
    Index arithmetic per sample as the kernel's."""
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

    def phase(tpad, fine, cf):
        """The span's phase: every block's scan of V3, then each of its
        span blocks' prefixes plus the threads' own sums."""
        acc = np.zeros(s_n, F32)
        for dd in (-1, 0, 1, 2):
            idx = np.clip((3 - dd) * sps + r_u - fine, 0, 5 * sps - 1)
            acc = acc + tpad[q_u + dd + 1] * pulse[idx]
        w0, v1, v2, v3 = _levels(acc * c_hmod + cf, n3)
        out = np.zeros(n3 * CHUNK, F32)
        for rank in range(blocks):
            p3 = _tree_scan(v3[None])[0]
            for c in range(rank, n3, blocks):
                e0 = _block_prefix(v1, v2, p3, c, n1, n2)
                out[c * CHUNK : (c + 1) * CHUNK] = (
                    e0[:, None] + w0[c * 256 : (c + 1) * 256]).reshape(-1)
        return out[:s_n]

    def lib(fn, w, *xs):
        """_lib on window w's row of arrays of the plain version's [B, ...]
        shape, so that each element sits where the plain version's does."""
        rows = []
        for x in xs:
            full = np.zeros((b_n,) + np.shape(x), F32)
            full[w] = x
            rows.append(full)
        return _lib(fn, *rows)[w]

    def synth(w, tpad, fine, cf):
        ph = phase(tpad, fine, cf)
        mask = ((u >= fine) & (u < fine + l_n)).astype(F32)
        return lib(torch.cos, w, ph) * mask, lib(torch.sin, w, ph) * mask

    def correlate(w, m_blk, zr, zi, fine):
        seg = res[w, m_blk * hop + u]
        bpos = fine + sps * np.arange(n_sym + 1)
        idx = np.maximum(bpos - 1, 0)
        out = []
        for x in (seg * zr, (-seg) * zi):
            w0, v1, v2, v3 = _levels(x, n3)
            p3 = _tree_scan(v3[None])[0]
            blk = idx // SCAN
            e = np.where(blk > 0, _p1_points(v1, v2, p3, np.maximum(blk - 1, 0)),
                         F32(0))
            out.append(np.where(bpos > 0, e + w0[blk, idx % SCAN], F32(0)))
        vr, vi = out
        return vr[1:] - vr[:-1], vi[1:] - vi[:-1]

    def df_same(w, cr, ci, same):
        pr = cr[1:] * cr[:-1] + ci[1:] * ci[:-1]
        pi = ci[1:] * cr[:-1] - cr[1:] * ci[:-1]
        srr = lib(lambda x: x.sum(-1), w, pr * same)
        sri = lib(lambda x: x.sum(-1), w, pi * same)
        df = lib(torch.atan2, w, sri, srr) / c_df
        keep = (same.sum() > 0) & (np.abs(df) < bin_hz)
        return np.where(keep, df, F32(0)), pr, pi

    def movsum(x):
        cs = _tree_scan(np.pad(x, (4, 3))[None])[0]
        return cs[7:] - cs[:-7]

    for w in range(b_n):
        for mi in range(n_m):
            p = params[w, mi]
            if p[k + 2] == 0:
                break                      # the window's last burst is done
            # setup: tones from the info bits
            info = p[:k].astype(F32)
            par = np.remainder(info @ gen_parity, F32(2))
            cw = np.concatenate([info, par])[: n_data * bps]
            v = np.zeros(n_data, np.int64)
            for bb in range(bps):
                v = 2 * v + cw[bb::bps].astype(np.int64)
            tones = tabs["template"].copy()
            tones[tabs["data_idx"]] = gray[v]
            tpad = np.concatenate([[F32(0)], tones[:1], tones, tones[-1:],
                                   [F32(0)]]).astype(F32)
            dtone = tones[1:] - tones[:-1]
            same = (dtone == 0).astype(F32)
            sel = ((np.abs(dtone) >= 1) & (np.abs(dtone) <= 3)).astype(F32)
            t0 = int(p[k])
            f0 = F32(p[k + 1]) * bin_hz
            m0 = min(max(t0 + margin, 0), nb_pad - n_blk_seg)

            # pass 0: df1, then dt and the refined start
            zr, zi = synth(w, tpad, 0, c_w * f0)
            cr, ci = correlate(w, m0, zr, zi, 0)
            df1, pr, pi = df_same(w, cr, ci, same)
            ang = two_pi * df1 * t_sym
            th = lib(torch.atan2, w, pi, pr) - ang
            th = lib(torch.atan2, w, lib(torch.sin, w, th),
                     lib(torch.cos, w, th))
            wgt = lib(torch.sqrt, w, pr * pr + pi * pi) * sel
            den = c_den * lib(lambda x: x.sum(-1), w, wgt * dtone * dtone)
            dt = lib(lambda x: x.sum(-1), w, wgt * th * dtone) / np.maximum(
                den, F32(1e-20))
            shift = int(np.clip(np.rint(dt * sr), -(sps - 1), sps - 1))
            start1 = t0 * hop - shift
            blk1 = start1 // hop
            fine1 = start1 - blk1 * hop
            m1 = min(max(blk1 + margin, 0), nb_pad - n_blk_seg)

            # pass 1: df2 and the gain
            zr, zi = synth(w, tpad, fine1, c_w * (f0 + df1))
            cr, ci = correlate(w, m1, zr, zi, fine1)
            df2, _, _ = df_same(w, cr, ci, same)
            cdf2 = c_w * df2
            uc = F32(fine1) + (np.arange(n_sym, dtype=F32) + F32(0.5)) * sps_f
            thc = cdf2 * (uc + F32(1))
            cc, sc = lib(torch.cos, w, thc), lib(torch.sin, w, thc)
            ctr = cr * cc + ci * sc
            cti = ci * cc - cr * sc
            s_lo = start1 + np.arange(n_sym) * sps
            cnt = (np.clip(s_lo + sps, 0, t_n) - np.clip(s_lo, 0, t_n)
                   ).astype(F32)
            den = np.maximum(movsum(cnt), F32(1))
            g_re = F32(2) * movsum(ctr) / den
            g_im = F32(2) * movsum(cti) / den

            # the subtraction, block by block over the span
            th2 = cdf2 * (u.astype(F32) + F32(1))
            ct, st = lib(torch.cos, w, th2), lib(torch.sin, w, th2)
            zr2 = zr * ct - zi * st
            zi2 = zi * ct + zr * st
            gk = np.where(r_u >= fine1, q_u, q_u - 1)
            gin = (gk >= 0) & (gk < n_sym)
            gkc = np.clip(gk, 0, n_sym - 1)
            amp_re = np.where(gin, g_re[gkc], F32(0))
            amp_im = np.where(gin, g_im[gkc], F32(0))
            sub = amp_re * zr2 - amp_im * zi2
            pos = blk1 * hop + u
            sub = sub * ((pos >= 0) & (pos < t_n)).astype(F32)
            wpos = m1 * hop + u
            res[w, wpos] = res[w, wpos] - sub
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
    """The NumPy model of the subtraction kernel as its blocks compute it
    (the cumsum tree cut into thread blocks and span blocks; three blocks a
    window, each scanning V3 itself and making its own span blocks'
    level-1 prefixes once; each window alone, stopping after its own last
    burst) gives the plain version's residual bit for bit."""
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
# model of the subtraction kernel's work queue (k_subtract, take_task)

N_PASSES = 5               # span passes of a burst step
QUEUE_SPARE = 1            # gfsk.cu queue_len: entries past one a pass


def _queue_model(counts, n_slots: int, n3: int, n_blocks: int, seed: int,
                 spare: int = QUEUE_SPARE) -> dict:
    """k_subtract's work queue in Python, its blocks interleaved at random
    between their shared-memory operations (seeded): the queue holds
    B * n_slots * N_PASSES + spare entries, as ``sub_ints`` sizes it, and
    a read past its end raises IndexError, as it would read the counts
    beyond it on the card.  Returns {(window, burst, pass): span blocks
    run} and the queue's counts."""
    b_n = len(counts)
    entries = [0] * (b_n * n_slots * N_PASSES + spare)
    nxt, done = [0] * b_n, [0] * b_n
    mi, pas = [0] * b_n, [0] * b_n
    q = {"head": 0, "tail": 0, "done": 0}
    runs: dict = {}

    def open_pass(w):
        done[w] = 0
        nxt[w] = 0
        entries[q["tail"]] = w + 1
        q["tail"] += 1

    def setup(w):
        if mi[w] >= n_slots or mi[w] >= counts[w]:
            q["done"] += 1
        else:
            open_pass(w)

    def block():
        while True:
            while True:                                 # take_task
                h = q["head"]
                yield
                e = entries[h]
                yield
                if e == 0:
                    if q["done"] >= b_n:
                        return
                    continue
                w = e - 1
                k = nxt[w]
                nxt[w] += 1
                yield
                if k < n3:
                    break
                if q["head"] == h:                      # atomicCAS
                    q["head"] = h + 1
                yield
            runs.setdefault((w, mi[w], pas[w]), []).append(k)
            yield
            done[w] += 1
            if done[w] == n3:                           # small_stage
                pas[w] += 1
                if pas[w] == N_PASSES:
                    pas[w] = 0
                    mi[w] += 1
                    setup(w)
                else:
                    open_pass(w)
            yield

    for w in range(b_n):
        setup(w)
    rng = np.random.default_rng(seed)
    live = [block() for _ in range(n_blocks)]
    for _ in range(10_000_000):
        if not live:
            break
        g = live[rng.integers(len(live))]
        try:
            next(g)
        except StopIteration:
            live.remove(g)
    assert not live, "the queue model did not finish"
    return {"runs": runs, **q}


# (bursts in each window, slots, span blocks a pass, blocks): every slot
# of every window filled, so that the queue takes every pass a call can
# open (one window; two; a crowded FT8 batch), and windows with free
# slots, one with none valid
QUEUE_CASES = [((4,), 4, 3, 2), ((3, 3), 3, 2, 5), ((16,) * 4, 16, 3, 7),
               ((2, 0, 1), 3, 4, 3)]


@pytest.mark.parametrize("counts,n_slots,n3,n_blocks", QUEUE_CASES,
                         ids=["1x4of4", "2x3of3", "4x16of16", "free-slots"])
def test_work_queue_model_runs_every_pass_once(counts, n_slots, n3,
                                               n_blocks):
    """In the model of k_subtract's work queue, every window runs each of
    its valid bursts' five passes, every span block of a pass once, and
    then stops; the head never reads past the queue, also when every slot
    of every window is a valid burst."""
    for seed in range(5):
        got = _queue_model(counts, n_slots, n3, n_blocks, seed)
        want = {(w, m, p) for w, c in enumerate(counts) for m in range(c)
                for p in range(N_PASSES)}
        assert set(got["runs"]) == want
        assert all(sorted(v) == list(range(n3))
                   for v in got["runs"].values())
        assert got["tail"] == N_PASSES * sum(counts)
        assert got["done"] == len(counts)


def test_work_queue_model_overruns_without_the_spare_entry():
    """The model sees the fault that the spare entry repairs: with a queue
    of exactly one entry a pass, a call whose windows fill every slot reads
    past its end once the last pass is taken."""
    with pytest.raises(IndexError):
        _queue_model((3, 3), 3, 2, 4, seed=0, spare=0)
    _queue_model((3, 2), 3, 2, 4, seed=0, spare=0)


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
