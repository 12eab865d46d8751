"""The GFSK decode's sync search on the CPU: its plain version
(``gfsk_engine.sync_candidates_plain``: the sync score, the NMS, the hybrid
top-K and the half-hop refinement) against the JAX package's own
expressions at FT8, FT4, JS8, FST4-60 and FST4W-120 shapes; NumPy models of
the ``sync_select`` kernel (radix select, compaction in index order,
bitonic sort; the first port's one block a window and half and the
cluster of 8 or 16 blocks with its slices, summed histograms and ties
scanned over ranks), of the ``sync_score`` kernel's tiles and separable
NMS, and of the ``sync_refine`` kernel's row arithmetic held bit for bit
to the plain version (or max_pool2d); and the wrapper's routing and
refusals, which come before any build."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import fst4 as jfst4
from cwsl_digi_tpu.modes import ft4 as jft4
from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu_torch.constants import WAVE_SR, Mode
from cwsl_digi_tpu_torch.modes import (_sync_kernels, fst4, ft4, ft8,
                                       gfsk_engine, js8)

F32 = np.float32

torch.set_num_threads(1)


def _cases():
    """name: (port spec, JAX spec, refine): the refine branch of FT8, FT4
    and JS8, and FST4-60 and FST4W-120 (no refinement)."""
    return {"ft8": (ft8.SPEC, jft8.SPEC, True),
            "ft4": (ft4.SPEC, jft4.SPEC, True),
            "js8": (js8.SPEC, jjs8.SPEC, True),
            "fst4-60": (fst4.make_spec(Mode.FST4_60),
                        jfst4.make_spec(jfst4.Mode.FST4_60), False),
            "fst4w-120": (fst4.make_spec(Mode.FST4W_120),
                          jfst4.make_spec(jfst4.Mode.FST4W_120), False)}


def _shapes(spec, refine: bool) -> tuple[int, int, int, int]:
    """(n_hops, power rows, demod rows, bins) of one decode_program call."""
    n_samples = int(round(spec.trperiod * WAVE_SR))
    n_hops = (n_samples - spec.sps) // spec.hop + 1
    ph = spec.pad_hops
    n_bins = spec.bin_range[2]
    h_demod = 2 * n_hops - 1 + 4 * ph if refine else n_hops + 2 * ph
    return n_hops, n_hops + 2 * ph, h_demod, n_bins


def _jax_sync(jspec, power_sync, demod, n_hops, refine, n_f0):
    """The reference's stages 2-3 (gfsk_engine.py:435-473: the shifted-slice
    correlation, base over the real rows, the NMS reduce_window and two
    lax.top_k) and 4a (:517-551: the fine-grid map of bf16 |demod|^2 and
    its three lookups a candidate), with jnp on the same operands.
    Returns (top_val, top_idx, tt)."""
    ps = jnp.asarray(power_sync).astype(jnp.bfloat16)
    b = ps.shape[0]
    n_t0 = jspec.max_hops
    acc = jnp.zeros((b, n_t0, n_f0), jnp.float32)
    for sym, tone in jspec.sync_cells:
        h0, b0 = jspec.os_t * sym, jspec.os_f * tone
        acc = acc + jax.lax.slice(ps, (0, h0, b0),
                                  (b, h0 + n_t0, b0 + n_f0)
                                  ).astype(jnp.float32)
    real_rows = jax.lax.slice(
        ps, (0, jspec.pad_hops, 0),
        (b, jspec.pad_hops + n_hops, ps.shape[2])).astype(jnp.float32)
    base = jnp.mean(real_rows, axis=(1, 2), keepdims=True) \
        * len(jspec.sync_cells)
    score = acc / (base + 1e-30)
    flat = score.reshape(b, -1)
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max,
        (1, jspec.os_t + 1, jspec.os_f + 1), (1, 1, 1), "SAME")
    flat_nms = jnp.where(score >= neigh, score, 0.0).reshape(b, -1)
    k_nms = jspec.top_k // 2
    v1, i1 = jax.lax.top_k(flat_nms, k_nms)
    v2, i2 = jax.lax.top_k(flat, jspec.top_k - k_nms)
    top_val = jnp.concatenate([v1, v2], axis=1)
    top_idx = jnp.concatenate([i1, i2], axis=1)
    t0 = top_idx // n_f0
    f0 = top_idx % n_f0
    if not refine:
        return np.asarray(top_val), np.asarray(top_idx), np.asarray(t0)
    stft_f = jnp.asarray(demod)
    powf = jnp.pad((jnp.abs(stft_f) ** 2).astype(jnp.bfloat16),
                   ((0, 0), (1, 1), (0, 0)))
    n_tf = 2 * n_t0 + 1
    accf = jnp.zeros((b, n_tf, n_f0), jnp.float32)
    for sym, tone in jspec.sync_cells:
        h0, b0 = 2 * jspec.os_t * sym, jspec.os_f * tone
        accf = accf + jax.lax.slice(
            powf, (0, h0, b0), (b, h0 + n_tf, b0 + n_f0)).astype(jnp.float32)
    accf = accf.reshape(b, n_tf * n_f0)
    idx3 = ((2 * t0[:, :, None]
             + jnp.arange(3, dtype=t0.dtype)[None, None, :]) * n_f0
            + f0[:, :, None])
    e3 = jnp.take_along_axis(
        accf, idx3.reshape(b, -1), axis=1).reshape(b, jspec.top_k, 3)
    delta = jnp.argmax(e3, axis=-1).astype(t0.dtype) - 1
    tt = jnp.clip(2 * t0 + delta, 0, stft_f.shape[1] - 1)
    return np.asarray(top_val), np.asarray(top_idx), np.asarray(tt)


def _port_sync(spec, power_sync, demod, n_hops, refine):
    """The port's stages 2-4a on CPU tensors, base as decode_program forms
    it.  Returns (top_val, top_idx, tt) as numpy."""
    ps = torch.from_numpy(power_sync).to(torch.bfloat16)
    ph = spec.pad_hops
    real_rows = ps[:, ph : ph + n_hops].to(torch.float32)
    base = real_rows.mean(dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    top_val, t0, f0, tt, os_t_eff = gfsk_engine.sync_candidates(
        spec, ps, torch.from_numpy(demod), base, n_hops, refine)
    assert os_t_eff == (2 * spec.os_t if refine else spec.os_t)
    n_f0 = _sync_kernels.grid(spec)[1]
    return top_val.numpy(), (t0 * n_f0 + f0).numpy(), tt.numpy()


def _tracks(rng, spec, b: int, n_sig: int):
    """Random candidate starts of ``n_sig`` tone tracks a window: [(window,
    t0, f0)], the power map's row and bin of sync cell (0, 0)."""
    n_t0, n_f0 = _sync_kernels.grid(spec)
    out = []
    for w in range(b):
        for _ in range(n_sig):
            t0 = int(rng.integers(0, n_t0))
            f0 = int(rng.integers(0, n_f0))
            out.append((w, t0, f0))
    return out


def _operands(spec, refine: bool, kind: str, seed: int):
    """Seeded (power_sync float32 of bf16 values, demod complex64, n_hops)
    at the mode's decode_program shapes, two windows.

    kind "integer": small integers (exact in bf16; many exact ties), the
    second window all zero, integer re/im in the demod; kind "noise":
    exponential noise and complex Gaussian noise with tone tracks 3-12 dB
    above it along the sync cells."""
    rng = np.random.default_rng(seed)
    n_hops, h_pow, h_dem, n_bins = _shapes(spec, refine)
    b = 2
    if kind == "integer":
        power = rng.integers(0, 8, (b, h_pow, n_bins)).astype(F32)
        power[1] = 0.0
        dem = (rng.integers(-3, 4, (b, h_dem, n_bins))
               + 1j * rng.integers(-3, 4, (b, h_dem, n_bins)))
        return power, dem.astype(np.complex64), n_hops
    power = rng.exponential(1.0, (b, h_pow, n_bins)).astype(F32)
    dem = ((rng.standard_normal((b, h_dem, n_bins))
            + 1j * rng.standard_normal((b, h_dem, n_bins))) / np.sqrt(2))
    for w, row, col in _tracks(rng, spec, b, 6):
        amp = 10 ** (rng.uniform(0.3, 1.2))
        for sym, tone in spec.sync_cells:
            r, c = row + spec.os_t * sym, col + spec.os_f * tone
            power[w, r : r + 3, c] += amp * rng.uniform(0.5, 1.0, 3)
            if refine:
                rr = 2 * r + int(rng.integers(-1, 2))
                if 0 <= rr < h_dem:
                    dem[w, rr, c] += np.sqrt(amp) * np.exp(
                        2j * np.pi * rng.uniform())
    # the bf16 values both sides read
    power = torch.from_numpy(power).to(torch.bfloat16).to(
        torch.float32).numpy()
    return power, dem.astype(np.complex64), n_hops


def _near_ties(vals: np.ndarray, rtol: float) -> np.ndarray:
    """[B, K] True where a sorted value is within rtol of a neighbour in
    its half (the JAX package's mean sums in another order, so such
    candidates may swap)."""
    near = np.zeros(vals.shape, bool)
    d = np.abs(np.diff(vals, axis=1)) <= rtol * np.abs(vals[:, 1:])
    near[:, 1:] |= d
    near[:, :-1] |= d
    return near


@pytest.mark.parametrize("name", list(_cases()))
def test_plain_matches_jax_on_integer_maps(name):
    """Integer-valued bf16 power maps (many exact ties; the second window
    all zero, so every score ties at 0) and integer demod cells: top_idx,
    t0, f0 and tt identical to the JAX package's expressions, top_val
    within 1e-6 relative (the two means sum in other orders)."""
    spec, jspec, refine = _cases()[name]
    power, demod, n_hops = _operands(spec, refine, "integer", 11)
    n_f0 = _sync_kernels.grid(spec)[1]
    jv, ji, jt = _jax_sync(jspec, power, demod, n_hops, refine, n_f0)
    pv, pi, pt = _port_sync(spec, power, demod, n_hops, refine)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=0)
    assert np.all(pv[1] == 0.0) and np.all(pi[1, : spec.top_k // 2]
                                           == np.arange(spec.top_k // 2))


@pytest.mark.parametrize("name", list(_cases()))
def test_plain_matches_jax_on_noise_with_tracks(name):
    """Exponential noise with tone tracks along the sync cells (and, on the
    refine branch, complex noise with the tracks at a half-hop offset):
    indices and tt identical to the JAX package's wherever neighbouring
    scores differ by more than 1e-5 relative, and no near-tie difference
    on these seeds; top_val within 1e-6 relative."""
    spec, jspec, refine = _cases()[name]
    power, demod, n_hops = _operands(spec, refine, "noise", 12)
    n_f0 = _sync_kernels.grid(spec)[1]
    jv, ji, jt = _jax_sync(jspec, power, demod, n_hops, refine, n_f0)
    pv, pi, pt = _port_sync(spec, power, demod, n_hops, refine)
    near = _near_ties(pv, 1e-5)
    differ = (pi != ji) | (pt != jt)
    assert not np.any(differ & ~near), np.argwhere(differ & ~near)[:5]
    assert int(np.sum(differ & near)) == 0
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# a NumPy model of sync_select


def _sort_key(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 key: -0.0 as 0.0, every NaN
    above +inf."""
    u = x.astype(F32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    key = np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def _bitonic(buf: np.ndarray) -> np.ndarray:
    """The kernel's bitonic network (ascending) on a power-of-two array."""
    buf = buf.copy()
    p2 = buf.size
    size = 2
    while size <= p2:
        stride = size // 2
        while stride:
            i = np.arange(p2 // 2)
            lo = 2 * stride * (i // stride) + i % stride
            hi = lo + stride
            up = (lo & size) == 0
            a, c = buf[lo], buf[hi]
            swap = (a > c) == up
            buf[lo] = np.where(swap, c, a)
            buf[hi] = np.where(swap, a, c)
            stride //= 2
        size *= 2
    return buf


def _radix_digit(hist: np.ndarray, want: int) -> tuple[int, int]:
    """The digit whose count from the top first reaches ``want`` in a
    2048-bin histogram, and the count above it."""
    above = 0
    digit = 2047
    while above + hist[digit] < want:
        above += hist[digit]
        digit -= 1
    return digit, above


def _pairs(key: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(~key << 32 | index) as uint64 for the keys at ``idx``."""
    idx = np.asarray(idx, np.int64)
    return ((~key[idx]).astype(np.uint64) << np.uint64(32)) \
        | idx.astype(np.uint64)


def _sorted_pick(x: np.ndarray, comp: np.ndarray, k: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's last step: the bitonic sort of the k pairs padded to a
    power of two, then (values, indices) of the first k."""
    p2 = 1
    while p2 < k:
        p2 *= 2
    buf = np.concatenate([comp, np.full(p2 - k, ~np.uint64(0))])
    out = (_bitonic(buf)[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return x[out], out


def _select_model(x: np.ndarray, k: int, rng) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """The first-port sync_select on one map [n] (one block a window and
    half): radix passes of 11, 11 and 10 bits to the k-th key, the keys
    above it in any order (shuffled here), the first ties at it in index
    order, the bitonic sort of (~key << 32 | index) padded to a power of
    two.  Returns (values, indices)."""
    key = _sort_key(x)
    prefix, mask, want = 0, 0, k
    for shift, bits in ((21, 11), (10, 11), (0, 10)):
        dmask = (1 << bits) - 1
        hit = (key & np.uint32(mask)) == prefix
        hist = np.bincount((key[hit] >> np.uint32(shift)) & dmask,
                           minlength=2048)
        digit, above = _radix_digit(hist, want)
        prefix |= digit << shift
        mask |= dmask << shift
        want -= above
    kth = np.uint32(prefix)
    gt = np.nonzero(key > kth)[0]
    assert gt.size == k - want
    ties = np.nonzero(key == kth)[0][:want]
    comp = _pairs(key, np.concatenate([rng.permutation(gt), ties]))
    return _sorted_pick(x, comp, k)


def _cluster_select_model(x: np.ndarray, k: int, c: int, rng,
                          cap: int | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """sync_select as a cluster of ``c`` blocks on one map [n]: block r
    owns the r-th slice of ceil(n / c) keys (rank order is index order;
    the last slices may be short or empty); each pass every block counts
    its digits under the prefix, the counts are summed (rank 0's
    histogram) and the digit chosen from the sum.  After the first pass a
    block sends its keys above the first digit to the pair buffer and keeps
    those on it as candidates (up to ``cap`` a block, None: no limit;
    beyond it the later passes and the keys above K read the whole slice
    again, taking only keys on the first digit).  The pair buffer takes
    keys from every block in any order (shuffled here); block r's ties are
    its last histogram's count at K's digit, its first slot the sum of the
    counts below its rank, and it takes all its ties in any order
    (shuffled here) where they fit, else its first in index order up to
    those still open.  Returns (values, indices)."""
    key = _sort_key(x)
    n = key.size
    size = -(-n // c)
    los = [min(n, r * size) for r in range(c)]
    parts = [key[lo : min(n, lo + size)] for lo in los]
    prefix, mask, want = 0, 0, k
    above = []
    scans = parts
    for shift, bits in ((21, 11), (10, 11), (0, 10)):
        dmask = (1 << bits) - 1
        hists = [np.bincount((p[(p & np.uint32(mask)) == prefix]
                              >> np.uint32(shift)) & dmask, minlength=2048)
                 for p in scans]
        digit, count_above = _radix_digit(np.sum(hists, axis=0), want)
        prefix |= digit << shift
        mask |= dmask << shift
        want -= count_above
        if shift == 21:
            scans = []
            for lo, p in zip(los, parts):
                above.append(lo + np.nonzero((p >> np.uint32(21)) > digit)[0])
                on = p[(p >> np.uint32(21)) == digit]
                scans.append(p if cap is not None and on.size > cap else on)
    kth = np.uint32(prefix)
    n_gt = k - want
    gt = np.concatenate(above + [lo + np.nonzero(
        (p > kth) & ((p >> np.uint32(21)) == (kth >> np.uint32(21))))[0]
        for lo, p in zip(los, parts)]).astype(np.int64)
    assert gt.size == n_gt
    comp = np.zeros(k, np.uint64)
    comp[:n_gt] = _pairs(key, rng.permutation(gt))
    mine = [int(h[prefix & 0x3FF]) for h in hists]
    before = np.concatenate([[0], np.cumsum(mine)[:-1]])
    filled = n_gt
    for lo, p, m, bef in zip(los, parts, mine, before):
        if m == 0 or bef >= want:
            continue
        take = min(m, want - bef)
        idx = lo + np.nonzero(p == kth)[0][:take]
        assert idx.size == take
        if take == m:                  # all of them: in any order
            idx = rng.permutation(idx)
        comp[n_gt + bef : n_gt + bef + take] = _pairs(key, idx)
        filled += take
    assert filled == k
    return _sorted_pick(x, comp, k)


def _select_maps(rng, n: int) -> dict[str, np.ndarray]:
    """Maps that stress the order: integer ties, mostly zeros (an NMS
    map), +inf, -inf, NaN and -0.0 among noise, all equal."""
    ties = rng.integers(0, 6, n).astype(F32)
    nms = np.where(rng.random(n) < 0.01, rng.exponential(1, n), 0.0
                   ).astype(F32)
    odd = rng.standard_normal(n).astype(F32)
    odd[rng.choice(n, 40, replace=False)] = np.inf
    odd[rng.choice(n, 30, replace=False)] = -np.inf
    odd[rng.choice(n, 20, replace=False)] = np.nan
    odd[rng.choice(n, 50, replace=False)] = -0.0
    odd[rng.choice(n, 50, replace=False)] = 0.0
    return {"ties": ties, "nms": nms, "odd": odd,
            "constant": np.full(n, 1.5, F32)}


SELECT_MODELS = {
    "block": _select_model,
    "cluster 8": lambda x, k, rng: _cluster_select_model(x, k, 8, rng),
    "cluster 16": lambda x, k, rng: _cluster_select_model(x, k, 16, rng),
    "cluster 16 no room": lambda x, k, rng: _cluster_select_model(
        x, k, 16, rng, cap=0)}


@pytest.mark.parametrize("model", list(SELECT_MODELS))
@pytest.mark.parametrize("k", [1, 7, 64, 255, 1024, 4500, 16384])
def test_select_model_equals_top_k_bit_for_bit(k, model):
    """The kernel's selection, modelled in NumPy, picks exactly what
    ``_top_k`` (a stable descending sort) picks: the same indices and the
    same value bits (NaN payloads and -0.0 included), on ties, zeros,
    +inf, -inf, NaN and odd k, at the FT8 window's 459,008 scores and at
    k = n; the first port's one block a window and half, and the cluster
    of 8 and of 16 blocks (with the candidates under the first digit kept,
    and with no room for them: the whole slices read again), also on
    100,003 scores (no slice size divides them: the last slice is
    short)."""
    select = SELECT_MODELS[model]
    rng = np.random.default_rng(100 + k)
    sizes = [256 * 1793] + ([100_003] if model != "block" else [])
    for n in sizes:
        for name, x in _select_maps(rng, n).items():
            mv, mi = select(x, k, rng)
            tv, ti = gfsk_engine._top_k(torch.from_numpy(x)[None], k)
            np.testing.assert_array_equal(mi, ti[0].numpy(),
                                          err_msg=f"{name} {n}")
            np.testing.assert_array_equal(mv.view(np.uint32),
                                          tv[0].numpy().view(np.uint32),
                                          err_msg=f"{name} {n}")
    x = _select_maps(rng, max(k, 2048))["odd"][:k]
    mv, mi = select(x, k, rng)
    np.testing.assert_array_equal(
        mi, gfsk_engine._top_k(torch.from_numpy(x)[None], k)[1][0].numpy())


def test_select_model_lays_out_the_hybrid_halves():
    """The kernel's two blocks a window write the NMS map's top_k // 2 and
    the raw score's rest into one [B, top_k] row with t0 = idx // n_f0 and
    f0 = idx % n_f0: equal to sync_select_plain's top_val and top_idx at
    JS8's grid with an odd top_k."""
    spec = dataclasses.replace(js8.SPEC, top_k=97)
    n_t0, n_f0 = _sync_kernels.grid(spec)
    rng = np.random.default_rng(5)
    score = rng.integers(0, 40, (3, n_t0, n_f0)).astype(F32)
    score[2] = 0.0
    nms = np.where(rng.random(score.shape) < 0.05, score, 0.0).astype(F32)
    pv, pi = gfsk_engine.sync_select_plain(spec, torch.from_numpy(score),
                                           torch.from_numpy(nms))
    k_nms = spec.top_k // 2
    for b in range(3):
        v1, i1 = _select_model(nms[b].reshape(-1), k_nms, rng)
        v2, i2 = _select_model(score[b].reshape(-1), spec.top_k - k_nms, rng)
        np.testing.assert_array_equal(np.concatenate([i1, i2]),
                                      pi[b].numpy())
        np.testing.assert_array_equal(np.concatenate([v1, v2]),
                                      pv[b].numpy())


# ---------------------------------------------------------------------------
# a NumPy model of sync_score's tiles and separable NMS


SCORE_SIDE = 64        # sync.cu's score region, halo included


def _nan_max(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sync.cu's nan_max: a where a > b or a is NaN, else b."""
    return np.where((a > b) | np.isnan(a), a, b)


def _separable_nms_model(score: np.ndarray, os_t: int, os_f: int
                         ) -> np.ndarray:
    """sync_score's NMS on one map [n_t0, n_f0]: block (ty, tx) holds the
    64 x 64 region of scores from (ty (64 - os_t) - os_t / 2, tx (64 -
    os_f) - os_f / 2), -inf off the map; the max over each row's os_f + 1
    columns, then over os_t + 1 rows of those, both with nan_max; a score
    of the inner tile is kept where it is >= that max, else +0.0."""
    pt, pf = os_t // 2, os_f // 2
    out_t, out_f = SCORE_SIDE - 2 * pt, SCORE_SIDE - 2 * pf
    n_t0, n_f0 = score.shape
    nt, nf = -(-n_t0 // out_t), -(-n_f0 // out_f)
    pad = np.full((nt * out_t + 2 * pt, nf * out_f + 2 * pf), -np.inf, F32)
    pad[pt : pt + n_t0, pf : pf + n_f0] = score
    nms = np.empty_like(score)
    for ty in range(nt):
        for tx in range(nf):
            t_lo, f_lo = ty * out_t, tx * out_f
            tile = pad[t_lo : t_lo + SCORE_SIDE, f_lo : f_lo + SCORE_SIDE]
            rmax = tile[:, :out_f]
            for i in range(1, 2 * pf + 1):
                rmax = _nan_max(rmax, tile[:, i : i + out_f])
            m = rmax[:out_t]
            for i in range(1, 2 * pt + 1):
                m = _nan_max(m, rmax[i : i + out_t])
            s = tile[pt : pt + out_t, pf : pf + out_f]
            keep = np.where(s >= m, s, F32(0.0))
            rows = min(out_t, n_t0 - t_lo)
            cols = min(out_f, n_f0 - f_lo)
            nms[t_lo : t_lo + rows, f_lo : f_lo + cols] = keep[:rows, :cols]
    return nms


def _nms_maps(rng, shape) -> dict[str, np.ndarray]:
    """Score maps for the NMS: small integers (plateaus, ties across the
    tile seams), noise with NaN, +inf, -inf and -0.0 (some on the edges
    and corners), a constant map, and all NaN but one row."""
    ties = rng.integers(0, 4, shape).astype(F32)
    odd = rng.standard_normal(shape).astype(F32)
    flat = odd.reshape(-1)
    for val, count in ((np.nan, 25), (np.inf, 25), (-np.inf, 25),
                       (-0.0, 60), (0.0, 60)):
        flat[rng.choice(flat.size, min(count, flat.size // 8 + 1),
                        replace=False)] = val
    odd[0, 0], odd[-1, -1], odd[0, -1], odd[-1, 0] = (np.nan, np.inf,
                                                      -0.0, -np.inf)
    odd[-1, shape[1] // 2] = np.nan
    odd[shape[0] // 2, -1] = np.inf
    nan_rows = np.full(shape, np.nan, F32)
    nan_rows[3] = 1.0
    return {"ties": ties, "odd": odd, "constant": np.full(shape, 2.0, F32),
            "nan rows": nan_rows}


@pytest.mark.parametrize("os_t, os_f", [(8, 4), (4, 2)])
def test_separable_nms_model_equals_max_pool2d(os_t, os_f):
    """The score kernel's separable NMS, tiled as the kernel tiles it,
    equals sync_score_plain's max_pool2d mask (score >= neighbourhood max,
    else +0.0) bit for bit: plateaus keep all their members, a NaN score or
    neighbour masks, -0.0 compares as 0.0, and every edge and tile seam
    holds, on maps cut to no whole number of tiles (FT8's and JS8's
    geometries)."""
    rng = np.random.default_rng(40 + os_t)
    for shape in [(130, 151), (256, 200), (5, 3)]:
        for name, score in _nms_maps(rng, shape).items():
            t = torch.from_numpy(score)[None, None]
            neigh = torch.nn.functional.max_pool2d(
                t, kernel_size=(os_t + 1, os_f + 1), stride=1,
                padding=(os_t // 2, os_f // 2))[0, 0]
            want = torch.where(t[0, 0] >= neigh, t[0, 0], 0.0).numpy()
            got = _separable_nms_model(score, os_t, os_f)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32),
                                          err_msg=f"{name} {shape}")


# ---------------------------------------------------------------------------
# a NumPy model of sync_refine's row arithmetic


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 -> float32, to nearest even (torch's .to(bf16))."""
    u = x.astype(F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(F32)
    return np.where(np.isnan(x), F32(np.nan), out)


def _mag2(z: np.ndarray) -> np.ndarray:
    """|z|^2 as sync.cu's mag2: |z| the double square root of the exact
    products' sum, rounded to float32, squared in float32."""
    m = np.sqrt(z.real.astype(np.float64) ** 2
                + z.imag.astype(np.float64) ** 2).astype(F32)
    return m * m


def _first_max(e: list[np.ndarray]) -> np.ndarray:
    """The offset of the first maximum of e[0..2] elementwise, NaN counting
    as the maximum (sync.cu's compare chain, torch.argmax's rule)."""
    best = np.zeros(e[0].shape, np.int64)
    bv = e[0]
    for k in (1, 2):
        nan_k, nan_b = np.isnan(e[k]), np.isnan(bv)
        take = (nan_k & ~nan_b) | (~nan_b & (e[k] > bv))
        best = np.where(take, k, best)
        bv = np.where(take, e[k], bv)
    return best


def _offset_energy(spec, demod, t0, f0, j, dd) -> np.ndarray:
    """One thread's sum (j the candidate, dd the offset; arrays): the sync
    cells' bf16(|z|^2) in spec order from the first cell, rows outside
    [0, H) as 0 (the thread loads the window's first cell there and drops
    it)."""
    _, h, _ = demod.shape
    k = t0.shape[1]
    w, t, f = j // k, t0.reshape(-1)[j], f0.reshape(-1)[j]
    r0 = 2 * t + dd - 1
    e = None
    for sym, tone in spec.sync_cells:
        r = 2 * spec.os_t * sym + r0
        inside = (r >= 0) & (r < h)
        z = demod[w, np.where(inside, r, 0),
                  np.where(inside, f + spec.os_f * tone, 0)]
        v = np.where(inside, _bf16_round(_mag2(z)), F32(0.0))
        e = v if e is None else (e + v).astype(F32)
    return e


def _refine_model(spec, demod: np.ndarray, t0: np.ndarray, f0: np.ndarray,
                  group: int = 4) -> np.ndarray:
    """sync_refine as the kernel lays it out: ``group`` lanes a candidate
    (4, as kept: one an offset, the fourth idle, 8 a warp; 3: 10 a warp,
    lanes 30 and 31 idle), each live lane summing its offset's cells
    (``_offset_energy``), dead lanes (idle, or past the last candidate in
    the tail warp) holding 0; the candidate's first lane reads lanes +1
    and +2 as __shfl_down_sync does (a lane past 31 reads its own) and
    takes the first maximum, NaN as the maximum; tt = clamp(2 t0 + delta,
    0, H - 1).  ``group`` 1: a thread a candidate, all three offsets."""
    b, h, _ = demod.shape
    n = t0.size
    t_flat = t0.reshape(-1)
    if group == 1:
        j = np.arange(n)
        best = _first_max([_offset_energy(spec, demod, t0, f0, j, dd)
                           for dd in range(3)])
        return np.clip(2 * t_flat + best - 1, 0, h - 1).reshape(t0.shape)
    per_warp = 32 // group
    warps = -(-n // per_warp)
    lane = np.arange(32)
    g, dd = lane // group, lane % group
    j = np.arange(warps)[:, None] * per_warp + g[None, :]       # [warps, 32]
    live = (g < per_warp)[None, :] & (dd < 3)[None, :] & (j < n)
    jj = np.where(live, j, 0)
    ddd = np.broadcast_to(np.where(dd < 3, dd, 0), j.shape)
    e = np.where(live, _offset_energy(spec, demod, t0, f0, jj, ddd),
                 F32(0.0))
    e1 = np.concatenate([e[:, 1:], e[:, -1:]], axis=1)
    e2 = np.concatenate([e[:, 2:], e[:, -2:]], axis=1)
    best = _first_max([e, e1, e2])
    first = live & (dd == 0)[None, :]
    tt = np.full(n, -1, np.int64)
    tt[j[first]] = np.clip(2 * t_flat[j[first]] + best[first] - 1, 0, h - 1)
    assert np.all(tt >= 0), "a candidate no lane wrote"
    return tt.reshape(t0.shape)


@pytest.mark.parametrize("name", ["ft8", "ft4", "js8"])
def test_refine_model_equals_the_plain_refinement_at_the_edges(name):
    """The kernel's row arithmetic equals sync_refine_plain on candidates
    at t0 = 0 (d = 0 reads row -1, the pad), at the last t0 of a
    spectrogram cut to the fewest rows the plain version takes (d = 2
    reads row H, the pad) and elsewhere, with exact ties between the three
    offsets (first maximum) and cells spanning 8 decades (|z|^2's and
    bf16's rounding); and |z|^2 as the kernel forms it equals torch's
    abs() ** 2 bit for bit."""
    spec = _cases()[name][0]
    n_t0, n_f0 = _sync_kernels.grid(spec)
    max_sym = max(s for s, _ in spec.sync_cells)
    h = 2 * spec.os_t * max_sym + 2 * n_t0 - 1     # h0 + n_tf <= H + 2
    rng = np.random.default_rng(21)
    b = 2
    demod = ((rng.standard_normal((b, h, spec.bin_range[2]))
              + 1j * rng.standard_normal((b, h, spec.bin_range[2])))
             * 10 ** rng.uniform(-4, 4, (b, h, 1))).astype(np.complex64)
    demod[1, ::3] = 1.0 + 1.0j                     # exact ties between d
    k = 40
    t0 = rng.integers(0, n_t0, (b, k))
    f0 = rng.integers(0, n_f0, (b, k))
    t0[:, :4] = 0
    t0[:, 4:8] = n_t0 - 1
    f0[:, 8] = n_f0 - 1
    sp = dataclasses.replace(spec, top_k=k)
    want = gfsk_engine.sync_refine_plain(
        sp, torch.from_numpy(demod), torch.from_numpy(t0),
        torch.from_numpy(f0)).numpy()
    np.testing.assert_array_equal(_refine_model(sp, demod, t0, f0), want)
    z = demod[0, :64]
    m = np.sqrt(z.real.astype(np.float64) ** 2
                + z.imag.astype(np.float64) ** 2).astype(F32)
    np.testing.assert_array_equal(
        (m * m).view(np.uint32),
        (torch.from_numpy(z).abs() ** 2).numpy().view(np.uint32))
    np.testing.assert_array_equal(
        _bf16_round(m * m),
        (torch.from_numpy(m * m).to(torch.bfloat16).to(torch.float32)
         ).numpy())


def _refine_spec(name: str):
    """FT8, FT4 and JS8 (the kernel's 21- and 16-cell instances) and FT8
    cut to 20 cells (the generic instance)."""
    if name == "ft8 20 cells":
        return dataclasses.replace(ft8.SPEC,
                                   sync_cells=ft8.SPEC.sync_cells[:20])
    return _cases()[name][0]


@pytest.mark.parametrize("count", [96, 97, 12_289])
@pytest.mark.parametrize("name", ["ft8", "ft4", "js8", "ft8 20 cells"])
def test_refine_lane_groups_equal_the_plain_refinement(name, count):
    """The refinement kernel's lane layout, modelled in NumPy (four lanes a
    candidate as kept, three, and one thread a candidate), equals
    sync_refine_plain bit for bit on ``count`` candidates (96 as two
    windows of 48; 97 and 12,289 in one window: the tail warp holds live
    and dead lanes) with NaN and +inf cells (an offset's sum NaN or inf),
    exact ties between the three offsets (a band of constant bins), t0 at
    0 and at the last start, f0 at the last bin, on a spectrogram cut to
    the fewest rows the plain version takes."""
    spec = _refine_spec(name)
    n_t0, n_f0 = _sync_kernels.grid(spec)
    max_sym = max(s for s, _ in spec.sync_cells)
    h = 2 * spec.os_t * max_sym + 2 * n_t0 - 1
    b, k = (2, 48) if count == 96 else (1, count)
    rng = np.random.default_rng(60 + count + len(spec.sync_cells))
    n_bins = spec.bin_range[2]
    demod = ((rng.standard_normal((b, h, n_bins))
              + 1j * rng.standard_normal((b, h, n_bins)))
             * 10 ** rng.uniform(-3, 3, (b, h, 1))).astype(np.complex64)
    demod[:, :, :48] = 1.0 + 1.0j                  # |z|^2 = 2: ties
    flat = demod.reshape(-1)
    for val in (np.nan, np.inf):
        flat[rng.choice(flat.size, flat.size // 400, replace=False)] = val
    t0 = rng.integers(0, n_t0, (b, k))
    f0 = rng.integers(0, n_f0, (b, k))
    t0[:, :3] = 0
    t0[:, 3:6] = n_t0 - 1
    f0[:, 6] = n_f0 - 1
    f0[:, 7:16] = rng.integers(0, 48 - spec.os_f * 7, (b, 9))
    sp = dataclasses.replace(spec, top_k=k)
    want = gfsk_engine.sync_refine_plain(
        sp, torch.from_numpy(demod), torch.from_numpy(t0),
        torch.from_numpy(f0)).numpy()
    e = np.stack([_offset_energy(sp, demod, t0, f0, np.arange(b * k), d)
                  for d in range(3)])
    assert np.isnan(e).any() and np.isinf(e).any()
    assert np.any((e[0] == e[1]) & (e[1] == e[2]))
    for group in (3, 4, 1):
        np.testing.assert_array_equal(_refine_model(sp, demod, t0, f0, group),
                                      want, err_msg=f"{group} lanes")


# ---------------------------------------------------------------------------
# routing and refusals


@pytest.fixture
def no_build(monkeypatch):
    def build():
        raise AssertionError("the library was built")

    monkeypatch.setattr(_sync_kernels, "load_library", build)


def _small_operands(spec, device="cpu"):
    n_hops, h_pow, h_dem, n_bins = _shapes(spec, spec.refine)
    ps = torch.zeros((2, h_pow, n_bins), dtype=torch.bfloat16, device=device)
    dem = torch.zeros((2, h_dem, n_bins), dtype=torch.complex64,
                      device=device)
    base = torch.ones((2, 1, 1), dtype=torch.float32, device=device)
    return ps, dem, base, n_hops


def test_sync_wrapper_refusals(no_build):
    """The kernel wrappers refuse CPU tensors, wrong dtypes and shapes, a
    power map too short for the grid at every sync cell, rows that are
    not n_hops plus the padding, odd oversampling, more than 40 sync
    cells, a top_k above 32768 or above the scores a window, and a demod
    spectrogram too narrow for the grid, before any build."""
    spec = js8.SPEC
    ps, dem, base, n_hops = _small_operands(spec)
    cand = _sync_kernels.sync_candidates
    with pytest.raises(ValueError, match="CUDA"):
        cand(spec, ps, dem, base, n_hops, True)
    with pytest.raises(ValueError, match="dtype"):
        cand(spec, ps.float(), dem, base, n_hops, True)
    with pytest.raises(ValueError, match="shape"):
        cand(spec, ps, dem, base[:1], n_hops, True)
    with pytest.raises(ValueError, match="must be 3-D"):
        cand(spec, ps[0], dem, base, n_hops, True)
    with pytest.raises(ValueError, match="holds no"):
        cand(spec, ps[:, :300], dem, base, n_hops, True)
    with pytest.raises(ValueError, match="holds no"):
        cand(spec, ps[:, :, :900], dem, base, n_hops, True)
    with pytest.raises(ValueError, match="rows"):
        cand(spec, ps, dem, base, n_hops - 1, True)
    with pytest.raises(ValueError, match="even oversampling"):
        cand(dataclasses.replace(spec, os_t=3), ps, dem, base, n_hops, True)
    with pytest.raises(ValueError, match="sync cells"):
        cand(dataclasses.replace(spec, sync_cells=((0, 0),) * 41), ps, dem,
             base, n_hops, True)
    with pytest.raises(ValueError, match="top_k=32770"):
        cand(dataclasses.replace(spec, top_k=32770), ps, dem, base, n_hops,
             True)
    with pytest.raises(ValueError, match="scores a window"):
        cand(dataclasses.replace(spec, max_hops=1, fmax_hz=spec.fmin_hz
                                 + 2 * spec.bin_hz, top_k=64), ps, dem,
             base, n_hops, True)
    with pytest.raises(ValueError, match="dtype"):
        cand(spec, ps, dem.to(torch.complex128), base, n_hops, True)
    with pytest.raises(ValueError, match="base bins"):
        cand(spec, ps, dem[:, :, :800], base, n_hops, True)
    score = torch.zeros((2, 128, 897), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        _sync_kernels.sync_select(spec, score, score)
    with pytest.raises(ValueError, match="shape"):
        _sync_kernels.sync_select(spec, score, score[:, :, :800])
    with pytest.raises(ValueError, match="CUDA"):
        _sync_kernels.sync_score(spec, ps, base)
    tt = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        _sync_kernels.sync_refine(spec, dem, tt, tt)
    with pytest.raises(ValueError, match="dtype"):
        _sync_kernels.sync_refine(spec, dem, tt.int(), tt)


@pytest.mark.parametrize("cluster", [4, 32, 0, -8, True])
def test_select_cluster_refusals(no_build, cluster):
    """The selection's and its plan's ``cluster`` takes 8, 16 or None (the
    card's own plan); anything else raises before any build or launch."""
    spec = ft8.SPEC
    score = torch.zeros((2,) + _sync_kernels.grid(spec), dtype=torch.float32)
    before = dict(_sync_kernels.launches)
    with pytest.raises(ValueError, match="8 or 16"):
        _sync_kernels.sync_select(spec, score, score, cluster=cluster)
    with pytest.raises(ValueError, match="8 or 16"):
        _sync_kernels.select_plan(spec, 2, "cpu", cluster=cluster)
    assert _sync_kernels.launches == before
    with pytest.raises(ValueError, match="CUDA"):    # 8 goes on to the checks
        _sync_kernels.sync_select(spec, score, score, cluster=8)


def test_cpu_sync_search_runs_the_plain_version(no_build):
    """On CPU tensors sync_candidates runs the plain version (equal
    results), loads no library and counts no launch; on another device it
    goes to the kernel wrapper, which refuses a device that is not CUDA;
    without the refine branch it never looks at the demod spectrogram."""
    spec, jspec, refine = _cases()["js8"]
    power, demod, n_hops = _operands(spec, refine, "noise", 31)
    ps = torch.from_numpy(power).to(torch.bfloat16)
    dem = torch.from_numpy(demod)
    base = ps[:, spec.pad_hops : spec.pad_hops + n_hops].float().mean(
        dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    before = dict(_sync_kernels.launches)
    got = gfsk_engine.sync_candidates(spec, ps, dem, base, n_hops, True)
    want = gfsk_engine.sync_candidates_plain(spec, ps, dem, base, n_hops,
                                             True)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert got[4] == want[4] == 2 * spec.os_t
    assert _sync_kernels.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gfsk_engine.sync_candidates(spec, ps.to("meta"), dem.to("meta"),
                                    base.to("meta"), n_hops, True)
    fst = _cases()["fst4-60"][0]
    ps2, _, base2, n2 = _small_operands(fst)
    top_val, t0, f0, tt, os_t_eff = gfsk_engine.sync_candidates(
        fst, ps2, None, base2, n2, False)
    assert tt is t0 and os_t_eff == fst.os_t


def test_sync_kernels_raise_without_library(monkeypatch, tmp_path):
    """A CUDA-typed call with no nvcc and no built library raises
    "nvcc not found" rather than running the plain version; no launch is
    counted."""
    monkeypatch.setattr(_sync_kernels, "_lib", None)
    monkeypatch.setattr(_sync_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_sync_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_sync_kernels, "_check", lambda operands: None)
    spec = js8.SPEC
    ps, dem, base, n_hops = _small_operands(spec)
    before = dict(_sync_kernels.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _sync_kernels.sync_candidates(spec, ps, dem, base, n_hops, True)
    assert _sync_kernels.launches == before
