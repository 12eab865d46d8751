"""The q-ary kernels (``modes/csrc/qary.cu``) and the median
(``modes/csrc/median.cu``) on the CPU: NumPy models of the kernels'
algorithms against their plain versions, the plain versions
against the JAX package, and the wrappers' routing and refusals.

- ``qra_mp``: a NumPy model of the kernel's arithmetic
  (``tools/qra_mp_model.py``; the real edges' messages, each variable's
  message as the product of its other messages, the channel and the
  padding scale with the plain version's underflow to 0, the butterfly
  Walsh-Hadamard transform with stride 32 first normalised by its DC
  term, prefix and suffix leave-one-out products, the per-edge
  permutation tables, the posterior's NaN-first argmax) against
  ``QaryMPDecoder.decode_plain`` on the priors of a Q65 decode with
  converging and noise words: ``ok`` identical, ``hard`` identical where
  ``ok`` holds, ``conf`` within 1e-4; the identities the kernel rests on
  (the variable's message against the plain version's division, the
  transform's DC term against the sum, the check's message summing to 1,
  the permutations' inverses); the butterflies against ``x @ H`` within
  float32 rounding;
- ``median_rows``: a model of its plans (the plan a row length gets;
  the selection's order keys, 11-bit digits, max and min where the two
  middle ranks part, sorted last keys; the large plan's stratified sample,
  its keys lo and hi, the stream's counts and candidates and the finish's
  places and fallback) bitwise against ``_median_rows_plain`` on rows
  with ties, zero pad rows, NaN (first, last, in the median's bin), +-0,
  infinities, 1 to 3 values, odd and even counts, middle values that
  split at each pass, a first digit over half the row, each plan's
  limits, the large plan's sample misses and candidate overflow, and
  FT8's strided view; ``_median_rows_plain`` against ``jnp.median``;
- ``qary_sync``: a model of the kernel (the sync rows summed in symbol
  order, the composite keys, each 32-bin strip's top-K, the merge) bitwise
  against ``_qary_sync_plain`` on JT65 and Q65 maps with planted equal
  scores in different strips and NaN cells, and against the scores
  ``qary_decode_program`` picks from a Q65 decode;
- the kernel's table block holds the plain version's tables, whose source
  equals the JAX package's;
- the wrappers: CPU tensors run the plain versions and count no launch;
  bad operands raise before the library loads; a decoder for a card
  refuses a search the kernel does not take when it is built; a
  CUDA-typed call with no nvcc raises.

The models import no JAX, so the card's tests can hold the kernels
against them too (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cwsl_digi_tpu_torch.modes import (_median_kernels, _qary_kernels,
                                       gfsk_engine, jt65, q65,
                                       qary_engine, qra)
from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from qra_mp_model import (F32, TINY, UNI, mp_model,  # noqa: E402,F401
                          warp_sum64, wht_butterfly)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# qra_mp model (tools/qra_mp_model.py)


def q65_priors(n_windows: int = 2, top_k: int = 4, seed: int = 3
               ) -> np.ndarray:
    """Priors [M, 63, 64] of a port Q65 decode on the CPU: a -16 dB burst
    in the first window (its variants converge), noise in the rest."""
    rng = np.random.default_rng(seed)
    clean = q65.synthesize("CQ W2AXR FN13", 1200.0)
    wins = [add_noise_at_snr(clean, -16.0, 12_000, rng)]
    wins += [rng.standard_normal(len(clean)) for _ in range(n_windows - 1)]
    dec = q65.Q65Decoder(top_k=top_k, device="cpu")
    e = dec.decode_arrays(np.stack(wins).astype(F32))["e"]
    pr = qary_engine._mp_priors(qary_engine.QaryDecoder.MP_VARIANTS,
                                torch.from_numpy(e))
    return pr.reshape(-1, 63, 64).numpy()


@pytest.fixture(scope="module")
def priors() -> np.ndarray:
    return q65_priors()


def assert_mp_agrees(got, want) -> None:
    """ok identical, hard identical where ok holds, conf within 1e-4
    there (words that do not converge end where 60 iterations of another
    summation order take them)."""
    hard, ok, conf = (np.asarray(x) for x in got)
    w_hard, w_ok, w_conf = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ok, w_ok)
    np.testing.assert_array_equal(hard[w_ok], w_hard[w_ok])
    np.testing.assert_allclose(conf[w_ok], w_conf[w_ok], rtol=0, atol=1e-4)


def test_wht_butterfly_equals_the_matmul():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 64)).astype(F32)
    h = qra._wht64()
    want = (x.astype(np.float64) @ h.astype(np.float64))
    got = wht_butterfly(x)
    # float32 rounding of six stages of sums of |x| <= 64 max|x|
    tol = 6 * 2.0 ** -23 * np.abs(x).sum(-1, keepdims=True)
    assert np.all(np.abs(got - want) <= tol)
    np.testing.assert_allclose(got, (x @ h), rtol=0, atol=float(tol.max()))
    # the transform is its own inverse up to 64
    np.testing.assert_allclose(wht_butterfly(got) / 64, x, rtol=0, atol=1e-5)


def random_messages(rng, shape) -> np.ndarray:
    """Normalised float32 messages [..., 64] as the message passing holds
    them: a few symbols large, many small, some at the 1e-30 floor."""
    x = rng.exponential(size=shape) ** 8
    x[rng.random(shape) < 0.3] = 0.0
    x = np.maximum(x / x.sum(-1, keepdims=True), 1e-30)
    return (x / x.sum(-1, keepdims=True)).astype(F32)


def test_variable_message_is_the_divided_product():
    """The kernel's variable-to-check message (the product of the other
    messages, the channel and the padding scale, 0 where its product with
    the edge's own message underflows) against the plain version's
    (the product over every edge, scale included, over own + 1e-30), on
    random words of Q65's code: where the own message is far above the
    floor and the product normal, within float32 rounding of the products;
    where the plain version's product underflows to 0, the floor after the
    clamp (but for a few entries whose product, in the kernel's order,
    ends just above 0: far below the message's other symbols)."""
    import qra_mp_model as mm

    dec = q65._mp(torch.device("cpu"))
    g = mm.edge_tables(dec)
    rng = np.random.default_rng(7)
    m = random_messages(rng, (32, g["e_var"].size, 64))
    chan = random_messages(rng, (32, 63, 64))[:, g["e_var"]]
    p, some = mm._products(m, g["others"])
    ext = np.where(some[None, :, None], chan * p, chan) * g["scale"][None,
                                                                   :, None]
    got = mm._clamp(np.where(ext * m == 0, F32(0), ext))
    # the plain version's: every edge of the variable in column order
    t = dec._host_tables()
    edge_of = np.full(t["row_mask"].size, -1)
    edge_of[np.flatnonzero(t["row_mask"].reshape(-1) > 0)] = np.arange(
        g["e_var"].size)
    pall = None
    for j in range(t["col_slots"].shape[1]):
        x = np.where((t["col_mask"][:, j] > 0)[None, :, None],
                     m[:, edge_of[t["col_slots"][:, j]]], UNI)
        pall = x if pall is None else pall * x
    tot = chan * pall[:, g["e_var"]]
    want = mm._clamp(tot / (m + TINY))
    deg = (g["var_edges"] >= 0).sum(1)[g["e_var"]]
    far = (m > F32(1e-20)) & (tot >= np.finfo(F32).tiny)
    tol = ((deg + 3) * 2.0 ** -23)[None, :, None]
    assert far.mean() > 0.2 and (tot == 0).any()
    assert np.all((np.abs(got - want) <= tol * want) | ~far)
    under = got[tot == 0]
    assert (under == TINY).mean() > 0.999 and under.max() < 1e-12


def test_transform_dc_term_is_the_sum():
    """Row 0 of the Walsh-Hadamard matrix is all ones, and a GF(64)
    permutation keeps a message's sum: the butterfly transform's DC term
    of a permuted message is its 64-term sum within float32 rounding, so
    the kernel normalises the transformed message by it."""
    dec = q65._mp(torch.device("cpu"))
    fwd = dec._host_tables()["qra_fwd"].reshape(-1, 64)[:40].astype(np.int64)
    x = random_messages(np.random.default_rng(8), (40, 64)) * F32(3.5)
    dc = wht_butterfly(np.take_along_axis(x, fwd, -1))[:, 0]
    want = x.astype(np.float64).sum(-1)
    assert np.all(np.abs(dc - want) <= 6 * 2.0 ** -23 * want)


def test_check_message_sums_to_one():
    """A check-to-variable message needs no second normalisation: the sum
    of the inverse transform over 64 of the leave-one-out product is its
    DC term, the product of normalised messages' DC terms, 1; after the
    clamp and the permutation within float32 rounding of 1."""
    import qra_mp_model as mm

    rng = np.random.default_rng(9)
    w = wht_butterfly(random_messages(rng, (50, 3, 64)))
    w = w * (F32(1) / (w[..., :1] + TINY))
    assert np.all(w[..., 0] == 1)
    loo = np.stack([w[:, 1] * w[:, 2], w[:, 0] * w[:, 2], w[:, 0] * w[:, 1]],
                   1)
    q = mm._clamp(wht_butterfly(loo) / F32(64))
    np.testing.assert_allclose(q.astype(np.float64).sum(-1), 1.0, rtol=0,
                               atol=1e-5)
    # written back through the permutation: bwd undoes fwd on every edge
    g = mm.edge_tables(q65._mp(torch.device("cpu")))
    assert np.all(np.take_along_axis(g["fwd"], g["bwd"], -1)
                  == np.arange(64))


def test_mp_model_matches_plain(priors):
    """The kernel's arithmetic against the plain decode on the priors of
    a Q65 decode: converging and noise words, the flags identical."""
    dec = q65._mp(torch.device("cpu"))
    want = [x.numpy() for x in dec.decode_plain(torch.from_numpy(priors))]
    assert want[1].any() and not want[1].all()
    got = mp_model(dec, priors)
    assert_mp_agrees(got, want)


def test_mp_model_on_edge_words():
    """Uniform words (every symbol ties: the argmax takes index 0 of each
    posterior, the zero word, which converges), one-hot codewords, and a
    word with a NaN prior (its posterior NaN, index of the first NaN)."""
    dec = q65._mp(torch.device("cpu"))
    rng = np.random.default_rng(4)
    cw = q65._CODE.encode(rng.integers(0, 64, 13))
    onehot = np.full((63, 64), 1e-3, F32)
    onehot[np.arange(63), cw] = 1.0
    onehot /= onehot.sum(-1, keepdims=True)
    words = np.stack([np.full((63, 64), UNI, F32), onehot,
                      np.full((63, 64), UNI, F32)])
    words[2, 5, 7] = np.nan
    dec10 = qra.QaryMPDecoder(dec.code, iters=10, device="cpu")
    want = [x.numpy() for x in dec10.decode_plain(torch.from_numpy(words))]
    got = mp_model(dec10, words)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:2], want[0][:2])
    assert want[1][0] and want[1][1] and (want[0][1] == cw).all()
    assert np.isnan(got[2][2]) and np.isnan(want[2][2])


def test_kernel_tables_hold_the_plain_versions_tables():
    """The qra_mp table block decodes back to the plain version's tables
    and ends with the 152 real slots (the kernel's edges) in order, and
    the plain version's tables are the JAX package's."""
    from cwsl_digi_tpu.modes import q65 as jq65

    dec = q65._mp(torch.device("cpu"))
    n, nc, mr, max_col = dec.kernel_code
    assert (n, nc, mr, max_col) == (63, 50, 4, 4)
    tab = dec.kernel_tables()
    assert tab.dtype == np.uint8
    t = dec._host_tables()
    edges = int(t["row_mask"].sum())
    assert edges == int(t["col_mask"].sum()) == 152
    assert tab.size == _qary_kernels.mp_table_bytes(n, nc, mr, max_col,
                                                    edges)
    assert _qary_kernels.mp_edges(torch.from_numpy(tab),
                                  dec.kernel_code) == edges
    o = 0
    for name, size in (("h_vars", nc * mr), ("h_coeff", nc * mr),
                       ("qra_fwd", nc * mr * 64), ("qra_bwd", nc * mr * 64)):
        np.testing.assert_array_equal(tab[o:o + size],
                                      t[name].reshape(-1), err_msg=name)
        o += size
    col = tab[o:o + n * max_col].reshape(n, max_col)
    o += n * max_col
    np.testing.assert_array_equal(col == 255, t["col_mask"] == 0)
    np.testing.assert_array_equal(np.where(col == 255, 0, col),
                                  np.where(t["col_mask"] > 0,
                                           t["col_slots"], 0))
    np.testing.assert_array_equal(tab[o:o + 64 * 64].reshape(64, 64),
                                  t["gf_mul"])
    o += 64 * 64
    np.testing.assert_array_equal(
        tab[o:], np.flatnonzero(t["row_mask"].reshape(-1) > 0))
    jm = jq65._mp()
    for name, arr in (("h_vars", jm._h_vars), ("h_coeff", jm.code.h_coeff),
                      ("qra_fwd", jm._fwd), ("qra_bwd", jm._bwd),
                      ("col_slots", jm._col_slots),
                      ("col_mask", jm._col_mask)):
        np.testing.assert_array_equal(t[name], arr, err_msg=name)
    assert dec.iters == jm.iters == 60


# ---------------------------------------------------------------------------
# median_rows model


def order_keys(x: np.ndarray) -> np.ndarray:
    """The kernels' ascending order keys of float32: -0.0 as 0.0, NaN
    above +inf."""
    x = np.asarray(x, F32)
    u = np.where(x == 0, np.uint32(0), x.view(np.uint32))
    k = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), k).astype(np.uint32)


def key_values(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.uint32)
    bits = np.where(k & np.uint32(0x80000000), k & np.uint32(0x7FFFFFFF), ~k)
    return bits.astype(np.uint32).view(F32)


def high_mask(low: int) -> int:
    """The key bits above ``low`` (none at 32)."""
    return 0 if low >= 32 else (0xFFFFFFFF << low) & 0xFFFFFFFF


def select_model(keys: np.ndarray, prefix: int, low: int, r0: int,
                 even: bool, trace: list | None = None) -> tuple[int, int]:
    """``median.cu``'s ``select_loop``: the keys of ranks r0 (and r0 + 1
    where ``even``) among the keys under ``prefix`` (its bits above
    ``low``) by digits of 11 bits (fewer where fewer are left) from the
    top.  Each pass counts the digits and takes the digit of each wanted
    rank; two digits apart end it by the max under the lower one's prefix
    and the min under the upper one's; a digit of at most FIN_CAP keys
    ends it by sorting them; the last digit ends it.  (Where the mid plan
    gathers a digit's keys into one block, the same passes run there.)
    ``trace`` gets each pass's state."""
    keys = np.asarray(keys, np.uint32)
    while True:
        bits = min(low, 11)
        shift = low - bits
        sel = keys[(keys & np.uint32(high_mask(low))) == np.uint32(prefix)]
        hist = np.bincount((sel >> np.uint32(shift)) & np.uint32(
            (1 << bits) - 1), minlength=1 << bits)
        cum = np.cumsum(hist)
        d0 = int(np.searchsorted(cum, r0, side="right"))
        d1 = int(np.searchsorted(cum, r0 + 1, side="right")) if even else d0
        below = int(cum[d0 - 1]) if d0 else 0
        count = int(hist[d0])
        p0, p1 = prefix | (d0 << shift), prefix | (d1 << shift)
        hn = np.uint32(high_mask(shift))
        if d1 != d0:
            if trace is not None:
                trace.append("split")
            return (int(keys[(keys & hn) == p0].max()),
                    int(keys[(keys & hn) == p1].min()))
        prefix, low, r0 = p0, shift, r0 - below
        if low == 0:
            if trace is not None:
                trace.append("done")
            return prefix, prefix
        if count <= _median_kernels.FIN_CAP:
            if trace is not None:
                trace.append("finish")
            fin = np.sort(keys[(keys & hn) == prefix])
            assert fin.size == count
            return int(fin[r0]), int(fin[r0 + 1] if even else fin[r0])
        if trace is not None:
            trace.append("go")


def cand_digit(lo: int, hi: int) -> tuple[int, int]:
    """(prefix, low) of the candidates (lo < key < hi): the bits lo and hi
    share, above ``low``."""
    low = 0 if lo == hi else (lo ^ hi).bit_length()
    return lo & high_mask(low), low


def large_model(keys: np.ndarray, trace: list) -> tuple[int, int]:
    """The large plan on one row's keys (no NaN): the sample's keys lo and
    hi MARGIN ranks outside the middle ranks' places, the stream's counts
    and candidates (lo < key < hi), and the finish: each middle rank on
    lo, on hi or among the candidates (selected under lo's and hi's common
    bits), else (or where the candidates overflow the buffer) the whole
    row again."""
    n = keys.size
    s, margin = _median_kernels.SAMPLE, _median_kernels.MARGIN
    samp = keys[_median_kernels.sample_positions(n)]
    r0, r1 = (n - 1) // 2, n // 2
    a = max(0, r0 * s // n - margin)
    b = min(s - 1, r1 * s // n + margin)
    lo = select_model(samp, 0, 32, a, False)[0]
    hi = select_model(samp, 0, 32, b, False)[0]
    below = int((keys < lo).sum())
    eqlo = int((keys == lo).sum())
    eqhi = int((keys == hi).sum()) if hi != lo else 0
    inside = keys[(keys > lo) & (keys < hi)]
    cap = -(-n // _median_kernels.LARGE_CAP_DIV)

    def place(r):
        t = r - below
        if t < 0:
            return 0, 0
        if t < eqlo:
            return 1, 0
        t -= eqlo
        if t < inside.size:
            return 2, t
        t -= inside.size
        return (3, 0) if t < eqhi else (4, 0)

    (p0, q0), (p1, q1) = place(r0), place(r1)
    k = [lo if p0 == 1 else hi, lo if p1 == 1 else hi]
    trace.append({"lo": lo, "hi": hi, "below": below, "eqlo": eqlo,
                  "eqhi": eqhi, "inside": int(inside.size),
                  "places": (p0, p1)})
    if 0 in (p0, p1) or 4 in (p0, p1) or (
            2 in (p0, p1) and inside.size > cap):
        trace.append("fallback")
        return select_model(keys, 0, 32, r0, n % 2 == 0, trace=trace)
    if 2 in (p0, p1):
        prefix, low = cand_digit(lo, hi)
        both = p0 == 2 and p1 == 2
        got = select_model(inside, prefix, low, q0 if p0 == 2 else q1,
                           both and q1 != q0, trace=trace)
        if both:
            k = list(got)
        elif p0 == 2:
            k[0] = got[0]
        else:
            k[1] = got[0]
    return k[0], k[1]


def median_model(x: np.ndarray, plan: str | None = None,
                 traces: list | None = None) -> np.ndarray:
    """``median_rows`` on each row of x [R, N] (or [R, A, B]) in the plan
    ``median_plan`` picks (or ``plan``): NaN for a row that holds a NaN;
    else the on-chip plans' selection of the two middle keys over the row
    (its blocks' slices change no count) or the large plan's; the value
    of the lower middle key for an odd count, 0.5 * (a + b) in float32 for
    an even one.  ``traces`` gets each row's (plan, states)."""
    x = np.asarray(x, F32).reshape(len(x), -1)
    n = x.shape[1]
    p = _median_kernels.median_plan(n, plan=plan)["plan"]
    out = []
    for row in x:
        keys = order_keys(row)
        trace: list = [p]
        if np.isnan(row).any():
            trace.append("nan")
            out.append(F32(np.nan))
        else:
            if p == "large":
                k0, k1 = large_model(keys, trace)
            else:
                k0, k1 = select_model(keys, 0, 32, (n - 1) // 2, n % 2 == 0,
                                      trace=trace)
            a, b = key_values(np.array([k0, k1], np.uint32))
            out.append(a if n % 2 else F32(0.5) * (a + b))
        if traces is not None:
            traces.append(trace)
    return np.array(out, F32)


@functools.lru_cache(maxsize=1)
def _median_cases(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    one = np.nextafter(F32(1.0), F32(2.0))
    cases = {
        "noise odd": rng.standard_normal((3, 1001)).astype(F32),
        "noise even": rng.exponential(size=(3, 4032)).astype(F32),
        "ties": rng.integers(-3, 4, (4, 999)).astype(F32),
        "ties even": rng.integers(0, 3, (4, 1000)).astype(F32),
        "split at pass 1": np.repeat(np.array([[1.0, 1000.0]], F32), 300,
                                     axis=1),
        "split at pass 3": np.repeat(np.array([[1.0, one]], F32), 300,
                                     axis=1),
        "signed zeros": np.where(rng.random((4, 64)) < 0.5, F32(-0.0),
                                 F32(0.0)).astype(F32),
        "infinities": np.concatenate([np.full((2, 5), np.inf, F32),
                                      np.full((2, 4), -np.inf, F32)], 1),
        "one value": np.array([[-2.5], [0.0]], F32),
        "two values": np.array([[3.0, -1.0], [-0.0, 0.0], [2.0, 2.0]], F32),
        "three values": np.array([[3.0, -1.0, 7.5], [np.inf, 0.0, -0.0]],
                                 F32),
        "all equal": np.full((2, 5000), F32(0.75)),
        "mostly signed zeros": np.where(
            rng.random((2, 6001)) < 0.9,
            np.where(rng.random((2, 6001)) < 0.5, F32(-0.0), F32(0.0)),
            rng.standard_normal((2, 6001))).astype(F32),
    }
    nan = rng.standard_normal((3, 257)).astype(F32)
    nan[0, 100] = np.nan
    nan[1, :] = np.nan
    cases["NaN"] = nan
    nan_at = rng.exponential(size=(3, 20001)).astype(F32)
    nan_at[0, 0] = np.nan                         # first
    nan_at[1, -1] = np.nan                        # last
    nan_at[2, np.argsort(nan_at[2])[10000]] = np.nan   # the median's bin
    cases["NaN first, last, in the median's bin"] = nan_at
    zeros = rng.exponential(size=(2, 40, 37)).astype(F32)
    zeros[:, :12] = 0.0            # a q-ary map's zero pad rows
    zeros[:, -12:] = 0.0
    cases["zero pad rows"] = zeros.reshape(2, -1)
    zeros_mid = np.zeros((2, 30, 20), F32)
    zeros_mid[:, 20:] = rng.exponential(size=(2, 10, 20))
    cases["zero pad majority"] = zeros_mid.reshape(2, -1)
    # a first digit that holds more than half the row: values in [1, 1.19)
    # share their top 11 bits
    big_bin = (1.0 + 0.18 * rng.random((2, 30001))).astype(F32)
    big_bin[:, :9000] = rng.exponential(size=(2, 9000)) * 100.0
    cases["candidate bin over half the row"] = big_bin
    # one key either side of each plan's limits: small / mid at
    # KEYS_BLOCK, the cluster's growth, mid / large at ONCHIP_MAX
    kb, mx = _median_kernels.KEYS_BLOCK, _median_kernels.ONCHIP_MAX
    for n in (kb, kb + 1, 2 * kb, 2 * kb + 1, 16 * kb, 16 * kb + 1, mx,
              mx + 1):
        cases[f"limit {n}"] = rng.exponential(size=(1, n)).astype(F32)
    # the large plan: ranks on lo and hi (a few values, many ties), a
    # sample that stands for nothing (a bracket miss), candidates beyond
    # the buffer
    n = mx + 1
    cases["large ties"] = rng.integers(0, 5, (1, n)).astype(F32)
    miss = rng.exponential(size=(1, n)).astype(F32) + 10.0
    miss[0, _median_kernels.sample_positions(n)] = -1.0
    cases["large sample misses"] = miss
    over = np.full((1, n), F32(0.5))
    over[0, _median_kernels.sample_positions(n)] = rng.permutation(
        _median_kernels.SAMPLE).astype(F32) - 8000.0
    cases["large candidates overflow"] = over
    return cases


def median_rows_cases(seed: int = 11) -> dict[str, np.ndarray]:
    """Rows of each edge the median meets, by name (float32 [R, N]): ties,
    signed zeros, NaN, infinities, 1 to 3 values, middle values apart at
    each pass, a first digit over half the row, the rows either side of
    each plan's limits, and the large plan's ties at its sample's keys,
    sample miss and candidate overflow."""
    return _median_cases(seed)


def ft8_view_map(seed: int = 12) -> np.ndarray:
    """An FT8-shaped power map [2, 743, 1825] whose ``[:, ::4, ::4]`` view
    is the SNR median's [2, 186, 457] rows (85,002 values)."""
    rng = np.random.default_rng(seed)
    return rng.exponential(size=(2, 743, 1825)).astype(F32)


@pytest.mark.parametrize("name", list(median_rows_cases()))
def test_median_model_matches_plain(name):
    x = median_rows_cases()[name]
    want = gfsk_engine._median_rows_plain(torch.from_numpy(x)).numpy()
    got = median_model(x)
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (name, got, want)
    # through the dispatcher on the CPU
    np.testing.assert_array_equal(
        gfsk_engine._median_rows(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("plan", ["small", "mid", "large"])
def test_median_model_in_each_plan(plan):
    """Each plan's model bit for bit the plain median on rows it does not
    pick by itself: even and odd noise with ties and signed zeros."""
    rng = np.random.default_rng(21)
    n = 20_000 if plan != "large" else 40_001
    x = rng.exponential(size=(2, n)).astype(F32)
    x[0, ::7] = 0.0
    x[1, ::5] = -0.0
    x[1, 1::5] = x[1, 2::5][: x[1, 1::5].size]
    if plan == "large":
        x = x[:, :-1] if n % 2 else x
    want = gfsk_engine._median_rows_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        median_model(x, plan=plan).view(np.uint32), want.view(np.uint32))


def test_median_plans_by_row_length():
    """The plan for each length and row count the decoders hand the
    kernel, and at the plans' limits: one block of 256 threads up to
    KEYS_BLOCK keys; above, a cluster of 512-thread blocks, 16 (8 where
    the card holds no 16) halved while the rows take more than
    MID_WAVE_BLOCKS blocks, at least as many as leave a block
    KEYS_BLOCK_MID_MAX keys; above ONCHIP_MAX the large plan, whose
    candidate buffer is an eighth of a row."""
    plan = _median_kernels.median_plan
    kb, mx = _median_kernels.KEYS_BLOCK, _median_kernels.ONCHIP_MAX
    cases = {(1, 4032): ("small", 1, 4032), (1536, 4032): ("small", 1, 4032),
             (1, kb): ("small", 1, kb), (1, kb + 1): ("mid", 16, 513),
             (1, 21_297): ("mid", 16, 1332), (26, 43_229): ("mid", 4, 10_808),
             (1, 85_002): ("mid", 16, 5313), (8, 85_002): ("mid", 16, 5313),
             (16, 85_002): ("mid", 8, 10_626),
             (24, 85_002): ("mid", 4, 21_251),
             (64, 85_002): ("mid", 4, 21_251),
             (24, 214_684): ("mid", 8, 26_836),
             (64, 214_684): ("mid", 8, 26_836), (1, mx): ("mid", 16, 32_768)}
    for (rows, n), (name, c, kpb) in cases.items():
        p = plan(n, rows=rows)
        assert (p["plan"], p["cluster"], p["keys_a_block"]) == (name, c,
                                                                 kpb), n
        assert p["threads"] == (256 if c == 1 else 512)
        cand = 0 if c == 1 else min(16_384, max(2048, -(-n // 10)))
        assert (p["cand"], p["smem_bytes"]) == (cand, 4 * (kpb + cand))
    assert plan(85_002, fits16=False)["cluster"] == 8
    assert plan(mx, fits16=False)["plan"] == "large"
    assert plan(mx // 2, fits16=False)["keys_a_block"] == 32_768
    for n in (mx + 1, 2_228_820, 3_732_095):
        p = plan(n)
        assert p == {"plan": "large", "sample": 16_384, "cap": -(-n // 8),
                     "chunks": -(-n // 16_384)}
    assert plan(85_002, cluster=4)["keys_a_block"] == 21_251
    assert plan(4032, plan="mid")["cluster"] == 16
    assert plan(50_000, plan="small")["cluster"] == 1
    with pytest.raises(ValueError, match="shared memory"):
        plan(100_000, plan="small")
    with pytest.raises(ValueError, match="more than"):
        plan(16_384, plan="large")
    with pytest.raises(ValueError, match="cluster"):
        plan(4032, plan="small", cluster=2)


def test_median_model_takes_each_path():
    """The cases reach every end of the selection: a digit of at most
    FIN_CAP keys ranked directly, two middle keys apart (max and min), the
    last digit, several passes (a first digit over half the row), NaN; in
    the large plan ranks on lo and on hi, among the candidates, a sample
    miss and a candidate overflow (each then the whole row again)."""
    cases = median_rows_cases()
    ends = {}
    for name in cases:
        traces: list = []
        median_model(cases[name], traces=traces)
        ends[name] = traces
    flat = [t for tr in ends.values() for row in tr for t in row
            if isinstance(t, str)]
    for state in ("small", "mid", "large", "finish", "split", "done", "go",
                  "nan", "fallback"):
        assert state in flat, state
    assert "go" in ends["candidate bin over half the row"][0]
    large = {name: [r[1] for r in tr] for name, tr in ends.items()
             if tr[0][0] == "large"}
    assert set(large) == {f"limit {_median_kernels.ONCHIP_MAX + 1}",
                          "large ties", "large sample misses",
                          "large candidates overflow"}
    assert large["large ties"][0]["places"] in ((1, 1), (3, 3), (1, 3))
    assert large[f"limit {_median_kernels.ONCHIP_MAX + 1}"][0][
        "places"] == (2, 2)
    assert 0.02 < large[f"limit {_median_kernels.ONCHIP_MAX + 1}"][0][
        "inside"] / (_median_kernels.ONCHIP_MAX + 1) < 0.08
    assert "fallback" in ends["large sample misses"][0]
    assert ends["large candidates overflow"][0][1]["inside"] > -(
        -(_median_kernels.ONCHIP_MAX + 1) // 8)
    assert "fallback" in ends["large candidates overflow"][0]


def test_median_strided_view_matches_plain():
    """FT8's SNR median reads the ``[:, ::4, ::4]`` view of its power map
    (85,002 values a row, the mid plan): the model on the view's values
    and the dispatcher on the view itself equal the plain median of a
    contiguous copy."""
    m = torch.from_numpy(ft8_view_map())
    view = m[:, ::4, ::4]
    assert not view.is_contiguous() and view[0].numel() == 85_002
    want = gfsk_engine._median_rows_plain(view.contiguous()).numpy()
    np.testing.assert_array_equal(gfsk_engine._median_rows(view).numpy(),
                                  want)
    np.testing.assert_array_equal(median_model(view.numpy()), want)


def test_median_plain_matches_jnp_median():
    """The plain median equals ``jnp.median`` on every case (NaN rows NaN,
    -0.0 equal to 0.0), and on a strided view of a 3-D map."""
    import jax.numpy as jnp

    for name, x in median_rows_cases().items():
        want = np.asarray(jnp.median(jnp.asarray(x), axis=1))
        got = gfsk_engine._median_rows_plain(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    m = np.random.default_rng(2).exponential(size=(3, 41, 57)).astype(F32)
    want = np.asarray(jnp.median(jnp.asarray(m)[:, ::4, ::4], axis=(1, 2)))
    got = gfsk_engine._median_rows(torch.from_numpy(m)[:, ::4, ::4]).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# qary_sync model


SYNC_WARPS, SYNC_THREADS, SYNC_CELLS = 8, 256, 16


def sync_schedule(hops, n_t0: int, ring: int = _qary_kernels.SYNC_RING,
                  ahead: int = _qary_kernels.SYNC_AHEAD) -> dict:
    """The ``qary_sync`` block's load schedule, as every thread runs it:
    the prologue's ``ahead`` groups (the union rows up to window g's end,
    below hops[0] + ring), then at window i the wait (for the groups up to
    the newest one committed at least q groups back whose rows reach
    window i's end, q at most ``ahead`` - 1; where none does, a gap
    outran the ring: a barrier, the missing rows as a group of their own
    and a wait for every group), the barrier, and the rows up to window
    i + ``ahead``'s end below hops[i] + ring.  Returns the events:
    ("issue", rows, group) and ("sum", window, groups complete), issues
    before the window they overlap is summed, as the kernel runs them.
    Raises where the kernel's invariants fail: a row issued twice or
    outside the windows, a slot overwritten while a row in it is still to
    be read, a window summed before its rows' groups are complete."""
    s = len(hops)
    hops = [int(h) for h in hops]
    st = {"next": hops[0], "wnext": 0, "events": [], "issued": {},
          "gnext": [], "barriers": 0}

    def issue(x: int, first_read: int) -> None:
        rows = []
        while True:
            while st["wnext"] < s and hops[st["wnext"]] + n_t0 <= st["next"]:
                st["wnext"] += 1
            if st["wnext"] == s:
                break
            lo = max(st["next"], hops[st["wnext"]])
            if lo >= x:
                break
            hi = min(hops[st["wnext"]] + n_t0, x)
            rows += range(lo, hi)
            st["next"] = hi
        live = {r for w in range(first_read, s)
                for r in range(hops[w], hops[w] + n_t0)}
        for r in rows:
            assert r not in st["issued"], f"row {r} issued twice"
            assert r in live, f"row {r} in no window left"
            for old in st["issued"]:
                assert not (old % ring == r % ring and old in live), \
                    f"row {r} overwrites row {old}, still to be read"
            st["issued"][r] = len(st["gnext"])
        st["events"].append(("issue", rows, len(st["gnext"])))
        st["gnext"].append(st["next"])        # the commit

    for g in range(ahead):
        issue(min(hops[0] + ring, hops[min(g, s - 1)] + n_t0), 0)
    for i in range(s):
        h = hops[i]
        need = h + n_t0
        newest = st["gnext"][::-1]
        pending = max((q for q in range(ahead) if newest[q] >= need),
                      default=-1)
        if pending < 0:
            st["barriers"] += 1
            issue(need, i)
            pending = 0
        complete = len(st["gnext"]) - pending
        st["barriers"] += 1
        for r in range(h, need):
            assert r in st["issued"] and st["issued"][r] < complete, \
                f"window {i}: row {r} not complete"
        issue(min(h + ring, hops[min(i + ahead, s - 1)] + n_t0), i)
        st["events"].append(("sum", i, complete))
    union = {r for h in hops for r in range(h, h + n_t0)}
    assert set(st["issued"]) == union
    return {"events": st["events"], "barriers": st["barriers"],
            "rows": len(union),
            "ahead_rows": max(len(e[1]) for e in st["events"]
                              if e[0] == "issue")}


def sync_warp_schedule(hops, n_t0: int, warp: int,
                       ring: int = 32, mirror: int = 20,
                       ahead: int = 4) -> dict:
    """The load schedule of warp ``warp`` on ``qary_sync``'s path for hops
    all congruent mod 8: its class rows m (row hops[0] + warp + 8 m) in
    its own ring (slot m mod ``ring``, slots below ``mirror`` again past
    its end), every class row from 0 in order; window i is class rows
    [c_i, c_i + J) (c_i = (hops[i] - hops[0]) / 8, J its offsets below
    n_t0); a step sums windows i and i + 1 where both fit the ring, else
    window i.  The prologue's ``ahead`` groups (up to window 2 g + 1's
    end), then at a step the wait (the groups up to the newest one
    committed at least q groups back that reaches the step's last window's
    end, q < ``ahead``; a gap that outran the ring: its rows now, a wait
    for all), then the class rows up to window i + 2 ``ahead`` + 1's end
    below c_i + ``ring``.  Returns the events, ("issue",
    class rows, group) and ("sum", window, groups complete, the step's
    first window).  Raises where
    a class row is issued twice, a slot (or its mirror) is written while
    its row is still to be read, or a window is summed before its rows'
    groups are complete."""
    s = len(hops)
    h0 = int(hops[0])
    cls = [(int(h) - h0) // 8 for h in hops]
    j_n = max(0, -(-(n_t0 - warp) // 8))
    st = {"next": 0, "events": [], "issued": {}, "gn": []}

    def slots(m):
        sl = m % ring
        return {sl, sl + ring} if sl < mirror else {sl}

    def issue(x: int, first_read: int) -> None:
        rows = list(range(st["next"], x))
        st["next"] = max(st["next"], x)
        live = {m for w in range(first_read, s)
                for m in range(cls[w], cls[w] + j_n)}
        for m in rows:
            assert m not in st["issued"], m
            for old in st["issued"]:
                assert not (slots(old) & slots(m) and old in live), \
                    f"class row {m} overwrites {old}, still to be read"
            st["issued"][m] = len(st["gn"])
        st["events"].append(("issue", rows, len(st["gn"])))
        st["gn"].append(st["next"])

    for g in range(ahead):
        issue(min(ring, cls[min(2 * g + 1, s - 1)] + j_n), 0)
    i = 0
    while i < s:
        c = cls[i]
        two = i + 1 < s and cls[i + 1] + j_n - c <= ring
        windows = [i, i + 1] if two else [i]
        need = cls[windows[-1]] + j_n
        newest = st["gn"][::-1]
        pending = max((q for q in range(ahead) if newest[q] >= need),
                      default=-1)
        if pending < 0:
            issue(need, i)
            pending = 0
        complete = len(st["gn"]) - pending
        for w in windows:
            for m in range(cls[w], cls[w] + j_n):
                assert st["issued"][m] < complete, f"window {w}: {m}"
        issue(min(c + ring, cls[min(i + 2 * ahead + 1, s - 1)] + j_n), i)
        for w in windows:
            st["events"].append(("sum", w, complete, i))
        i += len(windows)
    assert set(st["issued"]) == set(range(cls[-1] + j_n))
    return {"events": st["events"], "j": j_n}


def sync_congruent(hops) -> bool:
    """Whether ``qary_sync`` takes its warps' path: every hop hops[0]
    plus a multiple of 8."""
    return all((int(h) - int(hops[0])) % 8 == 0 for h in hops)


def _order_key64(val: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return (order_keys(val).astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - idx.astype(np.uint64))


def _top_by_rank(keys: np.ndarray, k: int) -> np.ndarray:
    """The positions of the ``k`` largest keys, largest first: the kernel
    places each key at its rank (the keys above it); the keys are unique,
    so that is their descending order."""
    assert len(np.unique(keys)) == len(keys)
    return np.argsort(keys)[::-1][:k]


def sync_model(spec, power_sync: np.ndarray, base: np.ndarray,
               stats: dict | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """``qary_sync`` in NumPy.  The rings of
    ``sync_warp_schedule`` (hops congruent mod 8) or of ``sync_schedule``
    (others): their rows written when issued, each cell adding its
    window's rows in window order from -0.0, over base + 1e-30; keys
    (order key << 32 | 2**32 - 1 - index).  A block takes every L-th strip
    (L = ``sync_plan``'s lists); a thread holds offsets w, w + 8, ... of
    bin l of a strip of 32; a strip's threshold is the K-th largest thread
    maximum, at least the key past the block's list; the pool (list and
    the keys at the threshold) gives the new list by rank.  The window's
    last block: the candidates at the K-th largest head of the lists, by
    rank.  ``stats`` collects the pools' sizes against their caps."""
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    n_t0, n_f0, k = spec.max_hops, fmax_bin - fmin_bin, spec.top_k
    ps = np.asarray(power_sync, F32)
    nb, h_rows, _ = ps.shape
    plan = _qary_kernels.sync_plan(n_f0, k)
    strips, lists = plan["strips"], plan["lists"]
    bins = _qary_kernels.SYNC_TF
    width = strips * bins
    ring_n = _qary_kernels.SYNC_RING
    hops = [spec.os_t * sym for sym in spec.sync_syms]
    src = np.zeros((nb, h_rows, width), F32)
    src[:, :, :n_f0] = ps[:, :, :n_f0]
    acc = np.full((SYNC_CELLS * SYNC_WARPS, nb, width), -0.0, F32)
    if sync_congruent(hops):
        for w in range(SYNC_WARPS):
            wring = np.zeros((52, nb, width), F32)
            sched = sync_warp_schedule(hops, n_t0, w)
            for ev in sched["events"]:
                if ev[0] == "issue":
                    for m in ev[1]:
                        r = hops[0] + w + 8 * m
                        for sl in ([m % 32, m % 32 + 32] if m % 32 < 20
                                   else [m % 32]):
                            wring[sl] = src[:, r] if r < h_rows else 0.0
                else:
                    # a pair <= 4 class rows apart reads from the first
                    # window's slot through the mirror
                    c = (hops[ev[1]] - hops[0]) // 8
                    first = ev[3] if ev[3] is not None else ev[1]
                    c1 = (hops[first] - hops[0]) // 8
                    at = c1 % 32 + (c - c1) if (
                        sched["j"] == 16 and c - c1 <= 4) else c % 32
                    for j in range(sched["j"]):
                        t = w + 8 * j
                        acc[t] = acc[t] + wring[at + j]
    else:
        ring = np.zeros((ring_n, nb, width), F32)
        for ev in sync_schedule(hops, n_t0)["events"]:
            if ev[0] == "issue":
                for r in ev[1]:
                    ring[r % ring_n] = src[:, r] if r < h_rows else 0.0
            else:
                h = hops[ev[1]]
                for t in range(n_t0):
                    acc[t] = acc[t] + ring[(h + t) % ring_n]
    den = np.asarray(base, F32).reshape(-1) + TINY
    val = acc / den[None, :, None]                     # [t, B, f]
    t_i = np.arange(SYNC_CELLS * SYNC_WARPS)[:, None]
    f_i = np.arange(width)[None, :]
    cell = (t_i < n_t0) & (f_i < n_f0)
    idx = (t_i * n_f0 + f_i).astype(np.uint64)
    cap = _qary_kernels.sync_pool_cap(k)
    st = stats if stats is not None else {}
    st.setdefault("strip_pool", []), st.setdefault("merge_pool", [])
    tv, ti = [], []
    for b in range(nb):
        keys = np.where(cell, _order_key64(val[:, b], idx), np.uint64(0))
        lk, lv = [], []
        for blk in range(lists):
            list_k = np.zeros(0, np.uint64)
            list_v = np.zeros(0, F32)
            for strip in range(blk, strips, lists):
                sl = slice(strip * bins, (strip + 1) * bins)
                kk, vv = keys[:, sl], val[:, b, sl]
                # thread (warp w, lane l): offsets w + 8 j of bin l
                thr = kk.reshape(SYNC_CELLS, SYNC_WARPS, 32)
                thr = thr.transpose(1, 2, 0).reshape(SYNC_THREADS, -1)
                maxima = np.sort(thr.max(axis=1))[::-1]
                floor = (list_k[k - 1] + np.uint64(1) if len(list_k) == k
                         else np.uint64(1))
                tau = floor
                if k <= SYNC_THREADS and maxima[k - 1] >= floor:
                    tau = maxima[k - 1]
                take = kk >= tau
                pool_k = np.concatenate([list_k, kk[take]])
                pool_v = np.concatenate([list_v, vv[take]])
                assert len(pool_k) <= cap
                st["strip_pool"].append(len(pool_k))
                top = _top_by_rank(pool_k, k)
                list_k, list_v = pool_k[top], pool_v[top]
            pad = k - len(list_k)
            lk.append(np.concatenate([list_k, np.zeros(pad, np.uint64)]))
            lv.append(np.concatenate([list_v, np.zeros(pad, F32)]))
        lk, lv = np.stack(lk), np.stack(lv)
        heads = np.sort(lk[:, 0])[::-1]
        tau_w = (heads[k - 1] if len(heads) >= k and heads[k - 1] != 0
                 else np.uint64(1))
        take = lk >= tau_w
        pool_k, pool_v = lk[take], lv[take]
        assert len(pool_k) <= lists * k
        st["merge_pool"].append(len(pool_k))
        top = _top_by_rank(pool_k, k)
        tv.append(pool_v[top])
        ti.append((np.uint64(0xFFFFFFFF)
                   - (pool_k[top] & np.uint64(0xFFFFFFFF))).astype(np.int64))
    return np.stack(tv), np.stack(ti)


def planted_map(spec, n_windows: int = 3, seed: int = 5
                ) -> tuple[np.ndarray, np.ndarray]:
    """A q-ary sync map [B, H, F] of exponential noise with the zero pad
    rows, a strong sync track at (t1, f1) copied to a bin of another strip
    (equal scores in different cells) and a column of zeros (equal scores
    down the column), and its base [B, 1, 1] (the mean times the sync
    count); window 1 has a NaN entry under a finite base (NaN scores in
    one column), window 2 a NaN entry in its base too (every score NaN,
    the first K indices win)."""
    fmin_bin, fmax_bin, n_bins = qary_engine._bin_range(spec)
    n_hops = (int(spec.trperiod * 12_000) - spec.sps) // spec.hop + 1
    h = n_hops + 2 * spec.pad_hops
    rng = np.random.default_rng(seed)
    ps = rng.exponential(size=(n_windows, h, n_bins)).astype(F32)
    ps[:, :spec.pad_hops] = 0.0
    ps[:, -spec.pad_hops:] = 0.0
    t1, f1, f2 = 37, 100, 900
    for s in spec.sync_syms:
        ps[:, spec.os_t * s + t1, f1] += 40.0
    ps[:, :, f2] = ps[:, :, f1]
    ps[:, :, 1500] = 0.0
    base = torch.from_numpy(ps).mean(dim=(1, 2), keepdim=True).numpy() \
        * F32(len(spec.sync_syms))
    ps[1:, spec.os_t * spec.sync_syms[3] + 60, 333] = np.nan
    base[2:] = np.nan
    return ps, base


def _same_vals(got: np.ndarray, want: np.ndarray) -> bool:
    return bool(((got.view(np.uint32) == want.view(np.uint32))
                 | (np.isnan(got) & np.isnan(want))).all())


@pytest.mark.parametrize("mode", ["JT65", "Q65-30"])
def test_sync_model_matches_plain(mode):
    """The model is bit for bit the plain version on planted maps: ties
    in two strips, NaN scores first, a NaN base (every score NaN)."""
    spec = jt65.SPEC if mode == "JT65" else q65.SPEC
    ps, base = planted_map(spec)
    base = torch.from_numpy(base)
    want_v, want_i = (x.numpy() for x in qary_engine._qary_sync_plain(
        spec, torch.from_numpy(ps), base))
    got_v, got_i = sync_model(spec, ps, base.numpy())
    np.testing.assert_array_equal(got_i, want_i)
    assert _same_vals(got_v, want_v)
    n_f0 = qary_engine._bin_range(spec)[1] - qary_engine._bin_range(spec)[0]
    # window 0: the planted track and its copy tie, the lower bin first
    assert want_i[0, :2].tolist() == [37 * n_f0 + 100, 37 * n_f0 + 900]
    assert want_v[0, 0] == want_v[0, 1]
    # window 1: the NaN scores come first, by index, then the track
    n_nan = int(np.isnan(want_v[1]).sum())
    assert 1 < n_nan < spec.top_k and np.isnan(want_v[1, :n_nan]).all()
    assert (np.diff(want_i[1, :n_nan]) > 0).all()
    assert want_i[1, n_nan] == 37 * n_f0 + 100
    # window 2: every score NaN, the first K indices
    assert want_i[2].tolist() == list(range(spec.top_k))
    # on the CPU the dispatcher is the plain version
    got = qary_engine._qary_sync(spec, torch.from_numpy(ps), base)
    np.testing.assert_array_equal(got[1].numpy(), want_i)


def sync_spec(spec, n_f0: int, **kw):
    """``spec`` searched over bins [0, n_f0) (and ``kw`` replaced)."""
    return dataclasses.replace(spec, fmin_hz=0.0,
                               fmax_hz=(n_f0 + 0.5) * spec.bin_hz, **kw)


def sync_map(spec, n_windows: int, seed: int, kind: str = "noise"
             ) -> tuple[np.ndarray, np.ndarray]:
    """A map [B, H, F] for ``spec`` (H = the last window's end + 8, F the
    bins with headroom) and its base [B, 1, 1]: exponential noise,
    integers 0 to 2 (ties everywhere) or ones (every score equal)."""
    _, _, n_bins = qary_engine._bin_range(spec)
    h = spec.os_t * max(spec.sync_syms) + spec.max_hops + 8
    rng = np.random.default_rng(seed)
    shape = (n_windows, h, n_bins)
    if kind == "noise":
        ps = rng.exponential(size=shape)
    elif kind == "ints":
        ps = rng.integers(0, 3, shape)
    else:
        ps = np.ones(shape)
    ps = ps.astype(F32)
    base = ps.mean(axis=(1, 2), keepdims=True).astype(F32) * F32(
        len(spec.sync_syms))
    return ps, base


def sync_edge_cases() -> dict:
    """The selection's edges by name: (spec, map, base).  Ties in every
    strip and across a strip's warps, every score equal across three
    warps, n_f0 one bin either side of each strip width, top-K 1 and 256,
    fewer time offsets than a block's 128, one sync symbol, gaps between
    sync symbols past the ring's look-ahead and past the ring, and hops
    that are not all congruent mod 8 (os_t 3: the block's shared ring)."""
    jt, q = jt65.SPEC, q65.SPEC
    cases = {
        "ties": (sync_spec(jt, 100), "ints"),
        "all equal": (sync_spec(jt, 10), "ones"),
        "k1": (sync_spec(q, 200, top_k=1), "noise"),
        "k256": (sync_spec(q, 200, top_k=256), "ints"),
        "k256 all equal": (sync_spec(q, 40, top_k=256), "ones"),
        "n_t0 50": (sync_spec(q, 150, max_hops=50), "noise"),
        "one symbol": (sync_spec(q, 90, sync_syms=(5,)), "noise"),
        "gap past the look-ahead": (
            sync_spec(q, 70, sync_syms=(0, 1, 20, 21, 50)), "noise"),
        "gap past the ring": (
            sync_spec(q, 70, sync_syms=(2, 40, 41, 90)), "ints"),
        # hops not all congruent mod 8: the block's shared ring
        "os_t 3": (sync_spec(q, 120, os_t=3), "noise"),
        "os_t 3 gap past the ring": (
            sync_spec(q, 70, os_t=3, sync_syms=(2, 40, 41, 150)), "ints"),
    }
    for n_f0 in (31, 32, 33, 63, 64, 65):
        cases[f"n_f0 {n_f0}"] = (sync_spec(q, n_f0), "noise")
    out = {}
    for i, (name, (spec, kind)) in enumerate(cases.items()):
        ps, base = sync_map(spec, 2, 40 + i, kind)
        out[name] = (spec, ps, base)
    return out


@pytest.mark.parametrize("name", list(sync_edge_cases()))
def test_sync_model_on_edge_cases(name):
    """The model is bit for bit the plain version on each edge; its pools
    stay within their caps."""
    spec, ps, base = sync_edge_cases()[name]
    want_v, want_i = (x.numpy() for x in qary_engine._qary_sync_plain(
        spec, torch.from_numpy(ps), torch.from_numpy(base)))
    got_v, got_i = sync_model(spec, ps, base)
    np.testing.assert_array_equal(got_i, want_i)
    assert _same_vals(got_v, want_v)
    if name == "all equal":
        # the first 24 indices: offsets 0 to 2, three warps
        assert want_i[0].tolist() == list(range(24))


@pytest.mark.parametrize("name", ["JT65", "Q65-30", "n_t0 50", "one symbol",
                                  "gap past the look-ahead",
                                  "gap past the ring", "os_t 3",
                                  "os_t 3 gap past the ring"])
def test_sync_schedule_holds_its_invariants(name):
    """Both load schedules issue each row of the windows' union once and
    no other, never overwrite a slot whose row is still to be read, and
    sum a window only once its rows' groups are complete: the block's
    shared ring for any hops (JT65's and Q65's windows with a barrier a
    window), and each warp's own ring where the hops are congruent mod 8
    (every mode's)."""
    if name in ("JT65", "Q65-30"):
        spec = jt65.SPEC if name == "JT65" else q65.SPEC
    else:
        spec = sync_edge_cases()[name][0]
    hops = [spec.os_t * s for s in spec.sync_syms]
    got = sync_schedule(hops, spec.max_hops)
    sums = [e for e in got["events"] if e[0] == "sum"]
    assert [e[1] for e in sums] == list(range(len(hops)))
    if name == "JT65":
        assert got["rows"] == 1128 and got["barriers"] == 63
    elif name == "Q65-30":
        assert got["rows"] == 800 and got["barriers"] == 22
    elif name.endswith("gap past the ring"):
        assert got["barriers"] > len(hops)
    assert sync_congruent(hops) == (spec.os_t == 8)
    if sync_congruent(hops):
        for w in range(SYNC_WARPS):
            got = sync_warp_schedule(hops, spec.max_hops, w)
            sums = [e for e in got["events"] if e[0] == "sum"]
            assert [e[1] for e in sums] == list(range(len(hops)))


def test_sync_model_matches_the_decode_program():
    """The model on the sync map ``qary_decode_program`` builds for a Q65
    decode gives the scores and candidates the program picks."""
    spec = dataclasses.replace(q65.SPEC, top_k=6)
    dec = q65.Q65Decoder(top_k=6, device="cpu")
    rng = np.random.default_rng(8)
    clean = q65.synthesize("VE3XYZ G4ABC IO91", 1400.0)
    audio = np.stack([add_noise_at_snr(clean, -18.0, 12_000, rng),
                      rng.standard_normal(len(clean))]).astype(F32)
    seen = {}
    sync = qary_engine._qary_sync

    def rec(spec_, power_sync, base):
        seen["ps"], seen["base"] = power_sync.clone(), base.clone()
        return sync(spec_, power_sync, base)

    qary_engine._qary_sync = rec
    try:
        out = dec.decode_arrays(audio)
    finally:
        qary_engine._qary_sync = sync
    got_v, got_i = sync_model(spec, seen["ps"].numpy(), seen["base"].numpy())
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    n_f0 = fmax_bin - fmin_bin
    np.testing.assert_array_equal(out["score"], got_v)
    np.testing.assert_array_equal(out["t0_hop"], got_i // n_f0
                                  - spec.pad_hops)
    np.testing.assert_array_equal(out["f0_bin"], got_i % n_f0 + fmin_bin)


# ---------------------------------------------------------------------------
# routing and refusals


@pytest.fixture
def no_build(monkeypatch):
    def build():
        raise AssertionError("the library was built")

    monkeypatch.setattr(_qary_kernels, "load_library", build)
    monkeypatch.setattr(_median_kernels, "load_library", build)


def test_cpu_tensors_run_the_plain_versions(no_build, priors):
    """On CPU tensors the dispatchers run the plain versions (equal
    results), load no library and count no launch; on another device they
    go to the kernel wrappers, which refuse a device that is not CUDA."""
    before = {**_qary_kernels.launches, **_median_kernels.launches}
    dec = q65._mp(torch.device("cpu"))
    words = torch.from_numpy(priors[:6])
    got, want = dec.decode(words), dec.decode_plain(words)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = torch.from_numpy(median_rows_cases()["ties"])
    assert torch.equal(gfsk_engine._median_rows(x),
                       gfsk_engine._median_rows_plain(x))
    spec = dataclasses.replace(q65.SPEC, top_k=5)
    ps, base = (torch.from_numpy(x) for x in planted_map(spec, 2))
    got = qary_engine._qary_sync(spec, ps, base)
    want = qary_engine._qary_sync_plain(spec, ps, base)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got[1], want[1])
    assert {**_qary_kernels.launches, **_median_kernels.launches} == before
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode(words.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gfsk_engine._median_rows(x.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        _qary_kernels.qary_sync(ps.to("meta"), base.reshape(-1).to("meta"),
                                torch.zeros(22, dtype=torch.int32,
                                            device="meta"), 128, 100, 5)


def test_qary_wrapper_refusals(no_build):
    """Wrong dtypes, shapes, contiguity and limits raise before any
    build."""
    dec = q65._mp(torch.device("cpu"))
    code = dec.kernel_code
    tab = torch.from_numpy(dec.kernel_tables())
    probs = torch.full((4, 63, 64), 1 / 64)
    mp = _qary_kernels.qra_mp
    with pytest.raises(ValueError, match="dtype"):
        mp(tab, probs.double(), code, 60)
    with pytest.raises(ValueError, match="shape"):
        mp(tab, probs[:, :62], code, 60)
    with pytest.raises(ValueError, match="shape"):
        mp(tab[:100], probs, code, 60)
    with pytest.raises(ValueError, match="3-D"):
        mp(tab, probs[0], code, 60)
    with pytest.raises(ValueError, match="contiguous"):
        mp(tab, probs.transpose(0, 1).contiguous().transpose(0, 1), code,
           60)
    with pytest.raises(ValueError, match="iters"):
        mp(tab, probs, code, -1)
    for bad in ((65, 50, 4, 4), (63, 64, 4, 4), (63, 50, 5, 4),
                (63, 50, 4, 5), (63, 50, 4, 9)):
        with pytest.raises(ValueError, match="the kernel takes n"):
            mp(tab, probs, bad, 60)
    with pytest.raises(ValueError, match="CUDA"):
        mp(tab, probs, code, 60)
    med = _median_kernels.median_rows
    x = torch.zeros((4, 100))
    with pytest.raises(ValueError, match="dtype"):
        med(x.double())
    with pytest.raises(ValueError, match="2-D"):
        med(x[None, None])
    with pytest.raises(ValueError, match="contiguous"):
        med(torch.zeros((2, 1_200_000, 1))[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        med(x.t().contiguous().t())
    with pytest.raises(ValueError, match="rows"):
        med(torch.zeros((0, 100)))
    with pytest.raises(ValueError, match="values a row"):
        med(torch.zeros((4, 0)))
    with pytest.raises(ValueError, match="CUDA"):
        med(x)
    sync = _qary_kernels.qary_sync
    ps = torch.zeros((2, 921, 2420))
    base = torch.ones(2)
    hops = torch.arange(22, dtype=torch.int32) * 8
    with pytest.raises(ValueError, match="dtype"):
        sync(ps.double(), base, hops, 128, 2160, 24)
    with pytest.raises(ValueError, match="dtype"):
        sync(ps, base, hops.long(), 128, 2160, 24)
    with pytest.raises(ValueError, match="shape"):
        sync(ps, base[:1], hops, 128, 2160, 24)
    with pytest.raises(ValueError, match="3-D"):
        sync(ps[0], base, hops, 128, 2160, 24)
    with pytest.raises(ValueError, match="contiguous"):
        sync(ps.transpose(1, 2).contiguous().transpose(1, 2), base, hops,
             128, 2160, 24)
    for n_t0, k in ((129, 24), (128, 257), (128, 0)):
        with pytest.raises(ValueError, match="the kernel takes at most"):
            sync(ps, base, hops, n_t0, 2160, k)
    with pytest.raises(ValueError, match="n_f0"):
        sync(ps, base, hops, 128, 2421, 24)
    with pytest.raises(ValueError, match="top_k at most the scores"):
        sync(ps, base, hops, 2, 10, 24)
    with pytest.raises(ValueError, match="CUDA"):
        sync(ps, base, hops, 128, 2160, 24)


def test_decoder_contracts_on_the_card(no_build):
    """A q-ary decoder for a card refuses a search the sync kernel does
    not take when it is built; on the CPU it stays."""
    with pytest.raises(ValueError, match="the kernel takes at most"):
        jt65.JT65Decoder(top_k=300, device="cuda")
    with pytest.raises(ValueError, match="the kernel takes at most"):
        qary_engine.check_sync_kernel(dataclasses.replace(q65.SPEC,
                                                          top_k=300))
    assert q65.Q65Decoder(top_k=300, device="cpu").spec.top_k == 300
    unsorted = dataclasses.replace(q65.SPEC, sync_syms=(8, 0, 11))
    with pytest.raises(ValueError, match="ascending"):
        qary_engine.check_sync_kernel(unsorted)


def test_qary_kernels_raise_without_library(monkeypatch, tmp_path):
    """A CUDA-typed call with no nvcc and no built library raises "nvcc
    not found" rather than running the plain version; no launch is
    counted."""
    for mod in (_qary_kernels, _median_kernels):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(mod, "_check", lambda operands: None)
    monkeypatch.setattr(_qary_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    before = {**_qary_kernels.launches, **_median_kernels.launches}
    dec = q65._mp(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _qary_kernels.qra_mp(torch.from_numpy(dec.kernel_tables()),
                             torch.zeros((2, 63, 64)), dec.kernel_code, 60)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _median_kernels.median_rows(torch.zeros((2, 10)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _qary_kernels.qary_sync(torch.zeros((1, 921, 2420)), torch.ones(1),
                                torch.zeros(22, dtype=torch.int32), 128,
                                2160, 24)
    assert {**_qary_kernels.launches, **_median_kernels.launches} == before
