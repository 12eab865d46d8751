"""NumPy models of the q-ary decode's last three hand kernels against
their plain versions, on the CPU (the kernels themselves run on the card:
``tests/test_torch_cuda.py``).

- ``qary_symbols`` (``modes/csrc/qary.cu``): G lanes a row (8 kept; 4, 16
  and 32 built for comparison), lane l holding tones l + G j; the sum as
  the in-lane folds by halves and the group's butterfly, the top 4 as each
  lane's sorted fours merged and the group's butterfly merges of sorted
  lists, each energy read back from its invertible key: top_e, top_tone
  and e_sum bit for bit ``_symbol_energies_plain`` on rows with ties within
  and across a group's lanes, NaNs of several payloads, -0.0 beside 0.0,
  infinities and a flat row; a row outside the map gives NaN and tone -1.
- ``chase_erasures`` (``modes/csrc/chase.cu``): the rank by counting order
  keys, the weights' windowed row sum, Threefry-2x32 in uint32 of each
  element's index in the whole draw, warp w taking trials w, w + 8, ...:
  bit for bit ``chase_erasures_plain`` at JT65's shape, at chunk offsets,
  and at other word lengths, trial counts and tiers.
- ``chase_score`` (``modes/csrc/chase.cu``): each symbol's five terms and
  its table of 64 (a corrected value's term), the tone bytes' compare for
  values of 64 or more, the stages' bytes read as words from a slot with
  whatever lies past them, four lanes a trial with four partial sums each,
  the quad's butterfly, each lane's best, the warps' best and their merge
  (the lower trial on ties, NaN the largest): info and ok identical to
  ``chase_score_plain``, the score within 1e-5, the best trial the plain
  version's on planted ties, also where a candidate's T x n bytes are no
  multiple of 16 and for tones outside [0, 63].
- the wrappers' refusals (before any build) and the decoders' dispatch:
  CPU tensors never reach a kernel.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cwsl_digi_tpu_torch.modes import (_chase_kernels, _qary_kernels, jt65,
                                       qary_engine, rs_device, rs64)

torch.set_num_threads(1)
U32 = np.uint32


# --------------------------------------------------------------------------
# shared pieces of the models
# --------------------------------------------------------------------------

def order_key(x: np.ndarray) -> np.ndarray:
    """qary.cu / chase.cu ``order_key``: float32 as uint32 in ascending
    order, -0.0 read as 0.0, every NaN above +inf (uint64 for packing)."""
    x = np.asarray(x, np.float32)
    u = np.where(x == 0, 0, x.view(U32)).astype(U32)
    k = np.where(u & U32(0x80000000), ~u, u | U32(0x80000000)).astype(U32)
    return np.where(np.isnan(x), U32(0xFFFFFFFF), k).astype(np.uint64)


def butterfly_sum(lanes: np.ndarray, width: int = 32) -> np.ndarray:
    """A group's __shfl_xor_sync sum (width / 2, ..., 2, 1 apart) of
    ``width`` float32 lane values [..., width]: lane 0's result (every
    lane's is the same)."""
    x = lanes.astype(np.float32)
    off = width // 2
    while off:
        x = (x + x[..., np.arange(width) ^ off]).astype(np.float32)
        off //= 2
    return x[..., 0]


# --------------------------------------------------------------------------
# qary_symbols
# --------------------------------------------------------------------------

def sym_keys(v: np.ndarray, tones: np.ndarray) -> np.ndarray:
    """qary.cu ``sym_key``: (order key << 32) | (63 - tone) << 26 | the
    energy's sign << 23 | its mantissa, uint64."""
    u = np.asarray(v, np.float32).view(U32).astype(np.uint64)
    low = ((np.uint64(63) - tones.astype(np.uint64)) << np.uint64(26)) \
        | ((u >> np.uint64(8)) & np.uint64(0x800000)) \
        | (u & np.uint64(0x7FFFFF))
    return (order_key(v) << np.uint64(32)) | low


def sym_values(keys: np.ndarray) -> np.ndarray:
    """qary.cu ``sym_value``: the energy a key holds, bit for bit."""
    hi = (keys >> np.uint64(32)).astype(U32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(U32)
    sign = (lo & U32(0x800000)) << U32(8)
    bits = np.where(hi == U32(0xFFFFFFFF),
                    sign | U32(0x7F800000) | (lo & U32(0x7FFFFF)),
                    np.where(hi == U32(0x80000000), sign,
                             np.where(hi & U32(0x80000000),
                                      hi & U32(0x7FFFFFFF), ~hi)))
    return bits.astype(U32).view(np.float32)


def _cas(a: np.ndarray, b: np.ndarray):
    return np.maximum(a, b), np.minimum(a, b)


def sort4(k: list) -> list:
    """qary.cu ``sym_sort4``: the network on four key arrays, descending."""
    k = list(k)
    k[0], k[1] = _cas(k[0], k[1])
    k[2], k[3] = _cas(k[2], k[3])
    k[0], k[2] = _cas(k[0], k[2])
    k[1], k[3] = _cas(k[1], k[3])
    k[1], k[2] = _cas(k[1], k[2])
    return k


def merge4(a: list, b: list) -> list:
    """qary.cu ``sym_merge4``: the top 4 of two descending lists."""
    c = [np.maximum(a[i], b[3 - i]) for i in range(4)]
    c[0], c[2] = _cas(c[0], c[2])
    c[1], c[3] = _cas(c[1], c[3])
    c[0], c[1] = _cas(c[0], c[1])
    c[2], c[3] = _cas(c[2], c[3])
    return c


def symbols_model(e: np.ndarray, group: int = 8, inside=None):
    """The kernel at ``group`` lanes a row: rows [R, 64] float32 (and which
    lie inside the map, all by default) -> (top_e [R, 4], top_tone [R, 4],
    e_sum [R]).  Lane l of a row's group holds tones l + G j."""
    e = e.astype(np.float32)
    if inside is not None:
        e = np.where(np.asarray(inside)[:, None], e,
                     np.uint32(0x7FC00000).view(np.float32))
    g, t = group, 64 // group
    tones = np.arange(64).reshape(t, g).T            # [G, T]: lane, j
    v = e[:, tones]                                  # [R, G, T]
    f = v.copy()
    h = t // 2
    while h:                                         # the lane's folds
        f[..., :h] = (f[..., :h] + f[..., h:2 * h]).astype(np.float32)
        h //= 2
    e_sum = butterfly_sum(f[..., 0], g)
    keys = sym_keys(v, np.broadcast_to(tones, v.shape))
    if t == 2:
        hi, lo = _cas(keys[..., 0], keys[..., 1])
        zero = np.zeros_like(hi)
        top = [hi, lo, zero, zero]
    else:
        fours = [sort4([keys[..., 4 * b + j] for j in range(4)])
                 for b in range(t // 4)]
        w = 1
        while w < t // 4:
            for b in range(0, t // 4, 2 * w):
                fours[b] = merge4(fours[b], fours[b + w])
            w *= 2
        top = fours[0]                               # each [R, G]
    off = g // 2
    while off:                                       # the group's merges
        other = [k[:, np.arange(g) ^ off] for k in top]
        top = merge4(top, other)
        off //= 2
    top = np.stack([k[:, 0] for k in top], axis=1)   # lane 0's [R, 4]
    top_tone = 63 - ((top >> np.uint64(26)) & np.uint64(63)).astype(np.int64)
    if inside is not None:
        top_tone = np.where(np.asarray(inside)[:, None], top_tone, -1)
    return sym_values(top), top_tone, e_sum


def _symbol_rows(rng) -> np.ndarray:
    """Rows of tone energies with the cases the selection must order: ties
    (two, three and all 64 equal), NaN, +-inf, -0.0 beside 0.0, zeros,
    exponential noise."""
    rows = rng.exponential(1.0, (40, 64)).astype(np.float32)
    rows[0, [5, 9]] = 9.0                      # tie of the best two
    rows[1, [2, 40, 63]] = 7.0                 # three-way tie
    rows[2] = 1.5                              # every tone equal
    rows[3, 11] = np.nan
    rows[4, [0, 33]] = np.nan
    rows[5, 17] = np.inf
    rows[6, [3, 4]] = -np.inf
    rows[7] = 0.0
    rows[7, ::2] = -0.0
    rows[8, [31, 32]] = 5.0                    # tie across the two halves
    rows[9, [1, 2, 3, 4]] = [1e-38, 1e-45, 3.4e38, 3.4e38]
    return rows


def test_symbols_model_matches_plain():
    """The warp's top-4 and sum bit for bit the plain version's stable sort
    and halving sum; the margin is the plain version's logs of the model's
    best two."""
    rows = _symbol_rows(np.random.default_rng(1))
    spec = qary_engine.QarySpec(
        name="t", n_sym=1, sps=64, n_tones=64, tone_offset=0, sync_syms=(),
        data_syms=(0,), trperiod=1.0, os_t=1, os_f=1)
    power = torch.from_numpy(rows)[None]             # [1, 40, 64]
    t0 = torch.arange(len(rows))[None]               # a candidate a row
    f0 = torch.zeros_like(t0)
    _e, top_e, top_tone, e_sum, margin = qary_engine._symbol_energies_plain(
        spec, power, t0, f0, torch.zeros(1, dtype=torch.int32))
    m_e, m_tone, m_sum = symbols_model(rows)
    np.testing.assert_array_equal(m_tone, top_tone[0, :, 0].numpy())
    np.testing.assert_array_equal(m_e.view(U32),
                                  top_e[0, :, 0].numpy().view(U32))
    np.testing.assert_array_equal(m_sum.view(U32),
                                  e_sum[0, :, 0].numpy().view(U32))
    assert m_tone[0, :2].tolist() == [5, 9]
    assert m_tone[2].tolist() == [0, 1, 2, 3]
    assert m_tone[4, :2].tolist() == [0, 33]
    want = (torch.log(torch.from_numpy(m_e[:, 0]) + 1e-30)
            - torch.log(torch.from_numpy(m_e[:, 1]) + 1e-30))
    np.testing.assert_array_equal(margin[0, :, 0].numpy(), want.numpy())


def test_halving_sum_is_the_warp_fold():
    """_halving_sum over 64 values is the lane pairs plus the butterfly, bit
    for bit, and differs from a sequential sum on some rows (so the fixed
    order matters); the kept layout's in-lane folds then the group's
    butterfly give the same sum."""
    x = np.random.default_rng(2).exponential(1.0, (500, 64)).astype(
        np.float32) * np.float32(1e3)
    got = qary_engine._halving_sum(torch.from_numpy(x)).numpy()
    want = butterfly_sum((x[:, :32] + x[:, 32:]).astype(np.float32))
    np.testing.assert_array_equal(got.view(U32), want.view(U32))
    np.testing.assert_array_equal(symbols_model(x)[2].view(U32),
                                  want.view(U32))
    seq = np.zeros(len(x), np.float32)
    for i in range(64):
        seq = (seq + x[:, i]).astype(np.float32)
    assert (seq != got).any()


def _group_edge_rows(kind: str, rng) -> np.ndarray:
    """Rows for what a group's merge of sorted lists can get wrong."""
    rows = rng.exponential(1.0, (8, 64)).astype(np.float32)
    if kind == "ties across lanes":
        rows[0, [1, 2]] = 9.0            # neighbouring lanes, one j
        rows[1, [3, 11]] = 9.0           # one lane (G 8), two j
        rows[2, [7, 8, 40]] = 9.0        # lane 7 j 0, lane 0 j 1, far
        rows[3, [0, 16, 32, 48]] = 9.0   # one lane at 4, 8 and 16 lanes
        rows[4, [5, 37]] = 9.0           # the halves' pair
        rows[5, [63, 62, 61, 60, 59]] = 9.0
        rows[6] = np.round(rows[6] * 2) / 2
        rows[7, ::9] = 5.0
    elif kind == "nans":
        payloads = np.asarray([0x7FC00000, 0x7FC00001, 0xFFC00000,
                               0x7F800001, 0xFFFFFFFF], np.uint32)
        for r in range(8):
            at = rng.choice(64, size=1 + r % 5, replace=False)
            rows[r, at] = payloads[:len(at)].view(np.float32)
        rows[7] = np.uint32(0x7FC00000).view(np.float32)
    elif kind == "signed zeros":
        rows[:] = 0.0
        rows[:, 1::3] = -0.0
        rows[1, 20] = 1e-45
        rows[2, [5, 6]] = -1e-45
        rows[3, 63] = -np.inf
        rows[4, 40] = np.inf
    elif kind == "flat":
        rows[:] = 1.5
        rows[1] = 0.0
        rows[2] = -0.0
        rows[3] = np.inf
    return rows


@pytest.mark.parametrize("group", [4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["ties across lanes", "nans",
                                  "signed zeros", "flat"])
def test_symbols_group_model_matches_plain(group, kind):
    """The kernel's layout at every group it is built for, bit for bit the
    plain version's stable sort and halving sum on the rows a group's
    merge can get wrong, NaN payloads and the sign of zero included; rows
    outside the map give NaN energies and tone -1."""
    rows = _group_edge_rows(kind, np.random.default_rng(group))
    spec = qary_engine.QarySpec(
        name="t", n_sym=1, sps=64, n_tones=64, tone_offset=0, sync_syms=(),
        data_syms=(0,), trperiod=1.0, os_t=1, os_f=1)
    power = torch.from_numpy(rows)[None]
    t0 = torch.arange(len(rows))[None]
    _e, top_e, top_tone, e_sum, _m = qary_engine._symbol_energies_plain(
        spec, power, t0, torch.zeros_like(t0),
        torch.zeros(1, dtype=torch.int32))
    m_e, m_tone, m_sum = symbols_model(rows, group)
    np.testing.assert_array_equal(m_tone, top_tone[0, :, 0].numpy())
    np.testing.assert_array_equal(m_e.view(U32),
                                  top_e[0, :, 0].numpy().view(U32))
    # a sum's NaN payload follows the order of its adds (the CPU keeps a
    # first operand's, the card writes its own), so NaN equals NaN there
    want = e_sum[0, :, 0].numpy()
    both_nan = np.isnan(m_sum) & np.isnan(want)
    np.testing.assert_array_equal(np.where(both_nan, 0, m_sum.view(U32)),
                                  np.where(both_nan, 0, want.view(U32)))
    inside = np.arange(len(rows)) % 3 != 1
    o_e, o_tone, o_sum = symbols_model(rows, group, inside)
    assert (o_tone[~inside] == -1).all() and np.isnan(o_e[~inside]).all()
    assert np.isnan(o_sum[~inside]).all()
    np.testing.assert_array_equal(o_tone[inside], m_tone[inside])
    np.testing.assert_array_equal(o_e[inside].view(U32),
                                  m_e[inside].view(U32))


# --------------------------------------------------------------------------
# chase_erasures
# --------------------------------------------------------------------------

ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_u32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 in uint32 arithmetic, as chase.cu's threefry2x32."""
    k0, k1 = U32(k0), U32(k1)
    ks = (k0, k1, U32(k0 ^ k1 ^ U32(0x1BD11BDA)))
    x0 = (x0.astype(U32) + ks[0]).astype(U32)
    x1 = (x1.astype(U32) + ks[1]).astype(U32)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in ROT[i % 2]:
                x0 = (x0 + x1).astype(U32)
                x1 = (((x1 << U32(r)) | (x1 >> U32(32 - r))) ^ x0).astype(U32)
            x0 = (x0 + ks[(i + 1) % 3]).astype(U32)
            x1 = (x1 + ks[(i + 2) % 3] + U32(i + 1)).astype(U32)
    return x0, x1


def erasures_model(margin: np.ndarray, seed: int, c0: int, n_trials: int,
                   tiers, nroots: int) -> np.ndarray:
    """The kernel's flags [C, T, n]: a block a candidate, its rank by
    counting keys, the weights' windowed sum by one thread, the key folded
    by one thread, warp w trials w, w + 8, ... and lanes l, l + 32."""
    c, n = margin.shape
    n_det, n_sto = len(tiers), n_trials - len(tiers)
    base_p = rs_device.chase_base_p(n)
    depth = rs_device.chase_depth(nroots, n_sto)
    f0, f1 = threefry_u32(0, 17, np.zeros(1, U32),
                          np.asarray([seed & 0xFFFFFFFF], U32))
    out = np.zeros((c, n_trials, n), bool)
    for ci in range(c):
        keys = order_key(margin[ci])
        pos = np.arange(n)
        rank = np.asarray([np.sum((keys < keys[i]) | ((keys == keys[i])
                                                      & (pos < i)))
                           for i in range(n)])
        p = base_p[rank]
        total = None
        for w0 in range(0, n, 32):
            acc = p[w0]
            for v in p[w0 + 1 : w0 + 32]:
                acc = np.float32(acc + v)
            total = acc if total is None else np.float32(total + acc)
        ratio = (depth / total).astype(np.float32)
        for warp in range(8):
            for t in range(warp, n_trials, 8):
                for half in range(2):
                    i = np.arange(32) + 32 * half
                    i = i[i < n]
                    if t < n_det:
                        out[ci, t, i] = rank[i] < tiers[t]
                        continue
                    s = t - n_det
                    idx = (np.uint64(c0 + ci) * np.uint64(n_sto * n)
                           + np.uint64(s * n) + i.astype(np.uint64))
                    b0, b1 = threefry_u32(f0[0], f1[0],
                                          (idx >> np.uint64(32)).astype(U32),
                                          (idx & np.uint64(0xFFFFFFFF))
                                          .astype(U32))
                    u = (((b0 ^ b1) >> U32(9)) | U32(0x3F800000)).view(
                        np.float32) - np.float32(1.0)
                    out[ci, t, i] = u < (p[i] * ratio[s]).astype(np.float32)
    return out


def _margins(rng, c: int, n: int) -> np.ndarray:
    m = rng.standard_normal((c, n)).astype(np.float32)
    m[0, 3:20] = m[0, 3]                       # ties keep position order
    m[1, ::2] = 0.0
    m[1, 1::2] = -0.0
    if c > 2:
        m[2, [0, 7]] = np.nan                  # NaN last
        m[2, 9] = -np.inf
    return m


@pytest.mark.parametrize("n,n_trials,tiers,nroots,c0,seed", [
    (63, 256, (0, 8, 16, 24, 32, 40), 51, 0, 12345),
    (63, 256, (0, 8, 16, 24, 32, 40), 51, 1021, 2**31 - 1),
    (40, 64, (0, 8), 20, 7, 5),
    (64, 9, (), 30, 3, 77),
])
def test_erasures_model_matches_plain(n, n_trials, tiers, nroots, c0, seed):
    """The kernel's flags bit for bit the plain version's, at JT65's shape
    and a chunk offset past 2**32 / (n_sto n) candidates' worth of index
    bits, at a word of 40 in two windows and one of 64 with no
    deterministic trials."""
    margin = _margins(np.random.default_rng(n + c0), 3, n)
    want = rs_device.chase_erasures_plain(nroots, n_trials, len(tiers),
                                          torch.from_numpy(margin),
                                          torch.tensor(seed), c0)
    assert tuple(rs_device.DET_TIERS[:len(tiers)]) == tiers
    got = erasures_model(margin, seed, c0, n_trials, tiers, nroots)
    np.testing.assert_array_equal(got, want.numpy())
    assert 0 < want[:, len(tiers):].float().mean() < 1


def test_chase_index_reaches_past_32_bits():
    """At the chunk offsets of a large batch the draw's element index
    exceeds 2**32, so its high word, the counter's first, is not 0."""
    c0 = 2**32 // (250 * 63) + 1
    assert c0 * 250 * 63 >= 2**32
    test_erasures_model_matches_plain(63, 256, (0, 8, 16, 24, 32, 40), 51,
                                      c0, 9)


def test_rank_model_matches_stable_argsort():
    m = _margins(np.random.default_rng(3), 6, 63)
    keys = order_key(m)
    pos = np.arange(63)
    want = rs_device.confidence_rank(torch.from_numpy(m)).numpy()
    for ci in range(len(m)):
        got = [np.sum((keys[ci] < keys[ci, i])
                      | ((keys[ci] == keys[ci, i]) & (pos < i)))
               for i in range(63)]
        np.testing.assert_array_equal(got, want[ci])
    assert want[2, 0] == 61 and want[2, 7] == 62 and want[2, 9] == 0


# --------------------------------------------------------------------------
# chase_score
# --------------------------------------------------------------------------

def better(a: float, ia: int, b: float, ib: int) -> bool:
    na, nb = np.isnan(a), np.isnan(b)
    if na or nb:
        return bool(na and (not nb or ia < ib))
    return bool(a > b or (a == b and ia < ib))


SC_LANES = _chase_kernels.SCORE_LANES        # lanes a trial
SC_SPAN = 64 // SC_LANES                     # symbols a lane
SC_STAGE = _chase_kernels.SCORE_STAGE        # trials a stage
SC_WARPS = _chase_kernels.SCORE_WARPS
SC_READ_PAD = 68     # bytes past a stage its last lane's words may reach


def score_tables(te, tn, es, n):
    """A candidate's symbols' rows [64, 6] (the floor's term, the four
    tones' terms, the tones as the bytes of a word, a tone outside [0, 255]
    taking the first inside tone's byte and term) and term tables [64, 64]
    (a corrected value below 64: its first tone's term, else the floor's),
    zeros past n, as the kernel's prologue builds them."""
    f32 = np.float32
    floor = ((es - (((te[:, 0] + te[:, 1]) + te[:, 2]) + te[:, 3]))
             / f32(60)).astype(f32)
    den = (es / f32(n) + f32(1e-30)).astype(f32)
    terms = np.log(((np.concatenate([te, floor[:, None]], axis=1)
                     + f32(1e-30)) / den[:, None]).astype(f32)).astype(f32)
    rows = np.zeros((64, 6), f32)
    lut = np.zeros((64, 64), f32)
    for i in range(n):
        valid = (tn[i] >= 0) & (tn[i] <= 255)
        first = int(np.argmax(valid)) if valid.any() else 4
        word = 0
        for h in range(4):
            src = h if valid[h] else first
            byte = int(tn[i, src]) if src < 4 else 0
            word |= byte << (8 * h)
            rows[i, 1 + h] = terms[i, src]
        rows[i, 0] = terms[i, 4]
        rows[i, 5] = np.uint32(word).view(f32)
        lut[i] = terms[i, 4]
        for h in (3, 2, 1, 0):
            if 0 <= tn[i, h] < 64:
                lut[i, tn[i, h]] = terms[i, h]
    return rows, lut


def term_slow(row, c: int):
    """chase.cu ``sc_term_slow``: the tone bytes' compare of a value."""
    x = np.uint32(row[5].view(U32)) ^ U32(c * 0x01010101)
    with np.errstate(over="ignore"):
        z = (x - U32(0x01010101)) & ~x & U32(0x80808080)
    ffs = int(z & -z).bit_length() if z else 0
    return row[ffs >> 3]


def stage_words(slab: np.ndarray, s: int, t_n: int, n: int, rng):
    """Stage s's slot as the lanes read it: its trials' bytes, then bytes of
    whatever lies past them up to the slot's end, as little-endian words."""
    t1 = min(SC_STAGE * (s + 1), t_n)
    body = slab[SC_STAGE * s:t1].reshape(-1)
    slot_b = -(-(SC_STAGE * n + SC_READ_PAD) // 16) * 16
    buf = rng.integers(0, 256, slot_b, dtype=np.uint8)
    buf[:len(body)] = body
    return buf.view("<u4").astype(np.uint64)


def score_model(k: int, accept: float, corrected, ok, era, top_e, top_tone,
                e_sum, seed: int = 0):
    """The kernel's (info, best_score, best_ok, best trial): a block a
    candidate, four lanes a trial (lane q its symbols 16 q .. 16 q + 15,
    read as words of its stage's slot, funnel-shifted and cut at n), a
    partial sum a symbol place in a word, the lane's sum and the quad's
    butterfly; each lane's best over the stages, the warp's over its
    quads, warp 0's over the warps."""
    c, t_n, n = corrected.shape
    f32 = np.float32
    rng = np.random.default_rng(seed)
    info = np.zeros((c, k), np.int64)
    best_score = np.zeros(c, np.float32)
    best_ok = np.zeros(c, bool)
    best_trial = np.zeros(c, np.int64)
    gate = f32(0.6 * accept)
    local = np.arange(SC_STAGE)
    for ci in range(c):
        rows, lut = score_tables(top_e[ci], top_tone[ci], e_sum[ci], n)
        wb = [None] * SC_WARPS
        for s in range(-(-t_n // SC_STAGE)):
            cws = stage_words(corrected[ci], s, t_n, n, rng)
            ews = stage_words(era[ci].astype(np.uint8), s, t_n, n, rng)
            lane_sum = np.zeros((SC_STAGE, SC_LANES), f32)
            lane_era = np.zeros((SC_STAGE, SC_LANES), f32)
            cnt = np.zeros(SC_STAGE, np.int64)
            for q in range(SC_LANES):
                i0 = q * SC_SPAN
                off = local * n + i0
                sh = (off & 3).astype(np.uint64) * np.uint64(8)
                acc = np.zeros((SC_STAGE, 4), f32)
                eacc = np.zeros((SC_STAGE, 4), f32)
                for kk in range(SC_SPAN // 4):
                    v = n - i0 - 4 * kk
                    keep = 0xFFFFFFFF if v >= 4 else 0 if v <= 0 \
                        else (1 << (8 * v)) - 1
                    w = (off >> 2) + kk
                    cw = (((cws[w + 1] << np.uint64(32)) | cws[w]) >> sh
                          & np.uint64(keep))
                    ew = (((ews[w + 1] << np.uint64(32)) | ews[w]) >> sh
                          & np.uint64(keep))
                    for j in range(4):
                        i = i0 + 4 * kk + j
                        val = ((cw >> np.uint64(8 * j))
                               & np.uint64(0xFF)).astype(np.int64)
                        term = lut[i, val & 63]
                        for li in np.flatnonzero(val >= 64):
                            term[li] = term_slow(rows[i], int(val[li]))
                        erased = ((ew >> np.uint64(8 * j))
                                  & np.uint64(0xFF)) != 0
                        acc[:, j] = (acc[:, j] + term).astype(f32)
                        eacc[:, j] = (eacc[:, j]
                                      + np.where(erased, term, f32(0))
                                      ).astype(f32)
                        cnt += erased
                lane_sum[:, q] = ((acc[:, 0] + acc[:, 1])
                                  + (acc[:, 2] + acc[:, 3])).astype(f32)
                lane_era[:, q] = ((eacc[:, 0] + eacc[:, 1])
                                  + (eacc[:, 2] + eacc[:, 3])).astype(f32)
            tot = butterfly_sum(lane_sum, SC_LANES)
            tot_era = butterfly_sum(lane_era, SC_LANES)
            for li in range(SC_STAGE):
                t = SC_STAGE * s + li
                if t >= t_n:
                    continue
                n_era = f32(cnt[li])
                s_era = f32(tot_era[li] / max(n_era, f32(1)))
                passed = ok[ci, t] and (n_era < 8 or s_era >= gate)
                score = f32(tot[li] / f32(n)) if passed else f32(-np.inf)
                warp = li // (32 // SC_LANES)
                if wb[warp] is None or better(score, t, *wb[warp]):
                    wb[warp] = (score, t)
        b = wb[0]
        for w in range(1, SC_WARPS):
            if wb[w] is not None and better(*wb[w], *b):
                b = wb[w]
        best_score[ci], best_trial[ci] = b
        info[ci] = corrected[ci, b[1], :k]
        best_ok[ci] = info[ci].any() and b[0] >= f32(accept)
    return info, best_score, best_ok, best_trial


def _score_case(rng, c: int = 6, t: int = 24, n: int = 63):
    """Corrected words against top-4 tone rows: some symbols hit the best
    tone, some another of the four, some none; trials with many erasures;
    planted ties of whole trials, an all-fail candidate and an all-zero
    winner."""
    rs = rs64.RS63(12, fcr=3)
    words = np.stack([rs.encode(rng.integers(0, 64, 12)) for _ in range(c)])
    top_tone = np.stack([words, (words + 1) % 64, (words + 2) % 64,
                         (words + 3) % 64], axis=-1).astype(np.int64)
    top_e = (rng.random((c, n, 4)) * [6.0, 1.0, 0.5, 0.25]).astype(
        np.float32)
    top_e = -np.sort(-top_e, axis=-1)
    e_sum = (top_e.sum(-1) + rng.random((c, n)) * 20).astype(np.float32)
    corrected = np.repeat(words[:, None], t, axis=1).astype(np.uint8)
    noise = rng.random((c, t, n)) < 0.3
    corrected[noise] = rng.integers(0, 64, noise.sum())
    era = rng.random((c, t, n)) < np.linspace(0.0, 0.5, t)[None, :, None]
    ok = rng.random((c, t)) < 0.8
    corrected[0, 9] = corrected[0, 3]          # equal trials: lower wins
    era[0, 9] = era[0, 3]
    ok[0, [3, 9]] = True
    era[0, [3, 9]] = False
    ok[1] = False                              # nothing passes
    corrected[2] = 0                           # a winner of all zeros
    ok[2] = True
    return (torch.from_numpy(corrected), torch.from_numpy(ok),
            torch.from_numpy(era), torch.from_numpy(top_e),
            torch.from_numpy(top_tone), torch.from_numpy(e_sum))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_model_matches_plain(seed):
    """The kernel's score and selection: info and ok identical, scores
    within 1e-5, the same best trial (the lower one of two equal trials);
    -inf where no trial passes, an all-zero info word not ok."""
    args = _score_case(np.random.default_rng(seed))
    info, score, best_ok = rs_device.chase_score_plain(12, 0.4, *args)
    m_info, m_score, m_ok, m_trial = score_model(
        12, 0.4, *(a.numpy() for a in args))
    np.testing.assert_array_equal(m_info, info.numpy())
    np.testing.assert_array_equal(m_ok, best_ok.numpy())
    fin = np.isfinite(score.numpy())
    np.testing.assert_array_equal(np.isfinite(m_score), fin)
    np.testing.assert_allclose(m_score[fin], score.numpy()[fin], rtol=0,
                               atol=1e-5)
    assert np.isneginf(m_score[1]) and m_trial[1] == 0 and not m_ok[1]
    assert not m_ok[2]
    if m_trial[0] in (3, 9):
        assert m_trial[0] == 3


def _score_case_any(rng, c: int, t: int, n: int, odd: bool):
    """Random words of n symbols and their top-4 rows; with ``odd`` the
    tones also hold -1, values of 64 to 255 and past 255, repeats, and the
    corrected words values of 64 or more."""
    words = rng.integers(0, 64, (c, n))
    top_tone = np.stack([words, (words + 1) % 64, (words + 2) % 64,
                         (words + 3) % 64], axis=-1).astype(np.int64)
    top_e = -np.sort(-(rng.random((c, n, 4)) * [6.0, 1.0, 0.5, 0.25]),
                     axis=-1).astype(np.float32)
    e_sum = (top_e.sum(-1) + rng.random((c, n)) * 20).astype(np.float32)
    corrected = np.repeat(words[:, None], t, axis=1).astype(np.uint8)
    noise = rng.random((c, t, n)) < 0.3
    corrected[noise] = rng.integers(0, 64, noise.sum())
    if odd:
        pick = rng.random((c, n, 4))
        top_tone[pick < 0.1] = -1
        top_tone[(pick >= 0.1) & (pick < 0.2)] = rng.integers(
            64, 256, ((pick >= 0.1) & (pick < 0.2)).sum())
        top_tone[(pick >= 0.2) & (pick < 0.25)] = 300
        top_tone[:, ::5, 2] = top_tone[:, ::5, 1]          # repeats
        top_tone[0, 3] = -1                                # none inside
        high = rng.random((c, t, n)) < 0.15
        corrected[high] = rng.integers(64, 256, high.sum())
        corrected[:, :, 7] = np.where(top_tone[:, None, 7, 1] > 63,
                                      top_tone[:, None, 7, 1] % 256,
                                      corrected[:, :, 7])
    era = rng.random((c, t, n)) < np.linspace(0.0, 0.5, t)[None, :, None]
    ok = rng.random((c, t)) < 0.8
    return (torch.from_numpy(corrected), torch.from_numpy(ok),
            torch.from_numpy(era), torch.from_numpy(top_e),
            torch.from_numpy(top_tone), torch.from_numpy(e_sum))


@pytest.mark.parametrize("t,n,odd", [
    (37, 63, False),       # a candidate's T x n bytes no multiple of 16
    (9, 64, False),        # one partial stage, full words (576 bytes)
    (24, 41, True),        # short words, tones and values outside [0, 63]
    (70, 63, True),        # three stages, the last partial
])
def test_score_model_slabs_and_tones(t, n, odd):
    """The kernel's stages where a candidate's slab is no multiple of 16
    bytes (the block's byte copies; the lanes' words reach past the stage
    into whatever the slot holds), at other word lengths, and with tones
    and corrected values outside [0, 63] (the table for values below 64,
    the tone bytes' compare above): info and ok identical to the plain
    version's, the score within 1e-5."""
    args = _score_case_any(np.random.default_rng(t + n), 4, t, n, odd)
    k = min(12, n)
    info, score, best_ok = rs_device.chase_score_plain(k, 0.4, *args)
    m_info, m_score, m_ok, _ = score_model(k, 0.4,
                                           *(a.numpy() for a in args),
                                           seed=t)
    np.testing.assert_array_equal(m_info, info.numpy())
    np.testing.assert_array_equal(m_ok, best_ok.numpy())
    fin = np.isfinite(score.numpy())
    np.testing.assert_array_equal(np.isfinite(m_score), fin)
    np.testing.assert_allclose(m_score[fin], score.numpy()[fin], rtol=0,
                               atol=1e-5)


def test_score_tables_match_the_hits():
    """A corrected value's term from the table (below 64) or the tone
    bytes' compare (64 and above) is the plain version's hit: its first
    tone's energy term where one matches, else the floor's."""
    rng = np.random.default_rng(11)
    args = _score_case_any(rng, 2, 4, 63, True)
    te, tn, es = args[3].numpy(), args[4].numpy(), args[5].numpy()
    f32 = np.float32
    for ci in range(2):
        rows, lut = score_tables(te[ci], tn[ci], es[ci], 63)
        for i in range(63):
            for v in list(range(64)) + [64, 100, 200, 255]:
                got = lut[i, v] if v < 64 else term_slow(rows[i], v)
                hit = np.flatnonzero(tn[ci, i] == v)
                want = rows[i, 1 + hit[0]] if len(hit) else rows[i, 0]
                assert got.view(U32) == f32(want).view(U32), (ci, i, v)
        assert (lut[63] == 0).all() and (rows[63] == 0).all()


def test_score_selection_ties_and_nan():
    """The warps' best and their merge pick as ``argmax``: the first of
    equal scores across warps, NaN above everything, -inf everywhere gives
    trial 0."""
    scores = [np.asarray([1.0, 2.0, 2.0, 0.5] * 4, np.float32),
              np.asarray([-np.inf] * 16, np.float32),
              np.asarray([0.0] * 5 + [np.nan] + [9.0] * 4 + [np.nan] * 6,
                         np.float32)]
    for sc in scores:
        wb = [None] * 8
        for warp in range(8):
            for t in range(warp, len(sc), 8):
                if wb[warp] is None or better(sc[t], t, *wb[warp]):
                    wb[warp] = (sc[t], t)
        b = wb[0]
        for w in range(1, 8):
            if better(*wb[w], *b):
                b = wb[w]
        assert b[1] == int(torch.from_numpy(sc).argmax())


# --------------------------------------------------------------------------
# refusals and dispatch
# --------------------------------------------------------------------------

def test_kernels_refuse_what_they_do_not_take():
    """Checks before any build: word length, trials, deterministic tiers,
    tones a symbol; CPU operands refused by the wrappers (the kernels need
    every operand on one CUDA device)."""
    _chase_kernels.check_chase(63, 256, 6)
    for n, t, d in ((65, 256, 6), (63, 1025, 6), (63, 6, 6), (63, 256, 9),
                    (0, 256, 6)):
        with pytest.raises(ValueError):
            _chase_kernels.check_chase(n, t, d)
    _qary_kernels.check_symbols(64)
    with pytest.raises(ValueError, match="64 tones"):
        _qary_kernels.check_symbols(32)
    m = torch.zeros((2, 63))
    seed = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA device"):
        _chase_kernels.chase_erasures(m, seed, torch.zeros(63),
                                      torch.zeros(250), (0, 8, 16, 24, 32, 40),
                                      256, 0)
    with pytest.raises(ValueError, match="dtype"):
        _chase_kernels.chase_erasures(m, seed.float(), torch.zeros(63),
                                      torch.zeros(250), (0,) * 6, 256, 0)
    args = _score_case(np.random.default_rng(4), c=3, t=12)
    with pytest.raises(ValueError, match="CUDA device"):
        _chase_kernels.chase_score(*args, 12, 0.4)
    with pytest.raises(ValueError, match="k=70"):
        _chase_kernels.chase_score(*args, 70, 0.4)
    power = torch.zeros((1, 300, 400))
    t0 = torch.zeros((1, 2), dtype=torch.int64)
    rows = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the map"):
        _qary_kernels.qary_symbols(power, t0, t0, rows, 0, 10, 200, 4, 0,
                                   False)
    with pytest.raises(ValueError, match="CUDA device"):
        _qary_kernels.qary_symbols(power, t0, t0, rows, 0, 10, 100, 4, 0,
                                   False)
    assert _chase_kernels._lib is None and _qary_kernels._lib is None


def test_cpu_decode_takes_the_plain_stages(monkeypatch):
    """A JT65 decode on CPU tensors runs the plain gather, flags and score
    (each once) and never a kernel wrapper."""
    calls = []

    def trap(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    for mod, name in ((_qary_kernels, "qary_symbols"),
                      (_chase_kernels, "chase_erasures"),
                      (_chase_kernels, "chase_score")):
        monkeypatch.setattr(mod, name, trap)
    for mod, name in ((qary_engine, "_symbol_energies_plain"),
                      (rs_device, "chase_erasures_plain"),
                      (rs_device, "chase_score_plain")):
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    rng = np.random.default_rng(9)
    win = (jt65.synthesize("CQ W2AXR FN13", 1270.0)
           + 0.5 * rng.standard_normal(int(jt65.T_R * 12_000))).astype(np.float32)
    res = jt65.JT65Decoder(top_k=2, device="cpu").decode(win[None])
    assert "CQ W2AXR FN13" in [r.message for r in res[0]]
    assert sorted(calls) == ["_symbol_energies_plain",
                             "chase_erasures_plain", "chase_score_plain"]
