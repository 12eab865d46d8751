"""The weak modes' hand kernels (``modes/csrc/weak.cu``) on the CPU: their
plain versions against the JAX package on inputs built to tie, NumPy
models of the kernels' algorithms bit for bit against the plain versions,
and the wrappers' routing and refusals.

- ``wspr._beam_decode_plain`` against ``jwspr._beam_decode`` at beam widths
  256 and 1024 on integer-valued LLRs, all-zero LLRs and a zero tail: bits
  identical, metric within 1e-5 relative (the normalising sum of |llr| in
  another order);
- a NumPy model of ``wspr_beam``: the two sorts as ascending sorts of its
  composite keys (a key is unique, so any sort gives the bitonic network's
  order), the merge by neighbours, the backtrack from the first maximum;
  bits and metric bitwise the plain version's, NaN LLRs included; and the
  kernel's bitonic network (its index formula, directions and the rule
  that lets a stage wait on a warp barrier) on random keys;
- ``rs_device.rs_ee_decode_plain`` against ``jrs.rs_ee_decode`` on 0,
  exactly 51 and 52 or more erasures, the all-zero word and random words:
  words and ``ok`` identical;
- a NumPy model of ``rs_ee`` (lanes j and j + 32, the shuffles, Horner
  chains over the table block ``rs_device.kernel_tables``) equal to the
  plain version on the same cases;
- the Chase program decodes through ``rs_ee_trials`` (syms [C, n], era [C,
  T, n]), equal to the expanded route;
- the smoke's RS bound counts the locator's roots from the trials' data;
- the wrappers: CPU tensors run the plain versions and count no launch;
  a wrong dtype, shape, contiguity, beam width or word length raises
  before the library loads, a WSPR decoder for a card refuses such a
  width when it is built; a CUDA-typed call with no nvcc raises.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import rs64 as jrs64
from cwsl_digi_tpu.modes import rs_device as jrs
from cwsl_digi_tpu.modes import wspr as jwspr
from cwsl_digi_tpu_torch.modes import _weak_kernels, rs_device, wspr

torch.set_num_threads(1)

DEAD = np.float32(-1e9)


# ---------------------------------------------------------------------------
# wspr_beam


def _tie_llrs(seed: int) -> np.ndarray:
    """Three candidates built to tie: integer-valued LLRs, all-zero LLRs,
    and random LLRs with a zero tail."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-3, 4, (81, 2)).astype(np.float32)
    tail = rng.standard_normal((81, 2)).astype(np.float32)
    tail[wspr.N_MSG_BITS:] = 0.0
    return np.stack([ints, np.zeros((81, 2), np.float32), tail])


def _cfg(w: int) -> tuple:
    cfg = wspr.WSPRConfig(beam_width=w)
    jcfg = jwspr.WSPRConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})
    return cfg, jcfg


@pytest.mark.parametrize("w", [256, 1024])
def test_plain_beam_matches_jax_on_ties(w):
    llr = _tie_llrs(w)
    cfg, jcfg = _cfg(w)
    bj, mj = jwspr._beam_decode(jcfg, jnp.asarray(llr))
    bp, mp = wspr._beam_decode_plain(cfg, torch.from_numpy(llr))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-5)


def _parity(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).reshape(
        *x.shape, 32).sum(-1) & 1


def _desc_key(m: np.ndarray) -> np.ndarray:
    """weak.cu's desc_key: ascending keys are descending floats, -0.0 as
    0.0, NaN (any sign) first."""
    u = m.view(np.uint32).copy()
    u[(u & 0x7FFFFFFF) == 0] = 0
    asc = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(m), np.uint32(0), ~asc).astype(np.uint64)


def _key_metric(key: np.ndarray) -> np.ndarray:
    """weak.cu's key_metric: the metric of a top key (desc_key inverted,
    -0.0 from its flag, NaN as 0x7fffffff)."""
    asc = ~(key >> np.uint64(32)).astype(np.uint32)
    u = np.where(asc & 0x80000000, asc & 0x7FFFFFFF, ~asc).astype(np.uint32)
    u = np.where(key & np.uint64(1 << 11), np.uint32(0x80000000), u)
    return u.astype(np.uint32).view(np.float32)


def _lift_first(rlow: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weak.cu's first_rank: the ranks whose tail is below v, by binary
    lifting over the W sorted tails (rows of rlow; v is one of them)."""
    w = rlow.shape[-1]
    c = np.zeros(v.shape, np.int64)
    b = w // 2
    while b:
        c += np.where(np.take_along_axis(rlow, c + b - 1, -1) < v, b, 0)
        b //= 2
    return c


def _lift_last(rlow: np.ndarray, v: np.ndarray) -> np.ndarray:
    """weak.cu's last_rank: the last rank whose tail is at most v."""
    w = rlow.shape[-1]
    e = np.zeros(v.shape, np.int64)
    b = w // 2
    while b:
        e += np.where(np.take_along_axis(rlow, e + b, -1) <= v, b, 0)
        b //= 2
    return e


def _children_positions(low30: np.ndarray, keys: int
                        ) -> tuple[np.ndarray, ...]:
    """The kernel's tail order of one step: the W survivors' sorted tail
    keys (low 30 bits << 32 | slot << 1), and by rank r the slot, the first
    and last rank of r's group of equal low 30 bits (the group bounds of
    the thread's first and last rank by lifting, the rest from its
    neighbours in the thread, ``keys`` // 2 ranks a thread) and the
    positions of r's bit-0 and bit-1 children in the stable order of the
    2W tails: r + r0 and r + e + 1."""
    w = low30.shape[-1]
    kt = max(1, keys // 2)
    slot = np.arange(w, dtype=np.uint64)
    tk = np.sort((low30.astype(np.uint64) << np.uint64(32))
                 | (slot << np.uint64(1)), axis=-1)
    v = (tk >> np.uint64(32)).astype(np.int64)
    s = ((tk >> np.uint64(1)) & np.uint64(0x3FF)).astype(np.int64)
    r = np.arange(w)
    lead = r % kt == 0
    trail = r % kt == kt - 1
    r0 = np.where(lead, _lift_first(v, v), r)
    e = np.where(trail, _lift_last(v, v), r)
    for q in range(1, kt):          # forward within the thread
        same = (r % kt == q) & (v == np.roll(v, 1, -1))
        r0 = np.where(same, np.roll(r0, 1, -1), r0)
    for q in range(kt - 2, -1, -1):  # backward within the thread
        same = (r % kt == q) & (v == np.roll(v, -1, -1))
        e = np.where(same, np.roll(e, -1, -1), e)
    return v, s, r0, e, r + r0, r + e + 1


def _beam_model(llr: np.ndarray, w: int, keys: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """The wspr_beam kernel's algorithm over the candidates at once, at
    ``keys`` top keys a thread: (bits [N, 50] int8, the best raw metric
    [N] float32).  A step: the W survivors sorted by (low 30 bits, slot);
    each rank's children at r + r0 and r + e + 1 of the 2W tail order;
    the merge against the rank neighbours in the group; the 2W keys
    (desc_key << 32 | position << 16 | -0.0 << 11 | bit << 10 | slot)
    sorted, the first W the survivors (a key is unique, so any sort gives
    the network's order); each survivor's path register (its message bits,
    the live flag in bit 63) taken from its parent."""
    n = llr.shape[0]
    st = np.zeros((n, w), np.uint32)
    met = np.full((n, w), DEAD, np.float32)
    met[:, 0] = 0.0
    path = np.zeros((n, w), np.uint64)
    live_bit = np.uint64(1 << 63)
    path[:, 0] = live_bit

    def branch(s, l0, l1):
        c1 = np.where(_parity(s & np.uint32(wspr.POLY1)), -1, 1)
        c2 = np.where(_parity(s & np.uint32(wspr.POLY2)), -1, 1)
        return (c1.astype(np.float32) * l0 + c2.astype(np.float32) * l1) \
            * np.float32(0.5)

    def take(a, i):
        return np.take_along_axis(a, i, axis=1)

    for step in range(81):
        l0, l1 = llr[:, step, 0:1], llr[:, step, 1:2]
        v, s, r0, e, p0, p1 = _children_positions(st & 0x3FFFFFFF, keys)
        st31 = take(st, s) & np.uint32(0x7FFFFFFF)
        s0 = st31 << np.uint32(1)
        lv = (take(path, s) & live_bit) != 0
        m = take(met, s)
        m0 = m + branch(s0, l0, l1)
        m1 = m + branch(s0 | np.uint32(1), l0, l1)
        if step >= wspr.N_MSG_BITS:
            m1 = m1 - np.float32(1e9)
        c = [np.where(lv, m0, DEAD), np.where(lv, m1, DEAD)]
        r = np.arange(w)
        has_next, has_prev = r < e, r > r0
        top = []
        for b, (cb, p) in enumerate(zip(c, (p0, p1))):
            nxt = take(cb, np.minimum(r + 1, w - 1)[None].repeat(n, 0))
            prv = take(cb, np.maximum(r - 1, 0)[None].repeat(n, 0))
            drop = (has_next & (cb < nxt)) | (has_prev & (cb <= prv))
            nb = np.where(drop, DEAD, cb)
            negz = (nb.view(np.uint32) == 0x80000000).astype(np.uint64)
            top.append((_desc_key(nb) << np.uint64(32))
                       | (p.astype(np.uint64) << np.uint64(16))
                       | (negz << np.uint64(11))
                       | np.uint64(b << 10) | s.astype(np.uint64))
        key = np.sort(np.concatenate(top, axis=1), axis=1)[:, :w]
        parent = (key & np.uint64(0x3FF)).astype(np.int64)
        bit = ((key >> np.uint64(10)) & np.uint64(1)).astype(np.uint32)
        met = _key_metric(key)
        st = (take(st, parent) << np.uint32(1)) | bit
        pp = take(path, parent)
        if step < wspr.N_MSG_BITS:
            pp = (pp & live_bit) | ((pp & ~live_bit) << np.uint64(1)) \
                | bit.astype(np.uint64)
        path = pp
    bits = np.zeros((n, wspr.N_MSG_BITS), np.int8)
    best = np.zeros(n, np.float32)
    for c_ in range(n):
        nan = np.flatnonzero(np.isnan(met[c_]))
        idx = int(nan[0]) if nan.size else int(np.argmax(met[c_]))
        best[c_] = met[c_, idx]
        for step in range(wspr.N_MSG_BITS):
            bits[c_, step] = int(path[c_, idx]) >> (49 - step) & 1
    return bits, best


@pytest.mark.parametrize("w", [32, 256])
def test_beam_kernel_model_matches_plain(w):
    """The kernel's steps (the W-key tail sort and the interleave, the
    merge against the rank neighbours, the top W of the 2W keys, the path
    registers) give the plain version's bits and metric bit for bit, at
    every plan of the width: on ties, on noisy LLRs and on a candidate
    with NaN LLRs (its metric NaN as the plain version's)."""
    rng = np.random.default_rng(w + 1)
    noisy = rng.standard_normal((3, 81, 2)).astype(np.float32) * 2
    nan = rng.standard_normal((1, 81, 2)).astype(np.float32)
    nan[0, 30, 1] = np.nan
    llr = np.concatenate([_tie_llrs(w), noisy, nan])
    cfg = wspr.WSPRConfig(beam_width=w)
    bp, mp = wspr._beam_decode_plain(cfg, torch.from_numpy(llr))
    norm = torch.from_numpy(llr).abs().sum(dim=(1, 2)) + 1e-30
    for keys in _weak_kernels.BEAM_PLANS[w]:
        bits, best = _beam_model(llr, w, keys)
        got = (torch.from_numpy(best) / (0.5 * norm)).numpy()
        np.testing.assert_array_equal(bits, bp.numpy())
        np.testing.assert_array_equal(got.view(np.uint32)[:-1],
                                      mp.numpy().view(np.uint32)[:-1])
        assert np.isnan(got[-1]) and np.isnan(mp.numpy()[-1])


@pytest.mark.parametrize("keys", [2, 4, 8, 16])
def test_interleave_gives_the_stable_tail_order(keys):
    """A survivor of rank r in the sort of the W survivors by (low 30
    bits, slot), in a group of m equal low 30 bits from rank r0 to e, has
    its bit-0 child at r + r0 and its bit-1 child at r + e + 1 of the
    stable order of the 2W children's 31-bit tails, for groups of 1 to 4
    (and the one group of all W of the first step), whatever ranks a
    thread holds; the metric survives its top key bit for bit (-0.0, the
    infinities and the extremes), NaN as NaN."""
    rng = np.random.default_rng(keys)
    w = 64
    for trial in range(40):
        if trial == 0:
            low = np.zeros(w, np.uint32)
        else:
            sizes = []
            while sum(sizes) < w:
                sizes.append(int(rng.integers(1, 5)))
            sizes[-1] -= sum(sizes) - w
            vals = rng.choice(2 ** 30, len(sizes), replace=False)
            low = rng.permutation(np.repeat(vals, sizes)).astype(np.uint32)
        hi = rng.integers(0, 4, w).astype(np.uint32) << np.uint32(30)
        st = low | hi
        _, s, r0, e, p0, p1 = _children_positions(low[None], keys)
        m = e - r0 + 1
        assert m.max() <= (w if trial == 0 else 4)
        tails = np.concatenate([(st << np.uint32(1)),
                                (st << np.uint32(1)) | np.uint32(1)]
                               ).astype(np.int64) & 0x7FFFFFFF
        order = np.argsort(tails, kind="stable")
        pos = np.empty(2 * w, np.int64)
        pos[order] = np.arange(2 * w)
        np.testing.assert_array_equal(p0[0], pos[s[0]])
        np.testing.assert_array_equal(p1[0], pos[w + s[0]])
    m = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 3.4e38, -1e9,
                  1e-45, -1e-45, np.nan], np.float32)
    negz = (m.view(np.uint32) == 0x80000000).astype(np.uint64)
    back = _key_metric((_desc_key(m) << np.uint64(32))
                       | (negz << np.uint64(11)))
    np.testing.assert_array_equal(back[:-1].view(np.uint32),
                                  m[:-1].view(np.uint32))
    assert np.isnan(back[-1])


def _network_model(keys: np.ndarray, kk: int, topn: int
                   ) -> tuple[np.ndarray, list]:
    """weak.cu's block_sort of the keys [NK] held kk a thread (thread t
    positions t kk .. t kk + kk - 1): every stage keeps the smaller key at
    the lower position, a phase's first stage pairing i with its mirror i ^
    (k - 1), the others i with i ^ j; the positions from topn on are left
    in the last phase.  Returns (the keys as held [NK], each stage's (k, j,
    kind, shared buffer or None)).  Asserts, stage by stage, what each
    kind's barrier covers: a register stage pairs two keys of one thread,
    a shuffle stage two lanes of one warp with every lane of the warp
    taking part, a shared stage two warps that both take part; the shared
    stages alternate their buffer."""
    nk = keys.size
    tt = nk // kk
    v = keys.reshape(tt, kk).copy()
    t = np.arange(tt)
    q = np.arange(kk)
    stages, buf, k = [], 0, 2
    while k <= nk:
        j = k // 2
        while j:
            mirror = j == k // 2
            left = k == nk and j < topn < nk
            on = (((t >> 5) << 5) * kk < topn) | (not left)
            pos = t[:, None] * kk + q[None, :]
            part = pos ^ (k - 1) if mirror else pos ^ j
            pt, pq = part // kk, part % kk
            if j < kk:
                kind, used = "register", None
                assert np.all(pt == t[:, None])
            elif j < 32 * kk:
                kind, used = "shuffle", None
                assert np.all(pt >> 5 == (t >> 5)[:, None])
                warp_on = on.reshape(-1, min(32, tt))
                assert np.all(warp_on.all(1) | ~warp_on.any(1))
            else:
                kind, used = "shared", buf
                buf ^= 1
                assert np.all(pt >> 5 != (t >> 5)[:, None])
            assert np.all(on[pt] == on[:, None])
            o = v[pt, pq]
            new = np.where(pos < part, np.minimum(v, o), np.maximum(v, o))
            v = np.where(on[:, None], new, v)
            stages.append((k, j, kind, used))
            j //= 2
        k *= 2
    shared = [s[3] for s in stages if s[2] == "shared"]
    assert all(a != b for a, b in zip(shared, shared[1:]))
    return v.reshape(-1), stages


@pytest.mark.parametrize("w", [32, 64, 256, 1024])
def test_bitonic_network_sorts_and_warp_barriers_hold(w):
    """At every plan of the width, the kernel's tail sort (W keys, K/2 a
    thread) sorts ascending and its top sort (2W keys, K a thread) puts
    the W least in order in front; register stages stay in a thread,
    shuffle stages in a warp, the rest cross shared memory behind a
    barrier (``_network_model``'s checks); the stage counts are
    ``_weak_kernels.beam_chain``'s."""
    rng = np.random.default_rng(w)
    for keys in _weak_kernels.BEAM_PLANS[w]:
        chain = _weak_kernels.beam_chain(w, keys)
        got = {}
        for name, nk, kk, topn in (("tail", w, max(1, keys // 2), w),
                                   ("top", 2 * w, keys, w)):
            vals = rng.permutation(np.arange(nk, dtype=np.uint64) * 7919
                                   + 3)
            out, stages = _network_model(vals, kk, topn)
            np.testing.assert_array_equal(out[:topn], np.sort(vals)[:topn])
            lg = nk.bit_length() - 1
            assert len(stages) == lg * (lg + 1) // 2
            got[name] = {kind: sum(s[2] == kind for s in stages)
                         for kind in ("register", "shuffle", "shared")}
        assert got == {name: chain[name] for name in ("tail", "top")}
        # a step ends on the exchange buffer it began with, which lets the
        # kernel choose each stage's buffer when it is compiled
        assert got["tail"]["shared"] == got["top"]["shared"]
        assert chain["block_barriers"] == (got["tail"]["shared"]
                                           + got["top"]["shared"] + 2)


# ---------------------------------------------------------------------------
# rs_ee


def _rs_cases(rng, k: int = 12, fcr: int = 3) -> dict:
    """Words and erasure flags by case: 0 erasures, exactly 51, 52 or more
    (up to all 63), the all-zero word (with and without erasures), and
    random words with errors and erasures (a fifth pure noise)."""
    rs = jrs64.RS63(k, fcr=fcr)
    nroots = 63 - k

    def coded(m):
        return np.stack([rs.encode(rng.integers(0, 64, k)) for _ in range(m)])

    def corrupt(w, n_err):
        w = w.copy()
        for r in w:
            pos = rng.permutation(63)[:n_err]
            r[pos] ^= rng.integers(1, 64, n_err)
        return w

    def erase(m, n_era):
        e = np.zeros((m, 63), bool)
        for r, c in zip(e, n_era):
            r[rng.permutation(63)[:c]] = True
        return e

    cases = {}
    w = coded(24)
    cases["no erasures"] = (corrupt(w, 12), np.zeros((24, 63), bool))
    cases["no erasures, 26 errors"] = (corrupt(w, 26),
                                       np.zeros((24, 63), bool))
    w = coded(16)
    cases["51 erasures"] = (corrupt(w, 20), erase(16, [nroots] * 16))
    cases["52+ erasures"] = (corrupt(w, 20),
                             erase(16, rng.integers(nroots + 1, 64, 16)))
    z = np.zeros((8, 63), np.int64)
    cases["all-zero word"] = (z, erase(8, [0, 1, 10, 51, 52, 63, 5, 30]))
    w = coded(60)
    n_era = rng.integers(0, 52, 60)
    words = corrupt(w, 10)
    words[::5] = rng.integers(0, 64, (12, 63))
    cases["random words"] = (words, erase(60, n_era))
    return cases


def test_plain_rs_matches_jax_on_edge_cases():
    cases = _rs_cases(np.random.default_rng(51))
    words = np.concatenate([w for w, _ in cases.values()])
    eras = np.concatenate([e for _, e in cases.values()])
    cj, okj = jrs.rs_ee_decode((63, 12, 3), (), None,
                               jnp.asarray(words, jnp.int32),
                               jnp.asarray(eras))
    cp, okp = rs_device.rs_ee_decode_plain(
        (63, 12, 3), torch.from_numpy(words), torch.from_numpy(eras))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    lo = 0
    for name, (w, _) in cases.items():      # each case both decodes and not
        ok = okp.numpy()[lo : lo + len(w)]
        lo += len(w)
        if name in ("no erasures", "51 erasures", "all-zero word"):
            assert ok.any(), name
        if name in ("no erasures, 26 errors", "random words"):
            assert not ok.all(), name


def _rs_block_tables(tab: np.ndarray, n: int, nroots: int) -> dict:
    """The tables an rs_ee block builds from the table block by repeated
    products: pw [k, i] = (X_i^-1)^k (k <= nroots), syn [i, j] =
    alpha^((fcr + j) deg_i) (j < nroots, 0 past), fc [i] = X_i^-1
    X_i^(1 - fcr); positions past n hold 0."""
    mul = tab[:4096].astype(np.int64).reshape(64, 64)
    xi, xinv, xfcr, root = (tab[4160 + 64 * q : 4224 + 64 * q].astype(
        np.int64) for q in range(4))
    pos = np.arange(64) < n
    pw = np.zeros((64, 64), np.int64)
    p = pos.astype(np.int64)
    x = np.where(pos, xinv, 0)
    for k in range(nroots + 1):
        pw[k] = p
        p = mul[p, x]
    syn = np.zeros((64, 64), np.int64)
    col = (np.arange(64) < nroots).astype(np.int64)
    r = np.where(np.arange(64) < nroots, root, 0)
    for i in range(n - 1, -1, -1):
        syn[i] = col
        col = mul[col, r]
    fc = np.where(pos, mul[xinv, xfcr], 0)
    return {"mul": mul, "xi": xi, "pw": pw, "syn": syn, "fc": fc}


def _rs_model(tab: np.ndarray, syms: np.ndarray, eras: np.ndarray,
              n: int, nroots: int) -> tuple[np.ndarray, np.ndarray]:
    """The rs_ee kernel's algorithm over trials syms [C, n] x eras [C, T,
    n] at once, on its table block and the tables its blocks build
    (``_rs_block_tables``): a candidate's syndromes once, as sums of r_i
    syn [i, j]; the erasure locator and Berlekamp-Massey on coefficient
    slots j (lane j // 2), the shuffle as a shift; Omega; Lambda's even
    and odd terms and Omega at each position as sums of c_k pw [k, i];
    Forney as Omega inv(odd) fc_i; the check as S(r) XOR S(e) over the
    changed positions.  Returns (corrected [C, T, n] uint8, ok [C, T])."""
    t = _rs_block_tables(tab, n, nroots)
    mul, pw, syn, fc = t["mul"], t["pw"], t["syn"], t["fc"]
    inv = tab[4096:4160].astype(np.int64)
    c, nt, _ = eras.shape
    j = np.arange(64)
    coef = j <= nroots
    r_c = np.zeros((c, 64), np.int64)
    r_c[:, :n] = syms & 63
    s_c = np.zeros((c, 64), np.int64)
    for i in range(n):                     # r_i the same in every lane
        s_c ^= mul[r_c[:, i : i + 1], syn[i][None, :]]
    r = np.repeat(r_c, nt, axis=0)
    s = np.repeat(s_c, nt, axis=0)
    era = eras.reshape(-1, n)
    m = len(era)

    def shift(x):
        return np.concatenate([np.zeros((x.shape[0], 1), np.int64),
                               x[:, :-1]], axis=1)

    lam = np.zeros((m, 64), np.int64)
    lam[:, 0] = 1
    for i in range(n):                     # ascending erased positions
        step = lam ^ mul[t["xi"][i], shift(lam)]
        lam = np.where(era[:, i : i + 1], step, lam)
    lam = np.where(coef, lam, 0)           # past nroots dropped once
    no_eras = era.sum(axis=1)
    b, el = lam.copy(), no_eras.copy()
    for rr in range(1, nroots + 1):
        act = rr > no_eras
        sidx = np.clip(rr - 1 - j, 0, 63)
        part = np.where(j <= rr - 1, mul[lam, s[np.arange(m)[:, None],
                                                  sidx]], 0)
        d = np.bitwise_xor.reduce(part, axis=1)
        bs = np.where(coef, shift(b), 0)
        tt = lam ^ mul[d[:, None], bs]
        cond = (d != 0) & (2 * el <= rr - 1 + no_eras) & act
        b = np.where(cond[:, None], mul[inv[d][:, None], lam],
                     np.where(act[:, None], bs, b))
        el = np.where(cond, rr + no_eras - el, el)
        lam = np.where(act[:, None], tt, lam)
    om = np.zeros((m, 64), np.int64)
    for i in range(nroots):                # lambda_i the same in every lane
        om ^= np.where((i <= j) & (j < nroots),
                       mul[lam[:, i : i + 1], s[np.arange(m)[:, None],
                                                np.clip(j - i, 0, 63)]], 0)
    even, odd, w = (np.zeros((m, 64), np.int64) for _ in range(3))
    for k in range(nroots + 1):            # lanes: positions i and i + 32
        term = mul[lam[:, k : k + 1], pw[k][None, :]]
        if k % 2:
            odd ^= term
        else:
            even ^= term
        w ^= mul[om[:, k : k + 1], pw[k][None, :]]
    mag = mul[mul[w, inv[odd]], fc[None, :]]
    out = np.where((even ^ odd) == 0, r ^ mag, r)
    out[:, n:] = 0
    z = s.copy()
    delta = out ^ r
    for i in range(n):                     # the changes, e_i in every lane
        z ^= mul[delta[:, i : i + 1], syn[i][None, :]]
    return (out[:, :n].astype(np.uint8).reshape(c, nt, n),
            ~(z != 0).any(axis=1).reshape(c, nt))


def test_kernel_tables_hold_the_plain_versions_tables():
    n, nroots, fcr = 63, 51, 3
    tab = rs_device.kernel_tables(n, nroots, fcr)
    assert tab.dtype == np.uint8 and tab.size == _weak_kernels.RS_TABLE_BYTES
    mul, inv = rs_device.gf_tables()
    syn, xi, xi_inv, ch, xfcr = rs_device._tables(n, nroots, fcr)
    np.testing.assert_array_equal(tab[:4096], mul.reshape(-1))
    np.testing.assert_array_equal(tab[4096:4160], inv)
    for q, col in enumerate((xi, xi_inv, xfcr)):
        np.testing.assert_array_equal(tab[4160 + 64 * q : 4160 + 64 * q + n],
                                      col)
    root = tab[4352 : 4352 + nroots].astype(np.int64)
    # S_j's powers are root_j ** deg_i, Chien's X_i^-d
    for j in (0, 7, nroots - 1):
        p = np.ones(1, np.int64)
        for i in range(n - 1, -1, -1):
            assert syn[j, i] == p[0]
            p = mul[p, root[j]]
    np.testing.assert_array_equal(ch[1], xi_inv)


@pytest.mark.parametrize("k,fcr", [(12, 3), (45, 1)])
def test_rs_kernel_model_matches_plain(k, fcr):
    """The kernel's algorithm gives the plain version's corrected words
    and ok flags, for JT65's RS(63,12) fcr 3 and an RS(63,45) fcr 1 (18
    roots: the locator's coefficients in nine lanes): every ``_rs_cases``
    case (0, exactly 51 and more than 51 erasures, the all-zero word), each
    word a candidate of one trial; and the words as candidates of several
    trials each (their syndromes once)."""
    rng = np.random.default_rng(k)
    if k == 12:
        cases = _rs_cases(rng)
        words = np.concatenate([w for w, _ in cases.values()])
        eras = np.concatenate([e for _, e in cases.values()])
    else:
        rs = jrs64.RS63(k, fcr=fcr)
        words = np.stack([rs.encode(rng.integers(0, 64, k))
                          for _ in range(40)])
        eras = rng.random((40, 63)) < rng.uniform(0, 0.35, (40, 1))
        words[rng.random((40, 63)) < 0.06] ^= 5
    nroots = 63 - k
    tab = rs_device.kernel_tables(63, nroots, fcr)
    cp, okp = rs_device.rs_ee_decode_plain(
        (63, k, fcr), torch.from_numpy(words), torch.from_numpy(eras))
    got, ok = _rs_model(tab, words, eras[:, None], 63, nroots)
    np.testing.assert_array_equal(got[:, 0], cp.numpy())
    np.testing.assert_array_equal(ok[:, 0], okp.numpy())
    assert ok.any() and not ok.all()
    # candidates of eight trials each: the first eight words' patterns
    syms = words[:: 8][: len(words) // 8]
    era8 = eras[: 8 * len(syms)].reshape(len(syms), 8, 63)
    cp, okp = rs_device.rs_ee_trials_plain(
        (63, k, fcr), torch.from_numpy(syms), torch.from_numpy(era8))
    got, ok = _rs_model(tab, syms, era8, 63, nroots)
    np.testing.assert_array_equal(got, cp.numpy())
    np.testing.assert_array_equal(ok, okp.numpy())


def test_chase_program_decodes_through_the_trial_entry(monkeypatch):
    """rs_chase_program hands rs_ee_trials each chunk's syms [cc, n] and
    era [cc, T, n]; its result equals the route through the expanded
    [cc T, n] words, chunk by chunk."""
    rng = np.random.default_rng(65)
    rs = jrs64.RS63(12, fcr=3)
    c, n = 5, 63
    syms = np.stack([rs.encode(rng.integers(0, 64, 12)) for _ in range(c)])
    syms[rng.random((c, n)) < 0.25] ^= 9
    margin = rng.random((c, n)).astype(np.float32)
    top_tone = np.stack([syms, (syms + 1) % 64, (syms + 2) % 64,
                         (syms + 3) % 64], axis=-1)
    top_e = (rng.random((c, n, 4)) * [4.0, 1.0, 0.5, 0.25]).astype(
        np.float32)
    e_sum = (top_e.sum(-1) + 8.0).astype(np.float32)
    args = [torch.from_numpy(x) for x in (syms, margin, top_e, top_tone,
                                          e_sum)]
    seen = []
    trials = rs_device.rs_ee_trials

    def record(nk_fcr, s, e):
        seen.append((tuple(s.shape), tuple(e.shape)))
        return trials(nk_fcr, s, e)

    monkeypatch.setattr(rs_device, "rs_ee_trials", record)
    monkeypatch.setattr(rs_device, "TRIALS_PER_CALL", 64 * 2)
    got = rs_device.rs_chase_program((63, 12, 3), 64, 6, 0.4, *args, 3)
    assert seen == [((2, n), (2, 64, n)), ((2, n), (2, 64, n)),
                    ((1, n), (1, 64, n))]

    def expanded(nk_fcr, s, e):
        cc, t, _ = e.shape
        corr, ok = rs_device.rs_ee_decode_plain(
            nk_fcr, s[:, None].expand(cc, t, n).reshape(-1, n),
            e.reshape(-1, n))
        return corr.reshape(cc, t, n), ok.reshape(cc, t)

    monkeypatch.setattr(rs_device, "rs_ee_trials", expanded)
    want = rs_device.rs_chase_program((63, 12, 3), 64, 6, 0.4, *args, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[2].any()


def test_rs_bound_counts_the_roots_the_data_has():
    """The smoke's RS bound counts Forney's work at the locator's roots of
    this run's trials: a clean word with e erasures has e roots, one with
    k decoded errors and no erasures k, one with more erasures than roots
    at most nroots; and a candidate's syndromes once for its trials."""
    import chip_smoke

    rng = np.random.default_rng(5)
    word = jrs64.RS63(12, fcr=3).encode(rng.integers(0, 64, 12))
    syms = torch.from_numpy(np.stack([word, word, word]).astype(np.int64))
    syms[1, [3, 17, 40]] ^= 5
    era = torch.zeros((3, 1, 63), dtype=torch.bool)
    era[0, 0, :20] = True
    era[2, 0, :] = True
    corr, ok = rs_device.rs_ee_trials_plain((63, 12, 3), syms, era)
    assert ok[:2].all()
    for i, roots in enumerate((20, 3, 51)):
        got = chip_smoke.rs_bound_ms((63, 12, 3), syms[i:i + 1],
                                     era[i:i + 1], corr[i:i + 1])
        assert got[2]["roots_a_trial_mean"] == roots
    # a candidate's syndromes count once for all its trials: two trials of
    # one candidate cost twice one trial less one syndrome set (51 x 62
    # products of 2 operations)
    one = chip_smoke.rs_bound_ms((63, 12, 3), syms[:1], era[:1], corr[:1])
    two = chip_smoke.rs_bound_ms((63, 12, 3), syms[:1],
                                 era[:1].expand(1, 2, 63).contiguous(),
                                 corr[:1].expand(1, 2, 63).contiguous())
    assert two[2]["int_ops"] == 2 * one[2]["int_ops"] - 2 * 51 * 62
    assert two[2]["int_ops_syndromes_a_trial"] == 2 * one[2]["int_ops"]


# ---------------------------------------------------------------------------
# routing and refusals


@pytest.fixture
def no_build(monkeypatch):
    def build():
        raise AssertionError("the library was built")

    monkeypatch.setattr(_weak_kernels, "load_library", build)


def test_cpu_tensors_run_the_plain_versions(no_build):
    """On CPU tensors the dispatchers run the plain versions (equal
    results), load no library and count no launch; on another device they
    go to the kernel wrappers, which refuse a device that is not CUDA."""
    llr = torch.from_numpy(_tie_llrs(3))
    cfg = wspr.WSPRConfig(beam_width=64)
    before = dict(_weak_kernels.launches)
    got = wspr._beam_decode(cfg, llr)
    want = wspr._beam_decode_plain(cfg, llr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cases = _rs_cases(np.random.default_rng(7))
    words, eras = (torch.from_numpy(x) for x in cases["random words"])
    got = rs_device.rs_ee_decode((63, 12, 3), words, eras)
    want = rs_device.rs_ee_decode_plain((63, 12, 3), words, eras)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = rs_device.rs_ee_trials((63, 12, 3), words[:4],
                                 eras[:12].reshape(4, 3, 63))
    want = rs_device.rs_ee_trials_plain((63, 12, 3), words[:4],
                                        eras[:12].reshape(4, 3, 63))
    assert got[0].dtype == torch.uint8
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _weak_kernels.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        wspr._beam_decode(cfg, llr.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rs_device.rs_ee_decode((63, 12, 3), words.to("meta"),
                               eras.to("meta"))


def test_weak_wrapper_refusals(no_build):
    """Wrong dtypes, shapes, contiguity, beam widths, word lengths and
    root counts raise before any build."""
    llr = torch.zeros((4, 81, 2))
    beam = _weak_kernels.wspr_beam
    with pytest.raises(ValueError, match="dtype"):
        beam(llr.double(), 512)
    with pytest.raises(ValueError, match="shape"):
        beam(llr[:, :80], 512)
    with pytest.raises(ValueError, match="3-D"):
        beam(llr[0], 512)
    with pytest.raises(ValueError, match="contiguous"):
        beam(llr.transpose(0, 1).contiguous().transpose(0, 1), 512)
    for w in (16, 384, 2048):
        with pytest.raises(ValueError, match="power of two"):
            beam(llr, w)
    for w, keys in ((512, 8), (512, 16), (32, 4), (1024, 3)):
        with pytest.raises(ValueError, match="is built for"):
            beam(llr, w, keys=keys)
    with pytest.raises(ValueError, match="CUDA"):
        beam(llr, 512)
    tab = torch.from_numpy(rs_device.kernel_tables(63, 51, 3))
    syms = torch.zeros((4, 63), dtype=torch.int64)
    era = torch.zeros((4, 3, 63), dtype=torch.bool)
    rs = _weak_kernels.rs_ee
    with pytest.raises(ValueError, match="dtype"):
        rs(tab, syms.int(), era, 51)
    with pytest.raises(ValueError, match="dtype"):
        rs(tab, syms, era.to(torch.uint8), 51)
    with pytest.raises(ValueError, match="shape"):
        rs(tab, syms, era[:2], 51)
    with pytest.raises(ValueError, match="shape"):
        rs(tab[:4096], syms, era, 51)
    with pytest.raises(ValueError, match="2- and 3-D"):
        rs(tab, syms, era[0], 51)
    with pytest.raises(ValueError, match="contiguous"):
        rs(tab, syms, era.transpose(0, 1).contiguous().transpose(0, 1), 51)
    with pytest.raises(ValueError, match="symbols"):
        rs(tab, torch.zeros((4, 64), dtype=torch.int64),
           torch.zeros((4, 3, 64), dtype=torch.bool), 51)
    for nroots in (0, 63):
        with pytest.raises(ValueError, match="nroots"):
            rs(tab, syms, era, nroots)
    with pytest.raises(ValueError, match="CUDA"):
        rs(tab, syms, era, 51)


def test_decoder_contracts_on_the_card(no_build):
    """A WSPR decoder for a card refuses a beam width the kernel does not
    take when it is built, not in a decode; on the CPU any width stays.
    The RS table block is copied once a code and device, and cached."""
    with pytest.raises(ValueError, match="power of two from 32 to 1024"):
        wspr.WSPRDecoder(beam_width=300, device="cuda")
    assert wspr.WSPRDecoder(beam_width=300, device="cpu").cfg.beam_width \
        == 300
    tab = rs_device.kernel_tables_device((63, 12, 3), "cpu")
    assert torch.equal(tab, torch.from_numpy(
        rs_device.kernel_tables(63, 51, 3)))
    assert rs_device.kernel_tables_device((63, 12, 3),
                                          torch.device("cpu")) is tab


def test_weak_kernels_raise_without_library(monkeypatch, tmp_path):
    """A CUDA-typed call with no nvcc and no built library raises "nvcc
    not found" rather than running the plain version; no launch is
    counted."""
    monkeypatch.setattr(_weak_kernels, "_lib", None)
    monkeypatch.setattr(_weak_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_weak_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_weak_kernels, "_check", lambda operands: None)
    before = dict(_weak_kernels.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _weak_kernels.wspr_beam(torch.zeros((2, 81, 2)), 512)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _weak_kernels.rs_ee(torch.zeros(4416, dtype=torch.uint8),
                            torch.zeros((2, 63), dtype=torch.int64),
                            torch.zeros((2, 1, 63), dtype=torch.bool), 51)
    assert _weak_kernels.launches == before
