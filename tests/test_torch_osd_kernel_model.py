"""The OSD kernel's reduction on the CPU: a NumPy model of what each warp
of ``csrc/ldpc.cu`` ``osd_kernel`` does to one word (the bitonic sort of
its 64-bit keys in registers, the generator's columns from the packed
column table, Gauss-Jordan in column form with no row swaps, the rows in
basis order and the base codeword) held to ``osd.osd_reduce_plain`` exactly
(permutation, reduced rows, basis) on the FT8, FST4 and WSPR generators,
with tied magnitudes, NaN and columns with no pivot; and the column
table the kernel reads."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import _kernels, fst4, ldpc, osd, wspr

torch.set_num_threads(1)


def _generator(code) -> np.ndarray:
    return np.concatenate([np.eye(code.k, dtype=np.uint8), code.gen_parity],
                          axis=1)


def _gens() -> dict:
    """name: generator [k, n] of each OSD shape the kernel serves."""
    return {"ft8": _generator(ldpc.ft8_code()),
            "fst4": _generator(ldpc.fst4_code()),
            "wspr": wspr._code_matrices()[0]}


def _keys(llr: np.ndarray) -> np.ndarray:
    """The kernel's sort keys of one word: (|LLR| bits + 1, 0 for NaN) << 10
    | (511 - index) << 1 | sign, larger = more reliable."""
    n = llr.size
    a = np.abs(llr).astype(np.float32)
    v = np.where(np.isnan(a), 0, a.view(np.uint32).astype(np.uint64) + 1)
    j = np.arange(n, dtype=np.uint64)
    return (v << np.uint64(10)) | ((np.uint64(511) - j) << np.uint64(1)) \
        | (llr < 0).astype(np.uint64)


def _bitonic_desc(keys: np.ndarray, n2: int) -> np.ndarray:
    """The kernel's network on 256 positions, stopped after the stage of
    size n2: at (kk, j) position e and its partner e ^ j keep the larger
    key first where e & kk == 0 and the smaller first elsewhere."""
    a = np.zeros(256, np.uint64)
    a[: keys.size] = keys
    e = np.arange(256)
    kk = 2
    while kk <= n2:
        j = kk >> 1
        while j > 0:
            lo = e[(e & j) == 0]
            hi = lo | j
            desc = (lo & kk) == 0
            x, y = a[lo].copy(), a[hi].copy()
            big, small = np.maximum(x, y), np.minimum(x, y)
            a[lo] = np.where(desc, big, small)
            a[hi] = np.where(desc, small, big)
            j >>= 1
        kk <<= 1
    return a


def _model_reduce(gen: np.ndarray, llr: np.ndarray):
    """One word through the kernel's steps 1-4.  Returns (perm [n], rows
    [k, n] 0/1 in basis order, basis [k], base codeword [n], columns with
    no pivot before the k-th pivot)."""
    k, n = gen.shape
    n2 = 2
    while n2 < n:
        n2 <<= 1
    srt = _bitonic_desc(_keys(llr), n2)[:n]
    perm = (511 - ((srt >> np.uint64(1)) & np.uint64(511))).astype(np.int64)
    ysgn = (srt & np.uint64(1)).astype(np.int64)
    # column c of the permuted generator: the k-bit mask of column perm[c]
    table = _kernels.generator_columns(torch.from_numpy(gen)).numpy().view(
        np.uint32)
    cols = [sum(int(table[p, w]) << (32 * w) for w in range(4))
            for p in perm]
    used, r, skipped = 0, 0, 0
    rank, pcol = {}, {}
    for c in range(n):
        if r >= k:
            break
        cand = cols[c] & ~used
        if not cand:
            skipped += 1
            continue
        pb = cand & -cand                       # the owner's one-hot pivot
        p = pb.bit_length() - 1
        piv = cols[c] & ~pb
        for j in range(n):
            if cols[j] & pb:
                assert j >= c, "a column before the pivot's changed"
                cols[j] ^= piv
        used |= pb
        rank[p], pcol[p] = r, c
        r += 1
    for p in range(k):                          # rank deficient: zero rows
        if p not in rank:
            rank[p], pcol[p] = r, 0
            r += 1
    rows = np.zeros((k, n), np.int64)
    basis = np.zeros(k, np.int64)
    for p in range(k):
        rows[rank[p]] = [(cols[j] >> p) & 1 for j in range(n)]
        basis[rank[p]] = pcol[p]
    d = {p: ysgn[pcol[p]] for p in range(k)}
    base = np.array([bin(cols[j] & sum(1 << p for p in range(k) if d[p]))
                     .count("1") & 1 for j in range(n)])
    return perm, rows, basis, base, skipped


@pytest.mark.parametrize("name", list(_gens()))
def test_osd_kernel_model_equals_plain_reduction(name):
    """24 seeded noisy codewords of the code (a quarter rounded to whole
    numbers: tied magnitudes; NaN at a few positions of two words): the
    model's order, reduced rows and basis equal osd_reduce_plain's exactly,
    and its base codeword is the plain version's decisions times its
    rows; some columns have no pivot."""
    gen = _gens()[name]
    llr = chip_smoke.noisy_llrs(gen, 24, seed=81, ties=6)
    llr[3, [0, 17, 40]] = np.nan
    llr[9, 5] = np.nan
    perm_p, gbits, basis_p = osd.osd_reduce_plain(torch.from_numpy(gen),
                                                  torch.from_numpy(llr))
    skipped = 0
    for w in range(llr.shape[0]):
        perm, rows, basis, base, sk = _model_reduce(gen, llr[w])
        skipped += sk
        np.testing.assert_array_equal(perm, perm_p[w].numpy())
        np.testing.assert_array_equal(rows, gbits[w].numpy())
        np.testing.assert_array_equal(basis, basis_p[w].numpy())
        y = (llr[w][perm] < 0).astype(np.int64)
        np.testing.assert_array_equal(base, (y[basis] @ rows) % 2)
    assert skipped > 0


def test_generator_columns_pack_each_column():
    """The kernel's column table: column j of each generator as a k-bit
    mask, row i at bit i & 31 of word i >> 5, [n, 4] int32, built once per
    generator tensor."""
    for gen in _gens().values():
        g = torch.from_numpy(gen)
        table = _kernels.generator_columns(g)
        assert table.shape == (gen.shape[1], 4)
        assert table.dtype == torch.int32
        bits = (table.numpy().view(np.uint32)[:, :, None]
                >> np.arange(32, dtype=np.uint32)) & 1
        bits = bits.reshape(gen.shape[1], 128)
        np.testing.assert_array_equal(bits[:, : gen.shape[0]].T, gen)
        assert not bits[:, gen.shape[0]:].any()
        assert _kernels.generator_columns(g) is table
