"""LDPC codes (NumPy) and a batched min-sum BP decoder (torch).

Counterpart of ``cwsl_digi_tpu/modes/ldpc.py``.  The host half (GF(2)
row reduction, :class:`Code`, the stand-in code constructor, the BP index
tables, the published FT8 code and the FST4 code) is copied because the
reference module imports jax at the top; the decoder is
:meth:`BPDecoder.decode_full`: on a CUDA tensor the hand kernel
``bp_minsum`` (``csrc/ldpc.cu``, all iterations in one launch), on a CPU
tensor its plain PyTorch version :meth:`BPDecoder.decode_full_plain`.

Codes: the published LDPC(174,91) of FT8/FT4; LDPC(240,101) for
FST4/FST4W and LDPC(174,87) for JS8 (``modes/js8.py``), each the published
table when ``CWSL_DIGI_TPU_TABLES_DIR`` supplies it (``modes/tables_ext.py``)
and otherwise the documented same-profile stand-in of
:func:`make_ldpc_code`, whose check rows have irregular weights.

Normalized min-sum with a fixed iteration count: check->variable messages
live in a dense ``[batch, n_checks, max_row]`` tensor (padded slots
masked); every word runs every iteration and convergence is read from the
syndrome afterwards.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes import _kernels, tables


def gf2_row_reduce(mat: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Row-reduce over GF(2); returns (reduced matrix, pivot column list)."""
    m = mat.copy().astype(np.uint8)
    rows, cols = m.shape
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot_rows = np.nonzero(m[r:, c])[0]
        if pivot_rows.size == 0:
            continue
        pr = r + pivot_rows[0]
        if pr != r:
            m[[r, pr]] = m[[pr, r]]
        for e in np.nonzero(m[:, c])[0]:
            if e != r:
                m[e] ^= m[r]
        pivots.append(c)
        r += 1
    return m, pivots


def gf2_invert(b: np.ndarray) -> np.ndarray | None:
    """Invert a square GF(2) matrix, or None if singular."""
    r = b.shape[0]
    aug = np.concatenate([b.astype(np.uint8), np.eye(r, dtype=np.uint8)], axis=1)
    red, pivots = gf2_row_reduce(aug)
    if pivots[:r] != list(range(r)):
        return None
    return red[:, r:]


@dataclasses.dataclass(frozen=True)
class Code:
    """A binary LDPC code with a systematic encoder: codewords are
    ``[info_bits(k) | parity_bits(n-k)]``."""

    n: int
    k: int
    h: np.ndarray           # [n-k, n] parity-check matrix (0/1)
    gen_parity: np.ndarray  # [k, n-k]: parity = info @ gen_parity mod 2

    @staticmethod
    def from_parity_matrix(h: np.ndarray) -> "Code":
        h = np.asarray(h, dtype=np.uint8)
        n_checks, n = h.shape
        k = n - n_checks
        binv = gf2_invert(h[:, k:])
        if binv is None:
            raise ValueError("parity section of H is singular; permute columns")
        gen = (binv @ h[:, :k]) % 2           # [n-k, k]
        return Code(n=n, k=k, h=h, gen_parity=gen.T.astype(np.uint8))

    def encode(self, info: np.ndarray) -> np.ndarray:
        info = np.asarray(info, dtype=np.uint8)
        parity = (info @ self.gen_parity) % 2
        return np.concatenate([info, parity.astype(np.uint8)], axis=-1)

    def syndrome(self, word: np.ndarray) -> np.ndarray:
        return (np.asarray(word, np.uint8) @ self.h.T) % 2


def make_ldpc_code(n: int, k: int, seed: int = 1, col_weight: int = 3) -> Code:
    """Deterministic pseudo-random regular-ish LDPC code with (n, k).

    Column weight 3 (the degree profile of the WSJT-X codes); row weights
    near-uniform.  Columns are permuted so the last n-k form an invertible
    square, giving a systematic encoder.  Deterministic in (n, k, seed).
    """
    n_checks = n - k
    rng = np.random.default_rng(seed)
    for attempt in range(64):
        h = np.zeros((n_checks, n), dtype=np.uint8)
        # distribute col_weight ones per column, balancing row weights
        row_fill = np.zeros(n_checks, dtype=np.int64)
        for c in rng.permutation(n):
            # choose the col_weight least-filled rows with random tie-break
            noise = rng.random(n_checks)
            chosen = np.lexsort((noise, row_fill))[:col_weight]
            h[chosen, c] = 1
            row_fill[chosen] += 1
        # arrange columns: find an information set via row reduction
        _, pivots = gf2_row_reduce(h)
        if len(pivots) == n_checks:
            pivot_set = set(pivots)
            non_pivots = [c for c in range(n) if c not in pivot_set]
            try:
                # info columns first, the invertible block last
                return Code.from_parity_matrix(h[:, non_pivots + pivots])
            except ValueError:
                pass
        rng = np.random.default_rng(seed + 1000 + attempt)
    raise RuntimeError("failed to construct LDPC code")


@dataclasses.dataclass(frozen=True)
class BPTables:
    """Static index tables for the batched BP decoder."""

    n: int
    n_checks: int
    max_row: int              # max check degree
    row_cols: np.ndarray      # [n_checks, max_row] var per check slot (pad n)
    row_mask: np.ndarray      # [n_checks, max_row] 1 for real slots
    max_col: int              # max variable degree
    col_slots: np.ndarray     # [n, max_col] flat index into [n_checks*max_row]
    col_mask: np.ndarray      # [n, max_col]


def build_bp_tables(h: np.ndarray) -> BPTables:
    h = np.asarray(h, np.uint8)
    n_checks, n = h.shape
    rows = [np.nonzero(h[i])[0] for i in range(n_checks)]
    max_row = max(len(r) for r in rows)
    row_cols = np.full((n_checks, max_row), n, dtype=np.int32)
    row_mask = np.zeros((n_checks, max_row), dtype=np.float32)
    for i, r in enumerate(rows):
        row_cols[i, : len(r)] = r
        row_mask[i, : len(r)] = 1.0
    cols = [np.nonzero(h[:, j])[0] for j in range(n)]
    max_col = max(len(c) for c in cols)
    col_slots = np.zeros((n, max_col), dtype=np.int32)
    col_mask = np.zeros((n, max_col), dtype=np.float32)
    slot_of = {}
    for i, r in enumerate(rows):
        for s, j in enumerate(r):
            slot_of[(i, j)] = i * max_row + s
    for j, cs in enumerate(cols):
        for s, i in enumerate(cs):
            col_slots[j, s] = slot_of[(i, j)]
            col_mask[j, s] = 1.0
    return BPTables(n, n_checks, max_row, row_cols, row_mask,
                    max_col, col_slots, col_mask)


def kernel_tables(t: BPTables) -> tuple[np.ndarray, np.ndarray]:
    """The BP tables as the ``bp_minsum`` kernel takes them: row_cols
    [n_checks, max_row] int16 (n in a padded slot) and col_slots [n,
    max_col] int16 (-1 in a padded slot)."""
    if t.n > np.iinfo(np.int16).max or t.n_checks * t.max_row > 2**15:
        raise ValueError(f"code too large for int16 tables: n={t.n}")
    col_slots = np.where(t.col_mask > 0, t.col_slots, -1)
    return t.row_cols.astype(np.int16), col_slots.astype(np.int16)


class BPDecoder:
    """Batched normalized min-sum BP for one code, tables on ``device``."""

    def __init__(self, code: Code, iters: int = 30, alpha: float = 0.8,
                 device: torch.device | str | None = None):
        self.code = code
        self.iters = iters
        self.alpha = alpha
        self.t = build_bp_tables(code.h)
        dev = as_device(device)
        self.device = dev
        self._row_cols = torch.from_numpy(self.t.row_cols.astype(np.int64)).to(dev)
        self._row_mask = torch.from_numpy(self.t.row_mask).to(dev)
        self._col_slots = torch.from_numpy(
            self.t.col_slots.reshape(-1).astype(np.int64)).to(dev)
        self._col_mask = torch.from_numpy(self.t.col_mask).to(dev)
        self._h_t = torch.from_numpy(code.h.T.astype(np.float32)).to(dev)
        # the kernel's int16 tables, uploaded once
        self._k_row_cols, self._k_col_slots = (
            torch.from_numpy(a).to(dev) for a in kernel_tables(self.t))

    def decode_full(self, llrs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """llrs [batch, n] (positive = bit 0) -> (hard [batch, n] int8,
        parity_ok [batch] bool, posterior LLR totals [batch, n]).

        A CPU tensor runs :meth:`decode_full_plain`; any other launches the
        ``bp_minsum`` kernel, which raises if it cannot (no fallback)."""
        if llrs.device.type == "cpu":
            return self.decode_full_plain(llrs)
        return _kernels.bp_minsum(llrs.contiguous(), self._k_row_cols,
                                  self._k_col_slots, self.iters, self.alpha)

    def decode_full_plain(self, llrs: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The plain PyTorch version of :meth:`decode_full` (on any
        device): the kernel's oracle."""
        b = llrs.shape[0]
        t = self.t
        n, nc, mr, mc = t.n, t.n_checks, t.max_row, t.max_col
        row_mask = self._row_mask[None]
        pad_big = (1.0 - row_mask) * 1e9
        pad_one = 1.0 - row_mask

        def var_totals(m_cv):
            # each variable pulls its <= max_col incoming check messages
            inc = m_cv.reshape(b, nc * mr)[:, self._col_slots]
            inc = (inc.reshape(b, n, mc) * self._col_mask[None]).sum(-1)
            tot = llrs + inc
            # zero virtual variable at index n for the padded row slots
            return torch.cat([tot, tot.new_zeros(b, 1)], dim=1)

        m_cv = llrs.new_zeros(b, nc, mr)
        for _ in range(self.iters):
            totals = var_totals(m_cv)
            m_vc = (totals[:, self._row_cols] - m_cv) * row_mask
            mag = m_vc.abs() + pad_big
            sgn = torch.where(m_vc < 0, -1.0, 1.0) * row_mask + pad_one
            tot_sgn = sgn.prod(dim=2, keepdim=True)
            m1 = mag.amin(dim=2, keepdim=True)
            m2 = torch.where(mag <= m1, 1e9, mag).amin(dim=2, keepdim=True)
            use = torch.where(mag == m1, m2, m1)
            # duplicate minima: the other minimum is m1 itself
            n_min = (mag <= m1).to(mag.dtype).sum(dim=2, keepdim=True)
            use = torch.where((mag == m1) & (n_min > 1), m1, use)
            m_cv = self.alpha * tot_sgn * sgn * use * row_mask
        totals = var_totals(m_cv)[:, :n]
        hard = (totals < 0).to(torch.int8)
        syn = torch.remainder(hard.to(torch.float32) @ self._h_t, 2.0)
        ok = (syn < 0.5).all(dim=1)
        return hard, ok, totals


@functools.lru_cache(maxsize=None)
def ft8_code() -> Code:
    """The published WSJT-X LDPC(174,91) code (FT8 & FT4), built from the
    parity table in :mod:`cwsl_digi_tpu_torch.modes.tables` (its generator
    is checked against the published rows in ``tests/test_torch_tables.py``)."""
    return Code.from_parity_matrix(tables.ft8_parity_matrix())


@functools.lru_cache(maxsize=None)
def fst4_code() -> Code:
    """LDPC(240,101): the FST4/FST4W inner code, from
    ``CWSL_DIGI_TPU_TABLES_DIR/fst4_ldpc_240_101.txt`` when supplied
    (info columns first), else the same-profile stand-in."""
    from cwsl_digi_tpu_torch.modes import tables_ext

    h = tables_ext.fst4_parity()
    if h is not None:
        return Code.from_parity_matrix(h)
    return make_ldpc_code(240, 101, seed=240)


def get_bp_decoder(which: str, iters: int = 30,
                   device: torch.device | str | None = None) -> BPDecoder:
    """BP decoder of the named code ("ft8" or "fst4") on ``device``."""
    code = {"ft8": ft8_code, "fst4": fst4_code}[which]()
    return BPDecoder(code, iters=iters, device=device)
