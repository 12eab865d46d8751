"""Q-ary sparse code over GF(64) + batched sum-product decoder (device,
PyTorch).

Counterpart of ``cwsl_digi_tpu/modes/qra.py``: the host code construction
below is the reference's, copied as it is; ``QaryMPDecoder.decode`` is the
port of its device decoder.  The reference's description follows.

The real Q65 inner code is QRA(63,13): a q-ary repeat-accumulate code over
GF(64) decoded with full symbol-probability message passing — that soft
decoder, fed per-tone energies, is where Q65's sensitivity comes from (the
reference gets it from jt9 -3, source/DecoderPool.hpp:645-647).  This module
provides the native equivalent:

- ``build_qra_code``: a deterministic sparse parity-check code over GF(64)
  with the exact (n, k) = (63, 13) and a low-density edge profile (info
  columns weight 3, parity columns weight 2), random nonzero GF edge
  coefficients, 4-cycle-free; columns arranged so a systematic encoder
  exists.  Same stand-in policy as the binary LDPC codes (modes/ldpc.py):
  rate/length/alphabet/degree-profile match gives the same waterfall; drop
  the published QRA matrix in for on-air interop.
- ``QaryMPDecoder``: batched sum-product over GF(64) in the probability
  domain.  Check nodes convolve symbol distributions under GF addition
  (= XOR), done with a 64-point Walsh-Hadamard transform as one [64, 64]
  float32 matmul (TF32 stays off: ``device.py``); GF edge coefficients
  are static permutations of the symbol axis.  Fixed iteration count, no
  data-dependent control flow.

On the card the decode is one launch of the ``qra_mp`` kernel
(``_qary_kernels``, ``csrc/qary.cu``); ``QaryMPDecoder.decode_plain`` is
the plain version the CPU runs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.convert import tables_to_torch
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes import _qary_kernels
from cwsl_digi_tpu_torch.modes.rs64 import _tables

Q = 64


# ---------------------------------------------------------------------------
# GF(64) vector helpers (host)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _mul_table() -> np.ndarray:
    """[64, 64] GF(64) multiplication table."""
    exp, log = _tables()
    t = np.zeros((Q, Q), np.int64)
    a = np.arange(1, Q)
    la = log[a]
    for b in range(1, Q):
        t[a, b] = exp[la + log[b]]
    return t


def gf_mul(a, b):
    return _mul_table()[a, b]


def gf_inv(a: int) -> int:
    exp, log = _tables()
    return int(exp[(63 - log[a]) % 63])


@functools.lru_cache(maxsize=1)
def _wht64() -> np.ndarray:
    """64-point Walsh-Hadamard matrix (+-1), H @ H = 64 I.

    WHT diagonalizes convolution under GF(2^6) addition (bitwise XOR of
    symbol indices): conv_xor(p, q) = IWHT(WHT(p) * WHT(q)) / 64.
    """
    h = np.array([[1.0]])
    for _ in range(6):
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


# ---------------------------------------------------------------------------
# Code construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QRACode:
    """Sparse GF(64) code. Codeword symbols = [info(k) | parity(n-k)]."""

    n: int
    k: int
    h_vars: np.ndarray     # [n_checks, max_row] var index (pad = n)
    h_coeff: np.ndarray    # [n_checks, max_row] GF coefficient (pad = 1)
    row_mask: np.ndarray   # [n_checks, max_row] 1.0 for real slots
    gen: np.ndarray        # [k, n-k] GF: parity = "info @ gen" over GF(64)

    @property
    def n_checks(self) -> int:
        return self.n - self.k

    def encode(self, info: np.ndarray) -> np.ndarray:
        info = np.asarray(info, np.int64)
        mt = _mul_table()
        parity = np.zeros(self.n - self.k, np.int64)
        for j in range(self.n - self.k):
            acc = 0
            for i in range(self.k):
                acc ^= int(mt[info[i], self.gen[i, j]])
            parity[j] = acc
        return np.concatenate([info, parity])

    def syndrome_ok(self, word: np.ndarray) -> bool:
        mt = _mul_table()
        for c in range(self.n_checks):
            acc = 0
            for s in range(self.h_vars.shape[1]):
                if self.row_mask[c, s]:
                    acc ^= int(mt[word[self.h_vars[c, s]],
                                  self.h_coeff[c, s]])
            if acc:
                return False
        return True


def _gf_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """Solve A X = B over GF(64); A [m, m], B [m, r]; None if singular."""
    mt = _mul_table()
    a = a.copy().astype(np.int64)
    b = b.copy().astype(np.int64)
    m = a.shape[0]
    for c in range(m):
        piv = None
        for r in range(c, m):
            if a[r, c]:
                piv = r
                break
        if piv is None:
            return None
        if piv != c:
            a[[c, piv]] = a[[piv, c]]
            b[[c, piv]] = b[[piv, c]]
        inv = gf_inv(int(a[c, c]))
        a[c] = mt[a[c], inv]
        b[c] = mt[b[c], inv]
        for r in range(m):
            if r != c and a[r, c]:
                f = int(a[r, c])
                a[r] ^= mt[a[c], f]
                b[r] ^= mt[b[c], f]
    return b


def build_qra_code(n: int = 63, k: int = 13, seed: int = 65,
                   info_w: int = 3, parity_w: int = 2) -> QRACode:
    """Deterministic sparse GF(64) code with a systematic encoder.

    Info columns get weight ``info_w``, parity columns ``parity_w``, checks
    near-uniform, no 4-cycles (no two columns share two checks), random
    nonzero GF coefficients.  Retries seeds until the parity square is
    invertible.
    """
    n_checks = n - k
    for attempt in range(256):
        rng = np.random.default_rng(seed + attempt)
        cols: list[np.ndarray] = []
        row_fill = np.zeros(n_checks, np.int64)
        pair_seen: set[tuple[int, int]] = set()
        ok = True
        for c in range(n):
            w = info_w if c < k else parity_w
            for _try in range(200):
                noise = rng.random(n_checks)
                order = np.lexsort((noise, row_fill))
                pick = np.sort(order[:w])
                pairs = [(int(pick[i]), int(pick[j]))
                         for i in range(w) for j in range(i + 1, w)]
                if all(p not in pair_seen for p in pairs):
                    pair_seen.update(pairs)
                    break
            else:
                ok = False
                break
            cols.append(pick)
            row_fill[pick] += 1
        if not ok or np.any(row_fill == 0):
            continue
        # dense H over GF for the encoder solve
        h = np.zeros((n_checks, n), np.int64)
        for c, pick in enumerate(cols):
            for r in pick:
                h[r, c] = int(rng.integers(1, Q))
        try:
            return code_from_dense(h, k)
        except ValueError:
            continue
    raise RuntimeError("failed to construct q-ary code")


def code_from_dense(h: np.ndarray, k: int) -> QRACode:
    """Build a :class:`QRACode` from a dense GF(64) parity matrix
    ``[n_checks, n]`` (0 = no edge) with info columns first.

    This is the entry point for the PUBLISHED Q65 QRA(63,13) matrix
    (supplied via CWSL_DIGI_TPU_TABLES_DIR/q65_qra_63_13.txt,
    modes/tables_ext.py) as well as the stand-in construction above."""
    h = np.asarray(h, np.int64)
    n_checks, n = h.shape
    if k != n - n_checks:
        raise ValueError(f"H shape {h.shape} inconsistent with k={k}")
    bmat = h[:, k:]
    amat = h[:, :k]
    sol = _gf_solve(bmat, amat)        # [n_checks, k]: parity = sol @ info
    if sol is None:
        raise ValueError("parity block of H is singular over GF(64); "
                         "supply H with info columns first")
    # sparse row tables
    rows = [np.nonzero(h[i])[0] for i in range(n_checks)]
    max_row = max(len(r) for r in rows)
    h_vars = np.full((n_checks, max_row), n, np.int32)
    h_coeff = np.ones((n_checks, max_row), np.int32)
    row_mask = np.zeros((n_checks, max_row), np.float32)
    for i, r in enumerate(rows):
        h_vars[i, : len(r)] = r
        h_coeff[i, : len(r)] = h[i, r]
        row_mask[i, : len(r)] = 1.0
    return QRACode(n=n, k=k, h_vars=h_vars, h_coeff=h_coeff,
                   row_mask=row_mask, gen=sol.T.astype(np.int64))


# ---------------------------------------------------------------------------
# Batched sum-product decoder (device)
# ---------------------------------------------------------------------------

class QaryMPDecoder:
    """Batched GF(64) sum-product in the probability domain.

    Messages are [batch, n_checks, max_row, 64] distributions.  Check
    update: permute each incoming message by its GF coefficient, WHT,
    leave-one-out product across the check's slots, inverse WHT, permute
    back.  Variable update: channel likelihood times incoming extrinsics.
    Padded slots carry uniform distributions so they are exact no-ops.
    The tables live on ``device`` (default: the card).
    """

    def __init__(self, code: QRACode, iters: int = 33,
                 device: torch.device | str | None = None):
        self.code = code
        self.iters = iters
        self.device = as_device(device)
        mt = _mul_table()
        nc, mr = code.h_vars.shape
        n = code.n
        # symbol-permutation tables per edge slot:
        # fwd[c,s,t] = index v such that coeff*v = t  (var -> check domain)
        inv_c = np.array([0] + [gf_inv(g) for g in range(1, Q)], np.int64)
        coeff = code.h_coeff.astype(np.int64)
        self._fwd = mt[inv_c[coeff][:, :, None], np.arange(Q)[None, None, :]]
        # bwd[c,s,t] = coeff*t (check -> var domain index of symbol t)
        self._bwd = mt[coeff[:, :, None], np.arange(Q)[None, None, :]]
        # variable-side gather: edges incident to each var (flat slot ids)
        slots = [[] for _ in range(n)]
        for c in range(nc):
            for s in range(mr):
                if code.row_mask[c, s]:
                    slots[int(code.h_vars[c, s])].append(c * mr + s)
        self._max_col = max(len(s) for s in slots)
        col_slots = np.zeros((n, self._max_col), np.int32)
        col_mask = np.zeros((n, self._max_col), np.float32)
        for v, ss in enumerate(slots):
            col_slots[v, : len(ss)] = ss
            col_mask[v, : len(ss)] = 1.0
        self._col_slots = col_slots
        self._col_mask = col_mask
        self._h_vars = code.h_vars
        self._row_mask = code.row_mask
        if self.device.type == "cuda":
            _qary_kernels.check_mp_code(*self.kernel_code)
        self._tabs = {k: v.to(torch.int64) if v.dtype == torch.int32 else v
                      for k, v in tables_to_torch(self._host_tables(),
                                                  self.device).items()}
        self._ktab: dict[torch.device, torch.Tensor] = {}   # by device

    def _host_tables(self) -> dict[str, np.ndarray]:
        return {"h_vars": self._h_vars, "h_coeff": self.code.h_coeff,
                "row_mask": self._row_mask, "qra_fwd": self._fwd,
                "qra_bwd": self._bwd, "col_slots": self._col_slots,
                "col_mask": self._col_mask, "wht": _wht64(),
                "gf_mul": _mul_table()}

    def tables(self) -> dict[str, torch.Tensor]:
        """Host tables the reference also builds (see ``convert.py``)."""
        return {k: torch.from_numpy(v) for k, v in self._host_tables().items()}

    @property
    def kernel_code(self) -> tuple[int, int, int, int]:
        """(n, checks, slots a check, edges a variable) for ``qra_mp``."""
        nc, mr = self.code.h_vars.shape
        return self.code.n, nc, mr, self._max_col

    def kernel_tables(self) -> np.ndarray:
        """The ``qra_mp`` kernel's table block, uint8, from the plain
        version's tables: h_vars and h_coeff [nc, mr] (h_vars = n in a
        padded slot), the permutations fwd and bwd [nc, mr, 64], col_slots
        [n, max_col] (255 in a padded column slot), gf_mul [64, 64] and
        e_slot, the flat slots c mr + s of the real slots (the kernel's
        edges), ascending: its length gives the kernel the edge count."""
        t = self._host_tables()
        col = np.where(t["col_mask"] > 0, t["col_slots"], 255)
        e_slot = np.flatnonzero(t["row_mask"].reshape(-1) > 0)
        parts = [t["h_vars"], t["h_coeff"], t["qra_fwd"], t["qra_bwd"], col,
                 t["gf_mul"], e_slot]
        return np.concatenate([np.asarray(a).reshape(-1) for a in parts]
                              ).astype(np.uint8)

    def decode(self, probs: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """probs: [B, n, 64] channel symbol likelihoods (rows normalized).

        Returns (hard symbols [B, n] int64, syndrome_ok [B] bool,
        posterior max-prob [B] — a confidence for acceptance gates).  On a
        CUDA tensor one launch of the ``qra_mp`` kernel (``_qary_kernels``;
        it raises where the kernel cannot run), on a CPU tensor
        :meth:`decode_plain`.
        """
        if probs.device.type == "cpu":
            return self.decode_plain(probs)
        tab = self._ktab.get(probs.device)
        if tab is None:
            # the kernel's table block, copied on first use on a device
            tab = self._ktab[probs.device] = torch.from_numpy(
                self.kernel_tables()).to(probs.device)
        return _qary_kernels.qra_mp(tab, probs.contiguous(),
                                    self.kernel_code, self.iters)

    def decode_plain(self, probs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`decode` in plain PyTorch: the reference's program, the
        transforms as [64, 64] float32 matmuls."""
        bsz = probs.shape[0]
        nc, mr = self.code.h_vars.shape
        n = self.code.n
        t = self._tabs
        wht = t["wht"]
        h_vars = t["h_vars"]
        row_mask = t["row_mask"][None, :, :, None]
        fwd = t["qra_fwd"][None].expand(bsz, -1, -1, -1)
        bwd = t["qra_bwd"][None].expand(bsz, -1, -1, -1)
        col_slots = t["col_slots"].reshape(-1)
        col_ok = t["col_mask"][None, :, :, None] > 0
        uni = 1.0 / Q
        slot_ids = torch.arange(mr, device=probs.device)[None, None, :, None]
        excl = [(row_mask > 0) & (slot_ids != s) for s in range(mr)]

        # channel likelihoods padded with a uniform row for slot gathers
        chan = torch.cat([probs, torch.full((bsz, 1, Q), uni,
                                            dtype=probs.dtype,
                                            device=probs.device)], dim=1)

        def norm(m):
            return m / (m.sum(dim=-1, keepdim=True) + 1e-30)

        def var_product(m_cv):
            flat = m_cv.reshape(bsz, nc * mr, Q)
            inc = flat[:, col_slots].reshape(bsz, n, self._max_col, Q)
            inc = torch.where(col_ok, inc, uni)
            return chan[:, :n] * inc.prod(dim=2)

        m_cv = torch.full((bsz, nc, mr, Q), uni, device=probs.device)
        for _ in range(self.iters):
            # ---- variable -> check -------------------------------------
            # posterior-style product of channel and all incoming messages
            # at each variable, then divide out own message (guarded).
            tot = var_product(m_cv)
            tot_slot = tot[:, h_vars.clamp(0, n - 1)]        # wrong for pads
            tot_slot = torch.where(h_vars[None, :, :, None] < n, tot_slot, uni)
            m_vc = tot_slot / (m_cv + 1e-30)
            m_vc = norm(m_vc.clamp(min=1e-30)) * row_mask \
                + uni * (1.0 - row_mask)
            # ---- check -> variable (WHT domain) ------------------------
            perm = torch.gather(m_vc, -1, fwd)
            w = perm @ wht                                    # [B,nc,mr,Q]
            # leave-one-out product over the check's slots; w crosses zero
            # so divide-by-own is unsafe — explicit exclusion per slot
            loo = torch.stack([torch.where(excl[s], w, 1.0).prod(dim=2)
                               for s in range(mr)], dim=2)
            new = (loo @ wht) / Q
            new = torch.gather(new, -1, bwd)
            new = new.clamp(min=1e-30)
            m_cv = norm(new) * row_mask + uni * (1.0 - row_mask)

        # posterior + hard decision
        post = norm(var_product(m_cv))
        hard = post.argmax(dim=-1)

        # syndrome over GF(64): xor of coeff*symbol per check
        hard_pad = torch.cat([hard, torch.zeros_like(hard[:, :1])], dim=1)
        sym_slot = hard_pad[:, h_vars]                        # [B, nc, mr]
        prod_slot = t["gf_mul"][sym_slot, t["h_coeff"][None]]
        prod_slot = torch.where(t["row_mask"][None] > 0, prod_slot, 0)
        syn = prod_slot[:, :, 0]
        for s in range(1, mr):
            syn = syn ^ prod_slot[:, :, s]
        ok = (syn == 0).all(dim=1)
        conf = post.amax(dim=-1).mean(dim=-1)
        return hard, ok, conf
