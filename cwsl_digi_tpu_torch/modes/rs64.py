"""Reed-Solomon codes over GF(64) for JT65 (RS(63,12)) and Q65 (RS(63,13)).

The reference gets these decoders from jt9.exe's linked Fortran libraries
(source/CWSL_DIGI.vcxproj:136-137); here they are implemented from first
principles: GF(2^6) with primitive polynomial x^6 + x + 1, systematic
encoding via the generator polynomial, and Berlekamp-Massey decoding with
erasure support (errors-and-erasures up to 2e + f <= n - k).

Host-side NumPy: RS decode operates on at most top-K candidate symbol lists
per window (tiny), while the heavy symbol-energy computation stays on
device (see jt65.py / q65.py).
"""

from __future__ import annotations

import functools

import numpy as np

M = 6
N = 63                    # codeword length = 2^6 - 1
PRIM_POLY = 0b1000011     # x^6 + x + 1


@functools.lru_cache(maxsize=1)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables for GF(64)."""
    exp = np.zeros(2 * N, dtype=np.int64)
    log = np.zeros(N + 1, dtype=np.int64)
    x = 1
    for i in range(N):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x40:
            x ^= PRIM_POLY
    exp[N : 2 * N] = exp[:N]
    return exp, log


def gmul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _tables()
    return int(exp[log[a] + log[b]])


def gdiv(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    exp, log = _tables()
    return int(exp[(log[a] - log[b]) % N])


def gpow(a: int, p: int) -> int:
    if a == 0:
        return 0
    exp, log = _tables()
    return int(exp[(log[a] * p) % N])


def _poly_mul(p: list[int], q: list[int]) -> list[int]:
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        if a:
            for j, b in enumerate(q):
                out[i + j] ^= gmul(a, b)
    return out


def _poly_eval(p: list[int], x: int) -> int:
    """Evaluate polynomial (highest-order first)."""
    y = 0
    for c in p:
        y = gmul(y, x) ^ c
    return y


@functools.lru_cache(maxsize=None)
def _generator_poly(n_parity: int, fcr: int) -> tuple[int, ...]:
    """g(x) = prod_{i=fcr..fcr+n_parity-1} (x - alpha^i), highest first."""
    exp, _ = _tables()
    g = [1]
    for i in range(fcr, fcr + n_parity):
        g = _poly_mul(g, [1, int(exp[i % N])])
    return tuple(g)


class RS63:
    """Systematic RS(63, k) over GF(64); codeword = [info | parity].

    ``fcr`` is the first consecutive generator root.  JT65 uses the Karn
    codec parameters init_rs_int(6, 0x43, fcr=3, prim=1, nroots=51) — the
    contract of the jt9 chain the reference spawns (DecoderPool.hpp:648).
    """

    def __init__(self, k: int, fcr: int = 1):
        assert 1 <= k < N
        self.k = k
        self.fcr = fcr
        self.n_parity = N - k
        self.g = list(_generator_poly(self.n_parity, fcr))

    def encode(self, info: np.ndarray) -> np.ndarray:
        info = np.asarray(info, dtype=np.int64)
        assert info.shape == (self.k,) and info.max() < 64
        # message * x^(n-k) mod g
        rem = [0] * self.n_parity
        for sym in info:
            feedback = int(sym) ^ rem[0]
            rem = rem[1:] + [0]
            if feedback:
                for j in range(self.n_parity):
                    rem[j] ^= gmul(feedback, self.g[j + 1])
        return np.concatenate([info, np.asarray(rem, np.int64)])

    # -- decoding -----------------------------------------------------------

    def syndromes(self, word: np.ndarray) -> list[int]:
        """S_j = c(alpha^(fcr+j)), j=0..n_parity-1 — via log/exp tables."""
        exp, log = _tables()
        word = np.asarray(word, np.int64)
        nz = word != 0
        if not nz.any():
            return [0] * self.n_parity
        logs = log[word[nz]]                       # [m]
        degs = (N - 1) - np.nonzero(nz)[0]         # x-power of each coeff
        i = np.arange(self.fcr, self.fcr + self.n_parity)[:, None]
        terms = exp[(logs[None, :] + i * degs[None, :]) % N]
        return list(np.bitwise_xor.reduce(terms, axis=1))

    def decode(self, word: np.ndarray,
               erasures: list[int] | None = None) -> np.ndarray | None:
        """Errors-and-erasures BM decode; returns corrected info symbols or
        None on failure.  ``erasures`` are positions (0 = first info symbol).
        """
        word = np.asarray(word, dtype=np.int64).copy()
        assert word.shape == (N,)
        exp, log = _tables()
        synd = self.syndromes(word)
        if max(synd) == 0:
            return word[: self.k]
        erasures = list(erasures or [])
        if len(erasures) > self.n_parity:
            return None
        # erasure locator (lowest-order-first): prod (1 + x*X_i)
        gamma = self._erasure_locator(erasures)
        # modified syndromes: S'(x) = S(x)*gamma(x) mod x^{2t}
        s_poly = synd[:]  # S_1..S_2t, lowest first
        xi_synd = self._poly_mul_low(s_poly, gamma)[: self.n_parity]
        # BM for the error locator on modified syndromes
        lam = self._berlekamp_massey(xi_synd, len(erasures))
        # full locator = lam * gamma
        locator = self._poly_mul_low(lam, gamma)
        # Chien search (vectorized): evaluate locator at alpha^{-(N-1-pos)}
        exp, log = _tables()
        loc = np.asarray(locator, np.int64)
        nzj = np.nonzero(loc)[0]
        xinv_pows = (-(N - 1 - np.arange(N))) % N          # [N]
        terms = exp[(log[loc[nzj]][None, :]
                     + xinv_pows[:, None] * nzj[None, :]) % N]
        vals = np.bitwise_xor.reduce(terms, axis=1)
        err_pos = list(np.nonzero(vals == 0)[0])
        deg = max((i for i, c in enumerate(locator) if c), default=0)
        if len(err_pos) != deg:
            return None
        # Forney: omega(x) = S(x)*locator(x) mod x^{2t}
        omega = self._poly_mul_low(s_poly, locator)[: self.n_parity]
        lam_odd = locator[1::2]  # derivative: odd coefficients
        for pos in err_pos:
            x = gpow(2, N - 1 - pos)
            xinv = gdiv(1, x)
            num = 0
            for j, c in enumerate(omega):
                num ^= gmul(c, gpow(xinv, j))
            den = 0
            for j, c in enumerate(lam_odd):
                den ^= gmul(c, gpow(xinv, 2 * j))
            if den == 0:
                return None
            # Forney generalized to first root fcr:
            # e = X^(1-fcr) * omega(X^-1) / Lambda'(X^-1)
            mag = gdiv(num, den)
            if self.fcr != 1:
                mag = gmul(mag, gpow(x, 1 - self.fcr))
            word[pos] ^= mag
        if max(self.syndromes(word)) != 0:
            return None
        return word[: self.k]

    # -- helpers (lowest-order-first polynomials) ---------------------------

    @staticmethod
    def _poly_mul_low(p: list[int], q: list[int]) -> list[int]:
        out = [0] * (len(p) + len(q) - 1)
        for i, a in enumerate(p):
            if a:
                for j, b in enumerate(q):
                    out[i + j] ^= gmul(a, b)
        return out

    @staticmethod
    def _erasure_locator(erasures: list[int]) -> list[int]:
        g = [1]
        for pos in erasures:
            xi = gpow(2, N - 1 - pos)
            g = RS63._poly_mul_low(g, [1, xi])
        return g

    def _berlekamp_massey(self, synd: list[int], n_erasures: int) -> list[int]:
        lam = [1]
        b = [1]
        l = 0
        m = 1
        bcoef = 1
        for i in range(self.n_parity - n_erasures):
            # discrepancy
            d = synd[i + n_erasures] if i + n_erasures < len(synd) else 0
            for j in range(1, l + 1):
                if j < len(lam) and i + n_erasures - j >= 0 \
                        and i + n_erasures - j < len(synd):
                    d ^= gmul(lam[j], synd[i + n_erasures - j])
            if d == 0:
                m += 1
            elif 2 * l <= i:
                t = lam[:]
                coef = gdiv(d, bcoef)
                shifted = [0] * m + [gmul(coef, c) for c in b]
                lam = [a ^ bb for a, bb in
                       zip(lam + [0] * (len(shifted) - len(lam)),
                           shifted + [0] * (len(lam) - len(shifted)))]
                l = i + 1 - l
                b = t
                bcoef = d
                m = 1
            else:
                coef = gdiv(d, bcoef)
                shifted = [0] * m + [gmul(coef, c) for c in b]
                lam = [a ^ bb for a, bb in
                       zip(lam + [0] * (len(shifted) - len(lam)),
                           shifted + [0] * (len(lam) - len(shifted)))]
                m += 1
        return lam
