"""A NumPy model of the ``qra_mp`` kernel's arithmetic
(``cwsl_digi_tpu_torch/modes/csrc/qary.cu``), float32 operation for
operation: the variable products in column-slot order, the butterfly
Walsh-Hadamard transform with stride 32 first, warp sums as xor
butterflies, prefix and suffix leave-one-out products, the per-slot
permutation tables and the posterior's NaN-first argmax.  On the same
words it gives the kernel's results bit for bit.

The CPU tests hold it against ``QaryMPDecoder.decode_plain``
(``tests/test_torch_qary_kernels.py``), the card tests and the smoke hold
the kernel against it (``tests/test_torch_cuda.py``, ``chip_smoke.py``),
and ``tools/qra_mp_flips.py`` runs it beside the plain versions.  Imports
no JAX.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
TINY = F32(1e-30)
UNI = F32(1.0 / 64)


def wht_butterfly(x: np.ndarray) -> np.ndarray:
    """The kernel's 64-point Walsh-Hadamard transform of the last axis:
    stride 32, then 16 to 1; the entry with the stride's bit clear becomes
    u + v, the other u - v (u the bit-clear entry)."""
    x = np.asarray(x, F32)
    shape = x.shape
    for h in (32, 16, 8, 4, 2, 1):
        y = x.reshape(*shape[:-1], 64 // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = np.stack([a + b, a - b], axis=-2).reshape(shape)
    return x


def warp_sum64(x: np.ndarray) -> np.ndarray:
    """The kernel's sum of the last axis (64): lane l adds symbols l and
    l + 32, then xor-butterfly rounds 16 to 1 (every lane the same
    float).  Keeps the axis."""
    s = x[..., :32] + x[..., 32:]
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ off]
    return s[..., :1]


def _clamp(x: np.ndarray) -> np.ndarray:
    return np.where(x < TINY, TINY, x)        # NaN stays NaN


def mp_model(dec, probs: np.ndarray
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``qra_mp``'s arithmetic in NumPy float32: (hard [B, n] int64, ok
    [B] bool, conf [B] float32) of probs [B, n, 64] for the code and
    iterations of ``dec`` (a ``qra.QaryMPDecoder``)."""
    t = dec._host_tables()
    h_vars, coeff = t["h_vars"].astype(np.int64), t["h_coeff"]
    fwd, bwd = t["qra_fwd"], t["qra_bwd"]
    col_slots, col_mask = t["col_slots"], t["col_mask"]
    n = dec.code.n
    nc, mr = h_vars.shape
    probs = np.asarray(probs, F32)
    bsz = probs.shape[0]
    m_cv = np.full((bsz, nc, mr, 64), UNI, F32)
    real = h_vars < n                                   # [nc, mr]
    v_of = np.minimum(h_vars, n - 1)

    def var_products():
        flat = m_cv.reshape(bsz, nc * mr, 64)
        p = None
        for j in range(col_slots.shape[1]):
            x = np.where(col_mask[None, :, j, None] > 0,
                         flat[:, col_slots[:, j]], UNI)
            p = x if j == 0 else p * x
        return probs * p

    for _ in range(dec.iters):
        tot = var_products()
        w = np.ones((bsz, nc, mr, 64), F32)
        for s in range(mr):
            a = _clamp(tot[:, v_of[:, s]] / (m_cv[:, :, s] + TINY))
            m = a / (warp_sum64(a) + TINY)
            perm = np.take_along_axis(m, fwd[None, :, s].astype(np.int64),
                                      axis=-1)
            w[:, :, s] = np.where(real[None, :, s, None], wht_butterfly(perm),
                                  F32(1.0))
        loo = np.empty_like(w)
        pre = np.ones((bsz, nc, 64), F32)
        for s in range(mr):
            loo[:, :, s] = pre
            pre = np.where(real[None, :, s, None], pre * w[:, :, s], pre)
        suf = np.ones((bsz, nc, 64), F32)
        for s in range(mr - 1, -1, -1):
            r = real[None, :, s, None]
            loo[:, :, s] = np.where(r, loo[:, :, s] * suf, loo[:, :, s])
            suf = np.where(r, suf * w[:, :, s], suf)
        for s in range(mr):
            q = wht_butterfly(loo[:, :, s]) / F32(64.0)
            new = _clamp(np.take_along_axis(
                q, bwd[None, :, s].astype(np.int64), axis=-1))
            new = new / (warp_sum64(new) + TINY)
            m_cv[:, :, s] = np.where(real[None, :, s, None], new,
                                     m_cv[:, :, s])

    tot = var_products()
    post = tot / (warp_sum64(tot) + TINY)                # [B, n, 64]
    nan = np.isnan(post)
    key = np.where(nan, np.inf, post)
    first_nan = nan.any(-1)
    hard = np.where(first_nan, nan.argmax(-1), key.argmax(-1))
    best = np.where(first_nan, F32(np.nan), post.max(-1, initial=-np.inf))
    conf = best[:, 0].copy()
    for v in range(1, n):
        conf = conf + best[:, v]
    conf = conf / F32(n)
    mul = t["gf_mul"]
    sym = np.concatenate([hard, np.zeros((bsz, 1), np.int64)], 1)[:, h_vars]
    prod = np.where(real[None], mul[sym, coeff[None]], 0)
    ok = ~np.bitwise_xor.reduce(prod, axis=2).any(axis=1)
    return hard.astype(np.int64), ok, conf.astype(F32)
