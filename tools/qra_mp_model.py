"""A NumPy model of the ``qra_mp`` kernel's arithmetic
(``cwsl_digi_tpu_torch/modes/csrc/qary.cu``), float32 operation for
operation: the messages of the real edges only; at each variable, each
edge's message as the product of the variable's other messages in column
order times the channel row, times 1/64 for each padded column slot, 0
where that times the edge's own message underflows to 0, clamped at 1e-30,
read at the check's permuted symbols; the butterfly Walsh-Hadamard
transform with stride 32 first, normalised by its DC term through an IEEE
reciprocal; at each check, prefix and suffix leave-one-out products, the
inverse transform, / 64, the clamp and no second normalisation, written
back through the permutation; the posterior (the channel row times the
messages in column order, a warp sum as an xor butterfly) and its
NaN-first argmax.  On the same words it gives the kernel's results bit for
bit.  ``mp_model(..., change=...)`` runs it with one step changed (one of
``CHANGES``, for ``tools/qra_mp_variants.py``).

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
# one step of the arithmetic changed: the variable's message without the 0
# where its product with the edge's own message underflows, or without the
# 1/64 a padded column slot; the plain version's variable message (the
# product over every edge, 1/64 a padded column slot, divided by the own
# message + 1e-30); the transformed message divided by its DC term + 1e-30
# in place of multiplied by the reciprocal; the check's message normalised
# again by its 64-term sum (a warp sum)
CHANGES = ("no underflow zero", "no padding scale", "division",
           "divide, not reciprocal", "renormalise checks")


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


def edge_tables(dec) -> dict:
    """The kernel's edges (the real slots, ascending): each one's variable,
    permutation fwd (check symbol l <- variable symbol fwd[l]) and bwd, and
    its padding scale (UNI to the padded column slots of its variable);
    each variable's edges in column order and each edge's other edges
    there (-1 padded); each check's edges [nc, mr] (-1 padded)."""
    t = dec._host_tables()
    n = dec.code.n
    max_col = dec.kernel_code[3]
    real = (t["row_mask"] > 0).reshape(-1)
    e_slot = np.flatnonzero(real)
    edge_of = np.full(real.size, -1)
    edge_of[e_slot] = np.arange(e_slot.size)
    col = np.where(t["col_mask"] > 0, edge_of[t["col_slots"]], -1)   # [n, D]
    deg = (col >= 0).sum(1)
    e_var = t["h_vars"].reshape(-1)[e_slot].astype(np.int64)
    others = np.full((e_slot.size, max(max_col - 1, 1)), -1)
    for e, v in enumerate(e_var):
        o = [x for x in col[v, : deg[v]] if x != e]
        others[e, : len(o)] = o
    scale = np.ones(e_slot.size, F32)
    for e, v in enumerate(e_var):
        for _ in range(max_col - deg[v]):
            scale[e] = scale[e] * UNI
    return {"e_var": e_var, "fwd": t["qra_fwd"].reshape(-1, 64)[e_slot]
            .astype(np.int64),
            "bwd": t["qra_bwd"].reshape(-1, 64)[e_slot].astype(np.int64),
            "var_edges": col, "others": others, "scale": scale,
            "check_edges": edge_of.reshape(t["h_vars"].shape)}


def _products(m: np.ndarray, idx: np.ndarray) -> tuple:
    """The products over the columns of ``idx`` (-1 = none) of the rows of
    m [B, E, 64], in column order: (product, whether any column)."""
    p = m[:, np.maximum(idx[:, 0], 0)]
    for j in range(1, idx.shape[1]):
        p = np.where((idx[:, j] >= 0)[None, :, None],
                     p * m[:, np.maximum(idx[:, j], 0)], p)
    return p, idx[:, 0] >= 0


def mp_model(dec, probs: np.ndarray, change: str | None = None
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``qra_mp``'s arithmetic in NumPy float32: (hard [B, n] int64, ok
    [B] bool, conf [B] float32) of probs [B, n, 64] for the code and
    iterations of ``dec`` (a ``qra.QaryMPDecoder``); with ``change`` (one
    of ``CHANGES``) that step changed."""
    if change is not None and change not in CHANGES:
        raise ValueError(f"change {change!r}: one of {CHANGES}")
    g = edge_tables(dec)
    probs = np.asarray(probs, F32)
    bsz = probs.shape[0]
    n_e = g["e_var"].size
    m = np.full((bsz, n_e, 64), UNI, F32)    # check -> variable, var order
    chan = probs[:, g["e_var"]]
    ce = g["check_edges"]
    real = ce >= 0
    mr = ce.shape[1]

    for _ in range(dec.iters):
        # variables: the other messages, the channel, the padding scale,
        # the underflow test, the clamp; permuted, transformed, normalised
        if change == "division":
            ve = g["var_edges"]
            pall = None
            for j in range(ve.shape[1]):
                y = np.where((ve[:, j] >= 0)[None, :, None],
                             m[:, np.maximum(ve[:, j], 0)], UNI)
                pall = y if pall is None else pall * y
            x = _clamp(chan * pall[:, g["e_var"]] / (m + TINY))
        else:
            p, some = _products(m, g["others"])
            x = np.where(some[None, :, None], chan * p, chan)
            if change != "no padding scale":
                x = x * g["scale"][None, :, None]
            if change != "no underflow zero":
                x = np.where(x * m == 0, F32(0), x)
            x = _clamp(x)
        w = wht_butterfly(np.take_along_axis(x, g["fwd"][None], axis=-1))
        if change == "divide, not reciprocal":
            w = w / (w[..., :1] + TINY)
        else:
            w = w * (F32(1) / (w[..., :1] + TINY))
        # checks: leave-one-out products, inverse transform, / 64, clamp
        ws = w[:, np.maximum(ce, 0)]                     # [B, nc, mr, 64]
        loo = np.empty_like(ws)
        pre = np.ones((bsz, ce.shape[0], 64), F32)
        for s in range(mr):
            loo[:, :, s] = pre
            pre = np.where(real[None, :, s, None], pre * ws[:, :, s], pre)
        suf = np.ones_like(pre)
        for s in range(mr - 1, -1, -1):
            r = real[None, :, s, None]
            loo[:, :, s] = np.where(r, loo[:, :, s] * suf, loo[:, :, s])
            suf = np.where(r, suf * ws[:, :, s], suf)
        q = _clamp(wht_butterfly(loo) / F32(64.0))
        if change == "renormalise checks":
            q = q / (warp_sum64(q) + TINY)
        m = np.take_along_axis(q[:, real], g["bwd"][None], axis=-1)

    return posterior_flags(dec, probs, m, g)


def posterior_flags(dec, probs: np.ndarray, m: np.ndarray, g: dict
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hard, ok, conf) from the check-to-variable messages m [B, E, 64]
    (variable order): the posterior, the channel row times the messages in
    column order, normalised by its warp sum; its NaN-first argmax and
    maximum; the GF(64) syndrome; the mean of the maxima."""
    t = dec._host_tables()
    n = dec.code.n
    bsz = probs.shape[0]
    p, some = _products(m, g["var_edges"])
    tot = np.where(some[None, :, None], probs * p, probs)
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
    h_vars = t["h_vars"].astype(np.int64)
    mul = t["gf_mul"]
    sym = np.concatenate([hard, np.zeros((bsz, 1), np.int64)], 1)[:, h_vars]
    prod = np.where((h_vars < n)[None], mul[sym, t["h_coeff"][None]], 0)
    ok = ~np.bitwise_xor.reduce(prod, axis=2).any(axis=1)
    return hard.astype(np.int64), ok, conf.astype(F32)
