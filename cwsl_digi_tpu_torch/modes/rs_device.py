"""Batched Reed-Solomon errors-and-erasures decoding on the device
(PyTorch).

Counterpart of ``cwsl_digi_tpu/modes/rs_device.py``: one call decodes
every (sync candidate x erasure pattern) trial of a JT65 decode in
parallel, then scores each corrected word against the demodulated tone
energies and keeps the best accepted trial per candidate.

- GF(2^6) over x^6+x+1 (0x43).  The reference multiplies carry-less (the
  TPU serializes gathers from tiny tables); here a product is one gather
  from the 64x64 multiplication table, built once from the same
  carry-less product, so every result is the same integer.
- On CUDA tensors the decode is one launch of the ``rs_ee`` kernel
  (``csrc/weak.cu``, a warp a trial).  Its plain version
  (:func:`rs_ee_decode_plain`, on CPU tensors) is masked and never
  branches on the data: Berlekamp-Massey runs all 2t rounds with
  per-trial active masks, and the reference's ``fori_loop`` s are Python
  loops of batched ops.
- Validity is "the corrected word's syndromes are all zero".
- The stochastic erasure patterns are the reference's own draws
  (``modes/threefry.py``), so the trial set, and with it the decode list,
  is the reference's: the flags are bit for bit the JAX package's ``u <
  p``, with p's weights, depths and row sum computed as its compiled
  program computes them (:func:`chase_base_p`, :func:`chase_depth`,
  :func:`windowed_row_sum`).
- On CUDA tensors the Chase program's other stages are hand kernels too
  (``csrc/chase.cu``, ``_chase_kernels``): the erasure flags
  (:func:`chase_erasures`) and the soft score with the best trial
  (:func:`chase_score`), so a chunk is three launches and no host sync;
  their plain versions (:func:`chase_erasures_plain`,
  :func:`chase_score_plain`) run on CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.convert import tables_to_torch
from cwsl_digi_tpu_torch.modes import (_chase_kernels, _weak_kernels,
                                       threefry)

PRIM_POLY = 0x43      # x^6 + x + 1
GF_M = 6
GF_Q = 64

# trials per rs_ee_trials call at most (bounds the plain version's [M, n]
# int64 temporaries and the soft score's [C, T, n, 4] ones)
TRIALS_PER_CALL = 1 << 18


@functools.lru_cache(maxsize=1)
def gf_tables() -> tuple[np.ndarray, np.ndarray]:
    """(mul [64, 64], inv [64]) int64: the carry-less product reduced by
    the primitive polynomial, and a^62 (inv(0) = 0), as the reference's
    ``gmul``/``ginv`` compute them."""
    a = np.arange(GF_Q, dtype=np.int64)[:, None]
    b = np.arange(GF_Q, dtype=np.int64)[None, :]
    r = np.zeros((GF_Q, GF_Q), np.int64)
    for j in range(GF_M):
        r ^= np.where((b >> j) & 1 == 1, a << j, 0)
    for j in range(2 * GF_M - 2, GF_M - 1, -1):
        r ^= np.where((r >> j) & 1 == 1, PRIM_POLY << (j - GF_M), 0)
    inv = np.zeros(GF_Q, np.int64)
    for x in range(1, GF_Q):
        inv[x] = int(np.nonzero(r[x] == 1)[0][0])
    return r, inv


@functools.lru_cache(maxsize=None)
def _gf_device(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    mul, inv = gf_tables()
    t = tables_to_torch({"gf_mul": mul, "gf_inv": inv}, device)
    return t["gf_mul"].reshape(-1), t["gf_inv"]


def gmul(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise GF(64) multiply of int64 tensors (values 0..63)."""
    mul, _ = _gf_device(a.device)
    return torch.take(mul, (a << GF_M) | b)


def ginv(a: torch.Tensor) -> torch.Tensor:
    """GF(64) inverse (inv(0) returns 0)."""
    _, inv = _gf_device(a.device)
    return inv[a]


@functools.lru_cache(maxsize=None)
def _tables(n: int, nroots: int, fcr: int):
    """NumPy constant tables: alpha powers for syndromes and Chien."""
    exp = np.zeros(2 * GF_Q, np.int32)
    x = 1
    for i in range(GF_Q - 1):
        exp[i] = x
        x <<= 1
        if x & GF_Q:
            x ^= PRIM_POLY
    for i in range(GF_Q - 1, 2 * GF_Q):
        exp[i] = exp[i - (GF_Q - 1)]

    def apow(e: int) -> int:
        return int(exp[e % (GF_Q - 1)])

    # Position index i carries the x^(n-1-i) coefficient (rs64.py layout:
    # word[0] is the HIGHEST degree — systematic info rides the top powers)
    deg = [n - 1 - i for i in range(n)]
    # syndrome matrix: S_j = sum_i r_i alpha^{deg_i (fcr+j)}
    syn = np.zeros((nroots, n), np.int32)
    for j in range(nroots):
        for i in range(n):
            syn[j, i] = apow(deg[i] * (fcr + j))
    # position powers: X_i = alpha^{deg_i}; inverses for Chien/Forney
    xi = np.asarray([apow(d) for d in deg], np.int32)
    xi_inv = np.asarray([apow(-d % (GF_Q - 1)) for d in deg], np.int32)
    # Chien: CH[d, i] = (X_i^{-1})^d, d = 0..nroots (locator degree)
    ch = np.zeros((nroots + 1, n), np.int32)
    for dd in range(nroots + 1):
        for i in range(n):
            ch[dd, i] = apow((-deg[i] * dd) % (GF_Q - 1))
    # X_i^{1-fcr} factor for Forney
    xfcr = np.asarray([apow((d * (1 - fcr)) % (GF_Q - 1)) for d in deg],
                      np.int32)
    return syn, xi, xi_inv, ch, xfcr


RS_TABLES = ("rs_syn", "rs_xi", "rs_xi_inv", "rs_ch", "rs_xfcr")


def host_tables(n: int, nroots: int, fcr: int) -> dict[str, np.ndarray]:
    """The RS tables by name (see ``convert.py``)."""
    return dict(zip(RS_TABLES, _tables(n, nroots, fcr)))


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, nroots: int, fcr: int, device: torch.device):
    t = tables_to_torch(host_tables(n, nroots, fcr), device)
    return tuple(t[name].to(torch.int64) for name in RS_TABLES)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (exact in any order), by halving."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] ^ x[..., h : 2 * h]
        if x.shape[-1] % 2:
            y = torch.cat([y[..., :1] ^ x[..., -1:], y[..., 1:]], dim=-1)
        x = y
    return x[..., 0]


def kernel_tables(n: int, nroots: int, fcr: int) -> np.ndarray:
    """The ``rs_ee`` kernel's table block, uint8 [4416]: the product table
    [64, 64], the inverses [64], then X_i, X_i^-1 and X_i^(1-fcr) of each
    position and alpha^(fcr+j) of each syndrome, each padded to 64."""
    mul, inv = gf_tables()
    syn, xi, xi_inv, _ch, xfcr = _tables(n, nroots, fcr)
    cols = [xi, xi_inv, xfcr, syn[:, n - 2]]     # position n-2 has degree 1
    out = [mul.reshape(-1), inv]
    out += [np.pad(c, (0, GF_Q - len(c))) for c in cols]
    return np.concatenate(out).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _kernel_tables_cached(n: int, nroots: int, fcr: int,
                          device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_tables(n, nroots, fcr)).to(device)


def kernel_tables_device(nk_fcr: tuple, device: torch.device | str
                         ) -> torch.Tensor:
    """The ``rs_ee`` kernel's table block on ``device``, copied there on
    the first call for this code and device and cached.  The copy is a
    host-to-device transfer: call this before capturing
    :func:`rs_ee_trials` in a CUDA graph (``QaryDecoder`` does so when it
    is built on a card)."""
    n, k, fcr = nk_fcr
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _kernel_tables_cached(n, n - k, fcr, device)


def rs_ee_decode(nk_fcr: tuple, recv: torch.Tensor, era: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched errors-and-erasures RS decode.

    nk_fcr = (n, k, fcr); recv [M, n] int64 received symbols; era [M, n]
    bool erasure flags.  Returns (corrected [M, n] int64, ok [M]): ok =
    the corrected word has all-zero syndromes.  On CUDA tensors one launch
    of the ``rs_ee`` kernel (``_weak_kernels``; it raises where the kernel
    cannot run), on CPU tensors :func:`rs_ee_decode_plain`.
    """
    if recv.device.type == "cpu":
        return rs_ee_decode_plain(nk_fcr, recv, era)
    m, n = recv.shape
    corrected, ok = rs_ee_trials(nk_fcr, recv, era.reshape(m, 1, n))
    return corrected.reshape(m, n).to(torch.int64), ok.reshape(m)


def rs_ee_trials(nk_fcr: tuple, syms: torch.Tensor, era: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Chase program's trials: trial (c, t) decodes syms [c] ([C, n]
    int64) with the erasure flags era [c, t] ([C, T, n] bool).  Returns
    (corrected [C, T, n] uint8, ok [C, T]).  On CUDA tensors one launch of
    the ``rs_ee`` kernel, which reads each candidate's row for its trials
    (the [C T, n] int64 expansion is never built), with no host sync once
    :func:`kernel_tables_device` has run for this code and device; on CPU
    tensors :func:`rs_ee_trials_plain`."""
    if syms.device.type == "cpu":
        return rs_ee_trials_plain(nk_fcr, syms, era)
    n, k, _fcr = nk_fcr
    return _weak_kernels.rs_ee(kernel_tables_device(nk_fcr, syms.device),
                               syms.contiguous(), era.contiguous(), n - k)


def rs_ee_trials_plain(nk_fcr: tuple, syms: torch.Tensor, era: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rs_ee_trials` through :func:`rs_ee_decode_plain` on the
    expanded words."""
    c, t, n = era.shape
    recv = syms[:, None, :].expand(c, t, n).reshape(-1, n)
    corrected, ok = rs_ee_decode_plain(nk_fcr, recv, era.reshape(-1, n))
    return corrected.reshape(c, t, n).to(torch.uint8), ok.reshape(c, t)


def rs_ee_decode_plain(nk_fcr: tuple, recv: torch.Tensor, era: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rs_ee_decode` in plain PyTorch: the reference's loops of
    batched GF(64) steps over [M, n] int64 tensors."""
    n, k, fcr = nk_fcr
    nroots = n - k
    dev = recv.device
    syn_t, xi_d, _xi_inv, ch_d, xfcr = _device_tables(n, nroots, fcr, dev)
    m = recv.shape[0]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    def syndromes(word):
        s = zeros(m, nroots)
        for i in range(n):
            s = s ^ gmul(word[:, i : i + 1], syn_t[:, i][None, :])
        return s

    s = syndromes(recv)

    # --- erasure locator Gamma(x) = prod_{era} (1 + X_l x) ----------------
    lam = zeros(m, nroots + 1)
    lam[:, 0] = 1
    for i in range(n):
        shifted = torch.cat([zeros(m, 1), gmul(lam[:, :-1], xi_d[i])], dim=1)
        lam = torch.where(era[:, i : i + 1], lam ^ shifted, lam)
    no_eras = era.sum(dim=1)                                 # [M]

    # --- Berlekamp-Massey with erasures (Karn decode_rs recursion) --------
    lam_len = nroots + 1
    s_pad = torch.cat([zeros(m, lam_len), s], dim=1)
    b, el = lam, no_eras
    for r in range(1, nroots + 1):
        active = r > no_eras                                 # [M]
        # discrepancy = sum_i lam[i] * S[r-1-i]
        d = _xor_reduce(gmul(lam.flip(1), s_pad[:, r : r + lam_len]))
        d_nz = (d != 0) & active
        b_shift = torch.cat([zeros(m, 1), b[:, :-1]], dim=1)
        t = lam ^ gmul(d[:, None], b_shift)
        deg_cond = d_nz & (2 * el <= (r - 1) + no_eras)
        b_new = torch.where(deg_cond[:, None], gmul(lam, ginv(d)[:, None]),
                            b_shift)
        el = torch.where(deg_cond, r + no_eras - el, el)
        lam = torch.where(active[:, None], t, lam)
        b = torch.where(active[:, None], b_new, b)

    # --- Chien search + Omega + Forney, one degree-indexed loop each ------
    ev = zeros(m, n)
    for d in range(nroots + 1):
        ev = ev ^ gmul(lam[:, d : d + 1], ch_d[d][None, :])
    is_err = ev == 0                                         # [M, n]

    # Omega = S * Lambda mod x^nroots: omega_j ^= lam_d * S_{j-d}
    s_lpad = torch.cat([zeros(m, nroots), s], dim=1)
    omega = zeros(m, nroots)
    for d in range(nroots + 1):
        omega = omega ^ gmul(lam[:, d : d + 1],
                             s_lpad[:, nroots - d : 2 * nroots - d])

    # Omega(X_i^{-1}) and Lambda'(X_i^{-1}); derivative keeps odd degrees
    om_ev = zeros(m, n)
    for d in range(nroots):
        om_ev = om_ev ^ gmul(omega[:, d : d + 1], ch_d[d][None, :])
    dlam_ev = zeros(m, n)
    for j in range((nroots + 1) // 2):
        d = 2 * j + 1
        dlam_ev = dlam_ev ^ gmul(lam[:, d : d + 1], ch_d[d - 1][None, :])
    mag = gmul(gmul(om_ev, ginv(dlam_ev)), xfcr[None, :])
    corrected = recv ^ torch.where(is_err, mag, 0)

    # --- membership check: corrected syndromes must vanish ----------------
    ok = (syndromes(corrected) == 0).all(dim=1)
    return corrected, ok


# deterministic erasure tiers (the reference's host ERASURE_SCHEDULE) + the
# stochastic Chase tiers' target erasure depths
DET_TIERS = (0, 8, 16, 24, 32, 40)
# the window of the erasure probabilities' row sum: the JAX package's
# program (XLA on the CPU) sums a row of more than 32 in windows of 32, each
# from its first value on, then the windows' sums in order
SUM_WINDOW = 32


def chase_depth(nroots: int, n_sto: int) -> np.ndarray:
    """The stochastic trials' target erasure depths, float32 [n_sto]:
    ``jnp.linspace(nroots - 14, nroots - 2, n_sto)`` as the JAX package's
    compiled program computes it, start * (1 - i * inv) + i * (stop * inv)
    with inv = 1 / (n_sto - 1) in float32, the last value exactly stop."""
    f32 = np.float32
    start, stop = f32(nroots - 14.0), f32(nroots - 2.0)
    if n_sto == 1:
        return np.asarray([start], np.float32)
    inv = f32(1.0) / f32(n_sto - 1)
    i = np.arange(n_sto - 1, dtype=np.float32)
    head = start * (f32(1.0) - i * inv) + i * (stop * inv)
    return np.append(head, stop).astype(np.float32)


def chase_base_p(n: int) -> np.ndarray:
    """Each confidence rank's erasure weight, float32 [n]: 0.9 - 0.8 r / (n
    - 1) as the JAX package's compiled program computes it, one fused
    multiply-add of r and the folded constant 0.8 / (n - 1) (exact here in
    float64: r has 6 bits and the constant 24)."""
    c = np.float32(np.float32(0.8) / np.float32(n - 1))
    r = np.arange(n, dtype=np.float64)
    return (np.float64(np.float32(0.9)) - r * np.float64(c)).astype(
        np.float32)


def windowed_row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis in :data:`SUM_WINDOW` order: each window
    of 32 added from its first value on, then the windows' sums in order
    (sequential float32 adds, so the result is the same on every
    device)."""
    total = None
    for w0 in range(0, x.shape[-1], SUM_WINDOW):
        acc = x[..., w0]
        for i in range(w0 + 1, min(x.shape[-1], w0 + SUM_WINDOW)):
            acc = acc + x[..., i]
        total = acc if total is None else total + acc
    return total


@functools.lru_cache(maxsize=None)
def _chase_tables_cached(n: int, nroots: int, n_sto: int,
                         device: torch.device
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(chase_base_p(n)).to(device),
            torch.from_numpy(chase_depth(nroots, n_sto)).to(device))


def chase_tables_device(n: int, nroots: int, n_sto: int,
                        device: torch.device | str
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(:func:`chase_base_p`, :func:`chase_depth`) on ``device``, copied
    there on the first call for these sizes and cached (call it before
    capturing the Chase program in a CUDA graph; ``QaryDecoder`` does so
    when it is built on a card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _chase_tables_cached(n, nroots, n_sto, device)


def confidence_rank(margin: torch.Tensor) -> torch.Tensor:
    """Each symbol's confidence rank in its row (0 = least confident): the
    position in a stable ascending sort of ``margin`` [C, n] (NaN last,
    equal margins in position order)."""
    c, n = margin.shape
    order = torch.argsort(margin, dim=1, stable=True)
    return torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=margin.device).expand(c, n)
        .contiguous())


def chase_erasures_plain(nroots: int, n_trials: int, n_det: int,
                         margin: torch.Tensor, seed, c0: int = 0
                         ) -> torch.Tensor:
    """:func:`chase_erasures` in plain PyTorch."""
    c, n = margin.shape
    dev = margin.device
    rank = confidence_rank(margin)
    det = (torch.stack([rank < f for f in DET_TIERS[:n_det]], dim=1)
           if n_det else torch.zeros((c, 0, n), dtype=torch.bool, device=dev))
    n_sto = n_trials - n_det
    base_p, depth = chase_tables_device(n, nroots, n_sto, dev)
    p = base_p[rank]                                         # [C, n]
    ratio = depth[None, :] / windowed_row_sum(p)[:, None]    # [C, n_sto]
    key = threefry.fold_in(threefry.prng_key(17, dev), seed)
    u = threefry.uniform(key, (c, n_sto, n), offset=c0 * n_sto * n)
    return torch.cat([det, u < p[:, None, :] * ratio[:, :, None]], dim=1)


def chase_erasures(nroots: int, n_trials: int, n_det: int,
                   margin: torch.Tensor, seed, c0: int = 0) -> torch.Tensor:
    """The Chase trials' erasure flags era [C, T, n] bool of candidates
    c0 .. c0 + C of a batch, from their per-symbol confidences margin [C,
    n] float32 and ``seed`` (a 0-dim integer tensor, or an int; its low 32
    bits are folded in).  Trials 0 .. n_det - 1 erase the ``DET_TIERS``
    least confident symbols; trial n_det + s erases symbol i where u < p:
    u the uniform of element (c0 + c, s, i) of the JAX package's one
    ``jax.random.uniform(fold_in(PRNGKey(17), seed), (C_all, n_sto, n))``
    draw, p = base_p[rank] x (depth[s] / the row's windowed sum of
    base_p[rank]), bit for bit the JAX package's ``u < p``.  On a CUDA
    tensor one launch of the ``chase_erasures`` kernel (``_chase_kernels``;
    the seed stays on the card), on a CPU tensor
    :func:`chase_erasures_plain`."""
    if margin.device.type == "cpu":
        return chase_erasures_plain(nroots, n_trials, n_det, margin, seed,
                                    c0)
    base_p, depth = chase_tables_device(margin.shape[1], nroots,
                                        n_trials - n_det, margin.device)
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(seed, dtype=torch.int64, device=margin.device)
    return _chase_kernels.chase_erasures(
        margin.contiguous(), seed.to(torch.int64), base_p, depth,
        DET_TIERS[:n_det], n_trials, c0)


def chase_trial_scores_plain(accept: float, corrected: torch.Tensor,
                             ok: torch.Tensor, era: torch.Tensor,
                             top_e: torch.Tensor, top_tone: torch.Tensor,
                             e_sum: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every trial's soft score [C, T] (-inf where it fails) and whether it
    passes [C, T]: the reference's vectorized score over [C, T, n, 4]
    hits."""
    n = corrected.shape[2]
    # soft re-encode score (the reference's host _soft_score, vectorized):
    # mean log(E[cw tone] / mean symbol energy), top-4 else residual floor
    hit = corrected[:, :, :, None] == top_tone[:, None, :, :]
    e_top = torch.where(hit, top_e[:, None], 0.0).sum(dim=-1)
    floor = (e_sum - top_e.sum(dim=-1)) / (GF_Q - 4)
    e_cw = torch.where(hit.any(dim=-1), e_top, floor[:, None, :])
    mean_e = (e_sum / n)[:, None, :]
    logr = torch.log((e_cw + 1e-30) / (mean_e + 1e-30))      # [C, T, n]
    score = logr.mean(dim=-1)
    # erased positions are the independent verification: a true codeword
    # still carries signal energy there, a noise-forced one scores ~0 (see
    # the reference)
    n_era = era.sum(dim=-1).to(torch.float32)                # [C, T]
    s_era = (logr * era).sum(dim=-1) / n_era.clamp(min=1.0)
    ok = ok & ((n_era < 8) | (s_era >= 0.6 * accept))
    return torch.where(ok, score, -torch.inf), ok


def chase_score_plain(k: int, accept: float, corrected: torch.Tensor,
                      ok: torch.Tensor, era: torch.Tensor,
                      top_e: torch.Tensor, top_tone: torch.Tensor,
                      e_sum: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`chase_score` in plain PyTorch: the trials' scores
    (:func:`chase_trial_scores_plain`) and ``argmax``."""
    score, ok = chase_trial_scores_plain(accept, corrected, ok, era, top_e,
                                         top_tone, e_sum)
    best = score.argmax(dim=1)                               # [C]
    bidx = torch.arange(corrected.shape[0], device=corrected.device)
    best_score = score[bidx, best]
    info = corrected[bidx, best, :k].to(torch.int64)
    # the all-zero word is a codeword of every RS code and wins on dead
    # air; require real content
    best_ok = (ok[bidx, best] & (best_score >= accept)
               & (info != 0).any(dim=1))
    return info, best_score, best_ok


def chase_score(k: int, accept: float, corrected: torch.Tensor,
                ok: torch.Tensor, era: torch.Tensor, top_e: torch.Tensor,
                top_tone: torch.Tensor, e_sum: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The soft re-encode score of every decoded trial and the best trial
    of each candidate: corrected [C, T, n] uint8 and ok [C, T] bool (the
    RS decode's), era [C, T, n] bool, top_e [C, n, 4] float32, top_tone [C,
    n, 4] int64, e_sum [C, n] float32.  A trial's score is the mean over
    the symbols of log((E + 1e-30) / (e_sum / n + 1e-30)), E the top-4
    energy of the corrected tone, else the residual floor (e_sum - the
    top-4 sum) / 60; a trial with 8 or more erasures also needs the mean of
    its erased symbols' terms >= 0.6 ``accept``.  Returns (info [C, k]
    int64, best_score [C] float32, best_ok [C] bool): the best passing
    trial (the lowest index on ties), its score (-inf where none passes)
    and whether it reaches ``accept`` with an info word not all zero.  On
    CUDA tensors one launch of the ``chase_score`` kernel
    (``_chase_kernels``), on CPU tensors :func:`chase_score_plain`."""
    if corrected.device.type == "cpu":
        return chase_score_plain(k, accept, corrected, ok, era, top_e,
                                 top_tone, e_sum)
    return _chase_kernels.chase_score(
        corrected.contiguous(), ok.contiguous(), era.contiguous(),
        top_e.contiguous(), top_tone.contiguous(), e_sum.contiguous(), k,
        accept)[:3]


def rs_chase_program(nk_fcr: tuple, n_trials: int, n_det: int,
                     accept: float, syms: torch.Tensor, margin: torch.Tensor,
                     top_e: torch.Tensor, top_tone: torch.Tensor,
                     e_sum: torch.Tensor, seed
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chase trial fan-out + decode + soft accept for a candidate batch.

    syms [C, n] int64 (codeword-domain), margin [C, n] float32 (per-symbol
    confidence), top_e [C, n, 4] / top_tone [C, n, 4] / e_sum [C, n] from
    the demod stage; ``seed`` a 0-dim integer tensor (or int) folded into
    the key of the stochastic patterns.  Returns (info [C, k], score [C],
    ok [C]): the best accepted trial per candidate.  Candidates are
    decoded in chunks of at most ``TRIALS_PER_CALL`` trials, each three
    stages (:func:`chase_erasures`, :func:`rs_ee_trials`,
    :func:`chase_score`; on a card three kernel launches, no host sync);
    each chunk draws its slice of the reference's one ``[C, n_sto, n]``
    draw.
    """
    n, k, _fcr = nk_fcr
    c = syms.shape[0]
    chunk = max(1, TRIALS_PER_CALL // n_trials)
    infos, scores, oks = [], [], []
    for c0 in range(0, c, chunk):
        sl = slice(c0, min(c, c0 + chunk))
        era = chase_erasures(n - k, n_trials, n_det, margin[sl], seed, c0)
        corrected, ok = rs_ee_trials(nk_fcr, syms[sl], era)  # uint8 words
        info, score, best_ok = chase_score(k, accept, corrected, ok, era,
                                           top_e[sl], top_tone[sl],
                                           e_sum[sl])
        infos.append(info)
        scores.append(score)
        oks.append(best_ok)
    return torch.cat(infos), torch.cat(scores), torch.cat(oks)
