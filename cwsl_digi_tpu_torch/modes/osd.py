"""Ordered-statistics decoding (OSD): the deep-decode fallback after BP.

Counterpart of ``cwsl_digi_tpu/modes/osd.py``: re-derive the codeword from
the k most reliable independent positions, then try a fixed set of
low-weight flip patterns over the least reliable of them and keep the
codeword at minimum soft distance.  Batched over words:

- one stable ``argsort`` of |LLR| per word (ties keep index order, as
  ``jnp.argsort`` does, so the basis matches the reference's);
- GF(2) elimination of the reliability-permuted generator, bit-packed 32
  columns to a word, all words advancing one column per step;
- the flip patterns re-encoded as one ``[T, k] @ [k, n]`` product per word,
  and the soft-distance arg-min.

That is :func:`osd_decode_plain`.  :func:`osd_decode` runs it on CPU
tensors; on a CUDA tensor it launches the hand kernel ``osd``
(``csrc/ldpc.cu``, one warp per word), which takes the flip patterns as
index lists (:func:`pattern_index_lists`, built once beside the pattern
table) and the generator as column masks (``_kernels.generator_columns``,
built on its first call).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from cwsl_digi_tpu_torch.modes import _kernels


@functools.lru_cache(maxsize=None)
def flip_patterns(k: int, n_singles: int, tail2: int, tail3: int) -> np.ndarray:
    """Static flip-pattern table [T, k] over basis coordinates (coordinate
    0 = most reliable): the zero pattern, single flips over the
    ``n_singles`` least reliable positions, pairs over the last ``tail2``,
    triples over the last ``tail3``."""
    pats = [np.zeros(k, np.uint8)]
    for i in range(k - 1, max(k - 1 - n_singles, -1), -1):
        p = np.zeros(k, np.uint8)
        p[i] = 1
        pats.append(p)
    for i, j in itertools.combinations(range(k - tail2, k), 2):
        if i >= 0:
            p = np.zeros(k, np.uint8)
            p[i] = p[j] = 1
            pats.append(p)
    for tri in itertools.combinations(range(k - tail3, k), 3):
        if tri[0] >= 0:
            p = np.zeros(k, np.uint8)
            p[list(tri)] = 1
            pats.append(p)
    return np.stack(pats)


def pattern_index_lists(patterns: np.ndarray) -> np.ndarray:
    """A flip-pattern table [T, k] as the ``osd`` kernel takes it: [T, 3]
    int16, each pattern's flipped coordinates in increasing order, -1
    padded.  Raises on a pattern of more than 3 flips."""
    pats = np.asarray(patterns)
    weight = (pats != 0).sum(axis=1)
    if weight.max(initial=0) > _kernels.OSD_MAX_FLIPS:
        raise ValueError(f"a flip pattern of weight {weight.max()}: the OSD "
                         f"kernel takes at most {_kernels.OSD_MAX_FLIPS}")
    out = np.full((pats.shape[0], _kernels.OSD_MAX_FLIPS), -1, np.int16)
    for t, row in enumerate(pats):
        idx = np.flatnonzero(row)
        out[t, : idx.size] = idx
    return out


def osd_decode(gen: torch.Tensor, llrs: torch.Tensor, patterns: torch.Tensor,
               pattern_idx: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched OSD.

    gen [k, n] 0/1 generator, llrs [M, n] float32 (positive = bit 0),
    patterns [T, k] float32, pattern_idx the same patterns as
    :func:`pattern_index_lists` on ``llrs``' device.
    Returns (codewords [M, n] int8, soft distance [M], hard errors [M]).

    A CPU tensor runs :func:`osd_decode_plain`; any other launches the
    ``osd`` kernel on a contiguous copy of ``llrs`` (gen as uint8), which
    needs ``pattern_idx`` and raises if it cannot launch (no fallback)."""
    if llrs.device.type == "cpu":
        return osd_decode_plain(gen, llrs, patterns)
    if pattern_idx is None:
        raise ValueError("the OSD kernel takes the flip patterns as index "
                         "lists: pass pattern_idx (pattern_index_lists)")
    return _kernels.osd(gen, llrs.contiguous(), pattern_idx)


def osd_reduce_plain(gen: torch.Tensor, llrs: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reduction of :func:`osd_decode_plain`: each word's stable
    reliability order perm [M, n] (most reliable first), its permuted
    generator reduced to row echelon form by GF(2) elimination, as 0/1
    float32 rows gbits [M, k, n], and each row's basis coordinate (its
    first set bit, 0 for a zero row) basis [M, k]."""
    m_words, n = llrs.shape
    k = gen.shape[0]
    dev = llrs.device
    w = -(-n // 32)
    perm = torch.argsort(-llrs.abs(), dim=1, stable=True)      # [M, n]
    gperm = gen.to(torch.int64)[:, perm].permute(1, 0, 2)       # [M, k, n]
    # bit-pack: column c at bit (c & 31) of word (c >> 5)
    shift = torch.arange(32, device=dev, dtype=torch.int64)
    gpad = torch.nn.functional.pad(gperm, (0, w * 32 - n))
    gp = (gpad.reshape(m_words, k, w, 32) << shift).sum(-1)     # [M, k, w]

    rows = torch.arange(k, device=dev)
    r = torch.zeros(m_words, dtype=torch.int64, device=dev)
    ar = torch.arange(m_words, device=dev)
    for c in range(n):
        if c >= k and c % 8 == 0 and bool((r >= k).all()):
            break       # every word has its k pivots
        wi, bit = c >> 5, c & 31
        col = (gp[:, :, wi] >> bit) & 1                          # [M, k]
        cand = (col == 1) & (rows[None] >= r[:, None])
        has = cand.any(dim=1)
        p = cand.to(torch.int8).argmax(dim=1)                    # first pivot
        rc = r.clamp(max=k - 1)     # a finished word (r == k) has no pivot
        src = torch.where(rows[None] == rc[:, None], p[:, None],
                          torch.where(rows[None] == p[:, None], rc[:, None],
                                      rows[None]))
        swapped = torch.gather(gp, 1, src[:, :, None].expand(-1, -1, w))
        gp = torch.where(has[:, None, None], swapped, gp)
        pivot_row = gp[ar, rc]                                   # [M, w]
        col2 = (gp[:, :, wi] >> bit) & 1
        elim = (col2 == 1) & (rows[None] != r[:, None]) & has[:, None]
        gp = torch.where(elim[:, :, None], gp ^ pivot_row[:, None, :], gp)
        r = r + has.to(torch.int64)
    # unpack to [M, k, n] 0/1; a row's pivot column is its first set bit
    gbits = ((gp[:, :, :, None] >> shift) & 1).reshape(m_words, k, w * 32)
    gbits = gbits[:, :, :n].to(torch.float32)
    basis = gbits.argmax(dim=2)                                  # [M, k]
    return perm, gbits, basis


def osd_decode_plain(gen: torch.Tensor, llrs: torch.Tensor,
                     patterns: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`osd_decode` (on any device):
    the kernel's oracle.  gen may have any integer or float dtype."""
    m_words, n = llrs.shape
    dev = llrs.device
    ar = torch.arange(m_words, device=dev)
    perm, gbits, basis = osd_reduce_plain(gen, llrs)

    llr_p = torch.gather(llrs, 1, perm)
    y = (llr_p < 0).to(torch.float32)
    wts = llr_p.abs()
    d = torch.gather(y, 1, basis)                                # [M, k]
    cands = torch.remainder(d[:, None, :] + patterns[None], 2.0)  # [M, T, k]
    cw = torch.remainder(torch.bmm(cands, gbits), 2.0)           # [M, T, n]
    mism = (cw - y[:, None, :]).abs()
    dist = torch.bmm(mism, wts[:, :, None])[:, :, 0]             # [M, T]
    best = dist.argmin(dim=1)
    cw_best = cw[ar, best]
    out = torch.zeros(m_words, n, dtype=torch.int8, device=dev)
    out.scatter_(1, perm, cw_best.to(torch.int8))
    return out, dist[ar, best], mism[ar, best].sum(-1).to(torch.int32)
