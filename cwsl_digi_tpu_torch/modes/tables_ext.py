"""Runtime loader for user-supplied published protocol tables.

Three table sets could not be reconstructed bit-exactly from memory in
this zero-egress build environment and remain STAND-INS until a user
drops in the published file: ``js8_ldpc_174_87.txt``,
``fst4_ldpc_240_101.txt``, and ``q65_qra_63_13.txt`` (each IS fully
published; the per-mode headers cite where).  The JS8 huffman varicode
text layer additionally defaults to a best-recall table (modes/js8_varicode.py,
override ``js8_varicode.txt``).  The other rows below are EMBEDDED from
the published sources and their files act as cross-check overrides:

  =====================  =====================================  ==========
  file name              contents (E = embedded + override,     used by
                         S = stand-in until supplied)
  =====================  =====================================  ==========
  jt65_sync.txt          E  126 x 0/1 pseudo-random sync        modes/jt65
                         vector (WSJT-X lib/jt65_mod npr;
                         QEX 2005 — embedded in modes/jt65.py)
  js8_costas.txt         E  7 (or 3 rows of 7) Costas tones     modes/js8
                         (JS8 normal mode reuses FT8's Costas
                         array — embedded in modes/js8.py)
  js8_ldpc_174_87.txt    S  87 rows x 174 cols 0/1 parity H     modes/js8
                         (WSJT-X 1.8 lib/ft8/ldpc_174_87*)
  fst4_ldpc_240_101.txt  S  139 rows x 240 cols 0/1 H           modes/fst4
                         (WSJT-X lib/fst4/ldpc_240_101*)
  q65_qra_63_13.txt      S  50 rows x 63 cols GF(64) exponents  modes/q65
                         0..63 dense H (0 = absent; IV3NWV
                         qracodes qra15_65_64_irr_e23 family)
  =====================  =====================================  ==========

Every OTHER stage of those modes is the published algorithm, so dropping
the real table in makes the mode on-air compatible with no code change:
set ``CWSL_DIGI_TPU_TABLES_DIR`` to a directory containing any of the
files above (whitespace/comma-separated integers, ``#`` comments ignored)
and restart.  Each loader validates structural invariants before
accepting, and raises — rather than silently falling back — when a
supplied table is malformed, so a typo cannot masquerade as the stand-in.

The reference gets these tables by spawning WSJT-X/JS8Call binaries
(source/DecoderPool.hpp:634-676,846-867); a user with those programs
installed has the table sources on disk already.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np

ENV_VAR = "CWSL_DIGI_TPU_TABLES_DIR"


def tables_dir() -> Path | None:
    d = os.environ.get(ENV_VAR)
    return Path(d) if d else None


def _read_rows(name: str) -> list[list[int]] | None:
    d = tables_dir()
    if d is None:
        return None
    p = d / name
    if not p.is_file():
        return None
    rows: list[list[int]] = []
    for line in p.read_text().splitlines():
        line = line.split("#", 1)[0].replace(",", " ").strip()
        if line:
            rows.append([int(t) for t in line.split()])
    if not rows:
        raise ValueError(f"{p}: no data rows")
    return rows


def _load_flat(name: str, n: int) -> np.ndarray | None:
    rows = _read_rows(name)
    if rows is None:
        return None
    flat = [v for r in rows for v in r]
    if len(flat) != n:
        raise ValueError(f"{name}: expected {n} values, got {len(flat)}")
    return np.asarray(flat, np.int32)


def _load_matrix(name: str, shape: tuple[int, int]) -> np.ndarray | None:
    rows = _read_rows(name)
    if rows is None:
        return None
    m = np.asarray(rows, dtype=np.int64)
    if m.ndim != 2 or m.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {m.shape}")
    return m


@functools.lru_cache(maxsize=None)
def jt65_sync() -> np.ndarray | None:
    """The published 126-chip JT65 sync vector, or None."""
    v = _load_flat("jt65_sync.txt", 126)
    if v is None:
        return None
    if not set(np.unique(v)) <= {0, 1}:
        raise ValueError("jt65_sync.txt: values must be 0/1")
    if int(v.sum()) != 63:
        raise ValueError(
            f"jt65_sync.txt: the published vector has exactly 63 sync "
            f"chips (63 data slots remain for the RS(63,12) symbols); "
            f"got {int(v.sum())}")
    return v.astype(np.int32)


@functools.lru_cache(maxsize=None)
def js8_costas() -> np.ndarray | None:
    """JS8 normal-mode 7x7 Costas tone rows [3, 7], or None."""
    rows = _read_rows("js8_costas.txt")
    if rows is None:
        return None
    flat = [v for r in rows for v in r]
    if len(flat) == 7:
        flat = flat * 3
    if len(flat) != 21:
        raise ValueError("js8_costas.txt: expected 7 or 21 tone values")
    a = np.asarray(flat, np.int32).reshape(3, 7)
    if a.min() < 0 or a.max() > 7:
        raise ValueError("js8_costas.txt: tones must be 0..7")
    for r in a:
        if len(set(r.tolist())) != 7:
            raise ValueError("js8_costas.txt: each Costas row must be a "
                             "permutation-like set of 7 distinct tones")
    return a


def _validated_parity(name: str, n_checks: int, n: int) -> np.ndarray | None:
    h = _load_matrix(name, (n_checks, n))
    if h is None:
        return None
    if not set(np.unique(h)) <= {0, 1}:
        raise ValueError(f"{name}: H entries must be 0/1")
    from cwsl_digi_tpu_torch.modes.ldpc import gf2_row_reduce

    _, pivots = gf2_row_reduce(h)
    if len(pivots) != n_checks:
        raise ValueError(f"{name}: H must have full row rank {n_checks}")
    return h.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def js8_parity() -> np.ndarray | None:
    """JS8 LDPC(174,87) parity-check matrix, or None."""
    return _validated_parity("js8_ldpc_174_87.txt", 87, 174)


@functools.lru_cache(maxsize=None)
def fst4_parity() -> np.ndarray | None:
    """FST4/FST4W LDPC(240,101) parity-check matrix, or None."""
    return _validated_parity("fst4_ldpc_240_101.txt", 139, 240)


@functools.lru_cache(maxsize=None)
def js8_varicode() -> dict[str, str] | None:
    """JS8Call huffman codebook from ``js8_varicode.txt``, or None.

    One pair per line: ``<token> <bits>`` where ``SP`` is the space
    character, ``EOT`` the end-of-transmission mark, ``HASH`` the ``#``
    character (a bare ``#`` would read as a comment), anything else a
    literal single character.  Comment lines start with ``#``.
    Validated prefix-free before acceptance.
    """
    d = tables_dir()
    if d is None:
        return None
    p = d / "js8_varicode.txt"
    if not p.is_file():
        return None
    from cwsl_digi_tpu_torch.modes.js8_varicode import EOT, validate_table

    table: dict[str, str] = {}
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(f"js8_varicode.txt: bad line {line!r}")
        tok, bits = parts
        ch = {"SP": " ", "EOT": EOT, "HASH": "#"}.get(tok, tok)
        if len(ch) != 1:
            raise ValueError(f"js8_varicode.txt: bad token {tok!r}")
        table[ch.upper() if ch.isalpha() else ch] = bits
    validate_table(table)
    return table


@functools.lru_cache(maxsize=None)
def q65_qra() -> np.ndarray | None:
    """Q65 QRA(63,13) dense GF(64) H [50, 63] (0 = no edge), or None."""
    h = _load_matrix("q65_qra_63_13.txt", (50, 63))
    if h is None:
        return None
    if h.min() < 0 or h.max() > 63:
        raise ValueError("q65_qra_63_13.txt: entries must be GF(64) "
                         "elements 0..63")
    if np.any((h != 0).sum(axis=1) < 2):
        raise ValueError("q65_qra_63_13.txt: every check row needs >= 2 "
                         "variables")
    return h
