"""Import published protocol tables from the files users actually have.

Counterpart of ``tools/import_tables.py`` on the port: the same parsers,
checks and emitted files, with the JS8 varicode alphabet taken from
``cwsl_digi_tpu_torch.modes.js8_varicode``, so a user of the port needs no
JAX package to install the published tables.  It reads the verbatim
formats of a WSJT-X / JS8Call source tree and writes the
``CWSL_DIGI_TPU_TABLES_DIR`` files that ``modes/tables_ext.py`` loads:

  upstream file                        emitted table
  -----------------------------------  ----------------------------
  ldpc_174_87_params.f90 (Nm/Mn data)  js8_ldpc_174_87.txt
  ldpc_240_101*.f90 (Nm/Mn data)       fst4_ldpc_240_101.txt
  varicode.cpp ({"char","bits"} pairs) js8_varicode.txt
  q65_qra_63_13.txt                    copied through

Usage (no device: the tool runs on the host)::

    python tools/torch_import_tables.py --src <file-or-source-tree> \
        --out $CWSL_DIGI_TPU_TABLES_DIR

Every import is validated (shape, 0/1 alphabet, Nm/Mn cross-consistency,
prefix-freeness) before anything is written; a malformed source raises
instead of emitting a plausible-but-wrong table.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# ---------------------------------------------------------------------------
# Fortran data-statement parsing
# ---------------------------------------------------------------------------

def _fortran_data_arrays(text: str) -> dict[str, list[int]]:
    """All ``data NAME/.../ `` integer blocks in a .f90 file, flattened in
    the order written (Fortran column-major for 2-D declarations)."""
    # strip comments, join continuation lines
    lines = []
    for line in text.splitlines():
        line = line.split("!", 1)[0]
        lines.append(line)
    joined = "\n".join(lines).replace("&", " ")
    out: dict[str, list[int]] = {}
    for m in re.finditer(r"data\s+(\w+)\s*/([^/]*)/", joined,
                         re.IGNORECASE | re.DOTALL):
        name = m.group(1).lower()
        vals = [int(t) for t in re.findall(r"-?\d+", m.group(2))]
        out[name] = out.get(name, []) + vals
    return out


def _fortran_dims(text: str, name: str) -> tuple[int, int] | None:
    """Declared dims of ``integer NAME(a,b)`` (comments stripped)."""
    clean = "\n".join(line.split("!", 1)[0] for line in text.splitlines())
    m = re.search(rf"\b{name}\s*\(\s*(\d+)\s*,\s*(\d+)\s*\)", clean,
                  re.IGNORECASE)
    return (int(m.group(1)), int(m.group(2))) if m else None


def parity_from_params_f90(text: str, n: int, k: int) -> np.ndarray:
    """Sparse H [n-checks rows? no: (n_checks, n)] from Nm/Mn data blocks.

    ``Nm`` lists each check's variable indices (1-based, zero-padded);
    ``Mn`` lists each bit's check indices.  Either alone suffices; when
    both parse, they must describe the same matrix.
    """
    n_checks = n - k
    arrays = _fortran_data_arrays(text)
    h_nm = h_mn = None
    if "nm" in arrays:
        vals = arrays["nm"]
        if len(vals) % n_checks:
            raise ValueError(
                f"Nm has {len(vals)} values, not a multiple of "
                f"{n_checks} checks")
        deg = len(vals) // n_checks
        dims = _fortran_dims(text, "Nm")
        if dims and dims not in ((deg, n_checks), (n_checks, deg)):
            raise ValueError(f"Nm declared {dims}, data implies "
                             f"({deg},{n_checks})")
        # Fortran data fills column-major: declaration Nm(deg, n_checks)
        # means consecutive ``deg`` values belong to one check (one column)
        if dims is None or dims == (deg, n_checks):
            mat = np.asarray(vals).reshape(n_checks, deg)
        else:                                 # declared Nm(n_checks, deg)
            mat = np.asarray(vals).reshape(deg, n_checks).T
        h_nm = np.zeros((n_checks, n), np.uint8)
        for c in range(n_checks):
            for v in mat[c]:
                if v == 0:
                    continue
                if not 1 <= v <= n:
                    raise ValueError(f"Nm check {c}: variable {v} out of "
                                     f"range 1..{n}")
                h_nm[c, v - 1] ^= 1
    if "mn" in arrays:
        vals = arrays["mn"]
        if len(vals) % n:
            raise ValueError(f"Mn has {len(vals)} values, not a multiple "
                             f"of {n} bits")
        deg = len(vals) // n
        dims = _fortran_dims(text, "Mn")
        if dims is None or dims == (deg, n):
            mat = np.asarray(vals).reshape(n, deg)
        else:                                 # declared Mn(n, deg)
            mat = np.asarray(vals).reshape(deg, n).T
        h_mn = np.zeros((n_checks, n), np.uint8)
        for b in range(n):
            for c in mat[b]:
                if c == 0:
                    continue
                if not 1 <= c <= n_checks:
                    raise ValueError(f"Mn bit {b}: check {c} out of range "
                                     f"1..{n_checks}")
                h_mn[c - 1, b] ^= 1
    if h_nm is None and h_mn is None:
        raise ValueError("no Nm or Mn data statement found")
    if h_nm is not None and h_mn is not None and not np.array_equal(
            h_nm, h_mn):
        raise ValueError("Nm and Mn describe different matrices — "
                         "corrupted source file?")
    return h_nm if h_nm is not None else h_mn


# ---------------------------------------------------------------------------
# js8call varicode.cpp huffman table
# ---------------------------------------------------------------------------

def varicode_from_cpp(text: str) -> dict[str, str]:
    """Extract the {"char", "bits"} huffman pairs from varicode.cpp."""
    pairs = re.findall(
        r'\{\s*"((?:\\.|[^"\\])+)"\s*,\s*"([01]+)"\s*\}', text)
    if not pairs:
        raise ValueError("no {\"char\",\"bits\"} huffman pairs found")
    from cwsl_digi_tpu_torch.modes.js8_varicode import EOT, validate_table

    table: dict[str, str] = {}
    for tok, bits in pairs:
        ch = tok.encode().decode("unicode_escape")
        if ch in ("\x04", "\u2666"):          # js8call's EOT diamond
            ch = EOT
        if len(ch) != 1:
            raise ValueError(f"non-single-char huffman token {tok!r}")
        table[ch.upper() if ch.isalpha() else ch] = bits
    if EOT not in table:
        raise ValueError(
            "huffman table has no EOT mark (\\x04): the JS8 text layer "
            "needs it to delimit frames — is this the right varicode.cpp?")
    validate_table(table)
    return table


def write_varicode(table: dict[str, str], out: Path) -> None:
    from cwsl_digi_tpu_torch.modes.js8_varicode import EOT

    lines = []
    for ch, bits in table.items():
        tok = {" ": "SP", EOT: "EOT", "#": "HASH"}.get(ch, ch)
        lines.append(f"{tok} {bits}")
    (out / "js8_varicode.txt").write_text("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _write_matrix(h: np.ndarray, path: Path) -> None:
    path.write_text(
        "\n".join(" ".join(str(int(v)) for v in row) for row in h) + "\n")


def import_file(path: Path, out: Path) -> list[str]:
    """Import one source file; returns the emitted table names."""
    text = path.read_text(errors="replace")
    name = path.name.lower()
    emitted = []
    if "174_87" in name and name.endswith((".f90", ".f")):
        h = parity_from_params_f90(text, 174, 87)
        _write_matrix(h, out / "js8_ldpc_174_87.txt")
        emitted.append("js8_ldpc_174_87.txt")
    elif "240_101" in name and name.endswith((".f90", ".f")):
        h = parity_from_params_f90(text, 240, 101)
        _write_matrix(h, out / "fst4_ldpc_240_101.txt")
        emitted.append("fst4_ldpc_240_101.txt")
    elif name == "varicode.cpp":
        write_varicode(varicode_from_cpp(text), out)
        emitted.append("js8_varicode.txt")
    elif name == "q65_qra_63_13.txt":
        (out / name).write_text(text)
        emitted.append(name)
    return emitted


def import_tree(src: Path, out: Path) -> list[str]:
    out.mkdir(parents=True, exist_ok=True)
    emitted: list[str] = []
    files = [src] if src.is_file() else sorted(src.rglob("*"))
    for p in files:
        if not p.is_file():
            continue
        try:
            got = import_file(p, out)
        except ValueError as e:
            print(f"  ! {p}: {e}", file=sys.stderr)
            continue
        if got:
            print(f"  {p} -> {', '.join(got)}")
            emitted += got
    return emitted


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="WSJT-X/JS8Call source tree (or a single file)")
    ap.add_argument("--out", required=True,
                    help="tables dir (point CWSL_DIGI_TPU_TABLES_DIR here)")
    args = ap.parse_args()
    emitted = import_tree(Path(args.src), Path(args.out))
    if not emitted:
        print("no importable table sources found "
              "(looked for ldpc_174_87*.f90, ldpc_240_101*.f90, "
              "varicode.cpp, q65_qra_63_13.txt)", file=sys.stderr)
        sys.exit(1)
    print(f"imported {len(emitted)} table(s) into {args.out}; "
          f"set CWSL_DIGI_TPU_TABLES_DIR={args.out}")


if __name__ == "__main__":
    main()
