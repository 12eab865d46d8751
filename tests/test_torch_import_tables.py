"""``tools/torch_import_tables.py`` against ``tools/import_tables.py``.

The port's importer is the JAX tool's code with the JS8 varicode alphabet
taken from the port: below its own docstring it must equal the JAX tool
once the ``cwsl_digi_tpu.`` import prefix is rewritten, and on the same
small source tree (a synthesized ``varicode.cpp``, two LDPC parameter
files in Fortran data statements, a Q65 table) both must emit the same
files, byte for byte, and reject the same malformed file.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import import_tables as jtool  # noqa: E402  (the JAX tool)
import torch_import_tables as ptool  # noqa: E402
from cwsl_digi_tpu_torch.modes import js8_varicode  # noqa: E402


def _code(path: Path) -> str:
    """The module below its docstring."""
    return path.read_text().split('"""', 2)[2]


# (line of the JAX tool, line of the port's) that differ on purpose
DIFFERS = [("# driver", "# entry point")]    # a section header's wording


def test_code_equals_the_jax_tool():
    want = re.sub(r"\bcwsl_digi_tpu\.", "cwsl_digi_tpu_torch.",
                  _code(REPO / "tools" / "import_tables.py"))
    for orig, port in DIFFERS:
        assert f"\n{orig}\n" in want
        want = want.replace(f"\n{orig}\n", f"\n{port}\n")
    assert _code(REPO / "tools" / "torch_import_tables.py") == want


def _fortran(name: str, rows: np.ndarray) -> str:
    """``integer NAME(deg, n)`` and its data statement, 1-based, zero
    padded, continuation lines and a comment as upstream writes them."""
    n, deg = rows.shape
    vals = [str(int(v)) for v in rows.reshape(-1)]
    body = ", &\n    ".join(",".join(vals[i : i + 12])
                             for i in range(0, len(vals), 12))
    return (f"! generated parity table\ninteger {name}({deg},{n})\n"
            f"data {name}/{body}/\n")


def _nm(n: int, k: int, deg: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = np.zeros((n - k, deg), np.int64)
    for c in range(n - k):
        d = int(rng.integers(deg - 2, deg + 1))
        rows[c, :d] = np.sort(rng.choice(n, d, replace=False)) + 1
    return rows


def _mn(nm: np.ndarray, n: int) -> np.ndarray:
    per_bit = [[] for _ in range(n)]
    for c, row in enumerate(nm):
        for v in row[row > 0]:
            per_bit[v - 1].append(c + 1)
    deg = max(len(b) for b in per_bit)
    return np.asarray([b + [0] * (deg - len(b)) for b in per_bit], np.int64)


def _varicode_cpp(table: dict[str, str]) -> str:
    def tok(ch):
        if ch == js8_varicode.EOT:
            return "\\x04"
        return ch.replace("\\", "\\\\").replace('"', '\\"')

    pairs = ",\n    ".join(f'{{"{tok(c)}", "{b}"}}' for c, b in table.items())
    return f"QMap<QString, QString> hufftable = {{\n    {pairs}\n}};\n"


@pytest.fixture
def source_tree(tmp_path):
    src = tmp_path / "src"
    (src / "lib" / "ft8").mkdir(parents=True)
    (src / "lib" / "fst4").mkdir(parents=True)
    (src / "js8").mkdir()
    (src / "js8" / "varicode.cpp").write_text(
        _varicode_cpp(js8_varicode.default_table()))
    nm = _nm(174, 87, 7, seed=1)
    (src / "lib" / "ft8" / "ldpc_174_87_params.f90").write_text(
        _fortran("Nm", nm) + _fortran("Mn", _mn(nm, 174)))
    (src / "lib" / "fst4" / "ldpc_240_101_parity.f90").write_text(
        _fortran("Mn", _mn(_nm(240, 101, 6, seed=2), 240)))
    (src / "q65_qra_63_13.txt").write_text("1 0 3\n0 2 1\n")
    return src


def _outputs(directory: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())}


def test_same_files_for_the_same_source_tree(source_tree, tmp_path, capsys):
    want = jtool.import_tree(source_tree, tmp_path / "jax")
    got = ptool.import_tree(source_tree, tmp_path / "port")
    assert sorted(got) == sorted(want) == sorted([
        "js8_varicode.txt", "js8_ldpc_174_87.txt", "fst4_ldpc_240_101.txt",
        "q65_qra_63_13.txt"])
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")
    h = np.loadtxt(tmp_path / "port" / "js8_ldpc_174_87.txt")
    assert h.shape == (87, 174) and set(np.unique(h)) <= {0.0, 1.0}


def test_same_refusal_of_a_malformed_source(source_tree, tmp_path, capsys):
    """A varicode table whose codes are not prefix-free, and an Nm/Mn pair
    that disagree, are refused by both tools, and nothing is written."""
    table = dict(js8_varicode.default_table())
    first = next(iter(table))
    table[first] = table[js8_varicode.EOT] + "0"
    (source_tree / "js8" / "varicode.cpp").write_text(_varicode_cpp(table))
    f90 = source_tree / "lib" / "ft8" / "ldpc_174_87_params.f90"
    nm = _nm(174, 87, 7, seed=1)
    f90.write_text(_fortran("Nm", nm) + _fortran("Mn", _mn(
        _nm(174, 87, 7, seed=3), 174)))
    want = jtool.import_tree(source_tree, tmp_path / "jax")
    jerr = capsys.readouterr().err
    got = ptool.import_tree(source_tree, tmp_path / "port")
    perr = capsys.readouterr().err
    assert sorted(got) == sorted(want) == ["fst4_ldpc_240_101.txt",
                                           "q65_qra_63_13.txt"]
    assert perr.replace(str(tmp_path / "port"), "") == \
        jerr.replace(str(tmp_path / "jax"), "")
    assert "prefix-free" in perr and "different matrices" in perr
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")


def test_main_names_the_tables_dir(source_tree, tmp_path, capsys,
                                  monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "torch_import_tables.py", "--src", str(source_tree),
        "--out", str(tmp_path / "t")])
    ptool.main()
    out = capsys.readouterr().out
    assert f"imported 4 table(s) into {tmp_path / 't'}" in out
    assert f"CWSL_DIGI_TPU_TABLES_DIR={tmp_path / 't'}" in out
