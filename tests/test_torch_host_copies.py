"""The port's copies of the JAX package's host modules.

The port imports nothing of the JAX package, so it keeps its own copy of
every host module it needs.  Each copy must equal its original once the
``cwsl_digi_tpu.`` import prefix is rewritten to ``cwsl_digi_tpu_torch.``
(a citation of the reference's sources may leave out the directory that
held the reference tree); the few lines that differ on purpose are listed
below with their reason.
Then both packages' functions run on the same seeded inputs and must
agree field by field (the two packages' ``DecodeResult`` and ``Spot``
classes are different classes).
"""

from __future__ import annotations

import ast
import dataclasses
import difflib
import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

from cwsl_digi_tpu import config as jconfig
from cwsl_digi_tpu.modes import base as jbase
from cwsl_digi_tpu.modes import crc as jcrc
from cwsl_digi_tpu.modes import gfsk as jgfsk
from cwsl_digi_tpu.modes import js8_varicode as jvc
from cwsl_digi_tpu.modes import message77 as jm77
from cwsl_digi_tpu.modes import tables_ext as jtx
from cwsl_digi_tpu.modes import wspr as jwspr
from cwsl_digi_tpu.report import spot as jspot
from cwsl_digi_tpu_torch import config as pconfig
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import base as pbase
from cwsl_digi_tpu_torch.modes import crc as pcrc
from cwsl_digi_tpu_torch.modes import gfsk as pgfsk
from cwsl_digi_tpu_torch.modes import js8_varicode as pvc
from cwsl_digi_tpu_torch.modes import message77 as pm77
from cwsl_digi_tpu_torch.modes import tables_ext as ptx
from cwsl_digi_tpu_torch.modes import wspr as pwspr
from cwsl_digi_tpu_torch.report import spot as pspot

REPO = Path(__file__).resolve().parents[1]

COPIES = [
    "constants.py", "version.py", "config.py", "stats.py", "native.py",
    "modes/message77.py", "modes/tables.py", "modes/crc.py", "modes/gfsk.py",
    "modes/tables_ext.py", "modes/js8_varicode.py", "modes/legacy72.py",
    "modes/rs64.py", "modes/jt65.py", "modes/q65.py",
    "report/spot.py", "report/pskreporter.py", "report/rbn.py",
    "report/wsprnet.py", "report/jt9format.py", "runtime/scheduler.py",
    "runtime/decoderpool.py", "sdr/source.py", "sdr/shm.py",
    "utils/hamutils.py", "utils/logging.py", "utils/qos.py",
    "utils/timeutils.py", "utils/wav.py", "utils/stringutils.py",
    "dsp/ssbd.py", "parallel/cluster.py",
]

# module -> (lines only the original has, lines only the copy has, reason)
DIFFERS = {
    "runtime/decoderpool.py": (
        ["        audio = np.asarray(job.audio)   # device windows fetched on "
         "demand"],
        ["import torch",
         "        audio = job.audio   # device windows fetched on demand",
         "        audio = audio.cpu().numpy() if isinstance(audio, "
         "torch.Tensor) \\",
         "            else np.asarray(audio)"],
        "keepwav reads jobs whose audio is a CUDA tensor"),
    "parallel/cluster.py": (
        ["        audio = np.ascontiguousarray(job.audio, np.float32)"],
        ["import torch",
         "        audio = job.audio",
         "        if isinstance(audio, torch.Tensor):     # device windows to "
         "the host",
         "            audio = audio.cpu().numpy()",
         "        audio = np.ascontiguousarray(audio, np.float32)"],
        "the port's receiver hands the pool windows that are CUDA tensors, "
        "which NumPy cannot read"),
    "modes/jt65.py": (
        ["                 fmax_hz: float | None = None):",
         "                         symbol_perm=ILV, value_demap=UNGRAY)"],
        ["                 fmax_hz: float | None = None, device=None):",
         "                         symbol_perm=ILV, value_demap=UNGRAY, "
         "device=device)"],
        "the decoder takes the port's device argument"),
    "modes/q65.py": (
        ["@functools.lru_cache(maxsize=1)",
         "def _mp() -> QaryMPDecoder:",
         "    return QaryMPDecoder(_CODE, iters=60)",
         "                 fmax_hz: float | None = None):",
         "                         mp=_mp())"],
        ["from cwsl_digi_tpu_torch.device import as_device",
         "@functools.lru_cache(maxsize=None)",
         "def _mp(device) -> QaryMPDecoder:",
         "    return QaryMPDecoder(_CODE, iters=60, device=device)",
         "                 fmax_hz: float | None = None, device=None):",
         "                         mp=_mp(as_device(device)), device=device)"],
        "the decoder and its message-passing tables live on a device"),
}


def _cited(text: str) -> str:
    """Citations of the reference's sources by relative path: the
    directory that held the reference tree is left out on both sides."""
    return re.sub(r"/\w+/reference/", "", text)


def _rewritten(text: str) -> list[str]:
    return _cited(re.sub(r"\bcwsl_digi_tpu\.", "cwsl_digi_tpu_torch.",
                         text)).splitlines()


def _line_diff(orig: list[str], copy: list[str]
               ) -> tuple[list[str], list[str]]:
    """(lines only the original has, lines only the copy has)."""
    removed, added = [], []
    for line in difflib.unified_diff(orig, copy, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line[0] == "-" else added).append(line[1:])
    return removed, added


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_original(module):
    orig = _rewritten((REPO / "cwsl_digi_tpu" / module).read_text())
    copy = _cited((REPO / "cwsl_digi_tpu_torch" / module).read_text()
                  ).splitlines()
    want_removed, want_added, _reason = DIFFERS.get(module, ([], [], ""))
    assert _line_diff(orig, copy) == (want_removed, want_added)


# host code copied into modules that also hold ported device code:
# (module, object) -> (lines only the original has, lines only the copy
# has, reason)
HOST_PARTS = {
    ("modes/wspr.py", "WSPRConfig"): None,
    ("modes/wspr.py", "_drift_offsets"): None,
    ("modes/wspr.py", "WSPRDecoder.decode"): (
        ["    def decode(self, audio: np.ndarray) -> list[list[DecodeResult]]:",
         "        audio = np.asarray(audio, np.float32)"],
        ["    @on_device_lock",
         "    def decode(self, audio) -> list[list[DecodeResult]]:",
         "        if not isinstance(audio, torch.Tensor):",
         "            audio = np.asarray(audio, np.float32)"],
        "a tensor already on the decoder's device is taken as it is; one "
        "decode at a time runs on a device"),
    ("modes/qra.py", "_mul_table"): None,
    ("modes/qra.py", "gf_mul"): None,
    ("modes/qra.py", "gf_inv"): None,
    ("modes/qra.py", "_wht64"): None,
    ("modes/qra.py", "QRACode"): None,
    ("modes/qra.py", "_gf_solve"): None,
    ("modes/qra.py", "build_qra_code"): None,
    ("modes/qra.py", "code_from_dense"): None,
    ("modes/qary_engine.py", "QarySpec"): None,
    ("modes/rs_device.py", "_tables"): None,
}


def _module_object(package: str, module: str, name: str):
    mod = importlib.import_module(
        f"{package}.{module[:-3].replace('/', '.')}")
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("module,name", list(HOST_PARTS),
                         ids=[f"{m}:{n}" for m, n in HOST_PARTS])
def test_host_part_equals_original(module, name):
    """Each host function or class copied beside ported device code equals
    its original (import prefix rewritten), but for the lines listed."""
    orig = _rewritten(inspect.getsource(
        _module_object("cwsl_digi_tpu", module, name)))
    copy = inspect.getsource(
        _module_object("cwsl_digi_tpu_torch", module, name)).splitlines()
    want_removed, want_added, _reason = HOST_PARTS[(module, name)] or (
        [], [], "")
    assert _line_diff(orig, copy) == (want_removed, want_added)


@pytest.mark.parametrize("package", ["dsp", "utils"])
def test_package_exports_match_the_reference(package):
    """The port's dsp/ and utils/ export every name the reference's
    ``__init__.py`` imports, as objects of the same name."""
    tree = ast.parse((REPO / "cwsl_digi_tpu" / package / "__init__.py")
                     .read_text())
    names = [a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) >= 4
    jmod = importlib.import_module(f"cwsl_digi_tpu.{package}")
    pmod = importlib.import_module(f"cwsl_digi_tpu_torch.{package}")
    for name in names:
        assert getattr(pmod, name).__name__.rsplit(".", 1)[-1] == \
            getattr(jmod, name).__name__.rsplit(".", 1)[-1], name


def test_register_decoder_as_the_reference(monkeypatch):
    """A registered decoder is what get_decoder(mode) returns with no other
    argument, in both packages; any argument builds a new decoder."""
    monkeypatch.setattr(jbase, "_REGISTRY", {})
    monkeypatch.setattr(pbase, "_REGISTERED", {})
    mine = object()
    jbase.register_decoder("FT8", mine)
    pbase.register_decoder("FT8", mine)
    assert jbase.get_decoder("FT8") is mine
    assert pbase.get_decoder("FT8") is mine
    assert pbase.get_decoder(Mode.FT8) is mine
    got = pbase.get_decoder("FT8", device="cpu")
    assert got is not mine and got.mode == Mode.FT8
    assert pbase.get_decoder("FT8", device="cpu", top_k=8).spec.top_k == 8
    assert pbase.get_decoder("FT4", device="cpu").mode == Mode.FT4


def test_decode_result_matches_the_reference():
    """The port's DecodeResult has the reference's fields and defaults."""
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(pbase.DecodeResult) == fields(jbase.DecodeResult)
    assert pbase.ModeDecoder.decode.__doc__ == \
        jbase.ModeDecoder.decode.__doc__


CORPUS = [
    "CQ K1ABC FN42", "K1ABC W9XYZ EN37", "W9XYZ K1ABC -11",
    "K1ABC W9XYZ R-09", "W9XYZ K1ABC RRR", "W9XYZ K1ABC RR73",
    "K1ABC W9XYZ 73", "CQ DX DL7ACA JO40", "CQ PJ4/K1ABC",
    "<PJ4/K1ABC> W9XYZ", "TNX BOB 73 GL", "K1ABC RR73; W9XYZ <KH1/KH7Z> -08",
    "K1ABC W9XYZ 6A WI", "W9XYZ K1ABC R 17B EMA", "K1ABC W9XYZ 579 WI",
    "123456789ABCDEF012", "CQ TEST K1ABC FN42", "G4ABC/P VE3XYZ RR73",
]


def test_message77_pack_unpack_agree():
    for text in CORPUS:
        jb, pb = jm77.pack77(text), pm77.pack77(text)
        np.testing.assert_array_equal(pb, jb, err_msg=text)
        assert pm77.unpack77(pb).text == jm77.unpack77(jb).text, text
    rng = np.random.default_rng(77)
    for bits in rng.integers(0, 2, (64, 77), dtype=np.uint8):
        try:
            want = jm77.unpack77(bits).text
        except Exception as e:       # an invalid payload: the copy raises too
            with pytest.raises(type(e)):
                pm77.unpack77(bits)
            continue
        assert pm77.unpack77(bits).text == want


def test_crc_agrees():
    rng = np.random.default_rng(14)
    for payload in rng.integers(0, 2, (32, 77), dtype=np.uint8):
        crc = pcrc.ft8_crc(payload)
        np.testing.assert_array_equal(crc, jcrc.ft8_crc(payload))
        assert pcrc.check_ft8_crc(np.concatenate([payload, crc]))
    np.testing.assert_array_equal(pcrc.ft8_crc_matrix(), jcrc.ft8_crc_matrix())


@pytest.mark.parametrize("f0,fs,sps", [(1500.0, 12_000, 1920),
                                       (-41_250.0, 192_000, 30_720)])
def test_gfsk_modulate_iq_agrees(f0, fs, sps):
    tones = np.random.default_rng(8).integers(0, 8, 79)
    np.testing.assert_array_equal(
        pgfsk.gfsk_modulate_iq(tones, f0, sps, fs, 6.25),
        jgfsk.gfsk_modulate_iq(tones, f0, sps, fs, 6.25))
    np.testing.assert_array_equal(
        pgfsk.gfsk_modulate(tones, 700.0, 1920, 12_000, 6.25),
        jgfsk.gfsk_modulate(tones, 700.0, 1920, 12_000, 6.25))


INI = """
[radio]
source=file:/data/band.npy?sr=192000&lo=14100000
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
decoder=14074000 FT8
decoder=14080000 FT4 1
decoder=14095600 WSPR -1 1.0000005 K1ABC
[wsjtx]
decodedepth=2
highestdecodefreq=3200
[reporting]
pskreporter=true
ignoredcalls=K1AAA W9ZZZ
[logging]
loglevel=3
"""


def test_load_config_agrees(tmp_path):
    ini = tmp_path / "c.ini"
    ini.write_text(INI)
    over = ["wsjtx.decoderburden=2.5", "decoders.decoder=7074000 FT8"]
    jc, pc = jconfig.load_config(ini, over), pconfig.load_config(ini, over)
    assert pc._values.keys() == jc._values.keys()
    for section, values in jc._values.items():
        if section == "decoders":
            continue
        assert pc._values[section] == values, section
    assert [dataclasses.astuple(d) for d in pc.decoders] == \
        [dataclasses.astuple(d) for d in jc.decoders]
    assert len(pc.decoders) == 4
    assert pc.num_decode_slots() == jc.num_decode_slots()
    assert pc.max_long_slots() == jc.max_long_slots()


def test_extract_spot_agrees():
    rng = np.random.default_rng(3)
    n_spots = 0
    for text in CORPUS + ["K1ABC FN42 37", "CQ"]:
        mode = Mode.WSPR if text == "K1ABC FN42 37" else Mode.FT8
        args = (text, float(rng.uniform(-24, 10)), float(rng.uniform(-1, 2)),
                float(rng.uniform(200, 3000)))
        want = jspot.extract_spot(
            jbase.DecodeResult(*args, mode=jspot.Mode(mode.value)),
            14_074_000, 3, 1_760_000_000.0)
        got = pspot.extract_spot(pbase.DecodeResult(*args, mode=mode),
                                 14_074_000, 3, 1_760_000_000.0)
        if want is None:
            assert got is None, text
            continue
        n_spots += 1
        assert dataclasses.asdict(got) == dataclasses.asdict(want), text
    assert n_spots >= 12


# the host part of modes/wspr.py (FST4W's payload needs it too); the
# decode program, the beam search and WSPRDecoder's device calls are ported
WSPR_HOST = ["interleave_map", "_parity32", "conv_encode", "_code_matrices",
             "pack_message", "unpack_message", "encode", "synthesize",
             "WSPRConfig", "_drift_offsets"]
WSPR_CONSTANTS = ["NSYM", "SPS", "BAUD", "TONE_SPACING", "T_R",
                  "SIGNAL_START_S", "N_MSG_BITS", "N_TAIL", "POLY1", "POLY2",
                  "HOP", "NFFT", "BIN_HZ", "FMIN_HZ", "FMAX_HZ", "PAD_HOPS",
                  "SYNC", "INTERLEAVE"]


def test_wspr_host_part_equals_original():
    """Each host function's source equals the original's (import prefix
    rewritten), the constants are equal, and the module holds the ported
    decoder beside them."""
    for name in WSPR_HOST:
        want = _rewritten(inspect.getsource(getattr(jwspr, name)))
        assert inspect.getsource(getattr(pwspr, name)).splitlines() == want
    for name in WSPR_CONSTANTS:
        np.testing.assert_array_equal(getattr(pwspr, name),
                                      getattr(jwspr, name), err_msg=name)
    public = {n for n in vars(pwspr) if not n.startswith("__")}
    assert {"WSPRDecoder", "_decode_program", "_beam_decode"} <= public


def test_wspr_host_part_agrees():
    rng = np.random.default_rng(50)
    for call, grid, dbm in [("K1ABC", "FN42", 37), ("W2AXR", "FN13", 30),
                            ("G4ABC", "IO91", 0), ("VE3XYZ", "EN93", 60)]:
        bits = pwspr.pack_message(call, grid, dbm)
        np.testing.assert_array_equal(bits, jwspr.pack_message(call, grid, dbm))
        assert pwspr.unpack_message(bits) == jwspr.unpack_message(bits) \
            == (call, grid, dbm)
        np.testing.assert_array_equal(pwspr.encode(call, grid, dbm),
                                      jwspr.encode(call, grid, dbm))
    for bits in rng.integers(0, 2, (16, 50), dtype=np.uint8):
        np.testing.assert_array_equal(pwspr.conv_encode(bits),
                                      jwspr.conv_encode(bits))
    for a, b in zip(pwspr._code_matrices(), jwspr._code_matrices()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pwspr.synthesize("K1ABC", "FN42", 37, window_len=200_000),
        jwspr.synthesize("K1ABC", "FN42", 37, window_len=200_000))


def test_js8_varicode_agrees():
    assert pvc.default_table() == jvc.default_table()
    for text in ["HELLO", "73 DE K1ABC", "SO? YES!", "", "TO THE SEA AT TEN"]:
        bits = pvc.encode(text, budget=72)
        assert bits == jvc.encode(text, budget=72)
        assert pvc.decode(bits) == jvc.decode(bits) == text
    assert pvc.encode("CQ CQ DE K1ABC K1ABC", budget=72) is None


def test_tables_ext_overrides_agree(tmp_path, monkeypatch):
    """Both packages read the same published-table directory and return
    the same tables."""
    rng = np.random.default_rng(7)
    (tmp_path / "js8_costas.txt").write_text("2 5 6 0 4 1 3\n")
    h = rng.integers(0, 2, (87, 174))
    h[:, 87:] = np.eye(87, dtype=np.int64)          # full row rank
    (tmp_path / "js8_ldpc_174_87.txt").write_text(
        "\n".join(" ".join(map(str, r)) for r in h))
    monkeypatch.setenv(jtx.ENV_VAR, str(tmp_path))
    assert ptx.ENV_VAR == jtx.ENV_VAR
    loaders = ["js8_costas", "js8_parity", "fst4_parity", "js8_varicode",
               "jt65_sync", "q65_qra"]
    try:
        for name in loaders:
            getattr(ptx, name).cache_clear()
            getattr(jtx, name).cache_clear()
            got, want = getattr(ptx, name)(), getattr(jtx, name)()
            if want is None:
                assert got is None, name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        assert ptx.js8_costas().shape == (3, 7)
        np.testing.assert_array_equal(ptx.js8_parity(), h)
    finally:
        monkeypatch.delenv(jtx.ENV_VAR)
        for name in loaders:
            getattr(ptx, name).cache_clear()
            getattr(jtx, name).cache_clear()


JS8_CORPUS = ["KN4CRD: HB EN50", "KN4CRD: CQ EN50", "KN4CRD: J1Y SNR -12",
              "KN4CRD: J1Y QUERY MSGS", "W2AXR: K1ABC 73", "CQCQ K1ABC",
              "CQ CQ CQ K1ABC EN50", "KN4CRD> VE3ABC> HELLO", "HELLO WORLD",
              "VE3/KN4CRD: HB", "W2AXR:", ""]


def test_js8_spots_agree():
    """The JS8 branch of the spot grammar (sender from classify) gives the
    reference's spots."""
    n_spots = 0
    for i, text in enumerate(JS8_CORPUS):
        args = (text, -12.0 + i, 0.1 * i, 500.0 + 100 * i)
        want = jspot.extract_spot(
            jbase.DecodeResult(*args, mode=jspot.Mode.JS8),
            7_078_000, 1, 1_760_000_000.0)
        got = pspot.extract_spot(pbase.DecodeResult(*args, mode=Mode.JS8),
                                 7_078_000, 1, 1_760_000_000.0)
        if want is None:
            assert got is None, text
            continue
        n_spots += 1
        assert dataclasses.asdict(got) == dataclasses.asdict(want), text
    assert n_spots >= 6
