"""The port's copies of the JAX package's host modules.

The port imports nothing of the JAX package, so it keeps its own copy of
every host module it needs.  Each copy must equal its original once the
``cwsl_digi_tpu.`` import prefix is rewritten to ``cwsl_digi_tpu_torch.``;
the few lines that differ on purpose are listed below with their reason.
Then both packages' functions run on the same seeded inputs and must
agree field by field (the two packages' ``DecodeResult`` and ``Spot``
classes are different classes).
"""

from __future__ import annotations

import dataclasses
import difflib
import re
from pathlib import Path

import numpy as np
import pytest

from cwsl_digi_tpu import config as jconfig
from cwsl_digi_tpu.modes import base as jbase
from cwsl_digi_tpu.modes import crc as jcrc
from cwsl_digi_tpu.modes import gfsk as jgfsk
from cwsl_digi_tpu.modes import message77 as jm77
from cwsl_digi_tpu.report import spot as jspot
from cwsl_digi_tpu_torch import config as pconfig
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import base as pbase
from cwsl_digi_tpu_torch.modes import crc as pcrc
from cwsl_digi_tpu_torch.modes import gfsk as pgfsk
from cwsl_digi_tpu_torch.modes import message77 as pm77
from cwsl_digi_tpu_torch.report import spot as pspot

REPO = Path(__file__).resolve().parents[1]

COPIES = [
    "constants.py", "version.py", "config.py", "stats.py", "native.py",
    "modes/message77.py", "modes/tables.py", "modes/crc.py", "modes/gfsk.py",
    "report/spot.py", "report/pskreporter.py", "report/rbn.py",
    "report/wsprnet.py", "report/jt9format.py", "runtime/scheduler.py",
    "runtime/decoderpool.py", "sdr/source.py", "sdr/shm.py",
    "utils/hamutils.py", "utils/logging.py", "utils/qos.py",
    "utils/timeutils.py", "utils/wav.py",
]

# module -> (lines only the original has, lines only the copy has, reason)
DIFFERS = {
    "report/spot.py": (
        ["        from cwsl_digi_tpu_torch.modes.js8 import classify",
         "",
         "        c = classify(text)",
         "        sender, locator = c.from_call, c.grid",
         '        if c.kind == "DIRECTED" and c.arg is not None:',
         "            report = str(c.arg)"],
        ['        raise NotImplementedError("JS8 is not ported yet")'],
        "JS8 is not ported: its classifier lives in the JAX mode module"),
    "runtime/decoderpool.py": (
        ["        audio = np.asarray(job.audio)   # device windows fetched on "
         "demand"],
        ["import torch",
         "        audio = job.audio   # device windows fetched on demand",
         "        audio = audio.cpu().numpy() if isinstance(audio, "
         "torch.Tensor) \\",
         "            else np.asarray(audio)"],
        "keepwav reads jobs whose audio is a CUDA tensor"),
}


def _rewritten(text: str) -> list[str]:
    return re.sub(r"\bcwsl_digi_tpu\.", "cwsl_digi_tpu_torch.",
                  text).splitlines()


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_original(module):
    orig = _rewritten((REPO / "cwsl_digi_tpu" / module).read_text())
    copy = (REPO / "cwsl_digi_tpu_torch" / module).read_text().splitlines()
    removed, added = [], []
    for line in difflib.unified_diff(orig, copy, lineterm="", n=0):
        if line.startswith(("---", "+++", "@@")):
            continue
        (removed if line[0] == "-" else added).append(line[1:])
    want_removed, want_added, _reason = DIFFERS.get(module, ([], [], ""))
    assert (removed, added) == (want_removed, want_added)


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
