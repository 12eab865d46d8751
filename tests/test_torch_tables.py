"""Tables carried across: the JAX package's precomputed tables, read off its
objects as NumPy arrays and passed through ``convert.tables_to_torch``,
equal the port's own constructors' tables bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.dsp import lowpass as jlowpass
from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer as JaxChannelizer
from cwsl_digi_tpu.modes import fst4 as jfst4
from cwsl_digi_tpu.modes import ft4 as jft4
from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu.modes import jt65 as jjt65
from cwsl_digi_tpu.modes import ldpc as jldpc
from cwsl_digi_tpu.modes import osd as josd
from cwsl_digi_tpu.modes import q65 as jq65
from cwsl_digi_tpu.modes import qra as jqra
from cwsl_digi_tpu.modes import rs_device as jrs
from cwsl_digi_tpu.modes import wspr as jwspr
from cwsl_digi_tpu_torch import convert
from cwsl_digi_tpu_torch.dsp import lowpass
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu_torch.modes import (fst4, ft4, ft8, js8, jt65, ldpc, osd,
                                       q65, rs_device, wspr)
from cwsl_digi_tpu_torch.modes import tables as ptables


def _assert_bitwise(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    assert a.dtype == b.dtype, name
    assert a.shape == b.shape, name
    assert torch.equal(a, b), name


@pytest.mark.parametrize("fs,usb", [(48_000, True), (192_000, False)])
def test_channelizer_tables_bitwise(fs, usb):
    freqs = np.linspace(-0.4 * fs, 0.4 * fs - 6000, 6)
    jb = JaxChannelizer(fs, freqs, is_usb=usb)
    tb = BatchChannelizer(fs, freqs, is_usb=usb, device="cpu")
    jax_np = {"tone_re": np.asarray(jb.tone_re),
              "tone_im": np.asarray(jb.tone_im),
              "segs": np.asarray(jb.segs)}
    carried = convert.tables_to_torch(jax_np, "cpu")
    mine = tb.tables()
    for name in jax_np:
        _assert_bitwise(carried[name], mine[name], name)
    assert tb._sub == jb._sub


def test_filter_taps_bitwise():
    for fs in (48_000, 96_000, 192_000):
        np.testing.assert_array_equal(lowpass.build_ssb_filter(fs, 6000),
                                      jlowpass.build_ssb_filter(fs, 6000))
    np.testing.assert_array_equal(lowpass.build_lowpass(64, 0.1),
                                  jlowpass.build_lowpass(64, 0.1))


def test_ft8_decoder_tables_bitwise():
    """DFT matrix, window, bitmaps, CRC matrix, data symbols, AP mask and
    values, BP index tables, generator, hash weights, flip patterns."""
    jd = jft8.FT8Decoder(my_call="W2AXR", depth=3)
    td = ft8.FT8Decoder(my_call="W2AXR", depth=3, device="cpu")
    spec = jd.spec
    bt = jd.bp.t
    jax_np = {
        "dft_mat": jd._dft_mat,
        "window": jd._window,
        "bitmaps": jd._bitmaps,
        "crc_mat": jd._crc_mat,
        "data_syms": jd._data_syms,
        "ap_mask": jd._ap_mask,
        "ap_vals": jd._ap_vals,
        "row_cols": bt.row_cols,
        "row_mask": bt.row_mask,
        "col_slots": bt.col_slots,
        "col_mask": bt.col_mask,
        "gen": np.concatenate([np.eye(jd.bp.code.k, dtype=np.uint8),
                               jd.bp.code.gen_parity], axis=1),
        "gen_parity": jd._gen_parity_f32,
        "hash_w": np.asarray(jd._hash_w),
        "patterns": josd.flip_patterns(jd.bp.code.k, spec.osd_singles,
                                       spec.osd_tail2,
                                       spec.osd_tail3).astype(np.float32),
    }
    carried = convert.tables_to_torch(jax_np, "cpu")
    mine = td.tables()
    assert set(carried) == set(mine)
    for name in jax_np:
        _assert_bitwise(carried[name], mine[name], name)
    assert carried["patterns"].shape == (268, 91)
    assert td.max_device_batch == jd.max_device_batch


def _jax_tables(jd) -> dict[str, np.ndarray]:
    """The tables a JAX GFSKDecoder builds, read off it as NumPy arrays."""
    spec, bt = jd.spec, jd.bp.t
    out = {
        "window": jd._window,
        "bitmaps": jd._bitmaps,
        "crc_mat": jd._crc_mat,
        "data_syms": jd._data_syms,
        "row_cols": bt.row_cols,
        "row_mask": bt.row_mask,
        "col_slots": bt.col_slots,
        "col_mask": bt.col_mask,
        "gen": np.concatenate([np.eye(jd.bp.code.k, dtype=np.uint8),
                               jd.bp.code.gen_parity], axis=1),
        "gen_parity": jd._gen_parity_f32,
        "hash_w": np.asarray(jd._hash_w),
        "patterns": josd.flip_patterns(jd.bp.code.k, spec.osd_singles,
                                       spec.osd_tail2,
                                       spec.osd_tail3).astype(np.float32),
    }
    if jd._dft_mat is not None:
        out["dft_mat"] = jd._dft_mat
    return out


@pytest.mark.parametrize("mode", ["FT4", "JS8", "FST4-60", "FST4W-120",
                                  "FST4-1800"])
def test_gfsk_mode_decoder_tables_bitwise(mode):
    """FT4, JS8 (LDPC(174,87)) and FST4/FST4W (LDPC(240,101)): BP index
    tables, generators, CRC matrices, DFT matrices (none for FST4-1800,
    whose spectrograms are rffts) carried across bit for bit."""
    if mode == "FT4":
        jd, td = jft4.FT4Decoder(), ft4.FT4Decoder(device="cpu")
    elif mode == "JS8":
        jd, td = jjs8.JS8Decoder(), js8.JS8Decoder(device="cpu")
    else:
        jd = jfst4.FST4Decoder(jfst4.Mode(mode))
        td = fst4.FST4Decoder(mode, device="cpu")
    jax_np = _jax_tables(jd)
    carried = convert.tables_to_torch(jax_np, "cpu")
    mine = td.tables()
    assert set(carried) == set(mine)
    for name in jax_np:
        _assert_bitwise(carried[name], mine[name], name)
    assert ("dft_mat" in mine) == (mode != "FST4-1800")
    assert td.max_device_batch == jd.max_device_batch


def test_qary_tables_bitwise():
    """The q-ary modes' tables (sync and data indices, interleaver, Gray
    demap, DFT matrices, RS tables, the Q65 code's sum-product tables)
    carried across from the JAX objects equal the port's bit for bit."""
    for jd, pd in [(jjt65.JT65Decoder(), jt65.JT65Decoder(device="cpu")),
                   (jq65.Q65Decoder(), q65.Q65Decoder(device="cpu"))]:
        jax_np = {"window": jd._window, "data_syms": jd._data_syms,
                  "sync_syms": jd._sync_syms, "dft_mat": jd._dft_mat}
        if jd.symbol_perm is not None:
            jax_np["symbol_perm"] = jd.symbol_perm
            jax_np["value_demap"] = jd.value_demap
        carried = convert.tables_to_torch(jax_np, "cpu")
        mine = pd.tables()
        assert set(carried) == set(mine)
        for name in carried:
            assert torch.equal(carried[name], mine[name]), name
        assert pd.spectrogram_branch == "dft"
    rs_j = dict(zip(rs_device.RS_TABLES, jrs._tables(63, 51, 3)))
    mine = convert.tables_to_torch(rs_device.host_tables(63, 51, 3), "cpu")
    for name, arr in convert.tables_to_torch(rs_j, "cpu").items():
        assert torch.equal(arr, mine[name]), name
    jm, pm = jq65._mp(), q65._mp(torch.device("cpu"))
    jax_np = {"h_vars": jm._h_vars, "h_coeff": jm.code.h_coeff,
              "row_mask": jm._row_mask, "qra_fwd": jm._fwd,
              "qra_bwd": jm._bwd, "col_slots": jm._col_slots,
              "col_mask": jm._col_mask, "wht": jqra._wht64(),
              "gf_mul": jqra._mul_table()}
    carried = convert.tables_to_torch(jax_np, "cpu")
    mine = pm.tables()
    assert set(carried) == set(mine)
    for name in carried:
        assert torch.equal(carried[name], mine[name]), name
    np.testing.assert_array_equal(q65._CODE.gen, jq65._CODE.gen)


@pytest.mark.parametrize("cycles", [None, 300, 20_000])
def test_wspr_decoder_tables_bitwise(cycles):
    """WSPR's sync vector, interleaver, Hann window, (162, 50) block-code
    matrices and OSD flip patterns (their count set by ``wsprcycles``)."""
    jd = jwspr.WSPRDecoder(cycles=cycles)
    g, r = jwspr._code_matrices()
    cfg = jd.cfg
    jax_np = {"sync": jd._sync, "interleave": jd._deinter,
              "window": jd._window, "wspr_gen": g, "wspr_inv": r,
              "patterns": josd.flip_patterns(
                  50, cfg.osd_singles, cfg.osd_tail2,
                  cfg.osd_tail3).astype(np.float32)}
    carried = convert.tables_to_torch(jax_np, "cpu")
    mine = wspr.WSPRDecoder(cycles=cycles, device="cpu").tables()
    assert set(carried) == set(mine)
    for name in jax_np:
        _assert_bitwise(carried[name], mine[name], name)
    assert carried["patterns"].shape == (1 + 50 + 325 + 364, 50)


def test_codes_and_flip_patterns_identical():
    jc, tc = jldpc.ft8_code(), ldpc.ft8_code()
    np.testing.assert_array_equal(jc.h, tc.h)
    np.testing.assert_array_equal(jc.gen_parity, tc.gen_parity)
    for args in [(91, 91, 16, 8), (91, 40, 10, 0), (101, 101, 16, 8)]:
        np.testing.assert_array_equal(osd.flip_patterns(*args),
                                      josd.flip_patterns(*args))
    np.testing.assert_array_equal(ft8.ap_hypotheses("K1ABC", "W9XYZ"),
                                  jft8.ap_hypotheses("K1ABC", "W9XYZ"))
    np.testing.assert_array_equal(ft8.encode_message("CQ W2AXR FN13"),
                                  jft8.encode_message("CQ W2AXR FN13"))
    assert ft8.SPEC.__dict__ == jft8.SPEC.__dict__


def test_ft8_generator_matches_published_rows():
    """The generator derived from the port's parity table starts with the
    published ldpc_174_91_c_generator rows."""
    code = ldpc.ft8_code()
    head = ptables.generator_hex_rows(code.gen_parity)
    assert tuple(head[: len(ptables.FT8_GENERATOR_HEX_HEAD)]) == \
        ptables.FT8_GENERATOR_HEX_HEAD
    assert len(ptables.FT8_GENERATOR_HEX_HEAD) > 0


def test_convert_refuses_unknown_names_and_dtypes():
    with pytest.raises(KeyError):
        convert.tables_to_torch({"weights": np.zeros(3, np.float32)},
                                "cpu")
    with pytest.raises(ValueError, match="dtype"):
        convert.tables_to_torch({"segs": np.zeros((2, 2), np.float64)},
                                "cpu")
