"""Tests of the port that need the card: the CUDA channelizer kernel against
its plain version (streaming, and at the blocks time shards give it), the
LDPC kernels ``bp_minsum`` and ``osd`` against their plain versions on
every code and OSD shape the decoders run (and no fallback when their
library cannot be built), the GFSK kernels ``subtract_known`` and
``multisym_llrs`` against their plain versions at FT8, FT4, JS8 and
FST4-60 shapes, the LLR kernel also from the demod spectrogram at FT8,
FT4, JS8 and FST4W-120 with the clamps' edge cases (and no fallback; the
subtraction bit for bit alike
whatever its blocks, in and out of a CUDA graph; ``sincosf`` as ``sinf``
and ``cosf``), the FT8, FT4, JS8, FST4-60, WSPR, JT65 and
Q65-30 decoders on CUDA tensors against the same decoders on CPU tensors,
the sync-search kernels ``sync_score``, ``sync_select`` and
``sync_refine`` against their plain versions on FT8 (noise with tone tracks,
all-tie windows, NaN and +-inf, the pass-1 shape, top_k 32768, a grid
smaller than a block), FT4, JS8, FST4-60 and FST4-900 maps, the selection
forced to 8-block clusters (and no fallback, also when the library refuses
a launch; no spills), and the
parallel layer on a virtual mesh of the card against one on the CPU.

This file imports no JAX (the machine with the card has none), so it runs
there without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Elsewhere every test skips.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cwsl_digi_tpu_torch.dsp import _kernels
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gfsk_kernels
from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels
from cwsl_digi_tpu_torch.modes import _sync_kernels as sync_kernels
from cwsl_digi_tpu_torch.modes import (fst4, ft4, ft8, gfsk_engine, js8,
                                       jt65, ldpc, osd, q65, subtract, wspr)
from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr, gfsk_modulate_iq
from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer
from test_torch_device_lock import pool_run
from test_torch_parity import WSPRTolerance, assert_same_batch_decodes

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from torch_ap_false import decode_window, fixtures  # noqa: E402

AP_FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "ap_false"
FALSE_SPOTS = AP_FIXTURES.parent / "false_spots"

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


@pytest.mark.parametrize("fs,usb", [(48_000, True), (96_000, True),
                                    (192_000, False)])
def test_cuda_kernel_matches_plain_on_card(dev, fs, usb):
    """The kernel against the plain version on the same CUDA inputs, 40
    channels (a partial channel tile), in the receiver's 12-sub-block
    chunks and one ragged window: atol 1e-4 (split-bf16 products, ~16
    bits, against float32 FIR sums of FO taps; output rms ~0.2)."""
    freqs = np.linspace(-0.45 * fs + 6000 * (not usb),
                        0.45 * fs - 6000 * usb, 40)
    kern = BatchChannelizer(fs, freqs, is_usb=usb, device=dev)
    plain = BatchChannelizer(fs, freqs, is_usb=usb, device=dev)
    g = 12 * kern._sub
    iq = torch.from_numpy(_iq(3 * g, seed=fs)).to(dev)
    before = _kernels.launches["channelize"]
    for i in range(3):
        x = iq[i * g : (i + 1) * g]
        torch.testing.assert_close(kern.process(x), plain.process_plain(x),
                                   rtol=0, atol=1e-4)
    n = 2 * g + 7 * kern.spec.block_size
    plain.reset()
    ref = plain.process_plain(torch.nn.functional.pad(iq[:n], (0, 3 * g - n)))
    torch.testing.assert_close(kern.process_window(iq[:n]),
                               ref[:, : n // kern.spec.block_size],
                               rtol=0, atol=1e-4)
    torch.cuda.synchronize()
    assert _kernels.launches["channelize"] == before + 4


def _ldpc_decoder(name: str, dev):
    """A decoder whose BP tables and OSD tables are those of ``name``."""
    return {"ft8": lambda: ft8.FT8Decoder(my_call="W2AXR", depth=3,
                                          device=dev),
            "ft4": lambda: ft4.FT4Decoder(depth=3, device=dev),
            "js8": lambda: js8.JS8Decoder(device=dev),
            "fst4": lambda: fst4.FST4Decoder(Mode.FST4_60, device=dev),
            "wspr": lambda: wspr.WSPRDecoder(device=dev)}[name]()


@pytest.mark.parametrize("name,seed", [("ft8", 1), ("js8", 2), ("fst4", 3)])
def test_bp_kernel_matches_plain_on_card(dev, name, seed):
    """bp_minsum against decode_full_plain on CPU copies of the same LLRs
    (the kernel's slot-order sums; chip_smoke.bp_vs_plain): 2048 seeded
    noisy codewords of each LDPC code, (174,91), (174,87) and (240,101),
    an eighth rounded to whole numbers (duplicated minima), at the
    decoder's iteration count.  Hard bits and parity flags equal,
    posterior totals within atol 1e-4; one launch."""
    d = _ldpc_decoder(name, dev)
    llr = torch.from_numpy(chip_smoke.noisy_llrs(
        d._host["gen"], 2048, seed, ties=256)).to(dev)
    before = ldpc_kernels.launches["bp_minsum"]
    got = chip_smoke.bp_vs_plain(d.bp, llr)
    torch.cuda.synchronize()
    assert ldpc_kernels.launches["bp_minsum"] == before + 1
    assert got["ok"], got
    assert 0 < got["parity_ok"] < 2048


@pytest.mark.parametrize("name,seed", [("ft8", 4), ("js8", 5), ("fst4", 6),
                                       ("wspr", 7), ("ft4", 8)])
def test_osd_kernel_matches_plain_on_card(dev, name, seed):
    """osd against osd_decode_plain on the same CUDA LLRs: 384 seeded
    noisy codewords of each OSD shape, FT8 (91, 174, 268 patterns), JS8
    (87, 174), FST4 (101, 240), WSPR (50, 162, 740 patterns) and FT4's
    pattern set, an eighth rounded (ties in |LLR|: the stable sort).
    Codewords and hard errors equal outside near-ties (the two picks'
    distances within 1e-5 relative), distances within rtol 1e-5; one
    launch."""
    d = _ldpc_decoder(name, dev)
    gen = d._tabs["wspr_gen" if name == "wspr" else "gen"]
    llr = torch.from_numpy(chip_smoke.noisy_llrs(
        gen.cpu().numpy(), 384, seed, ties=48)).to(dev)
    before = ldpc_kernels.launches["osd"]
    got = chip_smoke.osd_vs_plain(gen, llr, d._tabs["patterns"],
                                  d._tabs["pattern_idx"])
    torch.cuda.synchronize()
    assert ldpc_kernels.launches["osd"] == before + 1
    assert got["ok"], got


def test_ldpc_kernels_raise_without_library_on_card(dev, monkeypatch,
                                                    tmp_path):
    """With no nvcc and no built library, decode_full and osd_decode on a
    CUDA tensor raise; the plain versions never run and nothing counts."""
    monkeypatch.setattr(ldpc_kernels, "_lib", None)
    monkeypatch.setattr(ldpc_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ldpc_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ldpc.BPDecoder, "decode_full_plain", plain)
    monkeypatch.setattr(osd, "osd_decode_plain", plain)
    d = ft8.FT8Decoder(device=dev)
    llr = torch.ones((4, 174), device=dev)
    before = dict(ldpc_kernels.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        d.bp.decode_full(llr)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        osd.osd_decode(d._tabs["gen"], llr, d._tabs["patterns"],
                       d._tabs["pattern_idx"])
    assert ldpc_kernels.launches == before


def test_decoders_launch_the_ldpc_kernels_on_card(dev):
    """An FT8 decode on the card runs bp_minsum and osd, a WSPR decode
    runs osd."""
    rng = np.random.default_rng(12)
    win = add_noise_at_snr(ft8.synthesize("CQ W2AXR FN13", 1200.0), -12.0,
                           12_000, rng).astype(np.float32)
    before = dict(ldpc_kernels.launches)
    ft8.FT8Decoder(device=dev).decode(torch.from_numpy(win[None]).to(dev))
    torch.cuda.synchronize()
    assert ldpc_kernels.launches["bp_minsum"] > before["bp_minsum"]
    assert ldpc_kernels.launches["osd"] > before["osd"]
    win = add_noise_at_snr(wspr.synthesize("K1ABC", "FN42", 37, 1500.0),
                           -20.0, 12_000, rng).astype(np.float32)
    before = dict(ldpc_kernels.launches)
    wspr.WSPRDecoder(device=dev).decode(torch.from_numpy(win[None]).to(dev))
    torch.cuda.synchronize()
    assert ldpc_kernels.launches["osd"] > before["osd"]
    assert ldpc_kernels.launches["bp_minsum"] == before["bp_minsum"]


def _gfsk_shapes():
    """(name, spec, LDPC code) of each GFSK engine shape."""
    return [("ft8", ft8.SPEC, ldpc.ft8_code()),
            ("ft4", ft4.SPEC, ldpc.ft8_code()),
            ("js8", js8.SPEC, js8.js8_code()),
            ("fst4-60", fst4.make_spec(Mode.FST4_60), ldpc.fst4_code())]


# bursts in each window of the subtraction cases: one window's run out
# before the others'
GFSK_COUNTS = {"ft8": (6, 1, 3, 0, 2, 4, 5, 6), "ft4": (3, 1, 2, 3),
               "js8": (2, 1, 3, 2), "fst4-60": (2, 1)}


@pytest.mark.parametrize("shape", range(4),
                         ids=[s[0] for s in _gfsk_shapes()])
def test_subtract_kernel_matches_plain_on_card(dev, shape):
    """subtract_known against subtract_known_plain on CPU copies
    (chip_smoke.subtract_vs_plain): seeded windows with 0 to 6 known bursts
    at -6 to -14 dB in noise, 16 burst slots, at each shape.  Residual
    within 1e-3 of each window's peak, every fitted burst's integer time
    shift equal; one launch."""
    name, spec, code = _gfsk_shapes()[shape]
    audio, params, gp, _ = chip_smoke.burst_case(
        spec, code, GFSK_COUNTS[name], seed=20 + shape, n_slots=16)
    before = gfsk_kernels.launches["subtract_known"]
    got = chip_smoke.subtract_vs_plain(
        spec, *(torch.from_numpy(x).to(dev) for x in (audio, params, gp)))
    torch.cuda.synchronize()
    assert gfsk_kernels.launches["subtract_known"] == before + 1
    assert got["ok"], got
    assert got["steps"] == sum(GFSK_COUNTS[name])
    assert not got["shift_flips"], got


# blocks of subtract_known: every block the card holds at once, then 1, 3
# and 40 (fewer than a pass's span blocks at FST4-60, more at FT4)
SUB_BLOCKS = [0, 1, 3, 40]


def _subtract_blocks(spec, audio, params, gp, n_blocks: int):
    """The subtraction launched with ``n_blocks`` blocks, straight through
    the library (the wrapper always asks for every block the card holds),
    with the wrapper's operands, scratch and padding, on the current
    stream.  Returns (CUDA error, residual [B, T])."""
    import ctypes

    B, T = audio.shape
    dims, consts = gfsk_kernels.subtract_dims(spec, B, T, *gp.shape,
                                              params.shape[1])
    margin, hop = dims[9], dims[3]
    t_pad = -(-T // hop) * hop
    res = torch.nn.functional.pad(audio, (margin * hop,
                                          t_pad - T + margin * hop))
    tabs = gfsk_kernels._spec_tables(spec, audio.device)
    lib = gfsk_kernels.load_library()
    di = (ctypes.c_int * len(dims))(*dims)
    dc = (ctypes.c_float * len(consts))(*consts)
    n_int = ctypes.c_longlong(0)
    n_float = lib.gfsk_sub_scratch(ctypes.addressof(di),
                                   ctypes.addressof(dc), ctypes.byref(n_int))
    assert n_float > 0
    sf = torch.empty(n_float, dtype=torch.float32, device=audio.device)
    si = torch.empty(n_int.value, dtype=torch.int32, device=audio.device)
    err = lib.gfsk_subtract_launch(
        ctypes.addressof(di), ctypes.addressof(dc), res.data_ptr(),
        params.data_ptr(), gp.data_ptr(), tabs["pulse_pad"].data_ptr(),
        tabs["template"].data_ptr(), tabs["data_idx"].data_ptr(),
        tabs["gray"].data_ptr(), sf.data_ptr(), si.data_ptr(), None,
        torch.cuda.current_stream(audio.device).cuda_stream, n_blocks)
    return err, res[:, margin * hop:margin * hop + T]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("shape", [1, 3], ids=["ft4", "fst4-60"])
def test_subtract_blocks_agree_bit_for_bit_on_card(dev, shape):
    """However many blocks share subtract_known's work queue, the residual
    is the wrapper's bit for bit (each span block's sums in the same
    order, whichever block takes it); and each captures in a CUDA graph
    whose replay gives the same bits."""
    name, spec, code = _gfsk_shapes()[shape]
    audio, params, gp, _ = chip_smoke.burst_case(
        spec, code, GFSK_COUNTS[name], seed=40 + shape, n_slots=8)
    args = [torch.from_numpy(x).to(dev) for x in (audio, params, gp)]
    before = gfsk_kernels.launches["subtract_known"]
    ref = gfsk_kernels.subtract_known(spec, *args)
    assert gfsk_kernels.launches["subtract_known"] == before + 1
    for n in SUB_BLOCKS:
        err, got = _subtract_blocks(spec, *args, n)
        assert err == 0, n
        assert _same_bits(got, ref), n
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _subtract_blocks(spec, *args, n)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            err, captured = _subtract_blocks(spec, *args, n)
        assert err == 0, n
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(captured, ref), n


# windows whose bursts fill every slot, so that the work queue takes every
# pass a call can open: one FT8 window with 4 of 4, two FT4 windows with
# 3 of 3 each
FULL_SLOTS = {"ft8": (4,), "ft4": (3, 3)}


@pytest.mark.parametrize("shape", [0, 1], ids=["ft8", "ft4"])
def test_subtract_with_every_slot_filled_on_card(dev, shape):
    """With every slot of every window a valid burst, subtract_known stays
    within SUB_TOL_PEAK of the plain version with no shift flip, and gives
    the same bits at every block count and on a second call."""
    name, spec, code = _gfsk_shapes()[shape]
    counts = FULL_SLOTS[name]
    audio, params, gp, _ = chip_smoke.burst_case(
        spec, code, counts, seed=60 + shape, n_slots=max(counts))
    assert bool((params[:, :, -1] == 1).all())
    args = [torch.from_numpy(x).to(dev) for x in (audio, params, gp)]
    got = chip_smoke.subtract_vs_plain(spec, *args)
    assert got["ok"], got
    assert got["steps"] == sum(counts)
    assert not got["shift_flips"], got
    ref = gfsk_kernels.subtract_known(spec, *args)
    assert _same_bits(gfsk_kernels.subtract_known(spec, *args), ref)
    for n in SUB_BLOCKS:
        err, res = _subtract_blocks(spec, *args, n)
        torch.cuda.synchronize()
        assert err == 0, n
        assert _same_bits(res, ref), n


def test_subtract_refuses_more_blocks_than_the_card_holds(dev):
    """The work queue's blocks wait on each other, so all must be on the
    card at once: the library refuses a launch of more blocks than the
    card holds, before it writes anything."""
    name, spec, code = _gfsk_shapes()[1]
    audio, params, gp, _ = chip_smoke.burst_case(spec, code, (1,), seed=9)
    args = [torch.from_numpy(x).to(dev) for x in (audio, params, gp)]
    err, res = _subtract_blocks(spec, *args, 1 << 20)
    torch.cuda.synchronize()
    assert err != 0
    assert _same_bits(res, args[0])


def test_sincosf_rounds_as_sinf_and_cosf_on_card(dev):
    """The subtraction kernel's one sincosf an angle gives the bits of
    separate sinf and cosf calls over the angles it meets (to ~1e7 rad)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1e7, 1e7, 1 << 18),
                        rng.uniform(-3e5, 3e5, 1 << 18),
                        rng.uniform(-10, 10, 1 << 16)]).astype(np.float32)
    assert gfsk_kernels.trig_differ(torch.from_numpy(x).to(dev)) == 0


@pytest.mark.parametrize("shape", range(4),
                         ids=[s[0] for s in _gfsk_shapes()])
def test_llr_kernel_matches_plain_on_card(dev, shape):
    """multisym_llrs against _multisym_llrs_plain on CPU copies
    (chip_smoke.llr_vs_plain): 1024 seeded candidates at each shape,
    FST4-60 with its 4-symbol windows; within atol 1e-3; one launch."""
    _, spec, _ = _gfsk_shapes()[shape]
    csym, rot = chip_smoke.noisy_csym(spec, 1024, seed=30 + shape)
    bm = torch.from_numpy(spec.bitmaps()).to(dev)
    before = gfsk_kernels.launches["multisym_llrs"]
    got = chip_smoke.llr_vs_plain(spec, torch.from_numpy(csym).to(dev),
                                  torch.from_numpy(rot).to(dev), bm)
    torch.cuda.synchronize()
    assert gfsk_kernels.launches["multisym_llrs"] == before + 1
    assert got["ok"], got


def _fused_shapes():
    """(name, spec, os_t_eff, fold_pairs) of each spectrogram shape the
    LLR kernel's fused entry meets: the refine branch's half hops (FT8,
    FT4, JS8), FST4W-120's hops (coh4) and FT8 without the pair fold."""
    fst4w = fst4.make_spec(Mode.FST4W_120)
    return [("ft8", ft8.SPEC, 2 * ft8.SPEC.os_t, True),
            ("ft4", ft4.SPEC, 2 * ft4.SPEC.os_t, True),
            ("js8", js8.SPEC, 2 * js8.SPEC.os_t, True),
            ("fst4w-120", fst4w, fst4w.os_t, True),
            ("ft8 no fold", ft8.SPEC, 2 * ft8.SPEC.os_t, False)]


@pytest.mark.parametrize("shape", range(5),
                         ids=[s[0] for s in _fused_shapes()])
def test_fused_llr_kernel_matches_plain_on_card(dev, shape):
    """candidate_llrs (the LLR kernel from the demod spectrogram) against
    candidate_llrs_plain on CPU copies (chip_smoke.fused_llr_vs_plain): 8
    seeded spectrograms of 96 candidates each, the first five at the
    edges where the block start's clamps and the zero padding bite;
    within atol 1e-3; one launch."""
    _, spec, os_t_eff, fold = _fused_shapes()[shape]
    demod, tt, f0 = (torch.from_numpy(x).to(dev) for x in
                     chip_smoke.noisy_demod(spec, 8, 96, os_t_eff,
                                            seed=60 + shape))
    bm = torch.from_numpy(spec.bitmaps()).to(dev)
    before = gfsk_kernels.launches["multisym_llrs"]
    got = chip_smoke.fused_llr_vs_plain(spec, demod, tt, f0, os_t_eff, fold,
                                        bm)
    torch.cuda.synchronize()
    assert gfsk_kernels.launches["multisym_llrs"] == before + 1
    assert got["ok"], got


def test_gfsk_kernels_raise_without_library_on_card(dev, monkeypatch,
                                                    tmp_path):
    """With no nvcc and no built library, subtract_known, _multisym_llrs
    and candidate_llrs on CUDA tensors raise; the plain versions never run
    and nothing counts."""
    monkeypatch.setattr(gfsk_kernels, "_lib", None)
    monkeypatch.setattr(gfsk_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(gfsk_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(subtract, "subtract_known_plain", plain)
    monkeypatch.setattr(gfsk_engine, "_multisym_llrs_plain", plain)
    monkeypatch.setattr(gfsk_engine, "candidate_llrs_plain", plain)
    spec = ft8.SPEC
    before = dict(gfsk_kernels.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        subtract.subtract_known(
            spec, torch.zeros((2, 180_000), device=dev),
            torch.ones((2, 4, 94), dtype=torch.int32, device=dev),
            torch.zeros((91, 83), device=dev))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gfsk_engine._multisym_llrs(
            spec, torch.ones((4, 79, 8), dtype=torch.complex64, device=dev),
            torch.ones(4, dtype=torch.complex64, device=dev),
            torch.from_numpy(spec.bitmaps()).to(dev))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gfsk_engine.candidate_llrs(
            spec, torch.ones((2, 1300, 50), dtype=torch.complex64,
                             device=dev),
            torch.zeros((2, 4), dtype=torch.int64, device=dev),
            torch.zeros((2, 4), dtype=torch.int64, device=dev), 16, True,
            torch.from_numpy(spec.bitmaps()).to(dev))
    assert gfsk_kernels.launches == before


def test_decoders_launch_the_gfsk_kernels_on_card(dev):
    """An FT8 decode on the card at depth 2 runs multisym_llrs on each pass
    and subtract_known between them; a WSPR decode runs neither."""
    rng = np.random.default_rng(13)
    win = add_noise_at_snr(ft8.synthesize("CQ W2AXR FN13", 1200.0), -12.0,
                           12_000, rng).astype(np.float32)
    before = dict(gfsk_kernels.launches)
    res = ft8.FT8Decoder(device=dev).decode(
        torch.from_numpy(win[None]).to(dev), depth=2)
    torch.cuda.synchronize()
    assert [r.message for r in res[0]] == ["CQ W2AXR FN13"]
    assert gfsk_kernels.launches["multisym_llrs"] == before["multisym_llrs"] + 2
    assert gfsk_kernels.launches["subtract_known"] == \
        before["subtract_known"] + 1
    win = add_noise_at_snr(wspr.synthesize("K1ABC", "FN42", 37, 1500.0),
                           -20.0, 12_000, rng).astype(np.float32)
    before = dict(gfsk_kernels.launches)
    wspr.WSPRDecoder(device=dev).decode(torch.from_numpy(win[None]).to(dev))
    assert gfsk_kernels.launches == before


def _sync_noise_case(spec, seed: int, dev, windows: int = 2) -> tuple:
    """Sync-search operands of ``windows`` windows at the mode's
    decode_program shapes (``chip_smoke.tie_case``'s): exponential power
    noise and complex Gaussian demod noise with 8 tone tracks a window
    along the sync cells, the demod's at a random half-hop offset."""
    spec, ps, dem, _, n_hops, refine = chip_smoke.tie_case(spec, "cpu")
    rng = np.random.default_rng(seed)
    p_shape = (windows,) + tuple(ps.shape[1:])
    d_shape = (windows,) + tuple(dem.shape[1:])
    power = rng.exponential(1.0, p_shape).astype(np.float32)
    demod = ((rng.standard_normal(d_shape)
              + 1j * rng.standard_normal(d_shape)) / np.sqrt(2)
             ).astype(np.complex64)
    n_f0 = spec.bin_range[1] - spec.bin_range[0]
    for w in range(windows):
        for _ in range(8):
            t0 = int(rng.integers(0, spec.max_hops))
            f0 = int(rng.integers(0, n_f0))
            amp = 10 ** rng.uniform(0.3, 1.2)
            off = int(rng.integers(-1, 2))
            for sym, tone in spec.sync_cells:
                r, c = t0 + spec.os_t * sym, f0 + spec.os_f * tone
                power[w, r, c] += amp
                if 0 <= 2 * r + off < demod.shape[1]:
                    demod[w, 2 * r + off, c] += np.sqrt(amp)
    ps = torch.from_numpy(power).to(torch.bfloat16).to(dev)
    ph = spec.pad_hops
    base = ps[:, ph : ph + n_hops].to(torch.float32).mean(
        dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    return (spec, ps, torch.from_numpy(demod).to(dev), base, n_hops,
            refine)


def _small_grid_spec():
    """FT8 cut to a 3 x 40 grid (120 scores, fewer than a selection
    block's threads) with top_k 64, refined."""
    spec = ft8.SPEC
    return dataclasses.replace(spec, max_hops=3,
                               fmax_hz=spec.fmin_hz + 40 * spec.bin_hz,
                               top_k=64)


@pytest.mark.parametrize("case", [
    "ft8 noise", "ft8 ties", "js8 noise", "fst4-60 noise",
    "ft8 noise widest", "ft8 pass-1 shape", "ft8 nan inf", "ft4 noise",
    "fst4-900 noise", "ft8 small grid", "ft8 fourteen cells"])
def test_sync_kernels_match_plain_on_card(dev, case):
    """sync_score, sync_select and sync_refine (and the stage's wrapper)
    against the plain versions on CPU copies: the score and NMS map bit for
    bit, top_val bit for bit, top_idx and tt identical; on a small FT8 map
    with tone tracks, on FT8 windows of a constant map and of zeros (every
    score and every refinement offset ties), on JS8 (the score's os_t = 4,
    os_f = 2 instance with 21 cells), on FST4-60 (no refinement; os_t = 8,
    os_f = 4 with 40 cells), on FT8 at the largest top_k the selection
    takes (16384 a half), on FT8's pass-1 shape (24 windows), on FT8
    windows holding NaN, +-inf and -0.0, on FT4 (os_t = 8, os_f = 4 with
    16 cells), on FST4-900 (os_t = 4, os_f = 2 with 40 cells), on a grid
    of fewer scores than a selection block's threads, and with 14 of FT8's
    cells (the score's generic instance).  Each wrapper call counts one
    launch of its kernel."""
    name = case.split()[0]
    spec = {"ft8": ft8.SPEC, "js8": js8.SPEC, "ft4": ft4.SPEC,
            "fst4-60": fst4.make_spec(Mode.FST4_60),
            "fst4-900": fst4.make_spec(Mode.FST4_900)}[name]
    if case.endswith("widest"):
        spec = dataclasses.replace(spec,
                                   top_k=2 * sync_kernels.SELECT_MAX_K)
    if case.endswith("small grid"):
        spec = _small_grid_spec()
    if case.endswith("fourteen cells"):
        spec = dataclasses.replace(spec, sync_cells=spec.sync_cells[:14])
    if case.endswith("ties"):
        args = chip_smoke.tie_case(spec, dev)
    elif case.endswith("nan inf"):
        args = chip_smoke.odd_case(spec, dev)
    else:
        args = _sync_noise_case(spec, 17, dev,
                                24 if case.endswith("shape") else 2)
    before = dict(sync_kernels.launches)
    got = chip_smoke.sync_vs_plain(*args)
    torch.cuda.synchronize()
    refine = int(args[5])
    assert sync_kernels.launches == {
        "sync_score": before["sync_score"] + 2,
        "sync_select": before["sync_select"] + 2,
        "sync_refine": before["sync_refine"] + 2 * refine}
    assert got["ok"], got


def test_sync_kernels_raise_without_library_on_card(dev, monkeypatch,
                                                    tmp_path):
    """With no nvcc and no built library, sync_candidates on CUDA tensors
    raises; the plain versions never run and nothing counts."""
    monkeypatch.setattr(sync_kernels, "_lib", None)
    monkeypatch.setattr(sync_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sync_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for name in ("sync_candidates_plain", "sync_score_plain",
                 "sync_select_plain", "sync_refine_plain"):
        monkeypatch.setattr(gfsk_engine, name, plain)
    before = dict(sync_kernels.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gfsk_engine.sync_candidates(*chip_smoke.tie_case(js8.SPEC, dev))
    assert sync_kernels.launches == before


def test_sync_launch_refused_raises_on_card(dev, monkeypatch):
    """A launch the library refuses (a selection k above the scores a
    window, an odd os_t for the score, both past the wrappers' own checks)
    raises naming the kernel; the plain versions never run and nothing
    counts."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for name in ("sync_candidates_plain", "sync_score_plain",
                 "sync_select_plain", "sync_refine_plain"):
        monkeypatch.setattr(gfsk_engine, name, plain)
    spec, ps, _, base, _, _ = chip_smoke.tie_case(js8.SPEC, dev)
    score = torch.zeros((2, 4, 5), dtype=torch.float32, device=dev)
    before = dict(sync_kernels.launches)
    with pytest.raises(RuntimeError, match="sync_select kernel launch"):
        sync_kernels._select_launch(spec, score, score, 2, 20, 5)
    b, h, f = ps.shape
    n_t0, n_f0 = sync_kernels.grid(spec)
    with pytest.raises(RuntimeError, match="sync_score kernel launch"):
        sync_kernels._score_launch(dataclasses.replace(spec, os_t=3), ps,
                                   base, b, h, f, n_t0, n_f0)
    torch.cuda.synchronize()
    assert sync_kernels.launches == before


def test_sync_kernels_do_not_spill_on_card(dev):
    """The selection, the score (each instance the GFSK modes run) and the
    refinement (its 16- and 21-cell instances and the generic one) keep
    every value in registers: no local memory a thread.  At FT8's grid the
    selection runs 16-block clusters where the card holds one, else 8, and
    forced to 8 it cuts each map into 57,376 keys a block, 53,976 of them
    on chip."""
    attrs = sync_kernels.kernel_attrs(dev)
    assert attrs["sync_select"]["local_bytes"] == 0, attrs
    for n_cells in (16, 21, 40):
        got = sync_kernels.kernel_attrs(dev, n_cells)
        assert got["sync_score"]["local_bytes"] == 0, (n_cells, got)
        assert got["sync_refine"]["local_bytes"] == 0, (n_cells, got)
    plan = sync_kernels.select_plan(ft8.SPEC, 24, dev)
    fits16 = sync_kernels.select_plan(ft8.SPEC, 24, dev, cluster=16)
    assert plan["cluster"] == (
        16 if fits16["max_active_clusters"] >= 1 else 8), (plan, fits16)
    assert plan["max_active_clusters"] >= 1 and plan["threads"] == 1024
    plan8 = sync_kernels.select_plan(ft8.SPEC, 24, dev, cluster=8)
    assert (plan8["cluster"], plan8["keys_a_block"],
            plan8["keys_on_chip"]) == (8, 57_376, 53_976), plan8
    assert plan8["max_active_clusters"] >= 1


@pytest.mark.parametrize("top_k", [512, 32768])
def test_sync_select_eight_block_clusters_match_plain_on_card(dev, top_k):
    """The selection forced to 8-block clusters (the plan of a card that
    holds no 16-block cluster: at FT8's grid part of each slice stays in
    HBM and is read again each pass) at FT8's pass-1 shape, 24 windows,
    at top_k 512 and 32768: top_val bit for bit, indices and tt identical
    to the plain version on CPU copies, and to the wrapper's own plan.  A
    cluster of other than 8 or 16 blocks raises before any launch."""
    spec = dataclasses.replace(ft8.SPEC, top_k=top_k)
    args = _sync_noise_case(spec, 19, dev, 24)
    before = dict(sync_kernels.launches)
    got = chip_smoke.sync_vs_plain(*args, cluster=8)
    torch.cuda.synchronize()
    assert got["ok"] and got["cluster"] == 8, got
    assert sync_kernels.launches["sync_select"] == before["sync_select"] + 2
    score = torch.zeros((24,) + sync_kernels.grid(spec),
                        dtype=torch.float32, device=dev)
    before = dict(sync_kernels.launches)
    for bad in (4, 32, 0):
        with pytest.raises(ValueError, match="8 or 16"):
            sync_kernels.sync_select(spec, score, score, cluster=bad)
    assert sync_kernels.launches == before


def test_decoders_launch_the_sync_kernels_on_card(dev):
    """An FT8 decode on the card at depth 2 runs each sync kernel once a
    pass; FST4-60 runs the score and the selection, not the refinement; a
    WSPR decode runs none."""
    rng = np.random.default_rng(14)
    win = add_noise_at_snr(ft8.synthesize("CQ W2AXR FN13", 1200.0), -12.0,
                           12_000, rng).astype(np.float32)
    before = dict(sync_kernels.launches)
    res = ft8.FT8Decoder(device=dev).decode(
        torch.from_numpy(win[None]).to(dev), depth=2)
    torch.cuda.synchronize()
    assert [r.message for r in res[0]] == ["CQ W2AXR FN13"]
    assert sync_kernels.launches == {k: v + 2 for k, v in before.items()}
    win = add_noise_at_snr(fst4.synthesize("CQ F5ABC JN18", Mode.FST4_60,
                                           1000.0), -10.0, 12_000,
                           rng).astype(np.float32)
    before = dict(sync_kernels.launches)
    fst4.FST4Decoder(Mode.FST4_60, device=dev).decode(
        torch.from_numpy(win[None]).to(dev), depth=1)
    assert sync_kernels.launches == {**before,
                                     "sync_score": before["sync_score"] + 1,
                                     "sync_select": before["sync_select"] + 1}
    win = add_noise_at_snr(wspr.synthesize("K1ABC", "FN42", 37, 1500.0),
                           -20.0, 12_000, rng).astype(np.float32)
    before = dict(sync_kernels.launches)
    wspr.WSPRDecoder(device=dev).decode(torch.from_numpy(win[None]).to(dev))
    assert sync_kernels.launches == before


def test_one_decode_at_a_time_on_the_card(dev):
    """4 pool workers, 8 FT8 jobs on ``cuda:0``: never two decodes in the
    decoder's device call at once, every job decoded with its message."""
    got = pool_run(dev)
    assert got["decoded"] == 8 and got["calls"] == 8 and got["most"] == 1
    assert got["found"] == ["K1ABC W9XYZ EN37"] * 8
    assert got["lock_wait_s"] > 0.1


@pytest.mark.parametrize("path", [p.name for p, _ in fixtures(AP_FIXTURES)])
def test_ap_fixture_on_card_matches_cpu(dev, path):
    """A live FT8 window that gave a false AP spot, decoded alone with the
    live decoder's kwargs: the same messages on the card as on the CPU,
    and the JAX package's (stored beside it)."""
    side = dict(fixtures(AP_FIXTURES))[AP_FIXTURES / path]
    audio = np.load(AP_FIXTURES / path)
    got = decode_window(audio, side, dev)
    assert got == decode_window(audio, side, torch.device("cpu"))
    assert got == side["jax"]


@pytest.mark.parametrize("path", [p.name for p, _ in fixtures(FALSE_SPOTS)])
def test_false_spot_fixture_on_card_matches_cpu(dev, path):
    """A live FT8 window with a CQ-form or no-AP-form false spot: the same
    messages on the card as on the CPU and in the JAX package."""
    side = dict(fixtures(FALSE_SPOTS))[FALSE_SPOTS / path]
    audio = np.load(FALSE_SPOTS / path)
    got = decode_window(audio, side, dev)
    assert got == decode_window(audio, side, torch.device("cpu"))
    assert got == side["jax"] == side["false"]


def test_ft8_decoder_on_card_matches_cpu(dev):
    """The same windows through the port's decoder on CUDA and on CPU
    tensors: the same messages, SNR within 0.5 dB, frequency within one
    bin, dt within one hop (bf16 sync ties may order candidates
    differently on the two devices)."""
    rng = np.random.default_rng(5)
    wins = np.zeros((2, 180_000), np.float32)
    for w, sigs in enumerate([[("CQ W2AXR FN13", 700.0, 1.0, 0.5),
                               ("K1ABC W9XYZ -15", 1500.0, 0.4, 0.9)],
                              [("G4ABC K1ABC RR73", 2100.0, 0.3, 0.2)]]):
        for text, f0, amp, start in sigs:
            wins[w] += ft8.synthesize(text, f0, amplitude=amp, start_s=start)
        wins[w] += 0.3 * rng.standard_normal(180_000).astype(np.float32)
    kw = dict(my_call="W2AXR", depth=3)
    got = ft8.FT8Decoder(device=dev, **kw).decode(
        torch.from_numpy(wins).to(dev))
    want = ft8.FT8Decoder(device="cpu", **kw).decode(torch.from_numpy(wins))
    assert sum(len(w) for w in want) >= 3
    assert_same_batch_decodes(got, want)


def test_gfsk_modes_on_card_match_cpu(dev):
    """FT4 (refine branch), JS8 (its own LDPC(174,87)) and FST4-60 (fused
    DFT branch, coh4, sync-pair correction) on CUDA and on CPU tensors:
    the same decode lists within the tolerances above."""
    rng = np.random.default_rng(9)
    cases = [
        (lambda d: ft4.FT4Decoder(depth=3, device=d),
         ft4.synthesize("CQ W2AXR FN13", 900.0)
         + 0.5 * ft4.synthesize("K1ABC W9XYZ EN37", 1800.0, start_s=0.8),
         -12.0),
        (lambda d: js8.JS8Decoder(device=d),
         js8.synthesize("KN4CRD: HB EN50", 1100.0)
         + 0.6 * js8.synthesize("HELLO WORLD", 2000.0, start_s=1.0), -14.0),
        (lambda d: fst4.FST4Decoder(Mode.FST4_60, device=d),
         fst4.synthesize("K1ABC W9XYZ -15", Mode.FST4_60, 1000.0), -18.0),
    ]
    for make, clean, snr in cases:
        wins = np.stack([add_noise_at_snr(clean, snr, 12_000, rng)
                         for _ in range(2)]).astype(np.float32)
        card, host = make(dev), make("cpu")
        got = card.decode(torch.from_numpy(wins).to(dev))
        want = host.decode(torch.from_numpy(wins))
        assert sum(len(w) for w in want) >= 2, card.spec.name
        assert_same_batch_decodes(got, want, card.spec)


def test_weak_modes_on_card_match_cpu(dev):
    """WSPR (beam search, DD passes, OSD), JT65 (rfft branch and DFT
    branch, RS Chase with the reference's random patterns) and Q65-30
    (GF(64) message passing) on CUDA and on CPU tensors: the same decode
    lists within the tolerances above."""
    rng = np.random.default_rng(65)
    cases = [
        (lambda d: wspr.WSPRDecoder(device=d),
         wspr.synthesize("K1ABC", "FN42", 37, 1460.0)
         + wspr.synthesize("W2AXR", "FN13", 30, 1540.0), -24.0,
         WSPRTolerance),
        (lambda d: jt65.JT65Decoder(device=d),
         jt65.synthesize("K1ABC W9XYZ EN37", 1270.5)
         + jt65.synthesize("CQ W2AXR FN13", 800.0, start_s=1.5), -18.0,
         jt65.SPEC),
        (lambda d: jt65.JT65Decoder(fmax_hz=3000.0, device=d),
         jt65.synthesize("CQ W2AXR FN13", 2400.0), -18.0, jt65.SPEC),
        (lambda d: q65.Q65Decoder(device=d),
         q65.synthesize("CQ W2AXR FN13", 1200.0), -20.0, q65.SPEC),
    ]
    for make, clean, snr, tol in cases:
        wins = np.stack([add_noise_at_snr(clean, snr, 12_000, rng)
                         for _ in range(2)]).astype(np.float32)
        card, host = make(dev), make("cpu")
        got = card.decode(torch.from_numpy(wins).to(dev))
        want = host.decode(torch.from_numpy(wins))
        assert sum(len(w) for w in want) >= 2, type(card).__name__
        assert_same_batch_decodes(got, want, tol)


# (a0, n_out): blocks that start at no multiple of the 4096-sample
# sub-block, lengths that are no multiple of the kernel's 48-output tile,
# and starts up to 900 s x 192 kHz into a window
SHARD_BLOCKS = [(3 * 43_200_000 - 496, 1001), (43_200_000 - 496, 4097),
                (172_800_000 - 496 - 16 * 333, 333), (12_345 * 16 - 496, 47),
                (-496, 96)]


@pytest.mark.parametrize("n_ch", [4, 16])
def test_cuda_kernel_at_time_shard_offsets(dev, n_ch):
    """channelize_block at time-shard offsets and lengths, through the
    kernel and through the plain version on the same CUDA inputs: atol
    1e-4 (as above)."""
    from cwsl_digi_tpu_torch.dsp.channelizer import channelize_block_ref

    chan = BatchChannelizer(192_000, np.linspace(-90_000, 84_000, n_ch),
                            device=dev)
    bs = chan.spec.block_size
    h = chan.spec.filt_order - bs
    before = _kernels.launches["channelize"]
    for i, (a0, n_out) in enumerate(SHARD_BLOCKS):
        x = torch.from_numpy(_iq(h + n_out * bs, seed=i)).to(dev)
        ph = ((a0 + h) // bs) % 4
        n_sub = -(-x.shape[0] // chan._sub)
        want = channelize_block_ref(chan.spec, x, chan._tone_sub,
                                    chan._rotations(a0, chan._sub, n_sub),
                                    chan._segs, ph)
        torch.testing.assert_close(chan.channelize_block(x, a0, ph), want,
                                   rtol=0, atol=1e-4)
    torch.cuda.synchronize()
    assert _kernels.launches["channelize"] == before + len(SHARD_BLOCKS)


def test_time_shards_on_card_match_cpu(dev):
    """A window time-sharded over a virtual 4-entry mesh of the card
    equals the same shards on the CPU (atol 1e-4), one launch a shard."""
    freqs = [5_000.0, -9_000.0, 12_000.0]
    iq = _iq(4 * 4 * 3000, seed=11)
    before = _kernels.launches["channelize"]
    card = TimeShardedChannelizer(48_000, freqs, make_mesh(
        4, axes=("t",), devices=[dev] * 4)).channelize(iq)
    assert _kernels.launches["channelize"] == before + 4
    host = TimeShardedChannelizer(48_000, freqs, make_mesh(
        4, axes=("t",), devices=["cpu"] * 4)).channelize(iq)
    torch.testing.assert_close(card.cpu(), host, rtol=0, atol=1e-4)


def test_sharded_skim_on_card_matches_cpu(dev):
    """The channel-sharded skim on a virtual 4-entry mesh of the card and
    on one of the CPU (tests/test_parallel.py's window): the same decode
    lists within the tolerances above, one launch an entry."""
    fs = 48_000
    freqs = np.linspace(-18_000, 10_000, 8)
    burst = gfsk_modulate_iq(ft8.encode_message("CQ W2AXR FN13"),
                             freqs[5] + 1500.0, ft8.SPS * fs // 12_000, fs,
                             ft8.TONE_SPACING)
    iq = np.zeros(15 * fs, np.complex128)
    iq[fs // 2 : fs // 2 + len(burst)] = burst
    rng = np.random.default_rng(3)
    iq += 0.02 * (rng.standard_normal(len(iq))
                  + 1j * rng.standard_normal(len(iq)))
    iq = iq.astype(np.complex64)
    results = {}
    for d in (dev, "cpu"):
        step = ShardedSkimStep(
            fs, freqs, make_mesh(4, devices=[d] * 4),
            decoder=ft8.FT8Decoder(top_k=16, bp_iters=20, device=d))
        before = _kernels.launches["channelize"]
        results[d] = step.decode_window(iq)
        if d == dev:
            assert _kernels.launches["channelize"] == before + 4
    assert [r.message for r in results[dev][5]] == ["CQ W2AXR FN13"]
    assert_same_batch_decodes(results[dev], results["cpu"])


def test_window_client_sends_a_card_window(dev):
    """WindowClient.send of a job whose audio is a CUDA tensor (as the
    port's receiver hands windows to the pool): the server receives the
    same samples as a host array."""
    import time

    from cwsl_digi_tpu_torch.parallel.cluster import WindowClient, WindowServer
    from cwsl_digi_tpu_torch.runtime.decoderpool import DecodeJob

    class Pool:
        def __init__(self):
            self.jobs = []

        def push(self, job):
            self.jobs.append(job)

    audio = np.random.default_rng(2).standard_normal((2, 3000)).astype(
        np.float32)
    pool = Pool()
    server = WindowServer(0, pool, host="127.0.0.1")
    try:
        client = WindowClient("127.0.0.1", server.port)
        client.send(DecodeJob(mode=Mode.FT8,
                              audio=torch.from_numpy(audio).to(dev),
                              base_freqs=[14_074_000] * 2,
                              decoder_indices=[0, 1], epoch_time=0))
        deadline = time.monotonic() + 5
        while not pool.jobs and time.monotonic() < deadline:
            time.sleep(0.02)
        client.close()
    finally:
        server.close()
    assert len(pool.jobs) == 1
    np.testing.assert_array_equal(pool.jobs[0].audio, audio)
