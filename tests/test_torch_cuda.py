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
a launch; no spills), the weak modes' kernels ``wspr_beam`` (at widths 32
to 1024 in every plan, its shared memory and blocks an SM included, on
noise, ties and NaN)
and ``rs_ee`` (through both entries, with more than 51 erasures and with
more trials than the card's resident warps) against their plain versions (and no fallback;
no spills; the WSPR and JT65 decoders launch them), the q-ary kernels
``qra_mp`` (Q65 priors with converging and noise words), ``median_rows``
(every edge row in every plan, FT8's strided view, a JT65-sized map) and
``qary_sync`` (JT65 and Q65 maps with planted ties, NaN scores and a NaN
base) against their plain versions
and the NumPy models of ``tests/test_torch_qary_kernels.py`` (and no
fallback; no spills; the JT65, Q65-30, WSPR and FT8 decoders launch
them), the q-ary decode's ``qary_symbols``, ``chase_erasures`` and
``chase_score`` against their plain versions on a JT65 and a Q65-30
decode's inputs and planted edges (and no fallback; no spills), and the
parallel layer on a virtual mesh of the card against one
on the CPU, and its worker processes (two on the card, one on every card
where there are several) against the skim in one process.

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
from cwsl_digi_tpu_torch.modes import _chase_kernels as chase_kernels
from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gfsk_kernels
from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels
from cwsl_digi_tpu_torch.modes import _median_kernels as median_kernels
from cwsl_digi_tpu_torch.modes import _qary_kernels as qary_kernels
from cwsl_digi_tpu_torch.modes import _sync_kernels as sync_kernels
from cwsl_digi_tpu_torch.modes import _weak_kernels as weak_kernels
from cwsl_digi_tpu_torch.modes import (fst4, ft4, ft8, gfsk_engine, js8,
                                       jt65, ldpc, osd, q65, qary_engine,
                                       rs64, rs_device, subtract, wspr)
from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr, gfsk_modulate_iq
from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer
import test_torch_qary_kernels as qary_models
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


def _beam_noise(n: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (2.0 * rng.standard_normal((n, 81, 2))).astype(np.float32)).to(dev)


@pytest.mark.parametrize("w", [32, 256, 512, 1024])
def test_wspr_beam_matches_plain_on_card(dev, w):
    """wspr_beam against the plain beam search on the same CUDA LLRs, at
    every beam width the decoders run (1024 is the cycles >= 10000 width)
    and at 32, in the wrapper's plan and in every other plan of the width
    (``chip_smoke.beam_vs_plain``): noise, LLRs built to tie (integers,
    zeros, a zero tail) and a candidate with a NaN LLR; bits identical,
    the metric bit for bit (NaN as NaN), and the bits also the plain
    version's on CPU copies."""
    cfg = wspr.WSPRConfig(beam_width=w)
    llr = torch.cat([_beam_noise(40, w, dev),
                     chip_smoke.beam_tie_llrs(24, w + 1, dev)])
    llr[-1, 30, 1] = float("nan")
    got = chip_smoke.beam_vs_plain(cfg, llr)
    torch.cuda.synchronize()
    assert got["ok"], got
    bits, _ = wspr._beam_decode(cfg, llr)
    cpu_bits, _ = wspr._beam_decode_plain(cfg, llr.cpu())
    assert torch.equal(bits.cpu(), cpu_bits)


def _rs_trials(dev, n_cand: int, seed: int):
    """JT65 codewords with 0 to 20 errors a candidate, as syms [C, 63]
    int64, and erasure flags [C, 8, 63]: 0, 0, 51, 51, 52, 60, 63 and 25
    erased positions a candidate."""
    rng = np.random.default_rng(seed)
    rs = rs64.RS63(12, fcr=3)
    syms = np.stack([rs.encode(rng.integers(0, 64, 12))
                     for _ in range(n_cand)])
    for r in syms:
        pos = rng.permutation(63)[:rng.integers(0, 21)]
        r[pos] ^= rng.integers(1, 64, len(pos))
    syms = torch.from_numpy(syms).to(dev)
    return syms, chip_smoke.rs_edge_trials(syms, seed)


@pytest.mark.parametrize("n_cand", [96, 2048])
def test_rs_ee_matches_plain_on_card(dev, n_cand):
    """rs_ee against the plain decode on the same CUDA trials, through the
    Chase program's entry and through rs_ee_decode: corrected words and
    ok identical, with more than 51 erasures in a third of the trials;
    at 16,384 trials the card's resident warps each loop over more than
    one trial."""
    syms, era = _rs_trials(dev, n_cand, 5)
    nk = (63, 12, 3)
    for public in (False, True):
        got = chip_smoke.rs_vs_plain(nk, syms, era, public)
        assert got["ok"] and got["over_nroots"] > 0, got
        assert 0 < got["ok_share"] < 1, got
    # the all-zero word, clean and with errors, under each pattern
    zero = torch.zeros((2, 63), dtype=torch.int64, device=dev)
    zero[1, [4, 30, 50]] = 7
    got = chip_smoke.rs_vs_plain(nk, zero, era[:2].clone())
    assert got["ok"], got
    torch.cuda.synchronize()


def test_weak_kernels_raise_without_library_on_card(dev, monkeypatch,
                                                    tmp_path):
    """With no nvcc and no built library, the beam search and the RS
    decode on CUDA tensors raise; the plain versions never run and
    nothing counts."""
    monkeypatch.setattr(weak_kernels, "_lib", None)
    monkeypatch.setattr(weak_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(weak_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(wspr, "_beam_decode_plain", plain)
    for name in ("rs_ee_decode_plain", "rs_ee_trials_plain"):
        monkeypatch.setattr(rs_device, name, plain)
    syms, era = _rs_trials(dev, 4, 6)
    before = dict(weak_kernels.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wspr._beam_decode(wspr.WSPRConfig(), _beam_noise(4, 1, dev))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rs_device.rs_ee_trials((63, 12, 3), syms, era)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rs_device.rs_ee_decode((63, 12, 3), syms, era[:, 0])
    assert weak_kernels.launches == before


def test_weak_kernels_do_not_spill_on_card(dev):
    """wspr_beam in every plan of every width and rs_ee keep every value
    in registers (rs_ee's tables and per-warp rows in 15,776 B of static
    shared memory, at least four blocks an SM); with the back-pointers gone from shared memory a block
    holds the survivors, the tails by rank and the sort's exchange
    buffers, 72 W + 648 bytes (74,376 at W = 1024), so an SM holds three
    width-1024 blocks and at least five width-512 ones in the plan of a
    launch that fills the card."""
    for w, plans in weak_kernels.BEAM_PLANS.items():
        for keys in plans:
            attrs = weak_kernels.kernel_attrs(dev, w, keys)
            assert attrs["wspr_beam"]["local_bytes"] == 0, (w, keys, attrs)
            assert attrs["rs_ee"]["local_bytes"] == 0, attrs
            smem = weak_kernels.beam_smem_bytes(w, keys)
            assert smem <= 72 * w + 648, (w, keys, smem)
    assert weak_kernels.beam_smem_bytes(1024, 4) == 74_376
    assert weak_kernels.beam_blocks_per_sm(dev, 1024, 4) >= 3
    assert weak_kernels.beam_blocks_per_sm(dev, 512, 4) >= 5
    # rs_ee: 15,776 B of tables and per-warp rows a block, at least four
    # blocks an SM
    assert attrs["rs_ee"]["static_smem_bytes"] == 15_776, attrs
    assert weak_kernels.rs_blocks_per_sm(dev) >= 4


def test_decoders_launch_the_weak_kernels_on_card(dev):
    """A WSPR decode of two windows runs wspr_beam once a pass (the first
    and the DD pass), a JT65 decode runs rs_ee once for its Chase
    program, and each decodes its message."""
    rng = np.random.default_rng(17)
    win = add_noise_at_snr(wspr.synthesize("K1ABC", "FN42", 37, 1500.0),
                           -20.0, 12_000, rng).astype(np.float32)
    before = dict(weak_kernels.launches)
    res = wspr.WSPRDecoder(device=dev).decode(
        torch.from_numpy(np.stack([win, win])).to(dev))
    torch.cuda.synchronize()
    assert [r.message for r in res[0]] == ["K1ABC FN42 37"]
    assert weak_kernels.launches == {**before,
                                     "wspr_beam": before["wspr_beam"] + 2}
    win = add_noise_at_snr(jt65.synthesize("CQ W2AXR FN13", 1270.0), -15.0,
                           12_000, rng).astype(np.float32)
    before = dict(weak_kernels.launches)
    res = jt65.JT65Decoder(device=dev).decode(
        torch.from_numpy(win[None]).to(dev))
    torch.cuda.synchronize()
    assert [r.message for r in res[0]] == ["CQ W2AXR FN13"]
    assert weak_kernels.launches == {**before, "rs_ee": before["rs_ee"] + 1}


def test_qra_mp_matches_plain_on_card(dev):
    """qra_mp against the plain decode on the same CUDA priors (a Q65
    decode's converging and noise words, tiled to 2,400 words): flags
    identical, the converging words' symbols identical and confidence
    within 1e-4; and bit for bit the NumPy model of its arithmetic
    (``tools/qra_mp_model.py``) on the first 40 words: symbols, flags and
    confidence."""
    pr = qary_models.q65_priors()
    dec = q65._mp(dev)
    probs = torch.from_numpy(np.tile(pr, (60, 1, 1))).to(dev)
    got = chip_smoke.mp_vs_plain(dec, probs, strict=True)
    torch.cuda.synchronize()
    assert got["ok"] and 0 < got["converged"] < got["words"], got
    hard, ok, conf = (x.cpu().numpy() for x in dec.decode(probs[:len(pr)]))
    m_hard, m_ok, m_conf = qary_models.mp_model(
        q65._mp(torch.device("cpu")), pr)
    np.testing.assert_array_equal(hard, m_hard)
    np.testing.assert_array_equal(ok, m_ok)
    np.testing.assert_array_equal(conf.view(np.uint32), m_conf.view(np.uint32))


def _median_plans(n: int) -> list[tuple[str | None, int]]:
    """Each (plan, cluster) the kernel can run rows of n in: the wrapper's
    own, one block where the row fits its shared memory, each cluster
    size that fits, the large plan above its sample."""
    mk = median_kernels
    plans: list[tuple[str | None, int]] = [(None, 0)]
    for c in (1, 2, 4, 8, 16):
        try:
            mk.median_plan(n, cluster=c)
        except ValueError:
            continue
        plans.append(("small" if c == 1 else "mid", c))
    if n > mk.SAMPLE:
        plans.append(("large", 0))
    return plans


@pytest.mark.parametrize("name", list(qary_models.median_rows_cases()))
def test_median_rows_matches_plain_on_card(dev, name):
    """median_rows bit for bit the plain median on the card and the NumPy
    model of its selection, on each edge case, in the plan the wrapper
    picks and in every other plan and cluster size that takes the row."""
    x = qary_models.median_rows_cases()[name]
    xd = torch.from_numpy(x).to(dev)
    got = chip_smoke.median_vs_plain(xd)
    assert got["ok"], got
    kern = gfsk_engine._median_rows(xd).cpu()
    model = qary_models.median_model(x)
    assert ((kern.numpy().view(np.uint32) == model.view(np.uint32))
            | (np.isnan(model) & kern.isnan().numpy())).all()
    want = gfsk_engine._median_rows_plain(xd)
    for plan, cluster in _median_plans(x.shape[1]):
        out = median_kernels.median_rows(xd, plan=plan, cluster=cluster)
        assert chip_smoke._floats_differ(out, want) == 0, (plan, cluster)


def test_median_rows_takes_the_strided_view_on_card(dev, monkeypatch):
    """FT8's SNR median hands the kernel the ``[:, ::4, ::4]`` view of its
    power map as it lies (no copy; the mid plan) and gets the plain
    median's bits, at the decoder's row length and at a few windows."""
    seen = []
    launch = median_kernels.median_rows

    def spy(x, *args, **kwargs):
        seen.append((x.is_contiguous(), tuple(x.shape)))
        return launch(x, *args, **kwargs)

    monkeypatch.setattr(median_kernels, "median_rows", spy)
    m = torch.from_numpy(qary_models.ft8_view_map()).to(dev)
    for b in (1, 2):
        view = m[:b, ::4, ::4]
        got = chip_smoke.median_vs_plain(view)
        assert got["ok"], got
    assert seen == [(False, (1, 186, 457)), (False, (2, 186, 457))]
    want = gfsk_engine._median_rows_plain(m[:, ::4, ::4].contiguous())
    for cluster in (2, 4, 8, 16):
        out = launch(m[:, ::4, ::4], plan="mid", cluster=cluster)
        assert chip_smoke._floats_differ(out, want) == 0, cluster
    got = chip_smoke.median_vs_plain(m.transpose(1, 2)[:, ::3, ::5])
    assert got["ok"], got


def test_median_rows_on_a_jt65_map_on_card(dev):
    """A JT65 device batch's worth of sync map (15 windows of 1411 x 2645
    with the zero pad rows), many blocks a row: bit for bit the plain
    median."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.empty((15, 1411, 2645), device=dev).exponential_(generator=g)
    x[:, :64] = 0.0
    x[:, -64:] = 0.0
    got = chip_smoke.median_vs_plain(x.reshape(15, -1))
    assert got["ok"], got


@pytest.mark.parametrize("mode", ["JT65", "Q65-30"])
def test_qary_sync_matches_plain_on_card(dev, mode):
    """qary_sync against the plain selection on the card and the NumPy
    model, on maps with planted ties in two strips, NaN scores under a
    finite base and a NaN base: top_val bit for bit, top_idx identical;
    also at top_k 1 and 256; one launch a call."""
    spec = jt65.SPEC if mode == "JT65" else q65.SPEC
    ps, base = qary_models.planted_map(spec)
    psd = torch.from_numpy(ps).to(dev)
    based = torch.from_numpy(base).to(dev)
    for k in (spec.top_k, 1, 256):
        sp = dataclasses.replace(spec, top_k=k)
        got = chip_smoke.qsync_vs_plain(sp, psd, based)
        assert got["ok"], got
    val, idx = qary_engine._qary_sync(spec, psd, based)
    m_val, m_idx = qary_models.sync_model(spec, ps, base)
    assert (idx.cpu().numpy() == m_idx).all()
    assert ((val.cpu().numpy().view(np.uint32) == m_val.view(np.uint32))
            | np.isnan(m_val)).all()


@pytest.mark.parametrize("name", list(qary_models.sync_edge_cases()))
def test_qary_sync_edge_cases_on_card(dev, name):
    """qary_sync against the plain selection on each of the model's edges
    (ties across strips and warps, every score equal, n_f0 either side of a
    strip's width, top-K 1 and 256, 50 time offsets, one sync symbol, gaps
    past the look-ahead and the ring, hops not congruent mod 8): bit for
    bit, and the same twice (the window counters reset)."""
    spec, ps, base = qary_models.sync_edge_cases()[name]
    psd = torch.from_numpy(ps).to(dev)
    based = torch.from_numpy(base).to(dev)
    for _ in range(2):
        got = chip_smoke.qsync_vs_plain(spec, psd, based)
        assert got["ok"], got
    torch.cuda.synchronize()


def test_qary_kernels_raise_without_library_on_card(dev, monkeypatch,
                                                    tmp_path):
    """With no nvcc and no built library, the message passing, the median
    and the sync selection on CUDA tensors raise; the plain versions
    never run and nothing counts."""
    dec = q65._mp(dev)
    for mod in (qary_kernels, median_kernels):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(qary_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(type(dec), "decode_plain", plain)
    monkeypatch.setattr(gfsk_engine, "_median_rows_plain", plain)
    monkeypatch.setattr(qary_engine, "_qary_sync_plain", plain)
    before = {**qary_kernels.launches, **median_kernels.launches}
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dec.decode(torch.full((2, 63, 64), 1 / 64, device=dev))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gfsk_engine._median_rows(torch.zeros((2, 5, 7), device=dev))
    ps = torch.zeros((1, 921, 2420), device=dev)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qary_engine._qary_sync(q65.SPEC, ps, torch.ones((1, 1, 1),
                                                        device=dev))
    assert {**qary_kernels.launches, **median_kernels.launches} == before


def test_qary_kernels_do_not_spill_on_card(dev):
    """qra_mp, median_rows (each plan's kernels), qary_sync and
    qary_symbols keep every value in registers; a qary_sync block at top-24 takes 53,536 B of
    dynamic shared memory (its warps' rings) and an SM holds four;
    Q65's code, whose 152 edges' messages and channel rows take 55,040 B
    of shared memory a word, holds the design's MP_BLOCKS_SM (4) qra_mp
    blocks of 8 warps an SM."""
    attrs = {**qary_kernels.kernel_attrs(dev),
             **median_kernels.kernel_attrs(dev)}
    assert sorted(attrs) == ["median_rows", "qary_symbols", "qary_sync",
                             "qra_mp"]
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, attrs)
    plans = median_kernels.instance_attrs(dev)
    assert sorted(plans) == sorted(median_kernels.KERNELS)
    for name, a in plans.items():
        assert a["local_bytes"] == 0, (name, plans)
    dec = q65._mp(dev)
    edges = int(dec._host_tables()["row_mask"].sum())
    assert qary_kernels.mp_smem_bytes(63, edges) == 55_040
    assert qary_kernels.MP_BLOCKS_SM == 4
    assert qary_kernels.mp_blocks_per_sm(dev, dec.kernel_code, edges) \
        >= qary_kernels.MP_BLOCKS_SM, attrs
    occ = qary_kernels.sync_occupancy(dev, 24, 75)
    assert occ["dynamic_smem_bytes"] == 53_536, occ
    assert occ["blocks_an_sm"] >= 4, occ


def test_decoders_launch_the_qary_kernels_on_card(dev):
    """A JT65 decode runs qary_sync, qary_symbols, median_rows,
    chase_erasures and chase_score once each, a Q65-30 decode qary_sync
    and qary_symbols once, median_rows twice (the SNR and the priors) and
    qra_mp once and no Chase kernel, a WSPR and an FT8 decode median_rows;
    each decodes its message."""
    rng = np.random.default_rng(18)
    cases = [
        (jt65.JT65Decoder(device=dev), jt65.synthesize("CQ W2AXR FN13",
                                                       1270.0), -15.0,
         "CQ W2AXR FN13", {"qary_sync": 1, "median_rows": 1, "qra_mp": 0,
                           "qary_symbols": 1, "chase_erasures": 1,
                           "chase_score": 1}),
        (q65.Q65Decoder(device=dev), q65.synthesize("CQ W2AXR FN13",
                                                    1200.0), -15.0,
         "CQ W2AXR FN13", {"qary_sync": 1, "median_rows": 2, "qra_mp": 1,
                           "qary_symbols": 1, "chase_erasures": 0,
                           "chase_score": 0}),
        (wspr.WSPRDecoder(device=dev), wspr.synthesize("K1ABC", "FN42", 37,
                                                       1500.0), -20.0,
         "K1ABC FN42 37", None),
        (ft8.FT8Decoder(device=dev), ft8.synthesize("CQ K1ABC FN42",
                                                    1000.0), -10.0,
         "CQ K1ABC FN42", None)]
    for dec, clean, snr, msg, want in cases:
        win = add_noise_at_snr(clean, snr, 12_000, rng).astype(np.float32)
        before = {**qary_kernels.launches, **median_kernels.launches,
                  **chase_kernels.launches}
        res = dec.decode(torch.from_numpy(win[None]).to(dev))
        torch.cuda.synchronize()
        assert msg in [r.message for r in res[0]], type(dec).__name__
        after = {**qary_kernels.launches, **median_kernels.launches,
                 **chase_kernels.launches}
        counts = {k: after[k] - before[k] for k in before}
        if want is None:
            assert counts["median_rows"] >= 1 and counts["qra_mp"] == 0, \
                counts
            assert counts["qary_symbols"] == counts["chase_score"] == 0, \
                counts
        else:
            assert counts == want, (type(dec).__name__, counts)


@pytest.fixture(scope="module")
def decode_inputs():
    """The last three q-ary kernels' inputs of a 4-window JT65 and Q65-30
    decode of the weak replay's bursts (``chip_smoke``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return chip_smoke.record_decode_inputs(torch.device("cuda", 0), 4)


def test_qary_symbols_matches_plain_on_card(dev, decode_inputs):
    """qary_symbols against the plain gather and top-4 on each recorded
    JT65 and Q65-30 map and on planted rows (two best tones tied, a flat
    row, NaN and +inf): e, top_e, top_tone, e_sum and margin bit for bit,
    and all but the margin bit for bit the plain version on CPU copies."""
    for mode, spec, power, t0, f0, ds in decode_inputs["symbols"]:
        got = chip_smoke.symbols_vs_plain(spec, power, t0, f0, ds)
        assert got["ok"] and got["full_e"] == (mode == "Q65-30"), got
        got = chip_smoke.symbols_vs_plain(
            spec, chip_smoke.planted_symbols(spec, power, t0, f0), t0, f0,
            ds)
        assert got["ok"] and got["tied_best_two"] >= 2 * len(t0), got
    torch.cuda.synchronize()


def test_chase_kernels_match_plain_on_card(dev, decode_inputs):
    """chase_erasures bit for bit the plain flags (on the card and on CPU
    copies), at the decode's chunk and with planted margins past 2**32
    draws; chase_score's info and ok identical and its score within 1e-5
    of the plain version's, also with every trial duplicated."""
    for args in decode_inputs["erasures"]:
        got = chip_smoke.erasures_vs_plain(args)
        assert got["ok"] and 0.3 < got["erased_share"] < 0.9, got
        got = chip_smoke.erasures_vs_plain(chip_smoke.planted_chase(args))
        assert got["ok"], got
    for args in decode_inputs["score"]:
        got = chip_smoke.score_vs_plain(args)
        assert got["ok"] and got["ok_count"] > 0, got
        got = chip_smoke.score_vs_plain(chip_smoke.duplicate_trials(args))
        assert got["ok"], got
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_trials,shift", [(37, 1), (256, 1), (37, 0),
                                            (9, 3)])
def test_chase_score_byte_copies_match_plain_on_card(dev, decode_inputs,
                                                     n_trials, shift):
    """chase_score where its slabs are not 16-byte aligned (a candidate's
    T x n bytes or the bases), so the block copies them byte by byte: the
    same contract against the plain version as the TMA path's."""
    args = chip_smoke.unaligned_trials(decode_inputs["score"][0], n_trials,
                                       shift)
    assert not chase_kernels.score_bulk(args[2], args[4])
    got = chip_smoke.score_vs_plain(args)
    assert got["ok"], got
    torch.cuda.synchronize()


def test_qary_decode_kernels_raise_without_library_on_card(dev, monkeypatch,
                                                           tmp_path):
    """With no nvcc and no built library, the tone gather and the Chase
    stages on CUDA tensors raise; the plain versions never run and nothing
    counts."""
    for mod in (qary_kernels, chase_kernels):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(qary_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(qary_engine, "_symbol_energies_plain", plain)
    for name in ("chase_erasures_plain", "chase_score_plain"):
        monkeypatch.setattr(rs_device, name, plain)
    before = {**qary_kernels.launches, **chase_kernels.launches}
    spec = jt65.SPEC
    power = torch.zeros((1, 1411, 2645), device=dev)
    t0 = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    ds = torch.tensor(spec.data_syms, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qary_engine._symbol_energies(spec, power, t0, t0, ds)
    margin = torch.zeros((2, 63), device=dev)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rs_device.chase_erasures(51, 256, 6, margin, 5)
    c = torch.zeros((2, 8, 63), dtype=torch.uint8, device=dev)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rs_device.chase_score(
            12, 0.4, c, torch.ones((2, 8), dtype=torch.bool, device=dev),
            c.bool(), torch.ones((2, 63, 4), device=dev),
            torch.zeros((2, 63, 4), dtype=torch.int64, device=dev),
            torch.ones((2, 63), device=dev))
    assert {**qary_kernels.launches, **chase_kernels.launches} == before


def test_qary_decode_kernels_do_not_spill_on_card(dev):
    """qary_symbols, chase_erasures (its tiers through shared memory, not a
    parameter array indexed at run time) and chase_score keep every value
    in registers, in under 6 KB of static shared memory; chase_score's ring
    and its tables take at most 27 KB of dynamic shared memory, 8 blocks
    an SM or more; qary_symbols' grid takes JT65's batch in one wave."""
    attrs = {**chase_kernels.kernel_attrs(dev),
             "qary_symbols": qary_kernels.kernel_attrs(dev)["qary_symbols"]}
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, attrs)
        assert a["static_smem_bytes"] < 6 * 1024, (name, attrs)
    # chase_score's ring of trial stages and its symbols' tables: 8 blocks
    # an SM or more, so a 1,024-candidate chunk runs in one wave on 132 SMs
    design = chase_kernels.score_design(dev, 256, 63)
    assert design["dynamic_smem_bytes"] <= 27 * 1024, design
    assert design["blocks_an_sm"] >= 8, design
    # qary_symbols: JT65's 15-window batch (22,680 rows) in one wave
    sym = qary_kernels.symbols_design(dev)
    assert sym["rows_a_warp"] == 32 // qary_kernels.SYM_GROUP, sym
    assert sym["grid_cap"] * 8 * sym["rows_a_warp"] >= 22_680, sym


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


def _skim_iq() -> tuple[int, np.ndarray, np.ndarray]:
    """tests/test_parallel.py's window: 8 channels at 48 kHz, one FT8
    burst at 1.5 kHz in channel 5."""
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
    return fs, freqs, iq.astype(np.complex64)


def test_sharded_skim_on_card_matches_cpu(dev):
    """The channel-sharded skim on a virtual 4-entry mesh of the card and
    on one of the CPU (tests/test_parallel.py's window): the same decode
    lists within the tolerances above, one launch an entry."""
    fs, freqs, iq = _skim_iq()
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


def _skim_decoder(d) -> ft8.FT8Decoder:
    return ft8.FT8Decoder(top_k=16, bp_iters=20, device=d)


def test_worker_skim_on_card_matches_in_process(dev):
    """The skim's worker code in two worker processes on the card
    (``chip_smoke.WorkerSkim``), a position each: every array bit for bit
    the same 2-entry mesh's in this process, the workers' kernel launches
    that skim's (one channelizer launch a worker), and the decodes those
    of the 1-entry mesh (valid and payload identical, SNR, f and dt within
    the tolerances above)."""
    fs, freqs, iq = _skim_iq()
    spec = _skim_decoder(dev).spec
    stepw = chip_smoke.WorkerSkim(dev, 2, fs, freqs, spec, len(iq))
    try:
        assert stepw.pool.devices == [dev, dev]
        got = stepw.step(iq)
    finally:
        stepw.pool.close()
    before = chip_smoke._launch_totals()
    want = ShardedSkimStep(fs, freqs, make_mesh(2, devices=[dev] * 2),
                           decoder=_skim_decoder(dev)).step(iq)
    torch.cuda.synchronize()
    after = chip_smoke._launch_totals()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the launches each side made (the workers count only the skim's
    # libraries; this process counts every library)
    assert {k: n for k, n in stepw.launches.items() if n} == \
        {k: after[k] - before[k] for k in after if after[k] > before[k]}
    assert stepw.launches["channelize"] == 2
    one = ShardedSkimStep(fs, freqs, make_mesh(1, devices=[dev]),
                          decoder=_skim_decoder(dev)).step(iq)
    assert chip_smoke.same_decodes(got, one)
    assert [r.message for r in ft8.results_from_arrays(got)[5]] == \
        ["CQ W2AXR FN13"]


def test_worker_skim_on_every_card(dev):
    """On every visible card (two or more), one process: the skim takes a
    worker process a card, and its decodes are those of the 1-entry
    mesh."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    fs, freqs, iq = _skim_iq()
    step = ShardedSkimStep(fs, freqs, make_mesh(n),
                           decoder=_skim_decoder(dev))
    try:
        assert step.workers is not None
        assert step.workers.devices == [torch.device("cuda", i)
                                        for i in range(n)]
        got = step.step(iq)
    finally:
        step.close()
    one = ShardedSkimStep(fs, freqs, make_mesh(1, devices=[dev]),
                          decoder=_skim_decoder(dev)).step(iq)
    assert chip_smoke.same_decodes(got, one)
    assert [r.message for r in ft8.results_from_arrays(got)[5]] == \
        ["CQ W2AXR FN13"]


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
