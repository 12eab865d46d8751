"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, and fails without CUDA;
2. builds the port's four kernel libraries from ``cwsl_digi_tpu_torch``,
   one nvcc each, started together: the channelizer
   (``dsp/csrc/channelizer.cu``), the LDPC kernels ``bp_minsum`` and
   ``osd`` (``modes/csrc/ldpc.cu``), the GFSK kernels
   ``subtract_known`` and ``multisym_llrs`` (``modes/csrc/gfsk.cu``) and
   the sync-search kernels ``sync_score``, ``sync_select`` and
   ``sync_refine`` (``modes/csrc/sync.cu``), printing each ptxas report;
3. holds the channelizer kernel against its plain PyTorch version on the
   card, at the FT8 path's 64 dials, the mixed-mode path's 5 lines, the
   weak-mode path's 3 lines and the bench's 256 channels (192 kHz, 15 s
   of seeded IQ in the receiver's 0.25 s chunks, plus one whole-window
   call), and times one chunk in turns through the kernel, the plain
   version and one library call (a cuBLAS complex GEMM of the same taps
   and IQ), beside the bound of the function's arithmetic; the
   ``kernels`` line gives the main path's 64-channel numbers, the line
   before it the 256-channel ones;
4. holds ``bp_minsum`` and ``osd`` against their plain versions (phase
   ``ldpc_kernels``): at the FT8 main path's first-pass shapes on the
   inputs its decode hands them (24 busy windows with 3 AP hypotheses:
   36,864 BP words, 384 OSD words), the same rounded to whole numbers
   (ties), and on seeded noisy codewords of FT4, JS8 (174,87), FST4-60
   (240,101) and WSPR's (162,50) OSD with 740 patterns.  BP against the
   plain version on CPU copies of the inputs (its slot-order sums, as the
   kernel's): hard bits and parity flags equal, posterior totals within
   1e-4; OSD against the plain version on the card: codewords and hard
   errors equal (near-ties counted apart), distances within 1e-5
   relative.  Then each kernel's device time at the main path's shape
   beside the plain version's on the card and the bound, at the rates of
   the operations' types (FP32 without FMA, INT32) and at 67 TFLOP/s, and
   the ``osd`` kernel's dependent steps a word (sort steps and pivot
   columns), which its time follows;
4b. holds ``subtract_known`` and ``multisym_llrs`` against their plain
   versions on CPU copies of the inputs the decoders hand them (phase
   ``gfsk_kernels``): the FT8 main path's (FT8Decoder with AP at depth 3
   on 64 busy windows: the pass-1 LLRs of its first 24-window call, 12,288
   candidates straight from its demod spectrogram, and its pass-1
   subtraction of all 64 windows), FT4 at depth 3, JS8, FST4-60 (4-symbol
   windows) and FST4W-1800 at its device batch (the rfft branch):
   residual within 1e-3 of each window's peak and every fitted burst's
   integer time shift counted against the plain version's, LLRs within
   1e-3 through both entries of the LLR kernel (``candidate_llrs`` from the
   spectrogram against ``candidate_llrs_plain``, and ``multisym_llrs`` on
   the gathered csym against ``_multisym_llrs_plain``); the same for four
   FT8 windows with all 16 slots valid (the work queue then takes every
   pass a call can open); each subtraction's device operations a call,
   counted by ``torch.profiler`` (one kernel launch), and its device time in
   a CUDA graph, and that ``sincosf`` rounds as ``sinf`` and ``cosf``.  Then
   each kernel's device time at the main path's shape beside the plain
   version's on the card and the bound (the LLR kernel through both
   entries), and the LLR stage in turns on the same inputs: the fused call
   against the route before it (the plain gather and rotation, then the
   csym entry), each as the profiler's device time and as the time issued
   from the host;
4c. holds ``sync_score``, ``sync_select`` and ``sync_refine`` (one launch
   each, and the stage's wrapper ``sync_candidates``) against the plain
   versions on CPU copies of the inputs the decoders hand the sync search
   (phase ``sync_kernels``, recorded with the 4b cases): the FT8 main
   path's first 24-window pass-1 call (also at top_k 32768, 16384 a half)
   and its first call at the later passes' top_k, FT4 at depth 3, JS8, the
   App's FST4-60 (3000 Hz: the rfft branch), FST4W-1800 at its device
   batch, FT8 windows of a constant map and of zeros (every score ties) and
   FT8 windows holding NaN and +-inf, and the pass-1 call at both top_k
   with the selection forced to 8-block clusters (the plan of a card that
   holds no 16-block cluster): the score and NMS map bit for bit,
   top_val bit for bit, top_idx and tt identical; beside it the plain
   version on the card against the same.  It prints the kept designs: the
   selection's cluster, block and shared memory (also forced to 8 blocks),
   each kernel's registers and spills.  Then each kernel's device time
   at the FT8 pass-1 shape beside the plain version's on the card and the
   bound, the selection's at 8-block clusters beside it, ``torch.topk`` of
   both maps as the selection's yardstick, and
   the whole stage issued from the host through the kernels and the plain
   version;
5. runs the port's App on a seeded 192 kHz file replay with 64 FT8
   decoder lines across the band and known bursts in 17 of them (SNR 0 to
   -18 dB, a crowded channel of 9 overlapping signals, an AP-covered CQ);
   every expected spot must appear within 2 Hz and no other, through the
   channelizer, ``bp_minsum``, ``osd``, ``subtract_known``,
   ``multisym_llrs`` and the three sync kernels, with CUDA tensors reaching
   the decoder;
6. runs the App on seeded 192 kHz IQ with the lines a 20 m skimmer runs
   on one receiver: FT8, JS8, FT4, FST4-60 and FST4W-120.  The replay
   starts on the App's own anchor (the next UTC 15 s boundary) with noise
   up to the next 2-minute boundary, then 122 s with bursts in several
   windows of each (SNR -5 dB down to about 3 dB above each mode's
   threshold); every window must close on its own UTC boundary from the
   anchor on, and every expected spot (JS8's by its sender grammar) appear
   within 2 Hz, and no other, through the eight kernels;
7. runs the App on seeded 192 kHz IQ with the weak-signal lines of the
   same receiver: WSPR (14.0956 MHz), JT65 (14.076 MHz) and Q65-30
   (14.0795 MHz), written for the App's anchor as in 6: one WSPR window,
   two JT65 windows and four Q65-30 windows after the 2-minute boundary,
   8 bursts (SNR -8 dB down to about 3 dB above each mode's threshold);
   every window on its own boundary, every expected spot within 2 Hz and
   no other, through the channelizer and WSPR's OSD through ``osd`` (none
   of the three modes has an LDPC code or runs the GFSK engine);
8. decodes one synthesized window of each long period (FST4-300/900/1800,
   FST4W-300/900/1800) through ``get_decoder`` on the card, printing the
   spectrogram branch, the decode wall and the peak device memory;
9. times the decode of one window and of a 64-window batch for FT4, JS8,
   FST4-60, WSPR, JT65 and Q65-30 (and the peak device memory of the
   64-window WSPR batch);
10. runs the parallel layer on ``cuda:0``: the channel-sharded skim of the
    64 dials (bursts in 8) on a virtual 4-entry mesh against a 1-entry
    mesh, a 900 s 192 kHz window time-sharded 4 ways (4 channels) against
    one device's whole window and the plain version with its FST4W-900
    burst decoded, the kernel against the plain version at the shards'
    offsets, ``entry()``, ``dryrun_multichip`` on a virtual 4-entry mesh
    and the skim through a one-rank NCCL process group;
11. runs the port's App live (``tools/torch_soak.py``) at 512 FT8 channels
    as 8 synthetic real-time 192 kHz receivers of 64 dials, for 3 windows
    with 6 bursts a window spread over the receivers, scheduled from the
    App's anchor: every channel-window decoded, no stale drop or ingest
    overrun, every burst found on its own receiver's dials and no spot on
    another's, CUDA audio into the decoders, through the eight kernels,
    with the App's default pool (4 workers, one decode at a time on the
    card) and no spot later than its 15 s deadline; it prints the pool
    size, the latencies, the wait for the card's decode lock, stages, busy
    fraction and peak device memory;
12. decodes each committed live FT8 window that gave a false spot
    (``tests/torch_fixtures/ap_false``, ``tests/torch_fixtures/false_spots``)
    on the card, alone, with the live decoder's kwargs: its decode list
    must equal the JAX package's, stored beside it;
13. runs each of the last ported tools once at a tiny size on the card
    (``tools/torch_osd_calibrate.py``, ``torch_tune_topk.py``,
    ``torch_wspr_calibrate.py``; ``torch_import_tables.py`` on a
    synthesized ``varicode.cpp``) and prints what they print;
14. runs every section of the port's bench (``tools/torch_bench_sections.py``)
    on the card at a small size: the channelizer at 256 channels, the
    busy-band FT8 decode at batch 8 with one timed run (no decoded message
    may be one never injected), the decode of each of the 15 modes at
    batch 1, the FT8 recall with 8 trials and the JT65 and Q65-30 host
    share at batch 2, and prints each section's line; it must launch all
    eight kernels;
15. prints a ``{"kernels": [...]}`` line (``channelize``, ``bp_minsum``,
    ``osd``, ``subtract_known``, ``multisym_llrs``, ``sync_score``,
    ``sync_select``, ``sync_refine``, each with its launches in the App
    phases 5-7, 11 and 14, which set every count to 0 before they start
    and read it after), then ``{"ok": true, ...}`` last.

Each phase prints its wall time.

Any failed phase raises; nothing is caught.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

FS = 192_000
LO = 14_100_000
SEED = 20261016
CHAN_TOL = 1e-4          # kernel vs plain, max abs (split-bf16 products,
                         # ~16 bits, against float32 FIR sums of 512 taps;
                         # output rms ~0.2)
# published H100 SXM peaks at 700 W (dense): HBM bytes/s, bf16, TF32 and FP32
# FLOP/s (FP32_FLOPS counts an FMA as two operations)
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
# the stage kernels are built with --fmad=false: each float add, multiply,
# minimum and compare issues as one operation a lane and clock (132 SMs x
# 128 FP32 lanes x 1.98 GHz), integer work on 64 INT32 lanes an SM
FP32_OPS = 132 * 128 * 1.98e9
INT32_OPS = 132 * 64 * 1.98e9
SPOT_TOL_HZ = 2
LDPC_KERNELS = ("bp_minsum", "osd")
# the XLA programs of the JAX package that the LDPC kernels replace
LDPC_REPLACES = {"bp_minsum": "cwsl_digi_tpu/modes/ldpc.py:238",
                 "osd": "cwsl_digi_tpu/modes/osd.py:68"}
BP_POST_TOL = 1e-4       # bp_minsum vs the plain version on the CPU (the
                         # same slot-order sums), posterior totals max abs;
                         # hard bits and parity flags exact
OSD_DIST_RTOL = 1e-5     # osd vs plain, soft distance (sums of the
                         # mismatched weights in another order); codeword
                         # and hard errors exact outside near-ties
GFSK_KERNELS = ("subtract_known", "multisym_llrs")
# the XLA programs of the JAX package that the GFSK kernels replace
GFSK_REPLACES = {"subtract_known": "cwsl_digi_tpu/modes/subtract.py:71",
                 "multisym_llrs": "cwsl_digi_tpu/modes/gfsk_engine.py:161"}
SUB_TOL_PEAK = 1e-3      # subtract_known vs the plain version on the CPU,
                         # max |diff| over the window's peak |audio| (cos,
                         # sin and atan2 an ulp apart between libraries at
                         # phases of ~1e5 rad; the estimators' short sums
                         # in another order)
LLR_TOL = 1e-3           # multisym_llrs vs the plain version on the CPU,
                         # max abs of the std-3 LLRs (max-log sums)
SYNC_KERNELS = ("sync_score", "sync_select", "sync_refine")
HAND_KERNELS = LDPC_KERNELS + GFSK_KERNELS + SYNC_KERNELS
# the lines of the JAX package's XLA program that the sync kernels replace
SYNC_REPLACES = {"sync_score": "cwsl_digi_tpu/modes/gfsk_engine.py:435",
                 "sync_select": "cwsl_digi_tpu/modes/gfsk_engine.py:467",
                 "sync_refine": "cwsl_digi_tpu/modes/gfsk_engine.py:517"}
TRIG_OPS = 20            # a range-reduced float32 sin or cos, counted as
                         # this many operations in the bounds


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_libraries(mods: dict) -> None:
    """Build (or load) each kernel library, one nvcc each, all started
    together; print the wall and each build's ptxas report.  Raises the
    first build's error."""
    errors = {}

    def build(name, mod):
        try:
            mod.load_library()
        except BaseException as e:       # re-raised below
            errors[name] = e

    t0 = time.monotonic()
    threads = [threading.Thread(target=build, args=item)
               for item in mods.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next(iter(errors.values()))
    print(f"build: {', '.join(mods)} libraries in "
          f"{time.monotonic() - t0:.1f} s")
    for name, mod in mods.items():
        print(f"{name}: {mod.build_log.strip()}")


def cuda_ms(fn, reps: int) -> float:
    """Device time of one fn() call: ``reps`` calls captured in a CUDA
    graph, the graph replayed five times between CUDA events, the median
    replay over ``reps``.  Replaying leaves out the host's launch work, so
    this is the work on the card (inputs stay warm in L2 between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ops(fn) -> dict | None:
    """The device operations of one fn() call (after a warm-up call) as
    ``torch.profiler`` records them: {"events": all, "by_name": {name:
    count}, "busy_ms": the sum of their device times}, each kernel named
    without its return type, namespace and arguments; None when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in dev_events]
    if not names:
        return None
    by_name: dict[str, int] = {}
    for n in names:
        n = n.removeprefix("void ").replace("(anonymous namespace)::", "")
        n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
        by_name[n] = by_name.get(n, 0) + 1
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    return {"events": len(names), "by_name": by_name, "busy_ms": busy}


def eager_ms(fn, reps: int) -> float:
    """Median time of one fn() call issued from the host, between CUDA
    events after a warm-up: the device time plus any wait for the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _launch_bound(chan, iq_ext, rot, n_out: int) -> tuple[float, float]:
    """(bytes ms, ops ms) of one kernel launch: each input read and the
    output written once at the HBM rate, and the function's 4*C*FO*n_out
    FLOP as split-bf16 (three bf16 products) at the bf16 peak."""
    n_ch, fo = chan.spec.num_channels, chan.spec.filt_order
    n_bytes = (iq_ext.numel() * 8 + chan._taps_packed.numel() * 2
               + chan._coarse.numel() * 8 + rot.numel() * 8
               + n_ch * n_out * 4)
    return (n_bytes / HBM_BYTES_S * 1e3,
            3 * 4 * n_ch * fo * n_out / BF16_FLOPS * 1e3)


def kernel_phase(dev, freqs) -> dict:
    """CUDA channelizer vs its plain version at 192 kHz on ``freqs``:
    the error over 15 s of chunks and one window, then the times of one
    receiver chunk: kernel, plain version and the library yardstick, in
    turns, with the bound of the function's arithmetic."""
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.dsp.channelizer import (BatchChannelizer,
                                                     channelize_block_ref)

    n_ch = len(freqs)
    kern = BatchChannelizer(FS, freqs, device=dev)
    plain = BatchChannelizer(FS, freqs, device=dev)
    g_iq = 12 * kern._sub                      # the receiver's 0.25 s chunk
    n_chunks = -(-15 * FS // g_iq)
    rng = np.random.default_rng(SEED)
    iq = ((rng.standard_normal(n_chunks * g_iq)
           + 1j * rng.standard_normal(n_chunks * g_iq)) / np.sqrt(2)
          ).astype(np.complex64)
    iq_dev = torch.from_numpy(iq).to(dev)
    err = 0.0
    for i in range(n_chunks):
        x = iq_dev[i * g_iq : (i + 1) * g_iq]
        a = kern.process(x)
        b = plain.process_plain(x)
        err = max(err, float((a - b).abs().max()))
    whole = iq_dev[: 15 * FS]
    a = kern.process_window(whole)
    plain.reset()
    b = torch.cat([plain.process_plain(whole[i : i + g_iq])
                   for i in range(0, 15 * FS - g_iq + 1, g_iq)]
                  + [plain.process_plain(torch.nn.functional.pad(
                      whole[(15 * FS // g_iq) * g_iq:],
                      (0, g_iq - 15 * FS % g_iq)))], dim=1)[:, : a.shape[1]]
    err = max(err, float((a - b).abs().max()))
    torch.cuda.synchronize()
    print(f"channelizer kernel vs plain, {n_ch} channels: max abs err "
          f"{err:.3e} (tolerance {CHAN_TOL:g}) over {n_chunks} chunks + "
          "1 window")
    if not err <= CHAN_TOL:
        raise AssertionError(f"channelizer kernel disagrees: {err}")

    # one receiver chunk on the same device inputs
    st = kern.state
    bs, fo = kern.spec.block_size, kern.spec.filt_order
    x = iq_dev[:g_iq]
    iq_ext = torch.cat([st["tail"], x])
    a0 = st["abs_sample"] - st["tail"].shape[0]
    n_out = g_iq // bs
    rot_k = kern.tile_rotations(a0, n_out)
    rot_p = kern._rotations(a0, kern._sub, -(-iq_ext.shape[0] // kern._sub))
    # yardstick: one complex64 GEMM of the modulated taps with the Hankel
    # matrix of iq_ext (cuBLAS CGEMM, FP32: TF32 is off), without the
    # per-output rotation and real-part selection; the port never calls it
    g_taps = kern.taps.to(torch.complex64).to(dev)
    hankel = iq_ext.unfold(0, fo, bs)[:n_out].T.contiguous()
    runs = {
        "kernel": lambda: _kernels.channelize(
            iq_ext, kern._taps_packed, kern._coarse, rot_k, n_out, bs,
            st["out_phase"], kern.spec.sign),
        "plain": lambda: channelize_block_ref(
            kern.spec, iq_ext, kern._tone_sub, rot_p, kern._segs,
            st["out_phase"]),
        "library": lambda: torch.matmul(g_taps, hankel),
    }
    times = {k: [] for k in runs}
    for name in ["kernel", "plain", "library", "library", "plain", "kernel"]:
        times[name].append(cuda_ms(runs[name], 20))
    ms = {k: statistics.median(v) for k, v in times.items()}
    eager = {k: eager_ms(f, 20) for k, f in runs.items()}
    # least time for the same work: the bytes each input and output must
    # move once, and the function's arithmetic, real taps times the mixed
    # complex IQ, 4*C*FO*n_out FLOP, as split-bf16 (three bf16 products per
    # pair) on bf16 tensor cores (the mix, ~6*C*n_ext FLOP on the CUDA
    # cores, is a fraction of it and could overlap).  Beside it: the
    # kernel's own GEMM form, complex modulated taps times complex IQ,
    # which does twice the function's products, as split-bf16 and as
    # 3xTF32; and the direct form on FP32 CUDA cores
    bytes_ms, ops_ms = _launch_bound(kern, iq_ext, rot_k, n_out)
    fn_flop = 4 * n_ch * fo * n_out
    gemm_ms = 3 * 2 * fn_flop / BF16_FLOPS * 1e3
    tf32_ms = 3 * 2 * fn_flop / TF32_FLOPS * 1e3
    fp32_ms = fn_flop / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"channelizer chunk ({n_ch} ch x {g_iq / FS:.3f} s @ {FS} Hz): "
          f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
          f"library CGEMM (no rotation/selection) {ms['library']:.4f} ms; "
          f"bound {bound_ms:.5f} ms (split-bf16 ops {ops_ms:.5f}, bytes "
          f"{bytes_ms:.5f}); kernel at "
          f"{100 * bound_ms / ms['kernel']:.1f} % of bound; its complex-tap "
          f"GEMM form's own bound {gemm_ms:.5f} (as 3xTF32 {tf32_ms:.5f}); "
          f"FP32 direct form {fp32_ms:.5f}; device times (CUDA graph) "
          f"{times}; issued from the host one at a time {eager}")
    return {"max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "gemm_form_bound_ms": gemm_ms}


def noisy_llrs(gen: np.ndarray, n_words: int, seed: int,
               ties: int = 0) -> np.ndarray:
    """LLRs [n_words, n] of random codewords of the code ``gen`` [k, n]
    generates, over BPSK and white noise at Eb/N0 0 to 4 dB, scaled to the
    decoders' std-3 range (positive = bit 0); the first ``ties`` words are
    rounded to whole numbers, so |LLR| ties (the OSD's stable sort) and
    duplicated minima (min-sum) occur."""
    k, n = gen.shape
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(n_words, k))
    cw = (info @ gen.astype(np.int64)) % 2
    snr = 10 ** (np.linspace(0.0, 4.0, n_words) / 10)[:, None]
    sigma = np.sqrt(1.0 / (2 * snr * k / n))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = 2 * y / sigma ** 2
    llr = llr / llr.std(axis=1, keepdims=True) * 3.0
    llr[:ties] = np.round(llr[:ties])
    return llr.astype(np.float32)


def bp_vs_plain(bp, llrs: torch.Tensor) -> dict:
    """``bp.decode_full`` (the ``bp_minsum`` kernel on a CUDA tensor)
    against ``decode_full_plain`` on CPU copies of the same LLRs, where the
    plain version sums each variable's incoming messages in column-slot
    order, as the kernel does: hard bits and parity flags must be equal
    and the posterior totals within BP_POST_TOL.  Beside it, the plain
    version on the card (``on_card_plain``), whose 3-term sums torch may
    take in another order: min-sum carries that rounding into totals that
    differ by whole units in words that do not converge, so it is reported,
    not held to a tolerance."""
    from cwsl_digi_tpu_torch.modes.ldpc import BPDecoder

    kh, kok, kpost = bp.decode_full(llrs)
    host = BPDecoder(bp.code, iters=bp.iters, alpha=bp.alpha, device="cpu")
    ph, pok, ppost = host.decode_full_plain(llrs.cpu())
    ch, cok, cpost = bp.decode_full_plain(llrs)

    def diff(h, ok, post):
        err = (kpost.cpu() - post.to("cpu")).abs()
        return {"hard_differ": int(((kh.cpu() != h.cpu()).any(dim=1)
                                    | (kok.cpu() != ok.cpu())).sum()),
                "max_abs_err": float(err.max()),
                "words_above_tol": int((err.max(dim=1).values
                                        > BP_POST_TOL).sum())}

    got = diff(ph, pok, ppost)
    return {"ok": got["hard_differ"] == 0
            and got["max_abs_err"] <= BP_POST_TOL,
            "words": llrs.shape[0], **got, "parity_ok": int(pok.sum()),
            "on_card_plain": diff(ch, cok, cpost)}


def osd_vs_plain(gen, llrs: torch.Tensor, patterns, pattern_idx) -> dict:
    """``osd_decode`` (the ``osd`` kernel on a CUDA tensor) against
    ``osd_decode_plain`` on the same LLRs.  Where the codewords differ and
    the two distances are within OSD_DIST_RTOL of each other, the best two
    patterns were a near-tie that sums in another order may split
    (``near_ties``); any other differing codeword is a fault
    (``codeword_differ``).  Where they agree, the hard-error counts must be
    equal and the distances within OSD_DIST_RTOL."""
    from cwsl_digi_tpu_torch.modes import osd

    kc, kd, kn = osd.osd_decode(gen, llrs, patterns, pattern_idx)
    pc, pd, pn = osd.osd_decode_plain(gen, llrs, patterns)
    same = (kc == pc).all(dim=1)
    rel = (kd - pd).abs() / pd.abs().clamp(min=1e-30)
    near = ~same & (rel <= OSD_DIST_RTOL)
    got = {"words": llrs.shape[0],
           "codeword_differ": int((~same & ~near).sum()),
           "near_ties": int(near.sum()),
           "nhard_differ": int((same & (kn != pn)).sum()),
           "dist_rel_err": float(rel[same].max()) if bool(same.any())
           else 0.0,
           "max_abs_err": float((kd - pd)[same].abs().max())
           if bool(same.any()) else 0.0}
    return {"ok": got["codeword_differ"] == 0 and got["nhard_differ"] == 0
            and got["dist_rel_err"] <= OSD_DIST_RTOL, **got}


def main_path_ldpc_inputs(dev):
    """The FT8 main path's first-pass BP and OSD inputs as the decode
    hands them over: ``FT8Decoder`` with the operator's call (3 AP
    hypotheses) on one device batch of the bench's busy windows (6
    signals a window at -20 to -5 dB).  Returns (decoder, BP LLRs, OSD
    LLRs)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from torch_bench_sections import make_busy_windows

    from cwsl_digi_tpu_torch.modes import gfsk_engine, ldpc
    from cwsl_digi_tpu_torch.modes.ft8 import FT8Decoder

    dec = FT8Decoder(my_call="W2AXR", depth=3, device=dev)
    wins, _ = make_busy_windows(dec.max_device_batch)
    bp_in, osd_in = [], []
    orig_bp, orig_osd = ldpc.BPDecoder.decode_full, gfsk_engine.osd_decode

    def bp_rec(self, llrs):
        bp_in.append(llrs.clone())
        return orig_bp(self, llrs)

    def osd_rec(gen, llrs, patterns, pattern_idx=None):
        osd_in.append(llrs.clone())
        return orig_osd(gen, llrs, patterns, pattern_idx)

    ldpc.BPDecoder.decode_full = bp_rec
    gfsk_engine.osd_decode = osd_rec
    try:
        dec.decode(torch.from_numpy(wins).to(dev))
    finally:
        ldpc.BPDecoder.decode_full = orig_bp
        gfsk_engine.osd_decode = orig_osd
    return dec, bp_in[0], osd_in[0]


def bp_bound_ms(bp, m: int) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of min-sum BP over ``m`` words: the LLRs
    read and hard bits, parity flags and totals written once at the HBM
    rate, and per word and iteration 5 float operations an edge (the
    variable->check difference, the two minima, the scaling, the sum into
    the variable) and one a variable (the channel LLR), plus the last
    totals and the syndrome, at FP32_OPS (``ops_ms_fma_rate``: the
    same at FP32_FLOPS, which counts an FMA as two)."""
    t = bp.t
    edges = int(t.row_mask.sum())
    ops = m * (bp.iters * (5 * edges + t.n) + 2 * edges + t.n)
    n_bytes = m * t.n * (4 + 1 + 4) + m + 2 * (t.row_cols.size
                                               + t.col_slots.size)
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"edges": edges, "ops": ops, "bytes": n_bytes,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def osd_bound_ms(k: int, n: int, n_pat: int, m: int
                 ) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of OSD over ``m`` words: the LLRs,
    generator and pattern lists read and codewords, distances and counts
    written once at the HBM rate; per word the sort's n*ceil(log2 n)
    comparisons, the elimination's k pivots XORed into k rows of
    ceil(n/32) words, each pattern's re-encoding (5 word operations a row
    word: 3 flips, the mismatch, the count) and its soft distance (a
    multiply and an add a bit).  The sort, elimination and re-encoding are
    integer work at INT32_OPS, the distances float work at FP32_OPS; the
    two pipes issue side by side, so the bound is the larger time
    (``ops_ms_fma_rate``: all of it at FP32_FLOPS, which counts an FMA
    as two)."""
    w = -(-n // 32)
    int_word = n * int(np.ceil(np.log2(n))) + k * k * w + n_pat * 5 * w
    float_word = n_pat * 2 * n
    per_word = int_word + float_word
    ops = m * per_word
    n_bytes = m * n * 4 + k * n + n_pat * 3 * 2 + m * n + m * 8
    ops_ms = max(m * int_word / INT32_OPS, m * float_word / FP32_OPS) * 1e3
    return (n_bytes / HBM_BYTES_S * 1e3, ops_ms,
            {"ops_per_word": per_word, "int_ops_per_word": int_word,
             "ops": ops, "bytes": n_bytes,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def stage_kernel_times(runs: dict, bounds: dict, errs: dict,
                       shapes: dict) -> dict:
    """Each stage kernel's device time at the main path's shape: in a CUDA
    graph, two turns around its plain version issued from the host (``runs``
    name: (kernel, plain, kernel reps, plain reps)), beside its bound at the
    corrected rates (FP32_OPS, INT32_OPS) and at FP32_FLOPS."""
    out = {}
    for name, (kern, plain, reps, plain_reps) in runs.items():
        ms = [cuda_ms(kern, reps)]
        plain_ms = eager_ms(plain, plain_reps)
        ms.append(cuda_ms(kern, reps))
        kern_eager = eager_ms(kern, reps)
        bytes_ms, ops_ms, counts = bounds[name]
        bound = max(bytes_ms, ops_ms)
        bound_fma = max(bytes_ms, counts["ops_ms_fma_rate"])
        k_ms = statistics.median(ms)
        out[name] = {"ms": k_ms, "ms_turns": ms, "plain_ms": plain_ms,
                     "eager_ms": kern_eager, "bound_ms": bound,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes", "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                     "bound_ms_fma_rate": bound_fma, "counts": counts,
                     "library_ms": None, "max_abs_err": errs[name],
                     "shape": shapes[name]}
        print(f"{name} at {shapes[name]}: kernel {k_ms:.4f} ms device time "
              f"(turns {ms}), {kern_eager:.4f} ms issued from the host; "
              f"plain {plain_ms:.3f} ms from the host; bound {bound:.5f} ms "
              f"(bytes {bytes_ms:.5f}, ops {ops_ms:.5f}; {counts}), kernel "
              f"at {100 * bound / k_ms:.1f} % of it (at FP32_FLOPS: bound "
              f"{bound_fma:.5f} ms, {100 * bound_fma / k_ms:.1f} %); no "
              "single library call computes it")
    return out


def ldpc_kernels_phase(dev) -> dict:
    """The ``bp_minsum`` and ``osd`` kernels against their plain versions
    on the card: at the FT8 main path's first-pass shapes on its own
    inputs (36,864 BP words with 3 AP hypotheses, 384 OSD words), the same
    rounded (ties), and on seeded noisy codewords of every other code and
    OSD shape the decoders run (FT4, JS8 (174,87), FST4-60 (240,101),
    WSPR's (162,50) with 740 patterns); then the device time of each
    kernel at the main path's shape beside the plain version's and the
    bound."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import _kernels as mk
    from cwsl_digi_tpu_torch.modes import fst4, ft4, js8, osd, wspr

    dec, bp_llr, osd_llr = main_path_ldpc_inputs(dev)
    bp, tabs = dec.bp, dec._tabs
    pats = (tabs["patterns"], tabs["pattern_idx"])
    checks = {
        "bp ft8 pass 1": bp_vs_plain(bp, bp_llr),
        "bp ft8 pass 1 rounded": bp_vs_plain(bp, bp_llr[:4096].round()),
        "osd ft8 pass 1": osd_vs_plain(tabs["gen"], osd_llr, *pats),
        "osd ft8 pass 1 rounded": osd_vs_plain(tabs["gen"], osd_llr.round(),
                                               *pats),
    }
    others = [("ft4", ft4.FT4Decoder(depth=3, device=dev)),
              ("js8", js8.JS8Decoder(device=dev)),
              ("fst4-60", fst4.FST4Decoder(Mode.FST4_60, device=dev))]
    for i, (name, d) in enumerate(others):
        g = d._host["gen"]
        m_bp = d.max_device_batch * d.spec.top_k
        llr = torch.from_numpy(noisy_llrs(g, m_bp, SEED + 10 + i,
                                          ties=m_bp // 8)).to(dev)
        checks[f"bp {name}"] = bp_vs_plain(d.bp, llr)
        m_osd = d.max_device_batch * d.spec.osd_j
        llr = torch.from_numpy(noisy_llrs(g, m_osd, SEED + 20 + i,
                                          ties=m_osd // 8)).to(dev)
        checks[f"osd {name}"] = osd_vs_plain(
            d._tabs["gen"], llr, d._tabs["patterns"], d._tabs["pattern_idx"])
    wd = wspr.WSPRDecoder(device=dev)
    m_w = wd.max_device_batch * wd.cfg.osd_j
    llr = torch.from_numpy(noisy_llrs(wd._host["wspr_gen"], m_w, SEED + 30,
                                      ties=m_w // 8)).to(dev)
    checks["osd wspr"] = osd_vs_plain(wd._tabs["wspr_gen"], llr,
                                      wd._tabs["patterns"],
                                      wd._tabs["pattern_idx"])
    torch.cuda.synchronize()
    for name, c in checks.items():
        print(f"ldpc kernel vs plain, {name}: {json.dumps(c)}")
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"LDPC kernels disagree with the plain "
                             f"versions: {bad}")

    # device time at the main path's shapes: the kernels in a CUDA graph,
    # in turns around the plain versions issued from the host (the plain
    # OSD syncs with the host, so it cannot be captured)
    runs = {
        "bp_minsum": (lambda: mk.bp_minsum(
            bp_llr, bp._k_row_cols, bp._k_col_slots, bp.iters, bp.alpha),
                      lambda: bp.decode_full_plain(bp_llr), 10, 5),
        "osd": (lambda: mk.osd(tabs["gen"], osd_llr, tabs["pattern_idx"]),
                lambda: osd.osd_decode_plain(tabs["gen"], osd_llr,
                                             tabs["patterns"]), 20, 5),
    }
    k_gen, n_gen = tabs["gen"].shape
    bounds = {"bp_minsum": bp_bound_ms(bp, bp_llr.shape[0]),
              "osd": osd_bound_ms(k_gen, n_gen, tabs["patterns"].shape[0],
                                  osd_llr.shape[0])}
    errs = {name: max(c["max_abs_err"] for cn, c in checks.items()
                      if cn.startswith(name[:2]))
            for name in runs}
    out = stage_kernel_times(runs, bounds, errs,
                             {"bp_minsum": list(bp_llr.shape),
                              "osd": list(osd_llr.shape)})
    steps = osd_steps(tabs["gen"], osd_llr)
    out["osd"]["dependent_steps"] = steps
    print(f"osd dependent steps a word: {json.dumps(steps)}")
    return {"kernels": out, "checks": checks}


def osd_steps(gen, llrs: torch.Tensor) -> dict:
    """The chain of dependent steps a word of the ``osd`` kernel takes,
    which its time follows: the bitonic sort's steps to the power of two
    >= n, and the generator columns it eliminates until k pivots (the
    plain reduction's last pivot column + 1), mean and max over the
    words."""
    from cwsl_digi_tpu_torch.modes import osd

    n = llrs.shape[1]
    lg = max(1, int(np.ceil(np.log2(n))))
    _, _, basis = osd.osd_reduce_plain(gen, llrs)
    cols = (basis.max(dim=1).values + 1).to(torch.float64)
    return {"sort_steps": lg * (lg + 1) // 2,
            "pivot_columns_mean": float(cols.mean()),
            "pivot_columns_max": int(cols.max()),
            "steps_mean": lg * (lg + 1) // 2 + float(cols.mean())}


def burst_case(spec, code, counts, seed: int, n_slots: int = 0
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Seeded windows of a GFSK mode with ``counts[w]`` known bursts in
    window w: random info bits, GFSK at the mode's BT, SNRs (in 2500 Hz)
    from -6 down to -14 dB in unit white noise (the decoder's range), starts
    within +-0.3 s of the mode's signal start and off the hop grid, tones
    off the bin grid.  Returns (audio [B, T] float32, params [B, M, k+3]
    int32 with valid bursts first and M = max(max(counts), n_slots),
    gen_parity [k, n-k] float32: the operands of ``subtract_known``; and
    the bursts alone [B, T])."""
    from cwsl_digi_tpu_torch.constants import WAVE_SR
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate, place_burst

    rng = np.random.default_rng(seed)
    n = int(round(spec.trperiod * WAVE_SR))
    k = code.k
    n_m = max(max(counts), n_slots)
    clean = np.zeros((len(counts), n))
    params = np.zeros((len(counts), n_m, k + 3), np.int32)
    span_hz = spec.fmax_hz - spec.fmin_hz - spec.n_tones * spec.tone_spacing
    for w, cnt in enumerate(counts):
        snrs = np.linspace(-6.0, -14.0, max(cnt, 2))
        for j in range(cnt):
            info = rng.integers(0, 2, size=k)
            tones = spec.tones_from_codeword(code.encode(info))
            f0 = spec.fmin_hz + span_hz * (j + rng.uniform(0.2, 0.8)) / cnt
            start = spec.signal_start_s + rng.uniform(-0.3, 0.3)
            amp = np.sqrt(2 * 10 ** (snrs[j] / 10) * 2500 / (WAVE_SR / 2))
            burst = gfsk_modulate(tones, f0, spec.sps, WAVE_SR,
                                  spec.tone_spacing, bt=spec.bt)
            clean[w] += place_burst(burst, n, start, amp)
            params[w, j, :k] = info
            params[w, j, k] = int(round(start * WAVE_SR / spec.hop))
            params[w, j, k + 1] = int(round(f0 / spec.bin_hz))
            params[w, j, k + 2] = 1
    audio = (clean + rng.standard_normal(clean.shape)).astype(np.float32)
    return (audio, params,
            np.ascontiguousarray(code.gen_parity, dtype=np.float32),
            clean.astype(np.float32))


def noisy_csym(spec, m: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded coherent-LLR operands of ``m`` candidates: csym [m, n_sym,
    n_tones] complex64, unit noise plus a tone per symbol (the sync tone at
    sync cells) at amplitudes 0.2 to 3 with random phases, and rot [m]
    complex64 of random phase."""
    rng = np.random.default_rng(seed)
    t = spec.n_tones
    tones = rng.integers(0, t, size=(m, spec.n_sym))
    for s, tone in spec.sync_cells:
        tones[:, s] = tone
    amp = np.linspace(0.2, 3.0, m)[:, None, None]
    c = (rng.standard_normal((m, spec.n_sym, t))
         + 1j * rng.standard_normal((m, spec.n_sym, t)))
    c += amp * np.exp(1j * rng.uniform(0, 2 * np.pi, (m, spec.n_sym, 1))) \
        * (np.arange(t) == tones[:, :, None])
    rot = np.exp(-1j * rng.uniform(-np.pi, np.pi, m))
    return c.astype(np.complex64), rot.astype(np.complex64)


def noisy_demod(spec, b: int, k: int, os_t_eff: int, seed: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded operands of the coherent LLRs' spectrogram entry: demod [b,
    H, F] complex64 unit noise, H = os_t_eff * n_sym + 7 hops and F =
    os_f * (n_tones + 6) + 3 bins (neither a whole number of strides, so
    the gather reads the zero padding), with a tone track (a tone a
    symbol, the sync tones where known, amplitudes 0.5 to 3) under each
    even candidate; tt and f0 [b, k] int64 start hops and bins, the first
    five candidates of each window at the edges where the clamps of the
    block start bite (hop 0 and H - 1, bin 0 and F - 1, and the last start
    of the largest remainder, whose block reads the zero padding)."""
    rng = np.random.default_rng(seed)
    t, osf = spec.n_tones, spec.os_f
    h = os_t_eff * spec.n_sym + 7
    f = osf * (t + 6) + 3
    demod = (rng.standard_normal((b, h, f))
             + 1j * rng.standard_normal((b, h, f))) / np.sqrt(2.0)
    tt = rng.integers(0, h, (b, k))
    f0 = rng.integers(0, f, (b, k))
    # the last start with the largest remainder: its block runs past H and
    # F into the padding
    edges = [(0, 0), (h - 1, f - 1),
             ((h // os_t_eff) * os_t_eff - 1, (f // osf) * osf - 1),
             (0, f - 1), (h - 1, 0)]
    for i, (t_, f_) in enumerate(edges[:k]):
        tt[:, i], f0[:, i] = t_, f_
    for w in range(b):
        for c in range(0, k, 2):
            tones = rng.integers(0, t, spec.n_sym)
            for s_, tone in spec.sync_cells:
                tones[s_] = tone
            for s_ in range(spec.n_sym):
                hop = tt[w, c] + os_t_eff * s_
                fb = f0[w, c] + osf * tones[s_]
                if hop < h and fb < f:
                    demod[w, hop, fb] += rng.uniform(0.5, 3.0) * np.exp(
                        1j * rng.uniform(0, 2 * np.pi))
    return (demod.astype(np.complex64), tt.astype(np.int64),
            f0.astype(np.int64))


def record_gfsk_inputs(dec, audio: torch.Tensor):
    """The first coherent-LLR, subtraction and sync-search operands that
    ``dec.decode(audio)`` hands over: ((spec, demod, tt, f0, os_t_eff,
    fold_pairs, bitmaps), (spec, audio, params, gen_parity) or None,
    [(spec, power_sync, demod, base, n_hops, refine)]): the sync search's
    first call and the first of each later top_k (the later passes')."""
    from cwsl_digi_tpu_torch.modes import gfsk_engine

    llr_in, sub_in, sync_in = [], [], []
    orig_llr, orig_sub = gfsk_engine.candidate_llrs, gfsk_engine.subtract_known
    orig_sync = gfsk_engine.sync_candidates

    def llr_rec(spec, demod, tt, f0, os_t_eff, fold_pairs, bitmaps):
        if not llr_in:
            llr_in.append((spec, demod.clone(), tt.clone(), f0.clone(),
                           os_t_eff, fold_pairs, bitmaps.clone()))
        return orig_llr(spec, demod, tt, f0, os_t_eff, fold_pairs, bitmaps)

    def sub_rec(spec, audio, params, gen_parity):
        if not sub_in:
            sub_in.append((spec, audio.clone(), params.clone(),
                           gen_parity.clone()))
        return orig_sub(spec, audio, params, gen_parity)

    def sync_rec(spec, power_sync, demod, base, n_hops, refine):
        if all(spec.top_k != s[0].top_k for s in sync_in):
            sync_in.append((spec, power_sync.clone(),
                            demod.clone() if refine else None, base.clone(),
                            n_hops, refine))
        return orig_sync(spec, power_sync, demod, base, n_hops, refine)

    gfsk_engine.candidate_llrs = llr_rec
    gfsk_engine.subtract_known = sub_rec
    gfsk_engine.sync_candidates = sync_rec
    try:
        dec.decode(audio)
    finally:
        gfsk_engine.candidate_llrs = orig_llr
        gfsk_engine.subtract_known = orig_sub
        gfsk_engine.sync_candidates = orig_sync
    return llr_in[0], (sub_in[0] if sub_in else None), sync_in


def csym_operands(spec, demod, tt, f0, os_t_eff, fold_pairs, bitmaps):
    """The csym entry's operands (spec, csym [B*K, n_sym, T], rot [B*K],
    bitmaps) of the same candidates: the plain version's gather and
    rotation (the route before the fused kernel)."""
    from cwsl_digi_tpu_torch.modes import gfsk_engine

    csym = gfsk_engine.gather_candidates(spec, demod, tt, f0, os_t_eff)
    rot = gfsk_engine.candidate_rotation(spec, csym, f0, fold_pairs)
    return (spec, csym.reshape(-1, spec.n_sym, spec.n_tones),
            rot.reshape(-1), bitmaps)


def fitted_steps(params: torch.Tensor) -> torch.Tensor:
    """[B, M] bool: the (window, burst) steps the subtraction fits, each
    window's bursts up to its first invalid one."""
    return torch.cumprod((params[:, :, -1] != 0).to(torch.int32), dim=1) > 0


def subtract_vs_plain(spec, audio, params, gen_parity) -> dict:
    """``subtract_known`` (the kernel on CUDA tensors) against
    ``subtract_known_plain`` on CPU copies: max |diff| within SUB_TOL_PEAK
    of each window's peak |audio|; beside it the (window, burst) steps
    whose integer time shift differs (the plain version's from its
    ``torch.round``), which a half-sample tie may flip."""
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk
    from cwsl_digi_tpu_torch.modes import subtract

    shifts = torch.full(tuple(params.shape[:2]), -2 ** 31, dtype=torch.int32,
                        device=audio.device)
    got = gk.subtract_known(spec, audio, params, gen_parity, shifts=shifts)
    rounds, orig_round = [], torch.round

    def rec(x, *a, **k):
        out = orig_round(x, *a, **k)
        rounds.append(out.clone())
        return out

    torch.round = rec
    try:
        want = subtract.subtract_known_plain(spec, audio.cpu(), params.cpu(),
                                             gen_parity.cpu())
    finally:
        torch.round = orig_round
    peak = audio.abs().amax(dim=1).cpu()
    err = (got.cpu() - want).abs().amax(dim=1)
    rel = err / peak.clamp(min=1e-30)
    fit = fitted_steps(params.cpu())
    lim = spec.sps - 1
    flips = []
    for mi, r in enumerate(rounds):
        plain = r.to(torch.int64).clamp(-lim, lim)
        for w in torch.nonzero(fit[:, mi]).flatten().tolist():
            if int(shifts[w, mi]) != int(plain[w]):
                flips.append([w, mi, int(shifts[w, mi]), int(plain[w])])
    return {"ok": float(rel.max()) <= SUB_TOL_PEAK and bool(torch.isfinite(
        got).all()), "windows": audio.shape[0],
            "steps": int(fit.sum()), "max_abs_err": float(err.max()),
            "max_err_over_peak": float(rel.max()), "shift_flips": flips}


def llr_vs_plain(spec, csym, rot, bitmaps) -> dict:
    """``multisym_llrs`` (the kernel) against ``_multisym_llrs_plain`` on
    CPU copies: max abs within LLR_TOL."""
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk
    from cwsl_digi_tpu_torch.modes import gfsk_engine

    got = gk.multisym_llrs(spec, csym, rot, bitmaps)
    want = gfsk_engine._multisym_llrs_plain(spec, csym.cpu(), rot.cpu(),
                                            bitmaps.cpu())
    err = float((got.cpu() - want).abs().max())
    return {"ok": err <= LLR_TOL, "candidates": csym.shape[0],
            "max_abs_err": err}


def fused_llr_vs_plain(spec, demod, tt, f0, os_t_eff, fold_pairs,
                       bitmaps) -> dict:
    """``candidate_llrs`` (the kernel's spectrogram entry) against
    ``candidate_llrs_plain`` on CPU copies: max abs within LLR_TOL."""
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk
    from cwsl_digi_tpu_torch.modes import gfsk_engine

    got = gk.candidate_llrs(spec, demod, tt, f0, os_t_eff, fold_pairs,
                            bitmaps)
    want = gfsk_engine.candidate_llrs_plain(
        spec, demod.cpu(), tt.cpu(), f0.cpu(), os_t_eff, fold_pairs,
        bitmaps.cpu())
    err = float((got.cpu() - want).abs().max())
    return {"ok": err <= LLR_TOL and bool(torch.isfinite(got).all()),
            "candidates": tt.numel(), "max_abs_err": err}


def subtract_bound_ms(spec, audio, params, gen_parity
                      ) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the subtraction of this run's bursts:
    the audio read, the residual written, params and generator read once
    at the HBM rate; per sample of the (n_sym+1)*sps span and fitted
    (window, burst) step, two syntheses (4 pulse taps of a multiply and an
    add, the scale and carrier, the phase add, cos and sin, the mask: 53
    with TRIG_OPS a trig call), two correlations (three products, two
    cumsum adds: 10), the df2 twist (its angle, cos and sin, the rotation:
    48) and the gain and subtraction (4): 168 at FP32_OPS
    (``ops_ms_fma_rate``: the same at FP32_FLOPS, which counts an FMA as
    two)."""
    b, t = audio.shape
    span = (spec.n_sym + 1) * spec.sps
    steps = int(fitted_steps(params.cpu()).sum())
    per = 2 * (4 * 2 + 2 + 1 + 2 * TRIG_OPS + 2) + 2 * 5 \
        + (2 + 2 * TRIG_OPS + 6) + 4
    ops = steps * span * per
    n_bytes = 2 * b * t * 4 + params.numel() * 4 + gen_parity.numel() * 4
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"steps": steps, "span": span, "ops_per_sample_step": per,
             "ops": ops, "bytes": n_bytes,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def llr_bound_ms(spec, m: int, fused: bool = True, fold_pairs: bool = True
                 ) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the coherent LLRs of ``m``
    candidates: the candidates' cells (fused: read from the spectrogram at
    most once, with their start hop and bin; else csym and rot) read and
    the LLRs written once at the HBM rate; per candidate its rotation
    (fused: the angle, cos and sin, and with ``fold_pairs`` the sync pairs'
    products and sum, the angle of their sum, cos and sin and two complex
    products), per data symbol the |C|^2 of its rows (3 ops a tone), each
    T x T cross table (a complex product a column, 6, and 4 a cell), the
    pair maxima (an add and a max a combination), the triples (5 adds and a
    max), with coh4 the two 4-symbol windows (9 adds and a max), each over
    the neighbour tones the sync cells allow, the bit maxima and the
    scaling, at FP32_OPS (``ops_ms_fma_rate``: the same at FP32_FLOPS,
    which counts an FMA as two)."""
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk

    t = spec.n_tones
    tabs = gk._spec_tables(spec, torch.device("cpu"))
    pop = np.vectorize(lambda v: bin(int(v)).count("1"))(tabs["allow"].numpy())
    ap, an, ap2, an2 = pop
    rows = 5 if spec.coh4 else 3
    tables = 9 if spec.coh4 else 3
    metrics = 6 if spec.coh4 else 4
    n_data = len(spec.data_syms)
    per_sym = (rows * t * 3 + tables * (6 * t + 4 * t * t)
               + metrics * spec.bits_per_sym * (t + 2)
               + 8 * spec.bits_per_sym)
    ops_sym = (n_data * per_sym + int((2 * t * (ap + an)).sum())
               + int((6 * t * ap * an).sum()))
    if spec.coh4:
        ops_sym += int((10 * t * ap * an * an2).sum()
                       + (10 * t * ap2 * ap * an).sum())
    rot_ops = 0
    if fused:
        rot_ops = 3 + 2 * TRIG_OPS
        if fold_pairs:
            rot_ops += 8 * tabs["pairs"].shape[0] + 12 + 3 * TRIG_OPS
    ops = m * (ops_sym + rot_ops)
    cells = spec.n_sym * t * 8
    n_bytes = m * (cells + (16 if fused else 8)
                   + n_data * spec.bits_per_sym * 4)
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"ops_per_candidate": ops_sym + rot_ops, "rotation_ops": rot_ops,
             "ops": ops, "bytes": n_bytes,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def _gfsk_mode_windows(mode: str, n: int, seed: int) -> np.ndarray:
    """``n`` seeded windows of a GFSK mode with real messages (so that the
    first pass decodes and the subtraction runs): FT4 three bursts a
    window 2 dB apart at -4 to -10 dB, JS8, FST4-60 and FST4W-1800 one, at
    -6 to -14 dB (FST4W-1800 -28 dB), in noise."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import fst4, ft4, js8
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        if mode == "FT4":
            clean = sum(10 ** (-j * 0.1) * ft4.synthesize(
                text, 700.0 + 700.0 * j + 40.0 * rng.uniform(),
                start_s=0.3 + 0.3 * rng.uniform())
                for j, text in enumerate(["CQ VE3XYZ EN93",
                                          "K1ABC W9XYZ EN37",
                                          "W9XYZ K1ABC -11"]))
            snr = rng.uniform(-10, -4)
        elif mode == "JS8":
            clean = js8.synthesize("KN4CRD: HB EN50",
                                   800.0 + 1400.0 * rng.uniform())
            snr = rng.uniform(-14, -6)
        elif mode == "FST4-60":
            clean = fst4.synthesize("CQ F5ABC JN18", Mode.FST4_60,
                                    950.0 + 100.0 * rng.uniform())
            snr = rng.uniform(-14, -6)
        else:
            clean = fst4.synthesize("K1ABC FN42 30", Mode.FST4W_1800,
                                    1500.0, start_s=1.0)
            snr = -28.0
        out.append(add_noise_at_snr(clean, snr, 12_000, rng
                                    ).astype(np.float32))
    return np.stack(out)


def gfsk_cases(dev) -> dict:
    """The coherent-LLR and subtraction operands the decoders hand over, by
    case: the FT8 main path's (FT8Decoder with the operator's call at
    depth 3 on 64 busy windows: the pass-1 LLRs of its first 24-window
    call, 12,288 candidates, and its pass-1 subtraction over all 64
    windows), FT4 at depth 3, JS8, FST4-60 (coh4) and FST4W-1800 at its
    device batch.  {name: ((spec, demod, tt, f0, os_t_eff, fold_pairs,
    bitmaps), (spec, audio, params, gen_parity), [sync-search operands])}
    (``record_gfsk_inputs``)."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import fst4, ft4, js8
    from cwsl_digi_tpu_torch.modes.ft8 import FT8Decoder

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from torch_bench_sections import make_busy_windows

    wins, _ = make_busy_windows(64)
    dec = FT8Decoder(my_call="W2AXR", depth=3, device=dev)
    cases = {"ft8 main path": record_gfsk_inputs(
        dec, torch.from_numpy(wins).to(dev))}
    del wins
    others = [("ft4 depth 3", ft4.FT4Decoder(depth=3, device=dev), "FT4", 16),
              ("js8", js8.JS8Decoder(device=dev), "JS8", 16),
              ("fst4-60", fst4.FST4Decoder(Mode.FST4_60, device=dev),
               "FST4-60", 8),
              ("fst4w-1800", fst4.FST4Decoder(Mode.FST4W_1800, device=dev),
               "FST4W-1800", 0)]
    for i, (name, d, mode, n) in enumerate(others):
        n = n or d.max_device_batch
        audio = torch.from_numpy(_gfsk_mode_windows(mode, n, SEED + 40 + i))
        cases[name] = record_gfsk_inputs(d, audio.to(dev))
        del audio, d
    for name, (_, sub_in, _) in cases.items():
        if sub_in is None:
            raise AssertionError(f"{name}: the decode ran no subtraction")
    return cases


def gfsk_kernels_phase(dev, cases: dict | None = None) -> dict:
    """The ``subtract_known`` and ``multisym_llrs`` kernels against their
    plain versions on CPU copies of the inputs the decoders hand them
    (``gfsk_cases``: the LLR kernel through both entries, from the demod
    spectrogram and from the gathered csym) and on four FT8 windows with
    every slot a valid burst; each subtraction case's device operations a
    call (the profiler's count: one ``k_subtract`` launch) and its device
    time in a CUDA graph (so that a capture of it is shown to work at every
    shape); that ``sincosf`` rounds as ``sinf`` and ``cosf`` over the
    phases the kernel meets; then each kernel's device time at the main
    path's shape beside the plain version's on the card and the bound, and
    the LLR stage in turns: the fused call against the route before it
    (the plain gather and rotation, then the csym entry)."""
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk
    from cwsl_digi_tpu_torch.modes import ft8, gfsk_engine, ldpc, subtract

    cases = cases or gfsk_cases(dev)
    checks, calls = {}, {}
    for name, (llr_in, sub_in, _) in cases.items():
        checks[f"llr fused {name}"] = fused_llr_vs_plain(*llr_in)
        checks[f"llr csym {name}"] = llr_vs_plain(*csym_operands(*llr_in))
        checks[f"subtract {name}"] = subtract_vs_plain(*sub_in)
        ops = device_ops(lambda a=sub_in: gk.subtract_known(*a))
        launches = None if ops is None else ops["by_name"].get(
            "k_subtract", 0)
        calls[name] = {"k_subtract_launches": launches,
                       "device_operations": ops,
                       "graph_ms": cuda_ms(
                           lambda a=sub_in: gk.subtract_known(*a), 1)}
        torch.cuda.empty_cache()
    # every slot of every window a valid burst, as a crowded band fills
    # the decoders' 16: the work queue then takes every pass a call opens
    full = burst_case(ft8.SPEC, ldpc.ft8_code(), (16,) * 4, seed=SEED + 60,
                      n_slots=16)
    checks["subtract ft8 every slot filled"] = subtract_vs_plain(
        ft8.SPEC, *(torch.from_numpy(x).to(dev) for x in full[:3]))
    torch.cuda.synchronize()
    for name, c in checks.items():
        print(f"gfsk kernel vs plain, {name}: {json.dumps(c)}")
    for name, c in calls.items():
        print(f"subtract_known per call, {name}: {json.dumps(c)}")
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"GFSK kernels disagree with the plain "
                             f"versions: {bad}")
    if checks["subtract ft8 every slot filled"]["steps"] != 64:
        raise AssertionError("the filled-slot case fitted "
                             f"{checks['subtract ft8 every slot filled']}")
    many = {n: c["k_subtract_launches"] for n, c in calls.items()
            if c["k_subtract_launches"] not in (None, 1)}
    if many:
        raise AssertionError(f"subtract_known launched its kernel other "
                             f"than once a call: {many}")
    # every angle the kernel meets: FT8's phase to ~2.4e5 rad, FST4-1800's
    # to ~1e7, and the small twists
    rng = np.random.default_rng(SEED + 50)
    x = np.concatenate([rng.uniform(-1e7, 1e7, 1 << 20),
                        rng.uniform(-3e5, 3e5, 1 << 20),
                        rng.uniform(-10, 10, 1 << 18)]).astype(np.float32)
    trig = gk.trig_differ(torch.from_numpy(x).to(dev))
    print(f"sincosf against sinf and cosf: {trig} of {x.size} angles differ")
    if trig:
        raise AssertionError("sincosf rounds otherwise than sinf and cosf")

    # device time at the main path's shapes: the kernels in a CUDA graph,
    # in turns around the plain versions on the card issued from the host
    # (the plain subtraction syncs with the host once a burst); the LLR
    # kernel through both entries
    llr_in = cases["ft8 main path"][0]
    spec_l, demod, tt, f0, os_t_eff, fold, bm = llr_in
    old = csym_operands(*llr_in)
    spec_s, audio, params, gp = cases["ft8 main path"][1]
    runs = {
        "subtract_known": (
            lambda: gk.subtract_known(spec_s, audio, params, gp),
            lambda: subtract.subtract_known_plain(spec_s, audio, params, gp),
            3, 3),
        "multisym_llrs": (
            lambda: gk.candidate_llrs(*llr_in),
            lambda: gfsk_engine.candidate_llrs_plain(*llr_in), 10, 3),
        "multisym_llrs_csym": (
            lambda: gk.multisym_llrs(*old),
            lambda: gfsk_engine._multisym_llrs_plain(*old), 10, 3)}
    m = tt.numel()
    bounds = {"subtract_known": subtract_bound_ms(spec_s, audio, params, gp),
              "multisym_llrs": llr_bound_ms(spec_l, m, True, fold),
              "multisym_llrs_csym": llr_bound_ms(spec_l, m, False)}
    prefix = {"subtract_known": "subtract", "multisym_llrs": "llr fused",
              "multisym_llrs_csym": "llr csym"}
    errs = {name: max(c["max_abs_err"] for cn, c in checks.items()
                      if cn.startswith(prefix[name]))
            for name in runs}
    out = stage_kernel_times(runs, bounds, errs,
                             {"subtract_known": list(params.shape),
                              "multisym_llrs": [list(demod.shape),
                                                list(tt.shape)],
                              "multisym_llrs_csym": list(old[1].shape)})
    out["subtract_known"]["per_call"] = calls["ft8 main path"]
    return {"kernels": out, "llr_stage": llr_stage_turns(llr_in),
            "checks": checks, "per_call": calls, "trig_differ": trig}


def llr_stage_turns(llr_in) -> dict:
    """The FT8 main path's LLR stage on the same inputs, in turns fused,
    old, old, fused: the fused call (one launch from the demod
    spectrogram) against the route before it (the plain gather and
    rotation, then the csym entry), each as the device time the profiler
    sums over its operations and as the time issued from the host between
    CUDA events."""
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk

    routes = {"fused": lambda: gk.candidate_llrs(*llr_in),
              "old_route": lambda: gk.multisym_llrs(*csym_operands(*llr_in))}
    got: dict = {name: {"device_ms": [], "eager_ms": [], "events": None}
                 for name in routes}
    for name in ("fused", "old_route", "old_route", "fused"):
        ops = device_ops(routes[name])
        if ops is not None:
            got[name]["device_ms"].append(ops["busy_ms"])
            got[name]["events"] = ops["events"]
        got[name]["eager_ms"].append(eager_ms(routes[name], 5))
        torch.cuda.empty_cache()
    print(f"LLR stage, FT8 main path, fused against the old route: "
          f"{json.dumps(got)}")
    return got


def tie_case(spec, dev) -> tuple:
    """Sync-search operands of two windows at the mode's decode_program
    shapes where every score ties: window 0 a constant power map and
    demod (every offset of the refinement ties too), window 1 all zero
    (base 0, every score 0).  (spec, power_sync, demod, base, n_hops,
    refine)."""
    n_samples = int(round(spec.trperiod * 12_000))
    n_hops = (n_samples - spec.sps) // spec.hop + 1
    ph, n_bins = spec.pad_hops, spec.bin_range[2]
    power = torch.zeros((2, n_hops + 2 * ph, n_bins), dtype=torch.bfloat16,
                        device=dev)
    power[0] = 1.0
    demod = torch.zeros((2, 2 * n_hops - 1 + 4 * ph, n_bins),
                        dtype=torch.complex64, device=dev)
    demod[0] = 1.0 + 1.0j
    base = power[:, ph : ph + n_hops].to(torch.float32).mean(
        dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    return spec, power, demod, base, n_hops, spec.refine


def odd_case(spec, dev, seed: int = SEED + 47) -> tuple:
    """Sync-search operands of two windows at the mode's decode_program
    shapes (``tie_case``'s) whose bf16 power map is exponential noise with
    NaN, +inf, -inf and -0.0 cells (so NaN and infinite scores, and NMS
    windows that hold them); base is the noise's before those cells went
    in, so the other scores stay finite.  (spec, power_sync, demod, base,
    n_hops, refine)."""
    spec, ps, demod, _, n_hops, refine = tie_case(spec, dev)
    rng = np.random.default_rng(seed)
    power = rng.exponential(1.0, tuple(ps.shape)).astype(np.float32)
    ph = spec.pad_hops
    base = torch.from_numpy(power[:, ph : ph + n_hops]).to(
        torch.bfloat16).to(torch.float32).mean(
        dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    flat = power.reshape(-1)
    for val, count in ((np.nan, 20), (np.inf, 30), (-np.inf, 10),
                       (-0.0, 200)):
        flat[rng.choice(flat.size, count, replace=False)] = val
    return (spec, torch.from_numpy(power).to(torch.bfloat16).to(dev), demod,
            base.to(dev), n_hops, refine)


def sync_cases(dev, cases: dict) -> dict:
    """The sync-search operands the decoders hand over, by case: the FT8
    main path's first 24-window call of pass 1 (also at top_k 32768, the
    selection's widest: 16384 a half) and its first call at the later
    passes' top_k, FT4 at depth 3, JS8 and FST4W-1800 at its device batch
    (the rfft branch), all from ``gfsk_cases``; the App's FST4-60
    (``highestdecodefreq`` 3000 Hz: the rfft branch) on 8 windows; FT8's
    all-tie windows (``tie_case``) and FT8 windows holding NaN and +-inf
    (``odd_case``).  {name: (spec, power_sync, demod, base, n_hops,
    refine)}."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sk
    from cwsl_digi_tpu_torch.modes import fst4, ft8

    ft8_in = cases["ft8 main path"][2]
    if len(ft8_in) < 2:
        raise AssertionError("the FT8 main path ran no later pass")
    widest = (dataclasses.replace(ft8_in[0][0], top_k=2 * sk.SELECT_MAX_K),
              *ft8_in[0][1:])
    out = {"ft8 main path pass 1": ft8_in[0],
           "ft8 main path pass 1 at top_k 32768": widest,
           "ft8 main path pass 2": ft8_in[1]}
    for name in ("ft4 depth 3", "js8", "fst4w-1800"):
        out[name] = cases[name][2][0]
    dec = fst4.FST4Decoder(Mode.FST4_60, fmax_hz=3000.0, device=dev)
    if dec.spectrogram_branch != "rfft":
        raise AssertionError(f"the App's FST4-60 runs the "
                             f"{dec.spectrogram_branch} branch")
    audio = torch.from_numpy(_gfsk_mode_windows("FST4-60", 8, SEED + 45))
    out["fst4-60 app band"] = record_gfsk_inputs(dec, audio.to(dev))[2][0]
    out["ft8 constant and all-zero windows"] = tie_case(ft8.SPEC, dev)
    out["ft8 nan and inf"] = odd_case(ft8.SPEC, dev)
    return out


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of a (on the card) and b (on the CPU) that differ: by their
    bits for floats, where both are NaN by nothing (a NaN's payload and
    sign are the hardware's: x86 keeps an operand's and makes 0xffc00000
    of inf - inf, the card makes 0x7fffffff; ``_nan_payloads_differ``
    counts those), by value for integers."""
    a = a.cpu()
    if a.dtype == torch.float32:
        differ = a.view(torch.int32) != b.view(torch.int32)
        return int((differ & ~(a.isnan() & b.isnan())).sum())
    return int((a != b).sum())


def _abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| of a (on the card) and b (on the CPU), entries
    that are equal or both NaN counting 0 (so equal infinities and NaN
    scores leave it finite); NaN where one is NaN and the other not."""
    a = a.cpu()
    same = (a == b) | (a.isnan() & b.isnan())
    return float(torch.where(same, 0.0, (a - b).abs()).max())


def _nan_payloads_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries where a (on the card) and b (on the CPU) are both NaN with
    other bits."""
    a = a.cpu()
    return int(((a.view(torch.int32) != b.view(torch.int32))
                & a.isnan() & b.isnan()).sum())


def sync_vs_plain(spec, power_sync, demod, base, n_hops, refine, *,
                  cluster: int | None = None) -> dict:
    """The three sync kernels, one launch each (the selection's blocks a
    cluster forced to ``cluster`` where given), and the stage's wrapper (the
    card's own plan) against the plain versions on CPU copies: score and
    NMS map bit for bit, top_val bit for bit (a NaN as any NaN:
    ``_bits_differ``), top_idx and tt identical; beside it the plain
    version on the card against the same (CUDA's complex abs may round
    |z| otherwise than the CPU's, which the refinement's bf16 sums see)."""
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sk
    from cwsl_digi_tpu_torch.modes import gfsk_engine as ge

    score, nms = sk.sync_score(spec, power_sync, base)
    top_val, t0, f0 = sk.sync_select(spec, score, nms, cluster=cluster)
    tt = sk.sync_refine(spec, demod, t0, f0) if refine else t0
    full = sk.sync_candidates(spec, power_sync, demod, base, n_hops, refine)

    def cpu(x):
        return None if x is None else x.cpu()

    p_score, p_nms = ge.sync_score_plain(spec, cpu(power_sync), cpu(base))
    p_val, p_idx = ge.sync_select_plain(spec, p_score, p_nms)
    n_f0 = p_score.shape[2]
    p_t0, p_f0 = p_idx // n_f0, p_idx % n_f0
    p_tt = ge.sync_refine_plain(spec, cpu(demod), p_t0, p_f0) if refine \
        else p_t0
    card = ge.sync_candidates_plain(spec, power_sync, demod, base, n_hops,
                                    refine)
    res = {"windows": power_sync.shape[0], "scores": score.numel(),
           "top_k": spec.top_k, "refine": refine, "cluster": cluster,
           "score_bits_differ": _bits_differ(score, p_score),
           "nms_bits_differ": _bits_differ(nms, p_nms),
           "top_val_bits_differ": _bits_differ(top_val, p_val),
           "top_idx_differ": _bits_differ(t0 * n_f0 + f0, p_idx),
           "tt_differ": _bits_differ(tt, p_tt),
           "nan_payloads_differ": _nan_payloads_differ(score, p_score)
           + _nan_payloads_differ(top_val, p_val),
           "wrapper_differs": sum(_bits_differ(a, b.cpu()) for a, b in zip(
               full[:4], (top_val, t0, f0, tt))) + int(
               full[4] != (2 * spec.os_t if refine else spec.os_t)),
           "max_abs_err": {
               "sync_score": _abs_err(score, p_score),
               "sync_select": _abs_err(top_val, p_val),
               "sync_refine": float((tt.cpu() - p_tt).abs().max())},
           "card_plain_differs": {
               "top_idx": _bits_differ(card[1] * n_f0 + card[2], p_idx),
               "tt": _bits_differ(card[3], p_tt)}}
    res["ok"] = not any(res[k] for k in (
        "score_bits_differ", "nms_bits_differ", "top_val_bits_differ",
        "top_idx_differ", "tt_differ", "wrapper_differs"))
    return res


def sync_bounds(spec, power_sync, demod, t0, f0) -> dict:
    """{kernel: (bytes ms, ops ms, counts)} of the sync search of one call:
    sync_score reads once the cells of the power map that some score needs
    (each sync cell's n_t0 x n_f0 window; not the padding rows below and
    above nor the bins past the last tone) and base, writes the score and
    the NMS map once, and does a float add a cell, a division and the
    (os_t+1)(os_f+1) compares of the NMS a score (``fused_with_select``:
    the bytes of score and selection as one kernel, with no map written
    and read back); sync_select reads both
    maps and writes top_val, t0 and f0 once, and compares each score once
    (the least any selection does); sync_refine reads each distinct demod
    cell its candidates need (counted on this call's t0 and bins) and t0
    and f0, writes tt, and does |z|^2 (two products, an add, a square
    root, a square), the bf16 rounding and an add a cell and offset, and
    the argmax and clamp.  Operations at FP32_OPS (``ops_ms_fma_rate``:
    at FP32_FLOPS)."""
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sk

    b, h, f = power_sync.shape
    n_t0, n_f0 = sk.grid(spec)
    n = n_t0 * n_f0
    cells = len(spec.sync_cells)
    k = spec.top_k

    def entry(n_bytes, ops, extra):
        return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
                {"bytes": n_bytes, "ops": ops,
                 "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3, **extra})

    read = np.zeros((h, f), bool)
    for sym, tone in spec.sync_cells:
        r, c = spec.os_t * sym, spec.os_f * tone
        read[r : r + n_t0, c : c + n_f0] = True
    power_bytes = b * int(read.sum()) * 2
    top_bytes = b * k * (4 + 8 + 8)
    fused = power_bytes + b * 4 + top_bytes
    out = {
        "sync_score": entry(
            power_bytes + b * 4 + 2 * b * n * 4,
            b * n * (cells + (spec.os_t + 1) * (spec.os_f + 1)),
            {"power_bytes_read": power_bytes,
             "fused_with_select": {"bytes": fused,
                                   "ms": fused / HBM_BYTES_S * 1e3}}),
        "sync_select": entry(2 * b * n * 4 + top_bytes, 2 * b * n, {})}
    if demod is not None:
        rows = torch.as_tensor([2 * spec.os_t * s for s, _ in spec.sync_cells],
                               device=t0.device)
        cols = torch.as_tensor([spec.os_f * t for _, t in spec.sync_cells],
                               device=t0.device)
        r = (2 * t0[:, :, None, None] + torch.arange(3, device=t0.device)
             [:, None] - 1 + rows)                     # [B, K, 3, cells]
        c = (f0[:, :, None, None] + cols).expand_as(r)
        w = torch.arange(b, device=t0.device)[:, None, None, None]
        inside = (r >= 0) & (r < demod.shape[1])
        key = ((w * demod.shape[1] + r) * demod.shape[2] + c)[inside]
        uniq = int(torch.unique(key).numel())
        out["sync_refine"] = entry(
            uniq * 8 + b * k * 8 * 3,
            b * k * (3 * cells * 7 + 4), {"distinct_cells": uniq})
    return out


def sync_kernels_phase(dev, cases: dict | None = None) -> dict:
    """The ``sync_score``, ``sync_select`` and ``sync_refine`` kernels
    against their plain versions on CPU copies of the inputs the decoders
    hand them (``sync_cases``); then each kernel's device time at the FT8
    main path's first-pass shape beside the plain version's on the card
    and the bound, ``torch.topk`` of the same two maps as the selection's
    library yardstick, and the whole stage issued from the host through
    the kernels and through the plain version."""
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sk
    from cwsl_digi_tpu_torch.modes import gfsk_engine as ge

    s_cases = sync_cases(dev, cases or gfsk_cases(dev))
    runs = [(name, args, None) for name, args in s_cases.items()]
    runs += [(f"{name}, 8-block clusters", s_cases[name], 8)
             for name in ("ft8 main path pass 1",
                          "ft8 main path pass 1 at top_k 32768")]
    checks = {}
    for name, args, cluster in runs:
        checks[name] = sync_vs_plain(*args, cluster=cluster)
        print(f"sync kernels vs plain, {name}: {json.dumps(checks[name])}")
        torch.cuda.empty_cache()
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"sync kernels disagree with the plain "
                             f"versions: {bad}")
    spec, ps, demod, base, n_hops, refine = s_cases["ft8 main path pass 1"]
    design = sync_design(spec, ps.shape[0], dev)
    if design["select_plan_8"]["cluster"] != 8:
        raise AssertionError(f"8-block clusters not taken: {design}")
    score, nms = sk.sync_score(spec, ps, base)
    top_val, t0, f0 = sk.sync_select(spec, score, nms)
    b = ps.shape[0]
    k_nms = spec.top_k // 2
    runs = {
        "sync_score": (lambda: sk.sync_score(spec, ps, base),
                       lambda: ge.sync_score_plain(spec, ps, base), 20, 3),
        "sync_select": (lambda: sk.sync_select(spec, score, nms),
                        lambda: ge.sync_select_plain(spec, score, nms), 10,
                        3),
        "sync_refine": (lambda: sk.sync_refine(spec, demod, t0, f0),
                        lambda: ge.sync_refine_plain(spec, demod, t0, f0),
                        20, 3)}
    bounds = sync_bounds(spec, ps, demod, t0, f0)
    errs = {name: max(c["max_abs_err"][name] for c in checks.values())
            for name in runs}
    out = stage_kernel_times(
        runs, bounds, errs,
        {"sync_score": list(ps.shape), "sync_select": list(score.shape),
         "sync_refine": [list(demod.shape), list(t0.shape)]})
    lib = cuda_ms(lambda: (torch.topk(nms.reshape(b, -1), k_nms),
                           torch.topk(score.reshape(b, -1),
                                      spec.top_k - k_nms)), 10)
    out["sync_select"]["library_ms"] = lib
    print(f"sync_select library yardstick: torch.topk of both maps "
          f"{lib:.4f} ms device time")
    c8 = cuda_ms(lambda: sk.sync_select(spec, score, nms, cluster=8), 10)
    out["sync_select"]["cluster8_ms"] = c8
    print(f"sync_select at 8-block clusters {c8:.4f} ms device time, at the "
          f"card's own plan ({design['select_plan']['cluster']} blocks) "
          f"{out['sync_select']['ms']:.4f} ms")
    stage = {
        "kernels_ms": eager_ms(lambda: sk.sync_candidates(
            spec, ps, demod, base, n_hops, refine), 5),
        "plain_ms": eager_ms(lambda: ge.sync_candidates_plain(
            spec, ps, demod, base, n_hops, refine), 5)}
    print(f"sync stage, FT8 main path pass 1, issued from the host: "
          f"{json.dumps(stage)}")
    return {"kernels": out, "checks": checks, "stage": stage,
            "design": design}


def sync_design(spec, b: int, dev) -> dict:
    """What the kept sync_select and sync_score designs are on this card at
    ``spec``'s call of ``b`` windows: the selection's cut (blocks a
    cluster, threads a block, keys a block and of them on chip, dynamic
    shared memory, the clusters the card holds at once), also forced to
    8-block clusters (``select_plan_8``), and each kernel's
    registers, spilled (local) bytes and static shared memory as
    ``cudaFuncGetAttributes`` gives them (ptxas's own report of every
    kernel is printed with the build).  Printed on one line."""
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sk

    out = {"select_plan": sk.select_plan(spec, b, dev),
           "select_plan_8": sk.select_plan(spec, b, dev, cluster=8),
           "attrs": sk.kernel_attrs(dev, len(spec.sync_cells))}
    print(f"sync kernels' design, {spec.name} x {b} windows: "
          f"{json.dumps(out)}")
    return out


def _plan():
    """64 dials across the band and the bursts: (dial index, message,
    audio offset Hz, SNR dB in 2.5 kHz, dt s)."""
    dials = [LO + int(round(-FS / 2 + i * (FS - 6000) / 63))
             for i in range(64)]
    bursts = [
        (1, "CQ K1ABC FN42", 1500.0, 0.0, 0.0),
        (4, "K1ABC W9XYZ EN37", 800.0, -3.0, 0.2),
        (7, "W9XYZ K1ABC -11", 2200.0, -6.0, -0.1),
        (10, "CQ DL7ACA JO40", 1250.0, -9.0, 0.4),
        (13, "G4ABC VE3XYZ RR73", 650.0, -12.0, 0.0),
        (16, "VE3XYZ G4ABC R-15", 1900.0, -14.0, 0.3),
        (19, "CQ JA1XYZ PM95", 2500.0, -16.0, -0.2),
        (22, "K2DEF N0XYZ EM28", 1000.0, -18.0, 0.1),
        (25, "W1AW K9ABC EN52", 1750.0, -18.0, 0.6),
        (28, "W2AXR N3XYZ FM19", 1400.0, -15.0, 0.2),   # my-call AP
        (31, "CQ F5ABC JN18", 1125.0, -17.0, 0.0),      # CQ AP
        (34, "CQ VK2ABC QF56", 2700.0, -8.0, 0.8),
        (37, "KA1ABC KB2DEF FN31", 550.0, -10.0, 1.1),
        (40, "CQ PY2ABC GG66", 2050.0, -13.0, -0.3),
        (43, "OH2ABC SM5DEF JO89", 1600.0, -11.0, 0.5),
        (46, "CQ ZL1ABC RF72", 925.0, -7.0, 0.0),
    ]
    crowd = [("CQ AA1AA FN42", 450.0, -4.0, 0.0),
             ("AA1AA BB2BB EM10", 700.0, -8.0, 0.3),
             ("CQ CC3CC DM79", 950.0, -6.0, 0.6),
             ("CC3CC DD4DD CN87", 1200.0, -12.0, -0.2),
             ("CQ EE5EE EL98", 1450.0, -10.0, 0.9),
             ("EE5EE FF6FF DN70", 1700.0, -14.0, 0.1),
             ("CQ GG7GG EM79", 1950.0, -5.0, 0.4),
             ("GG7GG HH8HH FN20", 2200.0, -9.0, 1.2),
             ("CQ JJ9JJ EN61", 2450.0, -11.0, 0.7)]
    bursts += [(50,) + b for b in crowd]
    return dials, bursts


def _iq_noise(n: int, sigma: float, seed: int) -> np.ndarray:
    """n samples of complex64 white noise of total power sigma**2."""
    rng = np.random.default_rng(seed)
    iq = np.empty(n, np.complex64)
    iq.real = rng.standard_normal(n, dtype=np.float32)
    iq.imag = rng.standard_normal(n, dtype=np.float32)
    iq *= np.float32(sigma / np.sqrt(2))
    return iq


def _write_replay(path: Path, dials, bursts) -> list[tuple[str, int]]:
    """16 s of seeded 192 kHz IQ with the bursts; returns the expected
    (callsign, RF Hz) spots, each on every dial whose 200-3000 Hz search
    range holds the burst's tone 0."""
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.base import DecodeResult
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq
    from cwsl_digi_tpu_torch.report.spot import extract_spot

    rng = np.random.default_rng(SEED + 1)
    n = 16 * FS
    sigma = 0.05
    iq = (sigma / np.sqrt(2)) * (rng.standard_normal(n)
                                 + 1j * rng.standard_normal(n))
    expected = []
    for di, text, off, snr, dt in bursts:
        rf = dials[di] + off
        amp = sigma * np.sqrt(10 ** (snr / 10) * 2500.0 / FS)
        b = amp * gfsk_modulate_iq(ft8.encode_message(text), rf - LO,
                                   ft8.SPS * FS // 12_000, FS,
                                   ft8.TONE_SPACING)
        s = int((ft8.SIGNAL_START_S + dt) * FS)
        iq[s : s + len(b)] += b
        for dial in dials:
            if 200.0 <= rf - dial <= 3000.0:
                spot = extract_spot(DecodeResult(text, snr, dt, rf - dial),
                                    dial)
                expected.append((spot.callsign, spot.freq_hz))
    np.save(path, iq.astype(np.complex64))
    return expected


def _run_app(dev, ini: Path, n_windows, timeout_s: float,
             on_anchor=None) -> dict:
    """Run the port's App on ``ini`` until ``n_windows()`` channel-windows
    are decoded: its spots, the jobs handed to the pool and every kernel's
    launches in the run.  The App starts the replay on its own anchor, the
    next UTC 15 s boundary;
    ``on_anchor(utc_anchor)``, if given, runs once with that anchor just
    before the receiver opens the file (to write a replay that fits it)."""
    from cwsl_digi_tpu_torch.config import load_config
    from cwsl_digi_tpu_torch.runtime.app import App

    app = App(load_config(ini), max_runtime_s=timeout_s + 60, device=dev)
    spots, jobs = [], []
    orig_handle, orig_push = app.spots.handle, app.pool.push
    orig_setup = app.setup_receivers
    anchors = []

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s:
            spots.append(s)
        return s

    def push(job):
        jobs.append((job.mode.value, job.epoch_time, job.audio.device.type,
                     tuple(job.audio.shape)))
        orig_push(job)

    def setup(utc_anchor):
        if not anchors:
            anchors.append(utc_anchor)
            if on_anchor is not None:
                on_anchor(utc_anchor)
        orig_setup(utc_anchor)

    app.spots.handle = capture
    app.pool.push = push
    app.setup_receivers = setup

    # App.run warms the decoders up (one strong window through every pass)
    # before it starts the receiver
    _reset_launches()
    t0 = time.monotonic()
    runner = threading.Thread(target=app.run, daemon=True)
    try:
        runner.start()
        deadline = time.monotonic() + timeout_s
        while app.pool.count_decoded_windows < n_windows() \
                and time.monotonic() < deadline and runner.is_alive():
            time.sleep(0.2)
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
        counts = _launch_counts()
    finally:
        app._terminate = True
        runner.join(timeout=60)
    if runner.is_alive():
        raise RuntimeError("app did not shut down")
    rx_stage = [rx.stage for rx in app.receivers.values()]
    if rx_stage:
        print(f"channelize host wall {rx_stage[0]['channelize_wall_s']:.3f} s"
              f" for {rx_stage[0]['channelized_audio_s']:.2f} s of audio")
    return {"spots": spots, "jobs": jobs, "launches": counts["channelize"],
            "kernel_launches": counts, "run_s": run_s,
            "decoded": app.pool.count_decoded_windows,
            "stage_log": list(app.pool.stage_log),
            "anchor": anchors[0] if anchors else None}


def _kernel_modules() -> tuple:
    """The port's kernel libraries, each with its ``launches`` dict."""
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels, _sync_kernels
    from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels

    return _kernels, ldpc_kernels, _gfsk_kernels, _sync_kernels


def _reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _kernel_modules():
        for name in mod.launches:
            mod.launches[name] = 0


def _launch_counts() -> dict:
    """{kernel: launches since the last ``_reset_launches``}, every
    library's."""
    return {name: n for mod in _kernel_modules()
            for name, n in mod.launches.items()}


def _require_launches(where: str, counts: dict, names) -> None:
    """Fail unless each kernel of ``names`` was launched in ``where``."""
    print(f"{where}: kernel launches {counts}")
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{where} did not launch {missing}")


def _check_spots(spots, expected) -> None:
    """Every expected (callsign, RF Hz) spot within SPOT_TOL_HZ, no other."""
    got = [(s.callsign, s.freq_hz) for s in spots]
    for s in sorted(spots, key=lambda s: s.freq_hz):
        print(f"  spot {s.mode.value:>9} {s.freq_hz} {s.snr_db:+d} dB "
              f"{s.dt_s:+.2f} s {s.message}")
    missing = [e for e in expected if not any(
        c == e[0] and abs(f - e[1]) <= SPOT_TOL_HZ for c, f in got)]
    extra = [g for g in got if not any(
        c == g[0] and abs(f - g[1]) <= SPOT_TOL_HZ for c, f in expected)]
    print(f"spots: {len(got)} found, {len(expected)} expected, "
          f"missing {missing}, extra {extra}")
    if missing or extra:
        raise AssertionError("decoded spots differ from the injected bursts")


def main_path_phase(dev, workdir: Path) -> dict:
    """The port's App end to end on a 64-channel FT8 replay."""
    dials, bursts = _plan()
    iq_path = workdir / "band.npy"
    expected = _write_replay(iq_path, dials, bursts)
    ini = workdir / "smoke.ini"
    ini.write_text("\n".join(
        ["[radio]", f"source=file:{iq_path}?sr={FS}&lo={LO}",
         "[operator]", "callsign=W2AXR", "gridsquare=FN13",
         "[decoders]"] + [f"decoder={d} FT8" for d in dials]
        + ["[logging]", "loglevel=2", "logimmediately=true"]) + "\n")
    run = _run_app(dev, ini, lambda: len(dials), 240)
    decode_s = [e["decode_s"] for e in run["stage_log"]]
    print(f"main path: {len(dials)} FT8 channels, warmup+replay+decode "
          f"{run['run_s']:.1f} s, decode batches {decode_s} s, "
          f"windows decoded {run['decoded']}")
    if run["decoded"] != len(dials):
        raise AssertionError("not every channel's window was decoded")
    _check_spots(run["spots"], expected)
    if run["launches"] <= 0:
        raise AssertionError("main path did not launch the channelizer kernel")
    _require_launches("main path", run["kernel_launches"], HAND_KERNELS)
    devices = [j[2] for j in run["jobs"]]
    if not devices or any(d != "cuda" for d in devices):
        raise AssertionError(f"decoder got non-CUDA audio: {devices}")
    return {"launches": run["launches"], "decode_s": decode_s,
            "kernel_launches": run["kernel_launches"], "run_s": run["run_s"]}


# the lines a 20 m skimmer runs on one 192 kHz receiver at LO 14.100 MHz
MIXED_LINES = [("FT8", 14_074_000), ("JS8", 14_078_000), ("FT4", 14_080_000),
               ("FST4-60", 14_095_600), ("FST4W-120", 14_095_600)]
MIXED_S = 122


def _mixed_plan():
    """Bursts of the mixed replay: (mode, window index, message, audio Hz,
    SNR dB in 2.5 kHz, dt s).  The weakest sit about 3 dB above each
    mode's 50 % decode threshold in the reference's parity sweep
    (``PARITY_REPORT.json``: FT8 -21.9, FT4 -18.0, JS8 -21.0, FST4-60
    -25.0, FST4W-120 -29.6 dB).  JS8 bursts stay below 2 kHz and FT4 bursts
    above 1.1 kHz, so neither lands in the other's channel."""
    return [
        ("FT8", 0, "CQ K1ABC FN42", 1500.0, -5.0, 0.0),
        ("FT8", 2, "K1ABC W9XYZ EN37", 800.0, -12.0, 0.2),
        ("FT8", 2, "W9XYZ K1ABC -11", 2200.0, -19.0, -0.1),
        ("FT8", 5, "CQ DL7ACA JO40", 1250.0, -16.0, 0.4),
        ("FT4", 1, "CQ VE3XYZ EN93", 1200.0, -5.0, 0.0),
        ("FT4", 4, "VE3XYZ G4ABC IO91", 2000.0, -10.0, 0.1),
        ("FT4", 9, "G4ABC VE3XYZ R-15", 1600.0, -15.0, -0.1),
        ("FT4", 14, "CQ JA1XYZ PM95", 2500.0, -12.0, 0.2),
        ("JS8", 0, "KN4CRD: HB EN50", 1000.0, -8.0, 0.1),
        ("JS8", 3, "W2AXR: K1ABC SNR -12", 1500.0, -18.0, 0.3),
        ("JS8", 6, "CQCQ N0XYZ", 700.0, -12.0, 0.0),
        ("FST4-60", 0, "CQ F5ABC JN18", 1000.0, -12.0, 0.0),
        ("FST4-60", 1, "F5ABC OH2ABC KP20", 1050.0, -22.0, 0.5),
        ("FST4W-120", 0, "K1ABC FN42 30", 1500.0, -26.0, 0.0),
    ]


def _mode_burst(mode: str, text: str):
    """(tones, samples per symbol at 12 kHz, tone spacing, BT, signal start
    s) of one burst of ``mode``."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import fst4, ft4, ft8, js8, jt65, q65, wspr

    if mode == "WSPR":
        call, grid, dbm = text.split()
        return (wspr.encode(call, grid, int(dbm)), wspr.SPS,
                wspr.TONE_SPACING, 2.0, wspr.SIGNAL_START_S)
    if mode in ("JT65", "Q65-30"):
        mod = jt65 if mode == "JT65" else q65
        return (mod.encode_message(text), mod.SPS, mod.TONE_SPACING, 2.0,
                mod.SPEC.signal_start_s)
    if mode in ("FT8", "FT4", "JS8"):
        mod = {"FT8": ft8, "FT4": ft4, "JS8": js8}[mode]
        spec = mod.SPEC
        tones = mod.encode_message(text)
    else:
        spec = fst4.make_spec(Mode(mode))
        tones = fst4.encode_message(text, Mode(mode))
    return tones, spec.sps, spec.tone_spacing, spec.bt, spec.signal_start_s


def _line_windows(utc_anchor: float, lines
                  ) -> tuple[float, dict[str, list[float]]]:
    """The lead-in and the windows of a replay of ``lines`` that starts at
    ``utc_anchor`` (a UTC multiple of 15 s): the lead-in
    runs to the next 2-minute boundary, where every mode's windows begin
    and the bursts start, and MIXED_S s follow it.  Returns the lead-in in
    seconds and, per line, the UTC starts of the windows the receiver must
    close: each mode's consecutive periods from its own first boundary at
    or after the anchor, up to the end of the file."""
    from cwsl_digi_tpu_torch.constants import get_rx_period

    lead = -utc_anchor % 120.0
    end = utc_anchor + lead + MIXED_S
    starts = {}
    for m, _ in lines:
        trp = get_rx_period(m)
        first = -(-utc_anchor // trp) * trp
        starts[m] = [first + k * trp
                     for k in range(int((end - first) // trp))]
    return lead, starts


def _write_lines_replay(path: Path, lead_s: float, lines, plan, seed: int
                        ) -> list[tuple[str, int]]:
    """``lead_s`` s of seeded noise, then MIXED_S s of seeded 192 kHz IQ
    with the bursts of ``plan`` on ``lines`` (the same samples whatever the
    lead-in); returns the expected (callsign, RF Hz) spots by each mode's
    spot grammar."""
    from cwsl_digi_tpu_torch.constants import Mode, get_rx_period
    from cwsl_digi_tpu_torch.modes.base import DecodeResult
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq
    from cwsl_digi_tpu_torch.report.spot import extract_spot

    sigma = 0.05
    iq = _iq_noise(MIXED_S * FS, sigma, seed)
    dial_of = dict(lines)
    expected = []
    for mode, wi, text, off, snr, dt in plan:
        tones, sps, spacing, bt, start_s = _mode_burst(mode, text)
        rf = dial_of[mode] + off
        amp = sigma * np.sqrt(10 ** (snr / 10) * 2500.0 / FS)
        b = amp * gfsk_modulate_iq(tones, rf - LO, sps * FS // 12_000, FS,
                                   spacing, bt=bt)
        s = int((wi * get_rx_period(mode) + start_s + dt) * FS)
        iq[s : s + len(b)] += b.astype(np.complex64)
        spot = extract_spot(DecodeResult(text, snr, dt, off, mode=Mode(mode)),
                            dial_of[mode])
        expected.append((spot.callsign, spot.freq_hz))
    np.save(path, np.concatenate(
        [_iq_noise(int(round(lead_s * FS)), sigma, seed + 2), iq]))
    return expected


def _replay_phase(dev, workdir: Path, name: str, lines, plan, seed: int,
                  used) -> dict:
    """The port's App on a replay of ``lines`` with the bursts of ``plan``,
    written once the App has taken its anchor (noise to the next 2-minute
    boundary, then MIXED_S s): every line's windows on their own UTC
    boundaries, the expected spots and no other, through the channelizer
    kernel and each hand kernel of ``used``, with CUDA tensors reaching the
    decoders."""
    iq_path = workdir / f"{name}.npy"
    ini = workdir / f"{name}.ini"
    ini.write_text("\n".join(
        ["[radio]", f"source=file:{iq_path}?sr={FS}&lo={LO}",
         "[operator]", "callsign=W2AXR", "gridsquare=FN13",
         "[decoders]"] + [f"decoder={d} {m}" for m, d in lines]
        + ["[logging]", "loglevel=2", "logimmediately=true"]) + "\n")
    state = {}

    def write(utc_anchor):
        lead, state["starts"] = _line_windows(utc_anchor, lines)
        state["n"] = sum(len(v) for v in state["starts"].values())
        state["lead"] = lead
        state["expected"] = _write_lines_replay(iq_path, lead, lines, plan,
                                                 seed)

    run = _run_app(dev, ini, lambda: state.get("n", 1 << 30), 480, write)
    batches = [(e["mode"], e["decode_s"]) for e in run["stage_log"]]
    print(f"{name} path: {len(lines)} lines, replay from UTC "
          f"{run['anchor']:g} with a {state['lead']:g} s lead-in to the "
          f"2-minute boundary, warmup+replay+decode {run['run_s']:.1f} s, "
          f"windows decoded {run['decoded']} of {state['n']}, decode batches "
          f"(mode, s) {batches}")
    if run["decoded"] != state["n"]:
        raise AssertionError("not every line's windows were decoded")
    # each mode's windows close on its own UTC boundaries, the first at or
    # after the App's anchor
    epochs = {m: sorted(j[1] for j in run["jobs"] if j[0] == m)
              for m, _ in lines}
    for m, _ in lines:
        if epochs[m] != state["starts"][m]:
            raise AssertionError(f"{m} windows at {epochs[m]}, want "
                                 f"{state['starts'][m]}")
    print(f"window epochs from the anchor {run['anchor']:g}: " + ", ".join(
        f"{m} {[e - run['anchor'] for e in v]}" for m, v in epochs.items()))
    _check_spots(run["spots"], state["expected"])
    if run["launches"] <= 0:
        raise AssertionError(f"{name} path did not launch the channelizer "
                             "kernel")
    _require_launches(f"{name} path", run["kernel_launches"], used)
    devices = {j[2] for j in run["jobs"]}
    if devices != {"cuda"}:
        raise AssertionError(f"decoder got non-CUDA audio: {devices}")
    return {"launches": run["launches"],
            "kernel_launches": run["kernel_launches"], "decode_batches": batches,
            "run_s": run["run_s"], "windows": run["decoded"],
            "lead_s": state["lead"]}


def mixed_mode_phase(dev, workdir: Path) -> dict:
    """The port's App on the mixed-mode replay."""
    return _replay_phase(dev, workdir, "mixed-mode", MIXED_LINES,
                         _mixed_plan(), SEED + 2, HAND_KERNELS)


# the weak-signal lines of the same 20 m receiver: WSPR beside FST4W on
# 14.0956 MHz, JT65 on 14.076 MHz, and Q65-30 on a dial of its own in the
# span (the reference's config names no 20 m Q65 dial)
WEAK_LINES = [("WSPR", 14_095_600), ("JT65", 14_076_000),
              ("Q65-30", 14_079_500)]


def _weak_plan():
    """Bursts of the weak-mode replay: (mode, window index, message, audio
    Hz, SNR dB in 2.5 kHz, dt s).  The weakest sit at least about 3 dB above
    each mode's 50 % decode threshold in the reference's parity sweep
    (``PARITY_REPORT.json``: WSPR -31, JT65 -24, Q65-30 -24.6 dB).  The two
    WSPR bursts share a window 2 dB apart: WSPR's top-K has no
    non-maximum suppression, so a burst 6 dB above another fills the 24
    candidates with its own time and drift neighbours and the weaker one
    is never tried (the reference does the same)."""
    return [
        ("WSPR", 0, "K1ABC FN42 37", 1460.0, -24.0, 0.0),
        ("WSPR", 0, "W2AXR FN13 30", 1540.0, -26.0, 0.0),
        ("JT65", 0, "CQ DL7ACA JO40", 1270.0, -10.0, 0.0),
        ("JT65", 1, "DL7ACA K1ABC FN42", 1500.0, -21.0, 0.2),
        ("Q65-30", 0, "CQ VE3XYZ EN93", 1000.0, -8.0, 0.0),
        ("Q65-30", 1, "VE3XYZ G4ABC IO91", 1200.0, -13.0, 0.1),
        ("Q65-30", 2, "G4ABC VE3XYZ R-15", 1400.0, -17.0, 0.0),
        ("Q65-30", 3, "CQ JA1XYZ PM95", 1600.0, -21.0, 0.2),
    ]


def weak_modes_phase(dev, workdir: Path) -> dict:
    """The port's App on the weak-mode replay (WSPR, JT65, Q65-30): WSPR's
    OSD runs the ``osd`` kernel; none of the three has an LDPC code or
    runs the GFSK engine, so ``bp_minsum``, ``subtract_known``,
    ``multisym_llrs`` and the sync kernels have no launch here."""
    return _replay_phase(dev, workdir, "weak-modes", WEAK_LINES,
                         _weak_plan(), SEED + 5, ("osd",))


# (mode, message, audio Hz, SNR dB, seed): the reference's long-period
# round trips (tests/test_fst4_js8.py), FST4W-900 as a strong burst at the
# int16 scale of host-fed audio
LONG_WINDOWS = [("FST4-300", "K1ABC W9XYZ EN37", 1000.0, -20.0, 0),
                ("FST4-900", "K1ABC W9XYZ EN37", 1000.0, -24.0, 0),
                ("FST4-1800", "K1ABC W9XYZ EN37", 1000.0, -26.0, 0),
                ("FST4W-300", "K1ABC FN42 30", 1500.0, -24.0, 0),
                ("FST4W-900", "K1ABC FN42 30", 1500.0, 25.0, 3),
                ("FST4W-1800", "K1ABC FN42 30", 1500.0, -28.0, 0)]


def long_period_phase(dev) -> dict:
    """One synthesized window of each long period through get_decoder on
    the card (host audio, int16 peak scaling): the message must decode."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import fst4
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    out = {}
    for mode, text, f0, snr, seed in LONG_WINDOWS:
        clean = fst4.synthesize(text, Mode(mode), f0, start_s=1.0)
        win = add_noise_at_snr(clean, snr, 12_000,
                               np.random.default_rng(seed)).astype(np.float32)
        dec = get_decoder(mode, device=dev)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.monotonic()
            res = dec.decode(win[None])[0]
            walls.append(time.monotonic() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        msgs = [r.message for r in res]
        print(f"{mode}: {dec.spectrogram_branch} spectrograms, decode wall "
              f"{walls[0]:.3f} s first / {walls[1]:.3f} s second, peak "
              f"device memory {peak / 2**30:.3f} GiB, decodes {msgs}")
        if text not in msgs:
            raise AssertionError(f"{mode}: {text!r} not decoded: {msgs}")
        out[mode] = {"branch": dec.spectrogram_branch, "wall_s": walls,
                     "peak_bytes": peak}
        del dec
        torch.cuda.empty_cache()
    return out


def decode_walls_phase(dev) -> dict:
    """Decode wall of one window and of a 64-window batch (device-resident
    audio, as the receiver hands it over) for FT4, JS8, FST4-60, WSPR, JT65
    and Q65-30 at their published specs: one burst per window at -5 to
    -15 dB; with the peak device memory of the 64-window WSPR batch."""
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.modes import fst4, ft4, js8, jt65, q65, wspr
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    clean = {"FT4": ft4.synthesize("CQ VE3XYZ EN93", 1200.0),
             "JS8": js8.synthesize("KN4CRD: HB EN50", 1000.0),
             "FST4-60": fst4.synthesize("CQ F5ABC JN18", Mode.FST4_60,
                                        1000.0),
             "WSPR": wspr.synthesize("K1ABC", "FN42", 37, 1500.0),
             "JT65": jt65.synthesize("CQ F5ABC JN18", 1270.0),
             "Q65-30": q65.synthesize("CQ F5ABC JN18", 1000.0)}
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for mode, c in clean.items():
        wins = np.stack([add_noise_at_snr(c, rng.uniform(-15, -5), 12_000, rng)
                         for _ in range(64)]).astype(np.float32)
        audio = torch.from_numpy(wins).to(dev)
        del wins
        dec = get_decoder(mode, device=dev)
        dec.decode(audio[:1])                       # warm-up
        walls = {}
        for n, reps in ((1, 5), (64, 3)):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.monotonic()
                res = dec.decode(audio[:n])
                times.append(time.monotonic() - t0)
            walls[n] = times
            n_dec = sum(len(r) for r in res)
            if n_dec < n:
                raise AssertionError(f"{mode}: {n_dec} decodes in {n} "
                                     "windows")
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"{mode} ({dec.spectrogram_branch}, max_device_batch "
              f"{dec.max_device_batch}): decode wall 1 window median "
              f"{statistics.median(walls[1]):.4f} s {walls[1]}, 64 windows "
              f"median {statistics.median(walls[64]):.3f} s {walls[64]}, "
              f"peak device memory of the 64-window batch "
              f"{peak / 2**30:.3f} GiB")
        out[mode] = {"wall_1_s": statistics.median(walls[1]),
                     "wall_64_s": statistics.median(walls[64]),
                     "branch": dec.spectrogram_branch,
                     "max_device_batch": dec.max_device_batch,
                     "peak_bytes_64": peak}
        del dec, audio
        torch.cuda.empty_cache()
    return out


# FT8 bursts of the skim part: (dial index, message, audio Hz, SNR dB in
# 2.5 kHz), two in each 16-channel shard of the 64 dials
SKIM_BURSTS = [(2, "CQ K1ABC FN42", 1500.0, -6.0),
               (13, "K1ABC W9XYZ EN37", 900.0, -10.0),
               (21, "CQ DL7ACA JO40", 2100.0, -8.0),
               (30, "G4ABC VE3XYZ RR73", 1250.0, -12.0),
               (37, "CQ JA1XYZ PM95", 700.0, -9.0),
               (45, "W1AW K9ABC EN52", 1800.0, -14.0),
               (52, "CQ VK2ABC QF56", 2500.0, -7.0),
               (60, "OH2ABC SM5DEF JO89", 1100.0, -11.0)]
# (a0, n_out) of blocks the time shards give the kernel, and ragged ones:
# starts that are no multiple of the 4096-sample sub-block, n_out no
# multiple of the kernel's 48-output tile, a0 up to 900 s x 192 kHz
SHARD_BLOCKS = [(3 * 43_200_000 - 496, 1001), (43_200_000 - 496, 4097),
                (172_800_000 - 496 - 16 * 333, 333), (12_345 * 16 - 496, 47)]


def skim_window() -> tuple[np.ndarray, np.ndarray, dict]:
    """The skim part's window: the 64 dials' offsets from LO, 15 s of
    seeded 192 kHz noise with the bursts of SKIM_BURSTS, and the expected
    decodes by channel (each burst on every channel whose 200-3000 Hz
    search range holds its tone 0: at 192 kHz its own channel only)."""
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq

    dials, _ = _plan()
    freqs = np.asarray(dials, np.float64) - LO
    sigma = 0.05
    iq = _iq_noise(15 * FS, sigma, SEED + 7)
    want: dict[int, list[str]] = {}
    for di, text, off, snr in SKIM_BURSTS:
        amp = sigma * np.sqrt(10 ** (snr / 10) * 2500.0 / FS)
        b = amp * gfsk_modulate_iq(ft8.encode_message(text), freqs[di] + off,
                                   ft8.SPS * FS // 12_000, FS,
                                   ft8.TONE_SPACING)
        s = int(ft8.SIGNAL_START_S * FS)
        iq[s : s + len(b)] += b.astype(np.complex64)
        for c, f in enumerate(freqs):
            if 200.0 <= freqs[di] + off - f <= 3000.0:
                want.setdefault(c, []).append(text)
    return freqs, iq, {c: sorted(m) for c, m in want.items()}


def skim_decodes(step, out: dict) -> dict[int, list[str]]:
    """The messages a skim step decoded, by channel (channels with any)."""
    from cwsl_digi_tpu_torch.modes import ft8

    return {c: sorted(r.message for r in rl)
            for c, rl in zip(step.local_channels,
                             ft8.results_from_arrays(out)) if rl}


def _plain_block(chan, iq_ext, a0: int, out_phase: int):
    """The plain version of ``chan.channelize_block`` on the same device."""
    from cwsl_digi_tpu_torch.dsp.channelizer import channelize_block_ref

    n_sub = -(-iq_ext.shape[0] // chan._sub)
    return channelize_block_ref(chan.spec, iq_ext, chan._tone_sub,
                                chan._rotations(a0, chan._sub, n_sub),
                                chan._segs, out_phase)


def same_decodes(a: dict, b: dict) -> bool:
    """Two skim outputs decode alike on every channel: the same valid
    candidates and payloads, SNR within 0.5 dB, f within one bin, dt
    within one hop (PERF.md section 2)."""
    if not np.array_equal(a["valid"], b["valid"]):
        return False
    v = a["valid"]
    return (np.array_equal(a["payload"][v], b["payload"][v])
            and np.all(np.abs(a["snr"][v] - b["snr"][v]) <= 0.5)
            and np.all(np.abs(a["f0_bin"][v] - b["f0_bin"][v]) <= 1)
            and np.all(np.abs(a["t0_hop"][v] - b["t0_hop"][v]) <= 1))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_phase(dev) -> dict:
    """The parallel layer on ``cuda:0``: the channel-sharded skim of the
    64 FT8 dials on a virtual 4-entry mesh (16 channels a shard) against a
    1-entry mesh; a 900 s window at 192 kHz time-sharded 4 ways over 4
    channels against one device's ``process_window`` and the plain
    version, its FST4W-900 burst decoded through ``get_decoder``; the
    kernel against the plain version at the shards' blocks; ``entry()``
    once; ``dryrun_multichip`` on a virtual 4-entry mesh; the skim through
    a one-rank NCCL process group.  Each part's kernel launches are counted
    from 0 just before it and read just after, its comparisons outside."""
    import torch.distributed as dist

    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
    from cwsl_digi_tpu_torch.entry import (dryrun_multichip, entry,
                                           long_window_iq)
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
    from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
    from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer

    launches, walls, errs = {}, {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        _kernels.launches["channelize"] = 0
        t = time.monotonic()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = time.monotonic() - t
        launches[name] = _kernels.launches["channelize"]
        print(f"parallel {name}: {walls[name]:.3f} s, "
              f"{launches[name]} kernel launches")
        return r

    # --- channel-sharded skim: 64 dials, 16 a shard, FT8 bursts in 8
    freqs, iq, want = skim_window()
    mesh4 = make_mesh(4, devices=[dev] * 4)
    step4 = ShardedSkimStep(FS, freqs, mesh4)
    run("skim_4x16_first", lambda: step4.step(iq))
    out4 = run("skim_4x16", lambda: step4.step(iq))
    step1 = ShardedSkimStep(FS, freqs, make_mesh(1, devices=[dev]))
    out1 = step1.step(iq)
    got = skim_decodes(step4, out4)
    print(f"skim decodes: {got}")
    if got != want:
        raise AssertionError(f"skim decodes {got}, want {want}")
    if not same_decodes(out4, out1):
        raise AssertionError("4-entry skim disagrees with the 1-entry mesh")
    print("skim: valid/payload equal to the 1-entry mesh's, bitwise "
          f"{all(np.array_equal(out4[k], out1[k]) for k in out4)}")
    x = torch.from_numpy(iq).to(dev)
    err = 0.0
    for blk in mesh4.blocks("ch", 64):
        chan = BatchChannelizer(FS, freqs[blk], device=dev)
        h = chan.spec.filt_order - chan.spec.block_size
        a = chan.process_window(x)
        b = _plain_block(chan, torch.cat([x.new_zeros(h), x]), -h, 0)
        err = max(err, float((a - b).abs().max()))
    errs["skim_shards"] = err

    # --- time shards: 900 s at 192 kHz, 4 channels, 4 shards
    tfreqs = freqs[[8, 24, 40, 56]]
    sigma = 0.05                         # the skim window's noise
    w_text = "K1ABC FN42 30"
    n_t = 900 * FS
    t0 = time.monotonic()
    iq_long = long_window_iq(FS, n_t, "FST4W-900", w_text, tfreqs[1] + 1500,
                             sigma * np.sqrt(10 ** (-15 / 10) * 2500.0 / FS),
                             sigma / np.sqrt(2), np.random.default_rng(SEED))
    print(f"900 s window built in {time.monotonic() - t0:.1f} s")
    tsc = TimeShardedChannelizer(FS, tfreqs, make_mesh(4, axes=("t",),
                                                       devices=[dev] * 4))
    audio = run("timeshard_900s", lambda: tsc.channelize(iq_long))
    chan = BatchChannelizer(FS, tfreqs, device=dev)
    whole = chan.process_window(torch.from_numpy(iq_long).to(dev))
    errs["timeshard_vs_window"] = float((audio - whole).abs().max())
    del whole
    bs, h = chan.spec.block_size, chan.spec.filt_order - chan.spec.block_size
    t_loc = n_t // 4
    err = 0.0
    for s in range(4):
        a0 = s * t_loc - h
        xs = torch.from_numpy(iq_long[max(a0, 0) : (s + 1) * t_loc]).to(dev)
        if s == 0:
            xs = torch.cat([xs.new_zeros(h), xs])
        b = _plain_block(chan, xs, a0, (s * t_loc // bs) % 4)
        err = max(err, float(
            (audio[:, s * t_loc // bs : (s + 1) * t_loc // bs] - b).abs()
            .max()))
        del xs, b
        torch.cuda.empty_cache()
    errs["timeshard_vs_plain"] = err
    n_win = 900 * 12_000
    ch_audio = audio[1, :n_win].cpu().numpy()
    del audio
    res = run("fst4w900_decode", lambda: get_decoder(
        "FST4W-900", device=dev).decode(ch_audio[None, :])[0])
    print(f"FST4W-900 time-sharded decodes: {[r.message for r in res]}")
    if w_text not in [r.message for r in res]:
        raise AssertionError("the time-sharded FST4W-900 burst did not "
                             "decode")
    # the kernel against the plain version at shard offsets and lengths
    err = 0.0
    for a0, n_out in SHARD_BLOCKS:
        lo = max(a0, 0)
        xs = torch.from_numpy(iq_long[lo : a0 + h + n_out * bs]).to(dev)
        xs = torch.cat([xs.new_zeros(lo - a0), xs])
        ph = ((a0 + h) // bs) % 4
        err = max(err, float((chan.channelize_block(xs, a0, ph)
                              - _plain_block(chan, xs, a0, ph)).abs().max()))
    errs["shard_blocks"] = err

    # device time of one launch at each shard shape, beside its bound
    shard_ms = {}
    for name, sc, a0, n_out in [
            ("skim_shard_16ch_15s", BatchChannelizer(FS, freqs[:16],
                                                     device=dev),
             -h, 15 * FS // bs),
            ("time_shard_4ch_225s", chan, 3 * t_loc - h, t_loc // bs)]:
        lo = max(a0, 0)
        xs = torch.from_numpy(iq_long[lo : a0 + h + n_out * bs]).to(dev)
        xs = torch.cat([xs.new_zeros(lo - a0), xs])
        rot = sc.tile_rotations(a0, n_out)
        ph = ((a0 + h) // bs) % 4
        ms = cuda_ms(lambda: _kernels.channelize(
            xs, sc._taps_packed, sc._coarse, rot, n_out, bs, ph,
            sc.spec.sign), 3)
        bytes_ms, ops_ms = _launch_bound(sc, xs, rot, n_out)
        shard_ms[name] = {"ms": ms, "bound_ms": max(bytes_ms, ops_ms),
                          "bytes_ms": bytes_ms, "ops_ms": ops_ms}
        print(f"kernel launch {name}: {ms:.4f} ms device time; bound "
              f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
              f"split-bf16 ops {ops_ms:.4f}), "
              f"{100 * max(bytes_ms, ops_ms) / ms:.1f} % of it")
        del xs
    del iq_long

    # --- entry(): the FT8 forward step at the reference's shapes
    fn, args = entry()
    out = run("entry", lambda: fn(*args))
    if not all(bool(torch.isfinite(v.float()).all()) for v in out.values()) \
            or tuple(out["valid"].shape) != (4, 32):
        raise AssertionError("entry() outputs")

    # --- the reference's dry run on a virtual 4-entry mesh
    run("dryrun_multichip", lambda: dryrun_multichip(4, devices=[dev] * 4))

    # --- the skim through a one-rank NCCL process group
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        step_pg = ShardedSkimStep(FS, freqs, make_mesh(axes=("ch",)))
        out_pg = run("skim_nccl_1rank", lambda: step_pg.step(iq))
        if step_pg.local_channels != list(range(64)) \
                or not same_decodes(out_pg, out1):
            raise AssertionError("one-rank NCCL skim disagrees")
    finally:
        dist.destroy_process_group()

    print(f"parallel kernel vs plain / one-device window, max abs err: "
          f"{errs} (tolerance {CHAN_TOL:g})")
    if not max(errs.values()) <= CHAN_TOL:
        raise AssertionError(f"parallel channelizer disagrees: {errs}")
    want_launches = {"skim_4x16_first": 4, "skim_4x16": 4,
                     "timeshard_900s": 4,
                     "fst4w900_decode": 0, "entry": 0,
                     "skim_nccl_1rank": 1}
    for name, n in want_launches.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"want {n}")
    if launches["dryrun_multichip"] < 10:
        raise AssertionError("dryrun_multichip launched the kernel "
                             f"{launches['dryrun_multichip']} times")
    return {"launches": sum(launches.values()), "by_part": launches,
            "walls_s": walls, "max_abs_err": max(errs.values()),
            "errs": errs, "shard_launch": shard_ms}


# the live site: 8 receivers x 64 FT8 dials, 3 windows, 6 bursts a window
SOAK = dict(channels=512, receivers=8, windows=3, bursts=6)


def live_soak_phase(dev) -> dict:
    """The port's App live at 512 FT8 channels on 8 synthetic real-time
    receivers (``tools/torch_soak.run_soak``); its kernel launches are
    counted from 0 at its start."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from torch_soak import run_soak

    _reset_launches()
    r = run_soak(device=dev, **SOAK)
    counts = _launch_counts()
    st = r["stages"]
    lw = st["lock_wait_s"]
    print(f"live soak: {r['channels']} FT8 channels on {r['receivers']} "
          f"receivers x {r['windows']} windows ({r['pool_workers']} pool "
          f"workers, decode lock wait p50/p95/max/total {lw['p50']}/"
          f"{lw['p95']}/{lw['max']}/{lw['total']} s): "
          f"{r['decoded_windows']} channel-windows decoded, "
          f"{r['spots']} spots, bursts {r['bursts_found']}/{r['bursts_due']} "
          f"found on their own receiver, misrouted {r['misrouted']}, false "
          f"{r['false_spots']}, stale drops {r['stale_drops']}, ingest "
          f"overruns {r['ingest_overruns']}; latency p50/p95/max "
          f"{r['latency_s']['p50']}/{r['latency_s']['p95']}/"
          f"{r['latency_s']['max']} s, deadline misses "
          f"{r['deadline_misses']} (deadline {r['deadline_s']:g} s); "
          f"window-close lag p50/p95/max {st['window_close_lag_s']['p50']}/"
          f"{st['window_close_lag_s']['p95']}/{st['window_close_lag_s']['max']}"
          f" s, queue wait p50/p95/max {st['queue_wait_s']['p50']}/"
          f"{st['queue_wait_s']['p95']}/{st['queue_wait_s']['max']} s, "
          f"decode_s per batch {st['decode_s_per_batch']['series']}, "
          f"channelize dispatch {st['channelize_dispatch_s_per_audio_s']} s "
          f"per audio-s; busy fraction {r['busy_fraction']}; peak device "
          f"memory {(r['peak_device_bytes'] or 0) / 2**30:.3f} GiB; "
          f"{r['channelize_launches']} kernel launches; warm-up "
          f"{r['warmup_s']} s, wall {r['wall_s']} s")
    want = r["channels"] * r["windows"]
    if r["decoded_windows"] < want:
        raise AssertionError(f"{r['decoded_windows']} channel-windows "
                             f"decoded, want {want}")
    if r["stale_drops"] or r["ingest_overruns"]:
        raise AssertionError("live soak shed windows or overran its ring")
    if r["missing"] or not r["bursts_due"]:
        raise AssertionError(f"bursts not found on their own receiver: "
                             f"{r['missing']}")
    if r["misrouted"]:
        raise AssertionError(f"{r['misrouted']} spots on another receiver")
    if r["deadline_misses"]:
        raise AssertionError(f"{r['deadline_misses']} spots later than "
                             f"{r['deadline_s']:g} s after their window")
    if r["audio_devices"] != ["cuda"]:
        raise AssertionError(f"decoder got non-CUDA audio: "
                             f"{r['audio_devices']}")
    if r["channelize_launches"] <= 0:
        raise AssertionError("live soak did not launch the channelizer "
                             "kernel")
    _require_launches("live soak", counts, HAND_KERNELS)
    return {"launches": r["channelize_launches"], "kernel_launches": counts,
            "report": {
        k: v for k, v in r.items() if k not in ("stages", "missing")}}


AP_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures" \
    / "ap_false"
FALSE_SPOTS = AP_FIXTURES.parent / "false_spots"


def ap_fixtures_phase(dev) -> dict:
    """Each committed live FT8 window with a false spot (the operator-call
    AP form, the CQ form, neither), decoded alone on the card with the
    live decoder's kwargs (``tools/torch_ap_false``): its messages must
    equal the JAX package's list stored beside it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from torch_ap_false import decode_window, fixtures

    ap, other = fixtures(AP_FIXTURES), fixtures(FALSE_SPOTS)
    if not ap or not other:
        raise AssertionError(f"no fixtures under {AP_FIXTURES} or "
                             f"{FALSE_SPOTS}")
    found = ap + other
    decoders: dict = {}
    out = {}
    for path, side in found:
        t0 = time.monotonic()
        got = decode_window(np.load(path), side, dev, decoders=decoders)
        wall = time.monotonic() - t0
        print(f"{path.name}: card {got}, JAX {side['jax']} ({wall:.2f} s)")
        if got != side["jax"]:
            raise AssertionError(f"{path.name}: the card decodes {got}, "
                                 f"the JAX package {side['jax']}")
        out[path.name] = got
    return out


def tools_phase(dev) -> dict:
    """The last ported tools once each at a tiny size on the card; their
    own lines are printed as they go."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_import_tables
    import torch_osd_calibrate
    import torch_tune_topk
    import torch_wspr_calibrate

    from cwsl_digi_tpu_torch.modes import js8_varicode

    d = str(dev)
    osd = torch_osd_calibrate.main(["--trials", "4", "--noise", "25",
                                    "--device", d])
    if osd["false_messages"]:
        raise AssertionError(f"OSD calibrator: false decodes on noise "
                             f"{osd['false_messages']}")
    topk = torch_tune_topk.main(["8", "256", "--device", d])
    if topk[0]["recall_-18"] < 0.75 or topk[0]["busy_decodes_per_window"] <= 0:
        raise AssertionError(f"top-K screen: {topk}")
    ws = torch_wspr_calibrate.main(["--trials", "2", "--noise", "12",
                                    "--snrs", "-29", "--device", d])
    if ws["near_gate_offenders"] or not ws["true_osd"]["-29.0"]:
        raise AssertionError(f"WSPR calibrator: {ws}")

    def tok(ch):     # a C string literal of varicode.cpp
        if ch == js8_varicode.EOT:
            return "\\x04"
        return ch.replace("\\", "\\\\").replace('"', '\\"')

    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "varicode.cpp"
        src.write_text("".join(f'{{"{tok(c)}", "{b}"}},\n' for c, b
                               in js8_varicode.default_table().items()))
        emitted = torch_import_tables.import_tree(src, Path(tmp) / "tables")
        if emitted != ["js8_varicode.txt"]:
            raise AssertionError(f"table import emitted {emitted}")
    return {"osd_calibrate": osd, "tune_topk": topk,
            "wspr_calibrate": ws, "import_tables": emitted}


def bench_phase(dev) -> dict:
    """Every section of the port's bench once on the card, small: each must
    return a result, and the busy-band decode no message never injected.
    The channelizer section counts its own launches (the warm-up and the
    timed calls of ``BatchChannelizer.process``, not the launches captured
    to time the kernel alone)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_bench_sections

    from cwsl_digi_tpu_torch.constants import Mode

    # (name, section, args) at a small size
    sections = [("channelizer", "section_channelizer", (256,)),
                ("decode_production", "section_decode_production", (8, 1))]
    sections += [(f"mode_decode:{m.value}", "section_mode_decode",
                  (m.value, 1, 1)) for m in Mode]
    sections += [("recall", "section_recall", (8,))]
    sections += [(f"qary_host_fraction:{m}", "section_qary_host_fraction",
                  (m, 2)) for m in ("JT65", "Q65-30")]
    out = {}
    _reset_launches()
    for name, fn, args in sections:
        r = getattr(torch_bench_sections, fn)(*args, device=dev)
        if not r:
            raise AssertionError(f"bench section {name} returned nothing")
        r.pop("decodes", None)
        print(f"bench {name}: {json.dumps(r)}")
        out[name] = r
    counts = _launch_counts()
    chan, prod = out["channelizer"], out["decode_production"]
    if prod["false_messages"]:
        raise AssertionError(f"busy-band decode: {prod['false_messages']}")
    if not 0 < chan["kernel_launches"] <= counts["channelize"] \
            or chan["backend"] != "cuda":
        raise AssertionError(f"bench channelizer: {chan['kernel_launches']} "
                             "kernel launches")
    missing = [k for k, r in out.items() if r.get("found_share", 1.0) <= 0]
    if missing:
        raise AssertionError(f"bench sections decoded nothing: {missing}")
    _require_launches("bench", counts, HAND_KERNELS)
    return {"launches": chan["kernel_launches"], "kernel_launches": counts,
            "sections": out}


def main() -> int:
    print(card_line())
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import cwsl_digi_tpu_torch  # noqa: F401  (fails outside the repo)
    from cwsl_digi_tpu_torch.device import cuda_device
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gfsk_kernels
    from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sync_kernels

    dev = cuda_device()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    build_libraries({"channelizer": _kernels, "ldpc": ldpc_kernels,
                     "gfsk": gfsk_kernels, "sync": sync_kernels})

    walls = {}

    def phase(name, fn, *args):
        t = time.monotonic()
        r = fn(*args)
        walls[name] = time.monotonic() - t
        print(f"phase {name}: {walls[name]:.1f} s")
        return r

    # the shapes of the three App paths (the FT8 path's 64 dials, the mixed
    # path's 5 lines, the weak path's 3, one channel each), then the bench's
    # 256 channels
    dials, _ = _plan()
    kmain = phase("kernel_64ch", kernel_phase, dev,
                  np.asarray(dials, np.float64) - LO)
    kmixed = phase("kernel_mixed_5ch", kernel_phase, dev,
                   np.asarray([d for _, d in MIXED_LINES], np.float64) - LO)
    kweak = phase("kernel_weak_3ch", kernel_phase, dev,
                  np.asarray([d for _, d in WEAK_LINES], np.float64) - LO)
    kwide = phase("kernel_256ch", kernel_phase, dev,
                  np.linspace(-FS / 2, FS / 2 - 6000, 256))
    kldpc = phase("ldpc_kernels", ldpc_kernels_phase, dev)
    gcases = phase("gfsk_cases", gfsk_cases, dev)
    kgfsk = phase("gfsk_kernels", gfsk_kernels_phase, dev, gcases)
    ksync = phase("sync_kernels", sync_kernels_phase, dev, gcases)
    del gcases
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mstats = phase("ft8_64ch_app", main_path_phase, dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        xstats = phase("mixed_mode_app", mixed_mode_phase, dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        wstats = phase("weak_modes_app", weak_modes_phase, dev, Path(tmp))
    lstats = phase("long_periods", long_period_phase, dev)
    dstats = phase("decode_walls", decode_walls_phase, dev)
    pstats = phase("parallel", parallel_phase, dev)
    sstats = phase("live_soak", live_soak_phase, dev)
    astats = phase("ap_fixtures", ap_fixtures_phase, dev)
    tstats = phase("tools", tools_phase, dev)
    bstats = phase("bench", bench_phase, dev)
    print(json.dumps({"parallel": pstats}))
    print(json.dumps({"live_soak": sstats["report"]}))
    print(json.dumps({"ap_fixtures": astats, "tools": tstats}))
    print(json.dumps({"channelize_mixed_5ch": kmixed,
                      "channelize_weak_3ch": kweak,
                      "channelize_256ch": kwide}))
    print(json.dumps({"ldpc_kernels": kldpc}))
    print(json.dumps({"gfsk_kernels": kgfsk}))
    print(json.dumps({"sync_kernels": ksync}))
    print(json.dumps({"long_periods": lstats, "decode_walls": dstats,
                      "mixed_decode_batches": xstats["decode_batches"],
                      "weak_decode_batches": wstats["decode_batches"],
                      "phase_walls_s": walls}))
    app_phases = {"ft8_64ch_app": mstats, "mixed_mode_app": xstats,
                  "weak_modes_app": wstats, "live_soak": sstats,
                  "bench": bstats}
    kernels = [{
        "name": "channelize",
        "route": "cuda",
        "source": "cwsl_digi_tpu_torch/dsp/csrc/channelizer.cu",
        "replaces": "cwsl_digi_tpu/dsp/pallas_channelizer.py:61",
        "launches": (mstats["launches"] + xstats["launches"]
                     + wstats["launches"] + pstats["launches"]
                     + sstats["launches"] + bstats["launches"]),
        "launches_by_phase": {"ft8_64ch_app": mstats["launches"],
                              "mixed_mode_app": xstats["launches"],
                              "weak_modes_app": wstats["launches"],
                              "parallel": pstats["launches"],
                              "live_soak": sstats["launches"],
                              "bench": bstats["launches"]},
        "max_abs_err": max(kmain["max_abs_err"], kmixed["max_abs_err"],
                           kweak["max_abs_err"], kwide["max_abs_err"],
                           pstats["max_abs_err"]),
        "ms": kmain["ms"],
        "plain_ms": kmain["plain_ms"],
        "bound_ms": kmain["bound_ms"],
        "bound_by": kmain["bound_by"],
        "library_ms": kmain["library_ms"],
    }]
    hand = [(name, replaces, kldpc, "ldpc.cu")
            for name, replaces in LDPC_REPLACES.items()]
    hand += [(name, replaces, kgfsk, "gfsk.cu")
             for name, replaces in GFSK_REPLACES.items()]
    hand += [(name, replaces, ksync, "sync.cu")
             for name, replaces in SYNC_REPLACES.items()]
    for name, replaces, kphase, src in hand:
        k = kphase["kernels"][name]
        by_phase = {ph: st["kernel_launches"][name]
                    for ph, st in app_phases.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cwsl_digi_tpu_torch/modes/csrc/{src}",
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
