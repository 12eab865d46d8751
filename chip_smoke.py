"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, and fails without CUDA;
2. builds the port's eight kernel libraries from ``cwsl_digi_tpu_torch``,
   one nvcc each, started together: the channelizer
   (``dsp/csrc/channelizer.cu``), the LDPC kernels ``bp_minsum`` and
   ``osd`` (``modes/csrc/ldpc.cu``), the GFSK kernels
   ``subtract_known`` and ``multisym_llrs`` (``modes/csrc/gfsk.cu``),
   the sync-search kernels ``sync_score``, ``sync_select`` and
   ``sync_refine`` (``modes/csrc/sync.cu``), the weak modes' kernels
   ``wspr_beam`` and ``rs_ee`` (``modes/csrc/weak.cu``), the q-ary
   kernels ``qra_mp``, ``qary_sync`` and ``qary_symbols``
   (``modes/csrc/qary.cu``), the median ``median_rows``
   (``modes/csrc/median.cu``) and JT65's Chase kernels ``chase_erasures``
   and ``chase_score`` (``modes/csrc/chase.cu``), printing each ptxas
   report;
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
4d. holds ``wspr_beam`` and ``rs_ee`` against their plain versions on the
   card (phase ``weak_kernels``) on the decoders' own inputs: the beam
   search's LLRs of 24 windows of the weak replay's WSPR bursts at width
   512 (576 candidates, the first pass and the DD pass) and at the
   ``cycles >= 10000`` width 1024 (768 candidates, the first pass and two
   DD passes), the App's launch (48 candidates, 2 windows, at 512) and
   96 candidates of LLRs built to tie at both widths: bits identical and
   the metric bit for bit, in the plan the wrapper picks and in every
   other plan of the width; JT65's Chase trials at its
   device batch (15 windows of the weak replay's JT65 bursts, 92,160
   trials), 64 candidates with 0, 51, 52, 60 and 63 erasures, and the
   public ``rs_ee_decode`` on expanded words: corrected words and ``ok``
   identical.  Then each kernel's device time at the bench's shapes beside
   the plain version's and the bound, the beam also at the App's 48
   candidates and at width 1024 (768 candidates), each in every plan of
   its width, with the plan the wrapper picks, its threads, shared memory,
   blocks an SM, registers and spills; and the serial chain that sets each
   kernel's time (the beam's 81 steps of register, shuffle and
   shared-memory sort stages and block barriers, the RS decode's
   dependent Berlekamp-Massey rounds);
4e. holds ``qra_mp``, ``median_rows`` and ``qary_sync`` against their
   plain versions on the card (phase ``qary_kernels``) on the decoders'
   own inputs, recorded from a 64-window Q65-30 decode and a 64-window
   JT65 decode of the weak replay's bursts, 24 WSPR windows and 24 FT8
   windows: the message passing on Q65's 7,680 words (where kernel and
   plain version both converge, the symbols identical; the converged
   counts and the flags that 60 iterations of other sums move held
   within the plain version's own spread against the JAX package; every
   64th word and every word whose flag moved bit for bit the NumPy model
   of the kernel's arithmetic) and the 64 windows' decode lists through
   it and through the plain version (identical), on 960 words of noise
   priors and 320 benign words of a 16-window decode with -16 dB bursts
   (every flag identical, confidence within 1e-4), every median the
   decoders take
   (JT65's and Q65's sync maps at their device batches, Q65's priors,
   WSPR's map, FT8's rows, also as the strided view the decoder passes)
   and rows of its edges (ties, signed zeros, NaN, infinities, odd and
   even counts, middle values that split at each radix pass, noise one
   key either side of each plan's limits, the large plan's ties at its
   sample's keys, sample miss and candidate overflow) bit for bit, with a
   ``median_design`` line for each plan the recorded medians run in
   (threads, shared memory, cluster, registers, spills, blocks an SM),
   and the selection on every recorded
   JT65 and Q65 map and on three planted windows of each (a tie in two
   strips, NaN scores under a finite base, every score NaN) bit for bit.
   Then each kernel's device time at the decoders' shapes (the median
   with the plan it ran in) beside the
   plain version's, the bound and the library call (``torch.median``
   where a row's count is odd, ``torch.quantile`` where it is even and
   takes the input, ``torch.topk`` of the score map), and each
   kernel's registers and spills;
4f. holds ``qary_symbols``, ``chase_erasures`` and ``chase_score``
   against their plain versions on the card (phase
   ``qary_decode_kernels``) on the inputs of the App's 64-window JT65 and
   Q65-30 decodes of the weak replay's bursts and on planted edges (tied,
   flat and NaN tone rows; tied, signed-zero, NaN and -inf margins at a
   draw index past 2**32; trials duplicated in pairs; trials whose slabs
   are not 16-byte aligned, which ``chase_score`` copies byte by byte in
   place of its TMA ring): the tone gather,
   top-4, sum and margin bit for bit, the erasure flags bit for bit (also
   against the plain version on CPU copies), the Chase info and ok
   identical and the score within 1e-5, printing the flags' differing
   bits, the score error and the best trials changed (each only between
   trials within 1e-5); the 64-window decode lists with the plain stages
   equal the kernels'.  Then each kernel's device time at JT65's shapes
   beside the plain version's, the bound and, for the gather,
   ``torch.topk(e, 4)``, each kernel's registers and spills, and the two
   redesigns' layouts (``qary_symbols``' lanes and rows a warp, blocks an
   SM and grid; ``chase_score``'s stage, ring, shared bytes, blocks an SM
   and copy path);
5. runs the port's App on a seeded 192 kHz file replay with 64 FT8
   decoder lines across the band and known bursts in 17 of them (SNR 0 to
   -18 dB, a crowded channel of 9 overlapping signals, an AP-covered CQ);
   every expected spot must appear within 2 Hz and no other, through the
   channelizer, ``bp_minsum``, ``osd``, ``subtract_known``,
   ``multisym_llrs``, the three sync kernels and the SNR median's
   ``median_rows``, with CUDA tensors reaching the decoder;
6. runs the App on seeded 192 kHz IQ with the lines a 20 m skimmer runs
   on one receiver: FT8, JS8, FT4, FST4-60 and FST4W-120.  The replay
   starts on the App's own anchor (the next UTC 15 s boundary) with noise
   up to the next 2-minute boundary, then 122 s with bursts in several
   windows of each (SNR -5 dB down to about 3 dB above each mode's
   threshold); every window must close on its own UTC boundary from the
   anchor on, and every expected spot (JS8's by its sender grammar) appear
   within 2 Hz, and no other, through the eight kernels and
   ``median_rows``;
7. runs the App on seeded 192 kHz IQ with the weak-signal lines of the
   same receiver: WSPR (14.0956 MHz), JT65 (14.076 MHz) and Q65-30
   (14.0795 MHz), written for the App's anchor as in 6: one WSPR window,
   two JT65 windows and four Q65-30 windows after the 2-minute boundary,
   8 bursts (SNR -8 dB down to about 3 dB above each mode's threshold);
   every window on its own boundary, every expected spot within 2 Hz and
   no other, through the channelizer, WSPR's beam search through
   ``wspr_beam`` and its OSD through ``osd``, JT65's RS Chase through
   ``rs_ee``, Q65's message passing through ``qra_mp``, the q-ary sync
   search through ``qary_sync`` and every SNR and prior median through
   ``median_rows`` (none of the three modes has an LDPC code or runs the
   GFSK engine);
8. decodes one synthesized window of each long period (FST4-300/900/1800,
   FST4W-300/900/1800) through ``get_decoder`` on the card, printing the
   spectrogram branch, the decode wall and the peak device memory;
9. times the decode of one window and of a 64-window batch for FT4, JS8,
   FST4-60, WSPR, JT65 and Q65-30 (and the peak device memory of the
   64-window WSPR batch);
10. runs the parallel layer on ``cuda:0``: the channel-sharded skim of the
    64 dials (bursts in 8) on a virtual 4-entry mesh against a 1-entry
    mesh, the same skim in two worker processes on the card (its wall,
    start-up and the workers' own launches printed) bit for bit against
    a 2-entry mesh in this process, and the arrays in which a 32-channel
    batch's decode parts from the 64's, stage by stage, a 900 s 192 kHz
    window time-sharded 4 ways (4 channels) against one device's whole
    window and the plain version with its FST4W-900 burst decoded, the
    kernel against the plain version at the shards' offsets, ``entry()``,
    ``dryrun_multichip`` on a virtual 4-entry mesh and the skim through a
    one-rank NCCL process group;
11. runs the port's App live (``tools/torch_soak.py``) at 512 FT8 channels
    as 8 synthetic real-time 192 kHz receivers of 64 dials, for 3 windows
    with 6 bursts a window spread over the receivers, scheduled from the
    App's anchor: every channel-window decoded, no stale drop or ingest
    overrun, every burst found on its own receiver's dials and no spot on
    another's, CUDA audio into the decoders, through the eight kernels
    and ``median_rows``, with the App's default pool (4 workers, one
    decode at a time on the card) and no spot later than its 15 s
    deadline; it prints the pool size, the latencies, the wait for the
    card's decode lock, stages, busy fraction and peak device memory;
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
    sixteen kernels;
15. prints a ``{"kernels": [...]}`` line (``channelize``, ``bp_minsum``,
    ``osd``, ``subtract_known``, ``multisym_llrs``, ``sync_score``,
    ``sync_select``, ``sync_refine``, ``wspr_beam``, ``rs_ee``, ``qra_mp``,
    ``median_rows``, ``qary_sync``, ``qary_symbols``, ``chase_erasures``,
    ``chase_score``, each with its launches in the App
    phases 5-7, 11 and 14, which set every count to 0 before they start
    and read it after, and ``launch_gap_ms``, the launches of the FT8,
    mixed and weak App phases 5-7 (and, for the channelizer, of the
    parallel phase 10) x (ms - bound), each at the shape it ran at:
    ``LaunchShapes`` records each launch's shape and the operands of the
    first at each shape in those phases, and replays every shape on the
    card after the bench; the live soak and the bench run unrecorded, so
    that recording costs their timings and deadlines nothing), then
    ``{"ok": true, ...}`` last.

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
WEAK_KERNELS = ("wspr_beam", "rs_ee")
# the XLA programs of the JAX package that the weak kernels replace
WEAK_REPLACES = {"wspr_beam": "cwsl_digi_tpu/modes/wspr.py:526",
                 "rs_ee": "cwsl_digi_tpu/modes/rs_device.py:118"}
# the beam search's candidates a launch in the App: 2 windows x top-24
APP_BEAM_CANDIDATES = 48
QARY_KERNELS = ("qra_mp", "median_rows", "qary_sync")
# the XLA programs of the JAX package that the q-ary kernels and the median
# replace (the median also at qary_engine.py:168, wspr.py:507 and
# gfsk_engine.py:676), each with its source under modes/csrc
QARY_REPLACES = {"qra_mp": "cwsl_digi_tpu/modes/qra.py:268",
                 "median_rows": "cwsl_digi_tpu/modes/qary_engine.py:136",
                 "qary_sync": "cwsl_digi_tpu/modes/qary_engine.py:107"}
QARY_SOURCES = {"qra_mp": "qary.cu", "median_rows": "median.cu",
                "qary_sync": "qary.cu"}
MP_CONF_TOL = 1e-4       # qra_mp vs plain, confidence of the converging
                         # words (the transforms' sums in another order);
                         # flags and their symbols exact
# qra_mp vs plain on the weak replay's 7,680 Q65-30 words: 60 iterations of
# the sums in another order move the flags of words that converge late,
# and not evenly (tools/qra_mp_flips.py on these words: the plain version
# on the CPU converges on 118 fewer than the JAX package, 302 flags
# differ).  The kernel's converged count stays within that gap of the
# plain version's and its flags differ on at most as many words.
MP_GAP_MAX = 118
MP_FLIPS_MAX = 302
MP_MODEL_STRIDE = 64     # the kernel against the NumPy model of its
                         # arithmetic, bit for bit, on every 64th word and
                         # every word whose flag moved
# the q-ary decode's last op chains: the tone gather and top-4, JT65's Chase
# erasure patterns and soft score (the RS decode between them is rs_ee)
QARY_DECODE_KERNELS = ("qary_symbols", "chase_erasures", "chase_score")
QARY_DECODE_REPLACES = {
    "qary_symbols": "cwsl_digi_tpu/modes/qary_engine.py:123",
    "chase_erasures": "cwsl_digi_tpu/modes/rs_device.py:245",
    "chase_score": "cwsl_digi_tpu/modes/rs_device.py:274"}
QARY_DECODE_SOURCES = {"qary_symbols": "qary.cu",
                       "chase_erasures": "chase.cu",
                       "chase_score": "chase.cu"}
SCORE_TOL = 1e-5         # chase_score vs plain, the best trial's score
                         # (the mean of 63 logs summed in another order);
                         # info and ok identical, a changed best trial only
                         # between trials whose plain scores lie this close
THREEFRY_OPS = 85        # integer operations a stochastic flag: 2 + 20
                         # rounds x 3 (add, rotate, xor) + 5 key injections
                         # x 3, the index, the bits' float, the product and
                         # the compare
THREEFRY_ALU_OPS = 43    # of them the rotates, xors, shift and or, which
                         # only the 64 INT32 lanes of an SM issue (an add
                         # may also issue as IMAD on the 128 FP32 lanes)
ALL_KERNELS = HAND_KERNELS + WEAK_KERNELS + QARY_KERNELS + QARY_DECODE_KERNELS
# the GFSK engine's paths also take their SNR median through median_rows
GFSK_PATH_KERNELS = HAND_KERNELS + ("median_rows",)
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
        LAUNCH_SHAPES.timed = name
        try:
            ms = [cuda_ms(kern, reps)]
        finally:
            LAUNCH_SHAPES.timed = None
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
              f"{bound_fma:.5f} ms, {100 * bound_fma / k_ms:.1f} %)")
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


def _weak_windows(mode: str, n: int, seed: int) -> np.ndarray:
    """``n`` 12 kHz windows of the weak replay's bursts of ``mode`` (WSPR:
    both in every window; JT65 and Q65-30: their windows in turn), each
    burst at its plan's SNR over seeded unit noise, float32 [n,
    samples]."""
    from cwsl_digi_tpu_torch.modes import jt65, q65, wspr

    plan = [p for p in _weak_plan() if p[0] == mode]
    n_plan = max(p[1] for p in plan) + 1
    rng = np.random.default_rng(seed)
    t_r = {"WSPR": wspr.T_R, "JT65": jt65.T_R, "Q65-30": q65.T_R}[mode]
    length = int(t_r * 12_000)
    out = rng.standard_normal((n, length)).astype(np.float32)
    for w in range(n):
        for _, wi, text, f0, snr, dt in plan:
            if wi != w % n_plan:
                continue
            # amplitude A: A**2 / 2 over the noise power in 2.5 kHz
            amp = np.sqrt(2 * 10 ** (snr / 10) * 2500.0 / 6000.0)
            if mode == "WSPR":
                call, grid, dbm = text.split()
                out[w] += wspr.synthesize(
                    call, grid, int(dbm), f0, amplitude=amp,
                    start_s=wspr.SIGNAL_START_S + dt).astype(np.float32)
            elif mode == "JT65":
                out[w] += jt65.synthesize(text, f0, amplitude=amp,
                                          start_s=1.0 + dt).astype(np.float32)
            else:
                out[w] += q65.synthesize(
                    text, f0, amplitude=amp,
                    start_s=0.5 + dt).astype(np.float32)
    return out


def record_weak_inputs(dev) -> dict:
    """The inputs the weak decoders hand the two kernels on the card: the
    beam search's LLRs of 24 windows of the weak replay's WSPR bursts
    (the bench's batch: 576 candidates) at the default width 512 (the
    first pass and the DD pass) and at the ``cycles >= 10000`` width 1024
    (32 candidates a window, the first pass and two DD passes), and the
    Chase program's trials of JT65's device batch (15 windows of the weak
    replay's JT65 bursts, at the App's 3000 Hz: 360 candidates x 256
    trials).  {"beam": [(cfg, llr)], "rs": [(nk_fcr, syms, era)]}."""
    from cwsl_digi_tpu_torch.modes import jt65, rs_device, wspr

    rec = {"beam": [], "rs": []}
    beam, trials = wspr._beam_decode, rs_device.rs_ee_trials

    def beam_rec(cfg, llr):
        rec["beam"].append((cfg, llr.clone()))
        return beam(cfg, llr)

    def trials_rec(nk_fcr, syms, era):
        rec["rs"].append((nk_fcr, syms.clone(), era.clone()))
        return trials(nk_fcr, syms, era)

    wspr._beam_decode, rs_device.rs_ee_trials = beam_rec, trials_rec
    try:
        audio = torch.from_numpy(_weak_windows("WSPR", 24, SEED + 60)).to(dev)
        for kw in ({}, {"cycles": 10_000}):
            res = wspr.WSPRDecoder(device=dev, **kw).decode(audio)
            print(f"weak kernels' WSPR inputs {kw or 'default'}: "
                  f"{sum(len(r) for r in res)} decodes in 24 windows")
        jd = jt65.JT65Decoder(device=dev, fmax_hz=3000.0)
        audio = torch.from_numpy(_weak_windows(
            "JT65", jd.max_device_batch, SEED + 61)).to(dev)
        res = jd.decode(audio)
        print(f"weak kernels' JT65 inputs: {sum(len(r) for r in res)} "
              f"decodes in {jd.max_device_batch} windows")
    finally:
        wspr._beam_decode, rs_device.rs_ee_trials = beam, trials
    return rec


def beam_tie_llrs(n: int, seed: int, dev) -> torch.Tensor:
    """[n, 81, 2] LLRs built to tie, in turn: integer values in [-3, 3],
    all zero, and noise with a zero tail (the 31 tail steps)."""
    rng = np.random.default_rng(seed)
    llr = rng.integers(-3, 4, (n, 81, 2)).astype(np.float32)
    llr[1::3] = 0.0
    llr[2::3] = rng.standard_normal((len(llr[2::3]), 81, 2))
    llr[2::3, 50:] = 0.0
    return torch.from_numpy(llr).to(dev)


def beam_vs_plain(cfg, llr: torch.Tensor) -> dict:
    """``wspr_beam`` (through ``wspr._beam_decode``, in the plan the
    wrapper picks) against ``_beam_decode_plain`` on the same CUDA LLRs:
    bits identical and the normalised metric bit for bit (two NaNs count
    as equal); then the kernel in every other plan of the width
    (``wspr_beam(..., keys=K)``) against the same.  One launch through the
    decoder's entry."""
    from cwsl_digi_tpu_torch.modes import _weak_kernels as wk
    from cwsl_digi_tpu_torch.modes import wspr

    w = cfg.beam_width
    before = wk.launches["wspr_beam"]
    bits, metric = wspr._beam_decode(cfg, llr)
    launched = wk.launches["wspr_beam"] - before
    pb, pm = wspr._beam_decode_plain(cfg, llr)
    norm = llr.abs().sum(dim=(1, 2)) + 1e-30
    plans = {}
    for keys in wk.BEAM_PLANS[w]:
        best_k, b_k = wk.wspr_beam(llr, w, keys=keys)
        plans[keys] = (_bits_differ(b_k, pb.cpu())
                       + _bits_differ(best_k / (0.5 * norm), pm.cpu()))
    sms = torch.cuda.get_device_properties(llr.device).multi_processor_count
    out = {"shape": list(llr.shape), "beam_width": w, "launches": launched,
           "plan": wk.beam_plan(llr.shape[0], w, sms),
           "bits_differ": _bits_differ(bits, pb.cpu()),
           "metric_bits_differ": _bits_differ(metric, pm.cpu()),
           "plans_differ": plans,
           "max_abs_err": _abs_err(metric, pm.cpu()),
           "dtype": str(bits.dtype)}
    out["ok"] = (launched == 1 and out["bits_differ"] == 0
                 and out["metric_bits_differ"] == 0
                 and not any(plans.values())
                 and bits.dtype == pb.dtype and bits.shape == pb.shape)
    return out


def rs_vs_plain(nk_fcr, syms: torch.Tensor, era: torch.Tensor,
                public: bool = False) -> dict:
    """``rs_ee`` against the plain version on the same CUDA trials: through
    the Chase program's entry ``rs_ee_trials`` (syms [C, n], era [C, T,
    n]), or with ``public`` through ``rs_ee_decode`` on the expanded words
    [C T, n]: corrected words and ok identical.  One kernel launch."""
    from cwsl_digi_tpu_torch.modes import _weak_kernels as wk
    from cwsl_digi_tpu_torch.modes import rs_device

    c, t, n = era.shape
    before = wk.launches["rs_ee"]
    if public:
        recv = syms[:, None].expand(c, t, n).reshape(-1, n)
        flat = era.reshape(-1, n)
        got = rs_device.rs_ee_decode(nk_fcr, recv, flat)
        want = rs_device.rs_ee_decode_plain(nk_fcr, recv, flat)
    else:
        got = rs_device.rs_ee_trials(nk_fcr, syms, era)
        want = rs_device.rs_ee_trials_plain(nk_fcr, syms, era)
    launched = wk.launches["rs_ee"] - before
    n_era = era.sum(-1)
    out = {"trials": c * t, "entry": "rs_ee_decode" if public
           else "rs_ee_trials", "launches": launched,
           "erasures_min_max": [int(n_era.min()), int(n_era.max())],
           "over_nroots": int((n_era > n - nk_fcr[1]).sum()),
           "words_differ": int((got[0] != want[0]).any(-1).sum()),
           "ok_differ": int((got[1] != want[1]).sum()),
           "ok_share": float(want[1].float().mean()),
           "max_abs_err": float((got[0].long() - want[0].long()).abs().max()),
           "dtype": str(got[0].dtype)}
    out["ok"] = (launched == 1 and out["words_differ"] == 0
                 and out["ok_differ"] == 0 and got[0].dtype == want[0].dtype)
    return out


def rs_edge_trials(syms: torch.Tensor, seed: int) -> torch.Tensor:
    """Erasure flags [C, 8, n] for candidates syms [C, n]: a candidate's
    eight trials erase 0, 0, 51, 51, 52, 60, 63 and 25 random positions."""
    c, n = syms.shape
    counts = [0, 0, 51, 51, 52, 60, 63, 25]
    g = torch.Generator().manual_seed(seed)
    keys = torch.rand((c, len(counts), n), generator=g)
    rank = keys.argsort(-1).argsort(-1)
    era = rank < torch.tensor(counts)[None, :, None]
    return era.to(syms.device)


def beam_bound_ms(n: int, w: int) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the beam search of ``n`` candidates
    at width ``w``: the LLRs read and bits and metric written once at the
    HBM rate; per step and expanded entry (2W of them) 6 integer
    operations (two masks, two popcounts, two parities) and 6 float ones
    (two signed products, two adds, the halving, the tail), the merge's 6
    (two tail compares, two metric compares, the select, the key), each
    survivor's 4 to take it, and the least the two orders need: the
    stable order of the 2W tails is a stable sort of the W parents' tails
    (W log2 W compares; a parent's two children are its tail << 1 | bit)
    and an interleave (one operation a child), and the top W of 2W in
    order a selection (2 compares a key) and a sort of the W kept (W log2
    W).  Integers at INT32_OPS, floats at FP32_OPS, the two pipes side by
    side (``ops_ms_fma_rate``: all of it at FP32_FLOPS)."""
    e = 2 * w
    lg = w.bit_length() - 1
    int_step = e * 6 + e * 6 + w * 4 + 2 * w * lg + e + 2 * e
    float_step = e * 6
    int_ops = n * 81 * int_step
    float_ops = n * 81 * float_step
    n_bytes = n * (81 * 2 * 4 + 50 + 4)
    ops_ms = max(int_ops / INT32_OPS, float_ops / FP32_OPS) * 1e3
    return (n_bytes / HBM_BYTES_S * 1e3, ops_ms,
            {"int_ops": int_ops, "float_ops": float_ops, "bytes": n_bytes,
             "ops_ms_fma_rate": (int_ops + float_ops) / FP32_FLOPS * 1e3})


def beam_steps(w: int, keys: int) -> dict:
    """The chain of dependent steps a ``wspr_beam`` block takes at width
    ``w`` in plan ``keys``: 81 trellis steps, each the tail sort's and the
    top sort's compare stages (in registers, between lanes, between warps
    through shared memory), the block barriers and the group search's
    dependent shared loads (``_weak_kernels.beam_chain``); one more
    barrier after the set-up."""
    from cwsl_digi_tpu_torch.modes import _weak_kernels as wk

    c = wk.beam_chain(w, keys)
    return {"steps": 81, "keys_a_thread": keys, "threads": c["threads"],
            "tail_stages": c["tail"], "top_stages": c["top"],
            "stages_a_step": c["stages"],
            "block_barriers_a_step": c["block_barriers"],
            "search_loads_a_step": c["search_loads"],
            "stages_total": 81 * c["stages"],
            "block_barriers_total": 81 * c["block_barriers"] + 1}


def beam_design(dev, n: int, w: int) -> dict:
    """The plan the ``wspr_beam`` wrapper picks for ``n`` candidates at
    width ``w`` on this card, and each plan of the width: threads, dynamic
    shared memory, blocks an SM, registers and spills."""
    from cwsl_digi_tpu_torch.modes import _weak_kernels as wk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {}
    for keys in wk.BEAM_PLANS[w]:
        a = wk.kernel_attrs(dev, w, keys)["wspr_beam"]
        plans[keys] = {"threads": 2 * w // keys,
                       "smem_bytes": wk.beam_smem_bytes(w, keys),
                       "blocks_an_sm": wk.beam_blocks_per_sm(dev, w, keys),
                       "registers": a["registers"],
                       "local_bytes": a["local_bytes"]}
    return {"candidates": n, "beam_width": w,
            "plan": wk.beam_plan(n, w, sms), "sms": sms, "plans": plans}


def rs_bound_ms(nk_fcr, syms: torch.Tensor, era: torch.Tensor,
                corrected: torch.Tensor) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the errors-and-erasures decode of these
    trials, whose corrected words are ``corrected`` [C, T, n]: the symbols
    (int64), flags, tables read and the corrected words (a byte a symbol)
    and ok written once at the HBM rate; the GF(64) products (an index
    and an XOR each, 2 integer operations, the table read a load) the data
    needs, each polynomial evaluated by Horner's rule: a candidate's
    syndromes once for all its trials (nroots (n - 1)), and per trial the
    locator (i + 1 for the i-th erasure, at most nroots), each BM round
    past the erasures (r for the discrepancy, 2 (nroots + 1) for Lambda and
    B), and with d the locator's roots, counted as the positions the trial
    erases or changes (at most nroots, at most Lambda's degree): the Chien
    search (d a position), Omega = S Lambda mod x^nroots (nroots - i for
    Lambda's i-th coefficient), Omega and Lambda' at the roots only
    (nroots - 1 and (d + 1) // 2 each), Forney's 2 a root, and the
    membership check as S(r) XOR S(e), nroots a changed position; at
    INT32_OPS (``ops_ms_fma_rate``: at FP32_FLOPS; ``int_ops_syndromes_a_
    trial``: the count with a trial's own syndromes, as the first port
    computed them).  Also the dependent BM rounds a trial (its serial
    chain)."""
    n, k, _ = nk_fcr
    nr = n - k
    c, t, _ = era.shape
    era_c = era.cpu()
    changed = corrected.cpu().long() != syms.cpu()[:, None, :]
    e = era_c.sum(-1).to(torch.float64)
    ec = e.clamp(max=nr)
    nch = changed.sum(-1).to(torch.float64)
    d = (era_c | changed).sum(-1).to(torch.float64).clamp(max=nr)
    loc = torch.where(e <= nr, e * (e + 1) / 2,
                      nr * (nr + 1) / 2 + (e - nr) * nr)
    bm = (nr * (nr + 1) - ec * (ec + 1)) / 2 + (nr - ec) * 2 * (nr + 1)
    per = (loc + bm + d * n + (d + 1) * nr - d * (d + 1) / 2
           + d * (nr - 1) + d * torch.div(d + 1, 2, rounding_mode="floor")
           + 2 * d + nr * nch)
    syn = nr * (n - 1)
    int_ops = float(2 * (per.sum() + c * syn))
    n_bytes = c * n * 8 + 2 * c * t * n + c * t + 4096 + 5 * 64
    rounds = nr - ec
    return (n_bytes / HBM_BYTES_S * 1e3, int_ops / INT32_OPS * 1e3,
            {"int_ops": int_ops, "bytes": n_bytes,
             "int_ops_syndromes_a_trial": float(2 * (per.sum()
                                                    + c * t * syn)),
             "products_a_trial_mean": float(per.mean()) + syn / t,
             "roots_a_trial_mean": float(d.mean()),
             "bm_rounds_mean": float(rounds.mean()),
             "bm_rounds_max": int(rounds.max()),
             "ops_ms_fma_rate": int_ops / FP32_FLOPS * 1e3})


def rs_shared_loads(nk_fcr, syms: torch.Tensor, era: torch.Tensor,
                    corrected: torch.Tensor) -> dict:
    """Shared-memory loads a warp issues a trial of these trials, means:
    ``loads`` (every shared load instruction) and ``random_rows`` (the
    GF(64) products whose table row differs from lane to lane, ~3.5
    wavefronts each where the other loads take one), for the kernel (a
    candidate's syndromes once; each erasure's locator step 3; a BM round
    at most 9, 2 of them random rows; Omega 5 a coefficient; the
    evaluations 7 a coefficient; Forney 8, 4 of them random rows; S(e) 3
    a changed position; zero coefficients counted as if they were not
    skipped) and for the first port (the syndromes twice, 3 a position,
    random rows; the locator 3 an erasure; the same BM; Omega 5 a
    coefficient; each of a lane's two positions' Horner chains 2 a step:
    2 nroots + 1 + (nroots + 1) // 2 steps)."""
    n, k, _ = nk_fcr
    nr = n - k
    c, t, _ = era.shape
    e = era.cpu().sum(-1).to(torch.float64)
    rounds = (nr - e).clamp(min=0)
    nch = (corrected.cpu().long() != syms.cpu()[:, None, :]).sum(-1).to(
        torch.float64)
    syn_once = 4 * n / t
    new = (syn_once + 3 * e + 9 * rounds + 5 * nr + 7 * (nr + 1) + 8
           + 3 * nch)
    new_rand = 2 * rounds + 4
    chain = 2 * nr + 1 + (nr + 1) // 2
    old = (2 * 3 * n + 3 * e + 9 * rounds + 5 * nr + 2 * (2 * chain + 6))
    old_rand = 2 * 2 * n + 2 * e + 6 * rounds + 2 * (chain + 3)
    return {"loads": float(new.mean()), "random_rows": float(
                new_rand.mean()),
            "first_port_loads": float(old.mean()),
            "first_port_random_rows": float(old_rand.mean())}


def weak_cases(dev) -> dict:
    """The weak kernels' cases on the card, by name: ("beam", cfg, llr) or
    ("rs", nk_fcr, syms, era, public) (``record_weak_inputs`` plus ties
    and erasure edges)."""
    rec = record_weak_inputs(dev)
    cases = {}
    for cfg, llr in rec["beam"]:
        w = cfg.beam_width
        i = sum(1 for name in cases if name.startswith(f"wspr w{w}"))
        what = "pass 1" if i == 0 else f"dd pass {i}"
        cases[f"wspr w{w} {what}"] = ("beam", cfg, llr)
    cfg, llr = rec["beam"][0]
    cases["wspr w512 app"] = ("beam", cfg, llr[:APP_BEAM_CANDIDATES].clone())
    for w in (512, 1024):
        cfg = dataclasses.replace(rec["beam"][0][0], beam_width=w)
        cases[f"ties w{w}"] = ("beam", cfg, beam_tie_llrs(96, SEED + w, dev))
    nk_fcr, syms, era = rec["rs"][0]
    cases["jt65 device batch"] = ("rs", nk_fcr, syms, era, False)
    cases["jt65 erasure edges"] = ("rs", nk_fcr, syms[:64],
                                   rs_edge_trials(syms[:64], SEED + 62),
                                   False)
    cases["jt65 rs_ee_decode"] = ("rs", nk_fcr, syms[:32], era[:32], True)
    return cases


def weak_kernels_phase(dev) -> dict:
    """``wspr_beam`` and ``rs_ee`` against their plain versions on the card
    on the decoders' own inputs (``weak_cases``): bits and metric bit for
    bit, corrected words and ok identical; then each kernel's device time
    at the bench's shapes (WSPR: 576 candidates at width 512; JT65: 92,160
    trials) beside the plain version's and the bound, the beam also at the
    App's 48 candidates and at width 1024 (768), each in every plan of its
    width, with the plan's design, and the serial chain that sets each
    kernel's time."""
    from cwsl_digi_tpu_torch.modes import _weak_kernels as wk
    from cwsl_digi_tpu_torch.modes import rs_device, wspr

    cases = weak_cases(dev)
    checks = {}
    for name, case in cases.items():
        checks[name] = (beam_vs_plain(*case[1:]) if case[0] == "beam"
                        else rs_vs_plain(*case[1:]))
        print(f"weak kernels vs plain, {name}: {json.dumps(checks[name])}")
    torch.cuda.empty_cache()
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"weak kernels disagree with the plain "
                             f"versions: {bad}")
    _, cfg, llr = cases["wspr w512 pass 1"]
    _, _, llr_app = cases["wspr w512 app"]
    _, _, llr_w = cases["wspr w1024 pass 1"]
    shapes = {"app": llr_app, "bench": llr, "w1024": llr_w}
    widths = {"app": 512, "bench": 512, "w1024": 1024}
    design = {name: beam_design(dev, x.shape[0], widths[name])
              for name, x in shapes.items()}
    attrs = {w: wk.kernel_attrs(dev, w, wk.BEAM_PLANS[w][-1])
             for w in (512, 1024)}
    print(f"weak kernels' design: wspr_beam by shape {json.dumps(design)}; "
          f"attributes {json.dumps(attrs)}")
    _, nk_fcr, syms, era, _ = cases["jt65 device batch"]
    tables = rs_device.kernel_tables_device(nk_fcr, dev)
    nroots = nk_fcr[0] - nk_fcr[1]
    runs = {
        "wspr_beam": (lambda: wk.wspr_beam(llr, cfg.beam_width),
                      lambda: wspr._beam_decode_plain(cfg, llr), 3, 2),
        "rs_ee": (lambda: wk.rs_ee(tables, syms, era, nroots),
                  lambda: rs_device.rs_ee_trials_plain(nk_fcr, syms, era),
                  5, 2)}
    bounds = {"wspr_beam": beam_bound_ms(llr.shape[0], cfg.beam_width),
              "rs_ee": rs_bound_ms(nk_fcr, syms, era,
                                   wk.rs_ee(tables, syms, era, nroots)[0])}
    errs = {"wspr_beam": max(c["max_abs_err"] for n, c in checks.items()
                             if cases[n][0] == "beam"),
            "rs_ee": max(c["max_abs_err"] for n, c in checks.items()
                         if cases[n][0] == "rs")}
    out = stage_kernel_times(
        runs, bounds, errs,
        {"wspr_beam": list(llr.shape), "rs_ee": list(era.shape)})
    plan = design["bench"]["plan"]
    out["wspr_beam"]["plan"] = plan
    out["wspr_beam"]["dependent_steps"] = beam_steps(cfg.beam_width, plan)
    out["rs_ee"]["dependent_steps"] = {
        k: bounds["rs_ee"][2][k] for k in ("bm_rounds_mean",
                                           "bm_rounds_max")}
    for name, x in shapes.items():
        w = widths[name]
        bound = max(beam_bound_ms(x.shape[0], w)[:2])
        by_plan = {keys: cuda_ms(lambda: wk.wspr_beam(x, w, keys=keys),
                                 3 if x.shape[0] < 100 else 2)
                   for keys in wk.BEAM_PLANS[w]}
        plan = design[name]["plan"]
        row = {"shape": list(x.shape), "beam_width": w, "plan": plan,
               "ms": by_plan[plan], "ms_by_plan": by_plan,
               "bound_ms": bound,
               "design": design[name]["plans"][plan],
               "dependent_steps": beam_steps(w, plan)}
        out["wspr_beam"][name] = row
        print(f"wspr_beam {name} {list(x.shape)} at width {w}: plan K = "
              f"{plan} ({2 * w // plan} threads a candidate), "
              f"{by_plan[plan]:.5f} ms device time (every plan: "
              f"{json.dumps(by_plan)}), bound {bound:.5f} ms "
              f"({100 * bound / by_plan[plan]:.1f} %); "
              f"{json.dumps(row['design'])}; chain "
              f"{json.dumps(row['dependent_steps'])}")
    print(f"rs_ee chain {json.dumps(out['rs_ee']['dependent_steps'])}")
    corrected = wk.rs_ee(tables, syms, era, nroots)[0]
    rs_design = {**attrs[512]["rs_ee"],
                 "threads": 256, "blocks_an_sm": wk.rs_blocks_per_sm(dev),
                 "sms": torch.cuda.get_device_properties(
                     dev).multi_processor_count,
                 "shared_loads_a_trial": rs_shared_loads(nk_fcr, syms, era,
                                                         corrected)}
    print(f"rs_design {json.dumps(rs_design)}")
    r = out["rs_ee"]
    times = {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
    print(f"rs_ee at {list(era.shape)}: {json.dumps(times)}, share "
          f"{r['bound_ms'] / r['ms']:.3f}")
    return {"kernels": out, "checks": checks, "attrs": attrs,
            "beam_design": design, "rs_design": rs_design}


def record_qary_inputs(dev) -> dict:
    """The inputs the decoders hand the q-ary kernels on the card: Q65-30's
    priors of a 64-window decode of the weak replay's Q65 bursts (7,680
    words) and its sync maps (the decoder's 30-window device batches),
    JT65's sync maps of a 64-window decode (15-window batches), WSPR's
    map of 24 windows, and the FT8 decode's strided SNR view of 24 busy
    windows.  {"mp": [(decoder, probs)], "median": [(name, rows [R,
    N])], "median_view": [(name, the strided view [R, A, B] as the decoder
    passed it)], "sync": [(name, spec, power_sync, base)]}."""
    from cwsl_digi_tpu_torch.modes import (ft8, gfsk_engine, jt65, q65,
                                           qary_engine, qra, wspr)

    rec = {"mp": [], "median": [], "median_view": [], "sync": []}
    label = {"mode": ""}
    mp_decode = qra.QaryMPDecoder.decode
    sync = qary_engine._qary_sync
    medians = {mod: mod._median_rows
               for mod in (qary_engine, wspr, gfsk_engine)}

    def mp_rec(self, probs):
        rec["mp"].append((self, probs.clone()))
        return mp_decode(self, probs)

    def sync_rec(spec, power_sync, base):
        rec["sync"].append((label["mode"], spec, power_sync.clone(),
                            base.clone()))
        return sync(spec, power_sync, base)

    def med_rec(fn):
        def inner(x):
            what = "priors" if x.dim() == 2 else "map"
            rec["median"].append((f"{label['mode']} {what}", x.reshape(
                x.shape[0], -1).contiguous().clone()))
            if not x.is_contiguous():
                # the view itself (it keeps its power map alive)
                rec["median_view"].append((f"{label['mode']} view", x))
            return fn(x)
        return inner

    qra.QaryMPDecoder.decode, qary_engine._qary_sync = mp_rec, sync_rec
    for mod, fn in medians.items():
        mod._median_rows = med_rec(fn)
    try:
        for mode, make, n in (
                ("Q65-30", lambda: q65.Q65Decoder(device=dev), 64),
                ("JT65", lambda: jt65.JT65Decoder(device=dev), 64),
                ("WSPR", lambda: wspr.WSPRDecoder(device=dev), 24)):
            label["mode"] = mode
            audio = torch.from_numpy(
                _weak_windows(mode, n, SEED + 63)).to(dev)
            res = make().decode(audio)
            print(f"q-ary kernels' {mode} inputs: "
                  f"{sum(len(r) for r in res)} decodes in {n} windows")
            del audio
        label["mode"] = "FT8"
        rng = np.random.default_rng(SEED + 64)
        audio = np.stack([
            ft8.synthesize("CQ K1ABC FN42", 700.0 + 60.0 * w)
            + 0.3 * rng.standard_normal(180_000) for w in range(24)])
        res = ft8.FT8Decoder(device=dev).decode(
            torch.from_numpy(audio.astype(np.float32)).to(dev))
        print(f"q-ary kernels' FT8 inputs: {sum(len(r) for r in res)} "
              "decodes in 24 windows")
    finally:
        qra.QaryMPDecoder.decode, qary_engine._qary_sync = mp_decode, sync
        for mod, fn in medians.items():
            mod._median_rows = fn
    return rec


def _floats_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of two float32 tensors on the card that differ by their
    bits, two NaNs counting as equal."""
    differ = a.view(torch.int32) != b.view(torch.int32)
    return int((differ & ~(a.isnan() & b.isnan())).sum())


def mp_vs_plain(dec, probs: torch.Tensor, strict: bool = False,
                model: bool = False) -> dict:
    """``qra_mp`` (through ``QaryMPDecoder.decode``) against
    ``decode_plain`` on the same CUDA priors: where both converge (the
    syndrome holds) the symbols identical.  With ``strict`` also every flag
    identical and the converging words' confidence within MP_CONF_TOL.
    Without it the converged counts differ by at most MP_GAP_MAX and the
    flags on at most MP_FLIPS_MAX words, the plain version's own spread
    against the JAX package on the weak replay's words (60 iterations of
    the transforms' sums in another order move words that converge late,
    ``tools/qra_mp_flips.py``); the decoder's lists are held too
    (``q65_lists_vs_plain``).  With ``model`` the kernel's symbols, flags
    and confidence also equal, bit for bit, the NumPy model of its
    arithmetic (``tools/qra_mp_model.py``) on every MP_MODEL_STRIDE-th word
    and every word whose flag moved.  One kernel launch."""
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk

    before = qk.launches["qra_mp"]
    hard, ok, conf = dec.decode(probs)
    launched = qk.launches["qra_mp"] - before
    p_hard, p_ok, p_conf = dec.decode_plain(probs)
    both = ok & p_ok
    word_differs = (hard != p_hard).any(-1)
    err = (conf - p_conf).abs()[both]
    out = {"words": probs.shape[0], "launches": launched, "strict": strict,
           "converged": int(p_ok.sum()), "converged_kernel": int(ok.sum()),
           "converged_both": int(both.sum()),
           "kernel_loses": int((p_ok & ~ok).sum()),
           "kernel_gains": int((ok & ~p_ok).sum()),
           "ok_differ": int((ok != p_ok).sum()),
           "hard_differ_where_both_ok": int(word_differs[both].sum()),
           "hard_differ_elsewhere": int(word_differs[~both].sum()),
           "max_abs_err": float(err.max()) if err.numel() else 0.0}
    if strict:
        held = out["ok_differ"] == 0 and out["max_abs_err"] <= MP_CONF_TOL
    else:
        held = (abs(out["converged_kernel"] - out["converged"]) <= MP_GAP_MAX
                and out["ok_differ"] <= MP_FLIPS_MAX)
    if model:
        picks = torch.unique(torch.cat([
            torch.arange(0, probs.shape[0], MP_MODEL_STRIDE,
                         device=probs.device),
            (ok != p_ok).nonzero().reshape(-1)]))
        out.update(mp_vs_model(dec, probs[picks], hard[picks], ok[picks],
                               conf[picks]))
        held = held and out["model_words_differ"] == 0
    out["ok"] = (launched == 1 and out["hard_differ_where_both_ok"] == 0
                 and held)
    return out


def mp_vs_model(dec, probs: torch.Tensor, hard: torch.Tensor,
                ok: torch.Tensor, conf: torch.Tensor) -> dict:
    """The kernel's results on ``probs`` against the NumPy model of its
    arithmetic (``tools/qra_mp_model.py``) on the CPU: the words whose
    symbols, flag or confidence bits differ."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from qra_mp_model import mp_model

    t = time.monotonic()
    m_hard, m_ok, m_conf = mp_model(dec, probs.cpu().numpy())
    differ = ((hard.cpu().numpy() != m_hard).any(-1)
              | (ok.cpu().numpy() != m_ok)
              | (conf.cpu().numpy().view(np.uint32) != m_conf.view(np.uint32)))
    return {"model_words": int(probs.shape[0]),
            "model_words_differ": int(differ.sum()),
            "model_s": round(time.monotonic() - t, 1)}


def benign_q65_priors(dev) -> torch.Tensor:
    """The message-passing words of a Q65-30 decode on the card (top 4
    candidates) of 16 windows: a -16 dB burst in each even one (four
    messages at four frequencies), seeded unit noise in the odd ones; 320
    words that converge within a few iterations or never, the kind the
    CPU tests hold the kernel's model on (``q65_priors`` of
    ``tests/test_torch_qary_kernels.py``)."""
    from cwsl_digi_tpu_torch.modes import q65, qra
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    rng = np.random.default_rng(SEED + 67)
    msgs = ("CQ W2AXR FN13", "CQ K1ABC FN42", "K1ABC W9XYZ EN37",
            "W9XYZ K1ABC -11")
    wins = []
    for w in range(16):
        if w % 2:
            wins.append(rng.standard_normal(len(wins[-1])))
        else:
            clean = q65.synthesize(msgs[w // 2 % 4], 800.0 + 400 * (w // 4))
            wins.append(add_noise_at_snr(clean, -16.0, 12_000, rng))
    rec = []
    decode = qra.QaryMPDecoder.decode

    def keep(self, probs):
        rec.append(probs.clone())
        return decode(self, probs)

    qra.QaryMPDecoder.decode = keep
    try:
        q65.Q65Decoder(top_k=4, device=dev).decode(torch.from_numpy(
            np.stack(wins).astype(np.float32)).to(dev))
    finally:
        qra.QaryMPDecoder.decode = decode
    return rec[0]


def q65_lists_vs_plain(dev, audio: torch.Tensor) -> dict:
    """A Q65-30 decode of ``audio`` on the card through ``qra_mp`` and
    again with the plain message passing: the decode lists identical
    (message, SNR, dt, frequency and score of every entry)."""
    from cwsl_digi_tpu_torch.modes import q65, qra

    def lists(res):
        return [[(r.message, r.snr_db, r.dt_s, r.freq_hz, r.score)
                 for r in w] for w in res]

    dec = q65.Q65Decoder(device=dev)
    got = lists(dec.decode(audio))
    kernel = qra.QaryMPDecoder.decode
    qra.QaryMPDecoder.decode = qra.QaryMPDecoder.decode_plain
    try:
        want = lists(dec.decode(audio))
    finally:
        qra.QaryMPDecoder.decode = kernel
    out = {"windows": len(want), "decodes": sum(len(w) for w in want),
           "windows_differ": sum(a != b for a, b in zip(got, want))}
    out["ok"] = out["windows_differ"] == 0 and out["decodes"] > 0
    return out


def median_vs_plain(x: torch.Tensor) -> dict:
    """``median_rows`` (through ``gfsk_engine._median_rows``) against
    ``_median_rows_plain`` on the same CUDA rows [R, N]: bit for bit (NaN
    as NaN).  One kernel launch."""
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk
    from cwsl_digi_tpu_torch.modes import gfsk_engine

    before = mk.launches["median_rows"]
    got = gfsk_engine._median_rows(x)
    launched = mk.launches["median_rows"] - before
    want = gfsk_engine._median_rows_plain(x)
    same = (got == want) | (got.isnan() & want.isnan())
    out = {"shape": list(x.shape), "launches": launched,
           "bits_differ": _floats_differ(got, want),
           "nan_rows": int(want.isnan().sum()),
           "max_abs_err": float(torch.where(same, 0.0,
                                            (got - want).abs()).max())}
    out["ok"] = launched == 1 and out["bits_differ"] == 0
    return out


def qsync_vs_plain(spec, power_sync: torch.Tensor, base: torch.Tensor
                   ) -> dict:
    """``qary_sync`` (through ``qary_engine._qary_sync``) against
    ``_qary_sync_plain`` on the same CUDA map: top_val bit for bit (NaN as
    NaN), top_idx identical.  One kernel launch."""
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk
    from cwsl_digi_tpu_torch.modes import qary_engine

    before = qk.launches["qary_sync"]
    val, idx = qary_engine._qary_sync(spec, power_sync, base)
    launched = qk.launches["qary_sync"] - before
    p_val, p_idx = qary_engine._qary_sync_plain(spec, power_sync, base)
    same = (val == p_val) | (val.isnan() & p_val.isnan())
    out = {"shape": list(power_sync.shape), "top_k": spec.top_k,
           "launches": launched,
           "val_bits_differ": _floats_differ(val, p_val),
           "idx_differ": int((idx != p_idx).sum()),
           "nan_scores": int(p_val.isnan().sum()),
           "tied_pairs": int((p_val[:, 1:] == p_val[:, :-1]).sum()),
           "max_abs_err": float(torch.where(same, 0.0,
                                            (val - p_val).abs()).max())}
    out["ok"] = (launched == 1 and out["val_bits_differ"] == 0
                 and out["idx_differ"] == 0)
    return out


def planted_sync(spec, power_sync: torch.Tensor, base: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Three windows of a recorded map with planted edges: window 0's best
    column copied into a bin seven strips away (equal scores in two
    cells), a NaN entry in window 1 under its finite base (NaN scores in
    one column, first), and window 2's base NaN (every score NaN)."""
    from cwsl_digi_tpu_torch.modes import qary_engine

    ps, base = power_sync[:3].clone(), base[:3].clone()
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    n_f0 = fmax_bin - fmin_bin
    _, idx = qary_engine._qary_sync_plain(spec, ps[:1], base[:1])
    f = int(idx[0, 0]) % n_f0
    ps[0, :, (f + 7 * 32) % n_f0] = ps[0, :, f]
    ps[1, spec.os_t * spec.sync_syms[2] + 50, n_f0 // 3] = float("nan")
    base[2] = float("nan")
    return ps, base


def qsync_edge_cases(dev) -> dict:
    """``qary_sync``'s edges by name: (spec, map [2, H, F], base [2, 1,
    1]) on the card: ties everywhere (integers 0 to 2), every score equal
    across three warps, top-K 1 and 256, 50 time offsets, one sync
    symbol, a gap between sync symbols past the ring, hops not all
    congruent mod 8 (os_t 3: the block's shared ring), and n_f0 one bin
    either side of a strip's width (32 bins) and twice it."""
    from cwsl_digi_tpu_torch.modes import jt65, q65, qary_engine

    def spec_of(spec, n_f0, **kw):
        return dataclasses.replace(spec, fmin_hz=0.0,
                                   fmax_hz=(n_f0 + 0.5) * spec.bin_hz, **kw)

    jt, q = jt65.SPEC, q65.SPEC
    cases = {"ties": (spec_of(jt, 100), "ints"),
             "all equal": (spec_of(jt, 10), "ones"),
             "k1": (spec_of(q, 200, top_k=1), "noise"),
             "k256": (spec_of(q, 200, top_k=256), "ints"),
             "n_t0 50": (spec_of(q, 150, max_hops=50), "noise"),
             "one symbol": (spec_of(q, 90, sync_syms=(5,)), "noise"),
             "gap past the ring": (
                 spec_of(q, 70, sync_syms=(2, 40, 41, 90)), "ints"),
             "os_t 3": (spec_of(q, 120, os_t=3), "noise"),
             "os_t 3 gap past the ring": (
                 spec_of(q, 70, os_t=3, sync_syms=(2, 40, 41, 150)),
                 "ints")}
    for n_f0 in (31, 33, 63, 65):
        cases[f"n_f0 {n_f0}"] = (spec_of(q, n_f0), "noise")
    rng = np.random.default_rng(SEED + 67)
    out = {}
    for name, (spec, kind) in cases.items():
        _, _, n_bins = qary_engine._bin_range(spec)
        h = spec.os_t * max(spec.sync_syms) + spec.max_hops + 8
        shape = (2, h, n_bins)
        ps = (rng.exponential(size=shape) if kind == "noise"
              else rng.integers(0, 3, shape) if kind == "ints"
              else np.ones(shape)).astype(np.float32)
        base = ps.mean(axis=(1, 2), keepdims=True).astype(np.float32) \
            * np.float32(len(spec.sync_syms))
        out[name] = (spec, torch.from_numpy(ps).to(dev),
                     torch.from_numpy(base).to(dev))
    return out


def qsync_design(dev, shapes: dict) -> dict:
    """The ``qary_sync`` launch at each of ``shapes`` ({name: (spec,
    map)}): the strips and lists (blocks) a window, the blocks, the
    kernel's registers, spills and shared memory, the blocks an SM and the
    waves, and the look-ahead of a warp's own ring (the path of hops
    congruent mod 8: class rows past the window summed, and the bytes a
    block may have in flight)."""
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk
    from cwsl_digi_tpu_torch.modes import qary_engine

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    attrs = qk.kernel_attrs(dev)["qary_sync"]
    out = {}
    for name, (spec, ps) in shapes.items():
        fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
        b = ps.shape[0]
        plan = qk.sync_plan(fmax_bin - fmin_bin, spec.top_k)
        occ = qk.sync_occupancy(dev, spec.top_k, plan["lists"])
        blocks = plan["lists"] * b
        ahead = 32 - 16          # a warp's ring less a window's class rows
        out[name] = {"shape": list(ps.shape), **plan, "blocks": blocks,
                     **occ, **attrs, "threads": 256,
                     "waves": blocks / (occ["blocks_an_sm"] * sms),
                     "class_rows_ahead": ahead,
                     "bytes_in_flight_a_block": 8 * ahead * 32 * 4}
        print(f"qsync_design {name}: {json.dumps(out[name])}")
    return out


def median_edge_rows(dev) -> torch.Tensor:
    """One-row maps [1, N] that test the median's edges, odd and even N:
    ties, signed zeros, a NaN, infinities, two middle values apart at the
    first pass and one ulp apart, noise; noise one key either side of each
    plan's limits; and the large plan's ties at its sample's keys, sample
    miss and candidate overflow."""
    rng = np.random.default_rng(SEED + 65)
    one = np.nextafter(np.float32(1.0), np.float32(2.0))
    rows = [rng.integers(-3, 4, 999), rng.integers(0, 3, 1000),
            np.where(rng.random(1000) < 0.5, -0.0, 0.0),
            np.where(rng.random(999) < 0.5, -0.0, 0.0),
            np.r_[rng.standard_normal(500), np.nan],
            np.r_[np.full(5, np.inf), np.full(4, -np.inf)],
            np.repeat([1.0, 1000.0], 300), np.repeat([1.0, one], 300),
            rng.exponential(size=4001)]
    rows += [rng.exponential(size=n) for n in median_limit_lengths()]
    # the large plan: ties at its sample's keys, a sample that misses the
    # middle, candidates past their buffer (both then the whole row again)
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk

    n = mk.ONCHIP_MAX + 1
    pos = mk.sample_positions(n)
    miss = rng.exponential(size=n) + 10.0
    miss[pos] = -1.0
    over = np.full(n, 0.5)
    over[pos] = rng.permutation(mk.SAMPLE) - 8000.0
    rows += [rng.integers(0, 5, n), miss, over]
    return [torch.from_numpy(np.asarray(r, np.float32)[None]).to(dev)
            for r in rows]


def median_limit_lengths() -> list[int]:
    """Row lengths one key either side of each ``median_rows`` plan's
    limits: one block (KEYS_BLOCK), a cluster's growth (2 and 16
    KEYS_BLOCK), the on-chip plans' end (ONCHIP_MAX)."""
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk

    kb, mx = mk.KEYS_BLOCK, mk.ONCHIP_MAX
    return [kb, kb + 1, 2 * kb, 2 * kb + 1, 16 * kb, 16 * kb + 1, mx,
            mx + 1]


def mp_bound_ms(dec, b: int) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the sum-product decode of ``b`` words:
    the priors read and the symbols, flags and confidences written once at
    the HBM rate; per word and iteration the float operations of the
    algorithm on the real edges E (152) and checks: per edge of a variable
    of d edges the variable-to-check message (d - 2 products of the other
    messages, the channel's, the padding scale's, the underflow test's
    product and compare, and a clamp: d + 3 a symbol), the transform (6 x
    64 adds), its normalisation (an add, a reciprocal, 64 products), the
    inverse transform (6 x 64), the scaling and clamp of the new message (2
    x 64), the leave-one-out products (3 r - 4 a symbol for a check of r
    slots); then the posterior (64 E products, 63 x 3 x 64 for its sum and
    division, 63 x 63 compares), the syndrome (2 E integer operations) and
    the mean; at FP32_OPS (``ops_ms_fma_rate``: at FP32_FLOPS)."""
    tabs = dec._host_tables()
    n, nc, mr, _ = dec.kernel_code
    deg = tabs["col_mask"].sum(axis=1)
    e = int(deg.sum())
    r = tabs["row_mask"].sum(axis=1)
    loo = int(64 * np.maximum(3 * r - 4, 0).sum())
    v2c = int(64 * (deg * (deg + 3)).sum())
    per_iter = v2c + e * (384 + 2 + 64 + 384 + 128) + loo
    final = 64 * e + n * 3 * 64 + n * 63 + n
    ops = float(b) * (dec.iters * per_iter + final)
    n_bytes = b * (n * 64 * 4 + n * 8 + 1 + 4) + dec.kernel_tables().size
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"float_ops": ops, "bytes": n_bytes, "edges": e,
             "ops_a_word_iteration": per_iter,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def median_bound_ms(x: torch.Tensor) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the median of each row of x [R, N]:
    the rows read and one float a row written at the HBM rate; one key
    operation an entry at INT32_OPS."""
    r, n = x.shape
    n_bytes = r * n * 4 + r * 4
    return (n_bytes / HBM_BYTES_S * 1e3, r * n / INT32_OPS * 1e3,
            {"bytes": n_bytes, "ops_ms_fma_rate": r * n / FP32_FLOPS * 1e3})


def median_plan_of(dev, x: torch.Tensor) -> dict:
    """The ``median_rows`` plan the wrapper picks for rows x [R, ...]."""
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk

    return mk.median_plan(x[0].numel(), mk.fits16(dev), rows=x.shape[0])


def median_design(dev, rec: dict) -> list[dict]:
    """Each ``median_rows`` plan the recorded medians run in, at the first
    shape that runs it: threads, dynamic shared memory and blocks a
    cluster (or the large plan's sample, candidate buffer and stream
    blocks), each kernel's registers, spills and static shared memory,
    blocks an SM and clusters the card holds at once."""
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk

    attrs = mk.instance_attrs(dev)
    rows, seen = [], set()
    for name, x in rec["median"]:
        p = median_plan_of(dev, x)
        if p["plan"] in seen:
            continue
        seen.add(p["plan"])
        if p["plan"] == "large":
            kernels = {
                "large_sample": (mk.SAMPLE_THREADS, mk.SAMPLE_SMEM_BYTES,
                                 mk.SAMPLE_CLUSTER),
                "large_stream": (mk.STREAM_THREADS, 0, 1),
                "large_finish": (mk.FINISH_THREADS, mk.FINISH_SMEM_BYTES,
                                 mk.FINISH_CLUSTER)}
        else:
            kernels = {f"onchip_{p['plan']}": (p["threads"], p["smem_bytes"],
                                               p["cluster"])}
        rows.append({"plan": p, "shape": list(x.shape), "kernels": {
            k: {**attrs[k], "threads": t, "dynamic_smem_bytes": sm,
                "cluster": c, **mk.occupancy(dev, k, t, sm, c)}
            for k, (t, sm, c) in kernels.items()}})
    return rows


def qsync_bound_ms(spec, power_sync: torch.Tensor
                   ) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the sync correlation and top-K of
    these windows: the rows the scores read (the union of [os_t s, os_t s
    + max_hops) over the sync symbols, n_f0 bins wide), the bases and the
    K values and indices written once at the HBM rate; per score S - 1
    adds, a division and a compare at FP32_OPS."""
    from cwsl_digi_tpu_torch.modes import qary_engine

    b = power_sync.shape[0]
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    n_f0, n_t0, s = fmax_bin - fmin_bin, spec.max_hops, len(spec.sync_syms)
    rows = len({spec.os_t * sym + t for sym in spec.sync_syms
                for t in range(n_t0)})
    n_bytes = b * (rows * n_f0 * 4 + 4 + spec.top_k * 12) + s * 4
    ops = float(b) * n_t0 * n_f0 * (s + 1)
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"bytes": n_bytes, "rows": rows, "float_ops": ops,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def qary_kernels_phase(dev) -> dict:
    """``qra_mp``, ``median_rows`` and ``qary_sync`` against their plain
    versions on the card on the decoders' own inputs
    (``record_qary_inputs``) and on edges: on the 7,680 words of Q65's
    64-window decode the words both converge on identical, the converged
    counts and flags within MP_GAP_MAX and MP_FLIPS_MAX, the NumPy model
    bit for bit on a sample and every moved word, and the decode lists
    identical; on a batch of noise priors and on benign priors
    (``benign_q65_priors``) every flag identical; every recorded median (JT65's and Q65's maps,
    Q65's priors, WSPR's map, FT8's strided view) and the edge rows bit for
    bit; the selection on every recorded JT65 and Q65 map and on three
    planted windows of each (a tie in two strips, NaN scores, every
    score NaN), bit for bit.  Then each kernel's device time at the
    decoders' shapes beside the plain version's, the bound and the
    library call (for the median ``torch.median`` where a row's count is
    odd, the same function, and ``torch.quantile`` where it is even and
    the map has at most 2**24 entries; ``torch.topk`` of the score map),
    each kernel's registers and spills."""
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk
    from cwsl_digi_tpu_torch.modes import gfsk_engine, qary_engine

    rec = record_qary_inputs(dev)
    checks = {}
    dec, probs = rec["mp"][0]
    checks["qra_mp q65 64 windows"] = mp_vs_plain(dec, probs, model=True)
    audio = torch.from_numpy(_weak_windows("Q65-30", 64, SEED + 63)).to(dev)
    checks["qra_mp q65 decode lists"] = q65_lists_vs_plain(dev, audio)
    del audio
    g = torch.Generator(device=dev).manual_seed(SEED + 66)
    noise_e = torch.empty((8, 24, 63, 64), device=dev).exponential_(
        generator=g)
    noise = qary_engine._mp_priors(qary_engine.QaryDecoder.MP_VARIANTS,
                                   noise_e).reshape(-1, 63, 64)
    checks["qra_mp noise priors"] = mp_vs_plain(dec, noise, strict=True)
    benign = benign_q65_priors(dev)
    checks["qra_mp benign priors"] = mp_vs_plain(dec, benign, strict=True)
    if not 0 < checks["qra_mp benign priors"]["converged"] < benign.shape[0]:
        raise AssertionError("the benign Q65 priors hold no converging or "
                             "no failing word")
    del benign
    for i, (name, x) in enumerate(rec["median"]):
        checks[f"median {name} {i}"] = median_vs_plain(x)
    for i, (name, x) in enumerate(rec["median_view"]):
        checks[f"median {name} {i}"] = median_vs_plain(x)
    for i, x in enumerate(median_edge_rows(dev)):
        checks[f"median edge row {i}"] = median_vs_plain(x)
    for i, (name, spec, ps, base) in enumerate(rec["sync"]):
        checks[f"qary_sync {name} {i}"] = qsync_vs_plain(spec, ps, base)
    for name in ("JT65", "Q65-30"):
        _, spec, ps, base = next(c for c in rec["sync"] if c[0] == name)
        checks[f"qary_sync {name} planted"] = qsync_vs_plain(
            spec, *planted_sync(spec, ps, base))
    for name, (spec, ps, base) in qsync_edge_cases(dev).items():
        checks[f"qary_sync edge {name}"] = qsync_vs_plain(spec, ps, base)
    for name, c in checks.items():
        print(f"q-ary kernels vs plain, {name}: {json.dumps(c)}")
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"q-ary kernels disagree with the plain "
                             f"versions: {bad}")
    attrs = {**qk.kernel_attrs(dev), **mk.kernel_attrs(dev)}
    for row in median_design(dev, rec):
        print(f"median_design {json.dumps(row)}")
    edges = int(dec._host_tables()["row_mask"].sum())
    smem = qk.mp_smem_bytes(dec.kernel_code[0], edges)
    blocks = qk.mp_blocks_per_sm(dev, dec.kernel_code, edges)
    print(f"q-ary kernels' design: attributes {json.dumps(attrs)}, qra_mp "
          f"dynamic shared memory {smem} B, {blocks} blocks an SM")
    design_shapes = {}
    for name, spec, ps, _ in rec["sync"]:
        design_shapes.setdefault(f"{name} {list(ps.shape)}", (spec, ps))
    for name, spec, ps, _ in rec["sync"]:
        design_shapes.setdefault(f"{name} app {[4, *ps.shape[1:]]}",
                                 (spec, ps[:4]))
    sync_design = qsync_design(dev, design_shapes)
    if blocks < qk.MP_BLOCKS_SM:
        raise AssertionError(f"qra_mp: {blocks} blocks an SM, the design "
                             f"holds {qk.MP_BLOCKS_SM}")

    # the main path's shapes: Q65's 7,680 words, JT65's map of its device
    # batch (the costliest median and selection)
    jt = next(c for c in rec["sync"] if c[0] == "JT65")
    _, jspec, jps, jbase = jt
    jflat = jps.reshape(jps.shape[0], -1)
    runs = {"qra_mp": (lambda: dec.decode(probs),
                       lambda: dec.decode_plain(probs), 2, 1),
            "median_rows": (lambda: mk.median_rows(jflat),
                            lambda: gfsk_engine._median_rows_plain(jflat),
                            5, 2),
            "qary_sync": (
                lambda: qary_engine._qary_sync(jspec, jps, jbase),
                lambda: qary_engine._qary_sync_plain(jspec, jps, jbase), 5,
                2)}
    bounds = {"qra_mp": mp_bound_ms(dec, probs.shape[0]),
              "median_rows": median_bound_ms(jflat),
              "qary_sync": qsync_bound_ms(jspec, jps)}
    errs = {k: max(c.get("max_abs_err", 0.0) for n, c in checks.items()
                   if n.startswith(prefix))
            for k, prefix in (("qra_mp", "qra_mp"),
                              ("median_rows", "median"),
                              ("qary_sync", "qary_sync"))}
    out = stage_kernel_times(
        runs, bounds, errs,
        {"qra_mp": list(probs.shape), "median_rows": list(jflat.shape),
         "qary_sync": list(jps.shape)})

    # each recorded shape once: kernel, plain, bound, library
    shapes = {}
    for name, x in rec["median"]:
        key = f"{name} {list(x.shape)}"
        if key in shapes:
            continue
        if x.shape[1] % 2:
            # an odd count: torch.median computes the same function
            got, lib_med = mk.median_rows(x), torch.median(x, dim=1).values
            lib_call = "torch.median"
            lib = cuda_ms(lambda: torch.median(x, dim=1), 5)
            agree = bool(((got == lib_med)
                          | (got.isnan() & lib_med.isnan())).all())
        elif x.numel() <= 2 ** 24:
            # (issued from the host: quantile checks q on the host)
            lib_call, agree = "torch.quantile", None
            lib = eager_ms(lambda: torch.quantile(
                x, 0.5, dim=1, interpolation="midpoint"), 3)
        else:
            lib_call, lib, agree = None, None, None
        shapes[key] = {"kernel": "median_rows",
                       "plan": median_plan_of(dev, x),
                       "ms": cuda_ms(lambda: mk.median_rows(x), 5),
                       "plain_ms": eager_ms(
                           lambda: gfsk_engine._median_rows_plain(x), 2),
                       "bound_ms": max(median_bound_ms(x)[:2]),
                       "library": lib_call, "library_ms": lib,
                       "library_agrees": agree}
    for name, x in rec["median_view"]:
        key = f"{name} {list(x.shape)}"
        if key in shapes:
            continue
        shapes[key] = {"kernel": "median_rows",
                       "plan": median_plan_of(dev, x),
                       "ms": cuda_ms(lambda: gfsk_engine._median_rows(x), 5),
                       "plain_ms": eager_ms(
                           lambda: gfsk_engine._median_rows_plain(x), 2),
                       "bound_ms": max(median_bound_ms(
                           x.reshape(x.shape[0], -1))[:2]),
                       "library": None, "library_ms": None,
                       "library_agrees": None}
    for name, spec, ps, base in rec["sync"]:
        key = f"{name} {list(ps.shape)}"
        if key in shapes:
            continue
        fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
        acc = None
        for sym in spec.sync_syms:
            sl = ps[:, spec.os_t * sym : spec.os_t * sym + spec.max_hops,
                    : fmax_bin - fmin_bin]
            acc = sl if acc is None else acc + sl
        score = (acc / (base + 1e-30)).reshape(ps.shape[0], -1)
        del acc
        shapes[key] = {"kernel": "qary_sync",
                       "ms": cuda_ms(lambda: qary_engine._qary_sync(
                           spec, ps, base), 5),
                       "plain_ms": eager_ms(
                           lambda: qary_engine._qary_sync_plain(spec, ps,
                                                                base), 2),
                       "bound_ms": max(qsync_bound_ms(spec, ps)[:2]),
                       "library_ms": cuda_ms(
                           lambda: torch.topk(score, spec.top_k, dim=1), 5)}
    for key, v in shapes.items():
        v["share"] = v["bound_ms"] / v["ms"]
        print(f"q-ary {v['kernel']} at {key}: {json.dumps(v)}")
    jkey = f"JT65 {list(jps.shape)}"
    jmed = shapes[f"JT65 map {list(jflat.shape)}"]
    if jmed["library_agrees"] is not True:
        raise AssertionError(f"torch.median disagrees with median_rows at "
                             f"JT65's map {list(jflat.shape)}")
    out["median_rows"]["library_ms"] = jmed["library_ms"]
    out["qary_sync"]["library_ms"] = shapes[jkey]["library_ms"]
    return {"kernels": out, "checks": checks, "attrs": attrs,
            "shapes": shapes, "qsync_design": sync_design}


def record_decode_inputs(dev, windows: int = 64) -> dict:
    """The inputs the q-ary decoders hand the last three kernels on the
    card in the App's 64-window decodes (or ``windows``) of the weak
    replay's JT65 and Q65-30 bursts: each ``_symbol_energies`` call (JT65's 15-window device
    batches, Q65-30's 30-window ones with the 64 energies), and JT65's Chase
    stages, ``chase_erasures`` and ``chase_score`` (1,536 candidates in
    chunks of 1,024 and 512 x 256 trials).  {"symbols": [(mode, spec,
    power, t0, f0, data_syms)], "erasures": [args], "score": [args],
    "lists": {mode: the decode list}}."""
    from cwsl_digi_tpu_torch.modes import jt65, q65, qary_engine, rs_device

    rec = {"symbols": [], "erasures": [], "score": [], "lists": {}}
    label = {"mode": ""}
    symbols = qary_engine._symbol_energies
    erasures, score = rs_device.chase_erasures, rs_device.chase_score

    def keep(args):
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def sym_rec(spec, power, t0, f0, data_syms):
        rec["symbols"].append((label["mode"], spec) + keep(
            (power, t0, f0, data_syms)))
        return symbols(spec, power, t0, f0, data_syms)

    def era_rec(*args):
        rec["erasures"].append(keep(args))
        return erasures(*args)

    def score_rec(*args):
        rec["score"].append(keep(args))
        return score(*args)

    qary_engine._symbol_energies = sym_rec
    rs_device.chase_erasures, rs_device.chase_score = era_rec, score_rec
    try:
        for mode, make in (("JT65", jt65.JT65Decoder),
                           ("Q65-30", q65.Q65Decoder)):
            label["mode"] = mode
            audio = torch.from_numpy(
                _weak_windows(mode, windows, SEED + 63)).to(dev)
            res = make(device=dev).decode(audio)
            rec["lists"][mode] = [[r.message for r in w] for w in res]
            print(f"q-ary decode kernels' {mode} inputs: "
                  f"{sum(len(r) for r in res)} decodes in {len(res)} "
                  "windows")
            del audio
    finally:
        qary_engine._symbol_energies = symbols
        rs_device.chase_erasures, rs_device.chase_score = erasures, score
    return rec


def symbols_vs_plain(spec, power, t0, f0, data_syms) -> dict:
    """``qary_symbols`` (through ``qary_engine._symbol_energies``) against
    ``_symbol_energies_plain`` on the same CUDA map: e (Q65), top_e,
    top_tone, e_sum and margin bit for bit; and against the plain version
    on CPU copies: all but the margin bit for bit (the CPU's log may round
    another way), the margin's largest error printed.  One launch."""
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk
    from cwsl_digi_tpu_torch.modes import qary_engine

    names = ("e", "top_e", "top_tone", "e_sum", "margin")
    before = qk.launches["qary_symbols"]
    got = qary_engine._symbol_energies(spec, power, t0, f0, data_syms)
    launched = qk.launches["qary_symbols"] - before
    plain = qary_engine._symbol_energies_plain(spec, power, t0, f0,
                                               data_syms)
    cpu = qary_engine._symbol_energies_plain(
        spec, power.cpu(), t0.cpu(), f0.cpu(), data_syms.cpu())
    out = {"shape": list(power.shape), "candidates": list(t0.shape),
           "launches": launched, "full_e": got[0] is not None}
    for name, a, b, c in zip(names, got, plain, cpu):
        if a is None:
            continue
        out[f"{name}_differ"] = (_floats_differ(a, b) if a.is_floating_point()
                                 else int((a != b).sum()))
        out[f"{name}_differ_cpu"] = _bits_differ(a, c)
    out["margin_err_cpu"] = _abs_err(got[4], cpu[4])
    out["tied_best_two"] = int((plain[1][..., 0] == plain[1][..., 1]).sum())
    out["max_abs_err"] = _abs_err(got[3], cpu[3])
    out["ok"] = launched == 1 and all(
        v == 0 for k, v in out.items() if k.endswith("_differ")) and all(
        out[f"{n}_differ_cpu"] == 0 for n in names[:4] if f"{n}_differ_cpu"
        in out)
    return out


def planted_symbols(spec, power, t0, f0):
    """A copy of a map with planted rows at the first candidate of each
    window: its first data symbol's two best tones tied, its second's
    tones all equal, its third holding a NaN tone and +inf."""
    power = power.clone()
    bins = f0[:, 0, None] + spec.os_f * (spec.tone_offset
                                         + torch.arange(64, device=f0.device))
    for b in range(power.shape[0]):
        for s, kind in zip(spec.data_syms[:3], ("tie", "flat", "nan")):
            h = int(t0[b, 0]) + spec.os_t * s
            row = power[b, h, bins[b]]
            if kind == "tie":
                power[b, h, bins[b][[9, 3]]] = 2 * row.max()
            elif kind == "flat":
                power[b, h, bins[b]] = 1.5
            else:
                power[b, h, bins[b][[17, 40]]] = torch.tensor(
                    [float("nan"), float("inf")], device=power.device)
    return power


def erasures_vs_plain(args) -> dict:
    """``chase_erasures`` against ``chase_erasures_plain`` on the card and
    on CPU copies: every flag identical.  One launch."""
    from cwsl_digi_tpu_torch.modes import _chase_kernels as ck
    from cwsl_digi_tpu_torch.modes import rs_device

    nroots, n_trials, n_det, margin, seed, c0 = args
    before = ck.launches["chase_erasures"]
    era = rs_device.chase_erasures(*args)
    launched = ck.launches["chase_erasures"] - before
    plain = rs_device.chase_erasures_plain(*args)
    cpu = rs_device.chase_erasures_plain(
        nroots, n_trials, n_det, margin.cpu(),
        seed.cpu() if isinstance(seed, torch.Tensor) else seed, c0)
    out = {"shape": list(era.shape), "c0": c0, "launches": launched,
           "era_bits_differ": int((era != plain).sum()),
           "era_bits_differ_cpu": _bits_differ(era, cpu),
           "erased_share": float(era.float().mean()), "max_abs_err": 0.0}
    out["ok"] = (launched == 1 and out["era_bits_differ"] == 0
                 and out["era_bits_differ_cpu"] == 0)
    return out


def score_vs_plain(args) -> dict:
    """``chase_score`` against ``chase_score_plain`` on the same CUDA
    trials: info and ok identical, the best scores within SCORE_TOL (-inf
    alike), and a best trial other than the plain version's only where
    their plain scores lie within SCORE_TOL.  One launch."""
    from cwsl_digi_tpu_torch.modes import _chase_kernels as ck
    from cwsl_digi_tpu_torch.modes import rs_device

    k, accept, corrected, ok, era, top_e, top_tone, e_sum = args
    before = ck.launches["chase_score"]
    info, score, best_ok, trial = ck.chase_score(
        corrected, ok, era, top_e, top_tone, e_sum, k, accept)
    launched = ck.launches["chase_score"] - before
    p_info, p_score, p_ok = rs_device.chase_score_plain(*args)
    scores, _ = rs_device.chase_trial_scores_plain(
        accept, corrected, ok, era, top_e, top_tone, e_sum)
    p_trial = scores.argmax(dim=1)
    bidx = torch.arange(len(trial), device=trial.device)
    moved = trial != p_trial
    apart = (scores[bidx, trial] - scores[bidx, p_trial]).abs()
    fin = torch.isfinite(p_score)
    out = {"shape": list(corrected.shape), "launches": launched,
           "info_rows_differ": int((info != p_info).any(dim=1).sum()),
           "ok_differ": int((best_ok != p_ok).sum()),
           "finite_differ": int((torch.isfinite(score) != fin).sum()),
           "max_abs_err": float((score - p_score).abs()[fin].max())
           if fin.any() else 0.0,
           "best_trials_changed": int(moved.sum()),
           "changed_apart_max": float(apart[moved].max()) if moved.any()
           else 0.0, "ok_count": int(p_ok.sum())}
    out["ok"] = (launched == 1 and out["info_rows_differ"] == 0
                 and out["ok_differ"] == 0 and out["finite_differ"] == 0
                 and out["max_abs_err"] <= SCORE_TOL
                 and out["changed_apart_max"] <= SCORE_TOL)
    return out


def planted_chase(args):
    """Edge cases of the erasure flags from a recorded chunk's first 64
    candidates: margins with ties, zeros of both signs, NaN and -inf (the
    rank's order) at a chunk offset whose draw index passes 2**32."""
    nroots, n_trials, n_det, margin, seed, _c0 = args
    m = margin[:64].clone()
    m[0, 5:25] = m[0, 5]
    m[1] = 0.25
    m[2, ::3] = 0.0
    m[2, 1::3] = -0.0
    m[3, [0, 7]] = float("nan")
    m[3, 9] = float("-inf")
    c0 = 2 ** 32 // ((n_trials - n_det) * margin.shape[1]) + 1
    return (nroots, n_trials, n_det, m, seed, c0)


def duplicate_trials(args):
    """A recorded score chunk's first 64 candidates with each odd trial a
    copy of the even one before it (corrected word, flag and erasures)."""
    k, accept, corrected, ok, era, top_e, top_tone, e_sum = args
    c = slice(0, 64)
    corrected, ok, era = (x[c].clone() for x in (corrected, ok, era))
    corrected[:, 1::2] = corrected[:, 0::2]
    ok[:, 1::2] = ok[:, 0::2]
    era[:, 1::2] = era[:, 0::2]
    return (k, accept, corrected, ok, era, top_e[c], top_tone[c], e_sum[c])


def unaligned_trials(args, n_trials: int = 37, shift: int = 1):
    """A recorded score chunk's first 64 candidates and first ``n_trials``
    trials, each of the corrected words and the erasures a view ``shift``
    bytes past a 16-byte boundary: a candidate's n_trials x n bytes and the
    bases not 16-byte aligned, so ``chase_score`` stages them by the
    block's byte copies, not the TMA unit."""
    k, accept, corrected, ok, era, top_e, top_tone, e_sum = args
    c = slice(0, 64)

    def shifted(x):
        x = x[c, :n_trials].contiguous()
        buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
        view = buf[shift:shift + x.numel()].view(x.shape)
        view.copy_(x)
        return view

    return (k, accept, shifted(corrected), ok[c, :n_trials].contiguous(),
            shifted(era), top_e[c], top_tone[c], e_sum[c])


def symbols_bound_ms(spec, t0: torch.Tensor) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of the tone gather and top-4 of these
    candidates: each of the 64 tones of a (candidate, data symbol) read
    once, t0 / f0 and the rows read, top_e, top_tone, e_sum, margin (and
    the 64 energies for Q65) written once, at the HBM rate; per row 63
    adds, 4 x 63 compares and two logs (TRIG_OPS each) at FP32_OPS.  The
    32-byte sectors the gather touches (os_f floats apart) are counted
    beside it."""
    rows = t0.numel() * len(spec.data_syms)
    out_b = 16 + 32 + 4 + 4 + (4 * 64 if spec.full_e else 0)
    n_bytes = rows * (64 * 4 + out_b) + t0.numel() * 16 \
        + 4 * len(spec.data_syms)
    ops = float(rows) * (63 + 4 * 63 + 2 * TRIG_OPS + 3)
    tones_a_sector = max(1, 32 // (4 * spec.os_f))
    sectors = rows * -(-64 // tones_a_sector)
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"bytes": n_bytes, "rows": rows, "float_ops": ops,
             "gather_sector_bytes": sectors * 32,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def erasures_bound_ms(args) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of a chunk's erasure flags: the margins
    and tables read and the flags written once at the HBM rate; the
    operations, THREEFRY_OPS a stochastic flag, a compare a deterministic
    one and 2 n a symbol's rank, the larger of the rotates, xors and shifts
    (THREEFRY_ALU_OPS a flag) at INT32_OPS and all of them at INT32_OPS +
    FP32_OPS (the adds may issue on either kind of lane)."""
    _nroots, n_trials, n_det, margin, _s, _c0 = args
    c, n = margin.shape
    n_bytes = c * n * 4 + c * n_trials * n + n * 4 \
        + (n_trials - n_det) * 4 + 8
    flags = float(c) * n * (n_trials - n_det)
    ops = flags * THREEFRY_OPS + float(c) * n * (n_det + 2 * n)
    ops_ms = max(flags * THREEFRY_ALU_OPS / INT32_OPS,
                 ops / (INT32_OPS + FP32_OPS)) * 1e3
    return (n_bytes / HBM_BYTES_S * 1e3, ops_ms,
            {"bytes": n_bytes, "int_ops": ops,
             "alu_ops": flags * THREEFRY_ALU_OPS,
             "ops_ms_fma_rate": ops_ms,
             "ops_ms_int32_lanes_only": ops / INT32_OPS * 1e3})


def score_bound_ms(args) -> tuple[float, float, dict]:
    """(bytes ms, ops ms, counts) of a chunk's soft score and selection:
    the corrected words, flags and erasures, the candidates' top-4 rows and
    sums read once, info, score, ok and trial written once at the HBM
    rate; per symbol and trial 4 compares, a select and two adds, per
    symbol 5 logs (TRIG_OPS each) at FP32_OPS."""
    k, _accept, corrected, *_ = args
    c, t, n = corrected.shape
    n_bytes = 2 * c * t * n + c * t + c * n * (16 + 32 + 4) \
        + c * (8 * k + 4 + 1 + 8)
    ops = float(c) * (t * n * 7 + n * 5 * TRIG_OPS)
    return (n_bytes / HBM_BYTES_S * 1e3, ops / FP32_OPS * 1e3,
            {"bytes": n_bytes, "float_ops": ops,
             "ops_ms_fma_rate": ops / FP32_FLOPS * 1e3})


def qary_decode_kernels_phase(dev) -> dict:
    """``qary_symbols``, ``chase_erasures`` and ``chase_score`` against
    their plain versions on the card on the decoders' own inputs
    (``record_decode_inputs``: the App's 64-window JT65 and Q65-30
    decodes) and on planted edges (tied, flat and NaN tone rows; tied,
    signed-zero, NaN and -inf margins at a chunk offset past 2**32 draws;
    trials duplicated in pairs; slabs off 16-byte alignment, which
    ``chase_score`` copies byte by byte): the gather bit for bit, the flags
    bit for
    bit (also against the plain version on CPU copies), the score's info
    and ok identical, its score within SCORE_TOL, and each changed best
    trial within SCORE_TOL of the plain one; then the same decodes with the
    plain stages on the card give the same decode lists.  Then each
    kernel's device time at JT65's shapes (the 15-window gather, the 1,024
    candidate chunk) beside the plain version's, the bound and, for the
    gather, ``torch.topk(e, 4)`` of its energies; each kernel's registers
    and spills, and the layouts of ``qary_symbols`` (lanes and rows a
    warp, blocks an SM, grid) and ``chase_score`` (stage, ring, shared
    bytes, blocks an SM, copy path)."""
    from cwsl_digi_tpu_torch.modes import _chase_kernels as ck
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk
    from cwsl_digi_tpu_torch.modes import jt65, q65, qary_engine, rs_device

    rec = record_decode_inputs(dev)
    checks = {}
    for i, (mode, spec, power, t0, f0, ds) in enumerate(rec["symbols"]):
        checks[f"qary_symbols {mode} {i}"] = symbols_vs_plain(
            spec, power, t0, f0, ds)
    for mode in ("JT65", "Q65-30"):
        _, spec, power, t0, f0, ds = next(r for r in rec["symbols"]
                                          if r[0] == mode)
        checks[f"qary_symbols {mode} planted"] = symbols_vs_plain(
            spec, planted_symbols(spec, power[:2], t0[:2], f0[:2]), t0[:2],
            f0[:2], ds)
    for i, args in enumerate(rec["erasures"]):
        checks[f"chase_erasures {i}"] = erasures_vs_plain(args)
    checks["chase_erasures planted"] = erasures_vs_plain(
        planted_chase(rec["erasures"][0]))
    for i, args in enumerate(rec["score"]):
        checks[f"chase_score {i}"] = score_vs_plain(args)
    checks["chase_score duplicated trials"] = score_vs_plain(
        duplicate_trials(rec["score"][0]))
    # slabs that are not 16-byte aligned: the block's byte copies
    checks["chase_score byte copies"] = score_vs_plain(
        unaligned_trials(rec["score"][0]))
    for name, c in checks.items():
        print(f"q-ary decode kernels vs plain, {name}: {json.dumps(c)}")
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"q-ary decode kernels disagree with the "
                             f"plain versions: {bad}")
    era_bits = sum(c.get("era_bits_differ", 0)
                   + c.get("era_bits_differ_cpu", 0) for c in checks.values())
    changed = sum(c.get("best_trials_changed", 0) for c in checks.values())
    score_err = max(c["max_abs_err"] for n, c in checks.items()
                    if n.startswith("chase_score"))
    print(f"q-ary decode kernels: era bits differing {era_bits}, chase "
          f"score error {score_err:.3g} (tolerance {SCORE_TOL}), best "
          f"trials changed {changed}")

    # the same decodes with the plain stages on the card
    stages = (qary_engine._symbol_energies, rs_device.chase_erasures,
              rs_device.chase_score)
    qary_engine._symbol_energies = qary_engine._symbol_energies_plain
    rs_device.chase_erasures = rs_device.chase_erasures_plain
    rs_device.chase_score = rs_device.chase_score_plain
    try:
        for mode, make in (("JT65", jt65.JT65Decoder),
                           ("Q65-30", q65.Q65Decoder)):
            audio = torch.from_numpy(
                _weak_windows(mode, 64, SEED + 63)).to(dev)
            res = make(device=dev).decode(audio)
            same = [[r.message for r in w] for w in res] == rec["lists"][mode]
            checks[f"{mode} decode lists, plain stages"] = {"ok": same}
            print(f"q-ary decode kernels: {mode} 64-window decode lists "
                  f"with the plain stages {'equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"{mode}: the plain stages' decode "
                                     "lists differ from the kernels'")
            del audio
    finally:
        (qary_engine._symbol_energies, rs_device.chase_erasures,
         rs_device.chase_score) = stages

    attrs = {**{k: v for k, v in qk.kernel_attrs(dev).items()
                if k == "qary_symbols"}, **ck.kernel_attrs(dev)}
    score_t, score_n = rec["score"][0][2].shape[1:]
    design = {"qary_symbols": qk.symbols_design(dev),
              "chase_score": {**ck.score_design(dev, score_t, score_n),
                              "tma_path": ck.score_bulk(
                                  rec["score"][0][2], rec["score"][0][4])}}
    print(f"q-ary decode kernels' design: attributes {json.dumps(attrs)}, "
          f"layout {json.dumps(design)}")
    _, jspec, jps, jt0, jf0, jds = next(r for r in rec["symbols"]
                                        if r[0] == "JT65")
    era_args, score_args = rec["erasures"][0], rec["score"][0]
    runs = {"qary_symbols": (
                lambda: qary_engine._symbol_energies(jspec, jps, jt0, jf0,
                                                     jds),
                lambda: qary_engine._symbol_energies_plain(jspec, jps, jt0,
                                                           jf0, jds), 5, 3),
            "chase_erasures": (
                lambda: rs_device.chase_erasures(*era_args),
                lambda: rs_device.chase_erasures_plain(*era_args), 5, 2),
            "chase_score": (
                lambda: rs_device.chase_score(*score_args),
                lambda: rs_device.chase_score_plain(*score_args), 5, 2)}
    bounds = {"qary_symbols": symbols_bound_ms(jspec, jt0),
              "chase_erasures": erasures_bound_ms(era_args),
              "chase_score": score_bound_ms(score_args)}
    errs = {k: max(c["max_abs_err"] for n, c in checks.items()
                   if n.startswith(k)) for k in QARY_DECODE_KERNELS}
    out = stage_kernel_times(
        runs, bounds, errs,
        {"qary_symbols": list(jps.shape) + [list(jt0.shape)],
         "chase_erasures": list(era_args[3].shape) + [era_args[1]],
         "chase_score": list(score_args[2].shape)})
    e = qary_engine._symbol_energies_plain(
        dataclasses.replace(jspec, full_e=True), jps, jt0, jf0, jds)[0]
    out["qary_symbols"]["library_ms"] = cuda_ms(
        lambda: torch.topk(e, 4, dim=-1), 5)
    del e
    # the other shapes the decodes hand them
    shapes = {}
    _, qspec, qps, qt0, qf0, qds = next(r for r in rec["symbols"]
                                        if r[0] == "Q65-30")
    shapes["qary_symbols Q65-30"] = {
        "shape": list(qps.shape), "ms": cuda_ms(
            lambda: qary_engine._symbol_energies(qspec, qps, qt0, qf0, qds),
            5), "bound_ms": max(symbols_bound_ms(qspec, qt0)[:2])}
    for name, args, fn, bound in (
            ("chase_erasures", rec["erasures"][-1], rs_device.chase_erasures,
             erasures_bound_ms),
            ("chase_score", rec["score"][-1], rs_device.chase_score,
             score_bound_ms)):
        shapes[f"{name} last chunk"] = {
            "shape": list(args[3].shape if name == "chase_erasures"
                          else args[2].shape),
            "ms": cuda_ms(lambda: fn(*args), 5),
            "bound_ms": max(bound(args)[:2])}
    for key, v in shapes.items():
        print(f"q-ary decode kernel at {key}: {json.dumps(v)}")
    return {"kernels": out, "checks": checks, "attrs": attrs,
            "design": design, "shapes": shapes, "era_bits_differ": era_bits,
            "best_trials_changed": changed}


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
    from cwsl_digi_tpu_torch.modes import (_chase_kernels, _gfsk_kernels,
                                           _median_kernels, _qary_kernels,
                                           _sync_kernels, _weak_kernels)
    from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels

    return (_kernels, ldpc_kernels, _gfsk_kernels, _sync_kernels,
            _weak_kernels, _qary_kernels, _median_kernels, _chase_kernels)


def _reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    LAUNCH_SHAPES.reset_pending()
    for mod in _kernel_modules():
        for name in mod.launches:
            mod.launches[name] = 0


def _launch_counts() -> dict:
    """{kernel: launches since the last ``_reset_launches``}, every
    library's."""
    LAUNCH_SHAPES.commit()
    return {name: n for mod in _kernel_modules()
            for name, n in mod.launches.items()}


def _launch_totals() -> dict:
    """{kernel: launches}, every library's, read without a reset."""
    return {name: n for mod in _kernel_modules()
            for name, n in mod.launches.items()}


def _require_launches(where: str, counts: dict, names) -> None:
    """Fail unless each kernel of ``names`` was launched in ``where``."""
    print(f"{where}: kernel launches {counts}")
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{where} did not launch {missing}")


def _launchers() -> dict:
    """{kernel: (module, the function that launches and counts it)}."""
    from cwsl_digi_tpu_torch.dsp import _kernels as ch
    from cwsl_digi_tpu_torch.modes import _chase_kernels as ck
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gk
    from cwsl_digi_tpu_torch.modes import _kernels as lk
    from cwsl_digi_tpu_torch.modes import _median_kernels as mk
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qk
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sk
    from cwsl_digi_tpu_torch.modes import _weak_kernels as wk

    return {"channelize": (ch, "channelize"), "bp_minsum": (lk, "bp_minsum"),
            "osd": (lk, "osd"), "subtract_known": (gk, "subtract_known"),
            "multisym_llrs": (gk, "_llr_launch"),
            "sync_score": (sk, "_score_launch"),
            "sync_select": (sk, "_select_launch"),
            "sync_refine": (sk, "_refine_launch"),
            "wspr_beam": (wk, "wspr_beam"), "rs_ee": (wk, "rs_ee"),
            "qra_mp": (qk, "qra_mp"), "qary_sync": (qk, "qary_sync"),
            "median_rows": (mk, "median_rows"),
            "qary_symbols": (qk, "qary_symbols"),
            "chase_erasures": (ck, "chase_erasures"),
            "chase_score": (ck, "chase_score")}


def _launch_work(name: str, args: tuple) -> int:
    """What a launch's bound grows with: channels x outputs for the
    channelizer, candidates for the LLRs and the refinement, else the
    largest operand's entries."""
    if name == "channelize":
        return int(args[2].shape[0]) * int(args[4])
    if name == "multisym_llrs":
        return int(args[1].shape[0]) * int(args[2])
    if name == "sync_refine":
        return int(args[2].numel())
    return max(int(a.numel()) for a in args if isinstance(a, torch.Tensor))


def _shape_key(x):
    """A hashable key of an argument: a tensor's shape and dtype, else the
    value."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_shape_key(y) for y in x)
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    return repr(x)


class LaunchShapes:
    """Each kernel's launches by shape: the functions that launch and
    count the kernels are wrapped; while ``on`` (True, or a set of the
    kernels to record), each call's shape (its operands' shapes, its other
    arguments) is counted and the operands of the first call at each
    shape kept (cloned).  The counts follow the launch counts:
    ``_reset_launches`` drops what was recorded since the last
    ``_launch_counts``, which adds it to the totals.  While ``timed``
    names a kernel, the work of its last call is kept as the timed
    shape's.  ``price`` replays each kept shape on the card."""

    def __init__(self):
        self.on: bool | set = False
        self.timed: str | None = None
        self.timed_work: dict[str, int] = {}
        self.calls: dict[str, dict] = {}       # kernel: {key: first call}
        self.pending: dict[str, dict] = {}     # kernel: {key: launches}
        self.counted: dict[str, dict] = {}
        self.kept_bytes = 0
        self._lock = threading.Lock()
        self._orig: dict[str, tuple] = {}

    def install(self) -> None:
        for name, (mod, attr) in _launchers().items():
            fn = getattr(mod, attr)
            self._orig[name] = (mod, attr, fn)
            setattr(mod, attr, self._wrap(name, fn))

    def uninstall(self) -> None:
        """Put the unwrapped functions back (what was recorded stays)."""
        for mod, attr, fn in self._orig.values():
            setattr(mod, attr, fn)
        self.on = False

    def _wrap(self, name: str, fn):
        def launch(*args, **kwargs):
            if self.timed == name:
                self.timed_work[name] = _launch_work(name, args)
            elif self.on is True or (self.on and name in self.on):
                self._note(name, args, kwargs)
            return fn(*args, **kwargs)
        return launch

    def _note(self, name: str, args: tuple, kwargs: dict) -> None:
        key = (_shape_key(args), _shape_key(sorted(kwargs.items())))
        with self._lock:
            p = self.pending.setdefault(name, {})
            p[key] = p.get(key, 0) + 1
            if key in self.calls.setdefault(name, {}):
                return
            self.kept_bytes += sum(a.numel() * a.element_size()
                                   for a in [*args, *kwargs.values()]
                                   if isinstance(a, torch.Tensor))

            def keep(a):
                return a.clone() if isinstance(a, torch.Tensor) else a
            self.calls[name][key] = {
                "work": _launch_work(name, args),
                "call": (tuple(keep(a) for a in args),
                         {k: keep(v) for k, v in kwargs.items()})}

    def reset_pending(self) -> None:
        with self._lock:
            self.pending = {}

    def commit(self) -> None:
        with self._lock:
            for name, p in self.pending.items():
                c = self.counted.setdefault(name, {})
                for key, n in p.items():
                    c[key] = c.get(key, 0) + n
            self.pending = {}

    def price(self, timed: dict) -> dict:
        """Each kernel's counted launches priced at their own shapes: the
        device time of a replay of every kept shape (``cuda_ms``) against
        the bound of the timed shape (``timed`` name: {"bound_ms"}) scaled
        by the work.  Returns {kernel: {"launches", "shapes", "gap_ms" (the
        sum of launches x (ms - bound)), "by_shape"}}."""
        print(f"launch shapes: {self.kept_bytes / 2**30:.3f} GiB of "
              f"operands kept")
        out = {}
        for name, counted in self.counted.items():
            t = timed[name]
            w_t = self.timed_work[name]
            fn = self._orig[name][2]
            gap, rows = 0.0, []
            order = sorted(counted.items(), key=lambda kv: -kv[1])
            for key, n in order:
                c = self.calls[name][key]
                bound = t["bound_ms"] * c["work"] / w_t
                args, kwargs = c["call"]
                ms = cuda_ms(lambda: fn(*args, **kwargs), 3)
                gap += n * (ms - bound)
                rows.append({"launches": n, "work": c["work"], "ms": ms,
                             "bound_ms": bound})
            out[name] = {"launches": sum(n for _, n in order),
                         "shapes": len(order), "timed_work": w_t,
                         "gap_ms": gap, "by_shape": rows}
            print(f"{name} launches at their own shapes: "
                  f"{json.dumps(out[name])}")
        return out


LAUNCH_SHAPES = LaunchShapes()


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
    _require_launches("main path", run["kernel_launches"],
                      GFSK_PATH_KERNELS)
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
                         _mixed_plan(), SEED + 2, GFSK_PATH_KERNELS)


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
    beam search runs ``wspr_beam`` and its OSD ``osd``, JT65's RS Chase
    ``chase_erasures``, ``rs_ee`` and ``chase_score``, the q-ary demod
    ``qary_sync`` and ``qary_symbols``; none of the three has an LDPC code or runs the GFSK engine,
    so ``bp_minsum``, ``subtract_known``, ``multisym_llrs`` and the sync
    kernels have no launch here."""
    return _replay_phase(dev, workdir, "weak-modes", WEAK_LINES,
                         _weak_plan(), SEED + 5,
                         ("osd",) + WEAK_KERNELS + QARY_KERNELS
                         + QARY_DECODE_KERNELS)


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


class WorkerSkim:
    """The skim's worker code (``skim_worker`` served by ``CardWorkers``,
    the pool that a mesh of several cards takes) in ``n`` worker processes
    on ``dev``, a position of an n-entry mesh each, warmed up on a window
    of ``warm_len`` samples: the pool on one card.  :meth:`step` returns
    the rows merged in position order and keeps the workers' kernel
    launches in that step, summed, in ``launches``; ``start_s`` is the
    pool's start-up (spawn, build, warm-up)."""

    def __init__(self, dev, n: int, fs: int, freqs, spec,
                 warm_len: int) -> None:
        from cwsl_digi_tpu_torch.dsp.channelizer import ChannelizerSpec
        from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
        from cwsl_digi_tpu_torch.parallel.pipeline import (
            build_skim_libraries, skim_worker)
        from cwsl_digi_tpu_torch.parallel.workers import CardWorkers

        if len(freqs) % n:
            raise ValueError(f"{len(freqs)} channels over {n} workers")
        self._bs = ChannelizerSpec(fs, len(freqs)).block_size
        blocks = make_mesh(n, devices=[dev] * n).blocks("ch", len(freqs))
        if torch.device(dev).type == "cuda":
            build_skim_libraries()
        t = time.monotonic()
        self.pool = CardWorkers(
            [dev] * n, skim_worker,
            [(fs, {p: list(freqs[b])}, spec, warm_len // self._bs * self._bs)
             for p, b in enumerate(blocks)])
        self.start_s = time.monotonic() - t
        self.launches: dict[str, int] = {}

    def step(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        res = self.pool.step(np.ascontiguousarray(
            iq[: len(iq) // self._bs * self._bs], np.complex64))
        self.launches = {}
        for r in res:
            for k, n in r["launches"].items():
                self.launches[k] = self.launches.get(k, 0) + n
        rows = [r["rows"][p] for p, r in enumerate(res)]
        return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def batch_split_stages(dev, fs: int, freqs, iq) -> dict[str, list[str]]:
    """Where the decode of the first half of the channels as a batch of
    their own (a 2-entry mesh's position) parts from the whole bank's
    batch (the 1-entry mesh): the outputs that differ in those channels'
    rows, stage by stage, each stage given the same inputs in both
    batches: the channelizer's audio, the spectrograms (the Hann power
    map, the boxcar demod), the power map's row means (``base``), the
    sync search (top_val, t0, f0, tt), the SNR's noise median, and the
    decode's arrays."""
    from cwsl_digi_tpu_torch.dsp.channelizer import (BatchChannelizer,
                                                     ChannelizerSpec)
    from cwsl_digi_tpu_torch.modes import ft8, gfsk_engine

    def differ(names, a, b) -> list[str]:
        return [n for n, x, y in zip(names, a, b)
                if isinstance(x, torch.Tensor)
                and not torch.equal(x[: y.shape[0]], y)]

    half = len(freqs) // 2
    bs = ChannelizerSpec(fs, len(freqs)).block_size
    x = torch.from_numpy(np.ascontiguousarray(
        iq[: len(iq) // bs * bs], np.complex64)).to(dev)
    a_half = BatchChannelizer(fs, freqs[:half], device=dev).process_window(x)
    a_all = BatchChannelizer(fs, freqs, device=dev).process_window(x)
    out = {"audio": differ(["audio"], [a_all], [a_half])}
    a_all = torch.cat([a_half, a_all[half:]])     # the same audio from here
    a_half = a_all[:half]
    dec = ft8.FT8Decoder(device=dev)
    spec, tabs = dec.spec, dec._tabs
    ps, demod, refine = gfsk_engine.spectrograms(spec, a_all, tabs)
    out["spectrograms"] = differ(
        ["power_sync", "demod"], (ps, demod),
        gfsk_engine.spectrograms(spec, a_half, tabs))
    n_hops = (a_all.shape[1] - spec.sps) // spec.hop + 1
    rows = ps[:, spec.pad_hops : spec.pad_hops + n_hops].to(torch.float32)
    base = rows.mean(dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    out["base"] = differ(["base"], [base], [
        rows[:half].mean(dim=(1, 2), keepdim=True) * len(spec.sync_cells)])
    out["sync"] = differ(
        ["top_val", "t0", "f0", "tt"],
        gfsk_engine.sync_candidates(spec, ps, demod, base, n_hops, refine),
        gfsk_engine.sync_candidates(spec, ps[:half], demod[:half],
                                    base[:half], n_hops, refine))
    out["noise_median"] = differ(
        ["noise"], [gfsk_engine._median_rows(rows[:, ::4, ::4])],
        [gfsk_engine._median_rows(rows[:half, ::4, ::4])])
    d_all = dec.decode_arrays_device(a_all)
    d_half = dec.decode_arrays_device(a_half)
    out["decode"] = differ(list(d_half), [d_all[k] for k in d_half],
                           list(d_half.values()))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_phase(dev) -> dict:
    """The parallel layer on ``cuda:0``: the channel-sharded skim of the
    64 FT8 dials on a virtual 4-entry mesh (16 channels a shard) against a
    1-entry mesh; the skim in two worker processes on the card (the
    worker path that drives several cards from one process) against the
    same 2-entry mesh in this process, bit for bit, and the 1-entry mesh
    (the part's launches are the workers', returned by them), and where a
    32-channel batch's decode parts from the 64's; a 900 s
    window at 192 kHz time-sharded 4 ways over 4 channels against one
    device's ``process_window`` and the plain version, its FST4W-900
    burst decoded through ``get_decoder``; the kernel against the plain
    version at the shards' blocks; ``entry()`` once; ``dryrun_multichip``
    on a virtual 4-entry mesh; the skim through a one-rank NCCL process
    group.  Each part's kernel launches are counted from 0 just before it
    and read just after, its comparisons outside."""
    import torch.distributed as dist

    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
    from cwsl_digi_tpu_torch.entry import (dryrun_multichip, entry,
                                           long_window_iq)
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
    from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
    from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer

    launches, walls, errs = {}, {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        _kernels.launches["channelize"] = 0
        LAUNCH_SHAPES.reset_pending()
        t = time.monotonic()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = time.monotonic() - t
        launches[name] = _kernels.launches["channelize"]
        LAUNCH_SHAPES.commit()
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

    # --- the skim's worker code: two worker processes on cuda:0, 32
    # channels each, every array bit for bit the same 2-entry mesh's in
    # this process, the decodes those of the 1-entry mesh
    stepw = WorkerSkim(dev, 2, FS, freqs, ft8.SPEC, len(iq))
    try:
        run("skim_2_workers_first", lambda: stepw.step(iq))
        outw = run("skim_2_workers", lambda: stepw.step(iq))
    finally:
        stepw.pool.close()
    step2 = ShardedSkimStep(FS, freqs, make_mesh(2, devices=[dev] * 2))
    before = _launch_totals()
    out2 = step2.step(iq)
    torch.cuda.synchronize()
    after = _launch_totals()
    in_process = {k: after[k] - before[k] for k in after
                  if after[k] > before[k]}
    print(f"parallel skim_2_workers: start-up {stepw.start_s:.3f} s (spawn, "
          f"build, warm-up); the part's kernel launches are the workers': "
          f"{stepw.launches}")
    differ = [k for k in out2 if not np.array_equal(outw[k], out2[k])]
    if differ:
        raise AssertionError(f"2-worker skim differs from the same mesh in "
                             f"this process in {differ}")
    if skim_decodes(step2, outw) != want or not same_decodes(outw, out1):
        raise AssertionError("2-worker skim disagrees with the 1-entry mesh")
    if {k: n for k, n in stepw.launches.items() if n} != in_process \
            or in_process["channelize"] != 2:
        raise AssertionError(f"workers' launches {stepw.launches}, "
                             f"in this process {in_process}")
    split = batch_split_stages(dev, FS, freqs, iq)
    print("skim_2_workers: every array bit for bit the 2-entry mesh's in "
          "this process; valid/payload equal to the 1-entry mesh's, bitwise "
          f"{all(np.array_equal(outw[k], out1[k]) for k in out1)} (differ: "
          f"{[k for k in out1 if not np.array_equal(outw[k], out1[k])]}); "
          f"a 32-channel batch against the 64's, arrays that differ: {split}")
    worker_part = {"wall_s": walls["skim_2_workers"],
                   "first_wall_s": walls["skim_2_workers_first"],
                   "start_s": stepw.start_s,
                   "worker_launches": stepw.launches,
                   "batch_split_differ": split}

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
                     "skim_2_workers_first": 0, "skim_2_workers": 0,
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
            "errs": errs, "shard_launch": shard_ms,
            "skim_2_workers": worker_part}


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
    _require_launches("live soak", counts, GFSK_PATH_KERNELS)
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
    _require_launches("bench", counts, ALL_KERNELS)
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
    from cwsl_digi_tpu_torch.modes import _chase_kernels as chase_kernels
    from cwsl_digi_tpu_torch.modes import _gfsk_kernels as gfsk_kernels
    from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels
    from cwsl_digi_tpu_torch.modes import _median_kernels as median_kernels
    from cwsl_digi_tpu_torch.modes import _qary_kernels as qary_kernels
    from cwsl_digi_tpu_torch.modes import _sync_kernels as sync_kernels
    from cwsl_digi_tpu_torch.modes import _weak_kernels as weak_kernels

    dev = cuda_device()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    build_libraries({"channelizer": _kernels, "ldpc": ldpc_kernels,
                     "gfsk": gfsk_kernels, "sync": sync_kernels,
                     "weak": weak_kernels, "qary": qary_kernels,
                     "median": median_kernels, "chase": chase_kernels})

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
    LAUNCH_SHAPES.install()
    LAUNCH_SHAPES.timed = "channelize"       # the 64-channel chunk's shape
    kmain = phase("kernel_64ch", kernel_phase, dev,
                  np.asarray(dials, np.float64) - LO)
    LAUNCH_SHAPES.timed = None
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
    kweak_modes = phase("weak_kernels", weak_kernels_phase, dev)
    torch.cuda.empty_cache()
    kqary = phase("qary_kernels", qary_kernels_phase, dev)
    torch.cuda.empty_cache()
    kdecode = phase("qary_decode_kernels", qary_decode_kernels_phase, dev)
    torch.cuda.empty_cache()
    # the launches the kernels line prices, by shape: the App phases and
    # (the channelizer's) the parallel phase
    LAUNCH_SHAPES.on = True
    with tempfile.TemporaryDirectory() as tmp:
        mstats = phase("ft8_64ch_app", main_path_phase, dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        xstats = phase("mixed_mode_app", mixed_mode_phase, dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        wstats = phase("weak_modes_app", weak_modes_phase, dev, Path(tmp))
    LAUNCH_SHAPES.on = False
    lstats = phase("long_periods", long_period_phase, dev)
    dstats = phase("decode_walls", decode_walls_phase, dev)
    LAUNCH_SHAPES.on = {"channelize"}
    pstats = phase("parallel", parallel_phase, dev)
    # the soak and the bench run on the unwrapped functions
    LAUNCH_SHAPES.uninstall()
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
    print(json.dumps({"weak_kernels": kweak_modes}))
    print(json.dumps({"qary_kernels": {k: v for k, v in kqary.items()
                                       if k != "checks"}}))
    print(json.dumps({"qary_decode_kernels": {
        k: v for k, v in kdecode.items() if k != "checks"}}))
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
    timed = {"channelize": kmain}
    hand = [(name, replaces, kldpc, "ldpc.cu")
            for name, replaces in LDPC_REPLACES.items()]
    hand += [(name, replaces, kgfsk, "gfsk.cu")
             for name, replaces in GFSK_REPLACES.items()]
    hand += [(name, replaces, ksync, "sync.cu")
             for name, replaces in SYNC_REPLACES.items()]
    hand += [(name, replaces, kweak_modes, "weak.cu")
             for name, replaces in WEAK_REPLACES.items()]
    hand += [(name, replaces, kqary, QARY_SOURCES[name])
             for name, replaces in QARY_REPLACES.items()]
    hand += [(name, replaces, kdecode, QARY_DECODE_SOURCES[name])
             for name, replaces in QARY_DECODE_REPLACES.items()]
    for name, _, kphase, _ in hand:
        timed[name] = kphase["kernels"][name]
    priced = phase("launch_shapes", LAUNCH_SHAPES.price, timed)
    # the launches recorded by shape: the App phases' (and the parallel
    # phase's channelizer launches)
    recorded = {"channelize": (mstats["launches"] + xstats["launches"]
                               + wstats["launches"] + pstats["launches"])}
    for name, replaces, kphase, src in hand:
        k = kphase["kernels"][name]
        by_phase = {ph: st["kernel_launches"][name]
                    for ph, st in app_phases.items()}
        recorded[name] = sum(by_phase[ph] for ph in (
            "ft8_64ch_app", "mixed_mode_app", "weak_modes_app"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cwsl_digi_tpu_torch/modes/csrc/{src}",
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for k in kernels:
        p = priced.get(k["name"], {"launches": 0, "shapes": 0,
                                   "gap_ms": 0.0})
        if p["launches"] != recorded[k["name"]]:
            raise AssertionError(f"{k['name']}: {p['launches']} launches "
                                 f"recorded by shape, "
                                 f"{recorded[k['name']]} counted in the "
                                 "recorded phases")
        # launches x (ms - bound), each launch at its own shape
        k["launch_gap_ms"] = p["gap_ms"]
        k["launches_priced"] = p["launches"]
        k["launch_shapes"] = p["shapes"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
