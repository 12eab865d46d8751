"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, and fails without CUDA;
2. builds the hand-written channelizer kernel from ``cwsl_digi_tpu_torch``;
3. holds the kernel against its plain PyTorch version on the card, at the
   main path's 64 dials and at the bench's 256 channels (192 kHz, 15 s of
   seeded IQ in the receiver's 0.25 s chunks, plus one whole-window call),
   and times one chunk in turns through the kernel, the plain version and
   one library call (a cuBLAS complex GEMM of the same taps and IQ), beside
   the bound of the function's arithmetic; the ``kernels`` line gives the
   main path's 64-channel numbers, the line before it the 256-channel ones;
4. runs the port's App on a seeded 192 kHz file replay with 64 FT8
   decoder lines across the band and known bursts in 17 of them (SNR 0 to
   -18 dB, a crowded channel of 9 overlapping signals, an AP-covered CQ);
   every expected spot must appear within 2 Hz and no other, through the
   kernel, with CUDA tensors reaching the decoder;
5. prints a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Any failed phase raises; nothing is caught.
"""

from __future__ import annotations

import json
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
# FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
SPOT_TOL_HZ = 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    n_bytes = (iq_ext.numel() * 8 + kern._taps_packed.numel() * 2
               + kern._coarse.numel() * 8 + rot_k.numel() * 8
               + n_ch * n_out * 4)
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    fn_flop = 4 * n_ch * fo * n_out
    ops_ms = 3 * fn_flop / BF16_FLOPS * 1e3
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


def main_path_phase(dev, workdir: Path) -> dict:
    """The port's App end to end on a 64-channel FT8 replay."""
    from cwsl_digi_tpu_torch.config import load_config
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.runtime.app import App

    dials, bursts = _plan()
    iq_path = workdir / "band.npy"
    expected = _write_replay(iq_path, dials, bursts)
    ini = workdir / "smoke.ini"
    ini.write_text("\n".join(
        ["[radio]", f"source=file:{iq_path}?sr={FS}&lo={LO}",
         "[operator]", "callsign=W2AXR", "gridsquare=FN13",
         "[decoders]"] + [f"decoder={d} FT8" for d in dials]
        + ["[logging]", "loglevel=2", "logimmediately=true"]) + "\n")
    app = App(load_config(ini), max_runtime_s=600, device=dev)
    spots = []
    devices = []
    orig_handle, orig_push = app.spots.handle, app.pool.push

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s:
            spots.append(s)
        return s

    def push(job):
        devices.append(job.audio.device.type)
        orig_push(job)

    app.spots.handle = capture
    app.pool.push = push

    # App.run warms the decoder up (one strong window through every pass)
    # before it starts the receiver
    _kernels.launches["channelize"] = 0
    t0 = time.monotonic()
    runner = threading.Thread(target=app.run, daemon=True)
    runner.start()
    deadline = time.monotonic() + 240
    while app.pool.count_decoded_windows < len(dials) \
            and time.monotonic() < deadline and runner.is_alive():
        time.sleep(0.2)
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = _kernels.launches["channelize"]
    app._terminate = True
    runner.join(timeout=60)
    if runner.is_alive():
        raise RuntimeError("app did not shut down")
    rx_stage = [rx.stage for rx in app.receivers.values()]
    decode_s = [e["decode_s"] for e in app.pool.stage_log]
    print(f"main path: {len(dials)} FT8 channels, warmup+replay+decode "
          f"{run_s:.1f} s, decode batches {decode_s} s, "
          f"windows decoded {app.pool.count_decoded_windows}")
    if rx_stage:
        print(f"channelize host wall {rx_stage[0]['channelize_wall_s']:.3f} s"
              f" for {rx_stage[0]['channelized_audio_s']:.2f} s of audio")

    got = [(s.callsign, s.freq_hz) for s in spots]
    for s in sorted(spots, key=lambda s: s.freq_hz):
        print(f"  spot {s.freq_hz} {s.snr_db:+d} dB {s.dt_s:+.2f} s "
              f"{s.message}")
    missing = [e for e in expected if not any(
        c == e[0] and abs(f - e[1]) <= SPOT_TOL_HZ for c, f in got)]
    extra = [g for g in got if not any(
        c == g[0] and abs(f - g[1]) <= SPOT_TOL_HZ for c, f in expected)]
    print(f"spots: {len(got)} found, {len(expected)} expected, "
          f"missing {missing}, extra {extra}")
    if app.pool.count_decoded_windows != len(dials):
        raise AssertionError("not every channel's window was decoded")
    if missing or extra:
        raise AssertionError("decoded spots differ from the injected bursts")
    if launches <= 0:
        raise AssertionError("main path did not launch the channelizer kernel")
    if not devices or any(d != "cuda" for d in devices):
        raise AssertionError(f"decoder got non-CUDA audio: {devices}")
    return {"launches": launches, "decode_s": decode_s, "run_s": run_s}


def main() -> int:
    print(card_line())
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import cwsl_digi_tpu_torch  # noqa: F401  (fails outside the repo)
    from cwsl_digi_tpu_torch.device import cuda_device
    from cwsl_digi_tpu_torch.dsp import _kernels

    dev = cuda_device()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    t0 = time.monotonic()
    _kernels.load_library()
    print(f"build: channelizer library in {time.monotonic() - t0:.1f} s")
    print(_kernels.build_log.strip())

    # the main path's shape (its 64 dials), then the bench's 256 channels
    dials, _ = _plan()
    kmain = kernel_phase(dev, np.asarray(dials, np.float64) - LO)
    kwide = kernel_phase(dev, np.linspace(-FS / 2, FS / 2 - 6000, 256))
    with tempfile.TemporaryDirectory() as tmp:
        mstats = main_path_phase(dev, Path(tmp))
    print(json.dumps({"channelize_256ch": kwide}))
    print(json.dumps({"kernels": [{
        "name": "channelize",
        "route": "cuda",
        "source": "cwsl_digi_tpu_torch/dsp/csrc/channelizer.cu",
        "replaces": "cwsl_digi_tpu/dsp/pallas_channelizer.py:61",
        "launches": mstats["launches"],
        "max_abs_err": max(kmain["max_abs_err"], kwide["max_abs_err"]),
        "ms": kmain["ms"],
        "plain_ms": kmain["plain_ms"],
        "bound_ms": kmain["bound_ms"],
        "bound_by": kmain["bound_by"],
        "library_ms": kmain["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
