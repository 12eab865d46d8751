"""Stage breakdown of the port's decodes on one GPU.

    python3 tools/torch_decode_profile.py [FT8|WSPR|JT65|Q65-30 ...]

For each mode named (default FT8) it decodes a seeded batch of
``WINDOWS`` windows on ``cuda:0``: busy FT8 windows (``SIGNALS`` signals
each) with the FT8Decoder at full SPEC (AP from an operator call,
decodedepth 3); WSPR windows with two bursts 80 Hz apart; JT65 windows
with two bursts and Q65-30 windows with one, at the App's
``highestdecodefreq`` of 3000 Hz (JT65 on its rfft branch).  It prints

- the median wall of a whole decode (3 runs after a warm-up),
- the time inside each labelled stage, measured in a separate run with a
  device synchronize around every stage call (so stages do not overlap;
  the sum is at least the plain wall), and
- the device's busy share during one decode under ``torch.profiler``, with
  the kernels that take the most device time.

Stages are labelled by wrapping the decoders' stage functions in this
process only; the decoders' code is unchanged.  A stage marked "(in ...)"
runs inside another labelled stage, whose time includes it.  Without CUDA
it exits 1.
"""

from __future__ import annotations

import collections
import functools
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WINDOWS = 64     # one 192 kHz receiver's FT8 dials
SIGNALS = 6      # signals per window: a busy band


def _windows(n: int, n_sig: int, seed: int) -> np.ndarray:
    from cwsl_digi_tpu_torch.modes import ft8

    rng = np.random.default_rng(seed)
    calls = ["K1ABC", "W9XYZ", "G4ABC", "DL7ACA", "VE3XYZ", "JA1XYZ",
             "F5ABC", "PY2ABC", "ZL1ABC", "OH2ABC"]
    out = np.zeros((n, 180_000), np.float32)
    for w in range(n):
        for j in range(n_sig):
            a, b = rng.choice(calls, 2, replace=False)
            text = f"{a} {b} -{rng.integers(1, 25):02d}"
            f0 = 250.0 + 2600.0 * (j + rng.random() * 0.8) / n_sig
            amp = 10 ** (rng.uniform(-1.2, 0.0))
            out[w] += amp * ft8.synthesize(text, f0,
                                           start_s=rng.uniform(0.0, 1.5))
        out[w] += 0.15 * rng.standard_normal(180_000).astype(np.float32)
    return out


def device_busy(dec, audio: torch.Tensor, plain_wall: float) -> None:
    """One decode under torch.profiler: the device's busy share (union of
    its kernel and copy intervals over the decode's wall) and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("device busy share: not measured (the profiler recorded no "
              "device events)")
        return
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e6
    # the profiler slows the host, so its wall overstates the idle share;
    # the busy time over the unprofiled wall bounds it from the other side
    print(f"profiled decode wall {wall:.3f} s: {len(spans)} device events, "
          f"device busy {busy:.3f} s = {100 * busy / wall:.1f} % of the "
          f"profiled wall, {100 * busy / plain_wall:.1f} % of the "
          f"unprofiled median wall {plain_wall:.3f} s")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=60))


def _weak_windows(mode: str, n: int, seed: int) -> np.ndarray:
    """``n`` seeded windows of WSPR (two bursts 80 Hz apart), JT65 (two
    bursts) or Q65-30 (one burst), -20 to -12 dB each."""
    from cwsl_digi_tpu_torch.modes import jt65, q65, wspr
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    rng = np.random.default_rng(seed)
    if mode == "WSPR":
        clean = (wspr.synthesize("K1ABC", "FN42", 37, 1460.0)
                 + wspr.synthesize("W2AXR", "FN13", 30, 1540.0))
    elif mode == "JT65":
        clean = (jt65.synthesize("K1ABC W9XYZ EN37", 1270.0)
                 + jt65.synthesize("CQ W2AXR FN13", 2100.0, start_s=1.5))
    else:
        clean = q65.synthesize("CQ W2AXR FN13", 1200.0)
    return np.stack([add_noise_at_snr(clean, rng.uniform(-20, -12), 12_000,
                                      rng) for _ in range(n)]
                    ).astype(np.float32)


def _setup(mode: str, dev):
    """(decoder, device audio, [(owner, attribute, label)]) of one mode."""
    from cwsl_digi_tpu_torch.modes import (gfsk_engine, ldpc, qary_engine,
                                           qra, rs_device, wspr)
    from cwsl_digi_tpu_torch.modes.base import get_decoder

    if mode == "FT8":
        from cwsl_digi_tpu_torch.modes.ft8 import FT8Decoder

        dec = FT8Decoder(my_call="W2AXR", depth=3, device=dev)
        audio = _windows(WINDOWS, SIGNALS, 7)
        stages = [(gfsk_engine, name, label) for name, label in [
            ("_bf16_matmul", "spectrogram matmuls"),
            ("sync_candidates", "sync search (score, NMS, top-K, refine)"),
            ("_top_k", "top-K sorts (OSD and subtraction picks)"),
            ("candidate_llrs", "gather + coherent LLRs"),
            ("osd_decode", "OSD"),
            ("subtract_known", "subtraction"),
            ("select_subtract_params", "subtraction pick"),
            ("_median_rows", "SNR median"),
            ("_pack_outputs", "output pack")]]
        stages.append((ldpc.BPDecoder, "decode_full", "BP (min-sum)"))
        return dec, audio, stages
    audio = _weak_windows(mode, WINDOWS, 7)
    if mode == "WSPR":
        dec = get_decoder(mode, device=dev)
        stages = [
            (wspr.WSPRDecoder, "decode_arrays", "device program"),
            (torch.fft, "rfft", "spectrogram rffts (in device program)"),
            (wspr, "_beam_decode", "beam search, all passes (in device "
             "program)"),
            (wspr, "osd_decode", "OSD (in device program)"),
            (wspr, "_median_rows", "SNR median (in device program)")]
        return dec, audio, stages
    dec = get_decoder(mode, device=dev, fmax_hz=3000.0)
    stages = [(qary_engine, "qary_decode_program", "demod"),
              (qary_engine, "_qary_sync", "sync correlation + top-K (in "
               "demod)"),
              (qary_engine, "_symbol_energies", "tone gather + top-4 (in "
               "demod)")]
    if mode == "JT65":
        stages += [(qary_engine, "_median_rows", "SNR median (in demod)"),
                   (qary_engine, "rs_chase_program", "RS Chase"),
                   (rs_device, "chase_erasures",
                    "erasure patterns (in RS Chase)"),
                   (rs_device, "rs_ee_trials", "RS decode (in RS Chase)"),
                   (rs_device, "chase_score",
                    "soft score + best trial (in RS Chase)"),
                   (torch.fft, "rfft", "spectrogram rffts (in demod)")]
    else:
        stages += [(qary_engine, "_median_rows",
                    "medians (in demod and priors)"),
                   (qary_engine, "_mp_priors", "priors"),
                   (qra.QaryMPDecoder, "decode", "message passing"),
                   (qary_engine, "_mp_score_pack", "score + pack"),
                   (qary_engine, "_bf16_matmul",
                    "spectrogram matmul (in demod)")]
    return dec, audio, stages


def profile_mode(mode: str, dev) -> None:
    dec, audio_np, stages = _setup(mode, dev)
    audio = torch.from_numpy(audio_np).to(dev)
    res = dec.decode(audio)                   # warm-up
    n_dec = sum(len(r) for r in res)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode(audio)
        walls.append(time.perf_counter() - t0)
    print(f"{mode}: decode {len(audio)} windows: {n_dec} decodes, wall "
          f"median {statistics.median(walls):.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in walls)})")

    spent = collections.defaultdict(float)
    calls = collections.Counter()

    def timed(label, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t0
            calls[label] += 1
            return out
        return wrapper

    originals = [(owner, name, getattr(owner, name))
                 for owner, name, _ in stages]
    for owner, name, label in stages:
        setattr(owner, name, timed(label, getattr(owner, name)))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        dec.decode(audio)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    total = time.perf_counter() - t0
    print(f"instrumented decode wall {total:.3f} s; stages:")
    for label, s in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"  {label:46s} {s * 1e3:9.1f} ms  ({calls[label]} calls, "
              f"{100 * s / total:5.1f} %)")
    rest = total - sum(s for label, s in spent.items() if "(in " not in label)
    print(f"  {'other (gather, glue, host)':46s} {rest * 1e3:9.1f} ms  "
          f"({100 * rest / total:5.1f} %)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    # last, on the unwrapped stages: on the H100 a decode timed after a
    # profiler session ran ~1.6x slower than one timed before it
    device_busy(dec, audio, statistics.median(walls))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    for mode in argv or ["FT8"]:
        profile_mode(mode, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
