"""Stage breakdown of the port's FT8 decode on one GPU.

    python3 tools/torch_decode_profile.py

Decodes a seeded batch of busy FT8 windows (``WINDOWS`` windows of
``SIGNALS`` signals each) with the port's FT8Decoder at full SPEC (AP
from an operator call, decodedepth 3) on ``cuda:0`` and prints

- the median wall of a whole decode (3 runs after a warm-up),
- the time inside each labelled stage, measured in a separate run with a
  device synchronize around every stage call (so stages do not overlap;
  the sum is at least the plain wall), and
- the device's busy share during one decode under ``torch.profiler``, with
  the kernels that take the most device time.

Stages are labelled by wrapping the engine's stage functions in this
process only; the decoder's code is unchanged.  Without CUDA it exits 1.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    from cwsl_digi_tpu_torch.modes import gfsk_engine, ldpc
    from cwsl_digi_tpu_torch.modes.ft8 import FT8Decoder

    dev = torch.device("cuda", 0)
    dec = FT8Decoder(my_call="W2AXR", depth=3, device=dev)
    audio = torch.from_numpy(_windows(WINDOWS, SIGNALS, 7)).to(dev)
    res = dec.decode(audio)                   # warm-up
    n_dec = sum(len(r) for r in res)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode(audio)
        walls.append(time.perf_counter() - t0)
    print(f"decode {WINDOWS} windows x {SIGNALS} signals: "
          f"{n_dec} decodes, wall median {statistics.median(walls):.3f} s "
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

    stages = [("_bf16_matmul", "spectrogram matmuls"),
              ("_shifted_sum", "sync accumulation (coarse+fine)"),
              ("_top_k", "top-K sorts (candidates, OSD pick)"),
              ("_multisym_llrs", "coherent LLRs"),
              ("osd_decode", "OSD"),
              ("subtract_known", "subtraction"),
              ("select_subtract_params", "subtraction pick"),
              ("_median_rows", "SNR median"),
              ("_pack_outputs", "output pack")]
    originals = {name: getattr(gfsk_engine, name) for name, _ in stages}
    bp_original = ldpc.BPDecoder.decode_full
    for name, label in stages:
        setattr(gfsk_engine, name, timed(label, originals[name]))
    ldpc.BPDecoder.decode_full = timed("BP (min-sum)", bp_original)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.decode(audio)
    total = time.perf_counter() - t0
    print(f"instrumented decode wall {total:.3f} s; stages:")
    for label, s in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"  {label:34s} {s * 1e3:9.1f} ms  ({calls[label]} calls, "
              f"{100 * s / total:5.1f} %)")
    rest = total - sum(spent.values())
    print(f"  {'other (gather, glue, host)':34s} {rest * 1e3:9.1f} ms  "
          f"({100 * rest / total:5.1f} %)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")

    # last, on the unwrapped stages: on the H100 a decode timed after a
    # profiler session ran ~1.6x slower than one timed before it
    for name, fn in originals.items():
        setattr(gfsk_engine, name, fn)
    ldpc.BPDecoder.decode_full = bp_original
    device_busy(dec, audio, statistics.median(walls))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
