"""Headline benchmark of the PyTorch/CUDA port: real-time FT8 channels per card.

    python3 bench_cuda.py

Counterpart of ``bench.py`` for ``cwsl_digi_tpu_torch`` on one NVIDIA GPU.
It prints ONE JSON line on stdout (progress goes to stderr)::

    {"metric": "ft8_realtime_channels_per_chip", "value": N,
     "unit": "channels", "vs_baseline": x, "device": {...}, "detail": {...}}

``value`` is ``int(15 / (t_chan * 15 + t_dec))``: a channel costs, each
15 s period, 15 s of channelizing and the decode of one window.

  - ``t_chan``: host wall of ``BatchChannelizer.process`` per
    channel-second, at 256 channels and 192 kHz on one second of host IQ
    (its upload included), through the hand-written CUDA kernel; the
    kernel's own device time is reported beside it.
  - ``t_dec``: the median wall per window of ``FT8Decoder.decode`` on busy
    windows (6 signals at -20 to -5 dB) at the decoder's device batch,
    device-fed, over 3 runs; a decoded message that was never injected
    fails the bench.

``vs_baseline`` is against 512 channels, the limit PERF.md section 2 sets
(8 receivers of 64 FT8 dials).  The detail also carries the FT8 recall at
-18 to -22 dB, the decode wall per window of every mode of the reference's
72-line config and the mixed-mode capacity over that mix, the q-ary modes'
host share, each section's wall and peak device memory, and the kernel
libraries' load or build time (the channelizer's and the LDPC kernels').

Every section runs in this one process (``tools/torch_bench_sections.py``).
A section that raises or returns nothing ends the run with a non-zero exit
and its name on stderr, and no metric line; nothing is substituted.
``--device`` picks the card (default ``cuda:0``); without a CUDA device it
raises "no CUDA device" and exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

# PERF.md section 2: 8 receivers x 64 FT8 dials
BASELINE_CHANNELS = 512
FT8_T_R = 15.0

# the reference's shipped config.ini demonstrates 72 decoder lines across
# 14 bands (reference config.ini:45-145); the mixed-mode capacity uses
# exactly that distribution (bench.py:77-82)
TEMPLATE_MIX = {
    "FT8": 18, "WSPR": 11, "FT4": 10, "JT65": 9, "JS8": 6,
    "FST4W-120": 3, "FST4-60": 3, "FST4-120": 3, "FST4W-300": 2,
    "FST4-300": 2, "Q65-30": 1, "FST4W-900": 1, "FST4W-1800": 1,
    "FST4-900": 1, "FST4-1800": 1,
}
QARY_MODES = ("JT65", "Q65-30")


class SectionFailed(RuntimeError):
    """A bench section raised or returned nothing."""


def realtime_channels(t_chan: float, t_dec: float,
                      t_r: float = FT8_T_R) -> int:
    """Channels one card keeps in real time: each T/R period a channel
    costs ``t_r`` seconds of channelizing and one window's decode."""
    return int(t_r / (t_chan * t_r + t_dec))


def _mixed_mode_channels(t_chan: float, s_per_window: dict) -> int:
    """Real-time channels per card for the template mix.

    A mode-m channel costs ``t_chan`` seconds per second of audio plus
    ``C_m / T_m`` decode seconds per second; the capacity is the N at which
    the weighted mix fills one card-second per second.  Every mode of the
    mix needs its own measurement: a missing one raises, naming it."""
    from cwsl_digi_tpu_torch.constants import get_rx_period

    missing = [m for m in TEMPLATE_MIX if s_per_window.get(m) is None]
    if missing:
        raise ValueError(f"no decode measurement for {', '.join(missing)}")
    total_lines = sum(TEMPLATE_MIX.values())
    rate = sum(n_lines / total_lines
               * (s_per_window[mode] / get_rx_period(mode) + t_chan)
               for mode, n_lines in TEMPLATE_MIX.items())
    return int(1.0 / rate)


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them, the
    number of cards and the torch and CUDA versions."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, power = (s.strip() for s in out.stdout.strip().split(",", 1))
    return {"name": name, "power_limit": power,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def load_kernels() -> float:
    """Load (or build with nvcc) the kernel libraries, the channelizer's
    and the LDPC kernels'; seconds taken."""
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.modes import _kernels as ldpc_kernels

    t0 = time.perf_counter()
    _kernels.load_library()
    ldpc_kernels.load_library()
    return time.perf_counter() - t0


def run_sections(dev: torch.device) -> dict:
    """Every section in order on ``dev``: {section name: result}.  Raises
    SectionFailed naming the first section that raised or returned
    nothing."""
    import torch_bench_sections as sections

    steps = [("channelizer", sections.section_channelizer, ()),
             ("decode_production", sections.section_decode_production, ()),
             ("recall", sections.section_recall, ())]
    steps += [(f"mode_decode:{m}", sections.section_mode_decode, (m,))
              for m in TEMPLATE_MIX if m != "FT8"]
    steps += [(f"qary_host_fraction:{m}",
               sections.section_qary_host_fraction, (m,))
              for m in QARY_MODES]
    out = {}
    for name, fn, args in steps:
        print(f"# section {name}", file=sys.stderr, flush=True)
        try:
            r = fn(*args, device=dev)
        except Exception as e:
            raise SectionFailed(f"section {name} failed: {e!r}") from e
        if not r:
            raise SectionFailed(f"section {name} returned nothing")
        print(f"# section {name}: {r['wall_s']:.1f} s", file=sys.stderr,
              flush=True)
        out[name] = r
    return out


def metric_line(res: dict, device: dict, library_s: float) -> dict:
    """The bench's JSON line from the sections' results."""
    chan, prod, curve = (res["channelizer"], res["decode_production"],
                         res["recall"])
    t_chan, t_dec = chan["s_per_channel_second"], prod["s_per_window"]
    modes = {k.split(":", 1)[1]: r for k, r in res.items()
             if k.startswith("mode_decode:")}
    s_per_window = {"FT8": t_dec}
    s_per_window.update({m: r["s_per_window"] for m, r in modes.items()})
    channels = realtime_channels(t_chan, t_dec)
    return {
        "metric": "ft8_realtime_channels_per_chip",
        "value": channels,
        "unit": "channels",
        "vs_baseline": channels / BASELINE_CHANNELS,
        "device": device,
        "detail": {
            "channelizer_s_per_channel_second": t_chan,
            "channelizer_device_s_per_channel_second":
                chan["device_s_per_channel_second"],
            "channelizer_device_ms_per_second_of_iq": chan["device_ms"],
            "channelizer_device_bound_ms": chan["device_bound_ms"],
            "channelizer_backend": chan["backend"],
            "decode_s_per_window_production": t_dec,
            "decode_s_per_window_hostfed": prod["s_per_window_hostfed"],
            "decode_production_runs": prod["runs_s_per_window"],
            "decode_batch": prod["batch"],
            "decodes_per_window": prod["decodes_per_window"],
            "busy_found_share": prod["found_share"],
            "busy_false_messages": prod["false_messages"],
            "decode_lock_wait_s": prod["lock_wait_s"],
            "ft8_recall_curve": curve["recall"],
            "ft8_recall_trials": curve["trials"],
            "ft8_threshold_db": curve["threshold_db"],
            "ft8_false_per_noise_window": curve["false_per_noise_window"],
            "mode_decode_s_per_window": s_per_window,
            "mode_decode_batch": {m: r["batch"] for m, r in modes.items()},
            "mode_decode_found_share": {m: r["found_share"]
                                        for m, r in modes.items()},
            # template mix = the reference's shipped 72-line config
            # (config.ini:45-145), every mode measured
            "mixed_mode_channels_per_chip": _mixed_mode_channels(
                t_chan, s_per_window),
            "qary_host_fraction": {
                m: res[f"qary_host_fraction:{m}"]["host_fraction"]
                for m in QARY_MODES},
            "kernel_library_load_s": library_s,
            "section_walls_s": {k: r["wall_s"] for k, r in res.items()},
            "peak_device_bytes": {k: r["peak_device_bytes"]
                                  for k, r in res.items()},
        },
    }


def main(argv: list[str] | None = None) -> int:
    import torch_parity

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="the card to measure (default cuda:0)")
    args = ap.parse_args(argv)
    dev = torch_parity.tool_device(args.device)    # "no CUDA device"
    if dev.type != "cuda":
        raise ValueError(f"the bench measures a CUDA device, not {dev}")
    device = device_info(dev)
    library_s = load_kernels()
    try:
        res = run_sections(dev)
    except SectionFailed as e:
        traceback.print_exc()
        print(f"bench failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(metric_line(res, device, library_s)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
