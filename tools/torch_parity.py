"""Decode-parity harness of the PyTorch/CUDA port: recall vs SNR per mode.

Counterpart of ``tools/parity.py`` on the port's own modules
(``cwsl_digi_tpu_torch``): randomized protocol-exact signals (random
standard messages, random in-band frequency, random time offset) at each
mode's SNR grid, decoded through ``get_decoder(mode, device=...)``, plus

  - false decodes on pure-noise windows (the reference chain's acceptance
    discipline: zero);
  - crowded-band recall: 18 FT8 signals a window over one noise floor
    (the multi-pass subtraction path, jt9 -d3 analogue);
  - ``--check-fixtures``: each committed ``tests/fixtures/*.wav`` decoded
    through the port, hit or miss.

The per-SNR progress lines keep ``tools/parity.py``'s format, so
``tools/parity_logparse.py`` rebuilds a report from a log of this tool.

Usage (the card by default; ``--device cpu`` to rehearse at a tiny size)::

    python tools/torch_parity.py --quick              # all 15 modes, 8 trials
    python tools/torch_parity.py --modes FT8 WSPR --trials 25
    python tools/torch_parity.py --check-fixtures
    python tools/torch_parity.py --quick --modes FT8 --no-crowded \\
        --device cpu --trials 2

Output JSON (``--out``, default ``chiprun_out/torch_parity.json``) has the
shape of ``PARITY_REPORT.json`` (the JAX package's run on a TPU), with the
card's name and power limit and each mode's peak device memory.
"""

from __future__ import annotations

import argparse
import json
import string
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FIXTURE_DIR = REPO / "tests" / "fixtures"

# Per-mode sweep configuration: SNR grid (2.5 kHz ref), f0 range the
# decoder actually searches, realistic dt jitter range (seconds).
SWEEPS: dict[str, dict] = {
    "FT8": dict(snrs=(-10, -15, -17, -18, -19, -20, -21, -22),
                f0=(400.0, 2700.0), dt=(0.1, 1.0)),
    "FT4": dict(snrs=(-10, -14, -15, -16, -17, -18),
                f0=(400.0, 2700.0), dt=(0.2, 0.8)),
    "WSPR": dict(snrs=(-20, -24, -26, -28, -29, -30, -31),
                 f0=(1420.0, 1580.0), dt=(0.5, 2.0)),
    "JT65": dict(snrs=(-18, -20, -21, -22, -23, -24),
                 f0=(700.0, 1800.0), dt=(0.5, 1.5)),
    "Q65-30": dict(snrs=(-18, -21, -23, -24, -25, -26),
                   f0=(700.0, 1800.0), dt=(0.3, 1.0)),
    # FST4 search band follows the reference's jt9 invocation: 900-1100 Hz
    # for 60/120 s, 700-1100 for 300 s (source/DecoderPool.hpp:490-534);
    # FST4W fixed 1400-1600 Hz (:536-567).  The long periods cap their
    # trial counts (max_trials): a 1800 s window is 21.6 M samples, and
    # the binomial noise floor matters less than proving the row decodes
    # (every row of the reference's jt9 invocation matrix,
    # DecoderPool.hpp:631-659, appears here).  Expected thresholds scale
    # as 10*log10(period) from FST4-60 (constant Eb/N0: tone spacing and
    # baud shrink together).
    "FST4-60": dict(snrs=(-18, -21, -23, -24, -25),
                    f0=(910.0, 1090.0), dt=(0.5, 1.5)),
    "FST4-120": dict(snrs=(-23, -25, -26, -27, -28, -29),
                     f0=(910.0, 1090.0), dt=(0.5, 1.5), max_trials=50),
    "FST4-300": dict(snrs=(-28, -30, -32, -33, -34),
                     f0=(710.0, 1090.0), dt=(0.5, 1.5), max_trials=24),
    "FST4-900": dict(snrs=(-33, -35, -37, -38, -39),
                     f0=(910.0, 1090.0), dt=(0.5, 1.5), max_trials=24),
    "FST4-1800": dict(snrs=(-36, -38, -40, -41, -42),
                      f0=(910.0, 1090.0), dt=(0.5, 1.5), max_trials=24),
    "FST4W-120": dict(snrs=(-24, -27, -29, -30, -31, -32),
                      f0=(1430.0, 1570.0), dt=(0.5, 1.5)),
    "FST4W-300": dict(snrs=(-28, -30, -32, -33, -34),
                      f0=(1430.0, 1570.0), dt=(0.5, 1.5), max_trials=24),
    "FST4W-900": dict(snrs=(-33, -35, -37, -38, -39),
                      f0=(1430.0, 1570.0), dt=(0.5, 1.5), max_trials=24),
    "FST4W-1800": dict(snrs=(-36, -38, -40, -41, -42),
                       f0=(1430.0, 1570.0), dt=(0.5, 1.5), max_trials=24),
    "JS8": dict(snrs=(-12, -16, -18, -20, -21),
                f0=(600.0, 2400.0), dt=(0.2, 0.8)),
}

# at most this many samples go to one decode() call: a 1800 s window is
# 21.6 M samples, and holding 24 of them device-resident beside the decode
# temporaries overflows device memory (the subtraction pass keeps original
# + residual)
GROUP_SAMPLES = 2.0e8


def tool_device(name: str | None) -> torch.device:
    """The device a tool runs on: ``cuda:0`` unless told otherwise; a CUDA
    device where there is none raises "no CUDA device" (no CPU fallback)."""
    from cwsl_digi_tpu_torch.device import as_device, cuda_device

    dev = as_device(name)
    if dev.type == "cuda":
        cuda_device()
    return dev


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    from chip_smoke import card_line

    return card_line()


# ---------------------------------------------------------------------------
# Randomized protocol-exact message + window generation
# ---------------------------------------------------------------------------

def random_call(rng: np.random.Generator) -> str:
    """Random standard amateur callsign (packable by pack_call28)."""
    letters = string.ascii_uppercase
    p = letters[rng.integers(26)] + letters[rng.integers(26)]
    d = str(rng.integers(10))
    suf = "".join(letters[rng.integers(26)] for _ in range(int(rng.integers(1, 4))))
    return p + d + suf


def random_grid(rng: np.random.Generator) -> str:
    g = "ABCDEFGHIJKLMNOPQR"
    return (g[rng.integers(18)] + g[rng.integers(18)]
            + str(rng.integers(10)) + str(rng.integers(10)))


def random_power(rng: np.random.Generator) -> int:
    """Legal WSPR power: 0..57 dBm ending in 0/3/7 (the packer clamps at
    60, so 6x values can never round-trip)."""
    return int(rng.integers(0, 6)) * 10 + int(rng.choice([0, 3, 7]))


def make_trial(mode: str, rng: np.random.Generator,
               f0_range: tuple[float, float],
               dt_range: tuple[float, float]) -> tuple[np.ndarray, str]:
    """One protocol-exact clean window + its canonical expected message."""
    from cwsl_digi_tpu_torch.constants import Mode

    f0 = float(rng.uniform(*f0_range))
    dt = float(rng.uniform(*dt_range))
    if mode == "WSPR":
        from cwsl_digi_tpu_torch.modes import wspr as m
        call, grid, dbm = random_call(rng), random_grid(rng), random_power(rng)
        return (m.synthesize(call, grid, dbm, f0, start_s=dt),
                f"{call} {grid} {dbm}")
    if mode.startswith("FST4W"):
        from cwsl_digi_tpu_torch.modes import fst4 as m
        call, grid, dbm = random_call(rng), random_grid(rng), random_power(rng)
        text = f"{call} {grid} {dbm}"
        return m.synthesize(text, Mode(mode), f0, start_s=dt), text
    text = f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"
    if mode == "JT65":
        from cwsl_digi_tpu_torch.modes import jt65 as m
        return m.synthesize(text, f0, start_s=dt), text
    if mode == "Q65-30":
        from cwsl_digi_tpu_torch.modes import q65 as m
        return m.synthesize(text, f0, start_s=dt), text
    if mode.startswith("FST4"):
        from cwsl_digi_tpu_torch.modes import fst4 as m
        return m.synthesize(text, Mode(mode), f0, start_s=dt), text
    if mode == "FT4":
        from cwsl_digi_tpu_torch.modes import ft4 as m
        return m.synthesize(text, f0, start_s=dt), text
    if mode == "JS8":
        # realistic JS8 traffic is frame-exact directed/heartbeat messages
        # (free text longer than one frame spans multiple 15 s frames and
        # cannot round-trip through a single-window trial)
        from cwsl_digi_tpu_torch.modes import js8 as m
        text = f"{random_call(rng)}: {random_call(rng)} 73"
        return m.synthesize(text, f0, start_s=dt), text
    from cwsl_digi_tpu_torch.modes import ft8 as m
    return m.synthesize(text, f0, start_s=dt), text


def _decoded_messages(results) -> list[list[str]]:
    return [[r.message for r in rl] for rl in results]


def _decode_grouped(dec, wins) -> list[list[str]]:
    """Decode windows in groups of at most GROUP_SAMPLES samples."""
    wlen = len(wins[0])
    group = max(1, min(len(wins), int(GROUP_SAMPLES // wlen) or 1))
    res = []
    for i in range(0, len(wins), group):
        res += _decoded_messages(dec.decode(np.stack(wins[i:i + group])))
    return res


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def sweep_mode(mode: str, trials: int, seed: int = 42, snrs=None,
               verbose: bool = True, device=None) -> dict:
    """Recall at each SNR of ``mode``'s grid, false decodes on noise and
    the 50 % threshold, on ``device`` (default: the card); with the peak
    device memory of the run (on the card; its largest group)."""
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    dev = tool_device(device)
    cfg = SWEEPS[mode]
    snrs = list(snrs if snrs is not None else cfg["snrs"])
    trials = min(trials, cfg.get("max_trials", trials))
    rng = np.random.default_rng(seed)
    dec = get_decoder(mode, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    recall: dict[str, float] = {}
    for snr in snrs:
        wins, wants = [], []
        for _ in range(trials):
            clean, want = make_trial(mode, rng, cfg["f0"], cfg["dt"])
            wins.append(add_noise_at_snr(clean, float(snr), 12000, rng))
            wants.append(want)
        res = _decode_grouped(dec, wins)
        ok = sum(want in msgs for want, msgs in zip(wants, res))
        recall[f"{float(snr):.1f}"] = ok / trials
        if verbose:
            print(f"  {mode:10s} SNR {snr:+6.1f} dB: {ok}/{trials}"
                  f" = {ok/trials:.0%}", flush=True)

    # false decodes on pure noise (reference chain: essentially zero)
    n_noise = max(8, trials // 2)
    wlen = len(make_trial(mode, rng, cfg["f0"], cfg["dt"])[0])
    noise = rng.standard_normal((n_noise, wlen)).astype(np.float32)
    false_msgs = [m for msgs in _decode_grouped(dec, list(noise))
                  for m in msgs]
    false_n = len(false_msgs)
    if verbose and false_n:
        print(f"  {mode}: {false_n} FALSE decodes on {n_noise} noise windows"
              f" (seed {seed}): {false_msgs}", flush=True)

    # 95% binomial CI half-width per recall point
    ci95 = {s_: round(1.96 * float(np.sqrt(max(r * (1 - r), 0.25 / trials)
                                           / trials)), 3)
            for s_, r in recall.items()}
    return {
        "trials": trials,
        "recall": recall,
        "recall_ci95": ci95,
        "false_per_noise_window": false_n / n_noise,
        "threshold_db": _threshold(recall),
        "false_messages": false_msgs,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }


def _threshold(recall: dict[str, float], level: float = 0.5) -> float | None:
    """SNR at which recall crosses `level` (linear interpolation)."""
    pts = sorted(((float(s), r) for s, r in recall.items()), reverse=True)
    prev = None
    for snr, r in pts:  # descending SNR
        if r < level:
            if prev is None:
                return None
            s_hi, r_hi = prev
            if r_hi == r:
                return s_hi
            return round(snr + (level - r) * (s_hi - snr) / (r_hi - r), 1)
        prev = (snr, r)
    return pts[-1][0] if pts else None


def sweep_crowded(n_windows: int = 6, n_signals: int = 18, seed: int = 7,
                  verbose: bool = True, device=None) -> dict:
    """Many simultaneous FT8 signals per window -> aggregate recall.

    Mirrors the reference's busy-band operating point (jt9 -d3 with
    subtraction); SNRs drawn uniform [-18, -2] dB, frequencies on a
    jittered grid so signals overlap skirts but not centers.
    """
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.base import get_decoder

    rng = np.random.default_rng(seed)
    dec = get_decoder("FT8", device=tool_device(device))
    wins, wants = [], []
    wlen = int(ft8.T_R * 12000)
    for _ in range(n_windows):
        slots = np.linspace(500, 2600, n_signals) + rng.uniform(
            -30, 30, n_signals)
        acc = np.zeros(wlen)
        msgs = []
        for f0 in slots:
            text = f"{random_call(rng)} {random_call(rng)} {random_grid(rng)}"
            snr = float(rng.uniform(-18, -2))
            dt = float(rng.uniform(0.1, 1.0))
            clean = ft8.synthesize(text, float(f0), start_s=dt)
            amp = 10.0 ** (snr / 20.0)  # relative to the common noise floor
            acc += amp * clean
            msgs.append(text)
        # shared noise floor: density such that a unit-amplitude GFSK
        # burst (power 0.5) measures 0 dB in the 2.5 kHz reference bw,
        # so each signal's SNR is exactly its amp in dB (amp=10^(snr/20))
        noise_power = 0.5 / 2500.0 * (12000 / 2.0)
        noise = rng.standard_normal(wlen) * np.sqrt(noise_power)
        wins.append(acc + noise)
        wants.append(msgs)
    res = _decoded_messages(dec.decode(np.stack(wins)))
    total = sum(len(m) for m in wants)
    got = sum(sum(w in msgs for w in want) for want, msgs in zip(wants, res))
    extra = sum(sum(m not in want for m in msgs)
                for want, msgs in zip(wants, res))
    if verbose:
        print(f"  crowded FT8: {got}/{total} signals decoded "
              f"({n_signals}/window x {n_windows}), {extra} other decodes",
              flush=True)
    return {"n_windows": n_windows, "n_signals": n_signals,
            "total_signals": total, "decoded": got,
            "recall": round(got / total, 3), "other_decodes": extra}


# ---------------------------------------------------------------------------
# Committed fixtures (regression inputs decoupled from the live synth code)
# ---------------------------------------------------------------------------

FIXTURES = [
    # (name, mode, message-or-None(=use args), snr_db, f0, dt, seed)
    ("ft8_m10db", "FT8", "K1ABC W9XYZ EN37", -10.0, 1500.0, 0.5, 1),
    ("ft8_m18db", "FT8", "CQ DL7ACA JO40", -18.0, 850.0, 0.9, 2),
    ("ft8_m21db", "FT8", "G4ABC K1ABC RR73", -21.0, 2210.0, 0.3, 3),
    ("ft4_m15db", "FT4", "K1ABC W9XYZ EN37", -15.0, 1200.0, 0.4, 4),
    ("wspr_m28db", "WSPR", "K1ABC FN42 30", -28.0, 1512.3, 1.2, 5),
    ("jt65_m22db", "JT65", "K1ABC W9XYZ EN37", -22.0, 1270.5, 1.0, 6),
    ("q65_m24db", "Q65-30", "K1ABC W9XYZ EN37", -24.0, 1000.0, 0.6, 7),
    ("fst4_60_m23db", "FST4-60", "K1ABC W9XYZ EN37", -23.0, 1000.0, 1.0, 8),
    ("js8_m18db", "JS8", "CQCQ K1ABC", -18.0, 1500.0, 0.5, 9),
]

# the reference's known false decode of this fixture (ROADMAP queue 3,
# "WSPR fixture"): both packages decode it in place of the manifest's
KNOWN_FIXTURE_FAULTS = {"wspr_m28db.wav": "L8TUM RD32 30"}


def synth_named(mode: str, message: str, f0: float, dt: float) -> np.ndarray:
    from cwsl_digi_tpu_torch.constants import Mode

    if mode == "WSPR":
        from cwsl_digi_tpu_torch.modes import wspr as m
        call, grid, dbm = message.split()
        return m.synthesize(call, grid, int(dbm), f0, start_s=dt)
    if mode.startswith("FST4"):
        from cwsl_digi_tpu_torch.modes import fst4 as m
        return m.synthesize(message, Mode(mode), f0, start_s=dt)
    import importlib
    m = importlib.import_module(
        "cwsl_digi_tpu_torch.modes." + mode.split("-")[0].lower())
    return m.synthesize(message, f0, start_s=dt)


def check_fixtures(device=None, fixture_dir: Path = FIXTURE_DIR) -> list[dict]:
    """Decode each committed fixture WAV through the port: hit when the
    manifest's message is among the decodes, "known fault" when the
    reference's known false decode comes out in its place, else miss."""
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.utils.wav import read_wav

    dev = tool_device(device)
    out = []
    for entry in json.loads((fixture_dir / "manifest.json").read_text()):
        audio, sr = read_wav(fixture_dir / entry["file"])
        if sr != 12000:
            raise ValueError(f"{entry['file']}: {sr} Hz, want 12000")
        msgs = _decoded_messages(get_decoder(entry["mode"], device=dev).decode(
            np.asarray(audio, np.float32)[None, :]))[0]
        if entry["message"] in msgs:
            verdict = "hit"
        elif KNOWN_FIXTURE_FAULTS.get(entry["file"]) in msgs:
            verdict = "known fault"
        else:
            verdict = "miss"
        print(f"  {entry['file']:18s} {entry['mode']:8s} {verdict}: want "
              f"{entry['message']!r}, decoded {msgs}", flush=True)
        out.append({"file": entry["file"], "mode": entry["mode"],
                    "message": entry["message"], "decoded": msgs,
                    "verdict": verdict})
    return out


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="*", default=None)
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--quick", action="store_true",
                    help="the last 3 SNRs of each grid, 8 trials (fewer "
                         "with --trials)")
    ap.add_argument("--check-fixtures", action="store_true",
                    help="decode tests/fixtures/*.wav, report hit or miss")
    ap.add_argument("--no-crowded", action="store_true")
    ap.add_argument("--merge", action="store_true",
                    help="update only the swept modes inside an existing "
                         "--out report (patch sweeps)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "torch_parity.json"))
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    dev = tool_device(args.device)
    card = device_line(dev)
    print(card, flush=True)
    report: dict = {"device": str(dev), "card": card, "modes": {}}
    if args.merge and Path(args.out).exists():
        report = json.loads(Path(args.out).read_text())
        report.update(device=str(dev), card=card)
    if args.check_fixtures:
        print("== fixtures ==", flush=True)
        report["fixtures"] = check_fixtures(dev)
    else:
        modes = args.modes or list(SWEEPS)
        trials = min(8, args.trials) if args.quick else args.trials
        report["trials"] = trials
        for mode in modes:
            print(f"== {mode} ==", flush=True)
            snrs = SWEEPS[mode]["snrs"][-3:] if args.quick else None
            report["modes"][mode] = sweep_mode(mode, trials, snrs=snrs,
                                               device=dev)
        if not args.no_crowded and (args.modes is None or "FT8" in modes):
            print("== crowded band ==", flush=True)
            report["crowded"] = sweep_crowded(
                n_windows=2 if args.quick else 6, device=dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({m: {"threshold_db": d["threshold_db"],
                          "false_per_noise_window":
                              d["false_per_noise_window"]}
                      for m, d in report["modes"].items()}))
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
