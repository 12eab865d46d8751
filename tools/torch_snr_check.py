"""SNR-estimator calibration check of the port: reported vs injected SNR.

Counterpart of ``tools/snr_check.py`` on the port's decoders
(``cwsl_digi_tpu_torch``).  The reference reports jt9/wsprd SNRs verbatim
to PSK Reporter / WSPRNet (source/OutputHandler.cpp:505-621); the port's
estimators must match the WSJT-X convention (signal power over noise in
2.5 kHz) to ~1 dB.  Each engine carries a per-mode ``snr_offset_db``
(``modes/jt65.py``, ``modes/fst4.py``, ...) that this tool checks::

    python tools/torch_snr_check.py [modes...] [--trials N] [--device cpu]

Prints per-mode bias/std of (reported - injected) over randomized
protocol-exact signals at -10/-15 dB (``torch_parity``'s ``SWEEPS`` and
``make_trial``), decoded on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

DEFAULT_MODES = ("FT8", "FT4", "JS8", "WSPR", "JT65", "Q65-30",
                 "FST4-60", "FST4W-120")


def measure(mode: str, trials: int = 8, snrs=(-10.0, -15.0),
            rng=None, device=None) -> np.ndarray:
    """(reported - injected) SNR of every decode of the wanted message."""
    from torch_parity import SWEEPS, make_trial, tool_device

    from cwsl_digi_tpu_torch.modes import js8
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    rng = rng or np.random.default_rng(3)
    dec = get_decoder(mode, device=tool_device(device))
    errs = []
    for snr in snrs:
        wins, wants = [], []
        for _ in range(trials):
            if mode == "JS8":
                # one-frame text payload (the generic two-call trial
                # overflows JS8's 12-char text frame)
                f0 = float(rng.uniform(600, 2400))
                wins.append(add_noise_at_snr(
                    js8.synthesize("HELLO TU 73", f0, start_s=0.4),
                    snr, 12000, rng))
                wants.append("HELLO TU 73")
                continue
            clean, want = make_trial(mode, rng, SWEEPS[mode]["f0"],
                                     SWEEPS[mode]["dt"])
            wins.append(add_noise_at_snr(clean, snr, 12000, rng))
            wants.append(want)
        res = dec.decode(np.stack(wins))
        for want, rl in zip(wants, res):
            errs += [r.snr_db - snr for r in rl if r.message == want]
    return np.asarray(errs)


def main(argv: list[str] | None = None) -> dict:
    from torch_parity import device_line, tool_device

    ap = argparse.ArgumentParser()
    ap.add_argument("modes", nargs="*", default=list(DEFAULT_MODES))
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    dev = tool_device(args.device)
    print(device_line(dev), flush=True)
    out = {}
    for mode in args.modes or DEFAULT_MODES:
        errs = measure(mode, args.trials, device=dev)
        if len(errs) == 0:
            print(f"{mode:10s} no decodes")
            out[mode] = {"n": 0}
            continue
        print(f"{mode:10s} n={len(errs):3d} bias={errs.mean():+5.2f} dB"
              f"  std={errs.std():.2f}", flush=True)
        out[mode] = {"n": int(len(errs)), "bias_db": float(errs.mean()),
                     "std_db": float(errs.std())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
