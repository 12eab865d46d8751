"""Calibrate the OSD acceptance gates (ModeSpec.osd_nhard_max/osd_dist_frac)
of the port.

Counterpart of ``tools/osd_calibrate.py`` on ``cwsl_digi_tpu_torch``: the
same arguments, defaults, seed and order of random draws, so that the
same command builds the same trials.  For FT8 (or FT4) it measures

  - recall at threshold SNRs with the OSD pass on;
  - the false decodes on pure-noise windows (the gates must keep them at
    zero), with up to 10 of their messages.

The decoders are built as the JAX tool builds them (no AP) on
``--device``, and take host audio, peak-scaled to int16 as the reference
feeds jt9.

Usage (the card by default)::

    python tools/torch_osd_calibrate.py [--trials N] [--noise N] [--snrs a,b]
    python tools/torch_osd_calibrate.py --trials 2 --noise 25 --snrs -10 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--noise", type=int, default=200)
    ap.add_argument("--snrs", type=str, default="-20,-21,-22")
    ap.add_argument("--mode", type=str, default="FT8")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from torch_parity import device_line, tool_device

    from cwsl_digi_tpu_torch.modes import ft4, ft8
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    dev = tool_device(args.device)
    print(f"device {dev}: {device_line(dev)}", flush=True)
    mod = {"FT8": ft8, "FT4": ft4}[args.mode]
    dec = (ft8.FT8Decoder(device=dev) if args.mode == "FT8"
           else ft4.FT4Decoder(device=dev))
    sr = 12000
    rng = np.random.default_rng(7)
    text = "CQ K1ABC FN42"
    report: dict = {"mode": args.mode, "recall": {}}

    for snr in [float(s) for s in args.snrs.split(",")]:
        hits = 0
        batch = []
        for _ in range(args.trials):
            f0 = rng.uniform(400, 2500)
            batch.append(add_noise_at_snr(
                mod.synthesize(text, f0), snr, sr, rng))
        results = dec.decode(np.stack(batch))
        for rs in results:
            if any(r.message == text for r in rs):
                hits += 1
        report["recall"][f"{snr:.1f}"] = hits / args.trials
        print(f"SNR {snr:6.1f}: {hits}/{args.trials} = "
              f"{100*hits//args.trials}%", flush=True)

    # noise-only false decode check
    n_samp = int(mod.T_R * sr)
    false_msgs = []
    bs = 25
    for i in range(0, args.noise, bs):
        noise = rng.standard_normal((bs, n_samp)).astype(np.float32)
        for rs in dec.decode(noise):
            false_msgs += [r.message for r in rs]
    print(f"noise windows: {args.noise}, false decodes: {len(false_msgs)}")
    for m in false_msgs[:10]:
        print("  FALSE:", repr(m))
    report.update(noise_windows=args.noise, false_messages=false_msgs)
    return report


if __name__ == "__main__":
    main()
