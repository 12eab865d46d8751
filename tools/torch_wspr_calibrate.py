"""Calibrate the WSPR OSD acceptance gates (WSPRConfig.osd_*, host gates)
of the port.

Counterpart of ``tools/wspr_calibrate.py`` on ``cwsl_digi_tpu_torch``:
the same arguments, defaults, seeds and order of random draws, so that the
same command builds the same trials.  It reads ``osd_bits``,
``osd_nhard``, ``llr``, ``score``, ``bits`` and ``metric`` from the port's
``WSPRDecoder.decode_arrays`` on ``--device`` and measures, for the OSD
fallback path (wsprd -o analogue):

  - per-candidate (score, nhard, agree) stats of the TRUE codeword at
    threshold SNRs, where the gates must accept;
  - the same stats for every OSD fit on pure-noise windows, where the
    gates must reject (zero false decodes).

``--beam-sweep`` measures recall against beam width instead and writes
its JSON to ``--out`` (default ``chiprun_out/torch_wspr_calibration.json``;
``WSPR_CALIBRATION.json`` is the JAX package's record).

Usage (the card by default)::

    python tools/torch_wspr_calibrate.py [--trials N] [--noise N] [--snrs a,b]
    python tools/torch_wspr_calibrate.py --beam-sweep --trials 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

BEAM_SWEEP_OUT = REPO / "chiprun_out" / "torch_wspr_calibration.json"


def candidate_stats(dec, out, wi, k):
    from cwsl_digi_tpu_torch.modes import wspr as m

    bits = out["osd_bits"][wi, k]
    coded = m.conv_encode(bits)
    signs = 1.0 - 2.0 * coded.astype(np.float32)
    llr = out["llr"][wi, k].reshape(162)
    agree = float(np.sum(np.where(signs * llr > 0, np.abs(llr), 0.0))
                  / (np.sum(np.abs(llr)) + 1e-30))
    return {
        "score": float(out["score"][wi, k]),
        "nhard": int(out["osd_nhard"][wi, k]),
        "agree": agree,
        "bits": bits,
    }


def beam_sweep(trials: int, snrs: list[float], device,
               widths=(256, 512, 1024), out=BEAM_SWEEP_OUT) -> dict:
    """Recall vs beam width at the deep-SNR region wsprd owns: the
    ``wsprcycles`` -> beam-width mapping of ``WSPRDecoder.__init__``
    (reference default 3000 cycles/bit, config.ini:217-222, wsprd -C at
    DecoderPool.hpp:1026).  Randomized messages/frequencies/offsets per
    trial, like ``tools/torch_parity.py``; seconds per window on the host
    clock around each decode."""
    from torch_parity import device_line, make_trial

    from cwsl_digi_tpu_torch.modes import wspr as m
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    f0 = (1420.0, 1580.0)
    dt = (0.5, 2.0)
    report: dict = {"trials": trials, "snrs": snrs, "widths": {},
                    "device": str(device), "card": device_line(device)}
    for w in widths:
        dec = m.WSPRDecoder(beam_width=w, device=device)
        rec = {}
        for snr in snrs:
            rng = np.random.default_rng(int(1000 - snr))  # same per width
            wins, wants = [], []
            for _ in range(trials):
                clean, want = make_trial("WSPR", rng, f0, dt)
                wins.append(add_noise_at_snr(clean, snr, m.WAVE_SR, rng))
                wants.append(want)
            t0 = time.perf_counter()
            res = dec.decode(np.stack(wins))
            sec = (time.perf_counter() - t0) / trials
            ok = sum(want in [r.message for r in rl]
                     for want, rl in zip(wants, res))
            rec[f"{snr:.1f}"] = ok / trials
            print(f"  beam {w:5d} SNR {snr:+6.1f}: {ok}/{trials}"
                  f"  ({sec * 1e3:.0f} ms/win)", flush=True)
        report["widths"][str(w)] = {"recall": rec,
                                    "s_per_window": round(sec, 4)}
    # the cycles mapping this calibrates (WSPRDecoder.__init__)
    report["cycles_mapping"] = {"500": 256, "3000": 512, "10000": 1024}
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return report


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--noise", type=int, default=96)
    ap.add_argument("--snrs", type=str, default="-29,-30,-31,-32")
    ap.add_argument("--beam-sweep", action="store_true",
                    help="recall-vs-beam-width sweep -> --out")
    ap.add_argument("--out", default=str(BEAM_SWEEP_OUT),
                    help="the beam sweep's JSON")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    from torch_parity import device_line, tool_device

    dev = tool_device(args.device)
    print(f"device {dev}: {device_line(dev)}", flush=True)
    if args.beam_sweep:
        return beam_sweep(args.trials,
                          [float(s) for s in args.snrs.split(",")], dev,
                          out=args.out)

    from cwsl_digi_tpu_torch.modes import wspr as m
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    dec = m.WSPRDecoder(device=dev)
    rng = np.random.default_rng(7)
    true_bits = m.pack_message("K1ABC", "FN42", 30)
    report: dict = {"true_osd": {}, "true_beam": {}}

    for snr in [float(s) for s in args.snrs.split(",")]:
        clean = m.synthesize("K1ABC", "FN42", 30, 1512.34)
        batch = np.stack([
            add_noise_at_snr(clean, snr, m.WAVE_SR, rng)
            for _ in range(args.trials)])
        out = dec.decode_arrays(batch)
        n_osd = out["osd_bits"].shape[1]
        rows = []
        beam_rows = []
        for wi in range(args.trials):
            for k in range(n_osd):
                st = candidate_stats(dec, out, wi, k)
                if np.array_equal(st["bits"], true_bits):
                    rows.append(st)
                    break
            for k in range(dec.cfg.top_k):
                if np.array_equal(out["bits"][wi, k], true_bits):
                    beam_rows.append({
                        "metric": float(out["metric"][wi, k]),
                        "score": float(out["score"][wi, k]),
                    })
                    break
        report["true_osd"][f"{snr:.1f}"] = len(rows)
        report["true_beam"][f"{snr:.1f}"] = len(beam_rows)
        print(f"SNR {snr:6.1f}: true-OSD {len(rows)}/{args.trials} "
              f"(true-beam {len(beam_rows)})", flush=True)
        if rows:
            for f in ("score", "nhard", "agree"):
                v = np.asarray([r[f] for r in rows], np.float64)
                print(f"    osd  {f}: min {v.min():.3f} p25 "
                      f"{np.percentile(v, 25):.3f} med {np.median(v):.3f}")
        if beam_rows:
            for f in ("metric", "score"):
                v = np.asarray([r[f] for r in beam_rows], np.float64)
                print(f"    beam {f}: min {v.min():.3f} p25 "
                      f"{np.percentile(v, 25):.3f} med {np.median(v):.3f}")

    # noise-only: every OSD candidate is a potential false decode
    n_samp = int(m.T_R * m.WAVE_SR)
    stats = []
    beam_noise = []
    bs = 12
    for i in range(0, args.noise, bs):
        noise = rng.standard_normal((bs, n_samp)).astype(np.float32)
        out = dec.decode_arrays(noise)
        n_osd = out["osd_bits"].shape[1]
        for wi in range(bs):
            for k in range(n_osd):
                st = candidate_stats(dec, out, wi, k)
                del st["bits"]
                stats.append(st)
            for k in range(dec.cfg.top_k):
                beam_noise.append((float(out["metric"][wi, k]),
                                   float(out["score"][wi, k])))
    print(f"noise windows: {args.noise}, OSD candidates: {len(stats)}")
    bm = np.asarray(beam_noise)
    print(f"    beam metric max-5 {np.round(np.sort(bm[:, 0])[-5:], 3)} "
          f"score max-5 {np.round(np.sort(bm[:, 1])[-5:], 3)}")
    for f in ("score", "nhard", "agree"):
        v = np.asarray([s[f] for s in stats], np.float64)
        hi = np.sort(v)[-5:]
        lo = np.sort(v)[:5]
        print(f"    {f}: max-5 {np.round(hi, 3)} min-5 {np.round(lo, 3)}")
    # worst joint offenders under the prospective gates
    bad = [s for s in stats
           if s["agree"] >= 0.90 and s["nhard"] <= 34 and s["score"] >= 0.14]
    print(f"    near-gate offenders (agree>=0.90, nhard<=34, score>=0.14): "
          f"{len(bad)}")
    for s in sorted(bad, key=lambda s: -s["agree"])[:8]:
        print(f"      score {s['score']:.3f} nhard {s['nhard']} "
              f"agree {s['agree']:.3f}")
    report.update(noise_windows=args.noise, osd_candidates=len(stats),
                  near_gate_offenders=len(bad))
    return report


if __name__ == "__main__":
    main()
