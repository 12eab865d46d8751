"""Screen FT8 recall / busy-band decodes / latency vs candidate budget on
the port.

Counterpart of ``tools/tune_topk.py`` on ``cwsl_digi_tpu_torch``: the
same arguments, defaults, seeds and order of random draws (the trials
come from ``tools/torch_parity.py``'s ``make_trial``, ``SWEEPS``,
``random_call`` and ``random_grid``), so that the same command builds the
same trials.  For each top-K it prints the decode time per window of a
``max_device_batch`` batch (host clock, the device synchronised around
each decode), the recall at -18 and -21 dB, and the decodes per window of
a busy band (6 signals a window, -20 to -5 dB).  On the card the sync
search's selection takes top_k up to 32768
(``_sync_kernels.SELECT_MAX_K`` a half) and refuses a larger one.

Usage (the card by default)::

    python tools/torch_tune_topk.py [trials] [k1 k2 ...] [--device DEV]
    python tools/torch_tune_topk.py 8 256
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch_parity as parity  # noqa: E402
from cwsl_digi_tpu_torch.modes import ft8  # noqa: E402
from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr  # noqa: E402


def recall_at(dec, snr, trials, seed=42):
    rng = np.random.default_rng(seed)
    wins, wants = [], []
    for _ in range(trials):
        clean, want = parity.make_trial("FT8", rng, *[
            parity.SWEEPS["FT8"][k] for k in ("f0", "dt")])
        wins.append(add_noise_at_snr(clean, float(snr), 12000, rng))
        wants.append(want)
    res = dec.decode(np.stack(wins))
    msgs = [[r.message for r in rs] for rs in res]
    return sum(w in m for w, m in zip(wants, msgs)) / trials


def busy(dec, batch=24, per_window=6, seed=5):
    rng = np.random.default_rng(seed)
    wlen = int(ft8.T_R * 12_000)
    noise_power = 0.5 / 2500.0 * (12_000 / 2.0)
    wins = np.empty((batch, wlen), np.float32)
    for w in range(batch):
        acc = rng.standard_normal(wlen) * np.sqrt(noise_power)
        slots = np.linspace(600, 2500, per_window) + rng.uniform(
            -40, 40, per_window)
        for f0 in slots:
            text = (f"{parity.random_call(rng)} {parity.random_call(rng)} "
                    f"{parity.random_grid(rng)}")
            snr = float(rng.uniform(-20, -5))
            acc += 10.0 ** (snr / 20.0) * ft8.synthesize(
                text, float(f0), start_s=float(rng.uniform(0.1, 1.0)))
        wins[w] = acc
    res = dec.decode(wins)
    return sum(len(r) for r in res) / batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("trials", type=int, nargs="?", default=64)
    ap.add_argument("ks", type=int, nargs="*")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    dev = parity.tool_device(args.device)
    print(f"device {dev}: {parity.device_line(dev)}", flush=True)
    rows = []
    for k in args.ks or [512, 320, 256]:
        dec = ft8.FT8Decoder(top_k=k, device=dev)
        b = dec.max_device_batch
        rng = np.random.default_rng(0)
        wlen = int(ft8.T_R * 12000)
        audio = rng.standard_normal((b, wlen)).astype(np.float32)
        for w in range(b):
            audio[w] += 0.5 * ft8.synthesize("K1ABC W9XYZ FN20", 800.0 + 3 * w)
        dec.decode(audio)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            dec.decode(audio)
        _sync(dev)
        dt = (time.perf_counter() - t0) / 3 / b
        r18 = recall_at(dec, -18.0, args.trials)
        r21 = recall_at(dec, -21.0, args.trials)
        dpw = busy(dec)
        rows.append({"top_k": k, "ms_per_window": dt * 1e3, "recall_-18": r18,
                     "recall_-21": r21, "busy_decodes_per_window": dpw})
        print(f"top_k={k:4d}: {dt*1e3:5.1f} ms/win  recall -18={r18:.3f} "
              f"-21={r21:.3f}  busy={dpw:.2f}/6", flush=True)
    return rows


if __name__ == "__main__":
    main()
