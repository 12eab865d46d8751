"""Which of ``qra_mp``'s arithmetic steps keep the message passing's flags
near the plain version's: the kernel's NumPy model
(``tools/qra_mp_model.py``) as it is and with one step changed at a time
(``mp_model(..., change=...)``, the changes its ``CHANGES`` lists), on the
words of a ``tools/qra_mp_flips.py card`` run, against that run's plain
versions (on the card and on its host's CPU) and, where a ``cpu`` run of
that tool saved them (``DIR/jax.npz``), the JAX package's results.

    python tools/qra_mp_variants.py DIR [--words N] [--workers W]
                                    [--variants NAME ...]

DIR holds ``flips.npz``; its priors are made again on this CPU as the
flips tool makes them.  Prints, for each variant, the converged words and,
against each reference, the gap in converged words, the flags that differ
(lost / gained), and whether the symbols where both converge are
identical.  Imports no JAX; ~3.5 min a variant at 7,680 words with 6
workers.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import qra_mp_model as mm  # noqa: E402
from cwsl_digi_tpu_torch.modes import q65  # noqa: E402

VARIANTS = ("kept",) + mm.CHANGES


def _chunk(args) -> tuple:
    variant, pr = args
    return mm.mp_model(q65._mp(torch.device("cpu")), pr,
                       change=None if variant == "kept" else variant)


def main(argv: list[str]) -> int:
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from qra_mp_flips import priors

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", type=Path)
    ap.add_argument("--words", type=int, default=None)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    a = ap.parse_args(argv)
    z = np.load(a.dir / "flips.npz")
    pr = priors(z["e"])[: a.words]
    n = len(pr)
    ref = {k: (z[f"{k.replace(' ', '_')}_hard"][:n].astype(np.int64),
               z[f"{k.replace(' ', '_')}_ok"][:n])
           for k in ("plain card", "plain cpu")}
    if (a.dir / "jax.npz").exists():
        j = np.load(a.dir / "jax.npz")
        ref["jax"] = (j["jax_hard"][:n].astype(np.int64), j["jax_ok"][:n])
    print(f"{n} words; converged: "
          + ", ".join(f"{k} {int(v[1].sum())}" for k, v in ref.items()))
    with ProcessPoolExecutor(a.workers,
                             mp_context=mp.get_context("spawn")) as pool:
        for variant in a.variants:
            t = time.monotonic()
            parts = list(pool.map(_chunk, [(variant, pr[i : i + 240])
                                           for i in range(0, n, 240)]))
            hard, ok = (np.concatenate([p[i] for p in parts])
                        for i in range(2))
            line = [f"{variant}: converged {int(ok.sum())}"]
            for k, (rh, rok) in ref.items():
                both = ok & rok
                lost, gained = int((rok & ~ok).sum()), int((ok & ~rok).sum())
                line.append(f"vs {k}: gap {int(rok.sum()) - int(ok.sum())},"
                            f" flags differ {lost + gained} (lost {lost}, "
                            f"gained {gained}), symbols identical where "
                            f"both converge "
                            f"{not (hard != rh).any(-1)[both].any()}")
            print("; ".join(line) + f" ({time.monotonic() - t:.0f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
