"""Run the port's bench and decode profiles for two checkouts on one
card, in turns.

    python3 tools/torch_bench_ab.py OTHER_CHECKOUT [--runs N] [--out DIR]
                                    [--profile MODE ...]

Runs ``bench_cuda.py`` of OTHER_CHECKOUT and of this checkout N times each
(default 3) in the order other, this, this, other, other, this, ..., each
in its own process from its own root (so each builds and uses its own
kernels), then ``tools/torch_decode_profile.py`` of each for the modes
``--profile`` names (default FT8).  Every run's output goes to DIR
(default ``build/bench_ab``, which ``.gitignore`` lists):
``bench_<side>_<i>.json`` / ``.err`` and ``profile_<side>.log``.  It
prints one line a bench run (headline, ``t_dec`` with its three runs, the
mixed-mode capacity, the WSPR, JT65 and Q65-30 decode walls a window, the
FT8 recall and the busy band's found share and false messages) and, last, the
medians by checkout as one JSON object.  A failed bench exits 1 after the
others have run.  Needs one CUDA device; OTHER_CHECKOUT is e.g. ``git
archive`` of a parent commit unpacked into a directory that
``.gitignore`` lists.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def bench(root: Path, out: Path, tag: str) -> dict | None:
    """One bench_cuda.py run from ``root``: its summary, or None."""
    with open(out / f"bench_{tag}.json", "w") as so, \
            open(out / f"bench_{tag}.err", "w") as se:
        proc = subprocess.run([sys.executable, "bench_cuda.py"], cwd=root,
                              stdout=so, stderr=se, timeout=1200)
    lines = (out / f"bench_{tag}.json").read_text().strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(f"{tag}: bench failed ({proc.returncode})", flush=True)
        return None
    r = json.loads(lines[-1])
    d = r["detail"]
    s = {"headline": r["value"], "t_dec": d["decode_s_per_window_production"],
         "t_dec_runs": d["decode_production_runs"],
         "t_chan": d["channelizer_s_per_channel_second"],
         "mixed_mode": d["mixed_mode_channels_per_chip"],
         "wspr_s": d["mode_decode_s_per_window"]["WSPR"],
         "jt65_s": d["mode_decode_s_per_window"]["JT65"],
         "q65_s": d["mode_decode_s_per_window"]["Q65-30"],
         "recall": d["ft8_recall_curve"], "threshold_db": d["ft8_threshold_db"],
         "busy_found_share": d["busy_found_share"],
         "busy_false": d["busy_false_messages"],
         "false_per_noise_window": d["ft8_false_per_noise_window"],
         "device": r["device"]}
    print(f"{tag}: {json.dumps(s)}", flush=True)
    return s


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=str(HERE / "build" / "bench_ab"))
    ap.add_argument("--profile", nargs="+", default=["FT8"],
                    help="modes for tools/torch_decode_profile.py")
    args = ap.parse_args(argv)
    other = Path(args.other).resolve()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    roots = {"other": other, "this": HERE}
    order = []
    for i in range(args.runs):
        order += [("other", "this"), ("this", "other")][i % 2]
    results: dict[str, list[dict]] = {"other": [], "this": []}
    failed = False
    for i, side in enumerate(order):
        s = bench(roots[side], out, f"{side}_{i}")
        if s is None:
            failed = True
        else:
            results[side].append(s)
    for side, root in roots.items():
        with open(out / f"profile_{side}.log", "w") as f:
            proc = subprocess.run(
                [sys.executable, "tools/torch_decode_profile.py",
                 *args.profile],
                cwd=root, stdout=f, stderr=subprocess.STDOUT, timeout=900)
        print(f"profile {side}: exit {proc.returncode}, "
              f"{out / f'profile_{side}.log'}", flush=True)
        failed |= proc.returncode != 0
    summary = {side: {k: statistics.median(r[k] for r in rs)
                      for k in ("headline", "t_dec", "t_chan", "mixed_mode",
                                "wspr_s", "jt65_s", "q65_s")}
               | {"runs": len(rs)}
               for side, rs in results.items() if rs}
    print(json.dumps({"bench_ab": summary}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
