"""Merge ``tools/torch_soak.py`` run files into one soak summary.

Counterpart of ``tools/soak_merge.py``.  A run passes when it emitted
spots and had no deadline miss, no stale drop and no ingest overrun.
``max_channels_meeting_deadline`` is the largest channel count N such that
every run with a count <= N passed (a failing lower count caps it), and
the summary lists pass or fail per run.

Usage::

    python tools/torch_soak_merge.py chiprun_out/torch_soak_64x1.json \\
        chiprun_out/torch_soak_256x1.json ... --out chiprun_out/torch_soak.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def run_passes(run: dict) -> bool:
    return bool(run["spots"]) and run["deadline_misses"] == 0 \
        and run["stale_drops"] == 0 and run["ingest_overruns"] == 0


def summarize(runs: list[dict]) -> dict:
    runs = sorted(runs, key=lambda r: (r["channels"], r.get("receivers", 1),
                                       r.get("pool_workers", 0)))
    max_pass = None
    for n in sorted({r["channels"] for r in runs}):
        if not all(run_passes(r) for r in runs if r["channels"] == n):
            break
        max_pass = n
    return {
        "per_run": [{"channels": r["channels"],
                     "receivers": r.get("receivers", 1),
                     "pool_workers": r.get("pool_workers"),
                     "pass": run_passes(r),
                     "deadline_misses": r["deadline_misses"],
                     "stale_drops": r["stale_drops"],
                     "ingest_overruns": r["ingest_overruns"],
                     "latency_p95_s": r["latency_s"]["p95"]} for r in runs],
        "stale_drops_any": sum(r["stale_drops"] for r in runs),
        "ingest_overruns_any": sum(r["ingest_overruns"] for r in runs),
        "max_channels_meeting_deadline": max_pass,
        "card": sorted({r.get("card") for r in runs if r.get("card")}),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--out", default="chiprun_out/torch_soak.json")
    ap.add_argument("--note", default="")
    args = ap.parse_args(argv)

    runs = [json.loads(Path(p).read_text()) for p in args.runs]
    out = {"summary": summarize(runs), "runs": runs}
    if args.note:
        out["environment_note"] = args.note
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out["summary"], indent=1))
    return out


if __name__ == "__main__":
    main()
