"""Time the stage kernels of two checkouts on one card, in turns.

    python3 tools/stage_kernels_ab.py OTHER_CHECKOUT

Runs ``chip_smoke.ldpc_kernels_phase``, ``chip_smoke.gfsk_kernels_phase``
and, where the checkout has it, ``chip_smoke.sync_kernels_phase`` (on the
same recorded decoder inputs as the GFSK phase) of OTHER_CHECKOUT, of this
checkout, of this checkout again and of OTHER_CHECKOUT again, each in its
own process from its own root (so each builds its own kernels and checks
them against its own plain versions on the main path's inputs), and
prints every run's device times (CUDA graphs, this checkout's
``chip_smoke.cuda_ms`` for both), then the medians by checkout and kernel
as one JSON object, and each kernel's pair of medians like for like: a
checkout whose ``multisym_llrs`` is the LLR kernel's spectrogram entry
also times its csym entry (``multisym_llrs_csym``), which is compared with
the other's ``multisym_llrs`` where that has no such entry.  Needs one CUDA device; OTHER_CHECKOUT is e.g. ``git archive`` of a
parent commit unpacked into a directory that ``.gitignore`` lists.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from channelizer_ab import HERE, run  # noqa: E402

RUN = """
import importlib.util, json, torch, chip_smoke
spec = importlib.util.spec_from_file_location("timer", TIMER_PATH)
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
chip_smoke.cuda_ms = timer.cuda_ms      # one device timer for both
dev = torch.device("cuda", 0)
out = dict(chip_smoke.ldpc_kernels_phase(dev)["kernels"])
if hasattr(chip_smoke, "sync_kernels_phase"):
    cases = chip_smoke.gfsk_cases(dev)
    out.update(chip_smoke.gfsk_kernels_phase(dev, cases)["kernels"])
    out.update(chip_smoke.sync_kernels_phase(dev, cases)["kernels"])
    del cases
else:
    out.update(chip_smoke.gfsk_kernels_phase(dev)["kernels"])
print("RESULT " + json.dumps(out))
"""
KEYS = ("ms", "plain_ms", "max_abs_err")


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    order = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    results: dict[str, list[dict]] = {"other": [], "this": []}
    for name, root in order:
        print(f"== {name}: {root}", flush=True)
        r = run(root, RUN)
        print(f"{name}: " + json.dumps({k: v["ms"] for k, v in r.items()}),
              flush=True)
        results[name].append(r)
    summary = {name: {k: {key: statistics.median(r[k][key] for r in runs)
                          for key in KEYS}
                      for k in runs[0]}
               for name, runs in results.items()}
    pairs = {}
    for name in summary["other"]:
        mine = name
        if f"{name}_csym" in summary["this"] \
                and f"{name}_csym" not in summary["other"]:
            mine = f"{name}_csym"
        if mine in summary["this"]:
            pairs[name] = {"other": summary["other"][name]["ms"],
                           "this": summary["this"][mine]["ms"],
                           "this_entry": mine}
    print(json.dumps({"runs": results, "median": summary,
                      "like_for_like_ms": pairs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
