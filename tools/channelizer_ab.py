"""Time the channelizer kernel of two checkouts on one card, in turns.

    python3 tools/channelizer_ab.py OTHER_CHECKOUT

Runs ``chip_smoke.kernel_phase`` of OTHER_CHECKOUT, of this checkout, of
this checkout again and of OTHER_CHECKOUT again, each in its own process
from its own root (so each builds and checks its own kernel against its
own plain version), at the smoke's main-path 64 dials and at 256 channels,
and prints every run's numbers, then the medians by checkout.  Both are
timed with this checkout's ``chip_smoke.cuda_ms`` (device time, CUDA
graphs).  Needs one CUDA device; OTHER_CHECKOUT is e.g. ``git archive`` of
a parent commit unpacked into a directory that ``.gitignore`` lists.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

RUN = """
import importlib.util, json, numpy as np, torch, chip_smoke
spec = importlib.util.spec_from_file_location("timer", TIMER_PATH)
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
chip_smoke.cuda_ms = timer.cuda_ms      # one device timer for both
dev = torch.device("cuda", 0)
dials, _ = chip_smoke._plan()
out = {
    64: chip_smoke.kernel_phase(dev, np.asarray(dials, np.float64)
                                - chip_smoke.LO),
    256: chip_smoke.kernel_phase(dev, np.linspace(-chip_smoke.FS / 2,
                                 chip_smoke.FS / 2 - 6000, 256)),
}
print("RESULT " + json.dumps(out))
"""


def run(root: Path, code: str = RUN) -> dict:
    """``code`` (a script that prints ``RESULT <json>``) from ``root``,
    with this checkout's ``chip_smoke.py`` as TIMER_PATH; its result."""
    code = code.replace("TIMER_PATH", repr(str(HERE / "chip_smoke.py")))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise RuntimeError(f"kernel run failed in {root}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    order = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    results: dict[str, list[dict]] = {"other": [], "this": []}
    for name, root in order:
        print(f"== {name}: {root}", flush=True)
        results[name].append(run(root))
    summary = {name: {ch: {key: statistics.median(r[ch][key] for r in runs)
                           for key in ("ms", "plain_ms", "max_abs_err")}
                      for ch in ("64", "256")}
               for name, runs in results.items()}
    print(json.dumps({"runs": results, "median": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
