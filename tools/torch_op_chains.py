"""Time of the decode stages the port still runs as chains of PyTorch
ops (no hand kernel), on one GPU.

    python3 tools/torch_op_chains.py [--windows 64]

It decodes ``--windows`` seeded WSPR and Q65-30 windows (the batches of
``tools/torch_decode_profile.py``) once as a warm-up and once timed, with
a device synchronize where each stage starts and ends (as that tool times
its stages), so a stage's time is its launches and its device work:

- WSPR's drift sync search: ``modes/wspr.py`` from the sync-contrast map
  to the candidates' (t0, f0) (the reference's ``wspr.py:295-332``);
- WSPR's coherent demod: from the per-symbol LLRs' gather to the
  interleaved LLR pairs (the reference's ``wspr.py:333-435``);
- Q65's prior variants ``qary_engine._mp_priors`` and the re-encode score
  and pack ``qary_engine._mp_score_pack``.

A span of lines inside a function is timed by a line tracer on that
function's frames only: from the first line of the span that runs to the
first line after it.  It prints the card, then one JSON line a stage
(ms, times entered), the longest first.  The spans are found in the source
by their first and last statements, so they follow edits.  Without CUDA
it exits 1.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def _span(fn, first: str, last: str) -> tuple:
    """(code, first line, last line) of the statements of ``fn`` from the
    one that contains ``first`` to the one that contains ``last`` (lines of
    functions nested in ``fn`` run in frames of their own code: they are
    timed inside the span that calls them)."""
    lines, start = inspect.getsourcelines(fn)
    a = next(i for i, t in enumerate(lines) if first in t)
    b = next(i for i, t in enumerate(lines) if i > a and last in t)
    return fn.__code__, start + a, start + b


def _whole(fn) -> tuple:
    lines, start = inspect.getsourcelines(fn)
    return fn.__code__, start, start + len(lines) - 1


def stages() -> dict[str, tuple]:
    from cwsl_digi_tpu_torch.modes import qary_engine, wspr

    return {
        "WSPR drift sync search": _span(wspr._decode_program,
                                        "# sync-contrast map",
                                        "f0 = rem % n_f0p"),
        "WSPR coherent demod": _span(wspr._decode_program,
                                     "# per-symbol data LLRs",
                                     "llr = llr.reshape(b * cfg.top_k"),
        "Q65 prior variants (_mp_priors)": _whole(qary_engine._mp_priors),
        "Q65 score + pack (_mp_score_pack)": _whole(
            qary_engine._mp_score_pack)}


def profile(mode: str, windows: int, spans: dict, dev) -> dict:
    """{stage: [ms, times entered]} of one decode of ``mode``."""
    import time

    import torch_decode_profile as tdp
    from cwsl_digi_tpu_torch.modes.base import get_decoder

    dec = get_decoder(mode, device=dev, **(
        {"fmax_hz": 3000.0} if mode != "WSPR" else {}))
    audio = torch.from_numpy(tdp._weak_windows(mode, windows, 7)).to(dev)
    dec.decode(audio)
    torch.cuda.synchronize()
    out = {name: [0.0, 0] for name in spans}
    open_ = {}                  # frame id: (stage, start time)

    def close(frame_id):
        name, t0 = open_.pop(frame_id)
        torch.cuda.synchronize()
        out[name][0] += (time.perf_counter() - t0) * 1e3

    def local(frame, event, arg):
        key = id(frame)
        here = next((name for name, (code, a, b) in spans.items()
                     if frame.f_code is code and a <= frame.f_lineno <= b),
                    None)
        if key in open_ and (event == "return"
                             or open_[key][0] != here):
            close(key)
        if event == "line" and here is not None and key not in open_:
            torch.cuda.synchronize()
            open_[key] = (here, time.perf_counter())
            out[here][1] += 1
        return local

    codes = {code for code, _, _ in spans.values()}

    def tracer(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            return local
        return None

    sys.settrace(tracer)
    try:
        dec.decode(audio)
    finally:
        sys.settrace(None)
    torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    spans = stages()
    rows = {}
    for mode, prefix in (("WSPR", "WSPR"), ("Q65-30", "Q65")):
        rows.update(profile(mode, args.windows, {
            n: v for n, v in spans.items() if n.startswith(prefix)}, dev))
    for name, (ms, entered) in sorted(rows.items(),
                                      key=lambda kv: -kv[1][0]):
        code, a, b = spans[name]
        print(json.dumps({"stage": name, "ms": ms, "entered": entered,
                          "source": f"{Path(code.co_filename).name}:{a}-{b}",
                          "windows": args.windows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
