"""Time WSPR's beam search (``wspr_beam``) on one card at the three shapes
the port runs it at, beside another checkout's kernel.

    python3 tools/wspr_beam_profile.py [--first-port OTHER_CHECKOUT]
                                       [--rounds N] [--out FILE]

The inputs are the LLRs a WSPR decode hands the kernel
(``chip_smoke.record_weak_inputs``: 24 windows of the smoke's weak replay,
576 candidates at width 512, and 768 at width 1024 with ``cycles >=
10000``) and the first 48 of the 576, the App's launch (2 windows x
top-24).  At each shape, in turns (this checkout, the other, the other,
this checkout; ``--rounds`` times): the device time (``chip_smoke.
cuda_ms``) of this checkout's kernel in the plan its wrapper picks and of
``OTHER_CHECKOUT/cwsl_digi_tpu_torch/modes/csrc/weak.cu`` built as it is
(its one-block-of-W-threads launch); then every plan of this checkout's
kernel.  Both kernels' bits and raw metrics are held to each other bit for
bit (two NaNs count as equal).  For each kernel: registers, spills,
dynamic shared memory, blocks an SM (``cudaOccupancyMaxActiveBlocks...``,
or for the other checkout's library the least of its shared-memory,
register and thread limits), the static SASS counts of its instances
(``cuobjdump -sass``: SHFL, BAR, LDS, STS and the total), and the
dependent steps a trellis step (``chip_smoke.beam_steps``; the first
port's two bitonic sorts of 2W keys in shared memory).  Prints the card's
name and power limit and one JSON object (also written to ``--out``).
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE)]
import chip_smoke  # noqa: E402
from cwsl_digi_tpu_torch import kernel_build  # noqa: E402
from cwsl_digi_tpu_torch.modes import _weak_kernels as wk  # noqa: E402

BUILD_DIR = HERE / "build" / "wspr_beam_profile"


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction counts of each k_wspr_beam instance of the
    library, by mangled name: SHFL, BAR, LDS, STS and the total."""
    tool = shutil.which("cuobjdump") or str(
        Path(kernel_build.nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts: dict[str, Counter] = {}
    name = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name = fn if "k_wspr_beam" in fn else None
            if name:
                counts[name] = Counter()
            continue
        hit = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                        line)
        if name and hit:
            counts[name][hit.group(1)] += 1
    return {fn: {**{k: c[k] for k in ("SHFL", "BAR", "LDS", "STS")},
                 "total": sum(c.values())} for fn, c in counts.items()}


def first_port(other: Path):
    """The other checkout's weak.cu built as it is and bound: (library,
    shared object)."""
    src = other / "cwsl_digi_tpu_torch" / "modes" / "csrc" / "weak.cu"
    so, _ = kernel_build.build_library(src, BUILD_DIR, "weak_first",
                                       wk.EXTRA_FLAGS)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wspr_beam_launch.argtypes = [i, i, p, p, p, p]
    lib.wspr_beam_launch.restype = i
    lib.wspr_beam_smem_bytes.argtypes = [i]
    lib.wspr_beam_smem_bytes.restype = i
    lib.weak_kernel_attrs.argtypes = [i, i, p]
    lib.weak_kernel_attrs.restype = i
    return lib, so


def first_launcher(lib, llr: torch.Tensor, w: int):
    """A call that launches the other checkout's beam search on ``llr``
    at width ``w``, and its (best, bits) outputs."""
    n = llr.shape[0]
    best = torch.empty(n, dtype=torch.float32, device=llr.device)
    bits = torch.empty((n, wk.BEAM_MSG_BITS), dtype=torch.int8,
                       device=llr.device)

    def run():
        err = lib.wspr_beam_launch(
            n, w, llr.data_ptr(), best.data_ptr(), bits.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first port's wspr_beam: CUDA error {err}")
    return run, (best, bits)


def first_design(lib, w: int) -> dict:
    vals = (ctypes.c_int * 4)()
    if lib.weak_kernel_attrs(0, w, ctypes.addressof(vals)):
        raise RuntimeError("first port's weak_kernel_attrs failed")
    a = dict(zip(("registers", "local_bytes", "static_smem_bytes",
                  "max_threads"), list(vals)))
    smem = lib.wspr_beam_smem_bytes(w)
    blocks = min(233_472 // (smem + a["static_smem_bytes"] + 1024),
                 65_536 // (a["registers"] * w), 2048 // w, 32)
    lg = (2 * w).bit_length() - 1
    stages = lg * (lg + 1) // 2
    block = max(1, sum(max(0, q - 5) for q in range(1, lg + 1)))
    return {"threads": w, "smem_bytes": smem, "blocks_an_sm": blocks,
            "registers": a["registers"], "local_bytes": a["local_bytes"],
            "dependent_steps": {"stages_a_step": 2 * stages,
                                "block_barriers_a_step": 2 * block + 5}}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-port", type=Path, default=None,
                    help="another checkout whose wspr_beam is timed beside")
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns of (this, other, other, this) a shape")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    rec = chip_smoke.record_weak_inputs(dev)
    llr512 = rec["beam"][0][1]
    llr1024 = next(x for cfg, x in rec["beam"] if cfg.beam_width == 1024)
    shapes = {"app": (llr512[:chip_smoke.APP_BEAM_CANDIDATES].clone(), 512),
              "bench": (llr512, 512), "w1024": (llr1024, 1024)}
    out: dict = {"card": card, "shapes": {}}
    first = first_port(a.first_port) if a.first_port is not None else None
    for name, (llr, w) in shapes.items():
        n = llr.shape[0]
        reps = 3 if n < 100 else 2
        design = chip_smoke.beam_design(dev, n, w)
        plan = design["plan"]
        row: dict = {"shape": list(llr.shape), "beam_width": w,
                     "plan": plan, "design": design["plans"],
                     "dependent_steps": chip_smoke.beam_steps(w, plan),
                     "bound_ms": max(chip_smoke.beam_bound_ms(n, w)[:2])}
        kept = lambda: wk.wspr_beam(llr, w)  # noqa: E731
        turns: dict[str, list] = {"kept": [], "first port": []}
        if first is not None:
            run, (f_best, f_bits) = first_launcher(first[0], llr, w)
            run()
            best, bits = kept()
            torch.cuda.synchronize()
            row["first_port_bits_differ"] = chip_smoke._bits_differ(
                bits, f_bits.cpu())
            row["first_port_metric_bits_differ"] = chip_smoke._bits_differ(
                best, f_best.cpu())
            row["first_port_design"] = first_design(first[0], w)
            if row["first_port_bits_differ"] or \
                    row["first_port_metric_bits_differ"]:
                raise AssertionError(f"{name}: the kernels differ: {row}")
            for _ in range(a.rounds):
                for turn in ("kept", "first port", "first port", "kept"):
                    fn = kept if turn == "kept" else run
                    turns[turn].append(chip_smoke.cuda_ms(fn, reps))
        else:
            turns["kept"].append(chip_smoke.cuda_ms(kept, reps))
        row["ms_turns"] = turns
        row["ms_by_plan"] = {
            keys: chip_smoke.cuda_ms(
                lambda: wk.wspr_beam(llr, w, keys=keys), reps)
            for keys in wk.BEAM_PLANS[w]}
        out["shapes"][name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    out["sass"] = sass_counts(wk.build_library())
    if first is not None:
        out["first_port_sass"] = sass_counts(first[1])
    print(json.dumps(out))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
