"""Time the q-ary tone gather with its top-4 (``qary_symbols``) and JT65's
Chase soft score (``chase_score``) on one card, beside another checkout's
kernels.

    python3 tools/qary_chase_profile.py [--first-port OTHER_CHECKOUT]
                                        [--rounds N] [--out FILE]

The inputs are the decoders' own, recorded from the App's 64-window JT65
and Q65-30 decodes of the weak replay's bursts
(``chip_smoke.record_decode_inputs``): ``qary_symbols`` at JT65's
15-window device batch and Q65-30's 30 windows (the 64 energies written),
``chase_score`` at the 1,024- and 512-candidate chunks of 256 trials.  At
each shape, in turns (this checkout, the other, the other, this checkout;
``--rounds`` times): the device time (``chip_smoke.cuda_ms``, inputs warm
in L2) of this checkout's kernel through its wrapper and of
``OTHER_CHECKOUT``'s ``qary.cu`` and ``chase.cu`` built as they are and
run as their wrappers ran them, each held to the plain version
(``qary_symbols`` bit for bit, NaN equal to NaN; ``chase_score``'s info
and ok identical and its score within ``chip_smoke.SCORE_TOL``); beside
them this checkout's kernels with one design choice changed
(``VARIANTS``: ``qary_symbols`` at 4, 16 and 32 lanes a row, ``chase_score``
with deeper rings, and diagnostics that leave a phase out), and each
kernel's time with L2 flushed before every launch (a 96 MB write, whose
own time is taken off).  Also the bound (``chip_smoke.symbols_bound_ms``,
``score_bound_ms``), the layouts (``qary_symbols``' rows a warp, blocks an
SM and grid; ``chase_score``'s stage, ring, shared bytes, blocks an SM and
which copy path it took) and the registers and spills of both builds'
kernels.  Prints the card's name and power limit and one JSON object
(also written to ``--out``).  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE)]
import chip_smoke  # noqa: E402
from cwsl_digi_tpu_torch import kernel_build  # noqa: E402
from cwsl_digi_tpu_torch.modes import _chase_kernels as ck  # noqa: E402
from cwsl_digi_tpu_torch.modes import _qary_kernels as qk  # noqa: E402
from cwsl_digi_tpu_torch.modes import qary_engine, rs_device  # noqa: E402

BUILD_DIR = HERE / "build" / "qary_chase_profile"
ATTR_NAMES = ("registers", "local_bytes", "static_smem_bytes",
              "max_threads")
FLUSH_BYTES = 96 << 20           # written before each cold launch
# this checkout's kernels with one design choice changed: (source, [(the
# text as kept, the text in the variant)], exact).  A variant that is not
# exact (a diagnostic: a phase left out) is timed but not held to the plain
# version.
VARIANTS = {
    "chase_score ring of 3": (
        "chase.cu", [("constexpr int SC_RING = 2;",
                      "constexpr int SC_RING = 3;")], True),
    "chase_score ring of 4": (
        "chase.cu", [("constexpr int SC_RING = 2;",
                      "constexpr int SC_RING = 4;")], True),
    "chase_score without the symbols' work (diagnostic)": (
        "chase.cu", [("for (int k = 0; k < SC_SPAN / 4; ++k) {\n"
                      "            const uint32_t cw =",
                      "for (int k = 0; k < 0; ++k) {\n"
                      "            const uint32_t cw =")], False),
    "chase_score one table entry a symbol (diagnostic)": (
        "chase.cu", [("lut[(4 * k + j) * SC_LUT + ((cw >> (8 * j)) & 63u)]",
                      "lut[(4 * k + j) * SC_LUT]")], False),
    "chase_score without the erased sums (diagnostic)": (
        "chase.cu", [("eacc[j] += (nz >> (8 * j + 7)) & 1u ? term[j] : 0.0f;",
                      ";")], False),
    "qary_symbols 4 lanes a row": (
        "qary.cu", [("constexpr int SYM_GROUP = 8;",
                     "constexpr int SYM_GROUP = 4;"),
                    ("constexpr int SYM_MIN_BLOCKS = 6;",
                     "constexpr int SYM_MIN_BLOCKS = 4;")], True),
    "qary_symbols 16 lanes a row": (
        "qary.cu", [("constexpr int SYM_GROUP = 8;",
                     "constexpr int SYM_GROUP = 16;")], True),
    "qary_symbols 32 lanes a row": (
        "qary.cu", [("constexpr int SYM_GROUP = 8;",
                     "constexpr int SYM_GROUP = 32;")], True),
    "qary_symbols no register cap": (
        "qary.cu", [("constexpr int SYM_MIN_BLOCKS = 6;",
                     "constexpr int SYM_MIN_BLOCKS = 1;")], True),
    "qary_symbols without the group merge (diagnostic)": (
        "qary.cu", [("        for (int off = G / 2; off > 0; off >>= 1) {\n"
                     "            u64 other[4];",
                     "        for (int off = 0; off > 0; off >>= 1) {\n"
                     "            u64 other[4];")], False),
    "qary_symbols without the map's loads (diagnostic)": (
        "qary.cu", [("v[j] = __ldg(p + stride * j);",
                     "v[j] = static_cast<float>(j + sub);")], False)}


def bind(out: dict) -> dict:
    """Argument types of the entries the tool calls in libraries
    {"qary": ..., "chase": ...} (either may be missing)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if "qary" in out:
        out["qary"].qary_symbols_launch.argtypes = [p] * 11
        out["qary"].qary_symbols_launch.restype = i
        out["qary"].qary_kernel_attrs.argtypes = [i, p]
        out["qary"].qary_kernel_attrs.restype = i
    if "chase" in out:
        out["chase"].chase_score_launch.argtypes = [p, ctypes.c_float,
                                                    ctypes.c_float] + [p] * 11
        out["chase"].chase_score_launch.restype = i
        out["chase"].chase_kernel_attrs.argtypes = [i, p]
        out["chase"].chase_kernel_attrs.restype = i
    return out


def variant(name: str) -> dict:
    """This checkout's library with VARIANTS[name]'s changes, built and
    bound, and its ptxas report."""
    src, changes, _exact = VARIANTS[name]
    mod = qk if src == "qary.cu" else ck
    text = mod.SRC.read_text()
    for kept, new in changes:
        if text.count(kept) != 1:
            raise RuntimeError(f"{name}: {kept!r} not once in {src}")
        text = text.replace(kept, new)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    path = BUILD_DIR / f"{tag}.cu"
    path.write_text(text)
    so, log = kernel_build.build_library(path, BUILD_DIR, tag,
                                         mod.EXTRA_FLAGS)
    key = "qary" if src == "qary.cu" else "chase"
    return {**bind({key: ctypes.CDLL(str(so))}), "log": log or ""}


def first_port(other: Path) -> dict:
    """The other checkout's qary.cu and chase.cu built as they are and
    bound (its qary_symbols takes ten dims)."""
    csrc = other / "cwsl_digi_tpu_torch" / "modes" / "csrc"
    out = {}
    for name, mod in (("qary", qk), ("chase", ck)):
        so, _ = kernel_build.build_library(csrc / f"{name}.cu", BUILD_DIR,
                                           f"{name}_first", mod.EXTRA_FLAGS)
        out[name] = ctypes.CDLL(str(so))
    return bind(out)


def lib_symbols(lib, spec, power, t0, f0):
    """A call that runs a library's qary_symbols as its wrapper did, and
    its outputs."""
    b, h, f = power.shape
    k, dev = t0.shape[1], power.device
    n = len(spec.data_syms)
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    rows = qary_engine._sym_rows(tuple(spec.data_syms), spec.os_t, dev)
    e = torch.empty((b, k, n, 64) if spec.full_e else (1,),
                    dtype=torch.float32, device=dev)
    top_e = torch.empty((b, k, n, 4), dtype=torch.float32, device=dev)
    top_tone = torch.empty((b, k, n, 4), dtype=torch.int64, device=dev)
    e_sum = torch.empty((b, k, n), dtype=torch.float32, device=dev)
    margin = torch.empty((b, k, n), dtype=torch.float32, device=dev)
    dims = (ctypes.c_int * 10)(b, h, f, k, n, spec.max_hops,
                               fmax_bin - fmin_bin, spec.os_f,
                               spec.os_f * spec.tone_offset,
                               int(spec.full_e))

    def run():
        err = lib.qary_symbols_launch(
            ctypes.addressof(dims), power.data_ptr(), t0.data_ptr(),
            f0.data_ptr(), rows.data_ptr(), e.data_ptr(), top_e.data_ptr(),
            top_tone.data_ptr(), e_sum.data_ptr(), margin.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"qary_symbols: CUDA error {err}")
    return run, (e if spec.full_e else None, top_e, top_tone, e_sum, margin)


def lib_score(lib, args):
    """A call that runs a library's chase_score as its wrapper did, and
    its (info, best_score, best_ok) outputs."""
    k, accept, corrected, ok, era, top_e, top_tone, e_sum = args
    c, t, n = corrected.shape
    dev = corrected.device
    info = torch.empty((c, k), dtype=torch.int64, device=dev)
    best_score = torch.empty(c, dtype=torch.float32, device=dev)
    best_ok = torch.empty(c, dtype=torch.bool, device=dev)
    best_trial = torch.empty(c, dtype=torch.int64, device=dev)
    dims = (ctypes.c_int * 4)(c, t, n, k)

    def run():
        err = lib.chase_score_launch(
            ctypes.addressof(dims), float(np.float32(accept)),
            float(np.float32(0.6 * accept)), corrected.data_ptr(),
            ok.data_ptr(), era.data_ptr(), top_e.data_ptr(),
            top_tone.data_ptr(), e_sum.data_ptr(), info.data_ptr(),
            best_score.data_ptr(), best_ok.data_ptr(), best_trial.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"chase_score: CUDA error {err}")
    return run, (info, best_score, best_ok)


def symbols_differ(got, want) -> int:
    return sum((chip_smoke._floats_differ(a, b) if a.is_floating_point()
                else int((a != b).sum()))
               for a, b in zip(got, want) if a is not None)


def score_differ(got, want) -> dict:
    info, score, best_ok = got
    p_info, p_score, p_ok = want
    fin = torch.isfinite(p_score)
    err = float((score - p_score).abs()[fin].max()) if fin.any() else 0.0
    out = {"info_rows_differ": int((info != p_info).any(dim=1).sum()),
           "ok_differ": int((best_ok != p_ok).sum()),
           "finite_differ": int((torch.isfinite(score) != fin).sum()),
           "max_abs_err": err}
    out["ok"] = (out["info_rows_differ"] == 0 and out["ok_differ"] == 0
                 and out["finite_differ"] == 0
                 and err <= chip_smoke.SCORE_TOL)
    return out


def attrs_of(lib, fn: str, which: int) -> dict:
    vals = (ctypes.c_int * 4)()
    if getattr(lib, fn)(which, ctypes.addressof(vals)):
        raise RuntimeError(f"{fn}({which}) failed")
    return dict(zip(ATTR_NAMES, list(vals)))


def turns(runs: dict, reps: int, rounds: int) -> dict:
    """Each run's device times in turns: kept, first port, first port,
    kept; the others after each turn."""
    out: dict[str, list] = {name: [] for name in runs}
    order = ["kept", "first port", "first port", "kept"]
    for _ in range(rounds):
        for turn in order + [n for n in runs if n not in order]:
            if turn in runs:
                out[turn].append(chip_smoke.cuda_ms(runs[turn], reps))
    return out


def cold_ms(fn, flush_buf: torch.Tensor, reps: int) -> float:
    """Device time of fn() with L2 written over before each launch: a
    graph of (flush, fn) less one of the flush alone."""
    def flushed():
        flush_buf.fill_(1)
        fn()
    return (chip_smoke.cuda_ms(flushed, reps)
            - chip_smoke.cuda_ms(lambda: flush_buf.fill_(1), reps))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-port", type=Path, default=None,
                    help="another checkout whose kernels are timed beside")
    ap.add_argument("--rounds", type=int, default=2,
                    help="turns of (this, other, other, this) a shape")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    first = first_port(a.first_port) if a.first_port is not None else None
    variants = {name: variant(name) for name in VARIANTS}
    rec = chip_smoke.record_decode_inputs(dev)
    flush_buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)
    out: dict = {"card": card, "qary_symbols": {}, "chase_score": {}}

    for mode in ("JT65", "Q65-30"):
        _, spec, power, t0, f0, ds = next(r for r in rec["symbols"]
                                          if r[0] == mode)
        want = qary_engine._symbol_energies_plain(spec, power, t0, f0, ds)
        row: dict = {"shape": list(power.shape),
                     "candidates": list(t0.shape),
                     "bound": chip_smoke.symbols_bound_ms(spec, t0),
                     "design": qk.symbols_design(dev), "differ": {}}

        def kept(spec=spec, power=power, t0=t0, f0=f0, ds=ds):
            return qary_engine._symbol_energies(spec, power, t0, f0, ds)
        runs = {"kept": kept}
        row["differ"]["kept"] = symbols_differ(kept(), want)
        libs = {name: v["qary"] for name, v in variants.items()
                if "qary" in v}
        if first is not None:
            libs["first port"] = first["qary"]
        for name, lib in libs.items():
            runs[name], got = lib_symbols(lib, spec, power, t0, f0)
            runs[name]()
            torch.cuda.synchronize()
            row["differ"][name] = symbols_differ(got, want)
        row["ms_turns"] = turns(runs, 5, a.rounds)
        row["cold_ms"] = {name: cold_ms(fn, flush_buf, 5)
                          for name, fn in runs.items()
                          if name in ("kept", "first port")}
        out["qary_symbols"][mode] = row
        print(f"qary_symbols {mode}: {json.dumps(row)}", flush=True)

    for name, args in (("1,024 candidates", rec["score"][0]),
                       ("512 candidates", rec["score"][-1])):
        k, accept, corrected, ok, era, top_e, top_tone, e_sum = args
        want = rs_device.chase_score_plain(*args)
        runs = {"kept": lambda args=args: rs_device.chase_score(*args)}
        row = {"shape": list(corrected.shape),
               "bound": chip_smoke.score_bound_ms(args),
               "design": {**ck.score_design(dev, corrected.shape[1],
                                            corrected.shape[2]),
                          "tma_path": ck.score_bulk(corrected, era)},
               "differ": {"kept": score_differ(runs["kept"](), want)}}
        libs = {name: v["chase"] for name, v in variants.items()
                if "chase" in v}
        if first is not None:
            libs["first port"] = first["chase"]
        for n, lib in libs.items():
            runs[n], got = lib_score(lib, args)
            runs[n]()
            torch.cuda.synchronize()
            row["differ"][n] = score_differ(got, want)
        row["ms_turns"] = turns(runs, 5, a.rounds)
        row["cold_ms"] = {n: cold_ms(fn, flush_buf, 5)
                          for n, fn in runs.items()
                          if n in ("kept", "first port")}
        out["chase_score"][name] = row
        print(f"chase_score {name}: {json.dumps(row)}", flush=True)

    out["attrs"] = {"qary_symbols": qk.kernel_attrs(dev)["qary_symbols"],
                    "chase_score": ck.kernel_attrs(dev)["chase_score"]}
    if first is not None:
        out["first_port_attrs"] = {
            "qary_symbols": attrs_of(first["qary"], "qary_kernel_attrs", 2),
            "chase_score": attrs_of(first["chase"], "chase_kernel_attrs", 1)}
    out["variant_attrs"] = {
        name: (attrs_of(v["qary"], "qary_kernel_attrs", 2) if "qary" in v
               else attrs_of(v["chase"], "chase_kernel_attrs", 1))
        for name, v in variants.items()}
    exact = {n for n, v in VARIANTS.items() if v[2]} | {
        "kept", "first port"}
    bad = [f"qary_symbols {m} {k}" for m, r in out["qary_symbols"].items()
           for k, v in r["differ"].items() if v and k in exact] + [
          f"chase_score {m} {k}" for m, r in out["chase_score"].items()
          for k, v in r["differ"].items() if not v["ok"] and k in exact]
    out["disagree"] = bad
    print(json.dumps(out))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    if bad:
        raise AssertionError(f"disagree with the plain versions: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
