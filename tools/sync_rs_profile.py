"""Time the q-ary sync search (``qary_sync``) and the RS
errors-and-erasures decode (``rs_ee``) on one card, beside another
checkout's kernels.

    python3 tools/sync_rs_profile.py [--first-port OTHER_CHECKOUT]
                                     [--rounds N] [--recorded] [--out FILE]

``qary_sync``'s inputs: JT65's 15-window map [15, 1411, 2645] (the
decoder's device batch) and the App's 4-window maps, JT65 [4, 1411, 2645]
and Q65-30 [4, 921, 2420], of exponential noise with the zero pad rows
and a planted sync track, at each mode's top-24; with ``--recorded`` also
every map ``chip_smoke.record_qary_inputs`` records from the decoders.
``rs_ee``'s: the Chase trials of a JT65 device batch (15 windows of the
weak replay's JT65 bursts: 360 candidates x 256 trials), and the first 4
windows' share of them (the App's batch).  At each shape, in turns (this
checkout, the other, the other, this checkout; ``--rounds`` times): the
device time (``chip_smoke.cuda_ms``) of this checkout's kernel through its
wrapper and of ``OTHER_CHECKOUT``'s ``qary.cu`` and ``weak.cu`` built as
they are and run as their wrappers ran them (the first port's
``qary_sync`` with its zeroed counters), each held to the plain version
(top_val bit for bit and top_idx identical; corrected words and ok
identical); ``qary_sync``'s design (strips and lists a window, shared
memory, blocks an SM) and the bound
(``chip_smoke.qsync_bound_ms``, ``rs_bound_ms``) and the kernel's spans:
this file built with its ``QSYNC_SPAN`` hooks defined, the clock64()
cycles each warp spends in each phase (set-up, the correlation and its
waits for its copies, the wait at the barrier for the block's other
warps, the strip's selection, the list and the ticket, the window's
merge), averaged over the warps.  Registers and spills of both builds'
kernels.  Prints the card's name and power limit and one
JSON object (also written to ``--out``).  Needs one CUDA device and
``nvcc``.
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
from cwsl_digi_tpu_torch.modes import _qary_kernels as qk  # noqa: E402
from cwsl_digi_tpu_torch.modes import _weak_kernels as wk  # noqa: E402
from cwsl_digi_tpu_torch.modes import (jt65, q65, qary_engine,  # noqa: E402
                                       rs_device)

BUILD_DIR = HERE / "build" / "sync_rs_profile"
ATTR_NAMES = ("registers", "local_bytes", "static_smem_bytes",
              "max_threads")


SPAN_BLOCKS = 4096
SPAN_NAMES = {"QSYNC": ("set-up", "correlation", "selection",
                        "list and ticket", "merge", "correlation waits",
                        "wait for the block's warps"),
              "RS": ("set-up", "candidate syndromes", "locator",
                     "Berlekamp-Massey", "Omega", "evaluations and Forney",
                     "check and write")}
# the hooks of qary.cu (QSYNC_SPAN) and weak.cu (RS_SPAN): per block (the
# first SPAN_BLOCKS) and warp the cycles of each span, kept by each warp's
# first lane in shared memory and written out at the kernel's end
HOOKS = r"""
#include <cuda_runtime.h>
#define %(p)s_SPANS 1
__device__ unsigned long long span_acc[%(blocks)d * 8 * %(n)d];
__device__ __forceinline__ unsigned long long* span_state() {
    __shared__ unsigned long long st[8 * (%(n)d + 1)];
    return st + (threadIdx.x >> 5) * (%(n)d + 1);
}
__device__ __forceinline__ void span_begin() {
    if (threadIdx.x & 31) return;
    unsigned long long* st = span_state();
    for (int k = 0; k < %(n)d; ++k) st[1 + k] = 0;
    st[0] = clock64();
}
__device__ __forceinline__ void span_mark(int k) {
    if (threadIdx.x & 31) return;
    unsigned long long* st = span_state();
    const unsigned long long t = clock64();
    st[1 + k] += t - st[0];
    st[0] = t;
}
__device__ __forceinline__ void span_end() {
    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
    if ((threadIdx.x & 31) || b >= %(blocks)d) return;
    const unsigned long long* st = span_state();
    for (int k = 0; k < %(n)d; ++k)
        span_acc[(b * 8 + (threadIdx.x >> 5)) * %(n)d + k] = st[1 + k];
}
#define %(p)s_SPAN_BEGIN() span_begin()
#define %(p)s_SPAN(k) span_mark(k)
#define %(p)s_SPAN_END() span_end()
"""
READER = r"""
extern "C" int spans_read(void* acc) {
    return static_cast<int>(cudaMemcpyFromSymbol(acc, span_acc,
                                                 sizeof(span_acc)));
}
extern "C" int spans_clear() {
    static unsigned long long zero[%(blocks)d * 8 * %(n)d];
    return static_cast<int>(cudaMemcpyToSymbol(span_acc, zero,
                                               sizeof(zero)));
}
"""


def span_library(prefix: str, mod):
    """``mod``'s source built with its ``prefix``_SPAN hooks defined."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fill = {"p": prefix, "blocks": SPAN_BLOCKS,
            "n": len(SPAN_NAMES[prefix])}
    path = BUILD_DIR / f"{mod.SRC.stem}_spans.cu"
    path.write_text(HOOKS % fill + mod.SRC.read_text() + READER % fill)
    so, _ = kernel_build.build_library(path, BUILD_DIR,
                                       f"{mod.SRC.stem}_spans",
                                       mod.EXTRA_FLAGS)
    return ctypes.CDLL(str(so))


def read_spans(lib, prefix: str, fn) -> dict:
    """Each span's cycles a warp of one fn() launch on the hooked library:
    the mean over the warps of the first SPAN_BLOCKS blocks that ran (the
    merge's over the windows' last blocks, which alone run it)."""
    names = SPAN_NAMES[prefix]
    if lib.spans_clear():
        raise RuntimeError("spans_clear failed")
    fn()
    torch.cuda.synchronize()
    acc = np.zeros(SPAN_BLOCKS * 8 * len(names), np.uint64)
    if lib.spans_read(acc.ctypes.data):
        raise RuntimeError("spans_read failed")
    acc = acc.reshape(-1, len(names)).astype(np.float64)
    ran = acc[acc.sum(axis=1) > 0]
    out = {"warps": len(ran)}
    for i, name in enumerate(names):
        col = ran[:, i]
        if name == "merge":
            col = col[col > 0] if (col > 0).any() else col
        out[name] = float(col.mean())
    return out


def sync_spans(lib, spec, ps: torch.Tensor, base: torch.Tensor) -> dict:
    """``read_spans`` of one launch of the hooked qary.cu."""
    b, h, f = ps.shape
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    n_f0, k = fmax_bin - fmin_bin, spec.top_k
    plan = qk.sync_plan(n_f0, k)
    hops = qary_engine._sync_hops(tuple(spec.sync_syms), spec.os_t,
                                  ps.device)
    flat = base.reshape(-1).contiguous()
    cand_key = torch.empty((b, plan["lists"], k), dtype=torch.int64,
                           device=ps.device)
    cand_val = torch.empty((b, plan["lists"], k), dtype=torch.float32,
                           device=ps.device)
    top_val = torch.empty((b, k), dtype=torch.float32, device=ps.device)
    top_idx = torch.empty((b, k), dtype=torch.int64, device=ps.device)
    dims = (ctypes.c_int * 8)(b, h, f, spec.max_hops, n_f0,
                              len(spec.sync_syms), k, plan["lists"])

    def run():
        err = lib.qary_sync_launch(
            ctypes.addressof(dims), ps.data_ptr(), flat.data_ptr(),
            hops.data_ptr(), cand_key.data_ptr(), cand_val.data_ptr(),
            top_val.data_ptr(), top_idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"hooked qary_sync: CUDA error {err}")
    return read_spans(lib, "QSYNC", run)


def rs_spans(lib, nk_fcr, syms: torch.Tensor, era: torch.Tensor) -> dict:
    """``read_spans`` of one launch of the hooked weak.cu's rs_ee."""
    c, t, n = era.shape
    tables = rs_device.kernel_tables_device(nk_fcr, syms.device)
    corrected = torch.empty((c, t, n), dtype=torch.uint8, device=syms.device)
    ok = torch.empty((c, t), dtype=torch.bool, device=syms.device)
    dims = (ctypes.c_int * 4)(c, t, n, n - nk_fcr[1])

    def run():
        err = lib.rs_ee_launch(
            ctypes.addressof(dims), tables.data_ptr(), syms.data_ptr(),
            era.data_ptr(), corrected.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"hooked rs_ee: CUDA error {err}")
    return read_spans(lib, "RS", run)


def first_port(other: Path) -> dict:
    """The other checkout's qary.cu and weak.cu built as they are and
    bound."""
    p, i = ctypes.c_void_p, ctypes.c_int
    csrc = other / "cwsl_digi_tpu_torch" / "modes" / "csrc"
    out = {}
    for name, mod in (("qary", qk), ("weak", wk)):
        so, _ = kernel_build.build_library(csrc / f"{name}.cu", BUILD_DIR,
                                           f"{name}_first", mod.EXTRA_FLAGS)
        out[name] = ctypes.CDLL(str(so))
    out["qary"].qary_sync_launch.argtypes = [p] * 10
    out["qary"].qary_sync_launch.restype = i
    out["qary"].qary_kernel_attrs.argtypes = [i, p]
    out["qary"].qary_kernel_attrs.restype = i
    out["weak"].rs_ee_launch.argtypes = [p] * 7
    out["weak"].rs_ee_launch.restype = i
    out["weak"].weak_kernel_attrs.argtypes = [i, i, i, p]
    out["weak"].weak_kernel_attrs.restype = i
    return out


def first_sync(lib, spec, ps: torch.Tensor, base: torch.Tensor):
    """A call that runs the first port's qary_sync as its wrapper did (32
    bins a block, its scratch and zeroed counters allocated a call), and
    its outputs."""
    b, h, f = ps.shape
    fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
    n_f0, k = fmax_bin - fmin_bin, spec.top_k
    hops = qary_engine._sync_hops(tuple(spec.sync_syms), spec.os_t,
                                  ps.device)
    strips = -(-n_f0 // 32)
    top_val = torch.empty((b, k), dtype=torch.float32, device=ps.device)
    top_idx = torch.empty((b, k), dtype=torch.int64, device=ps.device)
    flat = base.reshape(-1).contiguous()
    dims = (ctypes.c_int * 7)(b, h, f, spec.max_hops, n_f0,
                              len(spec.sync_syms), k)

    def run():
        cand_key = torch.empty((b, strips, k), dtype=torch.int64,
                               device=ps.device)
        cand_val = torch.empty((b, strips, k), dtype=torch.float32,
                               device=ps.device)
        done = torch.zeros(b, dtype=torch.int32, device=ps.device)
        err = lib.qary_sync_launch(
            ctypes.addressof(dims), ps.data_ptr(), flat.data_ptr(),
            hops.data_ptr(), cand_key.data_ptr(), cand_val.data_ptr(),
            done.data_ptr(), top_val.data_ptr(), top_idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first port's qary_sync: CUDA error {err}")
    return run, (top_val, top_idx)


def first_rs(lib, nk_fcr, syms: torch.Tensor, era: torch.Tensor):
    """A call that runs the first port's rs_ee as its wrapper did, and its
    outputs."""
    c, t, n = era.shape
    tables = rs_device.kernel_tables_device(nk_fcr, syms.device)
    corrected = torch.empty((c, t, n), dtype=torch.uint8, device=syms.device)
    ok = torch.empty((c, t), dtype=torch.bool, device=syms.device)
    dims = (ctypes.c_int * 4)(c, t, n, n - nk_fcr[1])

    def run():
        err = lib.rs_ee_launch(
            ctypes.addressof(dims), tables.data_ptr(), syms.data_ptr(),
            era.data_ptr(), corrected.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first port's rs_ee: CUDA error {err}")
    return run, (corrected, ok)


def attrs_of(lib, which: int, weak: bool) -> dict:
    vals = (ctypes.c_int * 4)()
    err = (lib.weak_kernel_attrs(which, 512, 4, ctypes.addressof(vals))
           if weak else lib.qary_kernel_attrs(which, ctypes.addressof(vals)))
    if err:
        raise RuntimeError(f"kernel attributes: CUDA error {err}")
    return dict(zip(ATTR_NAMES, list(vals)))


def sync_map(spec, b: int, seed: int, dev) -> tuple:
    """[b, H, F] exponential noise with the decoders' zero pad rows and a
    sync track planted at (37, 100) of each window, and its base."""
    fmin_bin, fmax_bin, n_bins = qary_engine._bin_range(spec)
    n_hops = (int(spec.trperiod * 12_000) - spec.sps) // spec.hop + 1
    h = n_hops + 2 * spec.pad_hops
    g = torch.Generator(device=dev).manual_seed(seed)
    ps = torch.empty((b, h, n_bins), device=dev).exponential_(generator=g)
    ps[:, :spec.pad_hops] = 0.0
    ps[:, -spec.pad_hops:] = 0.0
    for s in spec.sync_syms:
        ps[:, spec.os_t * s + 37, 100] += 20.0
    base = ps.mean(dim=(1, 2), keepdim=True) * len(spec.sync_syms)
    return ps, base


def jt65_trials(dev) -> tuple:
    """The Chase trials of a JT65 device batch of the weak replay's
    bursts: (nk_fcr, syms [C, n], era [C, T, n])."""
    rec = []
    trials = rs_device.rs_ee_trials

    def keep(nk_fcr, syms, era):
        rec.append((nk_fcr, syms.clone(), era.clone()))
        return trials(nk_fcr, syms, era)

    rs_device.rs_ee_trials = keep
    try:
        jd = jt65.JT65Decoder(device=dev, fmax_hz=3000.0)
        audio = torch.from_numpy(chip_smoke._weak_windows(
            "JT65", jd.max_device_batch, chip_smoke.SEED + 61)).to(dev)
        jd.decode(audio)
    finally:
        rs_device.rs_ee_trials = trials
    return rec[0]


def turns(kept, other, reps: int, rounds: int) -> dict:
    out: dict[str, list] = {"kept": [], "first port": []}
    for _ in range(rounds):
        for turn in ("kept", "first port", "first port", "kept"):
            fn = kept if turn == "kept" else other
            if fn is not None:
                out[turn].append(chip_smoke.cuda_ms(fn, reps))
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-port", type=Path, default=None,
                    help="another checkout whose kernels are timed beside")
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns of (this, other, other, this) a shape")
    ap.add_argument("--recorded", action="store_true",
                    help="also the maps the decoders hand qary_sync")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    first = first_port(a.first_port) if a.first_port is not None else None
    spans = span_library("QSYNC", qk)
    spans.qary_sync_launch.argtypes = [ctypes.c_void_p] * 9
    spans.qary_sync_launch.restype = ctypes.c_int
    rs_hooked = span_library("RS", wk)
    rs_hooked.rs_ee_launch.argtypes = [ctypes.c_void_p] * 7
    rs_hooked.rs_ee_launch.restype = ctypes.c_int
    out: dict = {"card": card, "qary_sync": {}, "rs_ee": {}}

    maps = {"JT65 bench": (jt65.SPEC, *sync_map(jt65.SPEC, 15, 1, dev)),
            "JT65 app": (jt65.SPEC, *sync_map(jt65.SPEC, 4, 2, dev)),
            "Q65-30 app": (q65.SPEC, *sync_map(q65.SPEC, 4, 3, dev))}
    if a.recorded:
        rec = chip_smoke.record_qary_inputs(dev)
        for name, spec, ps, base in rec["sync"]:
            maps.setdefault(f"{name} recorded {list(ps.shape)}",
                            (spec, ps, base))
    for name, (spec, ps, base) in maps.items():
        fmin_bin, fmax_bin, _ = qary_engine._bin_range(spec)
        n_f0 = fmax_bin - fmin_bin
        want = qary_engine._qary_sync_plain(spec, ps, base)
        plan = qk.sync_plan(n_f0, spec.top_k)
        chk = chip_smoke.qsync_vs_plain(spec, ps, base)
        if not chk["ok"]:
            raise AssertionError(f"{name}: {chk}")
        row: dict = {"shape": list(ps.shape), "top_k": spec.top_k,
                     "bound_ms": max(chip_smoke.qsync_bound_ms(spec,
                                                               ps)[:2]),
                     "plan": {**plan, **qk.sync_occupancy(
                         dev, spec.top_k, plan["lists"])},
                     "spans": sync_spans(spans, spec, ps, base)}
        kept = lambda: qary_engine._qary_sync(spec, ps, base)  # noqa: E731
        other = None
        if first is not None:
            other, got = first_sync(first["qary"], spec, ps, base)
            other()
            torch.cuda.synchronize()
            row["first_port_differ"] = (
                chip_smoke._floats_differ(got[0], want[0])
                + int((got[1] != want[1]).sum()))
        row["ms_turns"] = turns(kept, other, 5, a.rounds)
        out["qary_sync"][name] = row
        print(f"qary_sync {name}: {json.dumps(row)}", flush=True)

    nk_fcr, syms, era = jt65_trials(dev)
    app_c = syms.shape[0] * 4 // 15
    for name, (s_, e_) in {"JT65 bench": (syms, era),
                           "JT65 app": (syms[:app_c].contiguous(),
                                        era[:app_c].contiguous())}.items():
        chk = chip_smoke.rs_vs_plain(nk_fcr, s_, e_)
        if not chk["ok"]:
            raise AssertionError(f"rs_ee {name}: {chk}")
        tables = rs_device.kernel_tables_device(nk_fcr, dev)
        nroots = nk_fcr[0] - nk_fcr[1]
        got = wk.rs_ee(tables, s_, e_, nroots)
        b_bytes, b_ops, counts = chip_smoke.rs_bound_ms(nk_fcr, s_, e_,
                                                        got[0])
        row = {"trials": list(e_.shape), "bound_ms": max(b_bytes, b_ops),
               "counts": counts,
               "shared_loads": chip_smoke.rs_shared_loads(nk_fcr, s_, e_,
                                                          got[0])}
        kept = lambda: wk.rs_ee(tables, s_, e_, nroots)  # noqa: E731
        other = None
        if first is not None:
            other, f_got = first_rs(first["weak"], nk_fcr, s_, e_)
            other()
            torch.cuda.synchronize()
            want = rs_device.rs_ee_trials_plain(nk_fcr, s_, e_)
            row["first_port_differ"] = (
                int((f_got[0] != want[0]).any(-1).sum())
                + int((f_got[1] != want[1]).sum()))
        row["ms_turns"] = turns(kept, other, 5, a.rounds)
        row["spans"] = rs_spans(rs_hooked, nk_fcr, s_, e_)
        out["rs_ee"][name] = row
        print(f"rs_ee {name}: {json.dumps(row)}", flush=True)

    out["attrs"] = {**qk.kernel_attrs(dev),
                    "rs_ee": wk.kernel_attrs(dev)["rs_ee"],
                    "rs_ee_blocks_an_sm": wk.rs_blocks_per_sm(dev)}
    if first is not None:
        out["first_port_attrs"] = {
            "qary_sync": attrs_of(first["qary"], 1, False),
            "rs_ee": attrs_of(first["weak"], 1, True)}
    bad = [k for part in ("qary_sync", "rs_ee") for k, v in out[part].items()
           if v.get("first_port_differ")]
    print(json.dumps(out))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    if bad:
        raise AssertionError(f"the first port differs from the plain "
                             f"version at {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
