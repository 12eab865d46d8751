"""Time the exact row median (``median_rows``) on one card at the shapes the
port runs it at, beside another checkout's kernel.

    python3 tools/median_profile.py [--first-port OTHER_CHECKOUT]
                                    [--rounds N] [--out FILE]

The inputs are the rows the decoders hand the kernel
(``chip_smoke.record_qary_inputs``: Q65-30's priors and sync maps of a
64-window decode, JT65's sync maps, WSPR's map of 24 windows, the FT8
decode's SNR rows of 24 busy windows, contiguous and as the strided
``[:, ::4, ::4]`` view of its power map the decoder passes).  At each
shape, in turns (this checkout, the other, the
other, this checkout; ``--rounds`` times): the device time
(``chip_smoke.cuda_ms``) of this checkout's kernel in the plan its wrapper
picks and of ``OTHER_CHECKOUT/cwsl_digi_tpu_torch/modes/csrc/median.cu``
built as it is (its three launches on a zeroed workspace, the zeroing
timed with it, as its wrapper ran it; on a contiguous copy of a strided
view, the copy timed with it), both held to the plain median bit for bit
(two NaNs count as equal); then every other plan and cluster size of this
checkout's kernel, and the bound.  Per shape it prints the plan's design
(threads, shared memory, blocks an SM and clusters the card holds, from
``cudaOccupancy...``), the device time of each of the large plan's three
kernels (``torch.profiler``), what share of a large row lies between the
sample's keys and in the middle ranks' first 11-, 12- and 13-bit digits,
and the kernels' spans: this file built with its ``MEDIAN_SPAN`` hooks
defined, the clock64() cycles each warp spends in each phase (the set-up
or load, then the selection's counting, merging, picking and last sweep,
the rest) averaged over the first blocks.  Registers and spills of every
kernel of both builds.  Prints the card's name and power limit and one
JSON object (also written to ``--out``).  Needs one CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE)]
import chip_smoke  # noqa: E402
from cwsl_digi_tpu_torch import kernel_build  # noqa: E402
from cwsl_digi_tpu_torch.modes import _median_kernels as mk  # noqa: E402
from cwsl_digi_tpu_torch.modes import gfsk_engine  # noqa: E402

BUILD_DIR = HERE / "build" / "median_profile"
SPAN_NAMES = ("set-up or load", "count", "merge", "pick", "last sweep",
              "rest")
SPAN_BLOCKS = 64
KERNEL_IDS = {"onchip_small": 0, "onchip_mid": 1, "large_sample": 2,
              "large_stream": 3, "large_finish": 4}

# the hooks of median.cu: per kernel, block and warp the cycles of each
# span (the first SPAN_BLOCKS blocks of a launch), kept by each warp's
# first lane in shared memory (the spans close inside device functions)
# and written out at the kernel's end
HOOKS = r"""
#include <cuda_runtime.h>
#define MEDIAN_SPANS 1
__device__ unsigned long long med_span_acc[5 * %(blocks)d * 32 * 6];
// a warp's last clock, its kernel's id and its six spans
__device__ __forceinline__ unsigned long long* med_span_state() {
    __shared__ unsigned long long st[32 * 8];
    return st + (threadIdx.x >> 5) * 8;
}
__device__ __forceinline__ void med_span_begin(int id) {
    if (threadIdx.x & 31) return;
    unsigned long long* st = med_span_state();
    st[1] = id;
    for (int k = 0; k < 6; ++k) st[2 + k] = 0;
    st[0] = clock64();
}
__device__ __forceinline__ void med_span(int k) {
    if (threadIdx.x & 31) return;
    unsigned long long* st = med_span_state();
    const unsigned long long t = clock64();
    st[2 + k] += t - st[0];
    st[0] = t;
}
__device__ __forceinline__ void med_span_end() {
    med_span(5);
    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
    if ((threadIdx.x & 31) || b >= %(blocks)d) return;
    const unsigned long long* st = med_span_state();
    for (int k = 0; k < 6; ++k)
        med_span_acc[((st[1] * %(blocks)d + b) * 32 + (threadIdx.x >> 5))
                     * 6 + k] = st[2 + k];
}
#define MEDIAN_SPAN_BEGIN(id) med_span_begin(id)
#define MEDIAN_SPAN(k) med_span(k)
#define MEDIAN_SPAN_END() med_span_end()
"""
READER = r"""
extern "C" int median_spans_read(void* acc) {
    return static_cast<int>(cudaMemcpyFromSymbol(acc, med_span_acc,
                                                 sizeof(med_span_acc)));
}
extern "C" int median_spans_clear() {
    static unsigned long long zero[5 * %(blocks)d * 32 * 6];
    return static_cast<int>(cudaMemcpyToSymbol(med_span_acc, zero,
                                               sizeof(zero)));
}
"""


def span_source() -> Path:
    """median.cu with the hooks defined."""
    hooked = (HOOKS % {"blocks": SPAN_BLOCKS} + mk.SRC.read_text()
              + READER % {"blocks": SPAN_BLOCKS})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "median_spans.cu"
    path.write_text(hooked)
    return path


def bind(lib) -> None:
    """The argument types of median.cu's entries on a library of it."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.median_onchip_launch.argtypes = [ll, ll, i, i, ll, ll, ll, i, i, i,
                                         i, p, p, p]
    lib.median_large_launch.argtypes = [ll, ll, ll, ll, p, p, p, p, p]


def spans_of(lib, fn) -> dict:
    """Each kernel's spans (cycles a warp, averaged over the warps of the
    first blocks that ran) of one fn() call on the hooked library."""
    if lib.median_spans_clear():
        raise RuntimeError("median_spans_clear failed")
    fn()
    torch.cuda.synchronize()
    acc = np.zeros(5 * SPAN_BLOCKS * 32 * 6, np.uint64)
    if lib.median_spans_read(acc.ctypes.data):
        raise RuntimeError("median_spans_read failed")
    acc = acc.reshape(5, SPAN_BLOCKS * 32, 6).astype(np.float64)
    out = {}
    for name, kid in KERNEL_IDS.items():
        ran = acc[kid][acc[kid].sum(axis=1) > 0]
        if len(ran):
            out[name] = {"warps": len(ran),
                         **{s: float(v) for s, v in
                            zip(SPAN_NAMES, ran.mean(axis=0))}}
    return out


def hooked_launcher(lib, x: torch.Tensor, plan: dict):
    """A call that launches the hooked library's kernel on x in ``plan``
    (the wrapper's own plan)."""
    r, n = x.shape[0], x[0].numel()
    out = torch.empty(r, dtype=torch.float32, device=x.device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if plan["plan"] == "large":
        ws = torch.empty((r, mk.WS_WORDS), dtype=torch.int32,
                         device=x.device)
        buf = torch.empty((r, plan["cap"]), dtype=torch.int32,
                          device=x.device)
        return lambda: lib.median_large_launch(
            r, n, x.stride(0), plan["cap"], x.data_ptr(), ws.data_ptr(),
            buf.data_ptr(), out.data_ptr(), stream())
    if x.dim() == 2:
        a, b, sa, sb = 1, n, 0, 1
    else:
        a, b, sa, sb = x.shape[1], x.shape[2], x.stride(1), x.stride(2)
    return lambda: lib.median_onchip_launch(
        r, n, a, b, x.stride(0), sa, sb, plan["cluster"], plan["threads"],
        plan["keys_a_block"], plan["cand"], x.data_ptr(), out.data_ptr(),
        stream())


def first_port(other: Path):
    """The other checkout's median.cu built as it is and bound."""
    src = other / "cwsl_digi_tpu_torch" / "modes" / "csrc" / "median.cu"
    so, _ = kernel_build.build_library(src, BUILD_DIR, "median_first",
                                       mk.EXTRA_FLAGS)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.median_rows_launch.argtypes = [ll, ll, p, p, p, p]
    lib.median_rows_launch.restype = i
    lib.median_ws_words.restype = i
    lib.median_kernel_attrs.argtypes = [p]
    lib.median_kernel_attrs.restype = i
    return lib


def first_launcher(lib, x: torch.Tensor):
    """A call that runs the other checkout's median as its wrapper did (a
    contiguous copy of a strided view, a zeroed workspace, three
    launches), and its output."""
    r = x.shape[0]
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    words = lib.median_ws_words()

    def run():
        flat = x.reshape(r, -1).contiguous()
        ws = torch.zeros((r, words), dtype=torch.int32, device=x.device)
        err = lib.median_rows_launch(
            r, flat.shape[1], flat.data_ptr(), ws.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"first port's median: CUDA error {err}")
    return run, out


def kernel_times(fn) -> dict:
    """Device time of each kernel of one fn() call (``torch.profiler``),
    by name, median of three calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times: dict[str, list] = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            times.setdefault(name, []).append(e.time_range.elapsed_us() / 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """median.cu's order keys of float32 x as int64 (-0.0 as 0.0, NaN
    above +inf)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(x == 0, torch.zeros_like(u), u)
    k = torch.where(u >= 2 ** 31, (~u) & 0xFFFFFFFF, u | 2 ** 31)
    return torch.where(x.isnan(), torch.full_like(k, 0xFFFFFFFF), k)


def large_shares(x: torch.Tensor) -> dict:
    """What share of each large row lies strictly between the sample's two
    keys (the candidates the stream keeps), and in the middle rank's first
    digit at 11, 12 and 13 bits (what a compaction after a first full
    pass would keep)."""
    r, n = x.shape
    keys = order_keys(x)
    mkey = keys.sort(dim=1).values[:, (n - 1) // 2]
    out = {}
    for bits in (11, 12, 13):
        same = (keys >> (32 - bits)) == (mkey[:, None] >> (32 - bits))
        out[f"median_digit_share_{bits}_bits"] = [
            float(v) for v in same.sum(dim=1).double() / n]
    s = mk.SAMPLE
    pos = torch.from_numpy(mk.sample_positions(n)).to(x.device)
    samp = keys[:, pos].sort(dim=1).values
    a = max(0, ((n - 1) // 2) * s // n - mk.MARGIN)
    b = min(s - 1, (n // 2) * s // n + mk.MARGIN)
    lo, hi = samp[:, a:a + 1], samp[:, b:b + 1]
    inside = ((keys > lo) & (keys < hi)).sum(dim=1).double() / n
    out["candidate_share"] = [float(v) for v in inside]
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-port", type=Path, default=None,
                    help="another checkout whose median is timed beside")
    ap.add_argument("--rounds", type=int, default=1,
                    help="turns of (this, other, other, this) a shape")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    rec = chip_smoke.record_qary_inputs(dev)
    shapes: dict[str, torch.Tensor] = {}
    for name, x in rec["median"] + rec["median_view"]:
        shapes.setdefault(f"{name} {list(x.shape)}", x)
    out: dict = {"card": card, "shapes": {}}
    first = first_port(a.first_port) if a.first_port is not None else None
    hooked = ctypes.CDLL(str(kernel_build.build_library(
        span_source(), BUILD_DIR, "median_spans", mk.EXTRA_FLAGS)[0]))
    bind(hooked)
    for name, x in shapes.items():
        r, n = x.shape[0], x[0].numel()
        reps = 5 if r * n < 2 ** 24 else 3
        plan = chip_smoke.median_plan_of(dev, x)
        want = gfsk_engine._median_rows_plain(x)
        got = gfsk_engine._median_rows(x)
        row: dict = {"shape": list(x.shape), "plan": plan,
                     "bound_ms": max(chip_smoke.median_bound_ms(
                         x.reshape(r, -1))[:2]),
                     "bits_differ": chip_smoke._floats_differ(got, want),
                     "design": chip_smoke.median_design(
                         dev, {"median": [(name, x)]})[0]["kernels"]}
        if plan["plan"] == "large":
            row["kernel_ms"] = kernel_times(lambda: mk.median_rows(x))
            row.update(large_shares(x))
        kept = lambda: gfsk_engine._median_rows(x)  # noqa: E731
        turns: dict[str, list] = {"kept": [], "first port": []}
        if first is not None:
            run, f_out = first_launcher(first, x)
            run()
            torch.cuda.synchronize()
            row["first_port_bits_differ"] = chip_smoke._floats_differ(
                f_out, want)
            for _ in range(a.rounds):
                for turn in ("kept", "first port", "first port", "kept"):
                    turns[turn].append(chip_smoke.cuda_ms(
                        kept if turn == "kept" else run, reps))
        else:
            turns["kept"].append(chip_smoke.cuda_ms(kept, reps))
        row["ms_turns"] = turns
        others = {}
        for c in (1, 2, 4, 8, 16):
            try:
                mk.median_plan(n, cluster=c)
            except ValueError:
                continue
            if c == plan.get("cluster"):
                continue
            others[f"cluster {c}"] = chip_smoke.cuda_ms(
                lambda: mk.median_rows(x, cluster=c), reps)
        if plan["plan"] != "large" and n > mk.SAMPLE:
            if x.is_contiguous():
                others["large"] = chip_smoke.cuda_ms(
                    lambda: mk.median_rows(x, plan="large"), reps)
        row["ms_other_plans"] = others
        row["spans"] = spans_of(hooked, hooked_launcher(hooked, x, plan))
        if row["bits_differ"] or row.get("first_port_bits_differ"):
            raise AssertionError(f"{name}: a kernel differs from the plain "
                                 f"median: {row}")
        out["shapes"][name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    out["attrs"] = mk.instance_attrs(dev)
    if first is not None:
        vals = (ctypes.c_int * 4)()
        first.median_kernel_attrs(ctypes.addressof(vals))
        out["first_port_attrs"] = dict(zip(
            ("registers", "local_bytes", "static_smem_bytes", "max_threads"),
            list(vals)))
    print(json.dumps(out))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
