"""Time the designs of the sync search's half-hop refinement on one card, in
turns, at the FT8 main path's first-pass call.

    python3 tools/sync_refine_variants.py [--out FILE]

Builds ``modes/csrc/sync.cu`` once more with the designs that were measured
beside the kept one added to it, into ``build/sync_refine_variants/``:

- ``first port``: a warp a candidate, its lanes loading the 3 x n cells
  into shared memory, three lanes summing them (the kernel before this
  design);
- ``thread a candidate``: one thread loads all 3 x n cells, then sums;
- ``triples``: three lanes a candidate, one an offset, 10 a warp;
- ``quads``: the same with four lanes a candidate, the fourth idle, 8 a
  warp (the kept kernel's instance);
- ``fused into the selection``: ``sync_select``'s rank-0 thread that writes
  a candidate (top_k up to 2048) also loads its 3 x n cells and writes tt,
  with no refinement launch (the selection's source patched here; its
  operands in a ``__constant__`` variable set before the timing).

Each is held bit for bit to ``sync_refine_plain`` on CPU copies, at
``top_k`` 512 (pass 1) and 32768, and at 512 on the candidates sorted by
(f0, t0) within each window.  The refinement alone is timed in turns
(device time, ``chip_smoke.cuda_ms``) beside three yardsticks, which give
up the bits and are not checked: one reads t0 and f0 and writes tt with
no cell, one loads the cells as quads do and sums their real parts, one
forms |z| in float; then the stage: score + selection
+ refinement against score + fused selection, as device time and issued
from the host.  Prints one JSON object (also written to ``--out``).
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402
from cwsl_digi_tpu_torch import kernel_build  # noqa: E402
from cwsl_digi_tpu_torch.modes import _sync_kernels as sk  # noqa: E402
from cwsl_digi_tpu_torch.modes import gfsk_engine as ge  # noqa: E402

BUILD_DIR = HERE / "build" / "sync_refine_variants"

# before sync_select's kernel: the fused variant's operands and its
# per-candidate refinement (one thread loads all 3 x n cells)
FUSED = r"""
struct FusedRefine {
    const float2* demod;
    int64_t* tt;
    RefineDims d;
    RefineCells cells;
    int on;
};
__constant__ FusedRefine g_fused;

// candidate (t, f) of window b by one thread: its 3 x NC cells loaded
// before any is used, each offset summed in spec order, the first maximum
template <int NC>
__device__ __forceinline__ int64_t refine_one(const float2* __restrict__ src,
                                              int t, int f,
                                              const RefineDims& d,
                                              const RefineCells& cells) {
    float2 z[3][NC];
    bool in[3][NC];
#pragma unroll
    for (int dd = 0; dd < 3; ++dd) {
        const int r0 = 2 * t + dd - 1;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            in[dd][c] = static_cast<unsigned>(cells.row[c] + r0)
                        < static_cast<unsigned>(d.H);
            z[dd][c] = __ldg(src + (in[dd][c] ? r0 * d.F + f + cells.off[c]
                                              : 0));
        }
    }
    float ev[3];
#pragma unroll
    for (int dd = 0; dd < 3; ++dd) {
        float e = in[dd][0] ? bf16_round(mag2(z[dd][0])) : 0.f;
#pragma unroll
        for (int c = 1; c < NC; ++c)
            e = e + (in[dd][c] ? bf16_round(mag2(z[dd][c])) : 0.f);
        ev[dd] = e;
    }
    int best = 0;
#pragma unroll
    for (int k = 1; k < 3; ++k) {
        const bool nan_k = ev[k] != ev[k], nan_b = ev[best] != ev[best];
        if ((nan_k && !nan_b) || (!nan_b && ev[k] > ev[best])) best = k;
    }
    const int r = 2 * t + best - 1;
    return r < 0 ? 0 : (r > d.H - 1 ? d.H - 1 : r);
}

__device__ __forceinline__ void fused_refine(int b, size_t o, unsigned idx,
                                             int n_f0) {
    if (!g_fused.on) return;
    const RefineDims& d = g_fused.d;
    g_fused.tt[o] = refine_one<21>(
        g_fused.demod + static_cast<size_t>(b) * d.H * d.F,
        static_cast<int>(idx / n_f0), static_cast<int>(idx % n_f0), d,
        g_fused.cells);
}

"""

SELECT_KERNEL = "__global__ void __launch_bounds__(SELECT_THREADS, 1)\n"
SELECT_TAIL = ("        top_f0[o0 + place] = idx % d.n_f0;\n"
               "        return;\n")
FUSED_TAIL = ("        top_f0[o0 + place] = idx % d.n_f0;\n"
              "        fused_refine(b, o0 + place, idx, d.n_f0);\n"
              "        return;\n")

# appended: the other designs and their C entries
VARIANTS = r"""
namespace {

// the first port: a warp a candidate
struct Cells {
    int n;
    int row[MAX_CELLS];
    int col[MAX_CELLS];
};

constexpr int FIRST_WARPS = 4;

__global__ void __launch_bounds__(FIRST_WARPS * 32)
k_refine_first_port(const float2* __restrict__ demod,
                    const int64_t* __restrict__ t0,
                    const int64_t* __restrict__ f0, RefineDims d, Cells cells,
                    int64_t* __restrict__ tt) {
    __shared__ float vals[FIRST_WARPS][3 * MAX_CELLS];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x * FIRST_WARPS + w;
    if (j >= d.B * d.K) return;
    const int b = j / d.K, n = cells.n;
    const int t = static_cast<int>(t0[j]), f = static_cast<int>(f0[j]);
    const float2* src = demod + static_cast<size_t>(b) * d.H * d.F;
    for (int i = lane; i < 3 * n; i += 32) {
        const int dd = i / n, c = i % n;
        const int row = cells.row[c] + 2 * t + dd - 1;
        float v = 0.f;
        if (row >= 0 && row < d.H)
            v = bf16_round(mag2(src[static_cast<size_t>(row) * d.F + f
                                    + cells.col[c]]));
        vals[w][i] = v;
    }
    __syncwarp();
    float e = 0.f;
    if (lane < 3)
        for (int c = 0; c < n; ++c)
            e = c ? e + vals[w][lane * n + c] : vals[w][lane * n];
    const float e1 = __shfl_sync(FULL, e, 1), e2 = __shfl_sync(FULL, e, 2);
    if (lane == 0) {
        const float ev[3] = {e, e1, e2};
        int best = 0;
#pragma unroll
        for (int dd = 1; dd < 3; ++dd) {
            const bool nan_d = ev[dd] != ev[dd], nan_b = ev[best] != ev[best];
            if ((nan_d && !nan_b) || (!nan_b && ev[dd] > ev[best])) best = dd;
        }
        const int r = 2 * t + best - 1;
        tt[j] = r < 0 ? 0 : (r > d.H - 1 ? d.H - 1 : r);
    }
}

// the yardstick: t0 and f0 read and tt written, no cell
__global__ void __launch_bounds__(REFINE_THREADS)
k_refine_no_cells(const int64_t* __restrict__ t0,
                  const int64_t* __restrict__ f0, RefineDims d,
                  int64_t* __restrict__ tt) {
    const int j = blockIdx.x * REFINE_THREADS + threadIdx.x;
    if (j >= d.B * d.K) return;
    const int r = 2 * static_cast<int>(__ldg(t0 + j))
                  + static_cast<int>(__ldg(f0 + j) % 3) - 1;
    tt[j] = r < 0 ? 0 : (r > d.H - 1 ? d.H - 1 : r);
}

// yardsticks of the kept layout (quads) that give up its bits: OP 0 loads
// the cells and sums their re parts (no |z|), OP 1 forms |z| in float
// (sqrtf in place of the double square root)
template <int OP>
__global__ void __launch_bounds__(REFINE_THREADS)
k_refine_cost(const float2* __restrict__ demod,
              const int64_t* __restrict__ t0, const int64_t* __restrict__ f0,
              RefineDims d, RefineCells cells, int64_t* __restrict__ tt) {
    const int lane = threadIdx.x & 31, g = lane / 4, dd = lane - 4 * g;
    const int j = (blockIdx.x * (REFINE_THREADS / 32) + (threadIdx.x >> 5))
                  * 8 + g;
    const bool live = dd < 3 && j < d.B * d.K;
    int t = 0;
    float e = 0.f;
    if (live) {
        t = static_cast<int>(__ldg(t0 + j));
        const int r0 = 2 * t + dd - 1;
        const int base = r0 * d.F + static_cast<int>(__ldg(f0 + j));
        const float2* src = demod + static_cast<size_t>(j / d.K) * d.H * d.F;
        float2 z[21];
        bool in[21];
#pragma unroll
        for (int c = 0; c < 21; ++c) {
            in[c] = static_cast<unsigned>(cells.row[c] + r0)
                    < static_cast<unsigned>(d.H);
            z[c] = __ldg(src + (in[c] ? base + cells.off[c] : 0));
        }
#pragma unroll
        for (int c = 0; c < 21; ++c) {
            float v = z[c].x;
            if (OP == 1) {
                const float m = sqrtf(z[c].x * z[c].x + z[c].y * z[c].y);
                v = bf16_round(m * m);
            }
            e = e + (in[c] ? v : 0.f);
        }
    }
    const float e1 = __shfl_down_sync(FULL, e, 1);
    const float e2 = __shfl_down_sync(FULL, e, 2);
    if (!live || dd != 0) return;
    const int best = e1 > e ? (e2 > e1 ? 2 : 1) : (e2 > e ? 2 : 0);
    const int r = 2 * t + best - 1;
    tt[j] = r < 0 ? 0 : (r > d.H - 1 ? d.H - 1 : r);
}

// one thread a candidate
__global__ void __launch_bounds__(REFINE_THREADS)
k_refine_thread(const float2* __restrict__ demod,
                const int64_t* __restrict__ t0,
                const int64_t* __restrict__ f0, RefineDims d,
                RefineCells cells, int64_t* __restrict__ tt) {
    const int j = blockIdx.x * REFINE_THREADS + threadIdx.x;
    if (j >= d.B * d.K) return;
    tt[j] = refine_one<21>(demod + static_cast<size_t>(j / d.K) * d.H * d.F,
                           static_cast<int>(__ldg(t0 + j)),
                           static_cast<int>(__ldg(f0 + j)), d, cells);
}

int prepare(const int* dims, const int* rows, const int* cols, int n_cells,
            RefineDims* d, RefineCells* rc, Cells* c) {
    d->B = dims[0];
    d->K = dims[1];
    d->H = dims[2];
    d->F = dims[3];
    if (n_cells != 21) return static_cast<int>(cudaErrorInvalidValue);
    rc->n = c->n = n_cells;
    for (int i = 0; i < n_cells; ++i) {
        rc->row[i] = c->row[i] = rows[i];
        rc->off[i] = rows[i] * d->F + cols[i];
        c->col[i] = cols[i];
    }
    return 0;
}

}  // namespace

extern "C" {

// which: 0 first port, 1 a thread a candidate, 2 triples, 3 quads; the
// yardsticks 4 no cell, 5 quads' loads with no |z|, 6 quads with a float
// |z|; FT8's 21 cells only
int variant_refine_launch(int which, const int* dims, const int* rows,
                          const int* cols, int n_cells, const void* demod,
                          const void* t0, const void* f0, void* tt,
                          void* stream) {
    RefineDims d;
    RefineCells rc;
    Cells c;
    const int err = prepare(dims, rows, cols, n_cells, &d, &rc, &c);
    if (err) return err;
    const long long n = static_cast<long long>(d.B) * d.K;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float2* dm = static_cast<const float2*>(demod);
    const int64_t* a = static_cast<const int64_t*>(t0);
    const int64_t* b = static_cast<const int64_t*>(f0);
    int64_t* out = static_cast<int64_t*>(tt);
    const int w = REFINE_THREADS / 32;
    if (which == 0)
        k_refine_first_port<<<(n + FIRST_WARPS - 1) / FIRST_WARPS,
                              FIRST_WARPS * 32, 0, st>>>(dm, a, b, d, c, out);
    else if (which == 1)
        k_refine_thread<<<(n + REFINE_THREADS - 1) / REFINE_THREADS,
                          REFINE_THREADS, 0, st>>>(dm, a, b, d, rc, out);
    else if (which == 2)
        k_sync_refine<21, 3><<<(n + 10 * w - 1) / (10 * w), REFINE_THREADS, 0,
                               st>>>(dm, a, b, d, rc, out);
    else if (which == 3)
        k_sync_refine<21, 4><<<(n + 8 * w - 1) / (8 * w), REFINE_THREADS, 0,
                               st>>>(dm, a, b, d, rc, out);
    else if (which == 4)
        k_refine_no_cells<<<(n + REFINE_THREADS - 1) / REFINE_THREADS,
                            REFINE_THREADS, 0, st>>>(a, b, d, out);
    else if (which == 5)
        k_refine_cost<0><<<(n + 8 * w - 1) / (8 * w), REFINE_THREADS, 0,
                           st>>>(dm, a, b, d, rc, out);
    else if (which == 6)
        k_refine_cost<1><<<(n + 8 * w - 1) / (8 * w), REFINE_THREADS, 0,
                           st>>>(dm, a, b, d, rc, out);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// the fused selection's operands (demod null: off), before its launches
int variant_fused_arm(const int* dims, const int* rows, const int* cols,
                      int n_cells, const void* demod, void* tt) {
    FusedRefine h = {};
    Cells c;
    if (demod) {
        const int err = prepare(dims, rows, cols, n_cells, &h.d, &h.cells, &c);
        if (err) return err;
        h.demod = static_cast<const float2*>(demod);
        h.tt = static_cast<int64_t*>(tt);
        h.on = 1;
    }
    return static_cast<int>(cudaMemcpyToSymbol(g_fused, &h, sizeof(h)));
}

// registers and local bytes a thread of variant `which` (as above; 4 the
// fused selection)
int variant_attrs(int which, int* out) {
    cudaFuncAttributes a;
    cudaError_t e;
    if (which == 0) e = cudaFuncGetAttributes(&a, k_refine_first_port);
    else if (which == 1) e = cudaFuncGetAttributes(&a, k_refine_thread);
    else if (which == 2) e = cudaFuncGetAttributes(&a, k_sync_refine<21, 3>);
    else if (which == 3) e = cudaFuncGetAttributes(&a, k_sync_refine<21, 4>);
    else e = cudaFuncGetAttributes(&a, k_sync_select);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    return 0;
}

}  // extern "C"
"""

REFINE_VARIANTS = ("first port", "thread a candidate", "triples", "quads")


def variant_source() -> str:
    """sync.cu with the fused selection's tail and the other designs."""
    src = sk.SRC.read_text()
    for anchor in (SELECT_KERNEL, SELECT_TAIL):
        if src.count(anchor) != 1:
            raise RuntimeError(f"sync.cu no longer has {anchor!r} once")
    at = src.index(SELECT_KERNEL)
    src = src[:at] + FUSED + src[at:]
    return src.replace(SELECT_TAIL, FUSED_TAIL) + VARIANTS


def load() -> tuple[ctypes.CDLL, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "sync_variants.cu"
    path.write_text(variant_source())
    out, log = kernel_build.build_library(path, BUILD_DIR, "sync_variants",
                                          sk.EXTRA_FLAGS)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.variant_refine_launch.argtypes = [i, p, p, p, i] + [p] * 5
    lib.variant_fused_arm.argtypes = [p, p, p, i, p, p]
    lib.variant_attrs.argtypes = [i, p]
    lib.sync_select_launch.argtypes = [p] * 8
    for name in ("variant_refine_launch", "variant_fused_arm",
                 "variant_attrs", "sync_select_launch"):
        getattr(lib, name).restype = i
    return lib, log or ""


def _dims(spec, demod, k):
    b, h, f = demod.shape
    rows, cols, n = sk._cells(spec, 2 * spec.os_t)
    return (ctypes.c_int * 4)(b, k, h, f), rows, cols, n


def refine_variant(lib, which: int, spec, demod, t0, f0) -> torch.Tensor:
    tt = torch.empty_like(t0)
    dims, rows, cols, n = _dims(spec, demod, t0.shape[1])
    err = lib.variant_refine_launch(
        which, ctypes.addressof(dims), ctypes.addressof(rows),
        ctypes.addressof(cols), n, demod.data_ptr(), t0.data_ptr(),
        f0.data_ptr(), tt.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant {which}: CUDA error {err}")
    return tt


def arm_fused(lib, spec, demod, tt) -> None:
    dims, rows, cols, n = _dims(spec, demod, tt.shape[1])
    err = lib.variant_fused_arm(ctypes.addressof(dims), ctypes.addressof(rows),
                                ctypes.addressof(cols), n, demod.data_ptr(),
                                tt.data_ptr())
    if err:
        raise RuntimeError(f"variant_fused_arm: CUDA error {err}")


def fused_stage(lib, spec, ps, base, tt):
    """Score, then the patched selection that also writes tt (armed)."""
    score, nms = sk.sync_score(spec, ps, base)
    b, n_t0, n_f0 = score.shape
    k = spec.top_k
    dev = score.device
    top_val = torch.empty((b, k), dtype=torch.float32, device=dev)
    t0 = torch.empty((b, k), dtype=torch.int64, device=dev)
    f0 = torch.empty_like(t0)
    pairs = torch.empty(b * 2 * sk._pair_stride(k), dtype=torch.int64,
                        device=dev)
    dims = (ctypes.c_int * 6)(b, n_t0 * n_f0, n_f0, k // 2, k - k // 2, 0)
    err = lib.sync_select_launch(
        ctypes.addressof(dims), nms.data_ptr(), score.data_ptr(),
        top_val.data_ptr(), t0.data_ptr(), f0.data_ptr(), pairs.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused selection: CUDA error {err}")
    return top_val, t0, f0, tt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    lib, log = load()
    print(log)
    cases = chip_smoke.gfsk_cases(dev)
    spec, ps, demod, base, n_hops, refine = cases["ft8 main path"][2][0]
    del cases
    torch.cuda.empty_cache()
    assert refine and len(spec.sync_cells) == 21
    out = {"card": chip_smoke.card_line(), "demod": list(demod.shape),
           "attrs": {}}
    for which, name in enumerate(REFINE_VARIANTS + ("fused selection",)):
        vals = (ctypes.c_int * 2)()
        if lib.variant_attrs(which, ctypes.addressof(vals)):
            raise RuntimeError(f"variant_attrs({which})")
        out["attrs"][name] = {"registers": vals[0], "local_bytes": vals[1]}

    # bit for bit against the plain version, at top_k 512 and 32768, and at
    # 512 on the candidates sorted by (f0, t0) within each window (the
    # raw half's neighbours then sit in one warp: what locality is worth)
    inputs = {}
    for k in (spec.top_k, 2 * sk.SELECT_MAX_K):
        sp = dataclasses.replace(spec, top_k=k)
        score, nms = sk.sync_score(sp, ps, base)
        _, t0, f0 = sk.sync_select(sp, score, nms)
        del score, nms
        want = ge.sync_refine_plain(sp, demod.cpu(), t0.cpu(), f0.cpu())
        inputs[f"top_k {k}"] = (sp, t0, f0, want)
        if k == spec.top_k:
            perm = (f0 * sk.grid(sp)[0] + t0).argsort(dim=1)
            inputs[f"top_k {k} sorted by (f0, t0)"] = (
                sp, t0.gather(1, perm), f0.gather(1, perm),
                want.gather(1, perm.cpu()))
    out["tt_differ"] = {}
    for label, (sp, t0, f0, want) in inputs.items():
        for which, name in enumerate(REFINE_VARIANTS):
            got = refine_variant(lib, which, sp, demod, t0, f0).cpu()
            out["tt_differ"][f"{name}, {label}"] = int((got != want).sum())
    sp, t0, f0, _ = inputs[f"top_k {spec.top_k}"]
    kept_stage = sk.sync_candidates(spec, ps, demod, base, n_hops, True)
    tt_f = torch.empty_like(t0)
    arm_fused(lib, spec, demod, tt_f)
    fused = fused_stage(lib, spec, ps, base, tt_f)
    torch.cuda.synchronize()
    out["fused_differs"] = sum(int((a.cpu() != b.cpu()).sum())
                               for a, b in zip(fused, kept_stage[:4]))
    bad = {k: v for k, v in out["tt_differ"].items() if v}
    if bad or out["fused_differs"]:
        print(json.dumps(out))
        raise AssertionError(f"variants disagree: {bad}, fused "
                             f"{out['fused_differs']}")

    # the refinement alone in turns (and the no-cell yardstick), then the
    # stage both ways in turns
    names = REFINE_VARIANTS + ("no cells", "quads, loads only",
                               "quads, float |z|")
    for label, (sp, t0, f0, _) in inputs.items():
        order = list(range(len(names)))
        times: dict[str, list[float]] = {}
        for which in order + order[::-1]:
            ms = chip_smoke.cuda_ms(
                lambda w=which: refine_variant(lib, w, sp, demod, t0, f0), 20)
            times.setdefault(names[which], []).append(ms)
        out[f"refine_ms, {label}"] = {
            name: {"median": statistics.median(v), "turns": v}
            for name, v in times.items()}
        print(json.dumps({label: out[f"refine_ms, {label}"]}), flush=True)
    stage = {"kept": [], "fused": [], "kept_host": [], "fused_host": []}

    def kept():
        return sk.sync_candidates(spec, ps, demod, base, n_hops, True)

    def fuse():
        return fused_stage(lib, spec, ps, base, tt_f)

    for name in ("kept", "fused", "fused", "kept"):
        fn = kept if name == "kept" else fuse
        stage[name].append(chip_smoke.cuda_ms(fn, 10))
        stage[f"{name}_host"].append(chip_smoke.eager_ms(fn, 10))
    lib.variant_fused_arm(None, None, None, 0, None, None)    # off again
    out["stage_ms"] = {k: {"median": statistics.median(v), "turns": v}
                       for k, v in stage.items()}
    print(json.dumps(out))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
