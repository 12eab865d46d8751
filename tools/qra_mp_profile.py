"""Profile Q65's GF(64) message passing (``qra_mp``) on one card at the
words of a 64-window Q65-30 decode (the smoke's weak replay: 7,680 words
with the decoder's 24 candidates and 5 prior variants).

    python3 tools/qra_mp_profile.py [--first-port OTHER_CHECKOUT]
                                    [--variants] [--out FILE]

For this checkout's kernel, and with ``--first-port`` for the one in
``OTHER_CHECKOUT/cwsl_digi_tpu_torch/modes/csrc/qary.cu`` (built as it is,
fed the table block without its trailing edge list), in turns: device time
(``chip_smoke.cuda_ms``) at 60 iterations and at 0 and 1 (the fixed and
the per-iteration cost), registers, spills, dynamic shared memory, the
blocks an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, or
for a library without that entry the least of the shared-memory, register
and 32-warp limits), and the SASS instruction counts of the kernel
(``cuobjdump -sass``, static: SHFL, MUFU, BAR, LDS, STS, FADD, FMUL and
the total).  Each kernel is also built once more with profiling hooks
(``clock64()`` at its phase boundaries, each warp's cycles summed over the
iterations; each block's SM and start and end ``%globaltimer``): this
checkout's through its ``MP_SPAN`` hooks (the set-up, the variable phase,
the wait at its barrier, the check phase, the wait at its barrier, the
posterior), the first port's with the same hooks put in at its own phase
boundaries (``FIRST_PORT_SPANS``: the set-up, the variable products, the
wait, the checks' slots, the wait, the posterior); it gives the share of
the cycles in each span and the blocks resident on an SM over the run
(time-weighted, from the blocks' intervals).  A hooked build is not timed
and must give its library's results bit for bit.  With ``--variants``,
this checkout's kernel is also built with one arithmetic step changed
(``VARIANTS``, the changes of ``qra_mp_model.CHANGES`` that touch no
table: the transformed message divided by its DC term in place of
multiplied by its reciprocal; the check's message normalised again by its
warp sum), each timed at 60 iterations in turns with the kernel as it is,
its flags held against the plain version's on the card (converged words,
the gap, the flags that differ, the symbols where both converge) and its
results against the model with the same change on every 64th word.  ncu
does not run on the card's machine, so there are no stall reasons.
Prints one JSON object (also written to ``--out``).  Needs one CUDA device
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE / "tools")]
import chip_smoke  # noqa: E402
import qra_mp_model  # noqa: E402
from cwsl_digi_tpu_torch import kernel_build  # noqa: E402
from cwsl_digi_tpu_torch.modes import _qary_kernels as qk  # noqa: E402
from cwsl_digi_tpu_torch.modes import q65, qra  # noqa: E402

BUILD_DIR = HERE / "build" / "qra_mp_profile"
SPANS = {"kept": ("set-up", "variable phase", "wait after variables",
                  "check phase", "wait after checks", "posterior"),
         "first port": ("set-up", "variable products", "wait after products",
                        "checks' slots", "wait after checks", "posterior")}
MAX_WORDS = 8192
MODEL_STRIDE = 64

# the hooks put into the first port's k_qra_mp (its one-block-a-word
# qary.cu of 10 warps and 93,952 B of shared memory a word), each
# anchor found exactly once: the spans open at the kernel's start; the
# set-up ends at the barrier before the iterations, the variable products
# (a thread an element) and the checks (a warp a check: each slot's
# message, transforms and products) each at their barrier, and the
# posterior, argmax and syndrome at the last barrier
FIRST_PORT_SPANS = [
    ("""         float* __restrict__ conf) {
    extern __shared__ float smem[];
    const MpTabs tb = mp_tabs(tables, d);
    const int slots = d.nc * d.mr;""",
     """         float* __restrict__ conf) {
    MP_SPAN_BEGIN();
    extern __shared__ float smem[];
    const MpTabs tb = mp_tabs(tables, d);
    const int slots = d.nc * d.mr;"""),
    ("""    float* buf = perm + warp * d.mr * Q;
    __syncthreads();
""", """    float* buf = perm + warp * d.mr * Q;
    __syncthreads();
    MP_SPAN(0);
"""),
    ("""        var_products(d, tb, m_cv, chan, tot);
        __syncthreads();
        for (int c = warp; c < d.nc; c += MP_WARPS) {""",
     """        var_products(d, tb, m_cv, chan, tot);
        MP_SPAN(1);
        __syncthreads();
        MP_SPAN(2);
        for (int c = warp; c < d.nc; c += MP_WARPS) {"""),
    ("""        }
        __syncthreads();
    }

    // posterior, its argmax""", """        }
        MP_SPAN(3);
        __syncthreads();
        MP_SPAN(4);
    }

    // posterior, its argmax"""),
    ("""    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {""", """    bad = __syncthreads_or(bad);
    MP_SPAN_END();
    if (threadIdx.x == 0) {"""),
]

# one arithmetic step of this checkout's kernel changed, as
# qra_mp_model.mp_model(..., change=name) changes it
VARIANTS = {
    "divide, not reciprocal": [(
        """        const float r = __frcp_rn(__shfl_sync(FULL, a[j], 0) + TINY);
        a[j] = a[j] * r;
        b[j] = b[j] * r;""",
        """        const float den = __shfl_sync(FULL, a[j], 0) + TINY;
        a[j] = a[j] / den;
        b[j] = b[j] / den;""")],
    "renormalise checks": [(
        """        la[j] = clamp_tiny(la[j] * (1.0f / Q));
        lb[j] = clamp_tiny(lb[j] * (1.0f / Q));""",
        """        la[j] = clamp_tiny(la[j] * (1.0f / Q));
        lb[j] = clamp_tiny(lb[j] * (1.0f / Q));
        const float den = warp_sum64(la[j], lb[j]) + TINY;
        la[j] = la[j] / den;
        lb[j] = lb[j] / den;""")],
}

# the hooks of qary.cu: per warp the cycles of each span, per block its SM
# and its start and end times (ns)
HOOKS = r"""
#include <cuda_runtime.h>
#define MP_SPANS 1
__device__ unsigned long long mp_span_acc[%(words)d * %(warps)d * 6];
__device__ unsigned long long mp_span_block[%(words)d * 3];
#define MP_SPAN_BEGIN()                                                   \
    unsigned long long mp_t = clock64(), mp_ns0;                          \
    unsigned long long mp_acc[6] = {0, 0, 0, 0, 0, 0};                    \
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(mp_ns0))
#define MP_SPAN(k)                                                        \
    do {                                                                  \
        const unsigned long long t_ = clock64();                          \
        mp_acc[k] += t_ - mp_t;                                           \
        mp_t = t_;                                                        \
    } while (0)
#define MP_SPAN_END()                                                     \
    do {                                                                  \
        MP_SPAN(5);                                                       \
        if (blockIdx.x < %(words)d) {                                     \
            if ((threadIdx.x & 31) == 0)                                  \
                for (int k_ = 0; k_ < 6; ++k_)                            \
                    mp_span_acc[(blockIdx.x * %(warps)d                   \
                                 + (threadIdx.x >> 5)) * 6 + k_] =        \
                        mp_acc[k_];                                       \
            if (threadIdx.x == 0) {                                       \
                unsigned long long ns1;                                   \
                unsigned sm;                                              \
                asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(ns1));  \
                asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));          \
                mp_span_block[blockIdx.x * 3] = sm;                       \
                mp_span_block[blockIdx.x * 3 + 1] = mp_ns0;               \
                mp_span_block[blockIdx.x * 3 + 2] = ns1;                  \
            }                                                             \
        }                                                                 \
    } while (0)
#include "%(src)s"
extern "C" int mp_spans_read(void* acc, void* blk) {
    cudaError_t e = cudaMemcpyFromSymbol(acc, mp_span_acc,
                                         sizeof(mp_span_acc));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaMemcpyFromSymbol(blk, mp_span_block,
                                                 sizeof(mp_span_block)));
}
"""


def q65_words(dev) -> tuple:
    """(decoder, probs [7,680, 63, 64]) of a 64-window Q65-30 decode of the
    smoke's weak replay on the card."""
    rec = []
    decode = qra.QaryMPDecoder.decode

    def keep(self, probs):
        rec.append((self, probs.clone()))
        return decode(self, probs)

    qra.QaryMPDecoder.decode = keep
    try:
        q65.Q65Decoder(device=dev).decode(torch.from_numpy(
            chip_smoke._weak_windows("Q65-30", 64, chip_smoke.SEED + 63)
        ).to(dev))
    finally:
        qra.QaryMPDecoder.decode = decode
    return rec[0]


def sass_counts(lib: Path) -> dict:
    """Static SASS instruction counts of the library's qra_mp kernels (all
    instances together), by mnemonic."""
    tool = shutil.which("cuobjdump") or str(
        Path(kernel_build.nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, inside = Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "k_qra_mp" in line
            continue
        hit = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                        line)
        if inside and hit:
            counts[hit.group(1)] += 1
    keys = ("SHFL", "MUFU", "BAR", "LDS", "STS", "FADD", "FMUL", "FSEL")
    return {**{k: counts[k] for k in keys}, "total": sum(counts.values())}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qra_mp_launch.argtypes = [p] * 7
    lib.qra_mp_launch.restype = i
    lib.qary_kernel_attrs.argtypes = [i, p]
    lib.qary_kernel_attrs.restype = i
    return lib


def launcher(lib: ctypes.CDLL, tab: torch.Tensor, probs: torch.Tensor,
             dims: list):
    """A call that launches the library's qra_mp on ``probs`` with the
    iteration count last in ``dims``."""
    b = probs.shape[0]
    hard = torch.empty((b, probs.shape[1]), dtype=torch.int64,
                       device=probs.device)
    ok = torch.empty(b, dtype=torch.uint8, device=probs.device)
    conf = torch.empty(b, dtype=torch.float32, device=probs.device)
    cd = (ctypes.c_int * len(dims))(*dims)

    def run():
        err = lib.qra_mp_launch(
            ctypes.addressof(cd), tab.data_ptr(), probs.data_ptr(),
            hard.data_ptr(), ok.data_ptr(), conf.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"qra_mp launch: CUDA error {err}")
    return run, (hard, ok, conf)


def attrs(lib: ctypes.CDLL) -> dict:
    vals = (ctypes.c_int * 4)()
    if lib.qary_kernel_attrs(0, ctypes.addressof(vals)):
        raise RuntimeError("qary_kernel_attrs failed")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "max_threads"), list(vals)))


def profile(name: str, lib: ctypes.CDLL, so: Path, tab: torch.Tensor,
            probs: torch.Tensor, dims: list, smem: int, warps: int,
            blocks_sm: int | None) -> dict:
    a = attrs(lib)
    if blocks_sm is None:
        blocks_sm = min(233_472 // (smem + a["static_smem_bytes"] + 1024),
                        65_536 // (a["registers"] * 32 * warps), 64 // warps)
    times = {}
    for iters in (0, 1, 60):
        run, _ = launcher(lib, tab, probs, dims[:-1] + [iters])
        times[iters] = chip_smoke.cuda_ms(run, 2 if iters == 60 else 5)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    waves = probs.shape[0] / (blocks_sm * n_sm)
    out = {"ms_60": times[60], "ms_0": times[0], "ms_1": times[1],
           "ms_an_iteration": (times[60] - times[0]) / 60,
           "attrs": a, "dynamic_smem_bytes": smem, "warps_a_block": warps,
           "blocks_an_sm": blocks_sm, "warps_an_sm": blocks_sm * warps,
           "waves": waves, "sass": sass_counts(so)}
    print(f"{name}: {json.dumps(out)}", flush=True)
    return out


def patched(src: Path, subs: list, name: str) -> Path:
    """``src`` with each (anchor, replacement) of ``subs`` applied, written
    to BUILD_DIR/``name``.cu; raises unless every anchor is found exactly
    once."""
    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: anchor found {text.count(old)} "
                               f"times in {src}: {old.splitlines()[0]!r}")
        text = text.replace(old, new)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.cu"
    out.write_text(text)
    return out


def build(src: Path, name: str) -> tuple:
    """(bound library, shared object) of ``src``."""
    so, _ = kernel_build.build_library(src, BUILD_DIR, name, qk.EXTRA_FLAGS)
    return bind(ctypes.CDLL(str(so))), so


def spans(label: str, src: Path, warps: int, tab: torch.Tensor,
          probs: torch.Tensor, dims: list, want: tuple) -> dict:
    """The spans of ``src`` built with the hooks (``src`` must define them
    where its phases end), on the first MAX_WORDS words; ``want`` its
    library's (hard, ok, conf) on them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    name = "spans_" + label.replace(" ", "_")
    wrap = BUILD_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    wrap.write_text(f"// {src.name} {digest}\n" + HOOKS % {
        "words": MAX_WORDS, "warps": warps, "src": src})
    lib, _ = build(wrap, name)
    lib.mp_spans_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mp_spans_read.restype = ctypes.c_int
    b = min(probs.shape[0], MAX_WORDS)
    run, res = launcher(lib, tab, probs[:b], [b] + dims[1:])
    run()
    torch.cuda.synchronize()
    acc = np.zeros(MAX_WORDS * warps * 6, np.uint64)
    blk = np.zeros(MAX_WORDS * 3, np.uint64)
    if lib.mp_spans_read(acc.ctypes.data, blk.ctypes.data):
        raise RuntimeError("mp_spans_read failed")
    acc = acc.reshape(MAX_WORDS, warps, 6)[:b].astype(np.float64)
    blk = blk.reshape(MAX_WORDS, 3)[:b].astype(np.int64)
    share = acc.sum((0, 1)) / acc.sum()
    # resident blocks an SM, time-weighted over each SM's busy span
    resident = []
    for sm in np.unique(blk[:, 0]):
        iv = blk[blk[:, 0] == sm, 1:]
        ev = np.concatenate([np.stack([iv[:, 0], np.ones(len(iv))], 1),
                             np.stack([iv[:, 1], -np.ones(len(iv))], 1)])
        ev = ev[np.lexsort((ev[:, 1], ev[:, 0]))]
        cnt = np.cumsum(ev[:, 1])[:-1]
        dt = np.diff(ev[:, 0])
        resident.append(float((cnt * dt).sum() / dt.sum()))
    same = bool((res[0] == want[0][:b]).all()
                and (res[1].bool() == want[1][:b].bool()).all()
                and (res[2].view(torch.int32)
                     == want[2][:b].view(torch.int32)).all())
    if not same:
        raise AssertionError(f"{label}: the hooked build differs from its "
                             "library")
    names = SPANS[label]
    out = {"words": b, "warps_a_block": warps,
           "cycles_share": dict(zip(names, share.tolist())),
           "cycles_a_warp_iteration": {
               k: float(v) for k, v in zip(
                   names, acc.mean((0, 1)) / max(dims[-1], 1))},
           "resident_blocks_an_sm": {
               "mean": float(np.mean(resident)),
               "min": float(np.min(resident)),
               "max": float(np.max(resident)), "sms": len(resident)},
           "block_us": float(np.median(blk[:, 2] - blk[:, 1]) / 1e3),
           "hooked_build_equals_the_library": same}
    print(f"spans {label}: {json.dumps(out)}", flush=True)
    return out


def flags_vs(got: tuple, ref: tuple) -> dict:
    """Converged words, the gap to ``ref``'s, the flags that differ (lost
    / gained) and whether the symbols agree wherever both converge."""
    h, ok = got[0], got[1].bool()
    rh, rok = ref[0], ref[1].bool()
    both = ok & rok
    return {"converged": int(ok.sum()), "ref_converged": int(rok.sum()),
            "gap": int(rok.sum()) - int(ok.sum()),
            "flags_differ": int((ok != rok).sum()),
            "lost": int((rok & ~ok).sum()), "gained": int((ok & ~rok).sum()),
            "symbols_identical_where_both_converge":
                bool(not (h != rh).any(-1)[both].any())}


def variants(dec, tab: torch.Tensor, probs: torch.Tensor, dims: list,
             kept_lib: ctypes.CDLL) -> dict:
    """Each of VARIANTS built, timed in turns with the kernel as it is,
    its flags against the plain version on the card and its results
    against the model with the same change on every MODEL_STRIDE-th
    word."""
    src = HERE / "cwsl_digi_tpu_torch" / "modes" / "csrc" / "qary.cu"
    libs = {"kept": kept_lib}
    for name, subs in VARIANTS.items():
        slug = "variant_" + re.sub(r"\W+", "_", name)
        libs[name] = build(patched(src, subs, slug), slug)[0]
    plain = dec.decode_plain(probs)
    out = {}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        run, res = launcher(libs[name], tab, probs, dims)
        ms = chip_smoke.cuda_ms(run, 2)
        o = out.setdefault(name, {"ms": []})
        o["ms"].append(ms)
        if "flags_vs_plain_card" not in o:
            run()
            torch.cuda.synchronize()
            o["flags_vs_plain_card"] = flags_vs(res, plain)
            pick = torch.arange(0, probs.shape[0], MODEL_STRIDE)
            model = qra_mp_model.mp_model(
                dec, probs[pick].cpu().numpy(),
                change=None if name == "kept" else name)
            o["model_words"] = len(pick)
            o["model_bit_for_bit"] = bool(
                np.array_equal(res[0][pick].cpu().numpy(), model[0])
                and np.array_equal(res[1][pick].cpu().numpy().astype(bool),
                                   model[1])
                and np.array_equal(res[2][pick].cpu().numpy().view(np.uint32),
                                   model[2].view(np.uint32)))
        print(f"variant {name}: {json.dumps(o)}", flush=True)
    for name, o in out.items():
        if not o["model_bit_for_bit"]:
            raise AssertionError(f"variant {name}: the kernel differs from "
                                 "the model with the same change")
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-port", type=Path, default=None,
                    help="another checkout whose qra_mp is profiled beside")
    ap.add_argument("--variants", action="store_true",
                    help="time and check the kernel with one step changed")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    print(chip_smoke.card_line())
    dev = torch.device("cuda:0")
    dec, probs = q65_words(dev)
    tab = dec._ktab[dev]
    code = dec.kernel_code
    edges = qk.mp_edges(tab, code)
    out = {"card": chip_smoke.card_line(), "words": probs.shape[0],
           "iters": dec.iters, "edges": edges}
    src = HERE / "cwsl_digi_tpu_torch" / "modes" / "csrc" / "qary.cu"
    kept_dims = [probs.shape[0], *code, edges, dec.iters]
    libs = {"kept": (bind(qk.load_library()), qk.build_library(), tab,
                     kept_dims, qk.mp_smem_bytes(code[0], edges), 8,
                     qk.mp_blocks_per_sm(dev, code, edges))}
    if a.first_port is not None:
        first_src = a.first_port / "cwsl_digi_tpu_torch" / "modes" / \
            "csrc" / "qary.cu"
        first, so = build(first_src, "qary_first")
        first.qra_mp_smem_bytes.argtypes = [ctypes.c_int] * 3
        first.qra_mp_smem_bytes.restype = ctypes.c_int
        n, nc, mr, _ = code
        libs["first port"] = (first, so, tab[:-edges].contiguous(),
                              [probs.shape[0], *code, dec.iters],
                              first.qra_mp_smem_bytes(n, nc, mr), 10, None)
    for turn in ("kept", "first port", "first port", "kept"):
        if turn not in libs:
            continue
        got = profile(turn, libs[turn][0], libs[turn][1], libs[turn][2],
                      probs, *libs[turn][3:])
        out.setdefault(turn, []).append(got)
    want = dec.decode(probs[:MAX_WORDS])
    out["spans"] = {"kept": spans("kept", src, 8, tab, probs, kept_dims,
                                  want)}
    if a.first_port is not None:
        lib, _, ftab, fdims = libs["first port"][:4]
        b = min(probs.shape[0], MAX_WORDS)
        run, fwant = launcher(lib, ftab, probs[:b], [b] + fdims[1:])
        run()
        torch.cuda.synchronize()
        out["spans"]["first port"] = spans(
            "first port", patched(first_src, FIRST_PORT_SPANS, "first_spans"),
            10, ftab, probs, fdims, fwant)
    if a.variants:
        out["variants"] = variants(dec, tab, probs, kept_dims,
                                   libs["kept"][0])
    print(json.dumps(out))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
