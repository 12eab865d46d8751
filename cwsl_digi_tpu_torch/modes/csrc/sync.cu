// The GFSK decode's sync search (FT8, FT4, JS8, FST4, FST4W): the sync
// score with its non-maximum suppression (NMS), the hybrid top-K and the
// decision-directed half-hop refinement, three launches a decode_program
// call with no host sync.
//
// They replace the XLA program of cwsl_digi_tpu/modes/gfsk_engine.py:435-473
// (the shifted-slice sync correlation, base, the NMS reduce_window and two
// lax.top_k) and :517-551 (the fine-grid sync map and its three lookups a
// candidate).  Their plain versions are gfsk_engine.py:sync_score_plain,
// sync_select_plain and sync_refine_plain (under sync_candidates_plain),
// which make ~100 launches a call: 2 x 21 slice-to-float32 copies and adds
// of the 256 x 1793 map at FT8, max_pool2d and where, two stable full
// sorts of 459,008 scores a window to keep 256 + 256, and for the refine
// branch a bf16 copy of |demod|^2 and a 513 x 1793 float32 map built from
// 21 more slices only to read 3 x 512 entries of it.
//
// What bounds them on an H100 (a 24-window FT8 call).
//
//   - sync_score reads once the cells of the bf16 power map that its
//     scores need (the 21 cells' 256 x 1793 windows: rows below 880, bins
//     below 1821; 76.7 MB) and writes the score and its NMS-masked copy
//     (2 x 44 MB): ~0.049 ms of HBM.  Its operations (21 adds, a division
//     and 45 compares a score) are ~0.02 ms at the FP32 rate: bytes bound
//     it.  The two maps are written (and read back by sync_select) only
//     because score and selection are two kernels: as one, the stage's
//     bytes would take ~0.023 ms.
//   - sync_select reads the two maps once (88 MB, ~0.026 ms) and writes
//     24 x 512 candidates: bytes bound it.  What costs is the selection's
//     passes over a window's 459,008 keys: a radix select reads them four
//     times (three digit histograms, one gather of the keys above the
//     k-th) plus an ordered scan for the ties at the k-th key, which stops
//     once enough are taken, on 48 of the card's 132 SMs.
//   - sync_refine reads each candidate's 3 x 21 demod cells (8 B each, a
//     scattered 32-byte sector apiece; ~4.7 MB of distinct cells, the raw
//     half's neighbours sharing some) and writes tt: ~0.0015 ms of HBM,
//     latency bound by the scattered loads.
//
// The design.
//
//   - sync_score: a block of 256 threads a 32 x 64 tile of (t0, f0), with
//     the NMS halo (os_t/2 rows, os_f/2 columns each side) computed into
//     shared memory as well (1.33x the scores at FT8).  Each score is the
//     plain version's sequence of float adds, float(power[os_t sym + t0,
//     os_f tone + f0]) cell after cell in spec order, then one IEEE
//     division by base + 1e-30f: bitwise the plain version's.  The cells'
//     row and column offsets go in as a kernel argument (at most 40, FST4's
//     count); the power map is read through L1/L2 (a tile's 21 cell windows
//     are ~50 KB of distinct bf16).  The mask is max_pool2d's: neighbours
//     outside the map do not count (-inf in the halo), a score is kept
//     where it is >= every neighbour (a plateau keeps all its members; a
//     NaN neighbour or score masks it), else +0.0.  Two designs measured
//     slower on an H100 80GB HBM3 at 700 W (0.376 and 0.566 ms against
//     0.326 ms at FT8's 24-window call, chip_smoke.py's sync_kernels
//     phase): 8 cell loads in flight a thread, and the cells' windows
//     staged in shared memory a Costas block at a time (the staging's
//     index arithmetic cost more than the L2 reads it saved).
//   - sync_select: a block of 1024 threads a (window, half), the NMS map's
//     top_k // 2 and the raw map's top_k - top_k // 2, written straight into
//     the concatenated [B, top_k] outputs as torch.cat lays them out, with
//     t0 = idx / n_f0 and f0 = idx % n_f0.  The order is the plain
//     version's torch.sort(stable=True, descending=True): each float maps to
//     an order-preserving uint32 key (-0.0 folded onto 0.0, every NaN to
//     0xffffffff, above +inf, as the sort puts NaN first), and (~key << 32 |
//     index) sorts ascending as value descending, lower index first on ties.
//     Radix passes of 11, 11 and 10 bits find the k-th key K (2048-bin
//     shared-memory histograms, 16 loads in flight a thread, one atomic a
//     digit a warp after a match_any grouping: most raw scores share a top
//     digit), one pass gathers the keys above K
//     (their count is known), an ordered block scan in index order takes
//     the first ties at K, and a bitonic sort of the kept pairs orders them
//     in dynamic shared memory sized to k's next power of two (at most
//     16,384 pairs, 128 KB, a half).  The value written is the map's own (so
//     -0.0 and NaN payloads stay).
//   - sync_refine: a warp a candidate, its lanes loading the 3 x n cells at
//     once; for d in 0..2 the sum over the cells, in order, of
//     float(bf16(|demod[2 os_t sym + 2 t0 + d - 1, os_f tone + f0]|^2)),
//     rows -1 and >= H read as 0 (the plain version pads a row each side);
//     |z| is correctly rounded (the double square root of the exact
//     products' sum) and squared in float32, as torch's abs() ** 2 rounds
//     on the CPU (gfsk.cu's mag2), then rounded to bf16 to nearest even as
//     torch's .to(bfloat16); delta = the first maximum's offset - 1
//     (torch.argmax: NaN counts as the maximum), tt = clamp(2 t0 + delta, 0,
//     H - 1).  No copy of |demod|^2 and no fine-grid map is made.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false -o libsync.so sync.cu

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_CELLS = 40;          // FST4's 40 sync cells
constexpr int MAX_OS_T = 16;           // NMS halo: os_t / 2 rows a side
constexpr int MAX_OS_F = 8;            // ... os_f / 2 columns a side
constexpr int SCORE_TT = 32;           // a score block's tile: rows (t0)
constexpr int SCORE_TF = 64;           // ... columns (f0)
constexpr int SCORE_THREADS = 256;
constexpr int SCORE_TILE = (SCORE_TT + MAX_OS_T) * (SCORE_TF + MAX_OS_F);
constexpr int SELECT_THREADS = 1024;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SELECT_MAX_K = 16384;    // each half's k at most (its pairs,
                                       // 128 KB of dynamic shared memory)
constexpr int SMEM_DEFAULT = 48 * 1024;  // more needs the function's opt-in
constexpr int SELECT_UNROLL = 16;      // map loads a thread has in flight
constexpr int RADIX_BINS = 2048;       // digits of 11, 11 and 10 bits
constexpr int REFINE_WARPS = 4;        // a warp a candidate
constexpr unsigned FULL = 0xffffffffu;

// The sync cells as offsets into a map: row = os * symbol, col = os_f * tone.
struct Cells {
    int n;
    int row[MAX_CELLS];
    int col[MAX_CELLS];
};

struct ScoreDims {
    int B, H, F, n_t0, n_f0, pt, pf;
};

struct SelectDims {
    int B, n, n_f0, k_nms, k_raw;
};

struct RefineDims {
    int B, K, H, F;
};

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// float -> bf16 -> float, rounding to nearest even as torch's
// c10::BFloat16(float) (NaN -> the quiet NaN 0x7fc0)
__device__ __forceinline__ float bf16_round(float x) {
    if (x != x) return __uint_as_float(0x7fc00000u);
    uint32_t u = __float_as_uint(x);
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
}

// |c| ** 2 as the plain version rounds it: |c| correctly rounded (the
// double square root of the exact float products' sum, as glibc's hypotf),
// then squared in float32 (gfsk.cu's mag2)
__device__ __forceinline__ float mag2(float2 c) {
    const double re = c.x, im = c.y;
    const float m = static_cast<float>(sqrt(re * re + im * im));
    return m * m;
}

// order-preserving key: larger float, larger key; -0.0 as 0.0; every NaN
// above +inf (torch.sort(descending=True) puts NaN first)
__device__ __forceinline__ uint32_t sort_key(float v) {
    if (v != v) return 0xffffffffu;
    uint32_t u = __float_as_uint(v);
    if (u == 0x80000000u) u = 0;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ---------------------------------------------------------------------------
// sync_score: score and NMS-masked score of a 32 x 64 tile

__global__ void __launch_bounds__(SCORE_THREADS)
k_sync_score(const uint16_t* __restrict__ power, const float* __restrict__ base,
             ScoreDims d, Cells cells, float* __restrict__ score,
             float* __restrict__ nms) {
    __shared__ float tile[SCORE_TILE];
    const int b = blockIdx.z;
    const int t_lo = blockIdx.y * SCORE_TT, f_lo = blockIdx.x * SCORE_TF;
    const int ew = SCORE_TF + 2 * d.pf, eh = SCORE_TT + 2 * d.pt;
    const float den = base[b] + 1e-30f;
    const uint16_t* pw = power + static_cast<size_t>(b) * d.H * d.F;
    for (int e = threadIdx.x; e < eh * ew; e += SCORE_THREADS) {
        const int t = t_lo - d.pt + e / ew, f = f_lo - d.pf + e % ew;
        float v = -CUDART_INF_F;        // outside the map: max_pool2d's pad
        if (t >= 0 && t < d.n_t0 && f >= 0 && f < d.n_f0) {
            const uint16_t* p = pw + static_cast<size_t>(t) * d.F + f;
            float acc = bf16_to_float(p[cells.row[0] * d.F + cells.col[0]]);
            for (int c = 1; c < cells.n; ++c)
                acc = acc
                      + bf16_to_float(p[cells.row[c] * d.F + cells.col[c]]);
            v = acc / den;
        }
        tile[e] = v;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < SCORE_TT * SCORE_TF; o += SCORE_THREADS) {
        const int r = o / SCORE_TF, c = o % SCORE_TF;
        const int t = t_lo + r, f = f_lo + c;
        if (t >= d.n_t0 || f >= d.n_f0) continue;
        const float s = tile[(r + d.pt) * ew + c + d.pf];
        bool keep = true;
        for (int i = 0; i <= 2 * d.pt; ++i)
            for (int j = 0; j <= 2 * d.pf; ++j)
                keep = keep && (s >= tile[(r + i) * ew + c + j]);
        const size_t out = (static_cast<size_t>(b) * d.n_t0 + t) * d.n_f0 + f;
        score[out] = s;
        nms[out] = keep ? s : 0.f;
    }
}

// ---------------------------------------------------------------------------
// sync_select: the top k of one map of one window, in torch.sort's order

struct SelectShared {
    unsigned hist[RADIX_BINS];
    unsigned warp_tot[SELECT_WARPS];
    unsigned prefix, want, n_gt;
};

// block-wide exclusive scan of v (every thread calls it); *total gets the sum
__device__ unsigned block_exclusive_scan(SelectShared& sh, unsigned v,
                                         unsigned* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh.warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
        unsigned w = sh.warp_tot[lane];
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = __shfl_up_sync(FULL, w, o);
            if (lane >= o) w += y;
        }
        sh.warp_tot[lane] = w;              // inclusive over warps
    }
    __syncthreads();
    const unsigned before = warp ? sh.warp_tot[warp - 1] : 0u;
    *total = sh.warp_tot[SELECT_WARPS - 1];
    __syncthreads();                        // warp_tot is reused next call
    return before + x - v;
}

__global__ void __launch_bounds__(SELECT_THREADS, 1)
k_sync_select(const float* __restrict__ nms, const float* __restrict__ score,
              SelectDims d, float* __restrict__ top_val,
              int64_t* __restrict__ top_t0, int64_t* __restrict__ top_f0) {
    __shared__ SelectShared sh;
    // (~key << 32 | index) kept: the next power of two of the larger half
    extern __shared__ unsigned long long buf[];
    const int b = blockIdx.x, half = blockIdx.y;
    const int k = half ? d.k_raw : d.k_nms;
    if (k == 0) return;
    const float* x = (half ? score : nms) + static_cast<size_t>(b) * d.n;
    const int tid = threadIdx.x, lane = tid & 31;
    const int n = d.n;
    const int step = SELECT_THREADS * SELECT_UNROLL;

    // 1. the k-th largest key, 11, 11 and 10 bits a pass from the top
    uint32_t prefix = 0, mask = 0;
    unsigned want = k;                 // rank of the k-th key among those
                                       // matching the prefix so far
    for (int pass = 0; pass < 3; ++pass) {
        const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
        const uint32_t dmask = pass == 2 ? 0x3ffu : 0x7ffu;
        for (int i = tid; i < RADIX_BINS; i += SELECT_THREADS) sh.hist[i] = 0;
        __syncthreads();
        for (int i0 = 0; i0 < n; i0 += step) {
            float v[SELECT_UNROLL];
#pragma unroll
            for (int u = 0; u < SELECT_UNROLL; ++u) {
                const int i = i0 + u * SELECT_THREADS + tid;
                v[u] = i < n ? x[i] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < SELECT_UNROLL; ++u) {
                const int i = i0 + u * SELECT_THREADS + tid;
                const uint32_t key = sort_key(v[u]);
                const bool hit = i < n && (key & mask) == prefix;
                const unsigned digit = hit ? (key >> shift) & dmask
                                           : RADIX_BINS;
                const unsigned peers = __match_any_sync(FULL, digit);
                if (hit && lane == __ffs(peers) - 1)
                    atomicAdd(&sh.hist[digit],
                              static_cast<unsigned>(__popc(peers)));
            }
        }
        __syncthreads();
        if (tid < 32) {
            // lane l holds bins 2047 - 64l down to 1984 - 64l; find the
            // digit where the count from the top first reaches want
            constexpr int PER = RADIX_BINS / 32;
            unsigned s = 0;
            for (int j = 0; j < PER; ++j)
                s += sh.hist[RADIX_BINS - 1 - PER * lane - j];
            unsigned incl = s;
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned y = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += y;
            }
            const unsigned excl = incl - s;
            if (excl < want && incl >= want) {
                unsigned above = excl;
                int bin = RADIX_BINS - 1 - PER * lane;
                while (above + sh.hist[bin] < want) above += sh.hist[bin--];
                sh.prefix = prefix | (static_cast<uint32_t>(bin) << shift);
                sh.want = want - above;
            }
        }
        __syncthreads();
        prefix = sh.prefix;
        want = sh.want;
        mask |= dmask << shift;
        __syncthreads();
    }
    const uint32_t kth = prefix;
    const unsigned n_gt = k - want;    // keys above the k-th

    // 2. the keys above it, in any order (the sort orders them)
    if (tid == 0) sh.n_gt = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += step) {
        float v[SELECT_UNROLL];
#pragma unroll
        for (int u = 0; u < SELECT_UNROLL; ++u) {
            const int i = i0 + u * SELECT_THREADS + tid;
            v[u] = i < n ? x[i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < SELECT_UNROLL; ++u) {
            const int i = i0 + u * SELECT_THREADS + tid;
            const uint32_t key = sort_key(v[u]);
            const bool gt = i < n && key > kth;
            const unsigned m = __ballot_sync(FULL, gt);
            unsigned slot = 0;
            if (m && lane == __ffs(m) - 1)
                slot = atomicAdd(&sh.n_gt, static_cast<unsigned>(__popc(m)));
            slot = __shfl_sync(FULL, slot, m ? __ffs(m) - 1 : 0);
            if (gt) {
                const unsigned pos = slot + __popc(m & ((1u << lane) - 1u));
                buf[pos] = (static_cast<unsigned long long>(~key) << 32)
                           | static_cast<unsigned>(i);
            }
        }
    }

    // 3. the first `want` keys equal to it, in index order: 4 consecutive
    //    elements a thread, a block scan a chunk, until enough are taken
    unsigned taken = 0;
    for (int c0 = 0; c0 < n && taken < want; c0 += 4 * SELECT_THREADS) {
        const int i0 = c0 + 4 * tid;
        unsigned flags = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (i0 + q < n && sort_key(x[i0 + q]) == kth) flags |= 1u << q;
        unsigned total;
        unsigned r = taken + block_exclusive_scan(sh, __popc(flags), &total);
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if ((flags >> q) & 1u) {
                if (r < want)
                    buf[n_gt + r] =
                        (static_cast<unsigned long long>(~kth) << 32)
                        | static_cast<unsigned>(i0 + q);
                ++r;
            }
        taken += total;
    }
    __syncthreads();

    // 4. bitonic sort of the k kept pairs, padded to a power of two
    int p2 = 1;
    while (p2 < k) p2 <<= 1;
    for (int i = k + tid; i < p2; i += SELECT_THREADS) buf[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= p2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < p2 / 2; i += SELECT_THREADS) {
                const int lo = 2 * stride * (i / stride) + (i % stride);
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const unsigned long long a = buf[lo], c = buf[hi];
                if ((a > c) == up) {
                    buf[lo] = c;
                    buf[hi] = a;
                }
            }
            __syncthreads();
        }
    }

    // 5. the concatenated outputs: [NMS half | raw half]
    const size_t o0 = static_cast<size_t>(b) * (d.k_nms + d.k_raw)
                      + (half ? d.k_nms : 0);
    for (int j = tid; j < k; j += SELECT_THREADS) {
        const unsigned idx = static_cast<unsigned>(buf[j] & 0xffffffffull);
        top_val[o0 + j] = x[idx];
        top_t0[o0 + j] = idx / d.n_f0;
        top_f0[o0 + j] = idx % d.n_f0;
    }
}

// ---------------------------------------------------------------------------
// sync_refine: each candidate's half-hop offset

__global__ void __launch_bounds__(REFINE_WARPS * 32)
k_sync_refine(const float2* __restrict__ demod, const int64_t* __restrict__ t0,
              const int64_t* __restrict__ f0, RefineDims d, Cells cells,
              int64_t* __restrict__ tt) {
    __shared__ float vals[REFINE_WARPS][3 * MAX_CELLS];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j = blockIdx.x * REFINE_WARPS + w;
    if (j >= d.B * d.K) return;        // the whole warp
    const int b = j / d.K, n = cells.n;
    const int t = static_cast<int>(t0[j]), f = static_cast<int>(f0[j]);
    const float2* src = demod + static_cast<size_t>(b) * d.H * d.F;
    // the warp's lanes load the 3 x n cells at once
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
    // lane dd sums offset dd's cells in order
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

Cells make_cells(const int* rows, const int* cols, int n) {
    Cells c;
    c.n = n;
    for (int i = 0; i < n; ++i) {
        c.row[i] = rows[i];
        c.col[i] = cols[i];
    }
    return c;
}

}  // namespace

extern "C" {

int sync_max_cells() { return MAX_CELLS; }
int sync_max_os_t() { return MAX_OS_T; }
int sync_max_os_f() { return MAX_OS_F; }
int sync_select_max_k() { return SELECT_MAX_K; }

// Score and NMS-masked score [B, n_t0, n_f0] float32 of power [B, H, F]
// bf16 (as uint16) over base [B] float32, on `stream`, one launch.
// dims [7]: B, H, F, n_t0, n_f0, os_t, os_f; rows / cols [n_cells]: each
// sync cell's os_t * symbol and os_f * tone.  Returns the cudaError_t.
int sync_score_launch(const int* dims, const int* rows, const int* cols,
                      int n_cells, const void* power, const void* base,
                      void* score, void* nms, void* stream) {
    ScoreDims d;
    d.B = dims[0];
    d.H = dims[1];
    d.F = dims[2];
    d.n_t0 = dims[3];
    d.n_f0 = dims[4];
    const int os_t = dims[5], os_f = dims[6];
    if (d.B < 1 || d.B > 65535 || d.n_t0 < 1 || d.n_f0 < 1 || n_cells < 1
        || n_cells > MAX_CELLS || os_t < 2 || os_t > MAX_OS_T || os_t % 2
        || os_f < 2 || os_f > MAX_OS_F || os_f % 2)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int c = 0; c < n_cells; ++c)
        if (rows[c] < 0 || cols[c] < 0 || rows[c] + d.n_t0 > d.H
            || cols[c] + d.n_f0 > d.F)
            return static_cast<int>(cudaErrorInvalidValue);
    d.pt = os_t / 2;
    d.pf = os_f / 2;
    const dim3 grid((d.n_f0 + SCORE_TF - 1) / SCORE_TF,
                    (d.n_t0 + SCORE_TT - 1) / SCORE_TT, d.B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    k_sync_score<<<grid, SCORE_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(power), static_cast<const float*>(base),
        d, make_cells(rows, cols, n_cells), static_cast<float*>(score),
        static_cast<float*>(nms));
    return static_cast<int>(cudaGetLastError());
}

// The hybrid top-K of nms and score [B, n] float32 on `stream`, one launch:
// top_val [B, k_nms + k_raw] float32, t0 and f0 [B, k_nms + k_raw] int64
// (idx / n_f0, idx % n_f0), the NMS map's k_nms first.  dims [5]: B, n,
// n_f0, k_nms, k_raw.  Returns the cudaError_t.
int sync_select_launch(const int* dims, const void* nms, const void* score,
                       void* top_val, void* t0, void* f0, void* stream) {
    SelectDims d;
    d.B = dims[0];
    d.n = dims[1];
    d.n_f0 = dims[2];
    d.k_nms = dims[3];
    d.k_raw = dims[4];
    if (d.B < 1 || d.n < 1 || d.n_f0 < 1 || d.k_nms < 0
        || d.k_raw < 1 || d.k_nms > SELECT_MAX_K || d.k_raw > SELECT_MAX_K
        || d.k_nms > d.n || d.k_raw > d.n)
        return static_cast<int>(cudaErrorInvalidValue);
    int p2 = 1;
    while (p2 < d.k_nms || p2 < d.k_raw) p2 <<= 1;
    const size_t smem = sizeof(unsigned long long) * p2;
    if (smem + sizeof(SelectShared) > SMEM_DEFAULT) {
        // per device, so set on each launch that needs it
        const cudaError_t e = cudaFuncSetAttribute(
            k_sync_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    k_sync_select<<<dim3(d.B, 2), SELECT_THREADS, smem, st>>>(
        static_cast<const float*>(nms), static_cast<const float*>(score), d,
        static_cast<float*>(top_val), static_cast<int64_t*>(t0),
        static_cast<int64_t*>(f0));
    return static_cast<int>(cudaGetLastError());
}

// The refined start hop tt [B, K] int64 of candidates t0, f0 [B, K] int64
// from demod [B, H, F] complex64, on `stream`, one launch.  dims [4]: B, K,
// H, F; rows / cols [n_cells]: each sync cell's 2 * os_t * symbol and os_f
// * tone.  Returns the cudaError_t.
int sync_refine_launch(const int* dims, const int* rows, const int* cols,
                       int n_cells, const void* demod, const void* t0,
                       const void* f0, void* tt, void* stream) {
    RefineDims d;
    d.B = dims[0];
    d.K = dims[1];
    d.H = dims[2];
    d.F = dims[3];
    if (d.B < 1 || d.K < 1 || d.B > 2147483647 / d.K || d.H < 1 || d.F < 1
        || n_cells < 1 || n_cells > MAX_CELLS)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n = d.B * d.K;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    k_sync_refine<<<(n + REFINE_WARPS - 1) / REFINE_WARPS, REFINE_WARPS * 32,
                    0, st>>>(
        static_cast<const float2*>(demod), static_cast<const int64_t*>(t0),
        static_cast<const int64_t*>(f0), d, make_cells(rows, cols, n_cells),
        static_cast<int64_t*>(tt));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
