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
//     and the NMS's compares a score) are ~0.02 ms at the FP32 rate: bytes
//     bound it.  What costs is the 21 two-byte loads a score through L1
//     (a variant with one load a score took half the time), then the NMS.
//     The two maps are written (and read back by sync_select) only because
//     score and selection are two kernels: as one, the stage's bytes would
//     take ~0.023 ms.
//   - sync_select reads the two maps once (88 MB, ~0.026 ms) and writes
//     24 x 512 candidates: bytes bound it.  What costs is the first radix
//     pass's histogram over every key, the cluster barriers between the
//     passes, and that a 16-block cluster takes a GPC: the card holds 7 at
//     once, so 48 clusters run in 7 waves of ~29 us.
//   - sync_refine reads each candidate's 3 x 21 demod cells (8 B each, a
//     scattered 32-byte sector apiece; ~4.7 MB of distinct cells, the raw
//     half's neighbours sharing some) and writes tt: ~0.0015 ms of HBM.
//     What costs: a launch and the dependent round trip to t0 and f0 (a
//     launch that does only that takes 0.0019 ms), the 774,144 scattered
//     cell loads, a 32-byte sector each (24.8 MB, ~0.0074 ms at the HBM
//     rate when cold; the loads alone take ~0.006 ms more), then |z|
//     through a double square root (~0.0022 ms against a float |z|,
//     which would lose the bits).
//
// The design.
//
//   - sync_score: a block of 256 threads a 64 x 64 region of (t0, f0) whose
//     inner (64 - os_t) x (64 - os_f) scores it writes, the rest being the
//     NMS halo (1.20x the scores at FT8's os_t = 8, os_f = 4).  A thread
//     computes one column's strip of 16 rows, 4 rows' loads in flight, so
//     a row's address is the last one's plus F.  The kernel is a template
//     on (os_t / 2, os_f / 2) and on the count of sync cells, with
//     instances for the GFSK modes' (4, 2) and (2, 1) and 16, 21 and 40
//     cells (any other geometry runs a generic instance): no division or
//     modulo is left, and the cell loop is unrolled, each cell one __ldg
//     at a constant offset (row * F + col, a kernel argument) from the
//     row's address.  Each score is the plain version's sequence of float
//     adds, float(power[os_t sym + t0, os_f tone + f0]) cell after cell in
//     spec order, then one IEEE division by base + 1e-30f: bitwise the
//     plain version's.  The NMS is separable: a max over the 2 pf + 1
//     columns into shared memory, then over the 2 pt + 1 rows, 4 + 8
//     compares at FT8 in place of 45.  The max is written by hand to
//     propagate NaN (fmaxf drops it), and cells off the map are -inf, so
//     the mask s >= max is max_pool2d's: a plateau keeps all its members,
//     a NaN neighbour or score masks, -0.0 compares as 0.0.
//   - sync_select: a thread-block cluster of C blocks of 1024 threads a
//     (window, half), the NMS map's top_k // 2 and the raw map's top_k -
//     top_k // 2, written straight into the concatenated [B, top_k]
//     outputs as torch.cat lays them out, with t0 = idx / n_f0 and f0 = idx
//     % n_f0.  The order is the plain version's torch.sort(stable=True,
//     descending=True): each float maps to an order-preserving uint32 key
//     (-0.0 folded onto 0.0, every NaN to 0xffffffff, above +inf, as the
//     sort puts NaN first), and (~key << 32 | index) sorts ascending as
//     value descending, lower index first on ties.  Block r of the cluster
//     owns the r-th contiguous slice of the map (rank order is index
//     order) and reads it from HBM once: C is the least power of two that
//     cuts a map to ~28 keys a thread, at most 16 (FT8: 16 blocks of
//     28,688 keys, 112 KB of shared memory each); a slice longer than
//     53,976 keys keeps the rest in HBM and reads it again each pass.
//     Radix passes of 11, 11 and 10 bits find the k-th key K.  The first
//     counts the top digits as it stores the keys in shared memory; each
//     pass a block counts into its own histogram (a warp keeps its first
//     digit's count in a register, as the NMS map's +0.0 and the raw map's
//     common top digit mostly share one, and adds the rest one atomic a
//     key where few, else one a digit after a match_any), adds its
//     nonzero bins into rank 0's through distributed shared memory
//     (DSMEM), and after a cluster barrier rank 0 picks the digit with a
//     block scan and writes it into every rank's shared memory before a
//     second.  After the first pass one sweep sends the keys above its
//     digit to the pair buffer and keeps those on it (the candidates) in
//     the rest of shared memory; the later passes, the keys above K and
//     the ties read only those (where they outgrow it, the whole slice
//     again).  The pair buffer is k pairs a (window, half) in HBM, a slot
//     a warp from an atomic in rank 0's shared memory.  Each block's ties
//     at K are its last histogram's count at K's digit; the ranks below
//     it give its first slot (a warp reads their counts); it writes all
//     its ties where they fit in what is still open, else its first ones
//     in index order (a block scan over its slice).  After a last cluster
//     barrier rank 0 orders the k pairs in the shared memory its keys
//     held, by counting for each pair the pairs below it (up to 1024
//     pairs; a bitonic sort above), and writes the map's own value (so
//     -0.0 and NaN payloads stay).  A 16-block cluster is a non-portable
//     size: where the card cannot hold one (cudaOccupancyMaxActiveClusters),
//     C is 8.
//   - sync_refine: a thread a (candidate, offset d in 0..2), four lanes a
//     candidate (the fourth idle; 8 a warp), 128 threads a block: FT8's
//     12,288 candidates are 384 blocks, one wave.  A thread loads
//     its candidate's t0 and f0, then issues all n cell loads of its row,
//     2 t0 + d - 1, at offsets fixed at launch (row * F + col, kernel
//     arguments) before it uses any: one round trip to memory after t0.
//     A row -1 or >= H loads the window's first cell and reads as 0 (a
//     predicate, not a branch).  The kernel is a template on the cell
//     count, with instances for 16 (FT4) and 21 (FT8, JS8) and a generic
//     one up to 40 (16 loads in flight a round).  The thread sums, in
//     spec order from the first cell,
//     float(bf16(|demod[2 os_t sym + 2 t0 + d - 1, os_f tone + f0]|^2)):
//     |z| is correctly rounded (the double square root of the exact
//     products' sum) and squared in float32, as torch's abs() ** 2 rounds
//     on the CPU (gfsk.cu's mag2), then rounded to bf16 to nearest even as
//     torch's .to(bfloat16) (NaN to 0x7fc0).  Two shuffles bring the
//     other offsets' sums to the candidate's first lane (every lane
//     shuffles; none returns before), which takes the first maximum (NaN
//     counts as the maximum, as torch.argmax), delta = its offset - 1,
//     and writes tt = clamp(2 t0 + delta, 0, H - 1).  No shared memory, no
//     copy of |demod|^2 and no fine-grid map.
//   - sync_select's cluster can be forced to 8 blocks (the C entry's
//     sixth dimension; 0 is the card's own plan): at FT8's grid that is
//     57,376 keys a block, 53,976 of them on chip and the rest read from
//     HBM again each pass, the plan a card that holds no 16-block cluster
//     runs.  The decode never forces it.
//
// Times.  At FT8's 24-window pass-1 call on an H100 80GB HBM3 at 700 W
// (chip_smoke.py's sync_kernels phase in tools/stage_kernels_ab.py,
// medians of two turns against the first port): sync_score 0.1488 ms
// (first port: a 32 x 64 tile with its halo, runtime divisions, 45
// compares, 0.3265), sync_select 0.2034 ms (first port: one block of 1024
// threads a window and half reading each map four times, 0.4354;
// torch.topk of both maps ~0.47), and forced to 8-block clusters 0.238
// ms; sync_refine 0.0118 ms (first port: a warp a candidate, its cells
// through shared memory, 0.0152).  Measured and not kept (same card,
// synthetic FT8 maps, in turns): clusters of 8 blocks with no room left
// for the candidates (0.237 against 0.202 ms); every block reading rank
// 0's sum through DSMEM instead of rank 0 writing its choice out (0.373
// against 0.349, each in its own call beside the first port's ~0.45); a
// split arrive/wait around the first pass and four threads a pair in the
// final count (0.204 against 0.202); a second register digit a warp
// (0.209); for the score, two blocks of 256 threads an SM with 128
// registers (0.180 against 0.168), and 4 columns a thread from two
// aligned 8-byte loads cut by a shift (0.162 against 0.147).  The
// streaming-threshold selection (one histogram pass, a compaction over
// many blocks, a small sort) was not built: the cluster beat both the
// first port and torch.topk.  For the refinement (the decoder's own
// inputs, tools/sync_refine_variants.py): three lanes a candidate, 10 a
// warp (0.0122 against 0.0118 ms; at 786,432 candidates 0.305 against
// 0.309); one thread a candidate with all 63 loads in flight (0.0171, 142
// registers); the refinement in sync_select's epilogue, rank 0's thread
// that writes a candidate loading its cells (score + selection 0.650 ms
// against score + selection + refinement 0.367: in a block of 1024
// threads the loads get 64 registers and spill, and the selection with
// them).  Yardsticks that give up the bits: a launch that reads t0 and f0
// and writes tt with no cell 0.0019 ms, the kept layout's cell loads
// summed with no |z| 0.0080, with |z| in float 0.0093, against the kept
// 0.0116 in the same turns; the candidates sorted by (f0, t0), so that
// neighbours share sectors, 0.0110.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false -o libsync.so sync.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CELLS = 40;          // FST4's 40 sync cells
constexpr int MAX_OS_T = 16;           // NMS halo: os_t / 2 rows a side
constexpr int MAX_OS_F = 8;            // ... os_f / 2 columns a side
constexpr int SCORE_SIDE = 64;         // a score block's region, halo included
constexpr int SCORE_THREADS = 256;     // a column's strip of rows a thread
constexpr int SCORE_GROUPS = SCORE_THREADS / SCORE_SIDE;
constexpr int SCORE_ROWS = SCORE_SIDE / SCORE_GROUPS;
constexpr int SELECT_THREADS = 1024;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SELECT_MAX_K = 16384;    // each half's k at most (its pairs,
                                       // 128 KB of shared memory to sort)
constexpr int SELECT_MAX_CLUSTER = 16;
constexpr int SELECT_KEYS_BLOCK = 28 * SELECT_THREADS;  // keys a block aims at
constexpr int SELECT_UNROLL = 16;      // map loads a thread has in flight
constexpr int RADIX_BINS = 2048;       // digits of 11, 11 and 10 bits
constexpr int REFINE_THREADS = 128;
constexpr int REFINE_GROUP = 4;        // a candidate's lanes: one an offset,
                                       // the fourth idle
constexpr unsigned FULL = 0xffffffffu;

// The refinement's sync cells: row = 2 os_t symbol, and that row's cell
// as one offset from the candidate's own, row * F + os_f tone.
struct RefineCells {
    int n;
    int row[MAX_CELLS];
    int off[MAX_CELLS];
};

// ... as one offset from a score's own cell: row * F + col
struct CellOffsets {
    int off[MAX_CELLS];
};

struct ScoreDims {
    int B, H, F, n_t0, n_f0, pt, pf, n_cells;
};

struct SelectDims {
    int B, n, n_f0, k_nms, k_raw;
    int slice;     // a block's keys: rank r owns [r slice, (r + 1) slice)
    int cached;    // ... the first of them kept in shared memory
    int p2;        // the pair buffer's stride a (window, half)
    int smem;      // dynamic shared memory bytes
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

// the larger of a and b, NaN if either is (max_pool2d's; fmaxf drops NaN)
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// Cells c0 .. c0 + M - 1 (those below n) of one refinement offset added
// to e in spec order, e taken from the first cell: bf16(|z|^2) of cell c
// at src[base + off[c]] on row row[c] + r0 of h, a row outside [0, h)
// read as 0 (the plain version pads a row each side).  The M loads are
// issued before any is used: a cell off the map loads src[0] and drops it.
template <int M>
__device__ __forceinline__ float add_cells(float e,
                                           const float2* __restrict__ src,
                                           int r0, int base, int h,
                                           const RefineCells& cells, int c0,
                                           int n) {
    float2 z[M];
    bool in[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
        const int c = min(c0 + i, MAX_CELLS - 1);
        in[i] = c0 + i < n && static_cast<unsigned>(cells.row[c] + r0)
                              < static_cast<unsigned>(h);
        z[i] = __ldg(src + (in[i] ? base + cells.off[c] : 0));
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
        if (c0 + i < n) {
            const float v = in[i] ? bf16_round(mag2(z[i])) : 0.f;
            e = c0 + i ? e + v : v;
        }
    return e;
}

constexpr int REFINE_CHUNK = 16;       // the generic instance's loads in
                                       // flight a round

// One refinement offset's energy over the NC sync cells, all NC loads in
// flight at once; NC = 0 reads the count from cells and loads
// REFINE_CHUNK cells a round.
template <int NC>
__device__ __forceinline__ float cell_energy(const float2* __restrict__ src,
                                             int r0, int base, int h,
                                             const RefineCells& cells) {
    if (NC) return add_cells<NC ? NC : 1>(0.f, src, r0, base, h, cells, 0, NC);
    float e = 0.f;
    for (int c0 = 0; c0 < cells.n; c0 += REFINE_CHUNK)
        e = add_cells<REFINE_CHUNK>(e, src, r0, base, h, cells, c0, cells.n);
    return e;
}

// ---------------------------------------------------------------------------
// sync_score: score and NMS-masked score of a 64 x 64 region's inner tile

// PT, PF: os_t / 2 and os_f / 2, NC: the sync cells; 0 reads them from d
template <int PT, int PF, int NC>
__global__ void __launch_bounds__(SCORE_THREADS, 4)
k_sync_score(const uint16_t* __restrict__ power, const float* __restrict__ base,
             ScoreDims d, CellOffsets cells, float* __restrict__ score,
             float* __restrict__ nms) {
    __shared__ float tile[SCORE_SIDE][SCORE_SIDE];   // scores; -inf off the map
    __shared__ float rmax[SCORE_SIDE][SCORE_SIDE];   // their max along f0
    const int pt = PT ? PT : d.pt, pf = PF ? PF : d.pf;
    const int out_t = SCORE_SIDE - 2 * pt, out_f = SCORE_SIDE - 2 * pf;
    const int b = blockIdx.z;
    const int t_lo = blockIdx.y * out_t, f_lo = blockIdx.x * out_f;
    const int col = threadIdx.x % SCORE_SIDE, grp = threadIdx.x / SCORE_SIDE;
    const float den = base[b] + 1e-30f;

    // 1. the region's scores: column col, rows grp * 16 .. + 15
    const int f = f_lo - pf + col;
    const bool f_in = f >= 0 && f < d.n_f0;
    const int r0 = grp * SCORE_ROWS;
    const uint16_t* pw = power + static_cast<size_t>(b) * d.H * d.F;
#pragma unroll 4
    for (int j = 0; j < SCORE_ROWS; ++j) {
        const int t = t_lo - pt + r0 + j;
        float v = -CUDART_INF_F;        // off the map: max_pool2d's pad
        if (f_in && t >= 0 && t < d.n_t0) {
            const uint16_t* p = pw + static_cast<size_t>(t) * d.F + f;
            float acc = bf16_to_float(__ldg(p + cells.off[0]));
            if (NC) {
#pragma unroll
                for (int c = 1; c < NC; ++c)
                    acc = acc + bf16_to_float(__ldg(p + cells.off[c]));
            } else {
                for (int c = 1; c < d.n_cells; ++c)
                    acc = acc + bf16_to_float(__ldg(p + cells.off[c]));
            }
            v = acc / den;
        }
        tile[r0 + j][col] = v;
    }
    __syncthreads();

    // 2. the max over each score's 2 pf + 1 columns
    if (col < out_f) {
#pragma unroll 4
        for (int j = 0; j < SCORE_ROWS; ++j) {
            const int r = r0 + j;
            float m = tile[r][col];
#pragma unroll
            for (int i = 1; i <= 2 * pf; ++i) m = nan_max(m, tile[r][col + i]);
            rmax[r][col] = m;
        }
    }
    __syncthreads();

    // 3. then over its 2 pt + 1 rows: a score is kept where it is >= that
    const int per = (out_t + SCORE_GROUPS - 1) / SCORE_GROUPS;
    const int fo = f_lo + col;
    if (col >= out_f || fo >= d.n_f0) return;
#pragma unroll
    for (int j = 0; j < per; ++j) {
        const int r = grp * per + j;
        const int t = t_lo + r;
        if (r >= out_t || t >= d.n_t0) break;
        float m = rmax[r][col];
#pragma unroll
        for (int i = 1; i <= 2 * pt; ++i) m = nan_max(m, rmax[r + i][col]);
        const float s = tile[r + pt][col + pf];
        const size_t o = (static_cast<size_t>(b) * d.n_t0 + t) * d.n_f0 + fo;
        score[o] = s;
        nms[o] = s >= m ? s : 0.f;
    }
}

// ---------------------------------------------------------------------------
// sync_select: the top k of one map of one window, in torch.sort's order

constexpr int SMEM_BLOCK_MAX = 232448;  // 227 KB: a block's shared memory

struct SelectShared {
    unsigned hist[RADIX_BINS];         // this block's counts of a pass's digit
    unsigned sum[RADIX_BINS];          // rank 0: the cluster's
    unsigned warp_tot[SELECT_WARPS];
    uint32_t prefix;                   // the key's bits chosen so far
    unsigned want;                     // ... the k-th's rank among their keys
    unsigned n_gt;                     // rank 0: pair slots taken above K
    unsigned n_cand;                   // candidates under the first digit
    unsigned n_tie;                    // ties at K written
    unsigned before;                   // ties at K in the ranks below this one
};

// a block's dynamic shared memory: its keys, then the candidates under the
// first pass's digit; on rank 0 at the end, the pairs to sort
constexpr int SELECT_SMEM_MAX =
    static_cast<int>((SMEM_BLOCK_MAX - sizeof(SelectShared)) / 16 * 16);
constexpr int SELECT_CACHE_KEYS = SELECT_SMEM_MAX / 4;

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

// Count a warp's digits (the lanes with hit) into the block's histogram.
// The warp keeps one digit's count in a register, wcnt of digit wdig (the
// first it meets; most keys share it: the NMS map's +0.0, the raw map's
// common top digit); the others go to the histogram, one atomic a key where
// they are few, else one a digit after a match_any.  Every lane calls it.
__device__ __forceinline__ void count_digits(unsigned* hist, bool hit,
                                             unsigned digit, unsigned& wdig,
                                             unsigned& wcnt, int lane) {
    const unsigned hits = __ballot_sync(FULL, hit);
    if (hits == 0) return;
    if (wdig == FULL) wdig = __shfl_sync(FULL, digit, __ffs(hits) - 1);
    const unsigned same = __ballot_sync(FULL, hit && digit == wdig);
    wcnt += __popc(same);
    const unsigned rest = hits & ~same;
    if (rest == 0) return;
    const bool mine = (rest >> lane) & 1u;
    if (__popc(rest) <= 2) {
        if (mine) atomicAdd(&hist[digit], 1u);
    } else {
        const unsigned peers = __match_any_sync(FULL, mine ? digit : FULL);
        if (mine && lane == __ffs(peers) - 1)
            atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
    }
}

// Write the pairs (~key << 32 | index) of the lanes with take at the slots
// that one atomic on *counter a warp reserves, from base.  Every lane calls.
__device__ __forceinline__ void put_pairs(unsigned long long* pr,
                                          unsigned* counter, unsigned base,
                                          bool take, uint32_t key,
                                          unsigned index, int lane) {
    const unsigned m = __ballot_sync(FULL, take);
    if (m == 0) return;
    const int first = __ffs(m) - 1;
    unsigned slot = 0;
    if (lane == first)
        slot = atomicAdd(counter, static_cast<unsigned>(__popc(m)));
    slot = __shfl_sync(FULL, slot, first);
    if (take)
        pr[base + slot + __popc(m & ((1u << lane) - 1u))] =
            (static_cast<unsigned long long>(~key) << 32) | index;
}

__global__ void __launch_bounds__(SELECT_THREADS, 1)
k_sync_select(const float* __restrict__ nms, const float* __restrict__ score,
              SelectDims d, float* __restrict__ top_val,
              int64_t* __restrict__ top_t0, int64_t* __restrict__ top_f0,
              unsigned long long* __restrict__ pairs) {
    __shared__ SelectShared sh;
    extern __shared__ __align__(16) unsigned char dyn[];
    uint32_t* keys = reinterpret_cast<uint32_t*>(dyn);
    // (key << 32 | slice index) of the keys under the first digit, after
    // the keys (8-byte aligned); cap of them fit
    const int cand_at = (d.cached + 1) / 2 * 8;
    unsigned long long* cand =
        reinterpret_cast<unsigned long long*>(dyn + cand_at);
    const unsigned cap = static_cast<unsigned>((d.smem - cand_at) / 8);
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const unsigned which = blockIdx.x / cluster.num_blocks();
    const int b = static_cast<int>(which >> 1), half = which & 1;
    const int k = half ? d.k_raw : d.k_nms;
    if (k == 0) return;                // every block of the cluster
    const float* x = (half ? score : nms) + static_cast<size_t>(b) * d.n;
    unsigned long long* pr =
        pairs + (static_cast<size_t>(b) * 2 + half) * d.p2;
    SelectShared* sh0 = cluster.map_shared_rank(&sh, 0);
    const int tid = threadIdx.x, lane = tid & 31;
    const long long lo_ll = static_cast<long long>(rank) * d.slice;
    const int lo = static_cast<int>(lo_ll < d.n ? lo_ll : d.n);
    const int len = min(d.n - lo, d.slice);
    const int cached = min(len, d.cached);
    const int steps = (len + SELECT_THREADS - 1) / SELECT_THREADS;
    auto key_at = [&](int i) -> uint32_t {
        return i < cached ? keys[i] : sort_key(x[lo + i]);
    };
    for (int i = tid; i < RADIX_BINS; i += SELECT_THREADS) {
        sh.hist[i] = 0;
        sh.sum[i] = 0;
    }
    if (tid == 0) {
        sh.n_gt = 0;
        sh.n_cand = 0;
        sh.n_tie = 0;
    }
    __syncthreads();

    // 1. the k-th largest key, 11, 11 and 10 bits a pass from the top.
    //    The first pass counts the slice as it reads it from HBM (its only
    //    read) into shared memory as keys; the rest of a slice too long for
    //    shared memory is read again each pass
    uint32_t prefix = 0, mask = 0;
    unsigned want = k;                 // rank of the k-th key among those
                                       // matching the prefix so far
    bool spilled = false;              // candidates beyond cap: full scans
    unsigned n_cand = 0;
    for (int pass = 0; pass < 3; ++pass) {
        const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
        const uint32_t dmask = pass == 2 ? 0x3ffu : 0x7ffu;
        unsigned wdig = FULL, wcnt = 0;
        if (pass == 0) {
            for (int i0 = 0; i0 < len; i0 += SELECT_UNROLL * SELECT_THREADS) {
                float v[SELECT_UNROLL];
#pragma unroll
                for (int u = 0; u < SELECT_UNROLL; ++u) {
                    const int i = i0 + u * SELECT_THREADS + tid;
                    v[u] = i < len ? x[lo + i] : 0.f;
                }
#pragma unroll
                for (int u = 0; u < SELECT_UNROLL; ++u) {
                    const int i = i0 + u * SELECT_THREADS + tid;
                    const uint32_t key = sort_key(v[u]);
                    if (i < cached) keys[i] = key;
                    count_digits(sh.hist, i < len, key >> 21, wdig, wcnt,
                                 lane);
                }
            }
        } else if (!spilled) {
            for (int c0 = 0; c0 < static_cast<int>(n_cand);
                 c0 += SELECT_THREADS) {
                const int c = c0 + tid;
                const uint32_t key = c < static_cast<int>(n_cand)
                    ? static_cast<uint32_t>(cand[c] >> 32) : 0u;
                count_digits(sh.hist,
                             c < static_cast<int>(n_cand)
                                 && (key & mask) == prefix,
                             (key >> shift) & dmask, wdig, wcnt, lane);
            }
        } else {
#pragma unroll 4
            for (int j = 0; j < steps; ++j) {
                const int i = j * SELECT_THREADS + tid;
                const uint32_t key = i < len ? key_at(i) : 0u;
                count_digits(sh.hist, i < len && (key & mask) == prefix,
                             (key >> shift) & dmask, wdig, wcnt, lane);
            }
        }
        if (lane == 0 && wcnt) atomicAdd(&sh.hist[wdig], wcnt);
        __syncthreads();
        if (pass == 0) cluster.sync();  // rank 0's sum is cleared
        for (int i = tid; i < RADIX_BINS; i += SELECT_THREADS)
            if (sh.hist[i]) atomicAdd(&sh0->sum[i], sh.hist[i]);
        cluster.sync();                // every block's counts are in
        if (rank == 0) {
            // the digit where the count from the top first reaches want:
            // thread t holds bins 2047 - 2t and 2046 - 2t; then the choice
            // goes to every rank and the sum is cleared for the next pass
            const unsigned c0 = sh.sum[RADIX_BINS - 1 - 2 * tid];
            const unsigned c1 = sh.sum[RADIX_BINS - 2 - 2 * tid];
            unsigned total;
            const unsigned excl = block_exclusive_scan(sh, c0 + c1, &total);
            if (excl < want && excl + c0 + c1 >= want) {
                const bool top = excl + c0 >= want;
                const unsigned bin = RADIX_BINS - (top ? 1 : 2) - 2 * tid;
                sh.prefix = prefix | (static_cast<uint32_t>(bin) << shift);
                sh.want = want - (top ? excl : excl + c0);
            }
            sh.sum[RADIX_BINS - 1 - 2 * tid] = 0;
            sh.sum[RADIX_BINS - 2 - 2 * tid] = 0;
            __syncthreads();
            if (tid > 0 && tid < static_cast<int>(cluster.num_blocks())) {
                SelectShared* o = cluster.map_shared_rank(&sh, tid);
                o->prefix = sh.prefix;
                o->want = sh.want;
            }
        }
        cluster.sync();                // rank 0's choice is everywhere
        if (pass < 2)
            for (int i = tid; i < RADIX_BINS; i += SELECT_THREADS)
                sh.hist[i] = 0;
        prefix = sh.prefix;
        want = sh.want;
        mask |= dmask << shift;
        if (pass == 0) {
            // the keys above the first digit are above K: to the pairs;
            // those under it are the later passes' candidates
            const uint32_t top = prefix >> 21;
#pragma unroll 4
            for (int j = 0; j < steps; ++j) {
                const int i = j * SELECT_THREADS + tid;
                const uint32_t key = i < len ? key_at(i) : 0u;
                put_pairs(pr, &sh0->n_gt, 0, i < len && (key >> 21) > top,
                          key, static_cast<unsigned>(lo + i), lane);
                const bool is_cand = i < len && (key >> 21) == top;
                const unsigned m = __ballot_sync(FULL, is_cand);
                if (m == 0) continue;
                const int first = __ffs(m) - 1;
                unsigned slot = 0;
                if (lane == first)
                    slot = atomicAdd(&sh.n_cand,
                                     static_cast<unsigned>(__popc(m)));
                slot = __shfl_sync(FULL, slot, first)
                       + __popc(m & ((1u << lane) - 1u));
                if (is_cand && slot < cap)
                    cand[slot] = (static_cast<unsigned long long>(key) << 32)
                                 | static_cast<unsigned>(i);
            }
        }
        __syncthreads();
        if (pass == 0) {
            n_cand = sh.n_cand;
            spilled = n_cand > cap;
        }
    }
    const uint32_t kth = prefix;
    const unsigned n_gt = k - want;    // keys above the k-th
    const unsigned last = kth & 0x3ffu;

    // 2. this block's ties at K (its last count at K's digit) and those of
    //    the ranks below it, whose slices come first in index order
    if (tid < 32) {
        const unsigned v = static_cast<unsigned>(tid) < rank
            ? cluster.map_shared_rank(&sh, tid)->hist[last] : 0u;
        const unsigned before = __reduce_add_sync(FULL, v);
        if (tid == 0) sh.before = before;
    }
    __syncthreads();
    const unsigned before = sh.before, mine = sh.hist[last];
    const unsigned take = before < want ? min(mine, want - before) : 0u;

    // 3. the keys under the first digit above K, in any order (the sort
    //    orders them), and where this block takes all its ties, those too
    const uint32_t top = kth >> 21;
    if (!spilled) {
        for (int c0 = 0; c0 < static_cast<int>(n_cand); c0 += SELECT_THREADS) {
            const int c = c0 + tid;
            const bool in = c < static_cast<int>(n_cand);
            const unsigned long long e = in ? cand[c] : 0ull;
            const uint32_t key = static_cast<uint32_t>(e >> 32);
            const unsigned index = lo + static_cast<unsigned>(e & 0xffffffffu);
            put_pairs(pr, &sh0->n_gt, 0, in && key > kth, key, index, lane);
            put_pairs(pr, &sh.n_tie, n_gt + before,
                      in && key == kth && take == mine, key, index, lane);
        }
    } else {
#pragma unroll 4
        for (int j = 0; j < steps; ++j) {
            const int i = j * SELECT_THREADS + tid;
            const uint32_t key = i < len ? key_at(i) : 0u;
            const unsigned index = static_cast<unsigned>(lo + i);
            put_pairs(pr, &sh0->n_gt, 0,
                      i < len && key > kth && (key >> 21) == top, key, index,
                      lane);
            put_pairs(pr, &sh.n_tie, n_gt + before,
                      i < len && key == kth && take == mine, key, index, lane);
        }
    }

    // 4. else its first ties at K in index order, up to those still open:
    //    4 consecutive keys a thread, a block scan a chunk
    if (take > 0 && take < mine) {
        unsigned taken = 0;
        for (int c0 = 0; c0 < len && taken < take; c0 += 4 * SELECT_THREADS) {
            const int i0 = c0 + 4 * tid;
            unsigned flags = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (i0 + q < len && key_at(i0 + q) == kth) flags |= 1u << q;
            unsigned total;
            unsigned r = taken + block_exclusive_scan(sh, __popc(flags), &total);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if ((flags >> q) & 1u) {
                    if (r < take)
                        pr[n_gt + before + r] =
                            (static_cast<unsigned long long>(~kth) << 32)
                            | static_cast<unsigned>(lo + i0 + q);
                    ++r;
                }
            taken += total;
        }
    }
    cluster.sync();                    // all k pairs are written (the
                                       // barrier orders global memory too)
    if (rank != 0) return;

    // 5. the k pairs in order where rank 0's keys were: up to a block's
    //    threads, each pair's place is the count of pairs below it (they
    //    differ: the indices do); else a bitonic sort, padded to a power
    //    of two
    unsigned long long* buf = reinterpret_cast<unsigned long long*>(dyn);
    const size_t o0 = static_cast<size_t>(b) * (d.k_nms + d.k_raw)
                      + (half ? d.k_nms : 0);
    if (k <= SELECT_THREADS) {
        if (tid < k) buf[tid] = __ldcg(pr + tid);
        __syncthreads();
        if (tid >= k) return;
        const unsigned long long mine = buf[tid];
        int place = 0;
#pragma unroll 8
        for (int j = 0; j < k; ++j) place += buf[j] < mine;
        const unsigned idx = static_cast<unsigned>(mine & 0xffffffffull);
        top_val[o0 + place] = x[idx];
        top_t0[o0 + place] = idx / d.n_f0;
        top_f0[o0 + place] = idx % d.n_f0;
        return;
    }
    int p2 = 1;
    while (p2 < k) p2 <<= 1;
    for (int i = tid; i < p2; i += SELECT_THREADS)
        buf[i] = i < k ? __ldcg(pr + i) : ~0ull;
    __syncthreads();
    for (int size = 2; size <= p2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < p2 / 2; i += SELECT_THREADS) {
                const int lo2 = 2 * stride * (i / stride) + (i % stride);
                const int hi = lo2 + stride;
                const bool up = (lo2 & size) == 0;
                const unsigned long long a = buf[lo2], c = buf[hi];
                if ((a > c) == up) {
                    buf[lo2] = c;
                    buf[hi] = a;
                }
            }
            __syncthreads();
        }
    }

    // 6. the concatenated outputs: [NMS half | raw half]
    for (int j = tid; j < k; j += SELECT_THREADS) {
        const unsigned idx = static_cast<unsigned>(buf[j] & 0xffffffffull);
        top_val[o0 + j] = x[idx];
        top_t0[o0 + j] = idx / d.n_f0;
        top_f0[o0 + j] = idx % d.n_f0;
    }
}

// ---------------------------------------------------------------------------
// sync_refine: each candidate's half-hop offset

// NC: the cell count (0 reads it from cells); G: lanes a candidate, 3 (one
// an offset, lanes 30 and 31 idle) or 4 (the fourth idle)
template <int NC, int G>
__global__ void __launch_bounds__(REFINE_THREADS)
k_sync_refine(const float2* __restrict__ demod, const int64_t* __restrict__ t0,
              const int64_t* __restrict__ f0, RefineDims d, RefineCells cells,
              int64_t* __restrict__ tt) {
    static_assert(G == 3 || G == 4, "a lane an offset");
    constexpr int PER_WARP = 32 / G;
    const int lane = threadIdx.x & 31, g = lane / G, dd = lane - G * g;
    const int j = (blockIdx.x * (REFINE_THREADS / 32) + (threadIdx.x >> 5))
                  * PER_WARP + g;
    const bool live = g < PER_WARP && dd < 3 && j < d.B * d.K;
    int t = 0;
    float e = 0.f;
    if (live) {
        t = static_cast<int>(__ldg(t0 + j));
        const int f = static_cast<int>(__ldg(f0 + j));
        const int r0 = 2 * t + dd - 1;
        e = cell_energy<NC>(demod + static_cast<size_t>(j / d.K) * d.H * d.F,
                            r0, r0 * d.F + f, d.H, cells);
    }
    // every lane shuffles (none has returned); lane G g reads its
    // candidate's other two offsets and takes the first maximum, NaN
    // counting as the maximum (torch.argmax)
    const float e1 = __shfl_down_sync(FULL, e, 1);
    const float e2 = __shfl_down_sync(FULL, e, 2);
    if (!live || dd != 0) return;
    const float ev[3] = {e, e1, e2};
    int best = 0;
#pragma unroll
    for (int k = 1; k < 3; ++k) {
        const bool nan_k = ev[k] != ev[k], nan_b = ev[best] != ev[best];
        if ((nan_k && !nan_b) || (!nan_b && ev[k] > ev[best])) best = k;
    }
    const int r = 2 * t + best - 1;
    tt[j] = r < 0 ? 0 : (r > d.H - 1 ? d.H - 1 : r);
}

using RefineKernel = void (*)(const float2*, const int64_t*, const int64_t*,
                              RefineDims, RefineCells, int64_t*);

// the refinement's instance for the cell count: FT4's 16, FT8's and JS8's
// 21, else the generic one
RefineKernel refine_kernel(int n_cells) {
    switch (n_cells) {
        case 16: return k_sync_refine<16, REFINE_GROUP>;
        case 21: return k_sync_refine<21, REFINE_GROUP>;
        default: return k_sync_refine<0, REFINE_GROUP>;
    }
}

using ScoreKernel = void (*)(const uint16_t*, const float*, ScoreDims,
                             CellOffsets, float*, float*);

// the score kernel's instance for (os_t / 2, os_f / 2) and the cell count:
// the GFSK modes' geometries, else the generic one
template <int PT, int PF>
ScoreKernel score_for_cells(int n_cells) {
    switch (n_cells) {
        case 16: return k_sync_score<PT, PF, 16>;
        case 21: return k_sync_score<PT, PF, 21>;
        case 40: return k_sync_score<PT, PF, 40>;
        default: return k_sync_score<PT, PF, 0>;
    }
}

ScoreKernel score_kernel(int pt, int pf, int n_cells) {
    if (pt == 4 && pf == 2) return score_for_cells<4, 2>(n_cells);
    if (pt == 2 && pf == 1) return score_for_cells<2, 1>(n_cells);
    return k_sync_score<0, 0, 0>;
}

// How a selection is cut: blocks a cluster, keys a block, keys kept on
// chip, dynamic shared memory, the pair buffer's stride.
struct SelectPlan {
    int cluster, slice, cached, smem, p2;
};

constexpr int MAX_DEVICES = 64;

// Once a device: the kernel's shared-memory and cluster-size opt-ins, and
// whether the card holds a 16-block cluster of it.  Returns the
// cudaError_t; *fits16 gets the answer.
cudaError_t select_setup(bool* fits16) {
    static int state[MAX_DEVICES];     // 0 unknown, 1 holds 16, 2 does not
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (state[dev] == 0) {
        e = cudaFuncSetAttribute(k_sync_select,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SELECT_SMEM_MAX);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(k_sync_select,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
        if (e != cudaSuccess) return e;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(SELECT_MAX_CLUSTER, 1, 1);
        cfg.blockDim = dim3(SELECT_THREADS, 1, 1);
        cfg.dynamicSmemBytes = SELECT_SMEM_MAX;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = SELECT_MAX_CLUSTER;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int n = 0;
        e = cudaOccupancyMaxActiveClusters(
            &n, reinterpret_cast<const void*>(k_sync_select), &cfg);
        if (e != cudaSuccess) return e;
        state[dev] = n > 0 ? 1 : 2;
    }
    *fits16 = state[dev] == 1;
    return cudaSuccess;
}

// cluster: 0 for the card's own plan, else the blocks a cluster (8 or 16)
SelectPlan select_plan(const SelectDims& d, bool fits16, int cluster) {
    SelectPlan p;
    const long long n = d.n;
    int c = cluster;
    if (c == 0) {
        c = 1;
        while (c < SELECT_MAX_CLUSTER && (n + c - 1) / c > SELECT_KEYS_BLOCK)
            c <<= 1;
        if (c == SELECT_MAX_CLUSTER && !fits16) c = SELECT_MAX_CLUSTER / 2;
    }
    p.cluster = c;
    p.slice = static_cast<int>((n + c - 1) / c);
    p.cached = p.slice < SELECT_CACHE_KEYS ? p.slice : SELECT_CACHE_KEYS;
    p.p2 = 1;
    while (p.p2 < d.k_nms || p.p2 < d.k_raw) p.p2 <<= 1;
    p.smem = SELECT_SMEM_MAX;          // a block has the SM to itself
    return p;
}

// dims [6]: B, n, n_f0, k_nms, k_raw and the blocks a cluster (0: the
// card's own plan; else 8 or 16), checked; the plan and *d filled
cudaError_t select_prepare(const int* dims, SelectDims* d, SelectPlan* p) {
    d->B = dims[0];
    d->n = dims[1];
    d->n_f0 = dims[2];
    d->k_nms = dims[3];
    d->k_raw = dims[4];
    const int cluster = dims[5];
    if (d->B < 1 || d->n < 1 || d->n_f0 < 1 || d->k_nms < 0
        || d->k_raw < 1 || d->k_nms > SELECT_MAX_K || d->k_raw > SELECT_MAX_K
        || d->k_nms > d->n || d->k_raw > d->n
        || (cluster != 0 && cluster != SELECT_MAX_CLUSTER / 2
            && cluster != SELECT_MAX_CLUSTER))
        return cudaErrorInvalidValue;
    bool fits16 = false;
    const cudaError_t e = select_setup(&fits16);
    if (e != cudaSuccess) return e;
    *p = select_plan(*d, fits16, cluster);
    if (static_cast<long long>(d->B) * 2 * p->cluster > 2147483647LL)
        return cudaErrorInvalidValue;
    d->slice = p->slice;
    d->cached = p->cached;
    d->p2 = p->p2;
    d->smem = p->smem;
    return cudaSuccess;
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
    d.n_cells = n_cells;
    const int os_t = dims[5], os_f = dims[6];
    if (d.B < 1 || d.B > 65535 || d.n_t0 < 1 || d.n_f0 < 1 || n_cells < 1
        || n_cells > MAX_CELLS || os_t < 2 || os_t > MAX_OS_T || os_t % 2
        || os_f < 2 || os_f > MAX_OS_F || os_f % 2)
        return static_cast<int>(cudaErrorInvalidValue);
    CellOffsets cells;
    for (int c = 0; c < n_cells; ++c) {
        if (rows[c] < 0 || cols[c] < 0 || rows[c] + d.n_t0 > d.H
            || cols[c] + d.n_f0 > d.F)
            return static_cast<int>(cudaErrorInvalidValue);
        cells.off[c] = rows[c] * d.F + cols[c];
    }
    d.pt = os_t / 2;
    d.pf = os_f / 2;
    const int out_t = SCORE_SIDE - 2 * d.pt, out_f = SCORE_SIDE - 2 * d.pf;
    const dim3 grid((d.n_f0 + out_f - 1) / out_f, (d.n_t0 + out_t - 1) / out_t,
                    d.B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    score_kernel(d.pt, d.pf, n_cells)<<<grid, SCORE_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(power), static_cast<const float*>(base),
        d, cells, static_cast<float*>(score), static_cast<float*>(nms));
    return static_cast<int>(cudaGetLastError());
}

// The hybrid top-K of nms and score [B, n] float32 on `stream`, one launch:
// top_val [B, k_nms + k_raw] float32, t0 and f0 [B, k_nms + k_raw] int64
// (idx / n_f0, idx % n_f0), the NMS map's k_nms first.  dims [6]: B, n,
// n_f0, k_nms, k_raw and the blocks a cluster (0: the card's own plan, C =
// 16 where it holds such a cluster, else 8; or 8 or 16); pairs: scratch of
// B * 2 * p2 uint64, p2 the least power of two >= k_raw.  Returns the
// cudaError_t.
int sync_select_launch(const int* dims, const void* nms, const void* score,
                       void* top_val, void* t0, void* f0, void* pairs,
                       void* stream) {
    SelectDims d;
    SelectPlan p;
    cudaError_t e = select_prepare(dims, &d, &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.cluster * 2 * d.B, 1, 1);
    cfg.blockDim = dim3(SELECT_THREADS, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, k_sync_select,
                           static_cast<const float*>(nms),
                           static_cast<const float*>(score), d,
                           static_cast<float*>(top_val),
                           static_cast<int64_t*>(t0),
                           static_cast<int64_t*>(f0),
                           static_cast<unsigned long long*>(pairs));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// The selection's cut for dims [6] (as sync_select_launch takes them):
// out [7] = blocks a cluster, threads a block, keys a block, of them kept
// in shared memory, dynamic shared memory bytes, the pair buffer's stride,
// and the clusters of that shape the card holds at once.  Returns the
// cudaError_t.
int sync_select_plan(const int* dims, int* out) {
    SelectDims d;
    SelectPlan p;
    cudaError_t e = select_prepare(dims, &d, &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.cluster, 1, 1);
    cfg.blockDim = dim3(SELECT_THREADS, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(k_sync_select), &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int vals[7] = {p.cluster, SELECT_THREADS, p.slice, p.cached,
                         p.smem, p.p2, n};
    for (int i = 0; i < 7; ++i) out[i] = vals[i];
    return 0;
}

// A kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes):
// which 0 = sync_select, 1 = sync_score's instance for os_t = 8, os_f = 4
// and n_cells, 2 = sync_refine's instance for n_cells (any count; the
// generic instance where none is compiled).  out [4].  Returns the
// cudaError_t.
int sync_kernel_attrs(int which, int n_cells, int* out) {
    cudaFuncAttributes a;
    cudaError_t e;
    if (which == 0)
        e = cudaFuncGetAttributes(&a, k_sync_select);
    else if (which == 1)
        e = cudaFuncGetAttributes(&a, score_kernel(4, 2, n_cells));
    else if (which == 2)
        e = cudaFuncGetAttributes(&a, refine_kernel(n_cells));
    else
        return static_cast<int>(cudaErrorInvalidValue);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

// The refined start hop tt [B, K] int64 of candidates t0, f0 [B, K] int64
// (t0 < n_t0 and f0 < n_f0 of the grid the cells were checked for) from
// demod [B, H, F] complex64, on `stream`, one launch.  dims [4]: B, K, H,
// F ((H + 1) F < 2**31); rows / cols [n_cells]: each sync cell's 2 * os_t *
// symbol (at most H) and os_f * tone (below F).  Returns the cudaError_t.
int sync_refine_launch(const int* dims, const int* rows, const int* cols,
                       int n_cells, const void* demod, const void* t0,
                       const void* f0, void* tt, void* stream) {
    RefineDims d;
    d.B = dims[0];
    d.K = dims[1];
    d.H = dims[2];
    d.F = dims[3];
    if (d.B < 1 || d.K < 1 || d.B > 2147483647 / d.K || d.H < 1 || d.F < 1
        || static_cast<long long>(d.H + 1) * d.F > 2147483647LL
        || n_cells < 1 || n_cells > MAX_CELLS)
        return static_cast<int>(cudaErrorInvalidValue);
    RefineCells cells = {};
    cells.n = n_cells;
    for (int c = 0; c < n_cells; ++c) {
        if (rows[c] < 0 || rows[c] > d.H || cols[c] < 0 || cols[c] >= d.F)
            return static_cast<int>(cudaErrorInvalidValue);
        cells.row[c] = rows[c];
        cells.off[c] = rows[c] * d.F + cols[c];
    }
    const long long n = static_cast<long long>(d.B) * d.K;
    constexpr int per_block = REFINE_THREADS / 32 * (32 / REFINE_GROUP);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    refine_kernel(n_cells)<<<static_cast<unsigned>(
                                 (n + per_block - 1) / per_block),
                             REFINE_THREADS, 0, st>>>(
        static_cast<const float2*>(demod), static_cast<const int64_t*>(t0),
        static_cast<const int64_t*>(f0), d, cells,
        static_cast<int64_t*>(tt));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
