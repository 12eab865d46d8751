// The exact median of each row of a map (median_rows), with no host sync:
// the q-ary modes' (JT65, Q65-30) sync-map and prior medians, WSPR's and
// the GFSK engine's SNR medians.
//
// It replaces jnp.median at cwsl_digi_tpu/modes/qary_engine.py:136 and
// :168, wspr.py:507 and gfsk_engine.py:676 (a full sort of each row).  Its
// plain version is modes/gfsk_engine.py:_median_rows_plain, a full
// torch.sort of each row.
//
// What bounds it on an H100: it reads each row once and writes one float a
// row, so bytes bound it (JT65's 15-window sync map: 224 MB, ~0.067 ms of
// HBM).  Most calls are small (Q65's priors, the GFSK modes' SNR rows):
// there what costs is a launch and the chain of dependent steps of one
// selection, each ended by a barrier.
//
// The selection (select_loop).  Each float maps to an order key (-0.0
// read as 0.0, as jnp.median's sort does; every NaN to 0xffffffff, above
// +inf).  The two middle ranks r0 = (n - 1) / 2 and r1 = n / 2 are found
// digit by digit from the top, 11 bits a pass: a pass counts the digits of
// the keys under the prefix chosen so far, and a scan of the counts
// (pick: a run of bins a thread, two block barriers) finds the digit of r0
// and of r1 = r0 + 1 for an even count.  Where the two digits differ, r0 is
// the last key under its prefix and r1 the first under its own, so one
// sweep of max and min ends it.  Where the chosen digit holds at most
// FIN_CAP keys, they are gathered into one block and sorted there by a
// bitonic network (a key a thread), which hands both ranks at once.  A
// first pass's top bin holds only NaN keys: a row with one has the median
// NaN.  An even count gives 0.5f * (a + b) of the two middle values.  Bit
// for bit the plain version's.
//
// The plans, chosen by the wrapper (modes/_median_kernels.py:median_plan)
// from the row's length n and the rows:
//
//   - small (n <= 8,192: Q65's [B x 24, 4,032] priors): one launch, a block
//     of 256 threads a row (k_median_onchip<false>), six an SM.  It reads
//     the row once into shared memory as keys, counting the first digit as
//     it goes, and runs every pass there.  No workspace, no memset.
//   - mid (n <= 16 x 32,768: the GFSK modes' SNR rows, FT8's [B, 85,002]
//     strided view, WSPR's noise map): one launch, a thread-block cluster of C
//     = 2..16 blocks of 512 threads a row (k_median_onchip<true>): 16 (8 where
//     the card holds no 16-block cluster), halved while the rows take more
//     than a block an SM, but no fewer than leave 32,768 keys a block (more
//     blocks load a row faster; a cluster's barriers cost about the same at
//     any size).  Each block reads its slice of the row once into shared
//     memory.  A pass: each block counts its keys, adds its nonzero counts
//     into every block's merged counts through distributed shared memory
//     (reductions, no round trip; double buffered by pass), one cluster
//     barrier, and every block picks the digit itself (the pattern of
//     sync.cu's sync_select, with no decision to send).  Once a digit holds
//     few enough keys (a tenth of a row, at most CAND_MAX), the blocks gather
//     them into rank 0 (one reservation a block), which goes on alone.  No
//     workspace, no memset.
//   - large (longer rows: the JT65 and Q65 sync maps, 9-15 MB a row):
//     three launches.  k_median_sample (a cluster of 8 blocks a row) reads
//     16,384 entries of the row at stratified positions and selects the
//     two sample keys lo and hi MARGIN ranks outside the middle ranks'
//     places in the sample.  k_median_stream (16,384 entries a block,
//     float4 loads, the next round's in flight while one is counted) reads
//     the row once: it counts the entries below lo, on lo and on hi as
//     floats, and stages every key in shared memory but keeps only those
//     strictly between lo and hi (no branch or vote a key), copying them
//     into a candidate buffer (~4.7 % of a row) one reservation a warp.
//     k_median_finish (a cluster of 8 blocks a row) places each middle
//     rank: on lo, on hi, or among the candidates, which it selects under
//     lo's and hi's common bits.  Where a middle rank falls outside [lo,
//     hi] or the candidates overflow the buffer (an eighth of a row; the
//     sample did not stand for the row), it selects over the whole row
//     again (slow, exact).  k_median_sample writes the workspace: no
//     memset.
//
// Built with --fmad=false and without fast math, so 0.5f * (a + b) is the
// IEEE float operations written here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Profiling hooks, empty in the library: tools/median_profile.py builds
// this file with them defined to read clock64() at a kernel's phase
// boundaries (MEDIAN_SPAN_BEGIN(id) opens kernel id's spans, MEDIAN_SPAN(k)
// closes span k of the calling warp).
#ifndef MEDIAN_SPANS
#define MEDIAN_SPAN_BEGIN(id)
#define MEDIAN_SPAN(k)
#define MEDIAN_SPAN_END()
#endif

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;         // per-device settings kept
constexpr int SMEM_BLOCK_MAX = 232448;  // 227 KB: a block's shared memory

constexpr int RADIX_BINS = 2048;        // 11-bit digits
constexpr int FIN_CAP = 256;            // keys sorted at the end
constexpr int PICK_PER = 8;             // bins a thread in a pick
constexpr int CAND_MAX = 16384;         // keys a mid plan's rank 0 goes on
                                        // alone with, at most
constexpr int ONCHIP_THREADS_MAX = 512;
constexpr int MAX_CLUSTER = 16;

constexpr int SAMPLE = 16384;           // the large plan's sample a row
constexpr int MARGIN = 384;             // sample ranks outside the middle
constexpr int SAMPLE_THREADS = 512;
constexpr int FINISH_THREADS = 512;
constexpr int SAMPLE_CLUSTER = 8;
constexpr int SAMPLE_CAND = 2048;       // keys the sample's rank 0 goes on
                                        // alone with
constexpr int FINISH_CLUSTER = 8;
constexpr int FINISH_CAND = 8192;       // keys the finish's rank 0 goes on
                                        // alone with
constexpr int STREAM_THREADS = 256;
constexpr int STREAM_VEC = 4;           // float4 loads a thread a round
constexpr int STREAM_CHUNK = 16384;     // entries a block
constexpr int THREAD_STAGE = 32;        // candidates a thread stages
// a row's workspace in the large plan (uint32): lo, hi, keys below lo,
// equal to lo, equal to hi (hi != lo), candidates, the NaN flag
constexpr int WS_LO = 0, WS_HI = 1, WS_BELOW = 2, WS_EQLO = 3, WS_EQHI = 4,
              WS_INSIDE = 5, WS_NAN = 6;
constexpr int WS_WORDS = 8;

// The ascending order of float32 as uint32: -0.0 read as 0.0, every NaN
// above +inf.
__device__ __forceinline__ uint32_t order_key(float x) {
    if (x != x) return FULL;
    const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a non-NaN order key (a zero key gives +0.0).
__device__ __forceinline__ float key_value(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The median of n keys from its two middle keys (equal for an odd n).
__device__ __forceinline__ float median_value(uint32_t k0, uint32_t k1,
                                              long long n) {
    const float a = key_value(k0);
    return (n & 1) ? a : 0.5f * (a + key_value(k1));
}

// The bits of a key above `low` (low < 32 keeps some; 32 none).
__device__ __forceinline__ uint32_t high_mask(uint32_t low) {
    return low >= 32 ? 0u : (FULL << low);
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One block alone, or the blocks of a cluster: rank, size, the barrier
// and a pointer into a rank's shared memory.
template <bool CL>
struct Group;

template <>
struct Group<false> {
    __device__ unsigned rank() const { return 0; }
    __device__ unsigned size() const { return 1; }
    __device__ void sync() const { __syncthreads(); }
    template <class T>
    __device__ T* at(T* p, unsigned) const { return p; }
};

template <>
struct Group<true> {
    __device__ unsigned rank() const {
        return cg::this_cluster().block_rank();
    }
    __device__ unsigned size() const {
        return cg::this_cluster().num_blocks();
    }
    __device__ void sync() const { cg::this_cluster().sync(); }
    template <class T>
    __device__ T* at(T* p, unsigned r) const {
        return cg::this_cluster().map_shared_rank(p, r);
    }
};

// What the picking block decided after a pass.
enum : uint32_t { GO = 0, DONE = 1, SPLIT = 2, FINISH = 3, ISNAN = 4 };

struct Decision {
    uint32_t prefix;   // the lower middle's key bits above `low`
    uint32_t low;      // its undecided low bits
    uint32_t r0;       // its rank among the keys under prefix
    uint32_t even;     // r0 + 1 is wanted too
    uint32_t state;
    uint32_t p1;       // SPLIT: the upper middle's prefix
    uint32_t count;    // keys under prefix
    uint32_t nan;      // a first pass's top bin (NaN keys only) ends it
};

template <bool CL>
struct SelShared {
    alignas(16) uint32_t hist[RADIX_BINS];  // a pass's counts, this block's
    // a cluster's counts of a pass, every block's added in (by pass parity:
    // a pass's are still read while the next pass's come in)
    alignas(16) uint32_t mrg[CL ? 2 : 1][CL ? RADIX_BINS : 4];
    uint32_t fin[FIN_CAP];                  // rank 0: the last keys
    uint32_t warp_tot[32];
    uint32_t found[4];                      // d0, rank in d0, count, d1
    uint32_t n_fin, n_cand, kmax, kmin, nan;
    uint32_t base, n_loc;                   // a gather's reservation
    uint32_t bmax, bmin;                    // a split's block extremes
    uint32_t res[2];                        // the two middle keys
};

// Keys from an array (shared or global memory), or from a row of floats.
struct KeysAt {
    const uint32_t* p;
    __device__ uint32_t operator()(long long i) const { return p[i]; }
};

struct FloatsAt {
    const float* x;
    __device__ uint32_t operator()(long long i) const {
        return order_key(x[i]);
    }
};

// The picking block (every thread): the digits of the wanted ranks in
// bins[nbins] (a power of two; the counts of the keys under d.prefix by
// their digit at `shift`), cleared as read; returns the next decision.
// Thread t holds a run of at most PICK_PER bins, a warp scan and the
// warps' totals place each rank in a thread, which finds its bin: two
// block barriers.  A lone block also clears the sweeps' counters (a
// cluster's rank 0 clears them between its barriers).
template <bool CL, class SH>
__device__ Decision pick(SH& sh, uint32_t* bins, int nbins,
                         const Decision& d, uint32_t shift) {
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const int warp = tid >> 5;
    const int per = nbins > nt ? nbins / nt : 1;
    const int b0 = tid * per;
    uint32_t c[PICK_PER];
    if (per >= 4) {
        // (a thread's run whole in uint4s: no bank conflicts to speak of)
#pragma unroll
        for (int j = 0; j < PICK_PER; j += 4) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (j < per) {
                uint4* at = reinterpret_cast<uint4*>(bins + b0 + j);
                v = *at;
                *at = make_uint4(0u, 0u, 0u, 0u);
            }
            c[j] = v.x;
            c[j + 1] = v.y;
            c[j + 2] = v.z;
            c[j + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < PICK_PER; ++j) {
            const bool in = j < per && b0 + j < nbins;
            c[j] = in ? bins[b0 + j] : 0u;
            if (in) bins[b0 + j] = 0u;
        }
    }
    uint32_t mine = 0;
    bool nan = false;
#pragma unroll
    for (int j = 0; j < PICK_PER; ++j) {
        mine += c[j];
        nan |= b0 + j == RADIX_BINS - 1 && c[j] != 0u;
    }
    uint32_t incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) sh.warp_tot[warp] = incl;
    if (tid == 0 && !CL) {
        sh.kmax = 0u;
        sh.kmin = FULL;
        sh.n_fin = 0u;
    }
    if (d.nan && d.low == 32 && nan) sh.nan = 1u;
    __syncthreads();
    // the warps below this one (a scan of the warps' totals over lanes)
    const uint32_t wt = lane < (nt >> 5) ? sh.warp_tot[lane] : 0u;
    uint32_t wi = wt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, wi, o);
        if (lane >= o) wi += y;
    }
    uint32_t run = __shfl_sync(FULL, wi - wt, warp) + incl - mine;
    const uint32_t r0 = d.r0, r1 = d.r0 + 1;
    if ((r0 >= run && r0 - run < mine)
        || (d.even && r1 >= run && r1 - run < mine)) {
#pragma unroll
        for (int j = 0; j < PICK_PER; ++j) {
            if (r0 >= run && r0 - run < c[j]) {
                sh.found[0] = b0 + j;
                sh.found[1] = r0 - run;
                sh.found[2] = c[j];
            }
            if (d.even && r1 >= run && r1 - run < c[j]) sh.found[3] = b0 + j;
            run += c[j];
        }
    }
    __syncthreads();
    const uint32_t d0 = sh.found[0];
    const uint32_t d1 = d.even ? sh.found[3] : d0;
    Decision nd = d;
    nd.prefix = d.prefix | (d0 << shift);
    nd.p1 = d.prefix | (d1 << shift);
    nd.low = shift;
    nd.r0 = sh.found[1];
    nd.count = sh.found[2];
    if (d.nan && d.low == 32 && sh.nan) {
        nd.state = ISNAN;
    } else if (d1 != d0) {
        nd.state = SPLIT;
    } else if (shift == 0) {
        nd.state = DONE;
    } else if (nd.count <= FIN_CAP) {
        nd.state = FINISH;
    } else {
        nd.state = GO;
    }
    return nd;
}

// A sweep's SWEEP_U keys of this thread from i0 (whole warps step
// together: the ballots of a sweep need every lane), all loads issued
// before any is used.
constexpr int SWEEP_U = 8;

template <class Src>
__device__ __forceinline__ void sweep_load(const Src& src, long long len,
                                           long long i0, uint32_t* k,
                                           bool* in) {
#pragma unroll
    for (int u = 0; u < SWEEP_U; ++u) {
        const long long i = i0 + static_cast<long long>(u) * blockDim.x
                            + threadIdx.x;
        in[u] = i < len;
        k[u] = in[u] ? src(i) : 0u;
    }
}

// The keys of this block's sweep under `prefix` (its bits in hm), `own`
// of them, into dst from a block's reservation of own slots on *counter
// (rank 0's: one remote atomic a block), then a slot a key from the
// block's local count; every thread calls it.
template <class SH, class Src>
__device__ void gather_keys(SH& sh, const Src& src, long long len,
                            uint32_t hm, uint32_t prefix, uint32_t own,
                            uint32_t* dst, uint32_t* counter, uint32_t cap) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        sh.base = own ? atomicAdd(counter, own) : 0u;
        sh.n_loc = 0u;
    }
    __syncthreads();
    const uint32_t base = sh.base;
    for (long long i0 = 0; i0 < len; i0 += SWEEP_U * blockDim.x) {
        uint32_t k[SWEEP_U];
        bool in[SWEEP_U];
        sweep_load(src, len, i0, k, in);
#pragma unroll
        for (int u = 0; u < SWEEP_U; ++u) {
            const bool t = in[u] && (k[u] & hm) == prefix;
            const unsigned m = __ballot_sync(FULL, t);
            if (m == 0) continue;
            const int first = __ffs(m) - 1;
            uint32_t slot = 0;
            if (lane == first)
                slot = atomicAdd(&sh.n_loc, static_cast<uint32_t>(__popc(m)));
            slot = base + __shfl_sync(FULL, slot, first)
                   + __popc(m & ((1u << lane) - 1u));
            if (t && slot < cap) dst[slot] = k[u];
        }
    }
}

// Rank 0's last step: its n = nd.count (<= FIN_CAP, at most the block's
// threads) keys in fin sorted by a bitonic network, a key a thread (FULL
// past n), through shuffles below a warp and hist (left clear) above;
// ranks nd.r0 (and nd.r0 + 1) into sh.res.
template <class SH>
__device__ void finish_sort(SH& sh, const Decision& nd) {
    const int tid = threadIdx.x, nt = blockDim.x;
    uint32_t k = tid < static_cast<int>(nd.count) ? sh.fin[tid] : FULL;
    for (int size = 2; size <= nt; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            uint32_t o;
            if (stride >= 32) {
                sh.hist[tid] = k;
                __syncthreads();
                o = sh.hist[tid ^ stride];
                __syncthreads();
            } else {
                o = __shfl_xor_sync(FULL, k, stride);
            }
            const bool lower = (tid & stride) == 0;
            const bool up = (tid & size) == 0;
            k = lower == up ? min(k, o) : max(k, o);
        }
    }
    sh.hist[tid] = 0u;
    if (tid == static_cast<int>(nd.r0)) sh.res[0] = k;
    if (tid == static_cast<int>(nd.even ? nd.r0 + 1 : nd.r0)) sh.res[1] = k;
    __syncthreads();
}

// The radix selection of the two middle keys (see the file header) over
// this block's keys src(0 .. len), from decision d (the same in every
// block of a cluster).  With `counted`, sh.hist already holds this
// block's counts of the first pass.  In a cluster, where a pass leaves at
// most cand_cap keys under the prefix, they are gathered into rank 0's
// cand and rank 0 goes on alone.  Returns 1 on the block that ends it,
// with the two keys in sh.res, 2 there for a NaN row, else 0.
template <bool CL, class SH, class Src>
__device__ int select_loop(SH& sh, const Src& src, long long len,
                           bool counted, const Group<CL>& g, Decision d,
                           uint32_t* cand, uint32_t cand_cap) {
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const bool lead = g.rank() == 0;
    SH* sh0 = g.at(&sh, 0);
    int parity = 0;
    for (;;) {
        const uint32_t bits = d.low < 11 ? d.low : 11;
        const uint32_t shift = d.low - bits;
        const uint32_t hm = high_mask(d.low);
        const uint32_t dm = (1u << bits) - 1u;
        const int nbins = 1 << bits;
        // (every count is cleared where it is read: the merge, the pick)
        if (!counted) {
            for (long long i0 = 0; i0 < len; i0 += SWEEP_U * nt) {
                uint32_t k[SWEEP_U];
                bool in[SWEEP_U];
                sweep_load(src, len, i0, k, in);
#pragma unroll
                for (int u = 0; u < SWEEP_U; ++u)
                    if (in[u] && (k[u] & hm) == d.prefix)
                        atomicAdd(&sh.hist[(k[u] >> shift) & dm], 1u);
            }
        }
        counted = false;
        __syncthreads();
        MEDIAN_SPAN(1);
        uint32_t* bins = sh.hist;
        if (CL) {
            // this block's nonzero counts added into every block's merged
            // counts (reductions, no round trip), then one cluster barrier
            uint32_t* m = sh.mrg[parity];
            const int c = static_cast<int>(g.size());
            for (int i = tid; i < nbins; i += nt) {
                const uint32_t v = sh.hist[i];
                if (v == 0u) continue;
                for (int q = 0; q < c; ++q) atomicAdd(g.at(m, q) + i, v);
            }
            if (lead && tid == 0) {    // for the sweeps after this pass
                sh.kmax = 0u;
                sh.kmin = FULL;
                sh.n_fin = 0u;
                sh.n_cand = 0u;
            }
            g.sync();                  // every block's counts are in
            bins = m;
            parity ^= 1;
        }
        MEDIAN_SPAN(2);
        const Decision nd = pick<CL>(sh, bins, nbins, d, shift);
        // this block's own keys under the new prefix (a cluster's local
        // counts are cleared here, after the pick's barriers)
        uint32_t own = nd.count;
        if (CL) {
            own = sh.hist[(nd.prefix >> shift) & dm];
            __syncthreads();
            for (int i = tid; i < nbins; i += nt) sh.hist[i] = 0u;
            __syncthreads();
        }
        MEDIAN_SPAN(3);
        if (nd.state == ISNAN) return lead ? 2 : 0;
        if (nd.state == DONE) {
            if (lead && tid == 0) sh.res[0] = sh.res[1] = nd.prefix;
            if (lead) __syncthreads();
            return lead ? 1 : 0;
        }
        const uint32_t hn = high_mask(nd.low);
        if (nd.state == SPLIT) {
            // r0 is the last key under its prefix, r1 the first under its
            uint32_t vmax = 0u, vmin = FULL;
            for (long long i0 = 0; i0 < len; i0 += SWEEP_U * nt) {
                uint32_t k[SWEEP_U];
                bool in[SWEEP_U];
                sweep_load(src, len, i0, k, in);
#pragma unroll
                for (int u = 0; u < SWEEP_U; ++u) {
                    if (in[u] && (k[u] & hn) == nd.prefix)
                        vmax = max(vmax, k[u]);
                    if (in[u] && (k[u] & hn) == nd.p1)
                        vmin = min(vmin, k[u]);
                }
            }
            vmax = __reduce_max_sync(FULL, vmax);
            vmin = __reduce_min_sync(FULL, vmin);
            if (tid == 0) {
                sh.bmax = 0u;
                sh.bmin = FULL;
            }
            __syncthreads();
            if (lane == 0) {
                atomicMax(&sh.bmax, vmax);
                atomicMin(&sh.bmin, vmin);
            }
            __syncthreads();
            if (tid == 0) {            // a block's, then the cluster's
                atomicMax(&sh0->kmax, sh.bmax);
                atomicMin(&sh0->kmin, sh.bmin);
            }
            g.sync();
            MEDIAN_SPAN(4);
            if (!lead) return 0;
            if (tid == 0) {
                sh.res[0] = sh.kmax;
                sh.res[1] = sh.kmin;
            }
            __syncthreads();
            return 1;
        }
        if (nd.state == FINISH) {
            // the keys under the prefix into rank 0's fin, then sorted
            gather_keys(sh, src, len, hn, nd.prefix, own, g.at(sh.fin, 0),
                        &sh0->n_fin, FIN_CAP);
            g.sync();
            MEDIAN_SPAN(4);
            if (!lead) return 0;
            finish_sort(sh, nd);
            return 1;
        }
        if (CL && cand != nullptr && nd.count <= cand_cap) {
            // few enough keys left: into rank 0, which goes on alone
            gather_keys(sh, src, len, hn, nd.prefix, own, g.at(cand, 0),
                        &sh0->n_cand, cand_cap);
            g.sync();
            MEDIAN_SPAN(4);
            if (!lead) return 0;
            return select_loop<false>(sh, KeysAt{cand}, nd.count, false,
                                      Group<false>(), nd, nullptr, 0u);
        }
        d = nd;
    }
}

// ---------------------------------------------------------------------------
// small and mid plans: the row on chip

// a row [A, B] of the input: entry (a, b) at a * sa + b * sb from the row's
// first, rows sr apart (all in floats)
struct RowView {
    long long n, sr, sa, sb;
    int A, B;
    int kpb;            // keys a block
    int cand;           // keys rank 0 goes on alone with (a cluster)
};

template <bool CL>
__global__ void __launch_bounds__(CL ? ONCHIP_THREADS_MAX : 256, CL ? 2 : 6)
k_median_onchip(const float* __restrict__ x, RowView v,
                float* __restrict__ out) {
    __shared__ SelShared<CL> sh;
    // this block's keys, then (a cluster's) the keys rank 0 goes on with
    extern __shared__ uint32_t keys[];
    MEDIAN_SPAN_BEGIN(CL ? 1 : 0);
    const Group<CL> g;
    const int tid = threadIdx.x, nt = blockDim.x;
    const unsigned rank = g.rank();
    const long long row = blockIdx.x / g.size();
    for (int i = tid; i < RADIX_BINS; i += nt) {
        sh.hist[i] = 0u;
        if (CL) sh.mrg[0][i] = sh.mrg[1][i] = 0u;
    }
    if (tid == 0) sh.nan = 0u;
    __syncthreads();
    if (CL) cluster_arrive();          // the merged counts are clear

    // this block's slice of the row into shared memory as keys, counting
    // the first digit; the view's (a, b) stepped by the block's threads
    const long long lo_ll = static_cast<long long>(rank) * v.kpb;
    const long long lo = lo_ll < v.n ? lo_ll : v.n;
    const int len = static_cast<int>(min(v.n - lo,
                                         static_cast<long long>(v.kpb)));
    const float* xr = x + row * v.sr;
    constexpr int U = 16;
    const bool flat = v.sb == 1 && (v.A == 1 || v.sa == v.B);  // contiguous
    const long long f0 = lo + tid;
    long long a = flat ? 0 : f0 / v.B;
    int b = flat ? 0 : static_cast<int>(f0 - a * v.B);
    const int da = nt / v.B, db = nt - da * v.B;
    for (int i0 = 0; i0 < len; i0 += U * nt) {
        float val[U];
        if (flat) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * nt + tid;
                val[u] = i < len ? __ldg(xr + lo + i) : 0.0f;
            }
        } else {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * nt + tid;
                val[u] = i < len ? __ldg(xr + a * v.sa + b * v.sb) : 0.0f;
                a += da;
                b += db;
                if (b >= v.B) {
                    b -= v.B;
                    ++a;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = i0 + u * nt + tid;
            if (i < len) {
                const uint32_t k = order_key(val[u]);
                keys[i] = k;
                atomicAdd(&sh.hist[k >> 21], 1u);
            }
        }
    }
    if (CL) cluster_wait();
    MEDIAN_SPAN(0);
    const Decision d{0u, 32u, static_cast<uint32_t>((v.n - 1) / 2),
                     (v.n & 1) ? 0u : 1u, GO, 0u, 0u, 1u};
    const int got = select_loop<CL>(sh, KeysAt{keys}, len, true, g, d,
                                    CL ? keys + v.kpb : nullptr,
                                    static_cast<uint32_t>(v.cand));
    if (tid == 0 && got)
        out[row] = got == 2 ? __uint_as_float(0x7fc00000u)
                            : median_value(sh.res[0], sh.res[1], v.n);
    MEDIAN_SPAN_END();
}

// ---------------------------------------------------------------------------
// large plan: a sample, one streaming read, the candidates

// The sample's j-th position in a row of n (n > SAMPLE): one in each
// stratum of n / SAMPLE entries, at a hashed offset.
__device__ __forceinline__ long long sample_pos(int j, long long n) {
    const long long step = n / SAMPLE;
    const uint32_t h = static_cast<uint32_t>(j) * 2654435761u;
    return static_cast<long long>(j) * n / SAMPLE
           + static_cast<long long>(h % static_cast<uint64_t>(step));
}

// a cluster of SAMPLE_CLUSTER blocks a row, each gathering a slice of the
// sample (the row's scattered reads spread over as many SMs)
__global__ void __launch_bounds__(SAMPLE_THREADS, 2)
k_median_sample(const float* __restrict__ x, long long n, long long sr,
                uint32_t* __restrict__ ws_all) {
    __shared__ SelShared<true> sh;
    // SAMPLE / SAMPLE_CLUSTER keys, then the keys rank 0 goes on with
    extern __shared__ uint32_t samp[];
    MEDIAN_SPAN_BEGIN(2);
    const Group<true> g;
    const int tid = threadIdx.x, nt = blockDim.x;
    const unsigned rank = g.rank();
    const long long row = blockIdx.x / SAMPLE_CLUSTER;
    const float* xr = x + row * sr;
    uint32_t* ws = ws_all + row * WS_WORDS;
    constexpr int PER = SAMPLE / SAMPLE_CLUSTER / SAMPLE_THREADS;
    constexpr int SLICE = SAMPLE / SAMPLE_CLUSTER;
    uint32_t* cand = samp + SLICE;
    const int j0 = static_cast<int>(rank) * SLICE;
    for (int i = tid; i < RADIX_BINS; i += nt)
        sh.hist[i] = sh.mrg[0][i] = sh.mrg[1][i] = 0u;
    if (tid == 0) sh.nan = 0u;
    __syncthreads();
    cluster_arrive();                  // the merged counts are clear
    float v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u)
        v[u] = __ldg(xr + sample_pos(j0 + u * nt + tid, n));
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const uint32_t k = order_key(v[u]);
        samp[u * nt + tid] = k;
        atomicAdd(&sh.hist[k >> 21], 1u);
    }
    __syncthreads();
    cluster_wait();
    MEDIAN_SPAN(0);
    // lo and hi: the sample keys MARGIN ranks below the lower middle's
    // place in the sample and above the upper middle's
    const long long r0 = (n - 1) / 2, r1 = n / 2;
    const long long a0 = r0 * SAMPLE / n - MARGIN;
    const long long b0 = r1 * SAMPLE / n + MARGIN;
    const uint32_t a = static_cast<uint32_t>(a0 < 0 ? 0 : a0);
    const uint32_t b = static_cast<uint32_t>(
        b0 > SAMPLE - 1 ? SAMPLE - 1 : b0);
    uint32_t ends[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const uint32_t q = e == 0 ? a : b;
        select_loop<true>(sh, KeysAt{samp}, SLICE, e == 0, g,
                          Decision{0u, 32u, q, 0u, GO, 0u, 0u, 0u},
                          cand, SAMPLE_CAND);
        ends[e] = sh.res[0];
        g.sync();                      // rank 0 is done with this one
    }
    if (rank == 0 && tid == 0) {
        ws[WS_LO] = ends[0];
        ws[WS_HI] = ends[1];
        ws[WS_BELOW] = ws[WS_EQLO] = ws[WS_EQHI] = 0u;
        ws[WS_INSIDE] = ws[WS_NAN] = 0u;
    }
    MEDIAN_SPAN_END();
}

// The candidates' (lo < key < hi) common bits: those lo and hi share, as
// a selection's prefix above `low`.
struct CandDigit {
    uint32_t prefix, low;
};

__device__ __forceinline__ CandDigit cand_digit(uint32_t lo, uint32_t hi) {
    const uint32_t common = lo == hi ? 32u : __clz(lo ^ hi);
    const uint32_t low = 32u - common;
    return CandDigit{lo & high_mask(low), low};
}

__global__ void __launch_bounds__(STREAM_THREADS)
k_median_stream(const float* __restrict__ x, long long n, long long sr,
                long long cap, uint32_t* __restrict__ ws_all,
                uint32_t* __restrict__ buf) {
    __shared__ uint32_t tstage[THREAD_STAGE][STREAM_THREADS];
    __shared__ uint32_t s_tot[4];
    MEDIAN_SPAN_BEGIN(3);
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const long long row = blockIdx.y;
    uint32_t* ws = ws_all + row * WS_WORDS;
    const uint32_t lo = ws[WS_LO], hi = ws[WS_HI];
    // the keys' order is the floats' (NaN aside, which only sets the flag:
    // its row's median is NaN), so the counts compare floats
    const float lo_f = key_value(lo), hi_f = key_value(hi);
    const float hi_eq = hi != lo ? hi_f : __uint_as_float(0x7fc00000u);
    if (tid < 4) s_tot[tid] = 0u;
    __syncthreads();

    uint32_t below = 0, eqlo = 0, eqhi = 0;
    bool nan = false;
    // this thread's staged candidates: every entry's key is written, the
    // count only grows for a candidate (no branch, no vote a key)
    uint32_t staged = 0;
    uint32_t* brow = buf + row * cap;
    auto take = [&](float val) {
        nan |= val != val;
        below += val < lo_f;
        eqlo += val == lo_f;
        eqhi += val == hi_eq;
        const float z = val + 0.0f;          // -0.0 as 0.0
        const uint32_t u = __float_as_uint(z);
        tstage[staged][tid] = u ^ ((static_cast<int>(u) >> 31)
                                   | 0x80000000u);
        staged += val > lo_f && val < hi_f;
    };
    // the staged candidates of the warp to the row's buffer (one
    // reservation a warp); every lane calls it
    auto flush = [&]() {
        uint32_t before = staged;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(FULL, before, o);
            if (lane >= o) before += y;
        }
        const uint32_t total = __shfl_sync(FULL, before, 31);
        before -= staged;
        uint32_t base = 0;
        if (lane == 0 && total) base = atomicAdd(&ws[WS_INSIDE], total);
        base = __shfl_sync(FULL, base, 0) + before;
        for (uint32_t i = 0; i < staged; ++i)
            if (base + i < cap) brow[base + i] = tstage[i][tid];
        staged = 0;
    };

    // this block's entries [f0, f1): float4 loads from the first 16-byte
    // boundary, a round's loads issued before the last round is counted,
    // the few entries before the boundary and after the last float4 singly
    const float* xr = x + row * sr;
    const long long f0 = static_cast<long long>(blockIdx.x) * STREAM_CHUNK;
    const long long f1 = min(n, f0 + STREAM_CHUNK);
    const long long mis = (reinterpret_cast<uintptr_t>(xr + f0) >> 2) & 3;
    const long long a0 = min(f1, f0 + ((4 - mis) & 3));
    const long long nq = (f1 - a0) / 4;
    const long long a1 = a0 + 4 * nq;
    const float4* xv = reinterpret_cast<const float4*>(xr + a0);
    const int nq_i = static_cast<int>(nq);
    constexpr int ROUND = STREAM_VEC * STREAM_THREADS;
    const int full = nq_i / ROUND * ROUND;
    float4 cur[STREAM_VEC];
    if (full > 0) {
#pragma unroll
        for (int u = 0; u < STREAM_VEC; ++u)
            cur[u] = __ldcs(xv + u * nt + tid);
    }
    for (int q0 = 0; q0 < full; q0 += ROUND) {
        float4 nxt[STREAM_VEC];
        if (q0 + ROUND < full) {
#pragma unroll
            for (int u = 0; u < STREAM_VEC; ++u)
                nxt[u] = __ldcs(xv + q0 + ROUND + u * nt + tid);
        }
#pragma unroll
        for (int u = 0; u < STREAM_VEC; ++u) {
            take(cur[u].x);
            take(cur[u].y);
            take(cur[u].z);
            take(cur[u].w);
        }
        if (__any_sync(FULL, staged > THREAD_STAGE - 4 * STREAM_VEC))
            flush();
#pragma unroll
        for (int u = 0; u < STREAM_VEC; ++u) cur[u] = nxt[u];
    }
    // the float4s after the whole rounds, then at most 3 + 3 singles
    for (int q = full + tid; q < nq_i; q += nt) {
        const float4 v = __ldcs(xv + q);
        take(v.x);
        take(v.y);
        take(v.z);
        take(v.w);
        if (staged > THREAD_STAGE - 4) {
            // a lone thread's list: its own reservation
            const uint32_t base = atomicAdd(&ws[WS_INSIDE], staged);
            for (uint32_t i = 0; i < staged; ++i)
                if (base + i < cap) brow[base + i] = tstage[i][tid];
            staged = 0;
        }
    }
    {
        const int head = static_cast<int>(a0 - f0);
        const int tail = static_cast<int>(f1 - a1);
        if (tid < head + tail)
            take(xr[tid < head ? f0 + tid : a1 + (tid - head)]);
    }
    flush();
    MEDIAN_SPAN(0);
    below = __reduce_add_sync(FULL, below);
    eqlo = __reduce_add_sync(FULL, eqlo);
    eqhi = __reduce_add_sync(FULL, eqhi);
    const bool wnan = __any_sync(FULL, nan);
    if (lane == 0) {
        if (below) atomicAdd(&s_tot[0], below);
        if (eqlo) atomicAdd(&s_tot[1], eqlo);
        if (eqhi) atomicAdd(&s_tot[2], eqhi);
        if (wnan) s_tot[3] = 1u;
    }
    __syncthreads();
    if (tid == 0) {
        if (s_tot[0]) atomicAdd(&ws[WS_BELOW], s_tot[0]);
        if (s_tot[1]) atomicAdd(&ws[WS_EQLO], s_tot[1]);
        if (s_tot[2]) atomicAdd(&ws[WS_EQHI], s_tot[2]);
        if (s_tot[3]) atomicOr(&ws[WS_NAN], 1u);
    }
    MEDIAN_SPAN_END();
}

// Where rank r of the row lies: below lo (0), on lo (1), among the
// candidates at *q (2), on hi (3), above hi (4).
__device__ __forceinline__ int place(long long r, const uint32_t* ws,
                                     long long* q) {
    long long t = r - ws[WS_BELOW];
    if (t < 0) return 0;
    if (t < ws[WS_EQLO]) return 1;
    t -= ws[WS_EQLO];
    if (t < ws[WS_INSIDE]) {
        *q = t;
        return 2;
    }
    t -= ws[WS_INSIDE];
    return t < ws[WS_EQHI] ? 3 : 4;
}

// a cluster of FINISH_CLUSTER blocks a row, each a slice of the candidates
// (or of the row)
__global__ void __launch_bounds__(FINISH_THREADS, 2)
k_median_finish(const float* __restrict__ x, long long n, long long sr,
                long long cap, const uint32_t* __restrict__ ws_all,
                const uint32_t* __restrict__ buf, float* __restrict__ out) {
    __shared__ SelShared<true> sh;
    extern __shared__ uint32_t cand[];     // FINISH_CAND keys for rank 0
    MEDIAN_SPAN_BEGIN(4);
    const Group<true> g;
    const int tid = threadIdx.x, nt = blockDim.x;
    const unsigned rank = g.rank(), c = g.size();
    const long long row = blockIdx.x / c;
    const uint32_t* ws = ws_all + row * WS_WORDS;
    if (ws[WS_NAN]) {
        if (rank == 0 && tid == 0) out[row] = __uint_as_float(0x7fc00000u);
        return;
    }
    const uint32_t lo = ws[WS_LO], hi = ws[WS_HI];
    const long long r0 = (n - 1) / 2, r1 = n / 2;
    long long q0 = 0, q1 = 0;
    const int p0 = place(r0, ws, &q0), p1 = place(r1, ws, &q1);
    const long long inside = ws[WS_INSIDE];
    const bool fallback = p0 == 0 || p0 == 4 || p1 == 0 || p1 == 4
        || ((p0 == 2 || p1 == 2) && inside > cap);
    uint32_t k[2] = {p0 == 1 ? lo : hi, p1 == 1 ? lo : hi};
    if (!fallback && p0 != 2 && p1 != 2) {
        if (rank == 0 && tid == 0) out[row] = median_value(k[0], k[1], n);
        return;
    }
    // the selection over this block's slice: of the row where the sample
    // missed, else of the candidates, from the stream's counts of their
    // digit (rank 0 holds them)
    const CandDigit cd = cand_digit(lo, hi);
    const bool both = p0 == 2 && p1 == 2;
    const long long total = fallback ? n : inside;
    const long long slice = (total + c - 1) / c;
    const long long lo_s = min(total, slice * rank);
    const long long len = min(total - lo_s, slice);
    for (int i = tid; i < RADIX_BINS; i += nt)
        sh.hist[i] = sh.mrg[0][i] = sh.mrg[1][i] = 0u;
    if (tid == 0) sh.nan = 0u;
    __syncthreads();
    cluster_arrive();                  // the merged counts are clear
    cluster_wait();
    MEDIAN_SPAN(0);
    const uint32_t q = static_cast<uint32_t>(
        fallback ? r0 : (p0 == 2 ? q0 : q1));
    const Decision d = fallback
        ? Decision{0u, 32u, q, (n & 1) ? 0u : 1u, GO, 0u, 0u, 0u}
        : Decision{cd.prefix, cd.low, q, both && q1 != q0 ? 1u : 0u, GO, 0u,
                   0u, 0u};
    const int got = fallback
        ? select_loop<true>(sh, FloatsAt{x + row * sr + lo_s}, len, false, g,
                            d, cand, FINISH_CAND)
        : select_loop<true>(sh, KeysAt{buf + row * cap + lo_s}, len, false,
                            g, d, cand, FINISH_CAND);
    if (got && tid == 0) {
        if (fallback || both) {
            k[0] = sh.res[0];
            k[1] = sh.res[1];
        } else if (p0 == 2) {
            k[0] = sh.res[0];
        } else {
            k[1] = sh.res[0];
        }
        out[row] = median_value(k[0], k[1], n);
    }
    MEDIAN_SPAN_END();
}

// ---------------------------------------------------------------------------
// set-up

// Once a device: the kernels' shared-memory and cluster-size opt-ins, and
// whether the card holds a 16-block cluster of the mid plan at its largest
// slice.  Returns the cudaError_t; *fits16 gets the answer.
cudaError_t median_setup(bool* fits16) {
    static int state[MAX_DEVICES];     // 0 unknown, 1 holds 16, 2 does not
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (state[dev] == 0) {
        // all the shared memory a block may have beyond its static part
        cudaFuncAttributes fa;
        e = cudaFuncGetAttributes(&fa, k_median_onchip<false>);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(
            k_median_onchip<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_BLOCK_MAX - static_cast<int>(fa.sharedSizeBytes));
        if (e != cudaSuccess) return e;
        e = cudaFuncGetAttributes(&fa, k_median_onchip<true>);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(
            k_median_onchip<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_BLOCK_MAX - static_cast<int>(fa.sharedSizeBytes));
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(
            k_median_onchip<true>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        e = cudaFuncGetAttributes(&fa, k_median_finish);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(
            k_median_finish, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_BLOCK_MAX - static_cast<int>(fa.sharedSizeBytes));
        if (e != cudaSuccess) return e;
        e = cudaFuncGetAttributes(&fa, k_median_sample);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(
            k_median_sample, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_BLOCK_MAX - static_cast<int>(fa.sharedSizeBytes));
        if (e != cudaSuccess) return e;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(MAX_CLUSTER, 1, 1);
        cfg.blockDim = dim3(ONCHIP_THREADS_MAX, 1, 1);
        cfg.dynamicSmemBytes = (32768 + CAND_MAX) * 4;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = MAX_CLUSTER;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int nc = 0;
        e = cudaOccupancyMaxActiveClusters(
            &nc, reinterpret_cast<const void*>(k_median_onchip<true>), &cfg);
        if (e != cudaSuccess) return e;
        state[dev] = nc > 0 ? 1 : 2;
    }
    *fits16 = state[dev] == 1;
    return cudaSuccess;
}

const void* kernel_of(int which) {
    switch (which) {
        case 0: return reinterpret_cast<const void*>(k_median_onchip<false>);
        case 1: return reinterpret_cast<const void*>(k_median_onchip<true>);
        case 2: return reinterpret_cast<const void*>(k_median_sample);
        case 3: return reinterpret_cast<const void*>(k_median_stream);
        case 4: return reinterpret_cast<const void*>(k_median_finish);
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

int median_ws_words() { return WS_WORDS; }
int median_sample_size() { return SAMPLE; }
int median_margin() { return MARGIN; }
int median_fin_cap() { return FIN_CAP; }
int median_cand_max() { return CAND_MAX; }
int median_stream_chunk() { return STREAM_CHUNK; }

// Whether the card holds a 16-block cluster of the mid plan (*out 1 or 0).
// Returns the cudaError_t.
int median_fits16(int* out) {
    bool f = false;
    const cudaError_t e = median_setup(&f);
    *out = f ? 1 : 0;
    return static_cast<int>(e);
}

// The small and mid plans: the median of each of `rows` rows of n float32
// into out [rows], one launch on `stream` of `cluster` blocks of `threads`
// a row (1: the small plan's lone block), each holding kpb keys.  Row r's
// entry (a, b), a < A, b < B, A * B = n, is x[r * sr + a * sa + b * sb].
// Returns the cudaError_t.
int median_onchip_launch(long long rows, long long n, int A, int B,
                         long long sr, long long sa, long long sb,
                         int cluster, int threads, int kpb, int cand,
                         const void* x, void* out, void* stream) {
    if (rows < 1 || rows > 65535 || n < 1 || A < 1 || B < 1
        || static_cast<long long>(A) * B != n || sr < 0 || sa < 0 || sb < 0
        || threads < 32 || threads > ONCHIP_THREADS_MAX || threads % 32
        || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8
            && cluster != MAX_CLUSTER)
        || kpb < 1 || static_cast<long long>(kpb) * cluster < n
        || cand < 0 || (cluster == 1 && cand != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    bool fits16 = false;
    cudaError_t e = median_setup(&fits16);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int smem = (kpb + cand) * 4;
    RowView v;
    v.n = n;
    v.sr = sr;
    v.sa = sa;
    v.sb = sb;
    v.A = A;
    v.B = B;
    v.kpb = kpb;
    v.cand = cand;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster), 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    if (cluster > 1)
        e = cudaLaunchKernelEx(&cfg, k_median_onchip<true>,
                               static_cast<const float*>(x), v,
                               static_cast<float*>(out));
    else
        e = cudaLaunchKernelEx(&cfg, k_median_onchip<false>,
                               static_cast<const float*>(x), v,
                               static_cast<float*>(out));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// The large plan: the median of each of `rows` contiguous rows of n
// float32 (rows sr apart, n > SAMPLE) into out [rows], three launches on
// `stream`.  ws: rows x WS_WORDS uint32 and buf: rows x cap uint32,
// neither cleared.  Returns the cudaError_t.
int median_large_launch(long long rows, long long n, long long sr,
                        long long cap, const void* x, void* ws, void* buf,
                        void* out, void* stream) {
    if (rows < 1 || rows > 65535 || n <= SAMPLE || n > 2147483647LL
        || sr < n || cap < 1 || cap > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    bool fits16 = false;
    cudaError_t e = median_setup(&fits16);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    uint32_t* w = static_cast<uint32_t*>(ws);
    uint32_t* b = static_cast<uint32_t*>(buf);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = SAMPLE_CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows * SAMPLE_CLUSTER), 1, 1);
    cfg.blockDim = dim3(SAMPLE_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (SAMPLE / SAMPLE_CLUSTER + SAMPLE_CAND) * 4;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, k_median_sample, xf, n, sr, w);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>((n + STREAM_CHUNK - 1)
                                          / STREAM_CHUNK),
                    static_cast<unsigned>(rows));
    k_median_stream<<<grid, STREAM_THREADS, 0, st>>>(xf, n, sr, cap, w, b);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    cfg.gridDim = dim3(static_cast<unsigned>(rows * FINISH_CLUSTER), 1, 1);
    cfg.blockDim = dim3(FINISH_THREADS, 1, 1);
    cfg.dynamicSmemBytes = FINISH_CAND * 4;
    attr.val.clusterDim.x = FINISH_CLUSTER;
    e = cudaLaunchKernelEx(&cfg, k_median_finish, xf, n, sr, cap,
                           static_cast<const uint32_t*>(w),
                           static_cast<const uint32_t*>(b),
                           static_cast<float*>(out));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// A kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes): which
// 0 small (k_median_onchip<false>), 1 mid (k_median_onchip<true>), 2
// k_median_sample, 3 k_median_stream, 4 k_median_finish.  out [4].
// Returns the cudaError_t.
int median_kernel_attrs(int which, int* out) {
    const void* k = kernel_of(which);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

// Blocks of kernel `which` (as median_kernel_attrs) of `threads` threads
// and `smem` dynamic shared bytes an SM holds, and for cluster > 1 the
// clusters of that many blocks the card holds at once (else 0): out [2].
// Returns the cudaError_t.
int median_occupancy(int which, int threads, int smem, int cluster,
                     int* out) {
    bool fits16 = false;
    cudaError_t e = median_setup(&fits16);
    if (e != cudaSuccess) return static_cast<int>(e);
    const void* k = kernel_of(which);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads,
                                                      smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int clusters = 0;
    if (cluster > 1) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(cluster, 1, 1);
        cfg.blockDim = dim3(threads, 1, 1);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = cluster;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        e = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    out[0] = blocks;
    out[1] = clusters;
    return 0;
}

}  // extern "C"
