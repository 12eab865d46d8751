// The q-ary modes' device stages (JT65, Q65-30): Q65's GF(64) sum-product
// decode (qra_mp) and the q-ary sync correlation with its top-K
// (qary_sync), each with no host sync.  The median of their maps, shared
// with WSPR and the GFSK engine, is csrc/median.cu's.
//
// They replace two XLA programs of the JAX package:
// cwsl_digi_tpu/modes/qra.py:268-349 (QaryMPDecoder.decode: a fori_loop of
// 60 sum-product iterations over [B, 50, 4, 64] messages, each two
// [64, 64] float32 matmuls for the Walsh-Hadamard transforms, gathers for
// the GF(64) permutations and the variable products, then argmax, the
// GF(64) syndrome and the confidence) and
// cwsl_digi_tpu/modes/qary_engine.py:107-118 (the sum of the sync rows'
// shifted slices, its normalisation and lax.top_k of the score map).
// Their plain versions are modes/qra.py:QaryMPDecoder.decode_plain and
// modes/qary_engine.py:_qary_sync_plain: ~40 launches and six
// [B, 50, 4, 64] temporaries an MP iteration (2,400 launches a decode),
// and 63 (JT65) or 22 (Q65) slice
// adds of the [B, 128, n_f0] map, a division and a stable sort of every
// score a window for its top 24.
//
// What bounds them on an H100.
//
//   - qra_mp reads the priors (B x 63 x 64 float32: 124 MB at Q65's 7,680
//     words of a 64-window decode) and writes a word's symbols, flag and
//     confidence.  Its operations: per word and iteration, each of the
//     152 edges' 64 symbols a product at the variable, a division, two
//     clamps, two normalisations (a sum and a division each), two 64-point
//     transforms (6 adds a symbol each), the leave-one-out products and a
//     scaling, ~2.7e5 float operations; 60 iterations of 7,680 words are
//     ~1.3e11, ~3.8 ms at the FP32 rate without FMA: operations bound it.
//     What sets its time is the warp shuffles of the transforms and sums
//     (~30 a slot and iteration a lane) and the 60 iterations' two block
//     barriers each.
//   - qary_sync reads the sync rows its scores need (the union of the
//     rows [8 s, 8 s + 128) over the sync symbols s, n_f0 bins wide:
//     ~690 MB at JT65's 64 windows, ~0.21 ms) and writes K candidates a
//     window.  Its operations, 63 adds and a division a score, are ~0.04
//     ms: bytes bound it.
//
// The design.
//
//   - qra_mp: a block of 10 warps a word, all iterations in one launch.
//     The word's check-to-variable messages (50 x 4 x 64 float32, 51.2
//     KB), its channel rows and the variable products (16 KB each) and a
//     permutation buffer stay in shared memory for the whole decode (91 KB
//     a block, two blocks an SM).  An iteration is two phases behind block
//     barriers: the threads form each variable's product of its channel
//     row and its incoming messages (the plain version's order: the
//     messages in column-slot order, a padded slot a uniform 1/64, then
//     the channel), then warp w updates checks w, w + 10, ... in place,
//     lane l holding symbols l and l + 32 of each of the check's slots.
//     A slot's variable-to-check message is the product over its own old
//     message (+ 1e-30), clamped at 1e-30 and normalised (a warp sum as
//     an xor butterfly); the GF(64) coefficient's permutation goes through
//     the warp's buffer; the Walsh-Hadamard transform is six butterfly
//     stages (stride 32 inside the lane, 16 to 1 by __shfl_xor_sync); the
//     leave-one-out products over the check's real slots are prefix and
//     suffix products in slot order; the inverse transform, / 64, the
//     inverse permutation, the clamp and the normalisation give the new
//     message.  Padded slots keep the uniform message and are never read
//     (exact no-ops, as in the plain version).  Then the posterior (a warp
//     a variable), its argmax (NaN first, then the first index on ties),
//     the GF(64) syndrome (a thread a check) and the mean of the
//     posterior maxima.  The sums run in another order than the plain
//     version's matmuls, so a word that converges late or not at all may
//     end elsewhere and its flag may differ from the plain version's, as
//     the plain version's own flags differ from the JAX package's;
//     where both converge the symbols are the plain version's.
//   - qary_sync: a block of 8 warps a window's 32 bins and all 128 time
//     offsets.  The sync rows pass through a 128-row ring in shared memory
//     in the order of the sync symbols (the hops ascending, each row read
//     once from device memory); a thread sums its 16 cells' rows in that
//     order (the plain version's adds, bitwise), divides by base + 1e-30f
//     and keys each score as (order key << 32 | ~index): the order key
//     puts NaN first and reads -0.0 as 0.0, the low word the lower index
//     first on ties, so a larger key is the earlier entry of the stable
//     descending sort.  The block's K largest keys are taken by K rounds
//     of a block maximum below the last one taken; the window's last block
//     (a ticket counter) merges the strips' candidates the same way and
//     writes top_val and top_idx.  The score map is never written.
//
// Built with --fmad=false and without fast math (IEEE divisions,
// denormals kept), so the sums and products are the IEEE float operations
// written here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;      // per-device launch settings kept

// ---------------------------------------------------------------------------
// order keys

// The ascending order of float32 as uint32: -0.0 read as 0.0, every NaN
// above +inf.
__device__ __forceinline__ uint32_t order_key(float x) {
    if (x != x) return 0xffffffffu;
    const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 warp_max_u64(u64 v) {
    const uint32_t hi = static_cast<uint32_t>(v >> 32);
    const uint32_t mhi = __reduce_max_sync(FULL, hi);
    const uint32_t mlo = __reduce_max_sync(
        FULL, hi == mhi ? static_cast<uint32_t>(v) : 0u);
    return (static_cast<u64>(mhi) << 32) | mlo;
}

// ---------------------------------------------------------------------------
// qra_mp

constexpr int Q = 64;
constexpr int MP_WARPS = 10;            // 50 checks: 5 a warp
constexpr int MP_THREADS = MP_WARPS * 32;
constexpr int MP_N_MAX = 64;            // code length
constexpr int MP_NC_MAX = 63;           // checks
constexpr int MP_MR = 4;                // slots a check at most
constexpr int MP_COL_MAX = 8;           // edges a variable at most
constexpr float TINY = 1e-30f;
constexpr float UNI = 1.0f / Q;

// The table block (uint8), for nc checks of mr slots, n variables of
// max_col column slots: h_vars [nc mr] (n = a padded slot), h_coeff
// [nc mr], fwd [nc mr 64], bwd [nc mr 64], col_slots [n max_col] (flat
// slot c mr + s, 255 = a padded column slot), gf_mul [64 64].
struct MpDims {
    int B, n, nc, mr, max_col, iters;
};

struct MpTabs {
    const uint8_t* h_vars;
    const uint8_t* h_coeff;
    const uint8_t* fwd;
    const uint8_t* bwd;
    const uint8_t* col_slots;
    const uint8_t* gf_mul;
};

__host__ __device__ inline MpTabs mp_tabs(const uint8_t* t, const MpDims& d) {
    const int slots = d.nc * d.mr;
    MpTabs o;
    o.h_vars = t;
    o.h_coeff = o.h_vars + slots;
    o.fwd = o.h_coeff + slots;
    o.bwd = o.fwd + slots * Q;
    o.col_slots = o.bwd + slots * Q;
    o.gf_mul = o.col_slots + d.n * d.max_col;
    return o;
}

__host__ __device__ inline int mp_table_bytes(int n, int nc, int mr,
                                              int max_col) {
    return 2 * nc * mr + 2 * nc * mr * Q + n * max_col + Q * Q;
}

// shared floats: m_cv [nc mr 64], chan [n 64], tot [n 64], the warps'
// permutation buffers [MP_WARPS mr 64], the posterior maxima [n]
__host__ __device__ inline int mp_smem_floats(int n, int nc, int mr) {
    return nc * mr * Q + 2 * n * Q + MP_WARPS * mr * Q + MP_N_MAX;
}

__device__ __forceinline__ float clamp_tiny(float x) {
    return x < TINY ? TINY : x;         // NaN stays NaN, as torch.clamp
}

// Sum of a 64-symbol message held as (a, b) = symbols (l, l + 32): an xor
// butterfly, the same float in every lane.
__device__ __forceinline__ float warp_sum64(float a, float b) {
    float s = a + b;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    return s;
}

// In-place 64-point Walsh-Hadamard transform (Sylvester order: H[t, j] =
// (-1)^popc(t & j), the plain version's matrix) of (a, b) = symbols (l,
// l + 32): stride 32 in the lane, then 16 to 1 across lanes; at each
// stage the entry with the stride's bit clear becomes u + v, the other
// u - v (u the bit-clear entry).
__device__ __forceinline__ void wht64(float& a, float& b, int lane) {
    const float u = a;
    a = u + b;
    b = u - b;
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
        const float pa = __shfl_xor_sync(FULL, a, h);
        const float pb = __shfl_xor_sync(FULL, b, h);
        const bool hi = (lane & h) != 0;
        a = hi ? pa - a : a + pa;
        b = hi ? pb - b : b + pb;
    }
}

// tot[v, t] = chan[v, t] * (m_cv[col_slots[v, 0], t] * ... ) over the
// variable's column slots in order, a padded one uniform.
__device__ __forceinline__ void var_products(const MpDims& d,
                                             const MpTabs& tb,
                                             const float* m_cv,
                                             const float* chan, float* tot) {
    for (int i = threadIdx.x; i < d.n * Q; i += MP_THREADS) {
        const int v = i >> 6, t = i & (Q - 1);
        float p = 1.0f;
        for (int j = 0; j < d.max_col; ++j) {
            const int slot = __ldg(tb.col_slots + v * d.max_col + j);
            const float x = slot == 255 ? UNI : m_cv[slot * Q + t];
            p = j == 0 ? x : p * x;
        }
        tot[i] = chan[i] * p;
    }
}

__global__ void __launch_bounds__(MP_THREADS, 2)
k_qra_mp(const uint8_t* __restrict__ tables, const float* __restrict__ probs,
         MpDims d, int64_t* __restrict__ hard, uint8_t* __restrict__ ok,
         float* __restrict__ conf) {
    extern __shared__ float smem[];
    const MpTabs tb = mp_tabs(tables, d);
    const int slots = d.nc * d.mr;
    float* m_cv = smem;
    float* chan = m_cv + slots * Q;
    float* tot = chan + d.n * Q;
    float* perm = tot + d.n * Q;
    float* post_max = perm + MP_WARPS * d.mr * Q;
    __shared__ int s_hard[MP_N_MAX];

    const int word = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* pw = probs + static_cast<long long>(word) * d.n * Q;
    for (int i = threadIdx.x; i < d.n * Q; i += MP_THREADS) chan[i] = pw[i];
    for (int i = threadIdx.x; i < slots * Q; i += MP_THREADS) m_cv[i] = UNI;
    float* buf = perm + warp * d.mr * Q;
    __syncthreads();

    for (int it = 0; it < d.iters; ++it) {
        var_products(d, tb, m_cv, chan, tot);
        __syncthreads();
        for (int c = warp; c < d.nc; c += MP_WARPS) {
            float wa[MP_MR], wb[MP_MR];
            bool real[MP_MR];
            // variable -> check, permuted into the check's domain, WHT
#pragma unroll
            for (int s = 0; s < MP_MR; ++s) {
                const int slot = c * d.mr + s;
                const int v = s < d.mr ? __ldg(tb.h_vars + slot) : d.n;
                real[s] = v < d.n;
                wa[s] = 1.0f;
                wb[s] = 1.0f;
                if (!real[s]) continue;
                float a = tot[v * Q + lane] / (m_cv[slot * Q + lane] + TINY);
                float b = tot[v * Q + lane + 32]
                    / (m_cv[slot * Q + lane + 32] + TINY);
                a = clamp_tiny(a);
                b = clamp_tiny(b);
                const float den = warp_sum64(a, b) + TINY;
                buf[s * Q + lane] = a / den;
                buf[s * Q + lane + 32] = b / den;
                __syncwarp();
                const uint8_t* f = tb.fwd + slot * Q;
                a = buf[s * Q + __ldg(f + lane)];
                b = buf[s * Q + __ldg(f + lane + 32)];
                __syncwarp();
                wht64(a, b, lane);
                wa[s] = a;
                wb[s] = b;
            }
            // leave-one-out products over the real slots: prefix * suffix
            float la[MP_MR], lb[MP_MR];
            float pa = 1.0f, pb = 1.0f;
#pragma unroll
            for (int s = 0; s < MP_MR; ++s) {
                la[s] = pa;
                lb[s] = pb;
                if (real[s]) {
                    pa = pa * wa[s];
                    pb = pb * wb[s];
                }
            }
            pa = 1.0f;
            pb = 1.0f;
#pragma unroll
            for (int s = MP_MR - 1; s >= 0; --s) {
                if (!real[s]) continue;
                la[s] = la[s] * pa;
                lb[s] = lb[s] * pb;
                pa = pa * wa[s];
                pb = pb * wb[s];
            }
            // check -> variable: inverse WHT, / 64, back to the variable's
            // domain, clamp, normalise
#pragma unroll
            for (int s = 0; s < MP_MR; ++s) {
                if (!real[s]) continue;
                const int slot = c * d.mr + s;
                float a = la[s], b = lb[s];
                wht64(a, b, lane);
                buf[s * Q + lane] = a / 64.0f;
                buf[s * Q + lane + 32] = b / 64.0f;
                __syncwarp();
                const uint8_t* g = tb.bwd + slot * Q;
                a = clamp_tiny(buf[s * Q + __ldg(g + lane)]);
                b = clamp_tiny(buf[s * Q + __ldg(g + lane + 32)]);
                __syncwarp();
                const float den = warp_sum64(a, b) + TINY;
                m_cv[slot * Q + lane] = a / den;
                m_cv[slot * Q + lane + 32] = b / den;
            }
        }
        __syncthreads();
    }

    // posterior, its argmax (NaN first, then the first index) and maximum
    var_products(d, tb, m_cv, chan, tot);
    __syncthreads();
    for (int v = warp; v < d.n; v += MP_WARPS) {
        const float x0 = tot[v * Q + lane], x1 = tot[v * Q + lane + 32];
        const float den = warp_sum64(x0, x1) + TINY;
        const float p0 = x0 / den, p1 = x1 / den;
        // lane's best of (p0 at lane, p1 at lane + 32)
        const bool take1 = (p1 != p1 && p0 == p0) || p1 > p0;
        float best = take1 ? p1 : p0;
        int idx = take1 ? lane + 32 : lane;
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) {
            const float ob = __shfl_xor_sync(FULL, best, off);
            const int oi = __shfl_xor_sync(FULL, idx, off);
            const bool bn = best != best, on = ob != ob;
            const bool other = (on && !bn) || ob > best
                || ((ob == best || (on && bn)) && oi < idx);
            best = other ? ob : best;
            idx = other ? oi : idx;
        }
        if (lane == 0) {
            s_hard[v] = idx;
            post_max[v] = best;
            hard[static_cast<long long>(word) * d.n + v] = idx;
        }
    }
    __syncthreads();
    // GF(64) syndrome, a thread a check
    bool bad = false;
    for (int c = threadIdx.x; c < d.nc; c += MP_THREADS) {
        uint32_t syn = 0;
        for (int s = 0; s < d.mr; ++s) {
            const int v = __ldg(tb.h_vars + c * d.mr + s);
            if (v >= d.n) continue;
            syn ^= __ldg(tb.gf_mul + s_hard[v] * Q
                         + __ldg(tb.h_coeff + c * d.mr + s));
        }
        bad = bad || syn != 0;
    }
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
        float sum = 0.0f;
        for (int v = 0; v < d.n; ++v) sum = v == 0 ? post_max[0]
                                                    : sum + post_max[v];
        conf[word] = sum / static_cast<float>(d.n);
        ok[word] = bad ? 0 : 1;
    }
}

int launch_mp(const MpDims& d, const uint8_t* tables, const float* probs,
              int64_t* hard, uint8_t* ok, float* conf, cudaStream_t st) {
    static int attr_bytes[MAX_DEVICES] = {};
    const int bytes = mp_smem_floats(d.n, d.nc, d.mr)
        * static_cast<int>(sizeof(float));
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (attr_bytes[dev] < bytes) {
        e = cudaFuncSetAttribute(k_qra_mp,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_bytes[dev] = bytes;
    }
    k_qra_mp<<<d.B, MP_THREADS, bytes, st>>>(tables, probs, d, hard, ok,
                                             conf);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// qary_sync

constexpr int SYNC_WARPS = 8;
constexpr int SYNC_THREADS = SYNC_WARPS * 32;
constexpr int SYNC_TF = 32;              // bins a block
constexpr int SYNC_TMAX = 128;           // time offsets at most; ring rows
constexpr int SYNC_CELLS = SYNC_TMAX / SYNC_WARPS;   // 16 a thread
constexpr int SYNC_S_MAX = 128;          // sync symbols at most
constexpr int SYNC_K_MAX = 256;

struct SyncDims {
    int B, H, F, n_t0, n_f0, S, K;
};

// Block maximum of the threads' keys (every thread gets it); `buf` [2][8]
// alternates between calls, so one barrier a call suffices.
__device__ __forceinline__ u64 block_max_u64(u64 v, u64* buf,
                                                  int round) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_max_u64(v);
    u64* b = buf + (round & 1) * SYNC_WARPS;
    if (lane == 0) b[warp] = v;
    __syncthreads();
    u64 m = b[0];
#pragma unroll
    for (int w = 1; w < SYNC_WARPS; ++w) m = b[w] > m ? b[w] : m;
    return m;
}

__global__ void __launch_bounds__(SYNC_THREADS)
k_qary_sync(const float* __restrict__ ps, const float* __restrict__ base,
            const int* __restrict__ hops, SyncDims d,
            u64* __restrict__ cand_key, float* __restrict__ cand_val,
            uint32_t* __restrict__ done, float* __restrict__ top_val,
            int64_t* __restrict__ top_idx) {
    __shared__ float ring[SYNC_TMAX][SYNC_TF];
    __shared__ int s_hops[SYNC_S_MAX];
    __shared__ u64 s_max[2 * SYNC_WARPS];
    __shared__ int s_last;
    const int b = blockIdx.y, strip = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int f = strip * SYNC_TF + lane;
    const float* pb = ps + static_cast<long long>(b) * d.H * d.F;
    for (int i = threadIdx.x; i < d.S; i += SYNC_THREADS) s_hops[i] = hops[i];
    __syncthreads();

    // the correlation: the sync rows in the order of the sync symbols
    float acc[SYNC_CELLS];
#pragma unroll
    for (int j = 0; j < SYNC_CELLS; ++j) acc[j] = 0.0f;
    int next = s_hops[0];
    for (int i = 0; i < d.S; ++i) {
        const int h = s_hops[i];
        const int hi = h + d.n_t0;
        for (int r = (next > h ? next : h) + warp; r < hi; r += SYNC_WARPS)
            ring[r & (SYNC_TMAX - 1)][lane] =
                f < d.n_f0 ? __ldg(pb + static_cast<long long>(r) * d.F + f)
                           : 0.0f;
        next = hi > next ? hi : next;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j) {
            const float v = ring[(h + warp + SYNC_WARPS * j)
                                 & (SYNC_TMAX - 1)][lane];
            acc[j] = i == 0 ? v : acc[j] + v;
        }
        __syncthreads();
    }

    // scores and keys: (order key << 32) | ~(t0 n_f0 + f0); 0 = no cell
    const float den = base[b] + TINY;
    float val[SYNC_CELLS];
    u64 key[SYNC_CELLS];
#pragma unroll
    for (int j = 0; j < SYNC_CELLS; ++j) {
        const int t = warp + SYNC_WARPS * j;
        val[j] = acc[j] / den;
        const bool cell = t < d.n_t0 && f < d.n_f0;
        const uint32_t idx = static_cast<uint32_t>(t * d.n_f0 + f);
        key[j] = cell ? (static_cast<u64>(order_key(val[j])) << 32)
                        | (0xffffffffu - idx)
                      : 0ull;
    }

    // the strip's K largest keys, largest first
    const long long slot0 = (static_cast<long long>(b) * gridDim.x + strip)
        * d.K;
    // (the first round takes any key: ~0 is a NaN score at index 0)
    u64 last = ~0ull;
    for (int r = 0; r < d.K; ++r) {
        u64 best = 0ull;
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j)
            best = ((r == 0 || key[j] < last) && key[j] > best) ? key[j]
                                                               : best;
        const u64 m = block_max_u64(best, s_max, r);
        if (m != 0ull) {
#pragma unroll
            for (int j = 0; j < SYNC_CELLS; ++j)
                if (key[j] == m) {
                    cand_key[slot0 + r] = m;
                    cand_val[slot0 + r] = val[j];
                }
        } else if (threadIdx.x == 0) {
            cand_key[slot0 + r] = 0ull;
        }
        last = m;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(done + b, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    // the window's last block: the top K of the strips' candidates
    const long long c0 = static_cast<long long>(b) * gridDim.x * d.K;
    const int n_c = gridDim.x * d.K;
    last = ~0ull;
    for (int r = 0; r < d.K; ++r) {
        u64 best = 0ull;
        int at = -1;
        for (int i = threadIdx.x; i < n_c; i += SYNC_THREADS) {
            const u64 k = __ldcg(cand_key + c0 + i);
            if ((r == 0 || k < last) && k > best) {
                best = k;
                at = i;
            }
        }
        const u64 m = block_max_u64(best, s_max, r);
        if (m != 0ull && best == m) {
            top_val[static_cast<long long>(b) * d.K + r] =
                __ldcg(cand_val + c0 + at);
            top_idx[static_cast<long long>(b) * d.K + r] =
                static_cast<int64_t>(0xffffffffu - static_cast<uint32_t>(m));
        }
        last = m;
    }
}

}  // namespace

extern "C" {

int qary_mp_n_max() { return MP_N_MAX; }
int qary_mp_nc_max() { return MP_NC_MAX; }
int qary_mp_mr_max() { return MP_MR; }
int qary_mp_col_max() { return MP_COL_MAX; }
int qary_sync_tf() { return SYNC_TF; }
int qary_sync_t_max() { return SYNC_TMAX; }
int qary_sync_s_max() { return SYNC_S_MAX; }
int qary_sync_k_max() { return SYNC_K_MAX; }

// Table bytes and dynamic shared memory bytes of qra_mp for a code of n
// variables, nc checks of mr slots and max_col column slots.
int qra_mp_table_bytes(int n, int nc, int mr, int max_col) {
    return mp_table_bytes(n, nc, mr, max_col);
}
int qra_mp_smem_bytes(int n, int nc, int mr) {
    return mp_smem_floats(n, nc, mr) * static_cast<int>(sizeof(float));
}

// Sum-product decode of B words: dims [6] = B, n, nc, mr, max_col, iters;
// tables: the table block; probs [B, n, 64] float32 -> hard [B, n] int64,
// ok [B] uint8 (the GF(64) syndrome is zero), conf [B] float32 (the mean
// of the posterior maxima), on `stream`, one launch.  Returns the
// cudaError_t.
int qra_mp_launch(const int* dims, const void* tables, const void* probs,
                  void* hard, void* ok, void* conf, void* stream) {
    MpDims d;
    d.B = dims[0];
    d.n = dims[1];
    d.nc = dims[2];
    d.mr = dims[3];
    d.max_col = dims[4];
    d.iters = dims[5];
    if (d.B < 1 || d.n < 1 || d.n > MP_N_MAX || d.nc < 1
        || d.nc > MP_NC_MAX || d.mr < 1 || d.mr > MP_MR || d.max_col < 1
        || d.max_col > MP_COL_MAX || d.iters < 0 || d.nc * d.mr > 255)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_mp(d, static_cast<const uint8_t*>(tables),
                     static_cast<const float*>(probs),
                     static_cast<int64_t*>(hard), static_cast<uint8_t*>(ok),
                     static_cast<float*>(conf),
                     static_cast<cudaStream_t>(stream));
}

// Sync correlation and top-K of B windows: dims [7] = B, H, F, n_t0, n_f0,
// S, K; ps [B, H, F] float32, base [B] float32, hops [S] int32 (os_t x the
// sync symbols, ascending); cand_key [B, strips, K] and cand_val [B,
// strips, K] scratch (strips = ceil(n_f0 / 32)), done [B] uint32 zeroed by
// the caller; top_val [B, K] float32, top_idx [B, K] int64, one launch on
// `stream`.  Returns the cudaError_t.
int qary_sync_launch(const int* dims, const void* ps, const void* base,
                     const void* hops, void* cand_key, void* cand_val,
                     void* done, void* top_val, void* top_idx, void* stream) {
    SyncDims d;
    d.B = dims[0];
    d.H = dims[1];
    d.F = dims[2];
    d.n_t0 = dims[3];
    d.n_f0 = dims[4];
    d.S = dims[5];
    d.K = dims[6];
    if (d.B < 1 || d.B > 65535 || d.n_t0 < 1 || d.n_t0 > SYNC_TMAX
        || d.n_f0 < 1 || d.n_f0 > d.F || d.S < 1 || d.S > SYNC_S_MAX
        || d.K < 1 || d.K > SYNC_K_MAX
        || static_cast<long long>(d.n_t0) * d.n_f0 < d.K)
        return static_cast<int>(cudaErrorInvalidValue);
    const int strips = (d.n_f0 + SYNC_TF - 1) / SYNC_TF;
    k_qary_sync<<<dim3(strips, d.B), SYNC_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ps), static_cast<const float*>(base),
        static_cast<const int*>(hops), d, static_cast<u64*>(cand_key),
        static_cast<float*>(cand_val), static_cast<uint32_t*>(done),
        static_cast<float*>(top_val), static_cast<int64_t*>(top_idx));
    return static_cast<int>(cudaGetLastError());
}

// A kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes): which
// 0 = qra_mp, 1 = qary_sync.  out [4].  Returns the
// cudaError_t.
int qary_kernel_attrs(int which, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaErrorInvalidValue;
    if (which == 0) e = cudaFuncGetAttributes(&a, k_qra_mp);
    else if (which == 1) e = cudaFuncGetAttributes(&a, k_qary_sync);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

}  // extern "C"
