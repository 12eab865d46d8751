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
//     confidence.  Its operations, per word and iteration, on each of the
//     152 edges' 64 symbols: the variable's other messages, the channel
//     row, the padding scale and the underflow test (d + 3 for a variable
//     of d edges), a clamp, two 64-point transforms (6 adds a symbol each),
//     the normalisation (a reciprocal and a product a symbol), the
//     leave-one-out products (3 r - 4 a symbol for a check of r slots),
//     the scaling and a clamp: ~2.2e5 float operations, ~1.0e11 for 60
//     iterations of 7,680 words, ~3.0 ms at the FP32 rate without FMA:
//     operations bound it.  The first port of this kernel took 40.7 ms on
//     an H100 80GB HBM3 at 700 W: 20 warps an SM (93,952 B of shared
//     memory a word), each slot a chain of 30 shuffles, 6 IEEE divisions
//     and two shared-memory permutations.
//   - qary_sync reads the sync rows its scores need (the union of the
//     rows [8 s, 8 s + 128) over the sync symbols s, n_f0 bins wide:
//     ~690 MB at JT65's 64 windows, ~0.21 ms) and writes K candidates a
//     window.  Its operations, 63 adds and a division a score, are ~0.04
//     ms: bytes bound it.
//
// The design.
//
//   - qra_mp: a block of 8 warps a word, all iterations in one launch, four
//     blocks an SM (32 warps).  Shared memory holds only the 152 real
//     edges' messages (E x 64 float32, 38,912 B) and the channel rows
//     (16,128 B): 55,040 B a word.  An iteration is two phases behind
//     block barriers, each of which replaces the messages in place, since
//     in each phase only one warp reads an edge: warp w takes variables w,
//     w + 8, ..., then checks w, w + 8, ...; lane l holds symbols l and l +
//     32 of each of the variable's or the check's edges, all of them going
//     through each butterfly stage together (their shuffles independent).
//     The variable phase forms each edge's variable-to-check message as the
//     product of the variable's other messages and its channel row (no
//     division), scaled by 1/64 for each padded column slot and set to 0
//     where its product with the edge's own message underflows to 0 (the
//     plain version divides the product over every edge by the own message
//     and gets 0 there), clamped at 1e-30.  It reads the inputs at the
//     check's permuted symbols (lane l at fwd[l]), so no permutation pass:
//     the Walsh-Hadamard transform (stride 32 inside the lane, 16 to 1 by
//     __shfl_xor_sync) follows directly, and its DC term, the message's
//     sum, broadcast from lane 0, normalises it through one IEEE reciprocal.
//     The check phase takes the leave-one-out products (prefix and suffix
//     in slot order), the inverse transform, / 64 and the clamp, and writes
//     lane l's symbol l to the variable's symbol fwd[l].  Its sum is the
//     leave-one-out product's DC term, the product of normalised DC terms,
//     1 to rounding, so it is not normalised again.  That is 21 shuffles
//     an edge and iteration a lane (30 in the first port), one reciprocal
//     and no division.  Then the posterior (a warp a variable), its argmax
//     (NaN first, then the first index on ties), the GF(64) syndrome (a
//     thread a check) and the mean of the posterior maxima.  The products
//     and sums run in another order than the plain version's, so a word
//     that converges late or not at all may end elsewhere and its flag may
//     differ from the plain version's, as the plain version's own flags
//     differ from the JAX package's; where both converge the symbols are
//     the plain version's.  tools/qra_mp_model.py is its arithmetic.
//     On an H100 80GB HBM3 at 700 W (tools/qra_mp_profile.py): 16.05 ms
//     at Q65's 7,680 words, 18.7 % of the bound (the first port 40.66 ms
//     in the same run); 56 registers, 3.92 blocks resident an SM on
//     average (the first port 1.98); the variable phase takes 63 % of the
//     warps' cycles, the check phase 35 %, the waits at the barriers 0.3
//     % (the first port: its variable products 18 %, its checks' slots 81
//     %).  An SM's shuffles fill ~36 % of its shuffle rate, so neither the
//     shuffles nor the barriers set the time: the work inside the phases
//     does (the gathers' loads and address arithmetic, the transforms'
//     dependent chains), which the spans do not split further.  Dividing
//     by the DC term in place of the reciprocal took 4.3 % longer, and
//     normalising the check's message again by its warp sum 16.6 %, and
//     each closed the gap to the plain version's converged words by only
//     6 and 4 of 77 words: neither is taken.
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

// Profiling hooks, empty in the library: tools/qra_mp_profile.py builds this
// file with them defined to read clock64() at the kernel's phase
// boundaries (MP_SPAN(k) closes span k) and the block's SM and start and end
// times.
#ifndef MP_SPANS
#define MP_SPAN_BEGIN()
#define MP_SPAN(k)
#define MP_SPAN_END()
#endif

constexpr int Q = 64;
constexpr int MP_WARPS = 8;
constexpr int MP_THREADS = MP_WARPS * 32;
constexpr int MP_BLOCKS_SM = 4;         // resident blocks an SM (Q65's code)
constexpr int MP_N_MAX = 64;            // code length
constexpr int MP_NC_MAX = 63;           // checks
constexpr int MP_MR = 4;                // slots a check at most
constexpr int MP_COL_MAX = 4;           // edges a variable at most
constexpr int MP_SLOTS_MAX = 255;       // nc mr; 255 = no edge
constexpr float TINY = 1e-30f;
constexpr float UNI = 1.0f / Q;

// The table block (uint8), for nc checks of mr slots, n variables of
// max_col column slots and E edges (the real slots): h_vars [nc mr] (n = a
// padded slot), h_coeff [nc mr], fwd [nc mr 64], bwd [nc mr 64], col_slots
// [n max_col] (flat slot c mr + s, 255 = a padded column slot), gf_mul
// [64 64], e_slot [E] (each edge's flat slot, ascending).
struct MpDims {
    int B, n, nc, mr, max_col, edges, iters;
};

struct MpTabs {
    const uint8_t* h_vars;
    const uint8_t* h_coeff;
    const uint8_t* fwd;
    const uint8_t* col_slots;
    const uint8_t* gf_mul;
    const uint8_t* e_slot;
};

__host__ __device__ inline MpTabs mp_tabs(const uint8_t* t, const MpDims& d) {
    const int slots = d.nc * d.mr;
    MpTabs o;
    o.h_vars = t;
    o.h_coeff = o.h_vars + slots;
    o.fwd = o.h_coeff + slots;
    o.col_slots = o.fwd + 2 * slots * Q;      // past fwd and bwd
    o.gf_mul = o.col_slots + d.n * d.max_col;
    o.e_slot = o.gf_mul + Q * Q;
    return o;
}

__host__ __device__ inline int mp_table_bytes(int n, int nc, int mr,
                                              int max_col, int edges) {
    return 2 * nc * mr + 2 * nc * mr * Q + n * max_col + Q * Q + edges;
}

// shared floats: the edge messages [E 64] and the channel rows [n 64]
__host__ __device__ inline int mp_smem_floats(int n, int edges) {
    return (edges + n) * Q;
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

// In-place 64-point Walsh-Hadamard transforms (Sylvester order: H[t, j] =
// (-1)^popc(t & j), the plain version's matrix) of R messages at once, each
// held as (a, b) = symbols (l, l + 32): stride 32 in the lane, then 16 to 1
// across lanes, the R messages' shuffles of a stage issued together; at
// each stage the entry with the stride's bit clear becomes u + v, the other
// u - v (u the bit-clear entry): each lane adds its own value, negated
// where its lane has the stride's bit, to its partner's.
template <int R>
__device__ __forceinline__ void wht64(float (&a)[R], float (&b)[R],
                                      int lane) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const float u = a[j];
        a[j] = u + b[j];
        b[j] = u - b[j];
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
        const uint32_t neg = (lane & h) ? 0x80000000u : 0u;
        float pa[R], pb[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            pa[j] = __shfl_xor_sync(FULL, a[j], h);
            pb[j] = __shfl_xor_sync(FULL, b[j], h);
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
            a[j] = pa[j] + __uint_as_float(__float_as_uint(a[j]) ^ neg);
            b[j] = pb[j] + __uint_as_float(__float_as_uint(b[j]) ^ neg);
        }
    }
}

// Variable v of D edges, slots[j] its column slots in order (the warp's):
// each edge's variable-to-check message, formed in the check's symbol order
// (lane l at symbols fwd[l], fwd[l + 32] of the edge's slot), transformed
// and normalised, replaces the edge's check-to-variable message.  The
// message to edge j: the product of the variable's other incoming messages
// in column order, times the channel row, times UNI for each padded column
// slot (`scale`); 0 where that times the edge's own message underflows to
// 0 (the plain version's product over every edge, divided by the own
// message, is 0 there); clamped at TINY.  Its transform's DC term, lane
// 0's a, is its sum: the message is divided by it (+ TINY) through one
// IEEE reciprocal.  Only this warp reads the variable's edges in this
// phase, so the messages are replaced in place after one __syncwarp.
template <int D>
__device__ __forceinline__ void var_update(const MpTabs& tb, float* m,
                                           const float* cv,
                                           const uint8_t* slots,
                                           const uint8_t* s_edge,
                                           float scale, int lane) {
    int e[D], ia[D], ib[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const int s = __ldg(slots + j);
        e[j] = s_edge[s] * Q;
        ia[j] = __ldg(tb.fwd + s * Q + lane);
        ib[j] = __ldg(tb.fwd + s * Q + lane + 32);
    }
    float a[D], b[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        float pa = 1.0f, pb = 1.0f;
        bool first = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
            if (k == j) continue;
            const float xa = m[e[k] + ia[j]], xb = m[e[k] + ib[j]];
            pa = first ? xa : pa * xa;
            pb = first ? xb : pb * xb;
            first = false;
        }
        float xa = D > 1 ? cv[ia[j]] * pa : cv[ia[j]];
        float xb = D > 1 ? cv[ib[j]] * pb : cv[ib[j]];
        xa = xa * scale;
        xb = xb * scale;
        const float ta = xa * m[e[j] + ia[j]], tb2 = xb * m[e[j] + ib[j]];
        a[j] = clamp_tiny(ta == 0.0f ? 0.0f : xa);
        b[j] = clamp_tiny(tb2 == 0.0f ? 0.0f : xb);
    }
    wht64<D>(a, b, lane);
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const float r = __frcp_rn(__shfl_sync(FULL, a[j], 0) + TINY);
        a[j] = a[j] * r;
        b[j] = b[j] * r;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D; ++j) {
        m[e[j] + lane] = a[j];
        m[e[j] + lane + 32] = b[j];
    }
}

// Check of R edges e0 .. e0 + R - 1 (the warp's): the leave-one-out
// products of their transformed messages (prefix times suffix in slot
// order), the inverse transforms, / 64, clamped at TINY, written back in
// the variables' symbol order (lane l's symbol l to fwd[l]).  The sum of
// such a message is the leave-one-out product's DC term, 1 to rounding, so
// it is not normalised again.  Only this warp reads the check's edges in
// this phase: in place after one __syncwarp.
template <int R>
__device__ __forceinline__ void check_update(const MpTabs& tb, float* m,
                                             int e0, int lane) {
    float a[R], b[R], la[R], lb[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        a[j] = m[(e0 + j) * Q + lane];
        b[j] = m[(e0 + j) * Q + lane + 32];
    }
    float pa = 1.0f, pb = 1.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
        la[j] = pa;
        lb[j] = pb;
        pa = pa * a[j];
        pb = pb * b[j];
    }
    pa = 1.0f;
    pb = 1.0f;
#pragma unroll
    for (int j = R - 1; j >= 0; --j) {
        la[j] = la[j] * pa;
        lb[j] = lb[j] * pb;
        pa = pa * a[j];
        pb = pb * b[j];
    }
    wht64<R>(la, lb, lane);
    int ia[R], ib[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int s = __ldg(tb.e_slot + e0 + j);
        ia[j] = __ldg(tb.fwd + s * Q + lane);
        ib[j] = __ldg(tb.fwd + s * Q + lane + 32);
        la[j] = clamp_tiny(la[j] * (1.0f / Q));
        lb[j] = clamp_tiny(lb[j] * (1.0f / Q));
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < R; ++j) {
        m[(e0 + j) * Q + ia[j]] = la[j];
        m[(e0 + j) * Q + ib[j]] = lb[j];
    }
}

// Variables of up to MP_COL_MAX edges.  The messages of every edge stay
// in shared memory in one array, in place: after the variable phase an
// edge's entry is its transformed variable-to-check message (check order),
// after the check phase its check-to-variable message (variable order).
__global__ void __launch_bounds__(MP_THREADS, MP_BLOCKS_SM)
k_qra_mp(const uint8_t* __restrict__ tables, const float* __restrict__ probs,
         MpDims d, int64_t* __restrict__ hard, uint8_t* __restrict__ ok,
         float* __restrict__ conf) {
    MP_SPAN_BEGIN();
    extern __shared__ float smem[];
    __shared__ uint8_t s_edge[MP_SLOTS_MAX + 1];   // flat slot -> edge
    __shared__ uint8_t s_first[MP_NC_MAX], s_count[MP_NC_MAX];
    __shared__ uint8_t s_deg[MP_N_MAX];
    __shared__ int s_hard[MP_N_MAX];
    __shared__ float post_max[MP_N_MAX];
    const MpTabs tb = mp_tabs(tables, d);
    float* m = smem;
    float* chan = m + d.edges * Q;

    const int word = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* pw = probs + static_cast<long long>(word) * d.n * Q;
    for (int i = threadIdx.x; i < d.n * Q; i += MP_THREADS) chan[i] = pw[i];
    for (int i = threadIdx.x; i < d.edges * Q; i += MP_THREADS) m[i] = UNI;
    for (int i = threadIdx.x; i <= MP_SLOTS_MAX; i += MP_THREADS)
        s_edge[i] = 255;
    __syncthreads();
    for (int e = threadIdx.x; e < d.edges; e += MP_THREADS)
        s_edge[__ldg(tb.e_slot + e)] = static_cast<uint8_t>(e);
    __syncthreads();
    // each check's first edge and count (edges ascend by slot), each
    // variable's degree (its column slots, padded ones last)
    for (int c = threadIdx.x; c < d.nc; c += MP_THREADS) {
        int first = 255, count = 0;
        for (int s = 0; s < d.mr; ++s) {
            const int e = s_edge[c * d.mr + s];
            if (e == 255) continue;
            first = count == 0 ? e : first;
            ++count;
        }
        s_first[c] = static_cast<uint8_t>(first);
        s_count[c] = static_cast<uint8_t>(count);
    }
    for (int v = threadIdx.x; v < d.n; v += MP_THREADS) {
        int deg = 0;
        while (deg < d.max_col
               && __ldg(tb.col_slots + v * d.max_col + deg) != 255)
            ++deg;
        s_deg[v] = static_cast<uint8_t>(deg);
    }
    __syncthreads();
    MP_SPAN(0);

    for (int it = 0; it < d.iters; ++it) {
        for (int v = warp; v < d.n; v += MP_WARPS) {
            const int deg = s_deg[v];
            const uint8_t* slots = tb.col_slots + v * d.max_col;
            const float* cv = chan + v * Q;
            float scale = 1.0f;
            for (int k = deg; k < d.max_col; ++k) scale = scale * UNI;
            switch (deg) {
            case 1: var_update<1>(tb, m, cv, slots, s_edge, scale, lane); break;
            case 2: var_update<2>(tb, m, cv, slots, s_edge, scale, lane); break;
            case 3: var_update<3>(tb, m, cv, slots, s_edge, scale, lane); break;
            case 4: var_update<4>(tb, m, cv, slots, s_edge, scale, lane); break;
            default: break;
            }
        }
        MP_SPAN(1);
        __syncthreads();
        MP_SPAN(2);
        for (int c = warp; c < d.nc; c += MP_WARPS) {
            const int e0 = s_first[c];
            switch (s_count[c]) {
            case 1: check_update<1>(tb, m, e0, lane); break;
            case 2: check_update<2>(tb, m, e0, lane); break;
            case 3: check_update<3>(tb, m, e0, lane); break;
            case 4: check_update<4>(tb, m, e0, lane); break;
            default: break;
            }
        }
        MP_SPAN(3);
        __syncthreads();
        MP_SPAN(4);
    }

    // posterior (the channel row times the incoming messages in column
    // order), its argmax (NaN first, then the first index) and maximum
    for (int v = warp; v < d.n; v += MP_WARPS) {
        const int deg = s_deg[v];
        float x0 = chan[v * Q + lane], x1 = chan[v * Q + lane + 32];
        if (deg > 0) {
            float p0 = 1.0f, p1 = 1.0f;
            for (int j = 0; j < deg; ++j) {
                const int e = s_edge[__ldg(tb.col_slots + v * d.max_col + j)];
                p0 = j == 0 ? m[e * Q + lane] : p0 * m[e * Q + lane];
                p1 = j == 0 ? m[e * Q + lane + 32] : p1 * m[e * Q + lane + 32];
            }
            x0 = x0 * p0;
            x1 = x1 * p1;
        }
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
    MP_SPAN_END();
    if (threadIdx.x == 0) {
        float sum = 0.0f;
        for (int v = 0; v < d.n; ++v) sum = v == 0 ? post_max[0]
                                                    : sum + post_max[v];
        conf[word] = sum / static_cast<float>(d.n);
        ok[word] = bad ? 0 : 1;
    }
}

cudaError_t mp_attrs(int dev, int bytes) {
    // per-device dynamic shared memory set so far
    static int attr_bytes[MAX_DEVICES] = {};
    if (attr_bytes[dev] >= bytes) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(
        k_qra_mp, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    // as much of the SM's memory shared as the blocks want
    e = cudaFuncSetAttribute(k_qra_mp,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_bytes[dev] = bytes;
    return cudaSuccess;
}

cudaError_t mp_prepare(const MpDims& d, int* bytes) {
    *bytes = mp_smem_floats(d.n, d.edges) * static_cast<int>(sizeof(float));
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    return mp_attrs(dev, *bytes);
}

bool mp_dims_ok(const MpDims& d) {
    return d.n >= 1 && d.n <= MP_N_MAX && d.nc >= 1 && d.nc <= MP_NC_MAX
        && d.mr >= 1 && d.mr <= MP_MR && d.max_col >= 1
        && d.max_col <= MP_COL_MAX && d.nc * d.mr <= MP_SLOTS_MAX
        && d.edges >= 1 && d.edges <= d.nc * d.mr;
}

int launch_mp(const MpDims& d, const uint8_t* tables, const float* probs,
              int64_t* hard, uint8_t* ok, float* conf, cudaStream_t st) {
    int bytes = 0;
    const cudaError_t e = mp_prepare(d, &bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
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
int qary_mp_blocks_sm() { return MP_BLOCKS_SM; }
int qary_sync_tf() { return SYNC_TF; }
int qary_sync_t_max() { return SYNC_TMAX; }
int qary_sync_s_max() { return SYNC_S_MAX; }
int qary_sync_k_max() { return SYNC_K_MAX; }

// Table bytes and dynamic shared memory bytes of qra_mp for a code of n
// variables, nc checks of mr slots, max_col column slots and `edges` real
// slots.
int qra_mp_table_bytes(int n, int nc, int mr, int max_col, int edges) {
    return mp_table_bytes(n, nc, mr, max_col, edges);
}
int qra_mp_smem_bytes(int n, int edges) {
    return mp_smem_floats(n, edges) * static_cast<int>(sizeof(float));
}

// Resident qra_mp blocks an SM of the current device for this code
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor with its shared memory):
// dims [7] as qra_mp_launch's (B and iters unused).  Returns the
// cudaError_t.
int qra_mp_blocks_per_sm(const int* dims, int* out) {
    MpDims d;
    d.B = 1;
    d.n = dims[1];
    d.nc = dims[2];
    d.mr = dims[3];
    d.max_col = dims[4];
    d.edges = dims[5];
    d.iters = 0;
    if (!mp_dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
    int bytes = 0;
    cudaError_t e = mp_prepare(d, &bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, k_qra_mp, MP_THREADS, bytes));
}

// Sum-product decode of B words: dims [7] = B, n, nc, mr, max_col, edges,
// iters; tables: the table block; probs [B, n, 64] float32 -> hard [B, n]
// int64, ok [B] uint8 (the GF(64) syndrome is zero), conf [B] float32 (the
// mean of the posterior maxima), on `stream`, one launch.  Returns the
// cudaError_t.
int qra_mp_launch(const int* dims, const void* tables, const void* probs,
                  void* hard, void* ok, void* conf, void* stream) {
    MpDims d;
    d.B = dims[0];
    d.n = dims[1];
    d.nc = dims[2];
    d.mr = dims[3];
    d.max_col = dims[4];
    d.edges = dims[5];
    d.iters = dims[6];
    if (d.B < 1 || d.iters < 0 || !mp_dims_ok(d))
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
// 0 = qra_mp, 1 = qary_sync.  out [4].  Returns the cudaError_t.
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
