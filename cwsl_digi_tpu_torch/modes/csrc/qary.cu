// The q-ary modes' device stages (JT65, Q65-30): Q65's GF(64) sum-product
// decode (qra_mp), the q-ary sync correlation with its top-K (qary_sync)
// and the data symbols' tone gather with its top-4 (qary_symbols), each
// with no host sync.  The median of their maps, shared with WSPR and the
// GFSK engine, is csrc/median.cu's.
//
// qary_symbols replaces cwsl_digi_tpu/modes/qary_engine.py:123-135 (the
// advanced-index gather of each candidate's data-symbol tone energies,
// lax.top_k of 4, their sum and the log margin of the best two); its plain
// version, modes/qary_engine.py:_symbol_energies_plain, gathers
// [B, K, n, 64] energies, sorts every row and reduces it in ~10 launches.
//
// The first two replace two XLA programs of the JAX package:
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
//     161 MB at JT65's 15-window batch, 0.048 ms) and writes K candidates
//     a window.  Its operations, 63 adds and a division a score, are
//     ~0.04 ms: bytes bound it.  Each value read is added to 16 windows'
//     cells or fewer, so the cells' adds read shared memory once each:
//     ~0.04 ms of the SMs' shared-memory bandwidth at that shape, the
//     floor beside the bytes.
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
//   - qary_sync: a block of 8 warps takes a window's strips of 32 bins
//     and all 128 time offsets (warp w offsets w + 8 j, lane l bin l), in
//     turn every L-th strip (L = the lists a window, at most 4096 / K).
//     Where every hop is h0 plus a multiple of 8 (every mode's, os_t =
//     8), warp w reads only rows h0 + w + 8 m, its class rows m: each
//     lane copies the values it reads (cp.async, 4 bytes) into the warp's
//     own ring of 32 class rows, the first 20 mirrored past its end, so
//     no block barrier; a step waits only for its own copies, sums two
//     windows (each row once from shared memory into registers where the
//     two are at most 4 class rows apart) and issues the class rows of
//     the windows 8 to 9 ahead.  Other hops take a 256-row ring shared by
//     the block, one barrier a window.  A cell adds its rows in window
//     order from -0.0 (the identity), as the plain version's adds, bitwise;
//     it divides by base + 1e-30f and keys the score as (order key << 32
//     | ~index): the order key puts NaN first and reads -0.0 as 0.0, the
//     low word the lower index first on ties, so a larger key is the
//     earlier entry of the stable descending sort.  The strip's top K: the
//     keys at or above the K-th largest thread maximum (each warp sorts its
//     32 maxima with a bitonic network on shuffles, a binary search a
//     warp ranks each; at least K keys reach it, at most K threads hold
//     one) and above the block's list's K-th join a pool with the list,
//     and each takes its rank (the pool's keys above it) in the new list.
//     The window's last block (a counter in device memory that it resets,
//     so one launch and no memset) merges the lists' keys at or above the
//     K-th largest head the same way.  The score map is never written.
//     On an H100 80GB HBM3 at 700 W (tools/sync_rs_profile.py, in turns
//     with the first port): 0.1167-0.1195 ms at JT65's [15, 1411, 2645]
//     (first port 0.3479-0.3495), 41 % of the bound; the App's JT65
//     [4, 1411, 2645] 0.0490-0.0500 (0.1500-0.1521) and Q65-30 [4, 921,
//     2420] 0.0323-0.0334 (0.0909-0.0918).  64 registers, 53,536 B of
//     dynamic shared memory at top-24, 4 blocks an SM; a warp spends ~70 %
//     of its cycles in the correlation (an eighth of them waiting for its
//     copies), ~18-24 % in the strip's selection, and the last block
//     ~8 % more in the merge.  64-bin strips (two bins a lane, 2 blocks an
//     SM) were as fast or slower at every shape: not kept.
//
//   - qary_symbols reads 64 tones of each (window, candidate, data
//     symbol), at a stride of os_f bins (4 at JT65 and Q65: a float a
//     16-byte word, so 4x the bytes it uses cross the bus), and writes 4
//     energies, 4 tones, the sum and the margin (and the 64 energies where
//     Q65's message passing reads them).  At JT65's 15-window batch (360
//     candidates, 22,680 rows) that is 7.1 MB, 0.0021 ms at 3.35 TB/s, and
//     23.2 MB of the 32-byte sectors the gather touches, 0.0069 ms: bytes
//     bound it.  8 lanes take a row, 4 rows a warp: lane l holds tones l +
//     8 j and issues its 8 loads before it uses one (the candidate's t0, f0
//     and row come in one round trip before them).  The sum folds tones 32,
//     16 and 8 apart in the lane's registers and 4, 2, 1 apart by
//     __shfl_xor_sync: the plain version's halving fold, bit for bit.  A
//     tone's key is (order key << 32 | 63 - tone << 26 | the energy's sign
//     and mantissa): descending, NaN first, -0.0 equal to 0.0, the lower
//     tone first on ties, as the plain version's stable sort, and
//     invertible, so the winners' energies are read back from their keys,
//     NaN payloads and the sign of zero included.  A lane sorts its two
//     fours and merges them, and the group merges the sorted lists in three
//     butterfly steps (the larger of a[i] and b[3 - i], then two compare
//     steps): 6 shuffles a row and 3/4 of one for the sum (the first port,
//     a warp a row: ~50).  The margin is logf of the best two, each +
//     1e-30f, subtracted.  A candidate outside the map writes NaN energies
//     and tone -1.  The grid is the blocks the card holds at once (6 an SM
//     or more, so at most 40 registers; it takes 32, and the card holds 8
//     an SM, 1,056 blocks): JT65's batch in one wave of 709 blocks.  On an
//     H100 80GB HBM3 at 700 W (tools/qary_chase_profile.py, in turns with
//     the first port): 0.00977-0.01038 ms at JT65's batch (the first port
//     0.01624-0.01686), 21 % of the byte bound and 69 % of the sectors',
//     0.01614-0.01681 at Q65-30's 30 windows with the energies written
//     (0.02968-0.03013); 4, 16 and 32 lanes a row 0.0103-0.0105,
//     0.0130-0.0132 and 0.0212-0.0213 at JT65's.  Without the map's loads
//     it still takes 0.0087-0.0089, and without the group's merge
//     0.0086-0.0088: the launch, the t0 round trip and ~750 instructions a
//     warp (the keys and the sorting networks on 64-bit keys) set the time,
//     not the sectors.
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

// Profiling hooks, empty in the library: tools/sync_rs_profile.py builds
// this file with them defined to read clock64() at the kernel's phase
// boundaries (QSYNC_SPAN(k) closes span k).
#ifndef QSYNC_SPANS
#define QSYNC_SPAN_BEGIN()
#define QSYNC_SPAN(k)
#define QSYNC_SPAN_END()
#endif

constexpr int SYNC_WARPS = 8;
constexpr int SYNC_THREADS = SYNC_WARPS * 32;
constexpr int SYNC_TF = 32;              // bins a strip (a block's, in turn)
constexpr int SYNC_TMAX = 128;           // time offsets at most
constexpr int SYNC_CELLS = SYNC_TMAX / SYNC_WARPS;   // 16 offsets a thread
constexpr int SYNC_RING = 256;           // the block's ring rows (2^k)
constexpr int SYNC_AHEAD = 8;            // windows whose rows load ahead
// the path of hops all congruent mod 8 (every mode's: os_t = 8): a warp's
// own ring of class rows (row h0 + warp + 8 m is class row m)
constexpr int SYNC_WRING = 32;           // class rows a warp's ring holds
constexpr int SYNC_PAIR_GAP = 4;         // class rows between a pair's
                                         // windows summed from registers
constexpr int SYNC_WMIRROR = SYNC_CELLS + SYNC_PAIR_GAP;  // slots mirrored
                                                          // past its end
constexpr int SYNC_WAHEAD = 4;           // steps whose rows load ahead
constexpr int SYNC_S_MAX = 128;          // sync symbols at most
constexpr int SYNC_K_MAX = 256;
constexpr int SYNC_LIST_CAP = 4096;      // a window's listed candidates
static_assert(SYNC_AHEAD == 8, "the wait's switch takes 0 to 7 groups");
static_assert(SYNC_WAHEAD == 4, "the warp path's switch takes 0 to 3");
static_assert(SYNC_PAIR_GAP == 4, "the pair's switch takes gaps 0 to 4");
// rows of ring the block's region holds: the block's ring or the warps'
constexpr int SYNC_RING_ROWS =
    (SYNC_WRING + SYNC_WMIRROR) * SYNC_WARPS > SYNC_RING
        ? (SYNC_WRING + SYNC_WMIRROR) * SYNC_WARPS : SYNC_RING;
constexpr int SYNC_SMEM_MAX = 112 * 1024;   // dynamic shared bytes at most

// Each window's count of finished blocks: zero when the library loads, and
// the window's last block sets it back to zero, so no launch needs a
// memset.  Launches on one device run in stream order (the decoders' device
// lock, modes/base.py, keeps one decode at a time on a device), so no two
// launches share a counter at once.
__device__ unsigned int g_sync_done[65535];

struct SyncDims {
    int B, H, F, n_t0, n_f0, S, K, strips;
};

// Candidates a strip's pool holds at most: the block's list (K) and the
// cells of the K threads whose maxima reach the threshold (all cells when
// K >= the threads).
__host__ __device__ __forceinline__ int sync_pool_cap(int K) {
    return K + (K < SYNC_THREADS ? K : SYNC_THREADS) * SYNC_CELLS;
}

// The dynamic shared memory a block's first region takes, the ring or a
// pool (16-byte multiple), and its list of K keys and values after it.
__host__ __device__ __forceinline__ int sync_region_bytes(int K, int L) {
    const int ring = SYNC_RING_ROWS * SYNC_TF * 4;
    const int strip = sync_pool_cap(K) * 12;
    const int merge = ((L + 1) & ~1) * 8 + L * K * 12;
    int r = ring > strip ? ring : strip;
    r = r > merge ? r : merge;
    return (r + 15) & ~15;
}

__host__ __device__ __forceinline__ int sync_smem_bytes(int K, int L) {
    return sync_region_bytes(K, L) + K * 12;
}

// Lists (blocks) a window at most: K of each fit the merge's pool.
__host__ __device__ __forceinline__ int sync_lists(int K) {
    const int l = SYNC_LIST_CAP / K;
    return l > 0 ? l : 1;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A key's low word: ~(t0 n_f0 + f0), so a lower index wins a tie.
__device__ __forceinline__ uint32_t sync_low(int t, int f,
                                             const SyncDims& d) {
    return 0xffffffffu - (static_cast<uint32_t>(t)
                          * static_cast<uint32_t>(d.n_f0)
                          + static_cast<uint32_t>(f));
}

// A cell's key: (order key << 32) | ~(t0 n_f0 + f0), 0 = no cell.
__device__ __forceinline__ u64 sync_key(float v, int t, int f,
                                        const SyncDims& d) {
    return (t < d.n_t0 && f < d.n_f0)
        ? (static_cast<u64>(order_key(v)) << 32) | sync_low(t, f, d)
        : 0ull;
}

// The warp's 32 keys sorted descending (lane p holds the p-th largest): a
// bitonic network on shuffles.
__device__ __forceinline__ u64 warp_sort_desc(u64 v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            const u64 o = __shfl_xor_sync(FULL, v, j);
            const bool keep_max = ((lane & k) == 0) == ((lane & j) == 0);
            v = keep_max ? (o > v ? o : v) : (o < v ? o : v);
        }
    return v;
}

// Entries of a descending list of 32 keys above x (binary lifting).
__device__ __forceinline__ int count_above(const u64* list, u64 x) {
    int c = 0;
#pragma unroll
    for (int step = 32; step > 0; step >>= 1)
        if (c + step <= 32 && list[c + step - 1] > x) c += step;
    return c;
}

// Keys of keys [0, n) above x, read two at a time (keys 16-byte aligned).
__device__ __forceinline__ int keys_above(const u64* keys, int n, u64 x) {
    int above = 0, u = 0;
#pragma unroll 4
    for (; u + 2 <= n; u += 2) {
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(keys + u);
        above += (v.x > x) + (v.y > x);
    }
    if (u < n) above += keys[u] > x;
    return above;
}

// Issues the copies of the rows in [next, X) that lie in a window [hops[w],
// hops[w] + n_t0) (the union of the windows, in row order; rows between
// windows are skipped) into the block's ring, the warps taking rows in
// turn, lane l bin l of its strip.  next and wnext (the first window that
// ends past next) advance; every thread runs the same schedule.
__device__ __forceinline__ void sync_issue(int& next, int& wnext, int X,
                                           const int* s_hops,
                                           const SyncDims& d,
                                           const float* src, bool bin_ok,
                                           float* ring) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (;;) {
        while (wnext < d.S && s_hops[wnext] + d.n_t0 <= next) ++wnext;
        if (wnext == d.S) return;
        const int lo = max(next, s_hops[wnext]);
        if (lo >= X) return;
        const int hi = min(s_hops[wnext] + d.n_t0, X);
        for (int r = lo + warp; r < hi; r += SYNC_WARPS) {
            const bool full = r < d.H && bin_ok;
            const float* s = src + (full ? static_cast<long long>(r) * d.F
                                           + lane : 0ll);
            cp_async4(ring + (r & (SYNC_RING - 1)) * SYNC_TF + lane, s,
                      full);
        }
        next = hi;
    }
}

// The correlation of a strip on a ring shared by the block (any ascending
// hops): window i is the rows [hops[i], hops[i] + n_t0); a cell adds its
// rows in window order, from -0.0 (the identity: the first add gives the
// first row's value bit for bit).  While window i is summed, the rows up
// to window i + SYNC_AHEAD's end are issued as far as the ring's slots
// past window i reach; a window waits only for the groups up to the one
// that holds its last row (gnext[q]: the rows issued up to the group
// committed q groups back).  One block barrier a window, two where a gap
// between windows outruns the ring.
__device__ __forceinline__ void sync_sum_block(float* acc, const int* s_hops,
                                               const SyncDims& d,
                                               const float* src,
                                               bool bin_ok, float* ring) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h0 = s_hops[0];
    int next = h0, wnext = 0;
    int gnext[SYNC_AHEAD];
#pragma unroll
    for (int q = 0; q < SYNC_AHEAD; ++q) gnext[q] = h0;
#pragma unroll
    for (int g = 0; g < SYNC_AHEAD; ++g) {
        sync_issue(next, wnext,
                   min(h0 + SYNC_RING, s_hops[min(g, d.S - 1)] + d.n_t0),
                   s_hops, d, src, bin_ok, ring);
        cp_async_commit();
#pragma unroll
        for (int q = SYNC_AHEAD - 1; q > 0; --q) gnext[q] = gnext[q - 1];
        gnext[0] = next;
    }
#pragma unroll 1
    for (int i = 0; i < d.S; ++i) {
        const int h = s_hops[i], need = h + d.n_t0;
        int pending = -1;       // groups that may stay in flight
#pragma unroll
        for (int q = 0; q < SYNC_AHEAD; ++q)
            if (gnext[q] >= need) pending = q;
        QSYNC_SPAN(1);
        if (pending < 0) {
            // a gap outran the ring: the rest of window i once window
            // i - 1 is summed
            __syncthreads();
            sync_issue(next, wnext, need, s_hops, d, src, bin_ok, ring);
            cp_async_commit();
#pragma unroll
            for (int q = SYNC_AHEAD - 1; q > 0; --q) gnext[q] = gnext[q - 1];
            gnext[0] = next;
            pending = 0;
        }
        switch (pending) {
            case 0: cp_async_wait<0>(); break;
            case 1: cp_async_wait<1>(); break;
            case 2: cp_async_wait<2>(); break;
            case 3: cp_async_wait<3>(); break;
            case 4: cp_async_wait<4>(); break;
            case 5: cp_async_wait<5>(); break;
            case 6: cp_async_wait<6>(); break;
            default: cp_async_wait<SYNC_AHEAD - 1>(); break;
        }
        __syncthreads();
        QSYNC_SPAN(5);
        sync_issue(next, wnext,
                   min(h + SYNC_RING,
                       s_hops[min(i + SYNC_AHEAD, d.S - 1)] + d.n_t0),
                   s_hops, d, src, bin_ok, ring);
        cp_async_commit();
#pragma unroll
        for (int q = SYNC_AHEAD - 1; q > 0; --q) gnext[q] = gnext[q - 1];
        gnext[0] = next;
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j) {
            const int t = warp + SYNC_WARPS * j;
            if (t < d.n_t0)
                acc[j] += ring[((h + t) & (SYNC_RING - 1)) * SYNC_TF + lane];
        }
    }
}

// Adds a window's J class rows (a warp's ring from the window's first
// slot, contiguous through the mirror) to the thread's offsets.
__device__ __forceinline__ void sync_add_window(float* acc, const float* w,
                                                int J) {
    if (J == SYNC_CELLS) {
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j) acc[j] += w[j * SYNC_TF];
    } else {
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j)
            if (j < J) acc[j] += w[j * SYNC_TF];
    }
}

// Adds two windows G class rows apart, each row read once: the union's
// 16 + G class rows into registers, then window i's and window i + 1's
// adds in that order (a cell's order), from the first window's slot,
// contiguous through the mirror.
template <int G>
__device__ __forceinline__ void sync_add_pair(float* acc, const float* w) {
    float v[SYNC_CELLS + G];
#pragma unroll
    for (int u = 0; u < SYNC_CELLS + G; ++u) v[u] = w[u * SYNC_TF];
#pragma unroll
    for (int j = 0; j < SYNC_CELLS; ++j) acc[j] += v[j];
#pragma unroll
    for (int j = 0; j < SYNC_CELLS; ++j) acc[j] += v[j + G];
}

// Copies warp w's class rows [mnext, X) (row h0 + w + 8 m; class rows past
// m_last, the last below H, read as 0) into its ring at slot m mod
// SYNC_WRING, and at the slots below SYNC_WMIRROR again past its end;
// lane l takes bin l.  gp points at class row mnext's value and advances
// with it; a copy that reads nothing is given the strip's first value.
__device__ __forceinline__ void sync_issue_warp(int& mnext, const float*& gp,
                                                int X, int m_last,
                                                long long step, bool bin_ok,
                                                const float* safe,
                                                float* wring) {
    for (; mnext < X; ++mnext, gp += step) {
        const bool full = mnext <= m_last && bin_ok;
        const float* sp = full ? gp : safe;
        const int slot = mnext & (SYNC_WRING - 1);
        cp_async4(wring + slot * SYNC_TF, sp, full);
        if (slot < SYNC_WMIRROR)
            cp_async4(wring + (slot + SYNC_WRING) * SYNC_TF, sp, full);
    }
}

// The correlation of a strip where every hop is h0 plus a multiple of 8:
// warp w sums offsets w + 8 j, whose rows h0 + w + 8 m are its own class
// rows m, so each lane copies the values it reads into the warp's own
// ring (slot m mod SYNC_WRING, the first SYNC_WMIRROR slots again past its
// end, so a window's 16 class rows are contiguous): no block barrier, a
// thread waits only for its own copies.  Window i is class rows [c_i, c_i
// + J) (c_i = (hops[i] - h0) / 8, J the warp's offsets below n_t0).  A
// step sums two windows where both fit the ring (one wait and one issue
// for the two; where they are at most SYNC_PAIR_GAP class rows apart,
// each of their rows read from the ring once); while it does, the class rows up to window i + 2
// SYNC_WAHEAD + 1's end are issued as far as the ring's slots past window
// i reach (every class row from 0 on: rows between windows far apart are
// read too).
__device__ __forceinline__ void sync_sum_warp(float* acc, const int* s_hops,
                                              const SyncDims& d,
                                              const float* src, bool bin_ok,
                                              float* ring) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h0 = s_hops[0];
    const int J = d.n_t0 > warp ? (d.n_t0 - warp + SYNC_WARPS - 1) >> 3 : 0;
    float* wring = ring + warp * (SYNC_WRING + SYNC_WMIRROR) * SYNC_TF
        + lane;
    // class row m's value at (the first) + m step
    const float* gp = src + static_cast<long long>(h0 + warp) * d.F + lane;
    const long long step = static_cast<long long>(SYNC_WARPS) * d.F;
    const int m_last = d.H > h0 + warp ? (d.H - 1 - h0 - warp) >> 3 : -1;
    int mnext = 0;
    int gn[SYNC_WAHEAD];
#pragma unroll
    for (int q = 0; q < SYNC_WAHEAD; ++q) gn[q] = 0;
#pragma unroll
    for (int g = 0; g < SYNC_WAHEAD; ++g) {
        sync_issue_warp(mnext, gp,
                        min(SYNC_WRING,
                            ((s_hops[min(2 * g + 1, d.S - 1)] - h0) >> 3)
                            + J),
                        m_last, step, bin_ok, src, wring);
        cp_async_commit();
#pragma unroll
        for (int q = SYNC_WAHEAD - 1; q > 0; --q) gn[q] = gn[q - 1];
        gn[0] = mnext;
    }
#pragma unroll 1
    for (int i = 0; i < d.S;) {
        const int c = (s_hops[i] - h0) >> 3;
        const int c2 = i + 1 < d.S ? (s_hops[i + 1] - h0) >> 3 : c;
        const bool two = i + 1 < d.S && c2 + J - c <= SYNC_WRING;
        const int need = (two ? c2 : c) + J;
        int pending = -1;
#pragma unroll
        for (int q = 0; q < SYNC_WAHEAD; ++q)
            if (gn[q] >= need) pending = q;
        QSYNC_SPAN(1);
        if (pending < 0) {
            // a gap outran the ring: the rest of the step's windows now
            // (their slots hold no row still to be read)
            sync_issue_warp(mnext, gp, need, m_last, step, bin_ok, src,
                            wring);
            cp_async_commit();
#pragma unroll
            for (int q = SYNC_WAHEAD - 1; q > 0; --q) gn[q] = gn[q - 1];
            gn[0] = mnext;
            pending = 0;
        }
        switch (pending) {
            case 0: cp_async_wait<0>(); break;
            case 1: cp_async_wait<1>(); break;
            case 2: cp_async_wait<2>(); break;
            default: cp_async_wait<SYNC_WAHEAD - 1>(); break;
        }
        QSYNC_SPAN(5);
        sync_issue_warp(
            mnext, gp,
            min(c + SYNC_WRING,
                ((s_hops[min(i + 2 * SYNC_WAHEAD + 1, d.S - 1)] - h0) >> 3)
                + J),
            m_last, step, bin_ok, src, wring);
        cp_async_commit();
#pragma unroll
        for (int q = SYNC_WAHEAD - 1; q > 0; --q) gn[q] = gn[q - 1];
        gn[0] = mnext;
        const float* w = wring + (c & (SYNC_WRING - 1)) * SYNC_TF;
        const int g = c2 - c;
        if (two && J == SYNC_CELLS && g <= SYNC_PAIR_GAP) {
            switch (g) {
                case 0: sync_add_pair<0>(acc, w); break;
                case 1: sync_add_pair<1>(acc, w); break;
                case 2: sync_add_pair<2>(acc, w); break;
                case 3: sync_add_pair<3>(acc, w); break;
                default: sync_add_pair<SYNC_PAIR_GAP>(acc, w); break;
            }
        } else {
            sync_add_window(acc, w, J);
            if (two)
                sync_add_window(
                    acc, wring + (c2 & (SYNC_WRING - 1)) * SYNC_TF, J);
        }
        i += two ? 2 : 1;
    }
}

__global__ void __launch_bounds__(SYNC_THREADS, 4)
k_qary_sync(const float* __restrict__ ps, const float* __restrict__ base,
            const int* __restrict__ hops, SyncDims d,
            u64* __restrict__ cand_key, float* __restrict__ cand_val,
            float* __restrict__ top_val, int64_t* __restrict__ top_idx) {
    extern __shared__ __align__(16) unsigned char sync_smem[];
    __shared__ int s_hops[SYNC_S_MAX];
    __shared__ u64 s_max[SYNC_THREADS];
    __shared__ u64 s_tau;
    __shared__ int s_count;
    __shared__ int s_last;
    __shared__ int s_cong;          // every hop h0 plus a multiple of 8
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.y, L = gridDim.x, K = d.K;
    QSYNC_SPAN_BEGIN();
    const int region = sync_region_bytes(K, L);
    const int cap = sync_pool_cap(K);
    float* ring = reinterpret_cast<float*>(sync_smem);
    u64* pool_key = reinterpret_cast<u64*>(sync_smem);
    float* pool_val = reinterpret_cast<float*>(sync_smem + 8 * cap);
    u64* list_key = reinterpret_cast<u64*>(sync_smem + region);
    float* list_val = reinterpret_cast<float*>(sync_smem + region + 8 * K);
    const float* pb = ps + static_cast<long long>(b) * d.H * d.F;
    for (int i = threadIdx.x; i < d.S; i += SYNC_THREADS) s_hops[i] = hops[i];
    if (threadIdx.x == 0) s_cong = 1;
    __syncthreads();
    if (threadIdx.x < d.S
        && ((s_hops[threadIdx.x] - s_hops[0]) & (SYNC_WARPS - 1)) != 0)
        s_cong = 0;
    __syncthreads();
    QSYNC_SPAN(0);
    const float den = base[b] + TINY;
    int n_run = 0;              // the block's list: its top keys so far

    for (int strip = blockIdx.x; strip < d.strips; strip += L) {
        const int f_base = strip * SYNC_TF;
        const int f = f_base + lane;
        const bool bin_ok = f < d.n_f0;
        const float* src = pb + f_base;
        float acc[SYNC_CELLS];
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j) acc[j] = -0.0f;
        if (s_cong)
            sync_sum_warp(acc, s_hops, d, src, bin_ok, ring);
        else
            sync_sum_block(acc, s_hops, d, src, bin_ok, ring);
        cp_async_wait<0>();
        QSYNC_SPAN(1);

        // scores and the thread's largest key: the largest order key, the
        // first offset on ties (the lowest index)
        uint32_t best = 0u;
        int best_t = 0;
#pragma unroll
        for (int j = 0; j < SYNC_CELLS; ++j) {
            acc[j] = acc[j] / den;
            const int t = warp + SYNC_WARPS * j;
            const uint32_t ok = t < d.n_t0 && bin_ok ? order_key(acc[j]) : 0u;
            if (ok > best) {
                best = ok;
                best_t = t;
            }
        }
        const u64 m = best ? (static_cast<u64>(best) << 32)
                                 | sync_low(best_t, f, d)
                           : 0ull;
        // a key enters the list only above its K-th (floor), and only at
        // or above the K-th largest thread maximum (tau): K threads hold a
        // key at least that large.  Each warp sorts its 32 maxima; a
        // maximum's rank is its place in its warp's list and the maxima
        // above it in the other seven (a binary search each).
        const u64 floor_key = n_run == K ? list_key[K - 1] + 1 : 1ull;
        const u64 srt = warp_sort_desc(m);
        QSYNC_SPAN(2);
        __syncthreads();        // the ring is read: the pool takes its place
        QSYNC_SPAN(6);
        s_max[threadIdx.x] = srt;
        if (threadIdx.x == 0) {
            s_tau = floor_key;
            s_count = n_run;
        }
        for (int i = threadIdx.x; i < n_run; i += SYNC_THREADS) {
            pool_key[i] = list_key[i];
            pool_val[i] = list_val[i];
        }
        __syncthreads();
        if (srt >= floor_key) {
            int above = lane;
#pragma unroll
            for (int w2 = 0; w2 < SYNC_WARPS; ++w2)
                if (w2 != warp) above += count_above(s_max + 32 * w2, srt);
            if (above == K - 1) s_tau = srt;
        }
        __syncthreads();
        // the keys at tau join the pool (at most K threads hold one)
        const u64 tau = s_tau;
        if (m >= tau) {
#pragma unroll
            for (int j = 0; j < SYNC_CELLS; ++j) {
                const u64 k = sync_key(acc[j], warp + SYNC_WARPS * j, f, d);
                if (k >= tau) {
                    const int at = atomicAdd(&s_count, 1);
                    pool_key[at] = k;
                    pool_val[at] = acc[j];
                }
            }
        }
        __syncthreads();
        // the pool's K largest keys, placed by their ranks, are the list
        const int n_pool = s_count;
        for (int p = threadIdx.x; p < n_pool; p += SYNC_THREADS) {
            const u64 k = pool_key[p];
            const int above = keys_above(pool_key, n_pool, k);
            if (above < K) {
                list_key[above] = k;
                list_val[above] = pool_val[p];
            }
        }
        n_run = min(K, n_pool);
        __syncthreads();
        QSYNC_SPAN(2);
    }

    // the block's list, zero keys past its end
    const long long slot0 = (static_cast<long long>(b) * L + blockIdx.x) * K;
    for (int i = threadIdx.x; i < K; i += SYNC_THREADS) {
        cand_key[slot0 + i] = i < n_run ? list_key[i] : 0ull;
        cand_val[slot0 + i] = i < n_run ? list_val[i] : 0.0f;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        s_last = atomicAdd(g_sync_done + b, 1u)
                 == static_cast<unsigned>(L - 1);
        if (s_last) g_sync_done[b] = 0u;    // every block has counted
    }
    __syncthreads();
    QSYNC_SPAN(3);
    if (!s_last) {
        QSYNC_SPAN_END();
        return;
    }
    __threadfence();

    // the window's last block: the candidates at or above the K-th largest
    // head of the lists (tau) hold the top K; each is placed by its rank
    // among them
    const long long c0 = static_cast<long long>(b) * L * K;
    const int n_c = L * K;
    u64* heads = reinterpret_cast<u64*>(sync_smem);
    u64* mkey = heads + ((L + 1) & ~1);      // 16-byte aligned
    float* mval = reinterpret_cast<float*>(mkey + n_c);
    for (int l = threadIdx.x; l < L; l += SYNC_THREADS)
        heads[l] = __ldcg(cand_key + c0 + static_cast<long long>(l) * K);
    if (threadIdx.x == 0) {
        s_tau = 1ull;
        s_count = 0;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < L; l += SYNC_THREADS) {
        const u64 hk = heads[l];
        if (hk != 0ull && keys_above(heads, L, hk) == K - 1) s_tau = hk;
    }
    __syncthreads();
    const u64 tau = s_tau;
    constexpr int MB = 8;           // list entries a thread loads at once
    for (int i0 = 0; i0 < n_c; i0 += SYNC_THREADS * MB) {
        u64 kk[MB];
#pragma unroll
        for (int u = 0; u < MB; ++u) {
            const int i = i0 + u * SYNC_THREADS + threadIdx.x;
            kk[u] = i < n_c ? __ldcg(cand_key + c0 + i) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < MB; ++u) {
            const int i = i0 + u * SYNC_THREADS + threadIdx.x;
            const bool take = i < n_c && kk[u] >= tau;
            const unsigned bal = __ballot_sync(FULL, take);
            int at = 0;
            if (lane == 0 && bal) at = atomicAdd(&s_count, __popc(bal));
            at = __shfl_sync(FULL, at, 0)
                + __popc(bal & ((1u << lane) - 1u));
            if (take) {
                mkey[at] = kk[u];
                mval[at] = __ldcg(cand_val + c0 + i);
            }
        }
    }
    __syncthreads();
    const int n_pool = s_count;
    for (int p = threadIdx.x; p < n_pool; p += SYNC_THREADS) {
        const u64 k = mkey[p];
        const int above = keys_above(mkey, n_pool, k);
        if (above < K) {
            top_val[static_cast<long long>(b) * K + above] = mval[p];
            top_idx[static_cast<long long>(b) * K + above] =
                static_cast<int64_t>(0xffffffffu - static_cast<uint32_t>(k));
        }
    }
    QSYNC_SPAN(4);
    QSYNC_SPAN_END();
}

// Sets the kernel's dynamic shared memory limit once a device.  Returns
// the cudaError_t.
int sync_attr() {
    static bool attr_set[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (!attr_set[dev]) {
        e = cudaFuncSetAttribute(k_qary_sync,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SYNC_SMEM_MAX);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set[dev] = true;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// qary_symbols

constexpr int SYM_WARPS = 8;
constexpr int SYM_THREADS = SYM_WARPS * 32;
constexpr int SYM_TONES = 64;            // tones a symbol (the kernel's only)
constexpr int SYM_GROUP = 8;             // lanes a row
constexpr int SYM_MIN_BLOCKS = 6;        // blocks an SM: JT65's 15-window
                                         // batch in one wave on 132 SMs

struct SymDims {
    int B, H, F;          // windows, map rows, map bins
    int K, n;             // candidates a window, data symbols
    int n_t0, n_f0;       // t0 < n_t0, f0 < n_f0 (the sync search's range)
    int os_f, tone0;      // bins a tone; bin of tone 0 past f0
    int full_e;           // write the 64 energies
};

// A tone's key: the energy's order key (NaN first, -0.0 equal to 0.0) in
// the high word, 63 - tone in the low word's top 6 bits (the lower tone
// first on ties), and below them the energy's sign and mantissa, which no
// comparison reaches (a row's tones differ) but which make the key
// invertible: sym_value gives the energy back bit for bit, NaN payloads and
// the sign of zero included.
__device__ __forceinline__ u64 sym_key(float v, int tone) {
    const uint32_t u = __float_as_uint(v);
    // order_key in integer operations: flip a negative's bits, set a
    // positive's sign; zeros of both signs as +0.0's key, NaN above all
    uint32_t k = u ^ (static_cast<uint32_t>(static_cast<int>(u) >> 31)
                      | 0x80000000u);
    k = (u & 0x7fffffffu) == 0u ? 0x80000000u : k;
    k = (u & 0x7fffffffu) > 0x7f800000u ? 0xffffffffu : k;
    const uint32_t lo = (static_cast<uint32_t>(SYM_TONES - 1 - tone) << 26)
        | ((u >> 8) & 0x800000u) | (u & 0x7fffffu);
    return (static_cast<u64>(k) << 32) | lo;
}

__device__ __forceinline__ int sym_tone(u64 key) {
    return SYM_TONES - 1 - static_cast<int>((key >> 26) & 63u);
}

__device__ __forceinline__ float sym_value(u64 key) {
    const uint32_t hi = static_cast<uint32_t>(key >> 32);
    const uint32_t lo = static_cast<uint32_t>(key);
    const uint32_t sign = (lo & 0x800000u) << 8;
    const uint32_t bits = hi == 0xffffffffu ? sign | 0x7f800000u
            | (lo & 0x7fffffu)                           // NaN
        : hi == 0x80000000u ? sign                        // zero
        : (hi & 0x80000000u) ? hi & 0x7fffffffu : ~hi;
    return __uint_as_float(bits);
}

// a >= b afterwards
__device__ __forceinline__ void sym_cas(u64& a, u64& b) {
    const u64 hi = a > b ? a : b;
    b = a > b ? b : a;
    a = hi;
}

// Sorts 4 keys descending.
__device__ __forceinline__ void sym_sort4(u64* k) {
    sym_cas(k[0], k[1]);
    sym_cas(k[2], k[3]);
    sym_cas(k[0], k[2]);
    sym_cas(k[1], k[3]);
    sym_cas(k[1], k[2]);
}

// The top 4 of two descending lists of 4 distinct keys, descending, into
// a: the larger of a[i] and b[3 - i] is a bitonic sequence holding them,
// which two compare steps sort.  Both lanes of a pair that merge each
// other's lists get the same list.
__device__ __forceinline__ void sym_merge4(u64* a, const u64* b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a[i] > b[3 - i] ? a[i] : b[3 - i];
    sym_cas(a[0], a[2]);
    sym_cas(a[1], a[3]);
    sym_cas(a[0], a[1]);
    sym_cas(a[2], a[3]);
}

// G lanes a row (window b, candidate k, data symbol s), 32 / G rows a warp,
// a warp's rows consecutive: power [B, H, F] float32, t0 / f0 [B K] int64,
// rows [n] int32 (os_t x the data symbols); e [B K n, 64] (full_e), top_e
// [B K n, 4], top_tone [B K n, 4] int64, e_sum and margin [B K n].  Lane l
// of a row's group holds tones l + G j (j < 64 / G): it issues all its
// loads before it uses one, folds its tones 32, 16, ... apart in
// registers and the group folds the rest by __shfl_xor_sync, the plain
// version's halving order; it sorts its keys' top 4 and the group merges
// the sorted lists in log2(G) butterfly steps, after which every lane of
// the group holds the row's top 4 keys, each energy read back from its key.
// The grid is the blocks the card holds at once, and a warp walks rows in a
// grid-stride loop.
__global__ void __launch_bounds__(SYM_THREADS, SYM_MIN_BLOCKS)
k_qary_symbols(const float* __restrict__ power,
               const int64_t* __restrict__ t0, const int64_t* __restrict__ f0,
               const int* __restrict__ rows, SymDims d, float* __restrict__ e,
               float* __restrict__ top_e, int64_t* __restrict__ top_tone,
               float* __restrict__ e_sum, float* __restrict__ margin) {
    constexpr int G = SYM_GROUP;
    static_assert(G == 4 || G == 8 || G == 16 || G == 32,
                  "4, 8, 16 or 32 lanes a row");
    constexpr int T = SYM_TONES / G;     // tones a lane
    constexpr int R = 32 / G;            // rows a warp
    const int lane = threadIdx.x & 31, sub = lane & (G - 1);
    const unsigned n_rows = static_cast<unsigned>(d.B) * d.K * d.n;
    const unsigned step = gridDim.x * SYM_WARPS * R;
    for (unsigned w0 = (blockIdx.x * SYM_WARPS + (threadIdx.x >> 5)) * R;
         w0 < n_rows; w0 += step) {
        const unsigned row = w0 + lane / G;
        const bool live = row < n_rows;
        const unsigned cand = live ? row / d.n : 0u;
        const int s = static_cast<int>(row - cand * d.n);
        const unsigned b = cand / d.K;
        long long tt = -1, ff = -1;
        int hop = 0;
        if (live) {                      // one round trip for the three
            tt = t0[cand];
            ff = f0[cand];
            hop = rows[s];
        }
        const bool inside = tt >= 0 && tt < d.n_t0 && ff >= 0 && ff < d.n_f0;
        float v[T];
        if (inside) {
            const float* p = power
                + (static_cast<long long>(b) * d.H + tt + hop) * d.F
                + ff + d.tone0 + static_cast<long long>(d.os_f) * sub;
            const long long stride = static_cast<long long>(d.os_f) * G;
#pragma unroll
            for (int j = 0; j < T; ++j) v[j] = __ldg(p + stride * j);
        } else {
#pragma unroll
            for (int j = 0; j < T; ++j) v[j] = __int_as_float(0x7fc00000);
        }
        if (d.full_e && live) {
            float* out = e + static_cast<long long>(row) * SYM_TONES + sub;
#pragma unroll
            for (int j = 0; j < T; ++j) out[G * j] = v[j];
        }
        // the halving fold: tones 32, 16, ... apart in the lane's
        // registers, then G / 2, ..., 1 apart across the group
        float f[T];
#pragma unroll
        for (int j = 0; j < T; ++j) f[j] = v[j];
#pragma unroll
        for (int h = T / 2; h > 0; h >>= 1)
#pragma unroll
            for (int j = 0; j < h; ++j) f[j] = f[j] + f[j + h];
        float sum = f[0];
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
            sum += __shfl_xor_sync(FULL, sum, off);
        // the lane's top 4, then the group's
        u64 top[4];
        if constexpr (T == 2) {
            const u64 k0 = sym_key(v[0], sub), k1 = sym_key(v[1], sub + G);
            top[0] = k0 > k1 ? k0 : k1;
            top[1] = k0 > k1 ? k1 : k0;
            top[2] = top[3] = 0;         // 0 is below every order key
        } else {                         // sorted fours, merged in pairs
            u64 four[T >= 4 ? T / 4 : 1][4];  // (T 2 builds this too)
#pragma unroll
            for (int b = 0; b < T / 4; ++b) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    four[b][j] = sym_key(v[4 * b + j], sub + G * (4 * b + j));
                sym_sort4(four[b]);
            }
#pragma unroll
            for (int w = 1; w < T / 4; w *= 2)
#pragma unroll
                for (int b = 0; b < T / 4; b += 2 * w)
                    sym_merge4(four[b], four[b + w]);
#pragma unroll
            for (int j = 0; j < 4; ++j) top[j] = four[0][j];
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
            u64 other[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                other[j] = __shfl_xor_sync(FULL, top[j], off);
            sym_merge4(top, other);
        }
        if (live && sub < 4) {   // (selects, so the list stays in registers)
            const u64 mine = sub == 0 ? top[0] : sub == 1 ? top[1]
                : sub == 2 ? top[2] : top[3];
            top_e[static_cast<long long>(row) * 4 + sub] = sym_value(mine);
            top_tone[static_cast<long long>(row) * 4 + sub] =
                inside ? sym_tone(mine) : -1;
        }
        // lane 0 of the group the best energy's log, lane 1 the second's
        const float lg = logf(sym_value(sub == 0 ? top[0] : top[1]) + TINY);
        const float lg1 = __shfl_down_sync(FULL, lg, 1);
        if (live && sub == 0) {
            e_sum[row] = sum;
            margin[row] = lg - lg1;
        }
    }
}

// The blocks of k_qary_symbols the current device holds at once (SMs x
// blocks an SM), kept a device.  Returns the cudaError_t.
int sym_resident(int* out) {
    static int resident[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return static_cast<int>(e);
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, k_qary_symbols, SYM_THREADS, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
        resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    *out = resident[dev];
    return 0;
}

}  // namespace

extern "C" {

int qary_mp_n_max() { return MP_N_MAX; }
int qary_mp_nc_max() { return MP_NC_MAX; }
int qary_mp_mr_max() { return MP_MR; }
int qary_mp_col_max() { return MP_COL_MAX; }
int qary_mp_blocks_sm() { return MP_BLOCKS_SM; }
int qary_sync_tf() { return SYNC_TF; }
int qary_sync_ring() { return SYNC_RING; }
int qary_sync_ahead() { return SYNC_AHEAD; }
int qary_sync_list_cap() { return SYNC_LIST_CAP; }
int qary_sync_t_max() { return SYNC_TMAX; }
int qary_sync_s_max() { return SYNC_S_MAX; }
int qary_sync_k_max() { return SYNC_K_MAX; }
int qary_symbols_tones() { return SYM_TONES; }
int qary_symbols_group() { return SYM_GROUP; }

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

// Sync correlation and top-K of B windows: dims [8] = B, H, F, n_t0, n_f0,
// S, K, L (lists a window: min(strips, max(1, SYNC_LIST_CAP / K)), strips
// = ceil(n_f0 / 32)); ps [B, H, F] float32, base [B] float32, hops [S]
// int32 (os_t x the sync symbols, ascending, hops[S - 1] + n_t0 <= H; rows
// past H read as 0); cand_key [B, L, K] uint64 and cand_val [B, L, K]
// float32 scratch; top_val [B, K] float32, top_idx [B, K] int64, one
// launch on `stream`.  Returns the cudaError_t.
int qary_sync_launch(const int* dims, const void* ps, const void* base,
                     const void* hops, void* cand_key, void* cand_val,
                     void* top_val, void* top_idx, void* stream) {
    SyncDims d;
    d.B = dims[0];
    d.H = dims[1];
    d.F = dims[2];
    d.n_t0 = dims[3];
    d.n_f0 = dims[4];
    d.S = dims[5];
    d.K = dims[6];
    const int L = dims[7];
    if (d.B < 1 || d.B > 65535 || d.n_t0 < 1 || d.n_t0 > SYNC_TMAX
        || d.n_f0 < 1 || d.n_f0 > d.F || d.S < 1 || d.S > SYNC_S_MAX
        || d.K < 1 || d.K > SYNC_K_MAX
        || static_cast<long long>(d.n_t0) * d.n_f0 < d.K)
        return static_cast<int>(cudaErrorInvalidValue);
    d.strips = (d.n_f0 + SYNC_TF - 1) / SYNC_TF;
    if (L != (d.strips < sync_lists(d.K) ? d.strips : sync_lists(d.K)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int e = sync_attr();
    if (e != 0) return e;
    k_qary_sync<<<dim3(L, d.B), SYNC_THREADS, sync_smem_bytes(d.K, L),
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ps), static_cast<const float*>(base),
        static_cast<const int*>(hops), d, static_cast<u64*>(cand_key),
        static_cast<float*>(cand_val), static_cast<float*>(top_val),
        static_cast<int64_t*>(top_idx));
    return static_cast<int>(cudaGetLastError());
}

// The tone gather and top-4 of B x K candidates' n data symbols: dims [10]
// = B, H, F, K, n, n_t0, n_f0, os_f, tone0, full_e; power [B, H, F]
// float32, t0 / f0 [B, K] int64, rows [n] int32 (os_t x the data symbols;
// the wrapper checks that n_t0 - 1 + rows and n_f0 - 1 + tone0 + 63 os_f
// stay inside the map); e [B, K, n, 64] float32 (written only with full_e),
// top_e [B, K, n, 4] float32, top_tone [B, K, n, 4] int64, e_sum and margin
// [B, K, n] float32, on `stream`, one launch of the blocks the card holds
// at once.  Returns the cudaError_t.
int qary_symbols_launch(const int* dims, const void* power, const void* t0,
                        const void* f0, const void* rows, void* e,
                        void* top_e, void* top_tone, void* e_sum,
                        void* margin, void* stream) {
    SymDims d;
    d.B = dims[0];
    d.H = dims[1];
    d.F = dims[2];
    d.K = dims[3];
    d.n = dims[4];
    d.n_t0 = dims[5];
    d.n_f0 = dims[6];
    d.os_f = dims[7];
    d.tone0 = dims[8];
    d.full_e = dims[9];
    if (d.B < 1 || d.K < 1 || d.n < 1 || d.n_t0 < 1 || d.n_t0 > d.H
        || d.n_f0 < 1 || d.os_f < 1 || d.tone0 < 0
        || d.n_f0 - 1 + d.tone0 + (SYM_TONES - 1) * d.os_f >= d.F
        || static_cast<long long>(d.B) * d.K * d.n > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    int resident = 0;
    const int err = sym_resident(&resident);
    if (err != 0) return err;
    const long long rows_n = static_cast<long long>(d.B) * d.K * d.n;
    const long long per_block = SYM_WARPS * (32 / SYM_GROUP);
    long long blocks = (rows_n + per_block - 1) / per_block;
    if (blocks > resident) blocks = resident;
    k_qary_symbols<<<static_cast<unsigned>(blocks), SYM_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(power), static_cast<const int64_t*>(t0),
        static_cast<const int64_t*>(f0), static_cast<const int*>(rows), d,
        static_cast<float*>(e), static_cast<float*>(top_e),
        static_cast<int64_t*>(top_tone), static_cast<float*>(e_sum),
        static_cast<float*>(margin));
    return static_cast<int>(cudaGetLastError());
}

// qary_symbols' layout on the current device: out [4] = lanes a row, rows
// a warp, blocks an SM, the grid's cap (the blocks the card holds at
// once).  Returns the cudaError_t.
int qary_symbols_design(int* out) {
    int resident = 0, sms = 0, dev = 0;
    const int e = sym_resident(&resident);
    if (e != 0) return e;
    cudaError_t c = cudaGetDevice(&dev);
    if (c == cudaSuccess)
        c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (c != cudaSuccess) return static_cast<int>(c);
    out[0] = SYM_GROUP;
    out[1] = 32 / SYM_GROUP;
    out[2] = resident / sms;
    out[3] = resident;
    return 0;
}

// Dynamic shared memory bytes of a qary_sync block at top-k and L lists a
// window, and the blocks an SM holds at it
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out [2].  Returns the
// cudaError_t.
int qary_sync_occupancy(int k, int lists, int* out) {
    if (k < 1 || k > SYNC_K_MAX || lists < 1 || lists > sync_lists(k))
        return static_cast<int>(cudaErrorInvalidValue);
    out[0] = sync_smem_bytes(k, lists);
    const int e = sync_attr();
    if (e != 0) return e;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, k_qary_sync, SYNC_THREADS, out[0]));
}

// A kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes): which
// 0 = qra_mp, 1 = qary_sync, 2 = qary_symbols.  out [4].  Returns the
// cudaError_t.
int qary_kernel_attrs(int which, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaErrorInvalidValue;
    if (which == 0) e = cudaFuncGetAttributes(&a, k_qra_mp);
    else if (which == 1) e = cudaFuncGetAttributes(&a, k_qary_sync);
    else if (which == 2) e = cudaFuncGetAttributes(&a, k_qary_symbols);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

}  // extern "C"
