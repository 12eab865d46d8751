// Min-sum LDPC belief propagation and ordered-statistics decoding (OSD), the
// two largest stages of the GFSK decode, as one launch each.
//
// bp_minsum replaces the XLA program cwsl_digi_tpu/modes/ldpc.py:238
// BPDecoder.decode_full (normalized min-sum with a fixed iteration count,
// then the syndrome); its plain PyTorch version is
// cwsl_digi_tpu_torch/modes/ldpc.py:BPDecoder.decode_full_plain, some 20
// small ops per iteration over [M, n_checks, max_row] tensors (~600
// launches a call).  osd replaces cwsl_digi_tpu/modes/osd.py:_osd_one /
// osd_decode; its plain version, cwsl_digi_tpu_torch/modes/osd.py:
// osd_decode_plain, runs ~12 launches per generator column and a host sync
// every 8 columns.
//
// What bounds them on an H100.  BP at the FT8 path's first pass (36,864
// words of LDPC(174,91), 522 edges, 30 iterations) does ~3.1e9 float
// operations on 58 MB of LLRs and outputs: 0.093 ms of FP32 issue (each
// add, multiply, minimum and compare one operation a lane and clock, the
// library being built with --fmad=false) against 0.017 ms of HBM, so the
// bound is operations.  OSD (384 words, k = 91, 268 flip patterns) is
// ~5.7e7 integer and float operations on 0.36 MB: a few microseconds at
// the INT32 rate.  Neither is near its bound in practice: both are chains
// of dependent steps (30 iterations of a check phase and a variable phase;
// 36 sort steps and ~105 elimination columns a word), so what they cost is
// latency per step times the number of steps, and keeping the whole chain
// on chip.  What holds BP back on this card is the instructions it
// issues, not its shared-memory traffic: on the H100, packing its tables
// (a fifth fewer shared-memory wavefronts) left its time as it was, while
// unrolling its loops for the code's degrees made it faster; and keeping
// each check's messages in min-sum's compressed form (alpha * m1,
// alpha * m2eff, the signs, the minimum's slot), with the tables in
// registers or in shared memory, made it slower: rebuilding every message
// in the variable phase costs more instructions than the loads it saves,
// and the register tables cost occupancy.  OSD's 384 words fill less than
// one warp a scheduler of the card's 528, so a word's chain of dependent
// instructions is the kernel's time: the first design (a block a word, two
// block barriers a pivot column, a 256-key sort whatever n, every word
// packing its permuted generator from a byte matrix through perm) took
// 0.086 ms.  The design:
//
//   - bp_minsum: one warp per word, four words per block.  The messages
//     [n_checks, max_row] and the variable totals [n] of a word live in
//     shared memory for all iterations; lane l owns checks l, l+32, ...
//     and variables l, l+32, ....  An iteration is a check phase,
//     __syncwarp, a variable phase, __syncwarp: no block barrier, words
//     never wait for each other.  The tables are packed once per block in
//     shared memory as byte offsets (a check's 8 columns into the totals
//     in one 16-byte load, a variable's 4 incoming slots into the
//     messages in one 8-byte load), and the kernel is instantiated for the
//     codes' degrees (7 and 3 for FT8/FT4, 6 and 3 for JS8 and
//     FST4/FST4W, any other up to the limits), so the loops over a check's
//     slots and a variable's edges unroll with no run-time bounds.  A
//     check forms alpha * m1 and alpha * m2eff once and each message from
//     them and its sign.  The LLRs are read once; hard bits, the syndrome
//     flag and the posterior totals are written once.  The arithmetic is
//     the plain version's, operation for operation: the sign is (m < 0),
//     so -0.0 is positive; the second minimum is over magnitudes strictly
//     above the first, a duplicated minimum gives the first, padded slots
//     count as 1e9 and send 0; a variable's incoming messages are summed
//     in column-slot order from 0 and then added to the channel LLR.  The
//     library is built with --fmad=false, so no product and sum are
//     contracted into an FMA.
//   - osd: one warp a word, four words a block, __syncwarp and shuffles
//     only (no block barrier: words never wait on each other).  The
//     generator is packed once per code (_kernels.generator_columns): column
//     j as a k-bit mask, 16 bytes, read through the L1 (each lane its
//     columns' masks at their received positions; staging the 2.8 KB table
//     in shared memory would need a block barrier or a copy a warp).  A
//     bitonic sort in registers, 8 keys a lane, up to the power of two >= n,
//     of 64-bit keys (|LLR| bits + 1, 0 for NaN; 511 - index; the sign)
//     gives the stable reliability order, NaN last.  Gauss-Jordan runs in
//     column form: lane l owns columns l, l + 32, ...; for each column in
//     order its owner finds the lowest row not yet a pivot with a set bit
//     (a one-hot mask, no bit search on the chain) and broadcasts it and
//     the column; every lane XORs that column, less the pivot bit, into
//     its columns with that bit set, branch-free.  Rows are not swapped:
//     the reduced row echelon form is unique, so the pivot rows ordered by
//     their columns are the plain version's rows (the NumPy model in the
//     LDPC tests shows it), each row's basis coordinate its pivot column.
//     The rows go to shared memory in basis order through a transpose of
//     the columns, and the base codeword is the parity of each column's
//     bits in the rows whose decision is 1.  Each flip pattern's codeword
//     is the base XOR <= 3 rows; a lane takes three patterns at once and
//     sums their soft distances word by word with __fadd_rn in ascending
//     bit order (+0 where the bits agree, no branch); the arg-min takes the
//     first pattern on a tie, pattern 0 when every distance is NaN.  Its
//     time is a single warp's: one scheduler issues it alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false -o libldpc.so ldpc.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BP_WARPS = 4;          // words per block, one warp each
constexpr int BP_MAX_ROW = 8;        // check degree
constexpr int BP_MAX_COL = 4;        // variable degree
constexpr int BP_MAX_N = 256;        // code length
constexpr int BP_MAX_CHECKS = 256;
constexpr int BP_VARS_PER_LANE = BP_MAX_N / 32;
constexpr float BP_PAD = 1e9f;       // magnitude of a padded check slot
constexpr unsigned BP_NONE = 0xffffu;  // a padded table entry

constexpr int OSD_WARPS = 4;         // words per block, one warp each
constexpr int OSD_MAX_K = 128;       // code dimension: 4 words a column
constexpr int OSD_MAX_N = 256;       // code length: 8 keys and columns a lane
constexpr int OSD_MAX_W = OSD_MAX_N / 32;    // packed words per row
constexpr int OSD_MAX_FLIPS = 3;             // rows per flip pattern
constexpr int OSD_PATS = 3;                  // patterns a lane takes at once
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of a block: the packed tables (a check's columns as byte
// offsets into the totals, 8 x 16 bits; a variable's incoming slots as
// byte offsets into the messages, 4 x 16 bits), then each word's messages
// [n_checks, max_row] and totals [n], 16-byte aligned.
__host__ __device__ inline int bp_table_bytes(int n, int nc) {
    return nc * 16 + n * 8;
}

__host__ __device__ inline int bp_word_bytes(int n, int nc, int mr) {
    return (nc * mr * 4 + n * 4 + 15) & ~15;
}

// 16-bit entry k of a packed table word
template <typename V>
__device__ __forceinline__ unsigned bp_half(const V& v, int k) {
    const unsigned w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    return (w >> (16 * (k & 1))) & 0xffffu;
}

__device__ __forceinline__ unsigned bp_half(const uint2& v, int k) {
    return ((k < 2 ? v.x : v.y) >> (16 * (k & 1))) & 0xffffu;
}

// MR, MC: the check and variable degrees the loops are unrolled for (the
// code's max_row and max_col), or 0 for any up to the limits.
template <int MR, int MC>
__global__ void __launch_bounds__(BP_WARPS * 32)
bp_minsum_kernel(const float* __restrict__ llr,
                 const int16_t* __restrict__ row_cols,
                 const int16_t* __restrict__ col_slots,
                 int8_t* __restrict__ hard, uint8_t* __restrict__ ok,
                 float* __restrict__ post, int m, int n, int nc, int mr_rt,
                 int mc_rt, int iters, float alpha) {
    constexpr int ROW = MR ? MR : BP_MAX_ROW;
    constexpr int COL = MC ? MC : BP_MAX_COL;
    const int mr = MR ? MR : mr_rt;
    const int mc = MC ? MC : mc_rt;
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* ctab = reinterpret_cast<uint4*>(smem);
    uint2* etab = reinterpret_cast<uint2*>(ctab + nc);
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
        unsigned h[BP_MAX_ROW];
#pragma unroll
        for (int s = 0; s < BP_MAX_ROW; ++s) {
            const int c = s < mr ? row_cols[i * mr + s] : n;
            h[s] = c < n ? 4u * static_cast<unsigned>(c) : BP_NONE;
        }
        ctab[i] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                             h[4] | h[5] << 16, h[6] | h[7] << 16);
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        unsigned h[BP_MAX_COL];
#pragma unroll
        for (int e = 0; e < BP_MAX_COL; ++e) {
            const int sl = e < mc ? col_slots[j * mc + e] : -1;
            h[e] = sl >= 0 ? 4u * static_cast<unsigned>(sl) : BP_NONE;
        }
        etab[j] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int word = blockIdx.x * BP_WARPS + warp;
    if (word >= m) return;          // a whole warp; no block barrier follows
    float* msg = reinterpret_cast<float*>(smem + bp_table_bytes(n, nc)
                                          + warp * bp_word_bytes(n, nc, mr));
    float* tot = msg + nc * mr;
    const char* tot_b = reinterpret_cast<const char*>(tot);
    const char* msg_b = reinterpret_cast<const char*>(msg);
    const float* l = llr + static_cast<size_t>(word) * n;

    float lv[BP_VARS_PER_LANE];
#pragma unroll
    for (int q = 0; q < BP_VARS_PER_LANE; ++q) {
        const int j = lane + 32 * q;
        lv[q] = j < n ? l[j] : 0.f;
        if (j < n) tot[j] = lv[q];  // the LLR plus no message yet
    }
    for (int s = lane; s < nc * mr; s += 32) msg[s] = 0.f;
    __syncwarp();

    for (int it = 0; it < iters; ++it) {
        // check phase: variable->check messages, then normalized min-sum
        for (int i = lane; i < nc; i += 32) {
            const uint4 ct = ctab[i];
            float* mi = msg + i * mr;
            float mag[ROW];
            unsigned neg = 0;
#pragma unroll
            for (int s = 0; s < ROW; ++s) {
                mag[s] = BP_PAD;
                const unsigned off = bp_half(ct, s);
                if (off != BP_NONE) {
                    const float v = __fsub_rn(
                        *reinterpret_cast<const float*>(tot_b + off), mi[s]);
                    mag[s] = fabsf(v);
                    neg |= static_cast<unsigned>(v < 0.f) << s;
                }
            }
            float m1 = mag[0];
#pragma unroll
            for (int s = 1; s < ROW; ++s)
                if (s < mr) m1 = fminf(m1, mag[s]);
            float m2 = BP_PAD;
            int n_min = 0;
#pragma unroll
            for (int s = 0; s < ROW; ++s) {
                if (s < mr) {
                    if (mag[s] > m1) m2 = fminf(m2, mag[s]);
                    n_min += mag[s] <= m1;
                }
            }
            // every message is +-alpha * m1, or +-alpha * m2eff at the
            // minimum (m2eff = m1 when the minimum is duplicated)
            const float a1 = __fmul_rn(alpha, m1);
            const float a2 = __fmul_rn(alpha, n_min > 1 ? m1 : m2);
            const unsigned sgn = neg ^ ((__popc(neg) & 1u) ? 0xffu : 0u);
#pragma unroll
            for (int s = 0; s < ROW; ++s) {
                if (s < mr) {
                    float out = 0.f;
                    if (bp_half(ct, s) != BP_NONE) {
                        const float v = mag[s] == m1 ? a2 : a1;
                        out = ((sgn >> s) & 1u) ? -v : v;
                    }
                    mi[s] = out;
                }
            }
        }
        __syncwarp();
        // variable phase: the LLR plus the incoming messages in slot order
#pragma unroll
        for (int q = 0; q < BP_VARS_PER_LANE; ++q) {
            const int j = lane + 32 * q;
            if (j < n) {
                const uint2 et = etab[j];
                float inc = 0.f;
#pragma unroll
                for (int e = 0; e < COL; ++e) {
                    const unsigned off = bp_half(et, e);
                    if (off != BP_NONE)
                        inc = __fadd_rn(
                            inc, *reinterpret_cast<const float*>(msg_b + off));
                }
                tot[j] = __fadd_rn(lv[q], inc);
            }
        }
        __syncwarp();
    }

    const size_t o = static_cast<size_t>(word) * n;
#pragma unroll
    for (int q = 0; q < BP_VARS_PER_LANE; ++q) {
        const int j = lane + 32 * q;
        if (j < n) {
            const float t = tot[j];
            post[o + j] = t;
            hard[o + j] = t < 0.f;
        }
    }
    bool bad = false;
    for (int i = lane; i < nc; i += 32) {
        const uint4 ct = ctab[i];
        unsigned p = 0;
#pragma unroll
        for (int s = 0; s < ROW; ++s) {
            const unsigned off = bp_half(ct, s);
            if (off != BP_NONE)
                p ^= *reinterpret_cast<const float*>(tot_b + off) < 0.f;
        }
        bad |= p != 0;
    }
    bad = __any_sync(FULL, bad);
    if (lane == 0) ok[word] = !bad;
}

// A warp's shared memory for one word
struct OsdWarp {
    uint32_t rows[OSD_MAX_K][OSD_MAX_W];   // reduced rows, basis order
    float wts[OSD_MAX_N];                  // |LLR| in reliability order
    int16_t perm[OSD_MAX_N];               // received index of a position
    uint8_t ysgn[OSD_MAX_N];               // hard decision of a position
    uint8_t rank[OSD_MAX_K];               // basis coordinate of a row
    uint8_t pcol[OSD_MAX_K];               // pivot column of a row
    uint4 cols[OSD_MAX_N];                 // reduced columns, for the rows
};

// One pivot of the column-form elimination, the pivot row p in word PW:
// every column from slot s on whose bit p is set takes the pivot column,
// less bit p (columns before slot s are final).
template <int KW, int NW, int PW>
__device__ __forceinline__ void osd_pivot(uint32_t (&col)[NW][KW],
                                          uint32_t (&piv)[KW],
                                          uint32_t (&used)[KW], int s,
                                          uint32_t pb) {
    piv[PW] &= ~pb;
    used[PW] |= pb;
#pragma unroll
    for (int ss = 0; ss < NW; ++ss) {
        if (ss < s) continue;
        const uint32_t sel = 0u - ((col[ss][PW] & pb) != 0u);   // no branch
#pragma unroll
        for (int w = 0; w < KW; ++w) col[ss][w] ^= piv[w] & sel;
    }
}

// One warp a word, OSD_WARPS words a block; KW words a generator column (k
// <= 32 KW), NW columns a lane and words a row (n <= 32 NW).  cols [n]
// uint4: column j of the generator as a k-bit mask (bit i = row i).
template <int KW, int NW>
__global__ void __launch_bounds__(OSD_WARPS * 32)
osd_kernel(const uint4* __restrict__ cols, const float* __restrict__ llr,
           const int16_t* __restrict__ pats, int8_t* __restrict__ cw_out,
           float* __restrict__ dist_out, int32_t* __restrict__ nhard_out,
           int m, int k, int n, int n_pat) {
    __shared__ OsdWarp shared[OSD_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int word = blockIdx.x * OSD_WARPS + warp;
    if (word >= m) return;          // no block barrier follows
    OsdWarp& S = shared[warp];
    const float* l = llr + static_cast<size_t>(word) * n;

    // 1. reliability order: a bitonic sort, descending, of 64-bit keys
    //    (|LLR| bits + 1, 0 for NaN; then 511 - index; then the sign), 8
    //    a lane (position lane * 8 + i), up to the power of two >= n
    unsigned long long key[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int j = lane * 8 + i;
        key[i] = 0ull;
        if (j < n) {
            const float x = l[j];
            const float a = fabsf(x);
            const unsigned long long v =
                isnan(a) ? 0ull : __float_as_uint(a) + 1ull;
            key[i] = (v << 10) | (static_cast<unsigned>(511 - j) << 1)
                | (x < 0.f ? 1u : 0u);
        }
    }
    int n2 = 2;
    while (n2 < n) n2 <<= 1;
#pragma unroll
    for (int kk = 2; kk <= OSD_MAX_N; kk <<= 1) {
        if (kk > n2) break;
#pragma unroll
        for (int j = kk >> 1; j > 0; j >>= 1) {
            if (j >= 8) {
                const int lm = j >> 3;
                const bool upper = (lane & lm) != 0;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const bool desc = ((lane * 8 + i) & kk) == 0;
                    const unsigned long long o =
                        __shfl_xor_sync(FULL, key[i], lm);
                    key[i] = (upper != desc) ? max(key[i], o) : min(key[i], o);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (i & j) continue;
                    const bool desc = ((lane * 8 + i) & kk) == 0;
                    const unsigned long long x = key[i], y = key[i | j];
                    const bool sw = desc ? x < y : x > y;
                    key[i] = sw ? y : x;
                    key[i | j] = sw ? x : y;
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int e = lane * 8 + i;
        if (e < n) {
            const unsigned long long kv = key[i];
            const unsigned v = static_cast<unsigned>(kv >> 10);
            S.perm[e] = static_cast<int16_t>(511 - ((kv >> 1) & 511));
            S.wts[e] = v ? __uint_as_float(v - 1)
                         : __uint_as_float(0x7fc00000u);      // NaN
            S.ysgn[e] = static_cast<uint8_t>(kv & 1);
        }
    }
    __syncwarp();

    // 2. column c = lane + 32 s of the permuted generator: the code's
    //    column mask of the received position perm[c]; the hard decisions
    int perm[NW];
    uint32_t col[NW][KW], ybits[NW];
#pragma unroll
    for (int s = 0; s < NW; ++s) {
        const int c = lane + 32 * s;
        perm[s] = c < n ? S.perm[c] : 0;
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (c < n) t = __ldg(cols + perm[s]);
        const uint32_t tw[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int w = 0; w < KW; ++w) col[s][w] = tw[w];
        ybits[s] = __ballot_sync(FULL, c < n && S.ysgn[c]);
    }

    // 3. Gauss-Jordan in column form, column by column until k pivots: the
    //    owner finds the first row not yet a pivot with a set bit (none: no
    //    pivot in this column) and broadcasts it and its column; every lane
    //    XORs that column, less the pivot's bit, into its columns with the
    //    pivot's bit set.  Rows are never swapped: the reduced row echelon
    //    form is unique, so ordering the pivot rows by their column gives
    //    the rows the plain version's swaps give.  Columns before c are
    //    final (their bits in rows not yet pivots are 0).
    uint32_t used[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) used[w] = 0u;
    int r = 0;
#pragma unroll
    for (int s = 0; s < NW; ++s) {
        for (int ln = 0; ln < 32; ++ln) {
            const int c = 32 * s + ln;
            if (r >= k || c >= n) break;
            // the owner's lowest candidate row, as a one-hot mask pb in
            // word pw (-1: none), with no bit search on the chain
            int pw = -1;
            uint32_t pb = 0u;
#pragma unroll
            for (int w = KW - 1; w >= 0; --w) {
                const uint32_t cm = col[s][w] & ~used[w];
                if (cm) {
                    pw = w;
                    pb = cm & (0u - cm);
                }
            }
            pw = __shfl_sync(FULL, pw, ln);
            pb = __shfl_sync(FULL, pb, ln);
            uint32_t piv[KW];
#pragma unroll
            for (int w = 0; w < KW; ++w)
                piv[w] = __shfl_sync(FULL, col[s][w], ln);
            if (pw < 0) continue;
            if (pw == 0)
                osd_pivot<KW, NW, 0>(col, piv, used, s, pb);
            else if (KW > 1 && pw == 1)
                osd_pivot<KW, NW, (KW > 1 ? 1 : 0)>(col, piv, used, s, pb);
            else if (KW > 2 && pw == 2)
                osd_pivot<KW, NW, (KW > 2 ? 2 : 0)>(col, piv, used, s, pb);
            else if (KW > 3)
                osd_pivot<KW, NW, (KW > 3 ? 3 : 0)>(col, piv, used, s, pb);
            const int p = 32 * pw + __ffs(pb) - 1;
            if (lane == 0) {
                S.rank[p] = static_cast<uint8_t>(r);
                S.pcol[p] = static_cast<uint8_t>(c);
            }
            ++r;
        }
    }
    if (r < k && lane == 0) {       // rank deficient: zero rows, basis 0
        for (int p = 0; p < k; ++p) {
            uint32_t u = 0u;
#pragma unroll
            for (int w = 0; w < KW; ++w)
                if (w == (p >> 5)) u = used[w];
            if (!((u >> (p & 31)) & 1u)) {
                S.rank[p] = static_cast<uint8_t>(r++);
                S.pcol[p] = 0;
            }
        }
    }
    __syncwarp();

    // 4. the reduced rows in basis order, through shared memory: the
    //    columns go in, lane l takes rows l, l + 32, ... bit by bit; and
    //    the base codeword: row p contributes where the decision at its
    //    pivot column is 1, so bit j is the parity of column j's bits in
    //    those rows
#pragma unroll
    for (int s = 0; s < NW; ++s) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        uint32_t* vw = &v.x;
#pragma unroll
        for (int w = 0; w < KW; ++w) vw[w] = col[s][w];
        S.cols[lane + 32 * s] = v;
    }
    __syncwarp();
    uint32_t rw[KW][NW];
#pragma unroll
    for (int s = 0; s < NW; ++s) {
#pragma unroll
        for (int w = 0; w < KW; ++w) rw[w][s] = 0u;
#pragma unroll 8
        for (int b = 0; b < 32; ++b) {
            const uint4 v = S.cols[32 * s + b];
            const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int w = 0; w < KW; ++w)
                rw[w][s] |= ((vw[w] >> lane) & 1u) << b;
        }
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) {
        const int p = 32 * w + lane;
        if (p < k) {
            const int rr = S.rank[p];
#pragma unroll
            for (int s = 0; s < NW; ++s) S.rows[rr][s] = rw[w][s];
        }
    }
    uint32_t dmask[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) {
        const int p = 32 * w + lane;
        dmask[w] = __ballot_sync(FULL, p < k && S.ysgn[S.pcol[p]]);
    }
    uint32_t base[NW];
#pragma unroll
    for (int s = 0; s < NW; ++s) {
        int par = 0;
#pragma unroll
        for (int w = 0; w < KW; ++w) par ^= __popc(col[s][w] & dmask[w]);
        base[s] = __ballot_sync(FULL, par & 1);
    }
    __syncwarp();

    // 5. each flip pattern's codeword (the base XOR <= 3 rows), its soft
    //    distance (the weights of the bits where it differs from the hard
    //    decisions, summed with __fadd_rn in ascending bit order) and the
    //    arg-min: the first pattern on a tie.  A lane takes OSD_PATS
    //    patterns at once, word by word: a word's 32 weights once in
    //    registers, then bit by bit an add for each pattern, of +0 where
    //    the bits agree (which leaves the sum as it is: no branch, no
    //    predicate), the patterns' chains side by side.
    auto encode = [&](const int (&idx)[OSD_MAX_FLIPS], uint32_t (&cw)[NW]) {
#pragma unroll
        for (int s = 0; s < NW; ++s) cw[s] = base[s];
#pragma unroll
        for (int q = 0; q < OSD_MAX_FLIPS; ++q) {
            const int row = idx[q] >= 0 ? idx[q] : 0;
            const uint32_t use = idx[q] >= 0 ? ~0u : 0u;
#pragma unroll
            for (int s = 0; s < NW; ++s) cw[s] ^= S.rows[row][s] & use;
        }
    };
    auto pattern = [&](int t, int (&idx)[OSD_MAX_FLIPS]) {
#pragma unroll
        for (int q = 0; q < OSD_MAX_FLIPS; ++q)
            idx[q] = pats[t * OSD_MAX_FLIPS + q];
    };
    float bd = INFINITY;
    int bt = 0x7fffffff, bn = 0;
    for (int t0 = 0; t0 < n_pat; t0 += 32 * OSD_PATS) {
        int idx[OSD_PATS][OSD_MAX_FLIPS];    // all the chunk's loads first
#pragma unroll
        for (int i = 0; i < OSD_PATS; ++i) {
            const int t = t0 + 32 * i + lane;
            pattern(t < n_pat ? t : 0, idx[i]);
        }
        uint32_t mis[OSD_PATS][NW];
        float dist[OSD_PATS];
        int cnt[OSD_PATS];
#pragma unroll
        for (int i = 0; i < OSD_PATS; ++i) {
            uint32_t cw[NW];
            encode(idx[i], cw);
            dist[i] = 0.f;
            cnt[i] = 0;
#pragma unroll
            for (int s = 0; s < NW; ++s) {
                mis[i][s] = cw[s] ^ ybits[s];
                cnt[i] += __popc(mis[i][s]);
            }
        }
#pragma unroll
        for (int s = 0; s < NW; ++s) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {      // 8 weights at a time
                const float4* w4 = reinterpret_cast<const float4*>(
                    S.wts + 32 * s + 8 * h);
                const float4 lo = w4[0], hi = w4[1];
                const float w[8] = {lo.x, lo.y, lo.z, lo.w,
                                    hi.x, hi.y, hi.z, hi.w};
#pragma unroll
                for (int b = 0; b < 8; ++b) {
#pragma unroll
                    for (int i = 0; i < OSD_PATS; ++i) {
                        const uint32_t m =
                            0u - ((mis[i][s] >> (8 * h + b)) & 1u);
                        dist[i] = __fadd_rn(
                            dist[i],
                            __uint_as_float(__float_as_uint(w[b]) & m));
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < OSD_PATS; ++i) {
            const int t = t0 + 32 * i + lane;
            if (t < n_pat && dist[i] < bd) {
                bd = dist[i];
                bt = t;
                bn = cnt[i];
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(FULL, bd, off);
        const int ot = __shfl_xor_sync(FULL, bt, off);
        const int on = __shfl_xor_sync(FULL, bn, off);
        if (od < bd || (od == bd && ot < bt)) {
            bd = od;
            bt = ot;
            bn = on;
        }
    }
    uint32_t cw[NW];
    int idx[OSD_MAX_FLIPS];
    if (bt >= n_pat) {              // every distance NaN: pattern 0
        bt = 0;
        pattern(0, idx);
        encode(idx, cw);
        bd = 0.f;
        bn = 0;
#pragma unroll
        for (int s = 0; s < NW; ++s) {
            uint32_t mis = cw[s] ^ ybits[s];
            bn += __popc(mis);
            while (mis) {
                bd = __fadd_rn(bd, S.wts[32 * s + __ffs(mis) - 1]);
                mis &= mis - 1;
            }
        }
    } else {
        pattern(bt, idx);
        encode(idx, cw);
    }

    // 6. the chosen codeword back in the received bit order
    const size_t o = static_cast<size_t>(word) * n;
#pragma unroll
    for (int s = 0; s < NW; ++s) {
        const int c = lane + 32 * s;
        if (c < n)
            cw_out[o + perm[s]] = static_cast<int8_t>((cw[s] >> lane) & 1u);
    }
    if (lane == 0) {
        dist_out[word] = bd;
        nhard_out[word] = bn;
    }
}

template <int MR, int MC>
cudaError_t bp_minsum_start(int smem, cudaStream_t st, const void* llr,
                            const void* row_cols, const void* col_slots,
                            void* hard, void* ok, void* post, int m, int n,
                            int nc, int mr, int mc, int iters, float alpha) {
    bp_minsum_kernel<MR, MC>
        <<<(m + BP_WARPS - 1) / BP_WARPS, BP_WARPS * 32, smem, st>>>(
            static_cast<const float*>(llr),
            static_cast<const int16_t*>(row_cols),
            static_cast<const int16_t*>(col_slots),
            static_cast<int8_t*>(hard), static_cast<uint8_t*>(ok),
            static_cast<float*>(post), m, n, nc, mr, mc, iters, alpha);
    return cudaGetLastError();
}

template <int KW, int NW>
cudaError_t osd_start(cudaStream_t st, const void* cols, const void* llr,
                      const void* pats, void* cw, void* dist, void* nhard,
                      int m, int k, int n, int n_pat) {
    osd_kernel<KW, NW><<<(m + OSD_WARPS - 1) / OSD_WARPS, OSD_WARPS * 32, 0,
                         st>>>(
        static_cast<const uint4*>(cols), static_cast<const float*>(llr),
        static_cast<const int16_t*>(pats), static_cast<int8_t*>(cw),
        static_cast<float*>(dist), static_cast<int32_t*>(nhard), m, k, n,
        n_pat);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int bp_minsum_max_row() { return BP_MAX_ROW; }
int bp_minsum_max_col() { return BP_MAX_COL; }
int bp_minsum_max_n() { return BP_MAX_N; }
int bp_minsum_max_checks() { return BP_MAX_CHECKS; }
int osd_max_k() { return OSD_MAX_K; }
int osd_max_n() { return OSD_MAX_N; }
int osd_max_flips() { return OSD_MAX_FLIPS; }

// Shared memory of one bp_minsum block, in bytes (under 48 KB for every
// code within the limits, so no attribute is needed).
int bp_minsum_smem_bytes(int n, int nc, int mr, int mc) {
    (void)mc;
    return bp_table_bytes(n, nc) + BP_WARPS * bp_word_bytes(n, nc, mr);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// row_cols [nc, mr] int16 (n in a padded slot), col_slots [n, mc] int16
// (flat slot index, -1 padded), llr [m, n] float32; hard [m, n] int8,
// ok [m] bool, post [m, n] float32.  The loops are unrolled for the
// codes' degrees: (7, 3) for FT8/FT4, (6, 3) for JS8 and FST4/FST4W.
int bp_minsum_launch(const void* llr, const void* row_cols,
                     const void* col_slots, void* hard, void* ok, void* post,
                     int m, int n, int nc, int mr, int mc, int iters,
                     float alpha, void* stream) {
    if (m < 1 || n < 1 || n > BP_MAX_N || nc < 1 || nc > BP_MAX_CHECKS
        || mr < 1 || mr > BP_MAX_ROW || mc < 1 || mc > BP_MAX_COL
        || iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = bp_minsum_smem_bytes(n, nc, mr, mc);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (mr == 7 && mc == 3)
        err = bp_minsum_start<7, 3>(smem, st, llr, row_cols, col_slots, hard,
                                    ok, post, m, n, nc, mr, mc, iters, alpha);
    else if (mr == 6 && mc == 3)
        err = bp_minsum_start<6, 3>(smem, st, llr, row_cols, col_slots, hard,
                                    ok, post, m, n, nc, mr, mc, iters, alpha);
    else
        err = bp_minsum_start<0, 0>(smem, st, llr, row_cols, col_slots, hard,
                                    ok, post, m, n, nc, mr, mc, iters, alpha);
    return static_cast<int>(err);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// cols [n, 4] int32: generator column j as a k-bit mask (bit i of word
// i >> 5 = row i), llr [m, n] float32, pats [n_pat, 3] int16 row indices
// (-1 padded); cw [m, n] int8, dist [m] float32, nhard [m] int32.
// Instantiated for the codes' column and row words: (3, 6) for FT8/FT4 and
// JS8, (2, 6) for WSPR, (4, 8) for FST4/FST4W and any other.
int osd_launch(const void* cols, const void* llr, const void* pats, void* cw,
               void* dist, void* nhard, int m, int k, int n, int n_pat,
               void* stream) {
    if (m < 1 || k < 1 || k > OSD_MAX_K || n < k || n > OSD_MAX_N
        || n_pat < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int kw = (k + 31) / 32, nw = (n + 31) / 32;
    cudaError_t err;
    if (kw == 3 && nw == 6)
        err = osd_start<3, 6>(st, cols, llr, pats, cw, dist, nhard, m, k, n,
                              n_pat);
    else if (kw <= 2 && nw == 6)
        err = osd_start<2, 6>(st, cols, llr, pats, cw, dist, nhard, m, k, n,
                              n_pat);
    else
        err = osd_start<4, 8>(st, cols, llr, pats, cw, dist, nhard, m, k, n,
                              n_pat);
    return static_cast<int>(err);
}

}  // extern "C"
