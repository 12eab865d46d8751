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
// ~36 sort steps and ~100 elimination columns), so what they cost is
// latency per step times the number of steps, and keeping the whole chain
// on chip.  What holds BP back on this card is the instructions it
// issues, not its shared-memory traffic: on the H100, packing its tables
// (a fifth fewer shared-memory wavefronts) left its time as it was, while
// unrolling its loops for the code's degrees made it faster; and keeping
// each check's messages in min-sum's compressed form (alpha * m1,
// alpha * m2eff, the signs, the minimum's slot), with the tables in
// registers or in shared memory, made it slower: rebuilding every message
// in the variable phase costs more instructions than the loads it saves,
// and the register tables cost occupancy.  The design:
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
//   - osd: one block of 128 threads per word, one generator row per
//     thread (k <= 128), kept in registers as <= 8 packed 32-bit words.  A
//     bitonic sort of 64-bit keys (|LLR| bits descending, then index) gives
//     the stable reliability order; warp ballots pack the permuted
//     generator and the received hard decisions; the elimination finds
//     each column's first pivot row at or below r by ballot, broadcasts the
//     pivot row through shared memory and XORs it into the rows with that
//     bit set, two barriers a pivot column, and stops at r = k for each word
//     on its own.  A flip pattern's codeword is the base codeword (rows
//     whose basis decision is 1) XOR its <= 3 rows; its soft distance sums
//     the weights of the mismatched bits, and the arg-min takes the first
//     pattern on a tie, as torch.argmin does.
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

constexpr int OSD_THREADS = 128;     // one generator row per thread
constexpr int OSD_WARPS = OSD_THREADS / 32;
constexpr int OSD_MAX_K = OSD_THREADS;
constexpr int OSD_MAX_N = 2 * OSD_THREADS;   // one compare pair per thread
constexpr int OSD_MAX_W = OSD_MAX_N / 32;    // packed words per row
constexpr int OSD_MAX_FLIPS = 3;             // rows per flip pattern
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

// v[i] for a runtime i < OSD_MAX_W, without a local-memory array
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[OSD_MAX_W],
                                         int i) {
    uint32_t r = 0;
#pragma unroll
    for (int w = 0; w < OSD_MAX_W; ++w)
        if (w == i) r = v[w];
    return r;
}

__global__ void __launch_bounds__(OSD_THREADS)
osd_kernel(const uint8_t* __restrict__ gen, const float* __restrict__ llr,
           const int16_t* __restrict__ pats, int8_t* __restrict__ cw_out,
           float* __restrict__ dist_out, int32_t* __restrict__ nhard_out,
           int k, int n, int n_pat) {
    __shared__ unsigned long long key[OSD_MAX_N];
    __shared__ int perm[OSD_MAX_N];
    __shared__ float wts[OSD_MAX_N];
    __shared__ uint32_t rows[OSD_MAX_K][OSD_MAX_W];
    __shared__ uint32_t ybits[OSD_MAX_W];
    __shared__ uint32_t ballots[2][OSD_WARPS];
    __shared__ uint32_t pivot[OSD_MAX_W], displaced[OSD_MAX_W];
    __shared__ uint32_t part[OSD_WARPS][OSD_MAX_W];
    __shared__ float best_d[OSD_WARPS];
    __shared__ int best_t[OSD_WARPS];

    const int word = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int nw = (n + 31) >> 5;
    const float* l = llr + static_cast<size_t>(word) * n;

    // 1. stable sort by |LLR|, most reliable first: ascending keys of the
    //    inverted |LLR| bits (NaN last, as torch sorts it) over the index
    for (int j = tid; j < OSD_MAX_N; j += OSD_THREADS) {
        unsigned long long kk = ~0ull;
        if (j < n) {
            const float a = fabsf(l[j]);
            const uint32_t inv = ~__float_as_uint(a);
            const unsigned long long hi =
                isnan(a) ? 0x100000000ull : static_cast<unsigned long long>(inv);
            kk = (hi << 9) | static_cast<unsigned>(j);
        }
        key[j] = kk;
    }
    __syncthreads();
    for (int size = 2; size <= OSD_MAX_N; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const int i = 2 * tid - (tid & (stride - 1));
            const int j = i + stride;
            const unsigned long long a = key[i], b = key[j];
            if ((a > b) == ((i & size) == 0)) {
                key[i] = b;
                key[j] = a;
            }
            __syncthreads();
        }
    }
    for (int j = tid; j < n; j += OSD_THREADS) {
        const int p = static_cast<int>(key[j] & 511u);
        perm[j] = p;
        wts[j] = fabsf(l[p]);
    }
    __syncthreads();

    // 2. the generator's columns and the hard decisions in that order,
    //    column c at bit c & 31 of word c >> 5
    for (int p = warp; p < k * nw; p += OSD_WARPS) {
        const int i = p / nw, w = p - i * nw;
        const int c = 32 * w + lane;
        const bool bit = c < n && gen[static_cast<size_t>(i) * n + perm[c]];
        const uint32_t b = __ballot_sync(FULL, bit);
        if (lane == 0) rows[i][w] = b;
    }
    for (int w = warp; w < nw; w += OSD_WARPS) {
        const int c = 32 * w + lane;
        const uint32_t b = __ballot_sync(FULL, c < n && l[perm[c]] < 0.f);
        if (lane == 0) ybits[w] = b;
    }
    __syncthreads();
    uint32_t row[OSD_MAX_W];
#pragma unroll
    for (int w = 0; w < OSD_MAX_W; ++w)
        row[w] = (tid < k && w < nw) ? rows[tid][w] : 0u;

    // 3. GF(2) elimination until k pivots (every thread sees the same r)
    int r = 0;
    for (int c = 0; c < n && r < k; ++c) {
        const int wi = c >> 5, bit = c & 31;
        const bool cand = tid >= r && ((pick(row, wi) >> bit) & 1u);
        const uint32_t b = __ballot_sync(FULL, cand);
        if (lane == 0) ballots[c & 1][warp] = b;
        __syncthreads();
        int p = -1;
#pragma unroll
        for (int q = 0; q < OSD_WARPS; ++q) {
            const uint32_t bq = ballots[c & 1][q];
            if (p < 0 && bq) p = 32 * q + __ffs(bq) - 1;
        }
        if (p < 0) continue;        // no pivot in this column
        if (tid == p) {
#pragma unroll
            for (int w = 0; w < OSD_MAX_W; ++w) pivot[w] = row[w];
        } else if (tid == r) {
#pragma unroll
            for (int w = 0; w < OSD_MAX_W; ++w) displaced[w] = row[w];
        }
        __syncthreads();
        if (tid == r) {
#pragma unroll
            for (int w = 0; w < OSD_MAX_W; ++w) row[w] = pivot[w];
        } else {
            if (tid == p) {
#pragma unroll
                for (int w = 0; w < OSD_MAX_W; ++w) row[w] = displaced[w];
            }
            if ((pick(row, wi) >> bit) & 1u) {
#pragma unroll
                for (int w = 0; w < OSD_MAX_W; ++w) row[w] ^= pivot[w];
            }
        }
        ++r;
    }

    // 4. a row's basis coordinate is its first set bit (0 for a zero row);
    //    the base codeword is the XOR of the rows whose decision there is 1
    int basis = 0;
    bool found = false;
#pragma unroll
    for (int w = 0; w < OSD_MAX_W; ++w) {
        if (!found && row[w]) {
            basis = 32 * w + __ffs(row[w]) - 1;
            found = true;
        }
    }
    const bool d = tid < k && ((ybits[basis >> 5] >> (basis & 31)) & 1u);
    __syncthreads();
    if (tid < k) {
#pragma unroll
        for (int w = 0; w < OSD_MAX_W; ++w)
            if (w < nw) rows[tid][w] = row[w];
    }
    uint32_t acc[OSD_MAX_W];
#pragma unroll
    for (int w = 0; w < OSD_MAX_W; ++w) {
        acc[w] = d ? row[w] : 0u;
        for (int off = 16; off > 0; off >>= 1)
            acc[w] ^= __shfl_xor_sync(FULL, acc[w], off);
    }
    if (lane == 0) {
#pragma unroll
        for (int w = 0; w < OSD_MAX_W; ++w) part[warp][w] = acc[w];
    }
    __syncthreads();
    uint32_t base[OSD_MAX_W];
#pragma unroll
    for (int w = 0; w < OSD_MAX_W; ++w) {
        base[w] = 0u;
        for (int q = 0; q < OSD_WARPS; ++q) base[w] ^= part[q][w];
    }

    // 5. each flip pattern's codeword, soft distance and the arg-min
    auto encode = [&](int t, uint32_t (&cw)[OSD_MAX_W]) {
#pragma unroll
        for (int w = 0; w < OSD_MAX_W; ++w) cw[w] = base[w];
        for (int q = 0; q < OSD_MAX_FLIPS; ++q) {
            const int idx = pats[t * OSD_MAX_FLIPS + q];
            if (idx >= 0) {
#pragma unroll
                for (int w = 0; w < OSD_MAX_W; ++w)
                    if (w < nw) cw[w] ^= rows[idx][w];
            }
        }
    };
    auto distance = [&](const uint32_t (&cw)[OSD_MAX_W], int* nh) {
        float dist = 0.f;
        int cnt = 0;
#pragma unroll
        for (int w = 0; w < OSD_MAX_W; ++w) {
            if (w < nw) {
                uint32_t mis = cw[w] ^ ybits[w];
                cnt += __popc(mis);
                while (mis) {
                    dist = __fadd_rn(dist, wts[32 * w + __ffs(mis) - 1]);
                    mis &= mis - 1;
                }
            }
        }
        *nh = cnt;
        return dist;
    };
    float bd = INFINITY;
    int bt = 0x7fffffff;
    for (int t = tid; t < n_pat; t += OSD_THREADS) {
        uint32_t cw[OSD_MAX_W];
        encode(t, cw);
        int nh;
        const float dist = distance(cw, &nh);
        if (dist < bd) {
            bd = dist;
            bt = t;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(FULL, bd, off);
        const int ot = __shfl_xor_sync(FULL, bt, off);
        if (od < bd || (od == bd && ot < bt)) {
            bd = od;
            bt = ot;
        }
    }
    if (lane == 0) {
        best_d[warp] = bd;
        best_t[warp] = bt;
    }
    __syncthreads();
    bd = best_d[0];
    bt = best_t[0];
    for (int q = 1; q < OSD_WARPS; ++q) {
        if (best_d[q] < bd || (best_d[q] == bd && best_t[q] < bt)) {
            bd = best_d[q];
            bt = best_t[q];
        }
    }
    if (bt >= n_pat) bt = 0;        // every distance NaN

    // 6. the chosen codeword back in the received bit order
    uint32_t cw[OSD_MAX_W];
    encode(bt, cw);
    const size_t o = static_cast<size_t>(word) * n;
    for (int j = tid; j < n; j += OSD_THREADS)
        cw_out[o + perm[j]] = static_cast<int8_t>((pick(cw, j >> 5) >> (j & 31)) & 1u);
    if (tid == 0) {
        int nh;
        dist_out[word] = distance(cw, &nh);
        nhard_out[word] = nh;
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
// gen [k, n] uint8 0/1, llr [m, n] float32, pats [n_pat, 3] int16 row
// indices (-1 padded); cw [m, n] int8, dist [m] float32, nhard [m] int32.
int osd_launch(const void* gen, const void* llr, const void* pats, void* cw,
               void* dist, void* nhard, int m, int k, int n, int n_pat,
               void* stream) {
    if (m < 1 || k < 1 || k > OSD_MAX_K || n < 1 || n > OSD_MAX_N
        || n_pat < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    osd_kernel<<<m, OSD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(gen), static_cast<const float*>(llr),
        static_cast<const int16_t*>(pats), static_cast<int8_t*>(cw),
        static_cast<float*>(dist), static_cast<int32_t*>(nhard), k, n, n_pat);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
