// JT65's Chase program around the errors-and-erasures RS decode (rs_ee,
// csrc/weak.cu): the trials' erasure flags (chase_erasures) and the soft
// re-encode score with the best trial of each candidate (chase_score), each
// one launch with no host sync.
//
// They replace the XLA program cwsl_digi_tpu/modes/rs_device.py:231-301
// (rs_chase_program) but its RS decode: the confidence rank (:245), the key
// and the stochastic patterns (:254-262), the score (:274-291) and the
// selection (:293-301).  Their plain versions are
// modes/rs_device.py:chase_erasures_plain and chase_score_plain: a stable
// argsort and a scatter for the rank, ~100 int64 element-wise launches of
// Threefry-2x32 over [C, 250, 63] tensors, and a [C, T, 63, 4] hit tensor
// with a dozen reductions for the score.
//
// What bounds them on an H100.
//
//   - chase_erasures writes C x T x n flags (24.8 MB at the App's 64 JT65
//     windows: 1,536 candidates x 256 trials x 63 symbols, 0.007 ms) and
//     hashes each stochastic element's 64-bit index with Threefry-2x32: 20
//     rounds of an add, a rotate and a xor, 5 key injections, ~85 integer
//     operations, ~2.1e9 at that shape.  The rotates and xors (~43 a flag)
//     issue only on an SM's 64 INT32 lanes, while an add may also issue as
//     IMAD on its 128 FP32 lanes: ~0.06 ms at that shape, operations bound
//     it.
//   - chase_score reads the corrected words and the flags (C x T x n bytes
//     each: 33 MB at a 1,024-candidate chunk of 256 trials, 0.011 ms with
//     the candidates' top-4 rows) and writes a word a candidate; its work,
//     a lookup and three adds a symbol and trial, is ~0.004 ms at the FP32
//     rate: bytes bound it.
//
// The design.
//
//   - chase_erasures: a block of 8 warps a candidate.  The block ranks its
//     row (a thread a symbol counts the symbols before it in the stable
//     ascending order: order key, NaN last, -0.0 equal to 0.0, then
//     position), looks up each symbol's weight base_p[rank] (the host's
//     table), sums the weights in the windows of 32 of the plain version
//     (one thread, in order), and divides each trial's depth by the sum;
//     another thread folds the seed into the key (Threefry-2x32 of (0,
//     seed) under (0, 17)).  Then warp w takes trials w, w + 8, ..., lane l
//     symbols l and l + 32: a deterministic trial compares the rank with its tier, a
//     stochastic one hashes its element's index in the whole [C_all, n_sto,
//     n] draw (the call's first candidate c0 shifts it), takes the top 23
//     bits as a float in [1, 2) minus 1 and compares it with base_p[rank] x
//     (depth / sum), the plain version's float operations: the flags are
//     bit for bit the plain version's, which are the JAX package's.
//   - chase_score: a block of 4 warps a candidate, four lanes a trial
//     (lane q its symbols 16 q .. 16 q + 15), 32 trials a stage.  Thread 0
//     starts the TMA unit's 1-D bulk copies of the first two stages' words
//     and flags into a ring of two slots in shared memory, each slot
//     completing on its mbarrier, before the block's prologue: each
//     symbol's five possible terms log((E + 1e-30) / (e_sum / n + 1e-30)),
//     E one of the top-4 energies or the residual floor, computed once with
//     logf, and its table of 64 terms, one for each corrected value below
//     64 (the first of its tones equal to it, else the floor), so a
//     symbol's term is one shared load; a value of 64 or more takes the
//     tone bytes' compare (a word a symbol, its four tones as bytes, a tone
//     outside [0, 255] replaced by the first inside one).  At each stage a
//     lane reads its five words of corrected symbols and of flags, the
//     block's barrier frees the slot, thread 0 starts the copy of the stage
//     two on into it, and the lanes score while it flies: the words funnel
//     shifted into place and cut at n, four partial sums a lane, the
//     erasures counted four flags a popc, the quad's sums by
//     __shfl_xor_sync (the plain version sums in another order: the score
//     agrees within rounding).  Each lane keeps its best passing trial (the
//     larger score, NaN the largest, the lower trial on ties), the warp
//     merges its quads' and warp 0 the warps', and the block writes the
//     best trial's info symbols, score and flag.  Where a candidate's T x n
//     bytes or the bases are not 16-byte aligned, the block copies the
//     stages byte by byte into the same ring.  26,560 B of dynamic shared
//     memory (the ring 8,384, the tables 18,176) and 56 registers: 8 blocks
//     an SM, a 1,024-candidate chunk in one wave.
//
// On an H100 80GB HBM3 at 700 W (tools/qary_chase_profile.py, in turns
// with the first port): chase_score 0.02324-0.02347 ms at a 1,024-candidate
// chunk of the App's JT65 decode (the first port 0.0591-0.0606), 47 % of
// the byte bound, 0.01492-0.01539 at the 512 chunk (0.0330-0.0334);
// without the symbols' work it takes 0.0142-0.0143, so the copies and the
// scoring barely overlap: a block's eight stages run one after another,
// and the table's loads conflict in the banks where trials' values differ
// (one table entry a symbol: 0.0204-0.0206).  Rings of 3 and 4 slots
// (more shared memory, so fewer blocks an SM than the chunk's 1,024 need
// for one wave) took 0.0271-0.0290, and as long as 2 slots at the 512
// chunk.  chase_erasures 0.0787 ms (the plain version 23.3 ms;
// chip_smoke.py, phase qary_decode_kernels), 30 registers, 4,908 B of
// shared memory.  The flags are the plain version's bit for bit, the
// score's info and ok identical, its score within 4.8e-7.
//
// Built with --fmad=false and without fast math (IEEE divisions, logf),
// so the products and divisions are the IEEE float operations written
// here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHASE_WARPS = 8;
constexpr int CHASE_THREADS = CHASE_WARPS * 32;
constexpr int CHASE_N_MAX = 64;          // symbols a word
constexpr int CHASE_T_MAX = 1024;        // trials a candidate
constexpr int CHASE_DET_MAX = 8;         // deterministic trials
constexpr int CHASE_SUM_WINDOW = 32;     // the weights' row sum's window
constexpr int CHASE_Q = 64;              // GF(64): tones a symbol
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;
constexpr float TINY = 1e-30f;

struct EraDims {
    int C, T, n, n_det;
    long long c0;                        // the call's first candidate
    int tiers[CHASE_DET_MAX];
};

struct ScoreDims {
    int C, T, n, k;
    float accept, gate;                  // gate: 0.6 accept
    int bulk;         // slabs 16-byte aligned: stage them by the TMA unit
};

// The ascending order of float32 as uint32: -0.0 read as 0.0, every NaN
// above +inf.
__device__ __forceinline__ uint32_t order_key(float x) {
    if (x != x) return 0xffffffffu;
    const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
    return __funnelshift_l(x, x, d);
}

// Threefry-2x32's rotation j of round group g (even groups, odd groups).
__host__ __device__ constexpr int rotation(int g, int j) {
    return g % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                      : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// Threefry-2x32 (20 rounds) of the counter (x0, x1) under the key (k0, k1),
// as modes/threefry.py:threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ KS_PARITY};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rotation(i, j)) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
}

// ---------------------------------------------------------------------------
// chase_erasures

// A block a candidate: margin [C, n] float32, seed (one int64, its low 32
// bits folded in), base_p [n] and depth [T - n_det] float32 -> era [C, T,
// n] uint8.
__global__ void __launch_bounds__(CHASE_THREADS)
k_chase_erasures(const float* __restrict__ margin,
                 const int64_t* __restrict__ seed,
                 const float* __restrict__ base_p,
                 const float* __restrict__ depth, EraDims d,
                 uint8_t* __restrict__ era) {
    __shared__ uint32_t key_s[CHASE_N_MAX];
    __shared__ int rank_s[CHASE_N_MAX];
    __shared__ float p_s[CHASE_N_MAX];
    __shared__ float ratio_s[CHASE_T_MAX];
    __shared__ int tier_s[CHASE_DET_MAX];
    __shared__ uint32_t fold_s[2];
    __shared__ float sum_s;
    const int c = blockIdx.x, tid = threadIdx.x;
    const int n = d.n, n_sto = d.T - d.n_det;
    if (tid < n) key_s[tid] = order_key(margin[static_cast<long long>(c) * n
                                               + tid]);
    // (the tiers through shared memory: a parameter array indexed at run
    // time would copy the parameters to local memory)
#pragma unroll
    for (int i = 0; i < CHASE_DET_MAX; ++i)
        if (tid == i) tier_s[i] = d.tiers[i];
    if (tid == CHASE_THREADS - 1) {
        // fold_in(PRNGKey(17), seed): the block of (0, seed) under (0, 17)
        uint32_t x0 = 0u, x1 = static_cast<uint32_t>(
            static_cast<unsigned long long>(seed[0]) & 0xffffffffull);
        threefry2x32(0u, 17u, x0, x1);
        fold_s[0] = x0;
        fold_s[1] = x1;
    }
    __syncthreads();
    if (tid < n) {
        const uint32_t mine = key_s[tid];
        int r = 0;
        for (int j = 0; j < n; ++j) {
            const uint32_t kj = key_s[j];
            r += kj < mine || (kj == mine && j < tid);
        }
        rank_s[tid] = r;
        p_s[tid] = base_p[r];
    }
    __syncthreads();
    if (tid == 0) {
        float total = 0.0f;
        for (int w0 = 0; w0 < n; w0 += CHASE_SUM_WINDOW) {
            float acc = p_s[w0];
            const int end = w0 + CHASE_SUM_WINDOW < n ? w0 + CHASE_SUM_WINDOW
                                                      : n;
            for (int i = w0 + 1; i < end; ++i) acc += p_s[i];
            total = w0 == 0 ? acc : total + acc;
        }
        sum_s = total;
    }
    __syncthreads();
    for (int s = tid; s < n_sto; s += CHASE_THREADS)
        ratio_s[s] = depth[s] / sum_s;
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    const uint32_t k0 = fold_s[0], k1 = fold_s[1];
    uint8_t* out = era + static_cast<long long>(c) * d.T * n;
    // element (c0 + c, s, i) of the [C_all, n_sto, n] draw
    const unsigned long long row0 =
        static_cast<unsigned long long>(d.c0 + c) * n_sto * n;
    for (int t = warp; t < d.T; t += CHASE_WARPS) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = lane + 32 * half;
            if (i >= n) continue;
            bool flag;
            if (t < d.n_det) {
                flag = rank_s[i] < tier_s[t];
            } else {
                const int s = t - d.n_det;
                const unsigned long long idx =
                    row0 + static_cast<unsigned long long>(s) * n + i;
                uint32_t x0 = static_cast<uint32_t>(idx >> 32);
                uint32_t x1 = static_cast<uint32_t>(idx);
                threefry2x32(k0, k1, x0, x1);
                const float u =
                    __uint_as_float(((x0 ^ x1) >> 9) | 0x3f800000u) - 1.0f;
                flag = u < p_s[i] * ratio_s[s];
            }
            out[t * n + i] = flag;
        }
    }
}

// ---------------------------------------------------------------------------
// chase_score

constexpr int SC_WARPS = 4;
constexpr int SC_THREADS = SC_WARPS * 32;
constexpr int SC_LANES = 4;                      // lanes a trial
constexpr int SC_SPAN = CHASE_N_MAX / SC_LANES;  // symbols a lane
constexpr int SC_STAGE = SC_THREADS / SC_LANES;  // trials a stage
constexpr int SC_RING = 2;                       // stages in flight
constexpr int SC_MIN_BLOCKS = 8;                 // blocks an SM at least
// bytes past a stage's words that its last lane's word loads may reach
constexpr int SC_READ_PAD = (SC_LANES - 1) * SC_SPAN + 4 * (SC_SPAN / 4 + 1);
constexpr int SC_LUT = 65;       // a symbol's term for each corrected value
                                 // below 64, and a pad (banks)
constexpr int SC_ROW = 6;        // a symbol's row: the floor's term, 4 hit
                                 // terms, its tones as bytes

// A slot's bytes for each of the corrected words and the erasure flags.
__host__ __device__ constexpr int sc_slot_bytes(int n) {
    return (SC_STAGE * n + SC_READ_PAD + 15) / 16 * 16;
}

// The dynamic shared memory of a block: SC_RING slots of both, then the
// symbols' term tables and rows.
__host__ __device__ constexpr int sc_smem_bytes(int n) {
    return SC_RING * 2 * sc_slot_bytes(n)
        + CHASE_N_MAX * (SC_LUT + SC_ROW) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                     : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory by the TMA unit, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                    "r"(smem_u32(bar)) : "memory");
}

// The better of two (score, trial) pairs: the larger score, NaN the
// largest, the lower trial on ties (torch.argmax, jnp.argmax).
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
    const bool na = a != a, nb = b != b;
    if (na || nb) return na && (!nb || ia < ib);
    return a > b || (a == b && ia < ib);
}

// The term of symbol i (table row `row`) for a corrected value c of 64 or
// more: the first of its four tone bytes equal to c, the lowest zero byte
// of the xor (bit 7 in z); __ffs(z) / 8 is 0 where none is (the floor's
// term), else 1 + the tone's place.
__device__ __forceinline__ float sc_term_slow(const float* row, uint32_t c) {
    const uint32_t x = __float_as_uint(row[5]) ^ (c * 0x01010101u);
    const uint32_t z = (x - 0x01010101u) & ~x & 0x80808080u;
    return row[__ffs(static_cast<int>(z)) >> 3];
}

// A block of SC_WARPS warps a candidate: corrected [C, T, n] uint8, ok [C,
// T] uint8, era [C, T, n] uint8, top_e [C, n, 4] float32, top_tone [C, n,
// 4] int64, e_sum [C, n] float32 -> info [C, k] int64, best_score [C]
// float32, best_ok [C] uint8, best_trial [C] int64.  Four lanes a trial,
// lane q its symbols 16 q .. 16 q + 15, SC_STAGE trials a stage; the
// stages' words and flags come through a ring of SC_RING slots in shared
// memory (d.bulk: copies by the TMA unit, issued by thread 0, completing
// on an mbarrier a slot; else the block's byte copies).  A symbol's term
// is one shared load from its row of 64 terms, one for each corrected
// value below 64 (the plain version's first matching tone, else the
// floor); a value of 64 or more takes the tone bytes' compare.
__global__ void __launch_bounds__(SC_THREADS, SC_MIN_BLOCKS)
k_chase_score(const uint8_t* __restrict__ corrected,
              const uint8_t* __restrict__ ok, const uint8_t* __restrict__ era,
              const float* __restrict__ top_e,
              const int64_t* __restrict__ top_tone,
              const float* __restrict__ e_sum, ScoreDims d,
              int64_t* __restrict__ info, float* __restrict__ best_score,
              uint8_t* __restrict__ best_ok,
              int64_t* __restrict__ best_trial) {
    extern __shared__ __align__(16) unsigned char ring_s[];
    __shared__ __align__(8) uint64_t bar_s[SC_RING];
    __shared__ float wbest_s[SC_WARPS];
    __shared__ int wtrial_s[SC_WARPS];
    __shared__ int best_s;
    __shared__ float bscore_s;
    const int c = blockIdx.x, tid = threadIdx.x, n = d.n, T = d.T;
    const int slot_b = sc_slot_bytes(n);
    float* lut_s = reinterpret_cast<float*>(ring_s + SC_RING * 2 * slot_b);
    float* row_s = lut_s + CHASE_N_MAX * SC_LUT;
    const int stages = (T + SC_STAGE - 1) / SC_STAGE;
    const long long cand0 = static_cast<long long>(c) * T;
    const uint8_t* cw_c = corrected + cand0 * n;
    const uint8_t* er_c = era + cand0 * n;
    if (d.bulk && tid == 0) {
#pragma unroll
        for (int r = 0; r < SC_RING; ++r) mbar_init(&bar_s[r], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int s = 0; s < SC_RING && s < stages; ++s) {
            const int t1 = SC_STAGE * (s + 1) < T ? SC_STAGE * (s + 1) : T;
            const int bytes = (t1 - SC_STAGE * s) * n;
            const long long at = static_cast<long long>(SC_STAGE) * s * n;
            unsigned char* slot = ring_s + 2 * slot_b * s;
            mbar_expect_tx(&bar_s[s], 2 * bytes);
            bulk_copy(slot, cw_c + at, bytes, &bar_s[s]);
            bulk_copy(slot + slot_b, er_c + at, bytes, &bar_s[s]);
        }
    }
    const int warp = tid >> 5, lane = tid & 31;
    const int q = lane & (SC_LANES - 1);
    const int local = tid / SC_LANES;            // the lane's trial in a stage
    // bit s: the RS decode's flag of the lane's trial in stage s
    // (stages <= CHASE_T_MAX / SC_STAGE = 32)
    uint32_t ok_bits = 0u;
    for (int s = 0; s < stages; ++s) {
        const int t = SC_STAGE * s + local;
        if (t < T && ok[cand0 + t] != 0) ok_bits |= 1u << s;
    }
    // each symbol's row and term table, while the copies fly.  The row: its
    // five possible terms (the floor's first) and its four tones as the
    // bytes of one word; a tone outside [0, 255] equals no corrected byte:
    // it takes the byte and term of the symbol's first tone inside (the
    // floor's term where none is), so the first byte that matches gives the
    // plain version's term.  The table: the floor's term, then each tone
    // below 64 its term, the last tone first, so the first tone of a value
    // stays.  Symbols n to 63 get zeros.
    if (tid < CHASE_N_MAX) {
        float* row = row_s + tid * SC_ROW;
        float* lut = lut_s + tid * SC_LUT;
        if (tid < n) {
            const long long r = static_cast<long long>(c) * n + tid;
            float te[4], term[5];
            long long tn[4];
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                te[h] = top_e[r * 4 + h];
                tn[h] = top_tone[r * 4 + h];
            }
            const float es = e_sum[r];
            const float floor_e = (es - (((te[0] + te[1]) + te[2]) + te[3]))
                / static_cast<float>(CHASE_Q - 4);
            const float den = es / static_cast<float>(n) + TINY;
#pragma unroll
            for (int h = 0; h < 4; ++h) term[h] = logf((te[h] + TINY) / den);
            term[4] = logf((floor_e + TINY) / den);
            uint32_t first_b = 0u;
            float first_t = term[4];
#pragma unroll
            for (int h = 3; h >= 0; --h)
                if (tn[h] >= 0 && tn[h] <= 255) {
                    first_b = static_cast<uint32_t>(tn[h]);
                    first_t = term[h];
                }
            uint32_t word = 0u;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const bool in = tn[h] >= 0 && tn[h] <= 255;
                word |= (in ? static_cast<uint32_t>(tn[h]) : first_b)
                    << (8 * h);
                row[1 + h] = in ? term[h] : first_t;
            }
            row[0] = term[4];
            row[5] = __uint_as_float(word);
            for (int v = 0; v < 64; ++v) lut[v] = term[4];
#pragma unroll
            for (int h = 3; h >= 0; --h)
                if (tn[h] >= 0 && tn[h] < 64) lut[tn[h]] = term[h];
        } else {
#pragma unroll
            for (int h = 0; h < SC_ROW; ++h) row[h] = 0.0f;
            for (int v = 0; v < 64; ++v) lut[v] = 0.0f;
        }
    }
    __syncthreads();
    const int i0 = q * SC_SPAN;
    const int off = local * n + i0;              // its first byte in a slot
    const int sh = (off & 3) * 8;
    const float* lut = lut_s + i0 * SC_LUT;
    // the lane's bytes below n in each word of 4 symbols
    uint32_t keep[SC_SPAN / 4];
#pragma unroll
    for (int k = 0; k < SC_SPAN / 4; ++k) {
        const int v = n - i0 - 4 * k;
        keep[k] = v >= 4 ? 0xffffffffu : v <= 0 ? 0u : (1u << (8 * v)) - 1u;
    }
    float wbest = 0.0f;
    int wtrial = -1;
    for (int s = 0; s < stages; ++s) {
        const int t = SC_STAGE * s + local;
        const int slot = s % SC_RING;
        unsigned char* cs = ring_s + 2 * slot_b * slot;
        if (d.bulk) {
            mbar_wait(&bar_s[slot], (s / SC_RING) & 1);
        } else {
            const int t1 = SC_STAGE * (s + 1) < T ? SC_STAGE * (s + 1) : T;
            const int bytes = (t1 - SC_STAGE * s) * n;
            const long long at = static_cast<long long>(SC_STAGE) * s * n;
            for (int x = tid; x < bytes; x += SC_THREADS) {
                cs[x] = cw_c[at + x];
                cs[slot_b + x] = er_c[at + x];
            }
            __syncthreads();
        }
        // the lane's words of the stage into registers; then the slot is
        // free, and the stage SC_RING on is copied into it while the
        // lanes score this one
        const uint32_t* cwd = reinterpret_cast<const uint32_t*>(cs) + (off >> 2);
        const uint32_t* ewd =
            reinterpret_cast<const uint32_t*>(cs + slot_b) + (off >> 2);
        uint32_t cword[SC_SPAN / 4 + 1], eword[SC_SPAN / 4 + 1];
#pragma unroll
        for (int k = 0; k <= SC_SPAN / 4; ++k) {
            cword[k] = cwd[k];
            eword[k] = ewd[k];
        }
        __syncthreads();
        if (d.bulk && tid == 0 && s + SC_RING < stages) {
            const int sn = s + SC_RING;
            const int t1 = SC_STAGE * (sn + 1) < T ? SC_STAGE * (sn + 1) : T;
            const int bytes = (t1 - SC_STAGE * sn) * n;
            const long long at = static_cast<long long>(SC_STAGE) * sn * n;
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_expect_tx(&bar_s[slot], 2 * bytes);
            bulk_copy(cs, cw_c + at, bytes, &bar_s[slot]);
            bulk_copy(cs + slot_b, er_c + at, bytes, &bar_s[slot]);
        }
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float eacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int cnt = 0;
#pragma unroll
        for (int k = 0; k < SC_SPAN / 4; ++k) {
            const uint32_t cw =
                __funnelshift_r(cword[k], cword[k + 1], sh) & keep[k];
            const uint32_t ew =
                __funnelshift_r(eword[k], eword[k + 1], sh) & keep[k];
            // bit 7 of each byte whose flag is set
            const uint32_t nz =
                (((ew & 0x7f7f7f7fu) + 0x7f7f7f7fu) | ew) & 0x80808080u;
            cnt += __popc(nz);
            float term[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                term[j] = lut[(4 * k + j) * SC_LUT + ((cw >> (8 * j)) & 63u)];
            if (cw & 0xc0c0c0c0u) {              // a value of 64 or more
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const uint32_t v = (cw >> (8 * j)) & 0xffu;
                    if (v >= 64u)
                        term[j] = sc_term_slow(
                            row_s + (i0 + 4 * k + j) * SC_ROW, v);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[j] += term[j];
                eacc[j] += (nz >> (8 * j + 7)) & 1u ? term[j] : 0.0f;
            }
        }
        float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        float sum_era = (eacc[0] + eacc[1]) + (eacc[2] + eacc[3]);
#pragma unroll
        for (int o = SC_LANES / 2; o > 0; o >>= 1) {
            sum += __shfl_xor_sync(FULL, sum, o);
            sum_era += __shfl_xor_sync(FULL, sum_era, o);
            cnt += __shfl_xor_sync(FULL, cnt, o);
        }
        if (t < T) {
            const float n_era = static_cast<float>(cnt);
            const float s_era = sum_era / (n_era > 1.0f ? n_era : 1.0f);
            const bool pass = ((ok_bits >> s) & 1u)
                && (n_era < 8.0f || s_era >= d.gate);
            const float score = pass ? sum / static_cast<float>(n)
                                     : -INFINITY;
            if (wtrial < 0 || better(score, t, wbest, wtrial)) {
                wbest = score;
                wtrial = t;
            }
        }
    }
    // the warp's best over its quads, then warp 0's over the warps
#pragma unroll
    for (int o = SC_LANES; o < 32; o <<= 1) {
        const float ob = __shfl_xor_sync(FULL, wbest, o);
        const int ot = __shfl_xor_sync(FULL, wtrial, o);
        if (ot >= 0 && (wtrial < 0 || better(ob, ot, wbest, wtrial))) {
            wbest = ob;
            wtrial = ot;
        }
    }
    if (lane == 0) {
        wbest_s[warp] = wbest;
        wtrial_s[warp] = wtrial;
    }
    __syncthreads();
    if (tid == 0) {
        float b = wbest_s[0];
        int bt = wtrial_s[0];
        for (int w = 1; w < SC_WARPS; ++w)
            if (wtrial_s[w] >= 0
                && (bt < 0 || better(wbest_s[w], wtrial_s[w], b, bt))) {
                b = wbest_s[w];
                bt = wtrial_s[w];
            }
        best_s = bt;
        bscore_s = b;
        best_score[c] = b;
        best_trial[c] = bt;
    }
    __syncthreads();
    if (warp == 0) {
        const int bt = best_s;
        const uint8_t* cw = corrected + (cand0 + bt) * n;
        bool nonzero = false;
        for (int j = lane; j < d.k; j += 32) {
            const int v = cw[j];
            info[static_cast<long long>(c) * d.k + j] = v;
            nonzero |= v != 0;
        }
        nonzero = __any_sync(FULL, nonzero);
        if (lane == 0) best_ok[c] = nonzero && bscore_s >= d.accept;
    }
}

}  // namespace

extern "C" {

int chase_n_max() { return CHASE_N_MAX; }
int chase_t_max() { return CHASE_T_MAX; }
int chase_det_max() { return CHASE_DET_MAX; }
int chase_sum_window() { return CHASE_SUM_WINDOW; }
int chase_score_warps() { return SC_WARPS; }
int chase_score_lanes() { return SC_LANES; }
int chase_score_stage() { return SC_STAGE; }
int chase_score_ring() { return SC_RING; }

// The erasure flags of C candidates' T trials: dims [4 + n_det] = C, T, n,
// n_det, then the n_det tiers; c0 the call's first candidate in the whole
// draw; margin [C, n] float32, seed one int64, base_p [n] and depth
// [T - n_det] float32 -> era [C, T, n] uint8, one launch on `stream`.
// Returns the cudaError_t.
int chase_erasures_launch(const int* dims, long long c0, const void* margin,
                          const void* seed, const void* base_p,
                          const void* depth, void* era, void* stream) {
    EraDims d;
    d.C = dims[0];
    d.T = dims[1];
    d.n = dims[2];
    d.n_det = dims[3];
    d.c0 = c0;
    if (d.C < 1 || d.n < 1 || d.n > CHASE_N_MAX || d.n_det < 0
        || d.n_det > CHASE_DET_MAX || d.T <= d.n_det || d.T > CHASE_T_MAX
        || c0 < 0 || d.C > 2147483647LL / (static_cast<long long>(d.T) * d.n))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < CHASE_DET_MAX; ++i)
        d.tiers[i] = i < d.n_det ? dims[4 + i] : 0;
    k_chase_erasures<<<d.C, CHASE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(margin), static_cast<const int64_t*>(seed),
        static_cast<const float*>(base_p), static_cast<const float*>(depth),
        d, static_cast<uint8_t*>(era));
    return static_cast<int>(cudaGetLastError());
}

// Whether chase_score stages these slabs by the TMA unit: both bases 16-byte
// aligned and a candidate's T n bytes a multiple of 16 (then every stage's
// start and length are).
int chase_score_bulk(const void* corrected, const void* era, int T, int n) {
    const auto a = reinterpret_cast<uintptr_t>(corrected)
        | reinterpret_cast<uintptr_t>(era);
    return (a & 15u) == 0 && (static_cast<long long>(T) * n) % 16 == 0;
}

// The soft score and best trial of C candidates' T trials: dims [4] = C,
// T, n, k; accept and gate (0.6 accept) as float32; corrected [C, T, n]
// uint8, ok [C, T] uint8, era [C, T, n] uint8, top_e [C, n, 4] float32,
// top_tone [C, n, 4] int64, e_sum [C, n] float32 -> info [C, k] int64,
// best_score [C] float32, best_ok [C] uint8, best_trial [C] int64, one
// launch on `stream`.  Returns the cudaError_t.
int chase_score_launch(const int* dims, float accept, float gate,
                       const void* corrected, const void* ok,
                       const void* era, const void* top_e,
                       const void* top_tone, const void* e_sum, void* info,
                       void* best_score, void* best_ok, void* best_trial,
                       void* stream) {
    ScoreDims d;
    d.C = dims[0];
    d.T = dims[1];
    d.n = dims[2];
    d.k = dims[3];
    d.accept = accept;
    d.gate = gate;
    if (d.C < 1 || d.T < 1 || d.T > CHASE_T_MAX || d.n < 1
        || d.n > CHASE_N_MAX || d.k < 1 || d.k > d.n
        || d.C > 2147483647LL / (static_cast<long long>(d.T) * d.n))
        return static_cast<int>(cudaErrorInvalidValue);
    d.bulk = chase_score_bulk(corrected, era, d.T, d.n);
    k_chase_score<<<d.C, SC_THREADS, sc_smem_bytes(d.n),
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(corrected),
        static_cast<const uint8_t*>(ok), static_cast<const uint8_t*>(era),
        static_cast<const float*>(top_e),
        static_cast<const int64_t*>(top_tone),
        static_cast<const float*>(e_sum), d, static_cast<int64_t*>(info),
        static_cast<float*>(best_score), static_cast<uint8_t*>(best_ok),
        static_cast<int64_t*>(best_trial));
    return static_cast<int>(cudaGetLastError());
}

// chase_score's design for T trials of n symbols on the current device:
// out [6] = warps a block, trials a stage, ring slots, dynamic shared
// bytes, static shared bytes, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns the
// cudaError_t.
int chase_score_design(int T, int n, int* out) {
    if (T < 1 || T > CHASE_T_MAX || n < 1 || n > CHASE_N_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, k_chase_score);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = SC_WARPS;
    out[1] = SC_STAGE;
    out[2] = SC_RING;
    out[3] = sc_smem_bytes(n);
    out[4] = static_cast<int>(a.sharedSizeBytes);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 5, k_chase_score, SC_THREADS, out[3]));
}

// A kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes): which
// 0 = chase_erasures, 1 = chase_score.  out [4].  Returns the cudaError_t.
int chase_kernel_attrs(int which, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaErrorInvalidValue;
    if (which == 0) e = cudaFuncGetAttributes(&a, k_chase_erasures);
    else if (which == 1) e = cudaFuncGetAttributes(&a, k_chase_score);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

}  // extern "C"
