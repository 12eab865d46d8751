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
//     each, ~50 MB at that shape, 0.015 ms) and the candidates' top-4 rows;
//     its per-symbol work is a lookup and two adds: bytes bound it.
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
//   - chase_score: a block of 8 warps a candidate.  Each symbol's five
//     possible terms log((E + 1e-30) / (e_sum / n + 1e-30)), E one of the
//     top-4 energies or the residual floor, are computed once into shared
//     memory with logf; warp w takes trials w, w + 8, ..., lane l symbols l
//     and l + 32, matches the corrected tone against the top-4 tones, and
//     the warp sums the terms and the erased terms by __shfl_xor_sync (the
//     plain version sums in another order: the score agrees within
//     rounding) and counts the erasures by ballot.  Each warp keeps its best
//     passing trial (the larger score, NaN the largest, the lower trial on
//     ties), warp 0 merges the 8, and the block writes the best trial's
//     info symbols, score and flag.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, phase qary_decode_kernels)
// at a 1,024-candidate chunk of the App's JT65 decode: chase_erasures
// 0.0787 ms (the plain version 23.3 ms), 30 registers, 4,908 B of shared
// memory; chase_score 0.0615 ms (2.18 ms), 32 registers, 2,376 B.  The
// flags are the plain version's bit for bit, the score's info and ok
// identical, its score within 4.8e-7.
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

// The better of two (score, trial) pairs: the larger score, NaN the
// largest, the lower trial on ties (torch.argmax, jnp.argmax).
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
    const bool na = a != a, nb = b != b;
    if (na || nb) return na && (!nb || ia < ib);
    return a > b || (a == b && ia < ib);
}

// A block a candidate: corrected [C, T, n] uint8, ok [C, T] uint8, era [C,
// T, n] uint8, top_e [C, n, 4] float32, top_tone [C, n, 4] int64, e_sum [C,
// n] float32 -> info [C, k] int64, best_score [C] float32, best_ok [C]
// uint8, best_trial [C] int64.
__global__ void __launch_bounds__(CHASE_THREADS)
k_chase_score(const uint8_t* __restrict__ corrected,
              const uint8_t* __restrict__ ok, const uint8_t* __restrict__ era,
              const float* __restrict__ top_e,
              const int64_t* __restrict__ top_tone,
              const float* __restrict__ e_sum, ScoreDims d,
              int64_t* __restrict__ info, float* __restrict__ best_score,
              uint8_t* __restrict__ best_ok,
              int64_t* __restrict__ best_trial) {
    __shared__ float term_s[CHASE_N_MAX][5];     // 4 hits, then the floor
    __shared__ int tone_s[CHASE_N_MAX][4];
    __shared__ float wbest_s[CHASE_WARPS];
    __shared__ int wtrial_s[CHASE_WARPS];
    __shared__ int best_s;
    __shared__ float bscore_s;
    const int c = blockIdx.x, tid = threadIdx.x, n = d.n;
    if (tid < n) {
        const long long r = static_cast<long long>(c) * n + tid;
        float te[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            te[h] = top_e[r * 4 + h];
            tone_s[tid][h] = static_cast<int>(top_tone[r * 4 + h]);
        }
        const float es = e_sum[r];
        const float floor_e = (es - (((te[0] + te[1]) + te[2]) + te[3]))
            / static_cast<float>(CHASE_Q - 4);
        const float den = es / static_cast<float>(n) + TINY;
#pragma unroll
        for (int h = 0; h < 4; ++h) term_s[tid][h] = logf((te[h] + TINY) / den);
        term_s[tid][4] = logf((floor_e + TINY) / den);
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    float wbest = 0.0f;
    int wtrial = -1;
    for (int t = warp; t < d.T; t += CHASE_WARPS) {
        const long long row = static_cast<long long>(c) * d.T + t;
        const uint8_t* cw = corrected + row * n;
        const uint8_t* er = era + row * n;
        float sum = 0.0f, sum_era = 0.0f;
        unsigned erased[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = lane + 32 * half;
            bool is_era = false;
            if (i < n) {
                const int v = cw[i];
                const int h = v == tone_s[i][0] ? 0 : v == tone_s[i][1] ? 1
                    : v == tone_s[i][2] ? 2 : v == tone_s[i][3] ? 3 : 4;
                const float term = term_s[i][h];
                is_era = er[i] != 0;
                sum += term;
                if (is_era) sum_era += term;
            }
            erased[half] = __ballot_sync(FULL, is_era);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            sum += __shfl_xor_sync(FULL, sum, off);
            sum_era += __shfl_xor_sync(FULL, sum_era, off);
        }
        const float n_era =
            static_cast<float>(__popc(erased[0]) + __popc(erased[1]));
        const float s_era = sum_era / (n_era > 1.0f ? n_era : 1.0f);
        const bool pass = ok[row] != 0 && (n_era < 8.0f || s_era >= d.gate);
        const float score = pass ? sum / static_cast<float>(n) : -INFINITY;
        if (wtrial < 0 || better(score, t, wbest, wtrial)) {
            wbest = score;
            wtrial = t;
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
        for (int w = 1; w < CHASE_WARPS; ++w)
            if (wtrial_s[w] >= 0 && better(wbest_s[w], wtrial_s[w], b, bt)) {
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
        const uint8_t* cw = corrected + (static_cast<long long>(c) * d.T + bt)
            * n;
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
    k_chase_score<<<d.C, CHASE_THREADS, 0,
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
