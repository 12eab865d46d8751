// The weak modes' two costliest device stages: WSPR's beam search
// (wspr_beam) and JT65's errors-and-erasures Reed-Solomon decode (rs_ee),
// one launch each with no host sync.
//
// They replace two XLA programs of the JAX package:
// cwsl_digi_tpu/modes/wspr.py:526-615 (_beam_decode: a lax.scan of 81
// trellis steps, each an argsort of the 2W expanded states, the merge of
// equal register tails and a lax.top_k, then a scan that backtracks) and
// cwsl_digi_tpu/modes/rs_device.py:118-222 (rs_ee_decode: syndromes, the
// erasure locator, Berlekamp-Massey, Chien, Omega and Forney as fori_loops
// over GF(64), then the corrected word's syndromes).  Their plain versions
// are modes/wspr.py:_beam_decode_plain and modes/rs_device.py:
// rs_ee_decode_plain, which run the same steps as PyTorch launches: ~25
// launches and two full sorts of 2W keys a trellis step, 81 steps and 162
// gathers a call (twice a decode with the decision-directed pass), and
// ~2,500 launches of [M, 63] int64 tensors an RS call.
//
// What bounds them on an H100.
//
//   - wspr_beam reads each candidate's 162 LLRs and writes 50 bits and a
//     metric (0.4 MB at the bench's 576 candidates, ~0.1 us of HBM).  Its
//     operations: per step and expanded entry two parities and a few float
//     adds, the merge's neighbour compares, and two sorts of 2W keys, at
//     least 2W log2(2W) compares each.  At W = 512 that is ~3.4 M integer
//     operations a candidate, ~0.12 ms for 576 candidates at the INT32
//     rate.  What sets its time is the serial chain: 81 dependent steps,
//     each two bitonic sorts of 2W keys in shared memory (55 compare
//     stages each at W = 512, 15 of them behind a block barrier, the rest
//     behind a warp barrier) and 5 more block barriers.
//   - rs_ee reads the symbols (int64, a candidate's row shared by its
//     trials) and the erasure flags (a byte each) and writes the corrected
//     word (a byte a symbol) and ok: ~12 MB at JT65's device batch of
//     92,160 trials, ~0.004 ms of HBM.  Its operations are GF(64) products
//     (a table lookup and an XOR each): two syndrome sets, the locator,
//     the BM rounds, Omega and three polynomial evaluations at every
//     position, ~17,000 a trial, ~0.2 ms at the INT32 rate: operations
//     bound it.  Its serial chain: the 51 dependent BM rounds (a shuffle,
//     a product and an XOR reduction across the warp each) between two
//     63-step Horner chains.
//
// The design.
//
//   - wspr_beam: one block of W threads a candidate, W a template (any
//     power of two from 32 to 1024), all 81 steps and the backtrack in one
//     launch.  The survivors' states, metrics and live flags, the step's
//     2W sort keys and metrics, the candidate's LLRs and every step's
//     back-pointers stay in shared memory (the back-pointers, parent |
//     bit << 15 in a uint16, are 81 x W x 2 B: 166 KB at W = 1024, so the
//     launch sets the dynamic shared memory attribute).  Thread t expands
//     survivor t into entries t (bit 0) and t + W (bit 1), with the plain
//     version's arithmetic: ((1 - 2 b1) l0 + (1 - 2 b2) l1) * 0.5, b1 and
//     b2 the parities (__popc) of the state under POLY1 and POLY2, added
//     to the metric, 1e9 taken off bit 1 on the tail steps, -1e9 where the
//     parent is not live.  The plain version's stable argsort of the 31-bit
//     register tails is an ascending sort of the unique (tail << 11 |
//     entry); after it each entry compares with its neighbours (drop the
//     worse of an equal pair, the later one on a metric tie), and the
//     stable descending top-W is an ascending sort of the unique (order
//     key of the metric << 22 | sorted position << 11 | entry), where the
//     order key maps -0.0 onto 0.0 and every NaN ahead of +inf, as
//     torch.sort(descending=True) places them.  Both sorts are bitonic in
//     shared memory, a compare-exchange a thread a stage; a stage whose
//     stride and whose successor's stride are at most 32 keeps every warp
//     inside its own 64 keys, so it waits on __syncwarp, not on the block.
//     One thread then walks the back-pointers from the first maximum of
//     the final metrics (NaN counting as the maximum).
//   - rs_ee: a warp a trial, the blocks looping over the trials.  Lanes j
//     and j + 32 hold coefficient j (and j + 32) of the locator, of B and
//     of the syndromes, and positions j and j + 32 of the word.  A GF(64)
//     product is one byte of the 64 x 64 table in shared memory (with the
//     inverse table, the positions' powers and the syndrome roots, 4.4 KB a
//     block).  The syndromes and the evaluations at X_i^-1 run as Horner
//     chains, the same field elements as the plain version's sums of
//     table powers; the locator multiplies in (1 + X_i x) for each erased
//     position in ascending order, truncated to nroots + 1 coefficients as
//     the plain version's; each BM round's discrepancy is one
//     __reduce_xor_sync and the shift of B and Lambda a __shfl_up_sync.
//     The trial's candidate row is read once a trial from syms [C, n]
//     int64 (the expanded [C T, n] int64 word is never built), the
//     erasure flags from era [C, T, n] bool.
//
// Both are built with --fmad=false, so the beam's metric arithmetic is the
// plain version's sequence of IEEE float operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// WSPR's trellis: 50 message bits, 31 tail bits, rate 1/2, K = 32
constexpr int BEAM_STEPS = 81;
constexpr int BEAM_MSG_BITS = 50;
constexpr uint32_t POLY1 = 0xF2D05351u;
constexpr uint32_t POLY2 = 0xE4613C47u;
constexpr int BEAM_W_MIN = 32;
constexpr int BEAM_W_MAX = 1024;
constexpr float DEAD = -1e9f;
constexpr int MAX_DEVICES = 64;           // per-device launch settings kept

// GF(64) Reed-Solomon limits: n symbols <= 63, nroots < n
constexpr int RS_N_MAX = 63;
constexpr int RS_WARPS = 8;                 // trials in flight a block
constexpr int RS_THREADS = RS_WARPS * 32;
// the table block: mul [64 x 64], inv [64], xi [64], xi_inv [64],
// xfcr [64], roots [64] (alpha^(fcr + j)), bytes
constexpr int RS_TAB_MUL = 0;
constexpr int RS_TAB_INV = 4096;
constexpr int RS_TAB_XI = RS_TAB_INV + 64;
constexpr int RS_TAB_XINV = RS_TAB_XI + 64;
constexpr int RS_TAB_XFCR = RS_TAB_XINV + 64;
constexpr int RS_TAB_ROOT = RS_TAB_XFCR + 64;
constexpr int RS_TAB_BYTES = RS_TAB_ROOT + 64;

// ---------------------------------------------------------------------------
// wspr_beam

__host__ __device__ constexpr int ilog2(int x) {
    return x <= 1 ? 0 : 1 + ilog2(x >> 1);
}

// an order key of a float metric: ascending keys are descending metrics,
// -0.0 as 0.0, every NaN first (torch.sort(descending=True)'s order)
__device__ __forceinline__ uint32_t desc_key(float m) {
    if (m != m) return 0u;
    uint32_t u = __float_as_uint(m);
    if ((u & 0x7fffffffu) == 0u) u = 0u;
    const uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ~asc;
}

// the branch metric of register state s: ((1 - 2 b1) l0 + (1 - 2 b2) l1)
// * 0.5 in the plain version's order and rounding
__device__ __forceinline__ float branch_metric(uint32_t s, float l0,
                                               float l1) {
    const float c1 = (__popc(s & POLY1) & 1) ? -1.0f : 1.0f;
    const float c2 = (__popc(s & POLY2) & 1) ? -1.0f : 1.0f;
    return __fmul_rn(__fadd_rn(__fmul_rn(c1, l0), __fmul_rn(c2, l1)), 0.5f);
}

// Ascending bitonic sort of key[0, 2W) by the block's W threads, one
// compare-exchange a thread a stage.  A stage of stride j <= 32 keeps warp
// w inside key[64 w, 64 w + 64), so between two such stages a warp barrier
// orders what it reads; any other stage boundary takes a block barrier.
// Ends with a block barrier.
template <int W>
__device__ __forceinline__ void bitonic_sort(uint64_t* key, int t) {
    constexpr int E = 2 * W;
#pragma unroll 1
    for (int k = 2; k <= E; k <<= 1) {
#pragma unroll 1
        for (int j = k >> 1; j > 0; j >>= 1) {
            const int i = 2 * t - (t & (j - 1));
            const uint64_t a = key[i];
            const uint64_t b = key[i + j];
            const bool up = (i & k) == 0;
            if ((a > b) == up) {
                key[i] = b;
                key[i + j] = a;
            }
            const int next = j > 1 ? j >> 1 : k;
            if (j <= 32 && next <= 32 && !(k == E && j == 1))
                __syncwarp();
            else
                __syncthreads();
        }
    }
}

template <int W>
struct BeamSmem {
    static constexpr int E = 2 * W;
    static constexpr size_t key = 0;                            // u64 [E]
    static constexpr size_t met2 = key + sizeof(uint64_t) * E;  // f32 [E]
    static constexpr size_t st = met2 + sizeof(float) * E;      // u32 [W]
    static constexpr size_t met = st + sizeof(uint32_t) * W;    // f32 [W]
    static constexpr size_t llr = met + sizeof(float) * W;      // f32 [162]
    static constexpr size_t bp = llr + sizeof(float) * 2 * BEAM_STEPS;
    static constexpr size_t live = bp + sizeof(uint16_t) * BEAM_STEPS * W;
    static constexpr size_t bytes = live + W;                   // u8 [W]
};

template <int W>
__global__ void __launch_bounds__(W)
k_wspr_beam(const float* __restrict__ llr, float* __restrict__ best,
            int8_t* __restrict__ bits) {
    using S = BeamSmem<W>;
    constexpr int E = 2 * W;
    constexpr int LOG_W = ilog2(W);
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* key = reinterpret_cast<uint64_t*>(smem + S::key);
    float* met2 = reinterpret_cast<float*>(smem + S::met2);
    uint32_t* st = reinterpret_cast<uint32_t*>(smem + S::st);
    float* met = reinterpret_cast<float*>(smem + S::met);
    float* sl = reinterpret_cast<float*>(smem + S::llr);
    uint16_t* bp = reinterpret_cast<uint16_t*>(smem + S::bp);
    uint8_t* live = smem + S::live;

    const int t = threadIdx.x;
    const long long cand = blockIdx.x;
    for (int i = t; i < 2 * BEAM_STEPS; i += W)
        sl[i] = llr[cand * 2 * BEAM_STEPS + i];
    st[t] = 0u;
    met[t] = t == 0 ? 0.0f : DEAD;             // one live root
    live[t] = t == 0;
    __syncthreads();

#pragma unroll 1
    for (int step = 0; step < BEAM_STEPS; ++step) {
        // expand survivor t into entry t (bit 0) and t + W (bit 1)
        {
            const float l0 = sl[2 * step], l1 = sl[2 * step + 1];
            const uint32_t s0 = st[t] << 1;
            const uint32_t s1 = s0 | 1u;
            const float m = met[t];
            float m0 = __fadd_rn(m, branch_metric(s0, l0, l1));
            float m1 = __fadd_rn(m, branch_metric(s1, l0, l1));
            if (step >= BEAM_MSG_BITS) m1 = __fsub_rn(m1, 1e9f);
            const bool lv = live[t] != 0;
            met2[t] = lv ? m0 : DEAD;
            met2[t + W] = lv ? m1 : DEAD;
            key[t] = (static_cast<uint64_t>(s0 & 0x7fffffffu) << 11)
                     | static_cast<uint64_t>(t);
            key[t + W] = (static_cast<uint64_t>(s1 & 0x7fffffffu) << 11)
                         | static_cast<uint64_t>(t + W);
        }
        __syncthreads();
        bitonic_sort<W>(key, t);

        // merge equal register tails: drop the worse of an adjacent equal
        // pair (the later on a metric tie), on the metrics as sorted
        uint64_t nk[2];
        float nm[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int p = t + h * W;
            const uint64_t kp = key[p];
            const uint64_t tail = kp >> 11;
            const int e = static_cast<int>(kp & 0x7ff);
            const float mp = met2[e];
            bool drop = false;
            if (p + 1 < E) {
                const uint64_t kn = key[p + 1];
                if ((kn >> 11) == tail && mp < met2[kn & 0x7ff]) drop = true;
            }
            if (p > 0) {
                const uint64_t kq = key[p - 1];
                if ((kq >> 11) == tail && mp <= met2[kq & 0x7ff]) drop = true;
            }
            nm[h] = drop ? DEAD : mp;
            nk[h] = (static_cast<uint64_t>(desc_key(nm[h])) << 22)
                    | (static_cast<uint64_t>(p) << 11)
                    | static_cast<uint64_t>(e);
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            key[t + h * W] = nk[h];
            met2[t + h * W] = nm[h];            // by sorted position
        }
        __syncthreads();
        bitonic_sort<W>(key, t);

        // the top W: survivor t is entry e of sorted position p
        {
            const uint64_t kk = key[t];
            const int p = static_cast<int>((kk >> 11) & 0x7ff);
            const int e = static_cast<int>(kk & 0x7ff);
            const int parent = e & (W - 1);
            const uint32_t bit = static_cast<uint32_t>(e >> LOG_W);
            const float m = met2[p];
            const uint32_t s = (st[parent] << 1) | bit;
            const uint8_t lv = live[parent];
            bp[step * W + t] = static_cast<uint16_t>(parent | (bit << 15));
            __syncthreads();
            st[t] = s;
            met[t] = m;
            live[t] = lv;
            __syncthreads();
        }
    }

    if (t == 0) {
        // the first maximum of the final metrics, NaN as the maximum
        int idx = 0;
        float mx = met[0];
        for (int i = 1; i < W && mx == mx; ++i) {
            const float v = met[i];
            if (v != v || v > mx) {
                mx = v;
                idx = i;
            }
        }
        best[cand] = mx;
        for (int step = BEAM_STEPS - 1; step >= 0; --step) {
            const uint16_t v = bp[step * W + idx];
            if (step < BEAM_MSG_BITS)
                bits[cand * BEAM_MSG_BITS + step] =
                    static_cast<int8_t>(v >> 15);
            idx = v & 0x7fff;
        }
    }
}

// Sets the instance's dynamic shared memory attribute on the first launch
// of each device (a launch captured in a CUDA graph after a warm-up one
// makes no such call).
// f(std::integral_constant<int, W>{}) for the instance of beam width w (a
// power of two from 32 to 1024); `refused` for any other width.
template <class F>
int with_width(int w, int refused, F&& f) {
    switch (w) {
        case 32: return f(std::integral_constant<int, 32>{});
        case 64: return f(std::integral_constant<int, 64>{});
        case 128: return f(std::integral_constant<int, 128>{});
        case 256: return f(std::integral_constant<int, 256>{});
        case 512: return f(std::integral_constant<int, 512>{});
        case 1024: return f(std::integral_constant<int, 1024>{});
        default: return refused;
    }
}

template <int W>
int launch_beam(int n, const float* llr, float* best, int8_t* bits,
                cudaStream_t st) {
    static bool attr_set[MAX_DEVICES] = {};
    const int bytes = static_cast<int>(BeamSmem<W>::bytes);
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (!attr_set[dev]) {
        e = cudaFuncSetAttribute(k_wspr_beam<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set[dev] = true;
    }
    k_wspr_beam<W><<<n, W, bytes, st>>>(llr, best, bits);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// rs_ee

__device__ __forceinline__ uint32_t gf_mul(const uint8_t* mul, uint32_t a,
                                           uint32_t b) {
    return mul[(a << 6) | b];
}

struct RsDims {
    int C, T, n, nroots;
};

// Received symbol r at position i corrected: Lambda, Omega and Lambda'
// (its odd coefficients, in x^2) evaluated at X_i^-1 by Horner's rule, and
// where Lambda vanishes r XOR Omega / Lambda' X_i^(1 - fcr) (Forney).
__device__ __forceinline__ uint32_t corrected_at(const uint8_t* tab,
                                                 const uint8_t* lm,
                                                 const uint8_t* om,
                                                 int nroots, int i,
                                                 uint32_t r) {
    const uint8_t* mul = tab + RS_TAB_MUL;
    const uint32_t x = tab[RS_TAB_XINV + i];
    const uint32_t x2 = gf_mul(mul, x, x);
    uint32_t ev = 0, oe = 0, de = 0;
    for (int k = nroots; k >= 0; --k) ev = gf_mul(mul, ev, x) ^ lm[k];
    for (int k = nroots - 1; k >= 0; --k) oe = gf_mul(mul, oe, x) ^ om[k];
    for (int k = (nroots + 1) / 2 - 1; k >= 0; --k)
        de = gf_mul(mul, de, x2) ^ lm[2 * k + 1];
    const uint32_t mag = gf_mul(
        mul, gf_mul(mul, oe, tab[RS_TAB_INV + de]), tab[RS_TAB_XFCR + i]);
    return ev == 0 ? (r ^ mag) : r;
}

__global__ void __launch_bounds__(RS_THREADS)
k_rs_ee(const uint8_t* __restrict__ tables, const int64_t* __restrict__ syms,
        const uint8_t* __restrict__ era, RsDims d,
        uint8_t* __restrict__ corrected, uint8_t* __restrict__ ok) {
    __shared__ uint8_t tab[RS_TAB_BYTES];
    __shared__ uint8_t word[RS_WARPS][64];
    __shared__ uint8_t syn[RS_WARPS][64];
    __shared__ uint8_t lam[RS_WARPS][64];
    __shared__ uint8_t omg[RS_WARPS][64];
    for (int i = threadIdx.x; i < RS_TAB_BYTES; i += RS_THREADS)
        tab[i] = tables[i];
    __syncthreads();
    const uint8_t* mul = tab + RS_TAB_MUL;
    const uint8_t* inv = tab + RS_TAB_INV;
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int n = d.n, nroots = d.nroots;
    const int ia = lane, ib = lane + 32;        // this lane's two indices
    const bool pa = ia < n, pb = ib < n;        // positions in the word
    const bool ca = ia <= nroots, cb = ib <= nroots;  // locator coefficients
    const unsigned total = d.C * d.T;        // < 2**31 (checked at launch)
    uint8_t* wd = word[w];
    uint8_t* sy = syn[w];
    uint8_t* lm = lam[w];
    uint8_t* om = omg[w];

    // 32-bit trial indices: a 64-bit division would be a call, whose
    // saved registers spill
    for (unsigned m = blockIdx.x * RS_WARPS + w; m < total;
         m += gridDim.x * RS_WARPS) {
        const unsigned c = m / static_cast<unsigned>(d.T);
        const int64_t* row = syms + static_cast<long long>(c) * n;
        const uint8_t* er = era + static_cast<long long>(m) * n;
        const uint32_t ra = pa ? static_cast<uint32_t>(row[ia]) & 63u : 0u;
        const uint32_t rb = pb ? static_cast<uint32_t>(row[ib]) & 63u : 0u;
        const unsigned ea = __ballot_sync(FULL, pa && er[ia] != 0);
        const unsigned eb = __ballot_sync(FULL, pb && er[ib] != 0);
        wd[ia] = static_cast<uint8_t>(ra);
        wd[ib] = static_cast<uint8_t>(rb);
        __syncwarp();

        // syndromes S_j = r(alpha^(fcr + j)), Horner from word[0] (the
        // highest power), j = ia and ib
        uint32_t sa = 0, sb = 0;
        {
            const uint32_t xa = ia < nroots ? tab[RS_TAB_ROOT + ia] : 0u;
            const uint32_t xb = ib < nroots ? tab[RS_TAB_ROOT + ib] : 0u;
            for (int i = 0; i < n; ++i) {
                const uint32_t r = wd[i];
                sa = gf_mul(mul, sa, xa) ^ r;
                sb = gf_mul(mul, sb, xb) ^ r;
            }
            if (ia >= nroots) sa = 0;
            if (ib >= nroots) sb = 0;
        }
        sy[ia] = static_cast<uint8_t>(sa);
        sy[ib] = static_cast<uint8_t>(sb);

        // erasure locator prod (1 + X_i x) over the erased positions in
        // ascending order, nroots + 1 coefficients kept
        uint32_t la = lane == 0 ? 1u : 0u, lb = 0u;
        const int no_eras = __popc(ea) + __popc(eb);
        for (int half = 0; half < 2; ++half) {
            unsigned mask = half ? eb : ea;
            while (mask) {
                const int i = __ffs(mask) - 1 + 32 * half;
                mask &= mask - 1;
                const uint32_t x = tab[RS_TAB_XI + i];
                uint32_t prev_a = __shfl_up_sync(FULL, la, 1);
                uint32_t prev_b = __shfl_up_sync(FULL, lb, 1);
                const uint32_t top_a = __shfl_sync(FULL, la, 31);
                if (lane == 0) {
                    prev_a = 0;
                    prev_b = top_a;
                }
                la ^= gf_mul(mul, prev_a, x);
                lb ^= gf_mul(mul, prev_b, x);
                if (!ca) la = 0;
                if (!cb) lb = 0;
            }
        }
        __syncwarp();

        // Berlekamp-Massey with erasures (Karn's decode_rs recursion), the
        // rounds r > no_eras
        {
            uint32_t ba = la, bb = lb;
            int el = no_eras;
            for (int r = no_eras + 1; r <= nroots; ++r) {
                // discrepancy: XOR over i < r of lambda_i S_(r-1-i)
                uint32_t part = 0;
                if (ia <= r - 1) part ^= gf_mul(mul, la, sy[r - 1 - ia]);
                if (ib <= r - 1) part ^= gf_mul(mul, lb, sy[r - 1 - ib]);
                const uint32_t dd = __reduce_xor_sync(FULL, part);
                uint32_t bsa = __shfl_up_sync(FULL, ba, 1);
                uint32_t bsb = __shfl_up_sync(FULL, bb, 1);
                const uint32_t top_b = __shfl_sync(FULL, ba, 31);
                if (lane == 0) {
                    bsa = 0;
                    bsb = top_b;
                }
                if (!ca) bsa = 0;
                if (!cb) bsb = 0;
                const uint32_t ta = la ^ gf_mul(mul, dd, bsa);
                const uint32_t tb = lb ^ gf_mul(mul, dd, bsb);
                if (dd != 0 && 2 * el <= (r - 1) + no_eras) {
                    const uint32_t id = inv[dd];
                    ba = gf_mul(mul, la, id);
                    bb = gf_mul(mul, lb, id);
                    el = r + no_eras - el;
                } else {
                    ba = bsa;
                    bb = bsb;
                }
                la = ta;
                lb = tb;
            }
        }
        lm[ia] = static_cast<uint8_t>(la);
        lm[ib] = static_cast<uint8_t>(lb);
        __syncwarp();

        // Omega = S Lambda mod x^nroots: omega_j = XOR over i <= j of
        // lambda_i S_(j-i)
        {
            uint32_t oa = 0, ob = 0;
            for (int i = 0; i < nroots; ++i) {
                const uint32_t li = lm[i];
                if (i <= ia && ia < nroots)
                    oa ^= gf_mul(mul, li, sy[ia - i]);
                if (i <= ib && ib < nroots)
                    ob ^= gf_mul(mul, li, sy[ib - i]);
            }
            om[ia] = static_cast<uint8_t>(oa);
            om[ib] = static_cast<uint8_t>(ob);
        }
        __syncwarp();

        // Chien, Omega and Lambda' at X_i^-1 and Forney at positions ia
        // and ib
        const uint32_t fa =
            pa ? corrected_at(tab, lm, om, nroots, ia, ra) : 0u;
        const uint32_t fb =
            pb ? corrected_at(tab, lm, om, nroots, ib, rb) : 0u;
        __syncwarp();
        wd[ia] = static_cast<uint8_t>(fa);
        wd[ib] = static_cast<uint8_t>(fb);
        __syncwarp();

        // the corrected word's syndromes must all vanish
        uint32_t za = 0, zb = 0;
        {
            const uint32_t xa = ia < nroots ? tab[RS_TAB_ROOT + ia] : 0u;
            const uint32_t xb = ib < nroots ? tab[RS_TAB_ROOT + ib] : 0u;
            for (int i = 0; i < n; ++i) {
                const uint32_t r = wd[i];
                za = gf_mul(mul, za, xa) ^ r;
                zb = gf_mul(mul, zb, xb) ^ r;
            }
            if (ia >= nroots) za = 0;
            if (ib >= nroots) zb = 0;
        }
        const bool bad = __any_sync(FULL, (za | zb) != 0);
        uint8_t* out = corrected + static_cast<long long>(m) * n;
        if (pa) out[ia] = static_cast<uint8_t>(fa);
        if (pb) out[ib] = static_cast<uint8_t>(fb);
        if (lane == 0) ok[m] = bad ? 0 : 1;
        __syncwarp();
    }
}

}  // namespace

extern "C" {

int weak_beam_w_min() { return BEAM_W_MIN; }
int weak_beam_w_max() { return BEAM_W_MAX; }
int weak_beam_steps() { return BEAM_STEPS; }
int weak_rs_n_max() { return RS_N_MAX; }
int weak_rs_table_bytes() { return RS_TAB_BYTES; }

// Dynamic shared memory bytes of wspr_beam at beam width w (a power of two
// from 32 to 1024), or -1.
int wspr_beam_smem_bytes(int w) {
    return with_width(w, -1, [](auto c) {
        return static_cast<int>(BeamSmem<decltype(c)::value>::bytes);
    });
}

// Beam search of n candidates at width w: llr [n, 81, 2] float32 (positive
// = coded bit 0) to best [n] float32 (the best path's raw metric) and bits
// [n, 50] int8, on `stream`, one launch.  Returns the cudaError_t.
int wspr_beam_launch(int n, int w, const void* llr, void* best, void* bits,
                     void* stream) {
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    return with_width(w, static_cast<int>(cudaErrorInvalidValue),
                      [&](auto c) {
        return launch_beam<decltype(c)::value>(
            n, static_cast<const float*>(llr), static_cast<float*>(best),
            static_cast<int8_t*>(bits), static_cast<cudaStream_t>(stream));
    });
}

// Errors-and-erasures decode of C x T < 2**31 trials: trial (c, t) is the
// word syms [c] (int64, values taken mod 64) with the erasure flags era
// [c, t] (bool); corrected [C, T, n] uint8 and ok [C, T] bool (all the
// corrected word's syndromes zero), on `stream`, one launch of at most as
// many blocks as the card holds at once.  dims [4]: C, T, n, nroots; tables: the
// RS_TAB_BYTES table block.  Returns the cudaError_t.
int rs_ee_launch(const int* dims, const void* tables, const void* syms,
                 const void* era, void* corrected, void* ok, void* stream) {
    RsDims d;
    d.C = dims[0];
    d.T = dims[1];
    d.n = dims[2];
    d.nroots = dims[3];
    if (d.C < 1 || d.T < 1 || d.C > 2147483647 / d.T || d.n < 2
        || d.n > RS_N_MAX || d.nroots < 1 || d.nroots >= d.n)
        return static_cast<int>(cudaErrorInvalidValue);
    // the blocks the card holds at once, asked once a device
    static int resident[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, k_rs_ee, RS_THREADS, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
        resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const long long total = static_cast<long long>(d.C) * d.T;
    long long blocks = (total + RS_WARPS - 1) / RS_WARPS;
    if (blocks > resident[dev]) blocks = resident[dev];
    k_rs_ee<<<static_cast<unsigned>(blocks), RS_THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(tables),
        static_cast<const int64_t*>(syms), static_cast<const uint8_t*>(era),
        d, static_cast<uint8_t*>(corrected), static_cast<uint8_t*>(ok));
    return static_cast<int>(cudaGetLastError());
}

// A kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes): which 0
// = wspr_beam at width w, 1 = rs_ee.  out [4].  Returns the cudaError_t.
int weak_kernel_attrs(int which, int w, int* out) {
    cudaFuncAttributes a;
    int e = static_cast<int>(cudaErrorInvalidValue);
    if (which == 0)
        e = with_width(w, e, [&](auto c) {
            return static_cast<int>(
                cudaFuncGetAttributes(&a, k_wspr_beam<decltype(c)::value>));
        });
    else if (which == 1)
        e = static_cast<int>(cudaFuncGetAttributes(&a, k_rs_ee));
    if (e != 0) return e;
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

}  // extern "C"
