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
//     adds, the merge's neighbour compares, and the least the two orders
//     need (a sort of the W survivors' tails, the top W of 2W keys and a
//     sort of them): at W = 512 ~2.2 M integer operations a candidate,
//     ~0.07 ms for 576 candidates at the INT32 rate.  What sets its time is
//     the serial chain: 81 dependent steps, each two sorting networks.
//   - rs_ee reads the symbols (int64, a candidate's row shared by its
//     trials) and the erasure flags (a byte each) and writes the corrected
//     word (a byte a symbol) and ok: ~12 MB at JT65's device batch of
//     92,160 trials, ~0.004 ms of HBM.  Its operations are GF(64) products
//     (a table lookup and an XOR each) that the data needs: a candidate's
//     syndromes once for all its trials, and per trial the locator, the
//     BM rounds, Omega, the Chien search, Omega and Lambda' at the roots,
//     Forney and S(e): ~10,450 a trial, 0.115 ms at the INT32 rate
//     (chip_smoke.rs_bound_ms): operations bound it.  What sets its time
//     is the shared-memory pipe: every product is a load.
//
// The design.
//
//   - wspr_beam: one block a candidate, all 81 steps in one launch, in a
//     plan of K keys a thread (2W / K threads): K = 2 where the candidates
//     leave SMs idle (the App's 48: the shortest chain a step), K = 4 where
//     they fill the card (fewer shuffles and barriers a candidate; 8 and
//     16 were slower at both).  A step:
//     (1) the W survivors' tails, (low 30 bits of the state, slot), K / 2
//         a thread, sorted.  A child's 31-bit tail is (low 30 << 1) | bit,
//         so this one sort fixes the plain version's stable argsort of the
//         2W tails: in a group of equal low 30 bits from rank r0 to e, rank
//         r's bit-0 child sits at r + r0 and its bit-1 child at r + e + 1,
//         and an equal tail beside it is the same bit's child of rank r - 1
//         or r + 1.  The group's ends come from two binary liftings over
//         the sorted tails in shared memory (the first and last rank a
//         thread; the others follow their neighbour).
//     (2) each rank's children: ((1 - 2 b1) l0 + (1 - 2 b2) l1) * 0.5 (b1,
//         b2 the parities of the state under POLY1 and POLY2) added to the
//         metric, 1e9 taken off bit 1 on the tail steps, -1e9 where the
//         parent is not live; the merge drops the worse of an equal pair
//         (the later on a metric tie) against the rank neighbours' children.
//     (3) the 2W top keys, desc_key(metric) << 32 | position << 16 | entry
//         (desc_key maps -0.0 onto 0.0 and every NaN ahead of +inf, as
//         torch.sort(descending=True) places them; the key also carries
//         -0.0 and the entry, so the survivor needs nothing else from it),
//         K a thread, sorted; only the first W are kept, so the last
//         phase's stages after the half-cleaner leave the upper half.
//     (4) survivor i takes its parent's state and path register: the
//         message bits so far, shifted in as they are chosen, and the live
//         flag.  The best path's bits are its path register, so there are
//         no back-pointers and no backtrack.
//     Both sorts are bitonic networks held in registers, in the form
//     whose every stage keeps the smaller key at the lower position (a
//     phase opens by pairing each position with its mirror), so no stage
//     has a direction to compute: a stage of stride below K (K / 2) runs
//     in a thread's registers, one below 32 times that between lanes
//     (__shfl_xor_sync), and only the wider ones cross shared memory
//     behind a block barrier (two alternating buffers, chosen when the
//     kernel is compiled).  At W = 512: 100 stages a step in every plan,
//     of them 20 (K = 2) or 12 (K = 4) behind a block barrier; 37.5 KB of
//     shared memory a block (74.4 KB at W = 1024).  The first maximum of
//     the final metrics (NaN as the maximum) is a warp's reduction.
//   - rs_ee: a warp a contiguous share of the trials (as many blocks as
//     the card holds at once), so that a candidate's syndromes S(r),
//     computed when the share reaches it, serve all its trials in the
//     share.  A GF(64) product is one byte of the 64 x 64 table in shared
//     memory; where its row is the same in every lane (a locator step's
//     X_i, BM's discrepancy and its inverse, Omega's lambda_i, the
//     evaluations' coefficients, S(e)'s e_i, S(r)'s r_i) the warp reads
//     within one 64-byte row, one wavefront (the first port read random
//     rows, ~3.5 wavefronts a product, ~660 a trial).  Lane l holds
//     coefficients 2 l and 2 l + 1 of the locator, of B and of Omega (one
//     shuffle a locator step or BM shift) and positions l and l + 32.  The
//     locator multiplies in (1 + X_i x) for each erased position in
//     ascending order and keeps nroots + 1 coefficients at the end (a
//     coefficient takes only lower ones); each BM round's discrepancy is
//     one __reduce_xor_sync.  Lambda's even and odd terms and Omega at
//     X_i^-1 are sums of c_k pw [k][i] over a table of the positions'
//     powers that each block builds (no Horner chain); Lambda' X_i^-1 is
//     the odd terms' sum, so Forney's magnitude is Omega inv(odd) fc_i,
//     fc_i = X_i^-1 X_i^(1 - fcr).  The corrected word's syndromes are
//     S(r) XOR S(e) over the changed positions (syndromes are linear), so
//     ok is the plain version's "all vanish".  ~910 shared loads a trial
//     (the first port ~1,380), 25 of them random rows (chip_smoke.
//     rs_shared_loads).  On an H100 80GB HBM3 at 700 W
//     (tools/sync_rs_profile.py): 0.5420-0.5446 ms at JT65's 92,160 trials
//     in turns with the first port's 1.0661-1.0671, 21 % of the bound; the
//     evaluations, Omega and the locator take ~22 % of a warp's cycles
//     each, BM 10 %, the check 10 %, the candidates' syndromes 8 %.
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

constexpr uint64_t PATH_LIVE = 1ull << 63;  // a survivor's live flag
constexpr uint64_t KEY_NEG_ZERO = 1ull << 11;

// an order key of a float metric: ascending keys are descending metrics,
// -0.0 as 0.0, every NaN first (torch.sort(descending=True)'s order)
__device__ __forceinline__ uint32_t desc_key(float m) {
    if (m != m) return 0u;
    uint32_t u = __float_as_uint(m);
    if ((u & 0x7fffffffu) == 0u) u = 0u;
    const uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ~asc;
}

// A top key: desc_key(m) << 32 | position << 16 | (m is -0.0) << 11 | bit
// << 10 | slot.  Position is unique, so the key orders by (descending
// metric, position) and carries the entry (the parent's slot and the
// bit) and the metric itself (key_metric).
__device__ __forceinline__ uint64_t top_key(float m, int pos, uint32_t bit,
                                            int slot) {
    const uint64_t neg_zero =
        __float_as_uint(m) == 0x80000000u ? KEY_NEG_ZERO : 0ull;
    return (static_cast<uint64_t>(desc_key(m)) << 32)
           | (static_cast<uint64_t>(pos) << 16) | neg_zero
           | (static_cast<uint64_t>(bit) << 10)
           | static_cast<uint64_t>(slot);
}

// the metric of a top key, bit for bit (any NaN as 0x7fffffff)
__device__ __forceinline__ float key_metric(uint64_t key) {
    const uint32_t asc = ~static_cast<uint32_t>(key >> 32);
    uint32_t u = (asc & 0x80000000u) ? (asc & 0x7fffffffu) : ~asc;
    if (key & KEY_NEG_ZERO) u = 0x80000000u;
    return __uint_as_float(u);
}

// the branch metric of register state s: ((1 - 2 b1) l0 + (1 - 2 b2) l1)
// * 0.5 in the plain version's order and rounding
__device__ __forceinline__ float branch_metric(uint32_t s, float l0,
                                               float l1) {
    const float c1 = (__popc(s & POLY1) & 1) ? -1.0f : 1.0f;
    const float c2 = (__popc(s & POLY2) & 1) ? -1.0f : 1.0f;
    return __fmul_rn(__fadd_rn(__fmul_rn(c1, l0), __fmul_rn(c2, l1)), 0.5f);
}

// A plan: K keys a thread of the 2W expanded entries, K / 2 of the W
// survivors, 2W / K threads a candidate.
template <int W, int K>
struct BeamPlan {
    static constexpr int N = 2 * W;
    static constexpr int T = N / K;
    static constexpr int KT = K / 2;
    static_assert(K >= 2 && (K & (K - 1)) == 0, "K a power of two");
    static_assert(T >= 32 && T <= 1024, "a block of 32 to 1024 threads");
};

template <int W, int K>
struct BeamSmem {
    using P = BeamPlan<W, K>;
    // the exchange buffers of the sorts' stages between warps (none in a
    // one-warp plan): two of 2W keys, thread t's q-th key at q T + t
    static constexpr size_t xb = 0;
    static constexpr size_t path =                              // u64 [2][W]
        xb + (P::T > 32 ? sizeof(uint64_t) * 2 * P::N : 0);
    static constexpr size_t st = path + sizeof(uint64_t) * 2 * W;  // u32 [2][W]
    static constexpr size_t met = st + sizeof(uint32_t) * 2 * W;   // f32 [W]
    static constexpr size_t rlow = met + sizeof(float) * W;        // u32 [W]
    static constexpr size_t rm = rlow + sizeof(uint32_t) * W;      // f32 [2][W]
    static constexpr size_t llr = rm + sizeof(float) * 2 * W;      // f32 [162]
    static constexpr size_t bytes = llr + sizeof(float) * 2 * BEAM_STEPS;
};

// The stages of a sort of NK keys held KK a thread that cross shared
// memory (stride 32 KK or more): of phases 2^1 .. 2^LK, and in phase 2^LK
// those before stride 2^LJ.
__host__ __device__ constexpr int shared_stages(int nk, int kk, int lk,
                                                 int lj) {
    int c = 0;
    for (int a = 1; a <= lk && (1 << a) <= nk; ++a)
        for (int b = a - 1; b >= 0 && !(a == lk && b == lj); --b)
            c += (1 << b) >= 32 * kk;
    return c;
}

// One compare stage (phase k, stride j) of an ascending bitonic sort of NK
// unique keys held KK a thread (thread t's v[q] at position t KK + q, TT =
// NK / KK threads), in the form whose every stage keeps the smaller key at
// the lower position: a phase's first stage (j = k / 2) pairs position i
// with its mirror in the block of k, i ^ (k - 1), the others i with i ^ j.
// A stage that pairs positions of one thread runs in its registers (j
// below KK); of one warp, between lanes (__shfl_xor_sync; j below 32 KK);
// any other, between warps through shared buffer BUF (two of STRIDE keys
// each; consecutive such stages alternate, so a buffer is written again
// only after the barrier that follows its last read) behind a block
// barrier.  In the last phase of a top-TOPN selection (TOPN < NK) the
// stages after the first leave the warps whose keys all lie past TOPN:
// what they hold is not needed.
template <int NK, int KK, int TOPN, int STRIDE, int k, int j, int BUF>
__device__ __forceinline__ void sort_stage(uint64_t (&v)[KK], int t,
                                           uint64_t* xb) {
    constexpr int TT = NK / KK;
    constexpr bool MIRROR = j == k / 2;
    constexpr bool LEFT = k == NK && j < TOPN && TOPN < NK;
    const bool on = !LEFT || (t & ~31) * KK < TOPN;       // warp-uniform
    if constexpr (j < KK) {
        if (on) {
#pragma unroll
            for (int q = 0; q < KK; ++q) {
                const int p = MIRROR ? q ^ (k - 1) : q ^ j;
                if (p < q) continue;
                const uint64_t a = v[q], b = v[p];
                v[q] = a < b ? a : b;
                v[p] = a < b ? b : a;
            }
        }
    } else {
        // the partner thread t ^ m; thread t keeps the smaller key where
        // it holds the lower position (bit `low` of t clear)
        constexpr int m = MIRROR ? k / KK - 1 : j / KK;
        constexpr int low = j / KK;
        const bool keep_min = (t & low) == 0;
        if constexpr (j < 32 * KK) {
            if (on) {
                // key q meets the partner's key q, or in a mirror stage
                // its key KK - 1 - q: the pair (q, KK - 1 - q) goes
                // together, so no key is sent after it changed
#pragma unroll
                for (int q = 0; q < (MIRROR ? (KK + 1) / 2 : KK); ++q) {
                    const int r = MIRROR ? KK - 1 - q : q;
                    const uint64_t oq = __shfl_xor_sync(0xffffffffu, v[r], m);
                    const uint64_t orr =
                        r == q ? oq : __shfl_xor_sync(0xffffffffu, v[q], m);
                    v[q] = ((oq < v[q]) == keep_min) ? oq : v[q];
                    if (r != q) v[r] = ((orr < v[r]) == keep_min) ? orr : v[r];
                }
            }
        } else {
            uint64_t* x = xb + BUF * STRIDE;
            if (on) {
#pragma unroll
                for (int q = 0; q < KK; ++q) x[q * TT + t] = v[q];
            }
            __syncthreads();
            if (on) {
#pragma unroll
                for (int q = 0; q < KK; ++q) {
                    const uint64_t o =
                        x[(MIRROR ? KK - 1 - q : q) * TT + (t ^ m)];
                    v[q] = ((o < v[q]) == keep_min) ? o : v[q];
                }
            }
        }
    }
}

// The stages of phases 2^LK.. and, within phase 2^LK, strides 2^LJ..1; the
// sort's first shared stage takes buffer B0.
template <int NK, int KK, int TOPN, int STRIDE, int B0, int LK = 1,
          int LJ = 0>
__device__ __forceinline__ void block_sort(uint64_t (&v)[KK], int t,
                                           uint64_t* xb) {
    if constexpr (LK <= ilog2(NK)) {
        constexpr int BUF = (B0 + shared_stages(NK, KK, LK, LJ)) & 1;
        sort_stage<NK, KK, TOPN, STRIDE, (1 << LK), (1 << LJ), BUF>(v, t,
                                                                    xb);
        if constexpr (LJ > 0)
            block_sort<NK, KK, TOPN, STRIDE, B0, LK, LJ - 1>(v, t, xb);
        else
            block_sort<NK, KK, TOPN, STRIDE, B0, LK + 1, LK>(v, t, xb);
    }
}

// threadIdx.x read anew where it is called (a volatile read on the card):
// what a trellis step computes from it (which key each sort stage keeps,
// the ranks' and their neighbours' addresses) then stays in the step and
// is not hoisted out of the loop and held across it, where ptxas spilled
// it.
__device__ __forceinline__ int fresh_tid() {
#ifdef __CUDA_ARCH__
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
#else
    return static_cast<int>(threadIdx.x);
#endif
}

// The first rank whose tail (of the W sorted ones in rlow) is v, and the
// last: binary liftings, log2 W dependent shared loads each.
template <int W>
__device__ __forceinline__ int first_rank(const uint32_t* rlow, uint32_t v) {
    int c = 0;
#pragma unroll
    for (int b = W / 2; b > 0; b >>= 1)
        if (rlow[c + b - 1] < v) c += b;
    return c;
}

template <int W>
__device__ __forceinline__ int last_rank(const uint32_t* rlow, uint32_t v) {
    int e = 0;
#pragma unroll
    for (int b = W / 2; b > 0; b >>= 1)
        if (rlow[e + b] <= v) e += b;
    return e;
}

template <int W, int K>
__global__ void __launch_bounds__(BeamPlan<W, K>::T)
k_wspr_beam(const float* __restrict__ llr, float* __restrict__ best,
            int8_t* __restrict__ bits) {
    using P = BeamPlan<W, K>;
    using S = BeamSmem<W, K>;
    constexpr int N = P::N, T = P::T, KT = P::KT;
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* xb = reinterpret_cast<uint64_t*>(smem + S::xb);
    uint64_t* spath = reinterpret_cast<uint64_t*>(smem + S::path);
    uint32_t* sst = reinterpret_cast<uint32_t*>(smem + S::st);
    float* smet = reinterpret_cast<float*>(smem + S::met);
    uint32_t* rlow = reinterpret_cast<uint32_t*>(smem + S::rlow);
    float* rm = reinterpret_cast<float*>(smem + S::rm);
    float* sl = reinterpret_cast<float*>(smem + S::llr);

    const int t = threadIdx.x;
    const long long cand = blockIdx.x;
    for (int i = t; i < 2 * BEAM_STEPS; i += T)
        sl[i] = llr[cand * 2 * BEAM_STEPS + i];
    for (int s = t; s < W; s += T) {
        sst[s] = 0u;
        smet[s] = s == 0 ? 0.0f : DEAD;        // one live root
        spath[s] = s == 0 ? PATH_LIVE : 0ull;
    }
    __syncthreads();

    constexpr int TAIL_SHARED = shared_stages(W, KT, ilog2(W) + 1, 0);
    static_assert(TAIL_SHARED == shared_stages(N, K, ilog2(N) + 1, 0),
                  "the two sorts cross shared memory equally often");
    int cur = 0;
#pragma unroll 1
    for (int step = 0; step < BEAM_STEPS; ++step) {
        const int t = fresh_tid();             // not hoisted: fresh_tid
        const uint32_t* st_c = sst + cur * W;
        const uint64_t* pa_c = spath + cur * W;

        // the survivors' tails: slot s = t KT + q keyed (low 30 bits of
        // its state, s), bit 30 riding below the slot; sorted, thread t
        // holds ranks t KT .. t KT + KT - 1
        uint64_t tk[KT];
#pragma unroll
        for (int q = 0; q < KT; ++q) {
            const int s = t * KT + q;
            const uint32_t u = st_c[s];
            tk[q] = (static_cast<uint64_t>(u & 0x3fffffffu) << 32)
                    | (static_cast<uint64_t>(s) << 1) | ((u >> 30) & 1u);
        }
        block_sort<W, KT, W, N, 0>(tk, t, xb);

        // each rank's two children: metric, -1e9 off bit 1 on the tail
        // steps, DEAD where the parent is not live; by rank to rlow / rm
        const float l0 = sl[2 * step], l1 = sl[2 * step + 1];
        uint32_t low[KT];
        int slot[KT];
        float c0[KT], c1[KT];
#pragma unroll
        for (int q = 0; q < KT; ++q) {
            low[q] = static_cast<uint32_t>(tk[q] >> 32);
            slot[q] = static_cast<int>((tk[q] >> 1) & 0x3ff);
            const uint32_t s0 =
                (low[q] | (static_cast<uint32_t>(tk[q] & 1u) << 30)) << 1;
            const float m = smet[slot[q]];
            const bool lv = (pa_c[slot[q]] & PATH_LIVE) != 0;
            const float m0 = __fadd_rn(m, branch_metric(s0, l0, l1));
            float m1 = __fadd_rn(m, branch_metric(s0 | 1u, l0, l1));
            if (step >= BEAM_MSG_BITS) m1 = __fsub_rn(m1, 1e9f);
            c0[q] = lv ? m0 : DEAD;
            c1[q] = lv ? m1 : DEAD;
            const int r = t * KT + q;
            rlow[r] = low[q];
            rm[r] = c0[q];
            rm[W + r] = c1[q];
        }
        __syncthreads();

        // the group of equal low 30 bits around rank r, ranks r0 .. e: the
        // thread's first and last rank search rlow, the others follow
        // their neighbour in the thread.  In the stable order of the 2W
        // tails, r's bit-0 child is at r + r0 and its bit-1 child at
        // r + e + 1; an equal tail next to it there is the child of the
        // same bit of rank r - 1 or r + 1 of the group: merge (drop the
        // worse of an equal pair, the later on a metric tie)
        int r0[KT], e[KT];
        r0[0] = first_rank<W>(rlow, low[0]);
        e[KT - 1] = last_rank<W>(rlow, low[KT - 1]);
#pragma unroll
        for (int q = 1; q < KT; ++q)
            r0[q] = low[q] == low[q - 1] ? r0[q - 1] : t * KT + q;
#pragma unroll
        for (int q = KT - 2; q >= 0; --q)
            e[q] = low[q] == low[q + 1] ? e[q + 1] : t * KT + q;
        uint64_t key[K];
#pragma unroll
        for (int q = 0; q < KT; ++q) {
            const int r = t * KT + q;
            const bool nx = r < e[q], pv = r > r0[q];
            const int rn = nx ? r + 1 : r, rp = pv ? r - 1 : r;
            float n0 = c0[q], n1 = c1[q];
            if ((nx && c0[q] < rm[rn]) || (pv && c0[q] <= rm[rp])) n0 = DEAD;
            if ((nx && c1[q] < rm[W + rn]) || (pv && c1[q] <= rm[W + rp]))
                n1 = DEAD;
            key[2 * q] = top_key(n0, r + r0[q], 0u, slot[q]);
            key[2 * q + 1] = top_key(n1, r + e[q] + 1, 1u, slot[q]);
        }
        // (the tail sort and the top sort cross shared memory equally
        // often, so a step ends on the buffer it began with)
        block_sort<N, K, W, N, TAIL_SHARED & 1>(key, t, xb);

        // the top W, positions t K .. t K + K - 1 < W: each takes its
        // parent's state and path register (the message bits, live flag)
        if (t * K < W) {
            uint32_t* st_n = sst + (cur ^ 1) * W;
            uint64_t* pa_n = spath + (cur ^ 1) * W;
#pragma unroll
            for (int q = 0; q < K; ++q) {
                const int i = t * K + q;
                const uint64_t kk = key[q];
                const int s = static_cast<int>(kk & 0x3ff);
                const uint32_t b = static_cast<uint32_t>(kk >> 10) & 1u;
                st_n[i] = (st_c[s] << 1) | b;
                smet[i] = key_metric(kk);
                const uint64_t pp = pa_c[s];
                pa_n[i] = step < BEAM_MSG_BITS
                    ? (pp & PATH_LIVE) | ((pp & ~PATH_LIVE) << 1) | b : pp;
            }
        }
        __syncthreads();
        cur ^= 1;
    }

    if (t < 32) {
        // the first maximum of the final metrics, NaN as the maximum: each
        // lane its W / 32 in order, then the lanes in order
        constexpr int PER = W / 32;
        int idx = t * PER;
        float mx = smet[idx];
        for (int i = 1; i < PER && mx == mx; ++i) {
            const float v = smet[t * PER + i];
            if (v != v || v > mx) {
                mx = v;
                idx = t * PER + i;
            }
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float om = __shfl_down_sync(0xffffffffu, mx, off);
            const int oi = __shfl_down_sync(0xffffffffu, idx, off);
            const bool take = t + off < 32 && mx == mx && (om != om || om > mx);
            if (take) {
                mx = om;
                idx = oi;
            }
        }
        idx = __shfl_sync(0xffffffffu, idx, 0);
        const uint64_t path = spath[cur * W + idx];
        if (t == 0) best[cand] = mx;
        for (int s = t; s < BEAM_MSG_BITS; s += 32)
            bits[cand * BEAM_MSG_BITS + s] =
                static_cast<int8_t>((path >> (BEAM_MSG_BITS - 1 - s)) & 1u);
    }
}

// f(std::integral_constant<int, W>{}, std::integral_constant<int, K>{})
// for the instance of beam width w and plan k (BEAM_PLANS in
// _weak_kernels.py); `refused` for any other pair.
template <class F>
int with_plan(int w, int k, int refused, F&& f) {
#define BEAM_PLAN(W_, K_) \
    if (w == W_ && k == K_) \
        return f(std::integral_constant<int, W_>{}, \
                 std::integral_constant<int, K_>{});
    BEAM_PLAN(32, 2)
    BEAM_PLAN(64, 2) BEAM_PLAN(64, 4)
    BEAM_PLAN(128, 2) BEAM_PLAN(128, 4)
    BEAM_PLAN(256, 2) BEAM_PLAN(256, 4)
    BEAM_PLAN(512, 2) BEAM_PLAN(512, 4)
    BEAM_PLAN(1024, 2) BEAM_PLAN(1024, 4)
#undef BEAM_PLAN
    return refused;
}

// Sets the instance's dynamic shared memory attribute once a device (a
// launch captured in a CUDA graph after a warm-up one makes no such call).
// Returns the cudaError_t.
template <int W, int K>
int beam_smem_attr() {
    static bool attr_set[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES)
        return static_cast<int>(cudaErrorInvalidDevice);
    if (!attr_set[dev]) {
        e = cudaFuncSetAttribute(k_wspr_beam<W, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(BeamSmem<W, K>::bytes));
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set[dev] = true;
    }
    return 0;
}

template <int W, int K>
int launch_beam(int n, const float* llr, float* best, int8_t* bits,
                cudaStream_t st) {
    const int e = beam_smem_attr<W, K>();
    if (e != 0) return e;
    k_wspr_beam<W, K><<<n, BeamPlan<W, K>::T, BeamSmem<W, K>::bytes, st>>>(
        llr, best, bits);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// rs_ee

// Profiling hooks, empty in the library: tools/sync_rs_profile.py builds
// this file with them defined to read clock64() at the kernel's phase
// boundaries (RS_SPAN(k) closes span k).
#ifndef RS_SPANS
#define RS_SPAN_BEGIN()
#define RS_SPAN(k)
#define RS_SPAN_END()
#endif

// a GF(64) product: one byte of the 64 x 64 table in shared memory.  Where
// the row a is the same in every lane of the warp, the lanes read within
// one 64-byte row, 16 words in 16 banks: one wavefront whatever the b.
__device__ __forceinline__ uint32_t gf_mul(const uint8_t* mul, uint32_t a,
                                           uint32_t b) {
    return mul[(a << 6) | b];
}

struct RsDims {
    int C, T, n, nroots;
};

// the block's tables past the table block: pw [k][l] = (X_i^-1)^k of the
// positions i = l and l + 32 (the low and the high byte), the positions'
// powers for the evaluations (k <= nroots), syn [i][j] = alpha^((fcr + j)
// deg_i), the syndromes' powers (j < nroots, 0 past), and fc [i] = X_i^-1
// X_i^(1 - fcr), Forney's constant a position
struct RsSmem {
    uint8_t tab[RS_TAB_BYTES];
    uint16_t pw[RS_N_MAX + 1][32];
    uint8_t syn[64][64];
    uint8_t fc[64];
    uint8_t word[RS_WARPS][64];        // the warp's candidate row
    uint16_t sy[RS_WARPS][66];         // S_(x-1) | S_x << 8 at x + 1, S(r)
    uint8_t lam[RS_WARPS][64];         // the trial's Lambda
    uint16_t lo[RS_WARPS][64];         // Lambda_k | Omega_k << 8
};

__global__ void __launch_bounds__(RS_THREADS)
k_rs_ee(const uint8_t* __restrict__ tables, const int64_t* __restrict__ syms,
        const uint8_t* __restrict__ era, RsDims d,
        uint8_t* __restrict__ corrected, uint8_t* __restrict__ ok) {
    __shared__ __align__(16) RsSmem sm;
    RS_SPAN_BEGIN();
    for (int i = threadIdx.x; i < RS_TAB_BYTES; i += RS_THREADS)
        sm.tab[i] = tables[i];
    __syncthreads();
    const uint8_t* mul = sm.tab + RS_TAB_MUL;
    const uint8_t* inv = sm.tab + RS_TAB_INV;
    const int n = d.n, nroots = d.nroots;
    {
        // threads 0-31 build two positions' powers, 64-127 a syndrome's,
        // 128-191 a position's Forney constant, by repeated products
        const int t = threadIdx.x;
        if (t < 32) {
            const int u = t + 32;
            const uint32_t x = t < n ? sm.tab[RS_TAB_XINV + t] : 0u;
            const uint32_t y = u < n ? sm.tab[RS_TAB_XINV + u] : 0u;
            uint32_t p = t < n ? 1u : 0u, q = u < n ? 1u : 0u;
            for (int k = 0; k <= nroots; ++k) {
                sm.pw[k][t] = static_cast<uint16_t>(p | (q << 8));
                p = gf_mul(mul, p, x);
                q = gf_mul(mul, q, y);
            }
        } else if (t >= 64 && t < 128) {
            const int j = t - 64;
            const uint32_t x = j < nroots ? sm.tab[RS_TAB_ROOT + j] : 0u;
            uint32_t p = j < nroots ? 1u : 0u;
            for (int i = 63; i >= 0; --i) {
                sm.syn[i][j] = static_cast<uint8_t>(i < n ? p : 0u);
                if (i < n) p = gf_mul(mul, p, x);
            }
        } else if (t >= 128 && t < 192) {
            const int i = t - 128;
            sm.fc[i] = static_cast<uint8_t>(
                i < n ? gf_mul(mul, sm.tab[RS_TAB_XINV + i],
                               sm.tab[RS_TAB_XFCR + i]) : 0u);
        }
    }
    __syncthreads();
    RS_SPAN(0);
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int ia = lane, ib = lane + 32;        // this lane's two positions
    const bool pa = ia < n, pb = ib < n;
    const int j0 = 2 * lane, j1 = 2 * lane + 1;  // and two coefficients
    const bool c0 = j0 <= nroots, c1 = j1 <= nroots;
    uint8_t* wd = sm.word[w];
    uint16_t* sy = sm.sy[w];
    uint8_t* lm = sm.lam[w];
    uint16_t* lo = sm.lo[w];

    // the warp's trials: a contiguous share of the C T, so that a
    // candidate's syndromes serve all its trials in the share (32-bit
    // indices: a 64-bit division would be a call, whose saved registers
    // spill)
    const unsigned total = static_cast<unsigned>(d.C) * d.T;
    const unsigned warps = gridDim.x * RS_WARPS;
    const unsigned gw = blockIdx.x * RS_WARPS + w;
    const unsigned per = total / warps, rem = total % warps;
    const unsigned m0 = gw * per + (gw < rem ? gw : rem);
    const unsigned m1 = m0 + per + (gw < rem ? 1u : 0u);
    unsigned c = m0 / static_cast<unsigned>(d.T);
    unsigned t = m0 - c * static_cast<unsigned>(d.T);
    unsigned c_row = 0xffffffffu;
    uint32_t ra = 0, rb = 0, s0 = 0, s1 = 0;

    for (unsigned m = m0; m < m1; ++m) {
        if (c != c_row) {
            // the candidate's row and its syndromes S_j = sum_i r_i
            // alpha^((fcr + j) deg_i), j = j0 and j1 (r_i the same in
            // every lane: one wavefront a product)
            const int64_t* row = syms + static_cast<long long>(c) * n;
            ra = pa ? static_cast<uint32_t>(row[ia]) & 63u : 0u;
            rb = pb ? static_cast<uint32_t>(row[ib]) & 63u : 0u;
            __syncwarp();
            wd[ia] = static_cast<uint8_t>(ra);
            wd[ib] = static_cast<uint8_t>(rb);
            __syncwarp();
            s0 = 0;
            s1 = 0;
            for (int i = 0; i < n; ++i) {
                const uint32_t r = wd[i];
                const uint32_t pair = *reinterpret_cast<const uint16_t*>(
                    &sm.syn[i][j0]);
                s0 ^= gf_mul(mul, r, pair & 63u);
                s1 ^= gf_mul(mul, r, pair >> 8);
            }
            // sy [x + 1] = S_(x - 1) | S_x << 8 (S_-1 = S_64 = 0)
            const uint32_t sm1 = __shfl_up_sync(FULL, s1, 1);
            sy[j0 + 1] = static_cast<uint16_t>((lane ? sm1 : 0u) | (s0 << 8));
            sy[j1 + 1] = static_cast<uint16_t>(s0 | (s1 << 8));
            if (lane == 0) sy[0] = 0;
            c_row = c;
        }
        RS_SPAN(1);
        const uint8_t* er = era + static_cast<long long>(m) * n;
        const unsigned ea = __ballot_sync(FULL, pa && er[ia] != 0);
        const unsigned eb = __ballot_sync(FULL, pb && er[ib] != 0);
        const int no_eras = __popc(ea) + __popc(eb);

        // erasure locator prod (1 + X_i x) over the erased positions in
        // ascending order (X_i the same in every lane), nroots + 1
        // coefficients kept: coefficient k takes only lower ones, so the
        // coefficients past nroots are dropped once, at the end
        uint32_t l0 = lane == 0 ? 1u : 0u, l1 = 0u;
        for (int half = 0; half < 2; ++half) {
            unsigned mask = half ? eb : ea;
            while (mask) {
                const int i = __ffs(mask) - 1 + 32 * half;
                mask &= mask - 1;
                const uint32_t x = sm.tab[RS_TAB_XI + i];
                uint32_t prev = __shfl_up_sync(FULL, l1, 1);
                if (lane == 0) prev = 0;
                l1 ^= gf_mul(mul, x, l0);
                l0 ^= gf_mul(mul, x, prev);
            }
        }
        if (!c0) l0 = 0;
        if (!c1) l1 = 0;
        __syncwarp();
        RS_SPAN(2);

        // Berlekamp-Massey with erasures (Karn's decode_rs recursion), the
        // rounds r > no_eras
        {
            uint32_t b0 = l0, b1 = l1;
            int el = no_eras;
            for (int r = no_eras + 1; r <= nroots; ++r) {
                // discrepancy: XOR over i < r of lambda_i S_(r-1-i): x = r
                // - 1 - j0, sy [x + 1] = S_(x-1) (j1's) | S_x << 8 (j0's)
                uint32_t part = 0;
                if (j0 <= r - 1) {
                    const uint32_t v = sy[r - j0];
                    part = gf_mul(mul, l0, v >> 8) ^ gf_mul(mul, l1, v & 63u);
                }
                const uint32_t dd = __reduce_xor_sync(FULL, part);
                uint32_t bs0 = __shfl_up_sync(FULL, b1, 1);
                if (lane == 0 || !c0) bs0 = 0;
                const uint32_t bs1 = c1 ? b0 : 0u;
                const uint32_t t0 = l0 ^ gf_mul(mul, dd, bs0);
                const uint32_t t1 = l1 ^ gf_mul(mul, dd, bs1);
                if (dd != 0 && 2 * el <= (r - 1) + no_eras) {
                    const uint32_t id = inv[dd];
                    b0 = gf_mul(mul, id, l0);
                    b1 = gf_mul(mul, id, l1);
                    el = r + no_eras - el;
                } else {
                    b0 = bs0;
                    b1 = bs1;
                }
                l0 = t0;
                l1 = t1;
            }
        }
        lm[j0] = static_cast<uint8_t>(l0);
        lm[j1] = static_cast<uint8_t>(l1);
        __syncwarp();
        RS_SPAN(3);

        // Omega = S Lambda mod x^nroots: omega_j = XOR over i <= j of
        // lambda_i S_(j-i), j = j0 and j1 (lambda_i the same in every lane)
        uint32_t o0 = 0, o1 = 0;
        for (int i = 0; i < nroots; ++i) {
            const uint32_t li = lm[i];
            if (li == 0 || i > j1) continue;
            // sy [j1 - i + 1] = S_(j0-i) (0 at i = j1) | S_(j1-i) << 8
            const uint32_t v = sy[j1 - i + 1];
            o0 ^= gf_mul(mul, li, v & 63u);
            o1 ^= gf_mul(mul, li, v >> 8);
        }
        if (j0 >= nroots) o0 = 0;
        if (j1 >= nroots) o1 = 0;
        lo[j0] = static_cast<uint16_t>(l0 | (o0 << 8));
        lo[j1] = static_cast<uint16_t>(l1 | (o1 << 8));
        __syncwarp();
        RS_SPAN(4);

        // Lambda's even and odd terms and Omega at X_i^-1 of positions ia
        // and ib, each term lambda_k (X_i^-1)^k (lambda_k the same in every
        // lane); Lambda' X_i^-1 is the odd terms' sum, so Forney's
        // Omega / Lambda' X_i^(1 - fcr) is Omega / odd x fc_i
        uint32_t ea0 = 0, oa0 = 0, wa0 = 0, eb0 = 0, ob0 = 0, wb0 = 0;
        for (int k = 0; k <= nroots; k += 2) {
            // k's and k + 1's coefficients a broadcast
            const uint32_t vv = reinterpret_cast<const uint32_t*>(lo)[k >> 1];
            const uint32_t v = vv & 0xffffu;
            if (v != 0) {
                const uint32_t pk = sm.pw[k][lane];
                const uint32_t pka = pk & 63u, pkb = pk >> 8;
                const uint32_t lk = v & 63u, ok_ = v >> 8;
                ea0 ^= gf_mul(mul, lk, pka);
                eb0 ^= gf_mul(mul, lk, pkb);
                wa0 ^= gf_mul(mul, ok_, pka);
                wb0 ^= gf_mul(mul, ok_, pkb);
            }
            const uint32_t u = k + 1 <= nroots ? vv >> 16 : 0u;
            if (u != 0) {
                const uint32_t pk = sm.pw[k + 1][lane];
                const uint32_t pka = pk & 63u, pkb = pk >> 8;
                const uint32_t lk = u & 63u, ok_ = u >> 8;
                oa0 ^= gf_mul(mul, lk, pka);
                ob0 ^= gf_mul(mul, lk, pkb);
                wa0 ^= gf_mul(mul, ok_, pka);
                wb0 ^= gf_mul(mul, ok_, pkb);
            }
        }
        const uint32_t maga = gf_mul(mul, gf_mul(mul, wa0, inv[oa0]), sm.fc[ia]);
        const uint32_t magb = gf_mul(mul, gf_mul(mul, wb0, inv[ob0]), sm.fc[ib]);
        const uint32_t fa = pa && (ea0 ^ oa0) == 0 ? ra ^ maga : ra;
        const uint32_t fb = pb && (eb0 ^ ob0) == 0 ? rb ^ magb : rb;
        RS_SPAN(5);

        // the corrected word's syndromes are S(r) XOR S(e), e = the
        // changes: they must all vanish (e_i the same in every lane)
        const uint32_t da = fa ^ ra, db = fb ^ rb;
        uint32_t z0 = s0, z1 = s1;
        for (int half = 0; half < 2; ++half) {
            unsigned mask = __ballot_sync(FULL, (half ? db : da) != 0);
            while (mask) {
                const int src = __ffs(mask) - 1;
                mask &= mask - 1;
                const uint32_t e = __shfl_sync(FULL, half ? db : da, src);
                const uint32_t pair = *reinterpret_cast<const uint16_t*>(
                    &sm.syn[src + 32 * half][j0]);
                z0 ^= gf_mul(mul, e, pair & 63u);
                z1 ^= gf_mul(mul, e, pair >> 8);
            }
        }
        const bool bad = __any_sync(FULL, (z0 | z1) != 0);
        uint8_t* out = corrected + static_cast<long long>(m) * n;
        if (pa) out[ia] = static_cast<uint8_t>(fa);
        if (pb) out[ib] = static_cast<uint8_t>(fb);
        if (lane == 0) ok[m] = bad ? 0 : 1;
        if (++t == static_cast<unsigned>(d.T)) {
            t = 0;
            ++c;
        }
        RS_SPAN(6);
    }
    RS_SPAN_END();
}

}  // namespace

extern "C" {

int weak_beam_w_min() { return BEAM_W_MIN; }
int weak_beam_w_max() { return BEAM_W_MAX; }
int weak_beam_steps() { return BEAM_STEPS; }
int weak_rs_n_max() { return RS_N_MAX; }
int weak_rs_table_bytes() { return RS_TAB_BYTES; }

// Dynamic shared memory bytes of wspr_beam at beam width w and plan k, or
// -1.
int wspr_beam_smem_bytes(int w, int k) {
    return with_plan(w, k, -1, [](auto cw, auto ck) {
        return static_cast<int>(
            BeamSmem<decltype(cw)::value, decltype(ck)::value>::bytes);
    });
}

// The wspr_beam blocks an SM holds at beam width w and plan k
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its shared memory),
// or a negative cudaError_t.
int wspr_beam_blocks_per_sm(int w, int k) {
    int blocks = 0;
    const int e = with_plan(w, k, static_cast<int>(cudaErrorInvalidValue),
                            [&](auto cw, auto ck) {
        constexpr int W = decltype(cw)::value, K = decltype(ck)::value;
        const int err = beam_smem_attr<W, K>();
        if (err != 0) return err;
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, k_wspr_beam<W, K>, BeamPlan<W, K>::T,
            BeamSmem<W, K>::bytes));
    });
    return e != 0 ? -e : blocks;
}

// Beam search of n candidates at width w in plan k: llr [n, 81, 2] float32
// (positive = coded bit 0) to best [n] float32 (the best path's raw
// metric) and bits [n, 50] int8, on `stream`, one launch.  Returns the
// cudaError_t.
int wspr_beam_launch(int n, int w, int k, const void* llr, void* best,
                     void* bits, void* stream) {
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    return with_plan(w, k, static_cast<int>(cudaErrorInvalidValue),
                     [&](auto cw, auto ck) {
        return launch_beam<decltype(cw)::value, decltype(ck)::value>(
            n, static_cast<const float*>(llr), static_cast<float*>(best),
            static_cast<int8_t*>(bits), static_cast<cudaStream_t>(stream));
    });
}

// The rs_ee blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or a negative cudaError_t.
int rs_ee_blocks_per_sm() {
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, k_rs_ee, RS_THREADS, 0);
    return e != cudaSuccess ? -static_cast<int>(e) : blocks;
}

// Errors-and-erasures decode of C x T < 2**31 trials: trial (c, t) is the
// word syms [c] (int64, values taken mod 64) with the erasure flags era
// [c, t] (bool); corrected [C, T, n] uint8 and ok [C, T] bool (all the
// corrected word's syndromes zero), on `stream`, one launch of at most as
// many blocks as the card holds at once, each warp a contiguous share of
// the trials.  dims [4]: C, T, n, nroots; tables: the RS_TAB_BYTES table
// block.  Returns the cudaError_t.
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
// = wspr_beam at width w in plan k, 1 = rs_ee.  out [4].  Returns the
// cudaError_t.
int weak_kernel_attrs(int which, int w, int k, int* out) {
    cudaFuncAttributes a;
    int e = static_cast<int>(cudaErrorInvalidValue);
    if (which == 0)
        e = with_plan(w, k, e, [&](auto cw, auto ck) {
            return static_cast<int>(cudaFuncGetAttributes(
                &a, k_wspr_beam<decltype(cw)::value, decltype(ck)::value>));
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
