// Burst subtraction and the coherent multi-symbol LLRs of the GFSK decode
// (FT8, FT4, JS8, FST4, FST4W), each as one wrapper call with no host sync.
//
// subtract replaces the XLA program cwsl_digi_tpu/modes/subtract.py:71
// subtract_known (a while_loop over the known bursts); its plain PyTorch
// version, cwsl_digi_tpu_torch/modes/subtract.py:subtract_known_plain,
// makes ~700 launches a burst (nine reference-order cumsums of ~70 launches
// each) and syncs with the host once a burst.  llr replaces
// cwsl_digi_tpu/modes/gfsk_engine.py:161 _multisym_llrs; its plain version,
// gfsk_engine.py:_multisym_llrs_plain, splits the candidates into chunks
// and materializes [m, n_data, T, T, T] (T^4 with coh4) float32 several
// times a chunk.
//
// What bounds them on an H100.
//
//   - subtract at the FT8 path's 64 windows reads the audio and writes the
//     residual once (~92 MB, ~0.03 ms of HBM), and computes per sample and
//     burst two syntheses (a 4-tap pulse sum, a cumsum, cos and sin), two
//     correlation cumsums and the twist (cos and sin again): ~170 float
//     operations with range-reduced trig counted as 20 each, ~0.26 ms at
//     the FP32 rate without FMA (--fmad=false) for FT8's 343 fitted bursts
//     (2 to 6 a window).  Operations bound it: the phase passes 1e5 rad,
//     where sincosf takes its slow argument reduction.  What costs besides
//     is the chain: each burst's fit needs the whole span's cumsums before
//     its next stage, and each window's bursts run in order.  The first
//     design issued each stage of each burst step as its own launch over
//     every window (1 + 10 M launches for M burst slots, ten a step even
//     after every window had run out of bursts), half of them grids of one
//     block a window; a thread block cluster a window for the whole call
//     (the stages between the span-wide passes repeated in each block,
//     barrier.cluster in place of the launches) measured slower still on
//     the H100: with 16 blocks a window the windows queue for the card,
//     with 4 the span-wide passes crawl.
//   - llr at FT8's 12,288 candidates reads 62 MB of symbol spectra and
//     writes 8.5 MB (~0.021 ms); its ~4,300 operations per (candidate, data
//     symbol) over the 512 triples take ~0.09 ms at the FP32 rate without
//     FMA: operations bound it.
//
// The design.
//
//   - subtract: one launch a call, of as many blocks as the card holds at
//     once (a cooperative launch; 4 a SM at 64 registers a thread), every
//     block a worker for the whole call, after a memset of the work queue.
//     A burst step is five span-wide passes (phase, correlation, phase,
//     correlation, subtraction), each cut into tasks of one span block
//     (4096 samples: 38 a pass at FT8, 5,283 at FST4-1800).  A window's
//     pass is opened by appending the window to the queue; blocks take
//     the open passes' span blocks in the order the passes were opened
//     (a count of taken span blocks per window), and the block that
//     finishes a pass's last span block (a count of finished ones) runs
//     what lies between that pass and the next, alone and at once: the
//     scan of the 38 V3 sums after a phase pass, the estimate after a
//     correlation pass, the next burst's tones after the subtraction; then
//     it opens the window's next pass.  So windows never wait on each
//     other, no block waits on a barrier while there is work, and a window
//     ends after its own last valid burst (valid bursts come first,
//     select_subtract_params), which is the reference's while_loop
//     exactly, since an invalid burst subtracts zero there: no empty step
//     runs.  A window's state, tones, gains and phase scan live in global
//     memory; writes are fenced before the counts that publish them, and
//     data other blocks wrote is read with __ldcg, past the L1.
//   - The reference's cumsum order is a fixed tree (subtract.py _cumsum):
//     sequential float32 adds within blocks of 16, the block totals scanned
//     the same way, each block's exclusive prefix added last.  A thread
//     owns one level-0 block of 16 samples: its sequential sum is V1, a
//     span block's 16 V1 sums (sequential) are V2 and its 16 V2 sums V3,
//     one V3 entry a span block.  The small stage after a pass scans V3 in
//     the tree's order (tree_scan); a span block's level-1 prefixes are
//     made once for the block (block_prefix: the 17 level-2 prefixes it
//     needs, then each thread's E + W from V1 staged in shared memory),
//     and the estimators' prefixes at the symbol boundaries are the tree's
//     E + W read back from V1, V2 and the scan (p1_point).  So the phase,
//     and the per-symbol correlations read at the symbol boundaries, round
//     exactly as the plain version's, whichever block takes a span block;
//     the library is built with --fmad=false, so no product and sum
//     contract into an FMA.  The phase is never stored: the subtraction
//     pass rebuilds it from the same sums.
//   - sincosf and atan2f are CUDA's, with full range reduction (the phase
//     reaches ~2.4e5 rad in an FT8 burst, ~1e7 at FST4-1800), within 2 ulp
//     of the CPU's; one sincosf an angle gives the bits of separate sinf
//     and cosf calls (gfsk_trig_differ checks it on the card).  The shift
//     rounds half to even (rintf) as torch.round.  The estimators' short
//     per-symbol sums are warp reductions in their own order, so dt, df1
//     and df2 may differ from the plain version's in the last bits.
//   - llr: one block per candidate, one thread per data symbol; the
//     symbol's 3 (or 5) neighbour rows and the T x T cross terms stay in
//     registers, and each window's terms are summed in the plain version's
//     order (e1p + e1s + e1n + x_ps + x_sn + x_pn) so that near-equal
//     maxima pick alike.  The per-candidate peak and std-3 scaling are a
//     block reduction in the same launch: one launch a call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false -o libgfsk.so gfsk.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN = 16;               // the reference cumsum's block
constexpr int SPAN_THREADS = 256;      // level-0 blocks of a span block
constexpr int CHUNK = SPAN_THREADS * SCAN;   // samples of one V3 entry
constexpr int SUB_MAX_SYM = 256;
constexpr int SUB_MAX_INFO = 128;
constexpr int SUB_MAX_PAR = 256;
constexpr int SUB_MAX_BURSTS = 64;
constexpr int SUB_MIN_BLOCKS = 4;      // k_subtract blocks an SM (64 registers)
constexpr int SUB_MAX_LEVELS = 12;
constexpr int MOV_TMP = 64;            // tree_scan scratch of n_sym + 7
constexpr int LLR_MAX_DATA = 128;
constexpr int LLR_MAX_BPS = 3;
constexpr int GAIN_SMOOTH = 7;         // subtract.py GAIN_SMOOTH_SYMS
constexpr unsigned FULL = 0xffffffffu;

// the five span-wide passes of a burst step
enum { P_PHASE0, P_CORR0, P_PHASE1, P_CORR1, P_APPLY, N_PASSES };
// the work queue's counts (SubBufs::q)
enum { Q_HEAD, Q_TAIL, Q_DONE, Q_N };

struct SubDims {
    int B, T, row, hop, sps, n_sym, S, L, n_blk_seg, margin, nb_pad;
    int k_info, n_par, n_data, bps, m_bursts, n_tones;
    int n1, n2, n3, scan_tmp;
    float c_hmod, c_w, bin_hz, c_df, two_pi, t_sym, c_den, sr, sps_f;
};

struct SubBufs {
    float* res;
    const int32_t* params;
    const float* gen_par;
    const float* pulse;
    const float* templ;
    const int32_t* data_idx;
    const int32_t* gray;
    float *ph_v1, *ph_v2, *ph_v3;      // level sums of the phase increments
    float *cr_v1, *cr_v2, *cr_v3;      // ... of the correlation products
    float *ci_v1, *ci_v2, *ci_v3;
    float *bw_re, *bw_im;              // within-block sums at the symbols
    float* ph_p3;                      // [B, n3] the phase's scan of V3
    float *v3c, *sc_p3, *scan_tmp;     // [B, ...] a small stage's scan
    float *tones, *g_re, *g_im;        // [B, n_sym] each window's burst
    struct WinState* win;              // [B]
    int32_t* entries;         // the queue: window + 1 of each opened pass,
                              // 0 past the tail (queue_len: one spare)
    unsigned *next, *done;    // [B] span blocks taken / finished this pass
    unsigned* q;              // [Q_N] head and tail of the queue, windows done
    int32_t* shifts;          // [B, m_bursts] or null: each step's shift
};

// A window's burst step as its current pass needs it: written by the block
// that runs the window's small stage, read by the blocks that take its
// span blocks.
struct WinState {
    int mi, pass, fine, m, start0, blk1, start1;
    float f0, cf, cdf2;
};

// A block's copy of the window it works on (its tones, gains and fit),
// the estimator's per-symbol arrays and the span passes' staging.
struct SubShared {
    WinState ws;
    int task_w, task_c, last;
    float tones[SUB_MAX_SYM], g_re[SUB_MAX_SYM], g_im[SUB_MAX_SYM];
    float par[SUB_MAX_PAR];
    float vr[SUB_MAX_SYM + 1], vi[SUB_MAX_SYM + 1];
    float cr[SUB_MAX_SYM], ci[SUB_MAX_SYM], pr[SUB_MAX_SYM], pi[SUB_MAX_SYM];
    float ta[SUB_MAX_SYM], tb[SUB_MAX_SYM], tc[SUB_MAX_SYM];
    float xp[SUB_MAX_SYM + GAIN_SMOOTH], cs[SUB_MAX_SYM + GAIN_SMOOTH];
    float mov_tmp[MOV_TMP];
    float ms[3][SUB_MAX_SYM];
    float v1s[SPAN_THREADS], v2s[SCAN];
    float st1[SPAN_THREADS + SCAN], st2[2 * SCAN], p2s[SCAN + 1];
    float sums[3];
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// floats of tree_scan's scratch for n values: each level above, twice
__host__ __device__ inline int tree_tmp(int n) {
    int t = 0;
    while (n > SCAN) {
        n = ceil_div(n, SCAN);
        t += 2 * n;
    }
    return t;
}

// Inclusive cumsum of v[0, n) into p in the reference's tree order, by one
// block (every thread calls it; it ends on a barrier).  tmp holds the
// levels above (tree_tmp(n) floats).
__device__ void tree_scan(const float* v, int n, float* p, float* tmp) {
    const float* lv[SUB_MAX_LEVELS];
    float* pl[SUB_MAX_LEVELS];
    int sz[SUB_MAX_LEVELS];
    int top = 0;
    lv[0] = v;
    pl[0] = p;
    sz[0] = n;
    float* t = tmp;
    while (sz[top] > SCAN && top + 1 < SUB_MAX_LEVELS) {
        const int nn = ceil_div(sz[top], SCAN);
        ++top;
        sz[top] = nn;
        lv[top] = t;
        t += nn;
        pl[top] = t;
        t += nn;
    }
    // up: each level's block totals, padded with zeros as the reference
    for (int l = 0; l < top; ++l) {
        float* out = const_cast<float*>(lv[l + 1]);
        for (int k = threadIdx.x; k < sz[l + 1]; k += blockDim.x) {
            const float* x = lv[l] + k * SCAN;
            const int cnt = sz[l] - k * SCAN;
            float s = x[0];
            for (int i = 1; i < SCAN; ++i) s = s + (i < cnt ? x[i] : 0.f);
            out[k] = s;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {             // the top level: sequential
        float s = lv[top][0];
        pl[top][0] = s;
        for (int i = 1; i < sz[top]; ++i) {
            s = s + lv[top][i];
            pl[top][i] = s;
        }
    }
    __syncthreads();
    // down: exclusive prefix of the level above + sequential within-block
    for (int l = top - 1; l >= 0; --l) {
        for (int i = threadIdx.x; i < sz[l]; i += blockDim.x) {
            const int blk = i / SCAN;
            const float e = blk == 0 ? 0.f : pl[l + 1][blk - 1];
            const float* x = lv[l] + blk * SCAN;
            float w = x[0];
            for (int k = blk * SCAN + 1; k <= i; ++k) w = w + lv[l][k];
            pl[l][i] = e + w;
        }
        __syncthreads();
    }
}

// The scan P3 of a window's V3 row (written by other blocks, read past the
// L1 into the window's copy v3c) into p3; ends on a barrier.
__device__ void scan_v3(const SubDims& d, const SubBufs& b, int w,
                        const float* v3, float* p3) {
    float* v3c = b.v3c + static_cast<size_t>(w) * d.n3;
    for (int i = threadIdx.x; i < d.n3; i += blockDim.x)
        v3c[i] = __ldcg(v3 + i);
    __syncthreads();
    tree_scan(v3c, d.n3, p3, b.scan_tmp + static_cast<size_t>(w) * d.scan_tmp);
}

// The tree's inclusive prefix at level 2 (index i of V2) and level 1
// (index i of V1), from V1, V2 and the scan P3 of V3.  Levels 1 and 2 hold
// more than 16 values (S > CHUNK), so each is E + W.
// The sequential sum of v[base], ..., v[base + cnt] (cnt < SCAN), its
// loads issued together.
__device__ __forceinline__ float seq_part(const float* v, int base, int cnt) {
    float x[SCAN];
#pragma unroll
    for (int k = 0; k < SCAN; ++k) x[k] = k <= cnt ? __ldcg(v + base + k) : 0.f;
    float w = x[0];
#pragma unroll
    for (int k = 1; k < SCAN; ++k)
        if (k <= cnt) w = w + x[k];
    return w;
}

__device__ float p2_point(const float* v2, const float* p3, int i) {
    const int blk = i / SCAN;
    const float e = blk == 0 ? 0.f : p3[blk - 1];
    return e + seq_part(v2, blk * SCAN, i - blk * SCAN);
}

__device__ float p1_point(const float* v1, const float* v2, const float* p3,
                          int i) {
    const int blk = i / SCAN;
    const float e = blk == 0 ? 0.f : p2_point(v2, p3, blk - 1);
    return e + seq_part(v1, blk * SCAN, i - blk * SCAN);
}

// Each thread's exclusive level-1 prefix (p1 at its V1 index j - 1, 0 for
// j = 0) in span block c, made once for the block: the V1 and V2 entries
// it needs staged in shared memory, the 17 level-2 prefixes by 17 threads
// (from the window's scan P3, in global memory), then each thread's E + W.
// The same operations in the same order as p1_point, so the same bits.
__device__ float block_prefix(const SubDims& d, SubShared& sh,
                              const float* v1, const float* v2,
                              const float* p3, int c) {
    const int t = threadIdx.x;
    const int j0 = c * SPAN_THREADS - SCAN;     // first staged V1 index
    const int q0 = c * SCAN - SCAN;             // first staged V2 index
    for (int k = t; k < SPAN_THREADS + SCAN; k += blockDim.x) {
        const int j = j0 + k;
        sh.st1[k] = (j >= 0 && j < d.n1) ? __ldcg(v1 + j) : 0.f;
    }
    if (t < 2 * SCAN) {
        const int q = q0 + t;
        sh.st2[t] = (q >= 0 && q < d.n2) ? __ldcg(v2 + q) : 0.f;
    }
    __syncthreads();
    if (t <= SCAN) {                            // p2 at q = 16 c - 2 + t
        const int q = c * SCAN - 2 + t;
        float r = 0.f;
        if (q >= 0) {
            const int blk = q / SCAN;
            const float e = blk == 0 ? 0.f : __ldcg(p3 + blk - 1);
            const float* x = sh.st2 + (blk * SCAN - q0);
            float w = x[0];
            for (int k = 1; k <= q - blk * SCAN; ++k) w = w + x[k];
            r = e + w;
        }
        sh.p2s[t] = r;
    }
    __syncthreads();
    const int j = c * SPAN_THREADS + t;
    float e0 = 0.f;
    if (j > 0 && j < d.n1) {
        const int i = j - 1, blk = i / SCAN;
        const float e = blk == 0 ? 0.f : sh.p2s[blk - 1 - (c * SCAN - 2)];
        const float* x = sh.st1 + (blk * SCAN - j0);
        float w = x[0];
        for (int k = 1; k <= i - blk * SCAN; ++k) w = w + x[k];
        e0 = e + w;
    }
    return e0;
}

// Synthesis phase increment at span sample u (subtract.py synth): the
// 4-tap pulse sum over the padded tones, then the carrier term cf.
__device__ __forceinline__ float dphi_at(const SubDims& d, const SubBufs& b,
                                         const float* tones, int u, int fine,
                                         float cf) {
    const int q = u / d.sps;
    const int r = u - q * d.sps;
    float acc = 0.f;
#pragma unroll
    for (int dd = -1; dd <= 2; ++dd) {
        int idx = (3 - dd) * d.sps + r - fine;
        idx = min(max(idx, 0), 5 * d.sps - 1);
        const int ti = q + dd + 1;        // t_pad = [0, t0, tones, t_last, 0]
        float tp;
        if (ti == 0 || ti == d.n_sym + 3) tp = 0.f;
        else if (ti == 1) tp = tones[0];
        else if (ti == d.n_sym + 2) tp = tones[d.n_sym - 1];
        else tp = tones[ti - 2];
        acc = acc + tp * b.pulse[idx];
    }
    return acc * d.c_hmod + cf;
}

// V1 (each thread's), V2 and V3 of span block c from the threads' level-0
// block sums, into the window's rows.
__device__ void span_levels(const SubDims& d, SubShared& sh, float s,
                            float* v1, float* v2, float* v3, int c) {
    const int j = c * SPAN_THREADS + threadIdx.x;
    sh.v1s[threadIdx.x] = s;
    if (j < d.n1) v1[j] = s;
    __syncthreads();
    if (threadIdx.x < SCAN) {
        const float* x = sh.v1s + threadIdx.x * SCAN;
        float s2 = x[0];
        for (int k = 1; k < SCAN; ++k) s2 = s2 + x[k];
        sh.v2s[threadIdx.x] = s2;
        const int q = c * SCAN + threadIdx.x;
        if (q < d.n2) v2[q] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s3 = sh.v2s[0];
        for (int k = 1; k < SCAN; ++k) s3 = s3 + sh.v2s[k];
        v3[c] = s3;
    }
}

// The sum of x[0, n) by one warp (lane-strided sums, then a butterfly:
// every lane ends with the same value).
__device__ float warp_sum(const float* x, int n) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) s = s + x[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(FULL, s, o);
    return s;
}

// sh.sums[k] = the sum of xs[k][0, n) for k < cnt, by warp k; ends on a
// barrier.
__device__ void group_sums(SubShared& sh, const float* const* xs, int cnt,
                           int n) {
    const int warp = threadIdx.x >> 5;
    if (warp < cnt) {
        const float s = warp_sum(xs[warp], n);
        if ((threadIdx.x & 31) == 0) sh.sums[warp] = s;
    }
    __syncthreads();
}

// movsum over GAIN_SMOOTH symbols (subtract.py movsum): the tree cumsum of
// x padded with 4 zeros before and 3 after, differenced 7 apart.
__device__ void movsum(SubShared& sh, const float* x, int n, float* out) {
    const int half = GAIN_SMOOTH / 2;
    for (int i = threadIdx.x; i < n + GAIN_SMOOTH; i += blockDim.x)
        sh.xp[i] = (i > half && i <= half + n) ? x[i - half - 1] : 0.f;
    __syncthreads();
    tree_scan(sh.xp, n + GAIN_SMOOTH, sh.cs, sh.mov_tmp);
    for (int s = threadIdx.x; s < n; s += blockDim.x)
        out[s] = sh.cs[s + GAIN_SMOOTH] - sh.cs[s];
    __syncthreads();
}

// The window's state and burst (tones; the gains at the subtraction) into
// this block's shared memory; ends on a barrier.
__device__ void load_window(const SubDims& d, const SubBufs& b, SubShared& sh,
                            int w, bool gains) {
    const size_t o = static_cast<size_t>(w) * d.n_sym;
    for (int s = threadIdx.x; s < d.n_sym; s += blockDim.x) {
        sh.tones[s] = __ldcg(b.tones + o + s);
        if (gains) {
            sh.g_re[s] = __ldcg(b.g_re + o + s);
            sh.g_im[s] = __ldcg(b.g_im + o + s);
        }
    }
    if (threadIdx.x == 0) {
        const volatile WinState* ws = b.win + w;
        sh.ws.mi = ws->mi;
        sh.ws.pass = ws->pass;
        sh.ws.fine = ws->fine;
        sh.ws.m = ws->m;
        sh.ws.start0 = ws->start0;
        sh.ws.blk1 = ws->blk1;
        sh.ws.start1 = ws->start1;
        sh.ws.f0 = ws->f0;
        sh.ws.cf = ws->cf;
        sh.ws.cdf2 = ws->cdf2;
    }
    __syncthreads();
}

// Open the window's next pass (state and burst already written): reset its
// counts, then append it to the queue.  Every thread calls it.
__device__ void open_pass(const SubBufs& b, SubShared& sh, int w) {
    if (threadIdx.x == 0) b.win[w] = sh.ws;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicExch(b.done + w, 0u);
        __threadfence();
        atomicExch(b.next + w, 0u);
        const unsigned t = atomicAdd(b.q + Q_TAIL, 1u);
        atomicExch(reinterpret_cast<unsigned*>(b.entries) + t,
                   static_cast<unsigned>(w + 1));
    }
    __syncthreads();
}

// Burst sh.ws.mi of window w: its tones from the info bits and the first
// pass's alignment, then its first pass opened; or, past the window's last
// valid burst, the window counted done.
__device__ void burst_setup(const SubDims& d, const SubBufs& b, SubShared& sh,
                            int w) {
    const int mi = sh.ws.mi;
    const int32_t* p = b.params
        + (static_cast<size_t>(w) * d.m_bursts + mi) * (d.k_info + 3);
    if (mi >= d.m_bursts || p[d.k_info + 2] == 0) {
        if (threadIdx.x == 0) atomicAdd(b.q + Q_DONE, 1u);
        return;
    }
    for (int j = threadIdx.x; j < d.n_par; j += blockDim.x) {
        float acc = 0.f;               // exact: sums of 0/1 products
        for (int i = 0; i < d.k_info; ++i)
            acc = acc + static_cast<float>(p[i]) * b.gen_par[i * d.n_par + j];
        sh.par[j] = fmodf(acc, 2.f);
    }
    for (int s = threadIdx.x; s < d.n_sym; s += blockDim.x)
        sh.tones[s] = b.templ[s];
    if (threadIdx.x == 0) {
        const int t0 = p[d.k_info];
        sh.ws.pass = P_PHASE0;
        sh.ws.start0 = t0 * d.hop;
        sh.ws.fine = 0;
        sh.ws.m = min(max(t0 + d.margin, 0), d.nb_pad - d.n_blk_seg);
        sh.ws.f0 = static_cast<float>(p[d.k_info + 1]) * d.bin_hz;
        sh.ws.cf = d.c_w * sh.ws.f0;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < d.n_data; k += blockDim.x) {
        int v = 0;
        for (int bb = 0; bb < d.bps; ++bb) {
            const int c = k * d.bps + bb;
            const float bit = c < d.k_info ? static_cast<float>(p[c])
                                           : sh.par[c - d.k_info];
            v = 2 * v + static_cast<int>(bit);
        }
        sh.tones[b.data_idx[k]] = static_cast<float>(b.gray[v]);
    }
    __syncthreads();
    const size_t o = static_cast<size_t>(w) * d.n_sym;
    for (int s = threadIdx.x; s < d.n_sym; s += blockDim.x)
        b.tones[o + s] = sh.tones[s];
    open_pass(b, sh, w);
}

// Span block c of a phase pass: the level sums of the phase increments.
__device__ void phase_chunk(const SubDims& d, const SubBufs& b, SubShared& sh,
                            int w, int c) {
    const int fine = sh.ws.fine;
    const float cf = sh.ws.cf;
    const int j = c * SPAN_THREADS + threadIdx.x;
    float s = 0.f;
    for (int i = 0; i < SCAN; ++i) {
        const int u = j * SCAN + i;
        const float x = u < d.S ? dphi_at(d, b, sh.tones, u, fine, cf) : 0.f;
        s = i == 0 ? x : s + x;
    }
    span_levels(d, sh, s, b.ph_v1 + static_cast<size_t>(w) * d.n1,
                b.ph_v2 + static_cast<size_t>(w) * d.n2,
                b.ph_v3 + static_cast<size_t>(w) * d.n3, c);
}

// Span block c of a correlation pass: the masked reference cos/sin at the
// pass's alignment, its products with the extracted span and their level
// sums; the within-block prefix at each symbol boundary fine + sps*k - 1.
__device__ void corr_chunk(const SubDims& d, const SubBufs& b, SubShared& sh,
                           int w, int c) {
    const int fine = sh.ws.fine;
    const float cf = sh.ws.cf;
    const size_t w1 = static_cast<size_t>(w) * d.n1;
    const size_t w2 = static_cast<size_t>(w) * d.n2;
    const size_t w3 = static_cast<size_t>(w) * d.n3;
    const float* seg = b.res + static_cast<size_t>(w) * d.row
        + static_cast<size_t>(sh.ws.m) * d.hop;
    float* bw_re = b.bw_re + w * (d.n_sym + 1);
    float* bw_im = b.bw_im + w * (d.n_sym + 1);
    const float e0 = block_prefix(d, sh, b.ph_v1 + w1, b.ph_v2 + w2,
                                  b.ph_p3 + w3, c);
    const int j = c * SPAN_THREADS + threadIdx.x;
    float wr = 0.f, wi = 0.f, wp = 0.f;
    for (int i = 0; i < SCAN; ++i) {
        const int u = j * SCAN + i;
        float ar = 0.f, ai = 0.f;
        if (u < d.S) {
            const float x = dphi_at(d, b, sh.tones, u, fine, cf);
            wp = i == 0 ? x : wp + x;
            const float mk = (u >= fine && u < fine + d.L) ? 1.f : 0.f;
            float sn, cs;
            sincosf(e0 + wp, &sn, &cs);
            const float zr = cs * mk;
            const float zi = sn * mk;
            const float sg = __ldcg(seg + u);
            ar = sg * zr;
            ai = (-sg) * zi;
        }
        wr = i == 0 ? ar : wr + ar;
        wi = i == 0 ? ai : wi + ai;
        if (u < d.S) {
            const int bp = u + 1 - fine;
            if (bp >= 0 && bp % d.sps == 0 && bp / d.sps <= d.n_sym) {
                bw_re[bp / d.sps] = wr;
                bw_im[bp / d.sps] = wi;
            }
        }
    }
    span_levels(d, sh, wr, b.cr_v1 + w1, b.cr_v2 + w2, b.cr_v3 + w3, c);
    __syncthreads();
    span_levels(d, sh, wi, b.ci_v1 + w1, b.ci_v2 + w2, b.ci_v3 + w3, c);
}

// Span block c of the subtraction: the second pass's reference twisted by
// df2, times the gain of its symbol, masked to the window.
__device__ void apply_chunk(const SubDims& d, const SubBufs& b, SubShared& sh,
                            int w, int c) {
    const int fine = sh.ws.fine, blk1 = sh.ws.blk1;
    const float cf = sh.ws.cf, cdf2 = sh.ws.cdf2;
    const size_t w1 = static_cast<size_t>(w) * d.n1;
    const size_t w2 = static_cast<size_t>(w) * d.n2;
    float* seg = b.res + static_cast<size_t>(w) * d.row
        + static_cast<size_t>(sh.ws.m) * d.hop;
    const float e0 = block_prefix(d, sh, b.ph_v1 + w1, b.ph_v2 + w2,
                                  b.ph_p3 + static_cast<size_t>(w) * d.n3, c);
    const int j = c * SPAN_THREADS + threadIdx.x;
    float wp = 0.f;
    for (int i = 0; i < SCAN; ++i) {
        const int u = j * SCAN + i;
        if (u >= d.S) continue;
        const float x = dphi_at(d, b, sh.tones, u, fine, cf);
        wp = i == 0 ? x : wp + x;
        const float mk = (u >= fine && u < fine + d.L) ? 1.f : 0.f;
        float sn, cs;
        sincosf(e0 + wp, &sn, &cs);
        const float zr = cs * mk;
        const float zi = sn * mk;
        const float th2 = cdf2 * (static_cast<float>(u) + 1.f);
        float st, ct;
        sincosf(th2, &st, &ct);
        const float zr2 = zr * ct - zi * st;
        const float zi2 = zi * ct + zr * st;
        const int q = u / d.sps;
        const int r = u - q * d.sps;
        const int gk = r >= fine ? q : q - 1;   // gain_pad index - 1
        const bool gin = gk >= 0 && gk < d.n_sym;
        const float ar = gin ? sh.g_re[gk] : 0.f;
        const float ai = gin ? sh.g_im[gk] : 0.f;
        float sub = ar * zr2 - ai * zi2;
        const long long pos = static_cast<long long>(blk1) * d.hop + u;
        sub = sub * ((pos >= 0 && pos < d.T) ? 1.f : 0.f);
        seg[u] = __ldcg(seg + u) - sub;
    }
}

// The per-symbol correlations of the current pass, then pass 0: df1 and
// dt, the refined start and the second pass's alignment; pass 1: df2 and
// the smoothed complex gain.  Into sh (the caller stores the window).
__device__ void estimate(const SubDims& d, const SubBufs& b, SubShared& sh,
                         int w, int pass) {
    const int n_sym = d.n_sym;
    const int fine = sh.ws.fine;
    const size_t w1 = static_cast<size_t>(w) * d.n1;
    const size_t w2 = static_cast<size_t>(w) * d.n2;
    const size_t w3 = static_cast<size_t>(w) * d.n3;
    // the cumsums at the boundaries fine + sps*k - 1 (0 where that is < 0)
    for (int part = 0; part < 2; ++part) {
        const float* v1 = (part ? b.ci_v1 : b.cr_v1) + w1;
        const float* v2 = (part ? b.ci_v2 : b.cr_v2) + w2;
        const float* bw = (part ? b.bw_im : b.bw_re) + w * (n_sym + 1);
        float* out = part ? sh.vi : sh.vr;
        float* p3 = b.sc_p3 + w3;
        scan_v3(d, b, w, (part ? b.ci_v3 : b.cr_v3) + w3, p3);
        for (int k = threadIdx.x; k <= n_sym; k += blockDim.x) {
            const int bpos = fine + d.sps * k;
            float a = 0.f;
            if (bpos > 0) {
                const int blk = (bpos - 1) / SCAN;
                const float e = blk > 0 ? p1_point(v1, v2, p3, blk - 1) : 0.f;
                a = e + __ldcg(bw + k);
            }
            out[k] = a;
        }
        __syncthreads();
    }
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x) {
        sh.cr[s] = sh.vr[s + 1] - sh.vr[s];
        sh.ci[s] = sh.vi[s + 1] - sh.vi[s];
    }
    __syncthreads();
    // df from same-tone pairs (df_same)
    const float* tn = sh.tones;
    const int np = n_sym - 1;
    for (int s = threadIdx.x; s < np; s += blockDim.x) {
        const float p_r = sh.cr[s + 1] * sh.cr[s] + sh.ci[s + 1] * sh.ci[s];
        const float p_i = sh.ci[s + 1] * sh.cr[s] - sh.cr[s + 1] * sh.ci[s];
        const float same = (tn[s + 1] - tn[s]) == 0.f ? 1.f : 0.f;
        sh.pr[s] = p_r;
        sh.pi[s] = p_i;
        sh.ta[s] = p_r * same;
        sh.tb[s] = p_i * same;
        sh.tc[s] = same;
    }
    __syncthreads();
    {
        const float* xs[3] = {sh.ta, sh.tb, sh.tc};
        group_sums(sh, xs, 3, np);
    }
    const float df_raw = atan2f(sh.sums[1], sh.sums[0]) / d.c_df;
    const float df = (sh.sums[2] > 0.f && fabsf(df_raw) < d.bin_hz) ? df_raw
                                                                      : 0.f;
    __syncthreads();                 // sums read before they are reused
    if (pass == 0) {
        // dt from tone-change pairs, df1 removed analytically
        const float ang = d.two_pi * df * d.t_sym;
        for (int s = threadIdx.x; s < np; s += blockDim.x) {
            const float dtone = tn[s + 1] - tn[s];
            const float adt = fabsf(dtone);
            const float sel = (adt >= 1.f && adt <= 3.f) ? 1.f : 0.f;
            float th = atan2f(sh.pi[s], sh.pr[s]) - ang;
            float sn, cs;
            sincosf(th, &sn, &cs);
            th = atan2f(sn, cs);
            const float wgt = sqrtf(sh.pr[s] * sh.pr[s] + sh.pi[s] * sh.pi[s])
                * sel;
            sh.ta[s] = wgt * dtone * dtone;
            sh.tb[s] = wgt * th * dtone;
        }
        __syncthreads();
        const float* xs[2] = {sh.ta, sh.tb};
        group_sums(sh, xs, 2, np);
        if (threadIdx.x == 0) {
            const float den = d.c_den * sh.sums[0];
            const float dt = sh.sums[1] / fmaxf(den, 1e-20f);
            int shift = static_cast<int>(rintf(dt * d.sr));
            shift = min(max(shift, -(d.sps - 1)), d.sps - 1);
            const int start1 = sh.ws.start0 - shift;
            const int blk1 = start1 >= 0 ? start1 / d.hop
                                         : -ceil_div(-start1, d.hop);
            if (b.shifts) b.shifts[w * d.m_bursts + sh.ws.mi] = shift;
            sh.ws.fine = start1 - blk1 * d.hop;
            sh.ws.m = min(max(blk1 + d.margin, 0), d.nb_pad - d.n_blk_seg);
            sh.ws.blk1 = blk1;
            sh.ws.start1 = start1;
            sh.ws.cf = d.c_w * (sh.ws.f0 + df);
        }
        __syncthreads();
        return;
    }
    // pass 1: the gain, each correlation twisted by df2 at its symbol centre
    const float cdf2 = d.c_w * df;
    const int start1 = sh.ws.start1;
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x) {
        const float uc = static_cast<float>(fine)
            + (static_cast<float>(s) + 0.5f) * d.sps_f;
        const float thc = cdf2 * (uc + 1.f);
        float sc, cc;
        sincosf(thc, &sc, &cc);
        sh.ta[s] = sh.cr[s] * cc + sh.ci[s] * sc;
        sh.tb[s] = sh.ci[s] * cc - sh.cr[s] * sc;
        const int lo = start1 + s * d.sps;
        sh.tc[s] = static_cast<float>(min(max(lo + d.sps, 0), d.T)
                                      - min(max(lo, 0), d.T));
    }
    __syncthreads();
    movsum(sh, sh.tc, n_sym, sh.ms[0]);
    movsum(sh, sh.ta, n_sym, sh.ms[1]);
    movsum(sh, sh.tb, n_sym, sh.ms[2]);
    const size_t o = static_cast<size_t>(w) * n_sym;
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x) {
        const float den = fmaxf(sh.ms[0][s], 1.f);
        b.g_re[o + s] = 2.f * sh.ms[1][s] / den;
        b.g_im[o + s] = 2.f * sh.ms[2][s] / den;
    }
    if (threadIdx.x == 0) sh.ws.cdf2 = cdf2;
    __syncthreads();
}

// What follows a window's pass once its last span block is done, by the
// block that did that span block: after a phase pass the scan of its V3;
// after a correlation pass the estimate; after the subtraction the next
// burst's setup (or the window done).  Then the next pass is opened.
__device__ void small_stage(const SubDims& d, const SubBufs& b, SubShared& sh,
                            int w) {
    load_window(d, b, sh, w, false);
    const int pass = sh.ws.pass;
    if (pass == P_PHASE0 || pass == P_PHASE1) {
        const size_t w3 = static_cast<size_t>(w) * d.n3;
        scan_v3(d, b, w, b.ph_v3 + w3, b.ph_p3 + w3);
    } else if (pass == P_CORR0 || pass == P_CORR1) {
        estimate(d, b, sh, w, pass == P_CORR0 ? 0 : 1);
    } else {
        __syncthreads();
        if (threadIdx.x == 0) ++sh.ws.mi;
        __syncthreads();
        burst_setup(d, b, sh, w);
        return;
    }
    __syncthreads();
    if (threadIdx.x == 0) ++sh.ws.pass;
    __syncthreads();
    open_pass(b, sh, w);
}

// The next span block to work on: the head of the queue's window's next
// untaken one (an entry is used up once all its window's span blocks of
// the pass are taken), or -1 once every window is done.  The head stops at
// the tail, whose entry is 0 until a pass is opened there: the queue has
// one entry more than a call can open, so when every window opens all its
// passes the head still reads a 0.  Thread 0.
__device__ void take_task(const SubDims& d, const SubBufs& b, int* w_out,
                          int* c_out) {
    volatile unsigned* q = b.q;
    const volatile int32_t* entries = b.entries;
    unsigned nap = 32;                  // ns; doubles while the queue is empty
    for (;;) {
        const unsigned h = q[Q_HEAD];
        const int e = entries[h];
        if (e == 0) {                   // nothing open beyond the head
            if (q[Q_DONE] >= static_cast<unsigned>(d.B)) {
                *w_out = -1;
                return;
            }
            __nanosleep(nap);
            nap = min(2 * nap, 2048u);
            continue;
        }
        const int w = e - 1;
        const unsigned k = atomicAdd(b.next + w, 1u);
        if (k < static_cast<unsigned>(d.n3)) {
            __threadfence();
            *w_out = w;
            *c_out = static_cast<int>(k);
            return;
        }
        atomicCAS(b.q + Q_HEAD, h, h + 1);
    }
}

// The whole subtraction in one launch: every block a worker for the whole
// call.  Each window's first burst is set up and its first pass opened;
// then each block takes span blocks of open passes off the queue, in the
// order the passes were opened, and the block that finishes a pass's last
// span block runs the window's small stage and opens its next pass.
// Windows never wait on each other, and a window ends after its last valid
// burst.  A launch of every block the card holds at once (cooperative),
// since blocks wait on the queue.
__global__ void __launch_bounds__(SPAN_THREADS, SUB_MIN_BLOCKS)
k_subtract(SubDims d, SubBufs b) {
    __shared__ SubShared sh;
    for (int w = blockIdx.x; w < d.B; w += gridDim.x) {
        if (threadIdx.x == 0) sh.ws.mi = 0;
        __syncthreads();
        burst_setup(d, b, sh, w);
        __syncthreads();
    }
    for (;;) {
        if (threadIdx.x == 0) take_task(d, b, &sh.task_w, &sh.task_c);
        __syncthreads();
        const int w = sh.task_w, c = sh.task_c;
        if (w < 0) break;
        const int pass = __ldcg(&b.win[w].pass);
        load_window(d, b, sh, w, pass == P_APPLY);
        if (pass == P_PHASE0 || pass == P_PHASE1) phase_chunk(d, b, sh, w, c);
        else if (pass == P_APPLY) apply_chunk(d, b, sh, w, c);
        else corr_chunk(d, b, sh, w, c);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0)
            sh.last = atomicAdd(b.done + w, 1u) + 1 == static_cast<unsigned>(d.n3);
        __syncthreads();
        if (sh.last) {
            __threadfence();
            small_stage(d, b, sh, w);
        }
        __syncthreads();
    }
}

// Count of x[i] whose sincosf differs in any bit from sinf and cosf (each
// argument read twice through volatile, so that the compiler cannot merge
// the two calls into one).
__global__ void k_trig_differ(const float* x, int n, int* n_differ) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const volatile float* xv = x;
    const float a = xv[i], c = xv[i];
    float s1, c1;
    sincosf(x[i], &s1, &c1);
    if (__float_as_uint(s1) != __float_as_uint(sinf(a))
        || __float_as_uint(c1) != __float_as_uint(cosf(c)))
        atomicAdd(n_differ, 1);
}

// ---------------------------------------------------------------------------
// Coherent multi-symbol LLRs

struct C2 {
    float x, y;
};

__device__ __forceinline__ C2 cmul(C2 a, C2 b) {
    return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}

// 2 Re(conj(a) * w), w = rr * b already formed
__device__ __forceinline__ float cross(C2 a, C2 w) {
    return 2.f * (a.x * w.x + a.y * w.y);
}

template <int T>
__device__ __forceinline__ void load_row(const C2* c, int k, int n_sym,
                                         C2 (&o)[T]) {
#pragma unroll
    for (int t = 0; t < T; ++t)
        o[t] = (k >= 0 && k < n_sym) ? c[k * T + t] : C2{0.f, 0.f};
}

// max over tones with bit b of the tone's Gray value 0, minus max over 1
template <int T>
__device__ __forceinline__ float bit_llr(const float (&f)[T], int mask0) {
    float m0 = -1e30f, m1 = -1e30f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
        if ((mask0 >> t) & 1) m0 = fmaxf(m0, f[t]);
        else m1 = fmaxf(m1, f[t]);
    }
    return m0 - m1;
}

template <int T>
__device__ __forceinline__ void table(const C2 (&a)[T], const C2 (&b)[T],
                                      C2 rr, float (&x)[T][T]) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
        const C2 wj = cmul(rr, b[j]);
#pragma unroll
        for (int i = 0; i < T; ++i) x[i][j] = cross(a[i], wj);
    }
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int k = 0; k < (blockDim.x >> 5); ++k) s += red[k];
    return s;
}

__device__ float block_max(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = red[0];
    for (int k = 1; k < (blockDim.x >> 5); ++k) s = fmaxf(s, red[k]);
    return s;
}

template <int T, bool COH4>
__global__ void __launch_bounds__(LLR_MAX_DATA)
k_llr(const float* __restrict__ csym, const float* __restrict__ rot,
      const float* __restrict__ bitmaps, const int32_t* __restrict__ data,
      const uint8_t* __restrict__ allow, float* __restrict__ out, int n_sym,
      int n_data, int bps) {
    __shared__ float red[LLR_MAX_DATA / 32];
    const int mc = blockIdx.x, d = threadIdx.x;
    const bool on = d < n_data;
    float l[LLR_MAX_BPS] = {0.f, 0.f, 0.f};
    if (on) {
        const C2* c = reinterpret_cast<const C2*>(csym)
            + static_cast<size_t>(mc) * n_sym * T;
        const C2 r = reinterpret_cast<const C2*>(rot)[mc];
        const C2 r2 = cmul(r, r);
        const int s = data[d];
        const int ap = allow[d], an = allow[n_data + d];
        int mask0[LLR_MAX_BPS];
        for (int bb = 0; bb < bps; ++bb) {
            int mk = 0;
            for (int t = 0; t < T; ++t)
                mk |= (bitmaps[bb * T + t] < 0.5f ? 1 : 0) << t;
            mask0[bb] = mk;
        }
        C2 cp[T], cs[T], cn[T];
        load_row<T>(c, s - 1, n_sym, cp);
        load_row<T>(c, s, n_sym, cs);
        load_row<T>(c, s + 1, n_sym, cn);
        float e1p[T], e1s[T], e1n[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            e1p[t] = cp[t].x * cp[t].x + cp[t].y * cp[t].y;
            e1s[t] = cs[t].x * cs[t].x + cs[t].y * cs[t].y;
            e1n[t] = cn[t].x * cn[t].x + cn[t].y * cn[t].y;
        }
        float x_ps[T][T], x_sn[T][T], x_pn[T][T];
        table<T>(cp, cs, r, x_ps);
        table<T>(cs, cn, r, x_sn);
        table<T>(cp, cn, r2, x_pn);
        float e2p[T], e2n[T], e3[T];
#pragma unroll
        for (int j = 0; j < T; ++j) {
            float g = -1e30f;
#pragma unroll
            for (int i = 0; i < T; ++i)
                if ((ap >> i) & 1) g = fmaxf(g, e1p[i] + x_ps[i][j]);
            e2p[j] = e1s[j] + g;
        }
#pragma unroll
        for (int i = 0; i < T; ++i) {
            float g = -1e30f;
#pragma unroll
            for (int j = 0; j < T; ++j)
                if ((an >> j) & 1) g = fmaxf(g, e1n[j] + x_sn[i][j]);
            e2n[i] = e1s[i] + g;
        }
#pragma unroll
        for (int sm = 0; sm < T; ++sm) {
            float g = -1e30f;
#pragma unroll
            for (int p = 0; p < T; ++p) {
                if (!((ap >> p) & 1)) continue;
                const float a = e1p[p] + e1s[sm];
#pragma unroll
                for (int n = 0; n < T; ++n) {
                    if (!((an >> n) & 1)) continue;
                    g = fmaxf(g, a + e1n[n] + x_ps[p][sm] + x_sn[sm][n]
                                     + x_pn[p][n]);
                }
            }
            e3[sm] = g;
        }
        for (int bb = 0; bb < bps; ++bb)
            l[bb] = bit_llr<T>(e1s, mask0[bb]) + bit_llr<T>(e2p, mask0[bb])
                + bit_llr<T>(e2n, mask0[bb]) + bit_llr<T>(e3, mask0[bb]);
        if constexpr (COH4) {
            const int ap2 = allow[2 * n_data + d], an2 = allow[3 * n_data + d];
            const C2 r3 = cmul(r2, r);
            float e4n[T], e4p[T];
            {
                C2 cn2[T];
                load_row<T>(c, s + 2, n_sym, cn2);
                float e1n2[T];
#pragma unroll
                for (int t = 0; t < T; ++t)
                    e1n2[t] = cn2[t].x * cn2[t].x + cn2[t].y * cn2[t].y;
                float x_p_nn[T][T], x_s_nn[T][T], x_n_nn[T][T];
                table<T>(cp, cn2, r3, x_p_nn);
                table<T>(cs, cn2, r2, x_s_nn);
                table<T>(cn, cn2, r, x_n_nn);
                // window [s-1, s, s+1, s+2]: axes (p, self, n, q)
#pragma unroll
                for (int sm = 0; sm < T; ++sm) {
                    float g = -1e30f;
                    for (int p = 0; p < T; ++p) {
                        if (!((ap >> p) & 1)) continue;
                        for (int n = 0; n < T; ++n) {
                            if (!((an >> n) & 1)) continue;
                            const float a = e1p[p] + e1s[sm] + e1n[n];
                            for (int q = 0; q < T; ++q) {
                                if (!((an2 >> q) & 1)) continue;
                                g = fmaxf(g, a + e1n2[q] + x_ps[p][sm]
                                                 + x_pn[p][n] + x_p_nn[p][q]
                                                 + x_sn[sm][n] + x_s_nn[sm][q]
                                                 + x_n_nn[n][q]);
                            }
                        }
                    }
                    e4n[sm] = g;
                }
            }
            {
                C2 cp2[T];
                load_row<T>(c, s - 2, n_sym, cp2);
                float e1p2[T];
#pragma unroll
                for (int t = 0; t < T; ++t)
                    e1p2[t] = cp2[t].x * cp2[t].x + cp2[t].y * cp2[t].y;
                float x_pp_p[T][T], x_pp_s[T][T], x_pp_n[T][T];
                table<T>(cp2, cp, r, x_pp_p);
                table<T>(cp2, cs, r2, x_pp_s);
                table<T>(cp2, cn, r3, x_pp_n);
                // window [s-2, s-1, s, s+1]: axes (q2, p, self, n)
#pragma unroll
                for (int sm = 0; sm < T; ++sm) {
                    float g = -1e30f;
                    for (int q2 = 0; q2 < T; ++q2) {
                        if (!((ap2 >> q2) & 1)) continue;
                        for (int p = 0; p < T; ++p) {
                            if (!((ap >> p) & 1)) continue;
                            const float a = e1p2[q2] + e1p[p] + e1s[sm];
                            for (int n = 0; n < T; ++n) {
                                if (!((an >> n) & 1)) continue;
                                g = fmaxf(g, a + e1n[n] + x_pp_p[q2][p]
                                                 + x_pp_s[q2][sm]
                                                 + x_pp_n[q2][n] + x_ps[p][sm]
                                                 + x_pn[p][n] + x_sn[sm][n]);
                            }
                        }
                    }
                    e4p[sm] = g;
                }
            }
            for (int bb = 0; bb < bps; ++bb)
                l[bb] = l[bb] + bit_llr<T>(e4n, mask0[bb])
                    + bit_llr<T>(e4p, mask0[bb]);
        }
    }
    // per candidate: divide by the peak |LLR|, then scale to std 3
    float pk = 0.f;
    for (int bb = 0; bb < bps; ++bb) pk = fmaxf(pk, fabsf(l[bb]));
    const float peak = block_max(on ? pk : 0.f, red);
    float sum = 0.f;
    for (int bb = 0; bb < bps; ++bb) {
        l[bb] = l[bb] / (peak + 1e-20f);
        sum += l[bb];
    }
    const float nb = static_cast<float>(n_data * bps);
    const float mean = block_sum(on ? sum : 0.f, red) / nb;
    float sq = 0.f;
    for (int bb = 0; bb < bps; ++bb) sq += (l[bb] - mean) * (l[bb] - mean);
    const float sd = sqrtf(block_sum(on ? sq : 0.f, red) / nb);
    if (on) {
        float* o = out + static_cast<size_t>(mc) * n_data * bps + d * bps;
        for (int bb = 0; bb < bps; ++bb) o[bb] = l[bb] / (sd + 1e-20f) * 3.f;
    }
}

SubDims make_dims(const int* di, const float* df) {
    SubDims d;
    d.B = di[0];
    d.T = di[1];
    d.row = di[2];
    d.hop = di[3];
    d.sps = di[4];
    d.n_sym = di[5];
    d.S = di[6];
    d.L = di[7];
    d.n_blk_seg = di[8];
    d.margin = di[9];
    d.nb_pad = di[10];
    d.k_info = di[11];
    d.n_par = di[12];
    d.n_data = di[13];
    d.bps = di[14];
    d.m_bursts = di[15];
    d.n_tones = di[16];
    d.n1 = ceil_div(d.S, SCAN);
    d.n2 = ceil_div(d.n1, SCAN);
    d.n3 = ceil_div(d.n2, SCAN);
    d.scan_tmp = tree_tmp(d.n3);
    d.c_hmod = df[0];
    d.c_w = df[1];
    d.bin_hz = df[2];
    d.c_df = df[3];
    d.two_pi = df[4];
    d.t_sym = df[5];
    d.c_den = df[6];
    d.sr = df[7];
    d.sps_f = df[8];
    return d;
}

bool dims_ok(const SubDims& d) {
    return d.B >= 1 && d.B <= 65535 && d.T >= 1 && d.hop >= 1
        && d.sps >= 1 && d.n_sym >= 2 && d.n_sym <= SUB_MAX_SYM
        && d.S > CHUNK && d.S == (d.n_sym + 1) * d.sps && d.L == d.n_sym * d.sps
        && d.row == d.nb_pad * d.hop && d.k_info >= 1
        && d.k_info <= SUB_MAX_INFO && d.n_par >= 0 && d.n_par <= SUB_MAX_PAR
        && d.n_data >= 1 && d.n_data <= d.n_sym && d.bps >= 1
        && d.n_data * d.bps <= d.k_info + d.n_par && d.m_bursts >= 1
        && d.m_bursts <= SUB_MAX_BURSTS && (1 << d.bps) <= d.n_tones
        && d.n3 <= 2147483647 / SCAN;
}

// scratch floats (per window) in the order make_bufs carves them
long long sub_floats_per_window(const SubDims& d) {
    return 2LL * (d.n_sym + 1) + 3LL * (d.n1 + d.n2 + d.n3) + 3LL * d.n3
        + d.scan_tmp + 3LL * d.n_sym
        + static_cast<long long>(sizeof(WinState) / 4);
}

// entries of the queue: one for each pass a window may open, and a last
// one that stays 0, so that a head past every opened pass reads "empty"
long long queue_len(const SubDims& d) {
    return static_cast<long long>(d.B) * d.m_bursts * N_PASSES + 1;
}

// scratch int32s: the queue, each window's two counts, the queue's counts
long long sub_ints(const SubDims& d) {
    return queue_len(d) + 2LL * d.B + Q_N;
}

SubBufs make_bufs(const SubDims& d, float* f, int32_t* si) {
    SubBufs b{};
    const size_t B = static_cast<size_t>(d.B);
    auto take = [&](size_t n) {
        float* p = f;
        f += n;
        return p;
    };
    b.bw_re = take(B * (d.n_sym + 1));
    b.bw_im = take(B * (d.n_sym + 1));
    float** sets[3][3] = {{&b.ph_v1, &b.ph_v2, &b.ph_v3},
                          {&b.cr_v1, &b.cr_v2, &b.cr_v3},
                          {&b.ci_v1, &b.ci_v2, &b.ci_v3}};
    for (auto& s : sets) {
        *s[0] = take(B * d.n1);
        *s[1] = take(B * d.n2);
        *s[2] = take(B * d.n3);
    }
    b.ph_p3 = take(B * d.n3);
    b.v3c = take(B * d.n3);
    b.sc_p3 = take(B * d.n3);
    b.scan_tmp = take(B * d.scan_tmp);
    b.tones = take(B * d.n_sym);
    b.g_re = take(B * d.n_sym);
    b.g_im = take(B * d.n_sym);
    b.win = reinterpret_cast<WinState*>(take(B * (sizeof(WinState) / 4)));
    b.entries = si;
    si += queue_len(d);
    b.next = reinterpret_cast<unsigned*>(si);
    b.done = b.next + B;
    b.q = b.done + B;
    return b;
}

// The blocks of a call: n_blocks, or (0) every block the card holds at
// once, but no more than there are span blocks in a pass of every window.
// Returns a cudaError_t.
cudaError_t plan_subtract(const SubDims& d, int n_blocks, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, k_subtract, SPAN_THREADS, 0);
    if (err != cudaSuccess) return err;
    const int cap = per_sm * sms;       // co-resident blocks
    if (cap < 1 || n_blocks < 0 || n_blocks > cap)
        return cudaErrorCooperativeLaunchTooLarge;
    const long long tasks = static_cast<long long>(d.B) * d.n3;
    *blocks = n_blocks ? n_blocks
                       : static_cast<int>(tasks < cap ? tasks : cap);
    return cudaSuccess;
}

}  // namespace

extern "C" {

int gfsk_sub_max_bursts() { return SUB_MAX_BURSTS; }
int gfsk_sub_max_sym() { return SUB_MAX_SYM; }
int gfsk_sub_max_info() { return SUB_MAX_INFO; }
int gfsk_sub_max_par() { return SUB_MAX_PAR; }
int gfsk_sub_chunk() { return CHUNK; }
int gfsk_llr_max_data() { return LLR_MAX_DATA; }

// Scratch a call needs: floats and int32s; -1 when the dims are refused.
long long gfsk_sub_scratch(const int* dims, const float* consts,
                           long long* n_int) {
    const SubDims d = make_dims(dims, consts);
    if (!dims_ok(d)) return -1;
    *n_int = sub_ints(d);
    return static_cast<long long>(d.B) * sub_floats_per_window(d);
}

// Subtract every window's known bursts from res [B, row] in place, on
// `stream`: a memset of the work queue and one cooperative launch of
// n_blocks blocks (0: every block the card holds at once; the wrapper
// passes 0, the card's tests fewer, to show that the residual does not
// depend on them), no host sync.
// shifts, if not null, is [B, m_bursts] int32 and takes each fitted step's
// integer time shift.  Returns the first cudaError_t (0 = success).
int gfsk_subtract_launch(const int* dims, const float* consts, void* res,
                         const void* params, const void* gen_par,
                         const void* pulse, const void* templ,
                         const void* data_idx, const void* gray,
                         void* scratch_f, void* scratch_i, void* shifts,
                         void* stream, int n_blocks) {
    const SubDims d = make_dims(dims, consts);
    if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
    int blocks = 0;
    cudaError_t err = plan_subtract(d, n_blocks, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    SubBufs b = make_bufs(d, static_cast<float*>(scratch_f),
                          static_cast<int32_t*>(scratch_i));
    b.res = static_cast<float*>(res);
    b.params = static_cast<const int32_t*>(params);
    b.gen_par = static_cast<const float*>(gen_par);
    b.pulse = static_cast<const float*>(pulse);
    b.templ = static_cast<const float*>(templ);
    b.data_idx = static_cast<const int32_t*>(data_idx);
    b.gray = static_cast<const int32_t*>(gray);
    b.shifts = static_cast<int32_t*>(shifts);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(scratch_i, 0, sub_ints(d) * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(SPAN_THREADS);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, k_subtract, d, b);
    if (err == cudaSuccess) err = cudaGetLastError();
    return static_cast<int>(err);
}

// Whether sincosf gives the bits of sinf and cosf: x [n] float32 on the
// card; returns (through *n_differ, device memory) how many x differ.
// One launch on `stream`.
int gfsk_trig_differ(const void* x, int n, void* n_differ, void* stream) {
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(n_differ, 0, sizeof(int), st);
    if (err == cudaSuccess) {
        k_trig_differ<<<ceil_div(n, 256), 256, 0, st>>>(
            static_cast<const float*>(x), n, static_cast<int*>(n_differ));
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// Coherent LLRs of m candidates on `stream`: csym [m, n_sym, n_tones]
// complex64 as float pairs, rot [m] complex64, bitmaps [bps, n_tones]
// float32, data [n_data] int32 symbol indices, allow [4, n_data] uint8
// masks of the tones a previous / next / second previous / second next
// neighbour may hold; out [m, n_data * bps] float32.  One launch.
int gfsk_llr_launch(const void* csym, const void* rot, const void* bitmaps,
                    const void* data, const void* allow, void* out, int m,
                    int n_sym, int n_tones, int bps, int n_data, int coh4,
                    void* stream) {
    if (m < 1 || n_sym < 1 || n_data < 1 || n_data > LLR_MAX_DATA || bps < 2
        || bps > LLR_MAX_BPS || (1 << bps) > n_tones
        || !(n_tones == 4 || n_tones == 8) || (coh4 && n_tones != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = ceil_div(n_data, 32) * 32;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* c = static_cast<const float*>(csym);
    const float* r = static_cast<const float*>(rot);
    const float* bm = static_cast<const float*>(bitmaps);
    const int32_t* di = static_cast<const int32_t*>(data);
    const uint8_t* al = static_cast<const uint8_t*>(allow);
    float* o = static_cast<float*>(out);
    if (n_tones == 8)
        k_llr<8, false><<<m, threads, 0, st>>>(c, r, bm, di, al, o, n_sym,
                                               n_data, bps);
    else if (coh4)
        k_llr<4, true><<<m, threads, 0, st>>>(c, r, bm, di, al, o, n_sym,
                                              n_data, bps);
    else
        k_llr<4, false><<<m, threads, 0, st>>>(c, r, bm, di, al, o, n_sym,
                                               n_data, bps);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
