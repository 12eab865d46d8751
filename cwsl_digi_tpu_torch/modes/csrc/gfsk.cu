// Burst subtraction and the coherent multi-symbol LLRs of the GFSK decode
// (FT8, FT4, JS8, FST4, FST4W), each as one wrapper call with no host sync.
//
// subtract replaces the XLA program cwsl_digi_tpu/modes/subtract.py:71
// subtract_known (a while_loop over the known bursts); its plain PyTorch
// version, cwsl_digi_tpu_torch/modes/subtract.py:subtract_known_plain,
// makes ~700 launches a burst (nine reference-order cumsums of ~70 launches
// each) and syncs with the host once a burst.  llr replaces
// cwsl_digi_tpu/modes/gfsk_engine.py:161 _multisym_llrs together with the
// candidates' block gather (:492-516, a relayout and a dynamic_slice) and
// their rotation (:555-579, with the sync-pair frequency correction); its
// plain versions are gfsk_engine.py:candidate_llrs_plain (from the demod
// spectrogram) and _multisym_llrs_plain (from gathered csym), which split
// the candidates into chunks and materialize [m, n_data, T, T, T] (T^4 with
// coh4) float32 several times a chunk.
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
//   - llr at FT8's 12,288 candidates reads each candidate's 79 x 8 cells of
//     the demod spectrogram once (62 MB) and writes 8.5 MB of LLRs
//     (~0.021 ms of HBM); its ~4,300 operations per (candidate, data
//     symbol) over the 512 triples take ~0.09 ms at the FP32 rate without
//     FMA: operations bound it.  The first design (one thread a data
//     symbol, its three 8 x 8 cross tables in registers) issued about as
//     many instructions but spilled and idled 6 of 64 lanes, 0.297 ms; and
//     the glue that fed it (a padded copy of the half-hop spectrogram,
//     0.7 GB a 24-window FT8 call, a fancy-index gather into csym, the
//     rotation's small launches) took ~0.9 ms more of device time a call.
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
//   - llr: one launch from the demod spectrogram to the scaled LLRs, a
//     block of 128 threads a candidate (8 blocks an SM at 64 registers, no
//     spill).  The block stages the candidate's [n_sym, T] cells in shared
//     memory once, at the plain version's strided indices with its clamps
//     (0 where the plain version reads the padding), and their |C|^2 (|C|
//     correctly rounded, then squared, as torch's abs() ** 2); warp 0 forms
//     the rotation: exp(-2j pi abs_bin / os_f) from f0 with sincosf (in the
//     kernel, not passed in: the sync-pair fold makes the final rotation
//     independent of it but for rounding, and every spot list of the
//     smoke is unchanged), then the fold, rot * exp(-1j angle(z * rot)),
//     z the sum over the sync pairs of conj(c_s) c_s+1 (a lane's pairs in
//     order, the lanes' sums as a tree: not torch's order, within
//     LLR_TOL).  Then 128 / T groups of T lanes take a data symbol each a
//     round, lane sm its middle tone sm: its column of x_ps and row of
//     x_sn in registers, its row of x_pn (with coh4 of the four other
//     shared tables) into the group's shared memory, the next row times r
//     and r^2 shared a tone a lane; a neighbour tone the sync cells rule
//     out enters as -inf, so the windows through it never win (as the
//     plain version's -1e30), with no branch.  Each window's terms are
//     summed in the plain version's order (e1p + e1s + e1n + x_ps + x_sn
//     + x_pn, and the 4-symbol windows'), maxima in any order (max is
//     exact), so near-equal maxima pick alike; the bit maxima are taken by
//     lane pairs (tones with bit b 0 and 1) and subtracted by a shuffle.
//     Warp 0 scales the candidate's LLRs by its peak and to std 3.  The
//     csym entry (multisym_llrs) is the same kernel on csym read as M
//     spectrograms of n_sym hops and T bins, hop and bin 0, rot given.
//     What is left is instructions issued, about 2x the operations the
//     bound counts (the per-lane tables and the bit maxima).
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
constexpr int LLR_MAX_SYM = 256;
constexpr int LLR_MAX_BPS = 3;
constexpr int LLR_THREADS = 128;       // a candidate's block: 128 / T groups
constexpr int LLR_BLOCKS_PER_SM = 8;   // at 64 registers a thread (4 with
                                       // coh4's 4-symbol windows)
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
// Coherent multi-symbol LLRs, from the demod spectrogram

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

// |c| ** 2 as the plain version rounds it: |c| correctly rounded (the
// double square root of the exact float products' sum, as glibc's hypotf),
// then squared in float32
__device__ __forceinline__ float mag2(C2 c) {
    const double re = c.x, im = c.y;
    const float m = static_cast<float>(sqrt(re * re + im * im));
    return m * m;
}

__device__ __forceinline__ int floor_div(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

struct LlrDims {
    int B, K, H, F;          // spectrogram [B, H, F], K candidates a window
    int n_sym, n_data, bps;
    int os_t, os_f;          // hop and bin strides between symbols / tones
    int fmin_bin;            // absolute bin of spectrogram bin 0
    int n_pairs;             // sync pairs folded into the rotation (0: none)
};

struct LlrArgs {
    const C2* spec;          // [B, H, F]
    const int64_t* tt;       // [B, K] start hop (null: 0)
    const int64_t* f0;       // [B, K] start bin (null: 0)
    const C2* rot;           // [B * K] given rotation (null: from f0)
    const float* bitmaps;    // [bps, T]
    const int32_t* data;     // [n_data] symbol indices
    const uint8_t* allow;    // [4, n_data] tone masks of the neighbours
    const int32_t* pairs;    // [n_pairs, 3]: symbol, its tone, next's tone
    float* out;              // [B * K, n_data * bps]
};

// A group's shared memory, in floats: its T x T tables (x_pn; with coh4
// also x_p_nn, x_n_nn, x_pp_p, x_pp_n) padded so that the groups of a warp
// start in other banks, the next row times r and r^2 (a float4 a tone),
// and the metrics of each tone (one float4, two with coh4)
template <int T, bool COH4>
__host__ __device__ constexpr int llr_tab_floats() {
    return (COH4 ? 5 : 1) * T * T + 4;
}

// floats a tone's metrics take (e1s, e2p, e2n, e3; with coh4 e4n, e4p)
template <bool COH4>
__host__ __device__ constexpr int llr_met_stride() {
    return COH4 ? 8 : 4;
}

template <int T, bool COH4>
__host__ __device__ constexpr int llr_group_floats() {
    return llr_tab_floats<T, COH4>() + 4 * T + llr_met_stride<COH4>() * T;
}

// the block's cells and their |C|^2, the groups', the candidate's LLRs
template <int T, bool COH4>
__host__ __device__ inline int llr_smem_bytes(int n_sym, int n_bits) {
    return n_sym * T * 12
        + (LLR_THREADS / T) * llr_group_floats<T, COH4>() * 4 + n_bits * 4;
}

// a row of the staged block (zeros outside the candidate's symbols)
template <int T>
__device__ __forceinline__ void cell_row(const C2* blk, int k, int n_sym,
                                         C2 (&o)[T]) {
    const bool in = k >= 0 && k < n_sym;
    const float4* p = reinterpret_cast<const float4*>(blk + (in ? k : 0) * T);
#pragma unroll
    for (int q = 0; q < T / 2; ++q) {
        const float4 v = in ? p[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        o[2 * q] = {v.x, v.y};
        o[2 * q + 1] = {v.z, v.w};
    }
}

__device__ __forceinline__ C2 cell(const C2* blk, int k, int t, int n_sym,
                                   int T) {
    return (k >= 0 && k < n_sym) ? blk[k * T + t] : C2{0.f, 0.f};
}

// a row's |C|^2, -inf at the tones the neighbour may not hold: every window
// through such a tone is then -inf and never the maximum, as the plain
// version's -1e30 never is
template <int T>
__device__ __forceinline__ void e1_row(const float* e1b, int k, int n_sym,
                                       int allow, float (&o)[T]) {
    const bool in = k >= 0 && k < n_sym;
    const float4* p = reinterpret_cast<const float4*>(e1b + (in ? k : 0) * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
        const float4 v = in ? p[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
            o[4 * q + j] = ((allow >> (4 * q + j)) & 1) ? w[j] : -INFINITY;
    }
}

// row p of a T x T table in shared memory
template <int T>
__device__ __forceinline__ void tab_row(const float* tab, int p,
                                        float (&o)[T]) {
    const float4* q4 = reinterpret_cast<const float4*>(tab + p * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
        const float4 v = q4[q];
        o[4 * q] = v.x;
        o[4 * q + 1] = v.y;
        o[4 * q + 2] = v.z;
        o[4 * q + 3] = v.w;
    }
}

template <int T>
__device__ __forceinline__ void store_row(float* tab, int p,
                                          const float (&v)[T]) {
    float4* q4 = reinterpret_cast<float4*>(tab + p * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q)
        q4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                            v[4 * q + 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// One block of LLR_THREADS a candidate: G = LLR_THREADS / T groups of T
// lanes, a group a data symbol and round, lane sm of a group its middle
// tone sm.
template <int T, bool COH4>
__global__ void __launch_bounds__(LLR_THREADS, COH4 ? 4 : LLR_BLOCKS_PER_SM)
k_llr(LlrDims d, LlrArgs a) {
    extern __shared__ float4 llr_smem[];
    __shared__ C2 rot_s;
    constexpr int G = LLR_THREADS / T;
    constexpr int TT = T * T;
    constexpr int NM = COH4 ? 6 : 4;          // metrics a tone
    constexpr int MS = llr_met_stride<COH4>();
    const int n_cells = d.n_sym * T;
    C2* blk = reinterpret_cast<C2*>(llr_smem);                 // [n_sym, T]
    float* e1b = reinterpret_cast<float*>(blk + n_cells);     // [n_sym, T]
    const int tid = threadIdx.x, g = tid / T, sm = tid % T;
    float* grp = e1b + n_cells + g * llr_group_floats<T, COH4>();
    float* tab = grp;                                          // tables
    float4* wsh = reinterpret_cast<float4*>(grp + llr_tab_floats<T, COH4>());
    float* met = grp + llr_tab_floats<T, COH4>() + 4 * T;     // [T, MS]
    float* llr_s = e1b + n_cells + G * llr_group_floats<T, COH4>();
    const int mc = blockIdx.x;

    // 1. the candidate's [n_sym, T] block: the plain version's strided
    //    gather with its clamps, 0 where it reads the padding (hops and
    //    bins fit in int: the wrapper takes H, F < 2**31 / max(os_t, os_f))
    {
        const int tt = a.tt ? static_cast<int>(a.tt[mc]) : 0;
        const int f0 = a.f0 ? static_cast<int>(a.f0[mc]) : 0;
        const int hq = ceil_div(d.H, d.os_t), fq = ceil_div(d.F, d.os_f);
        const int qt = floor_div(tt, d.os_t), qf = floor_div(f0, d.os_f);
        const int h0 = min(max(qt, 0), hq - d.n_sym) * d.os_t
            + (tt - qt * d.os_t);
        const int b0 = min(max(qf, 0), fq - T) * d.os_f + (f0 - qf * d.os_f);
        const C2* src = a.spec + static_cast<size_t>(mc / d.K) * d.H * d.F;
        for (int i = tid; i < n_cells; i += LLR_THREADS) {
            const int h = h0 + d.os_t * (i / T), f = b0 + d.os_f * (i % T);
            blk[i] = (h < d.H && f < d.F)
                ? src[static_cast<size_t>(h) * d.F + f] : C2{0.f, 0.f};
        }
    }
    __syncthreads();

    // 2. warp 0: the rotation, exp(-2j pi abs_bin / os_f) or the one given,
    //    then the sync-pair residual, rot * exp(-1j angle(z * rot)) with z
    //    the sum of conj(c_s) c_s+1 over the pairs (a lane's pairs summed
    //    in order, then the lanes' sums as a tree); every thread: the
    //    cells' |C|^2
    if (tid < 32) {
        C2 r;
        if (a.rot) {
            r = a.rot[mc];
        } else {
            const long long f0 = a.f0 ? a.f0[mc] : 0;
            const float ab = static_cast<float>(f0 + d.fmin_bin);
            float s, c;
            sincosf((-6.28318548f * ab) / static_cast<float>(d.os_f), &s, &c);
            r = {c, s};
        }
        if (d.n_pairs) {
            C2 z = {0.f, 0.f};
            for (int i = tid; i < d.n_pairs; i += 32) {
                const int* pr = a.pairs + 3 * i;
                const C2 u = blk[pr[0] * T + pr[1]];
                const C2 v = blk[(pr[0] + 1) * T + pr[2]];
                z.x = z.x + (u.x * v.x + u.y * v.y);
                z.y = z.y + (u.x * v.y - u.y * v.x);
            }
            z.x = warp_sum(z.x);
            z.y = warp_sum(z.y);
            z = cmul(z, r);
            float s, c;
            sincosf(atan2f(z.y, z.x), &s, &c);
            r = cmul(r, C2{c, -s});
        }
        if (tid == 0) rot_s = r;
    }
    for (int i = tid; i < n_cells; i += LLR_THREADS) e1b[i] = mag2(blk[i]);
    int mask0[LLR_MAX_BPS];
#pragma unroll
    for (int bb = 0; bb < LLR_MAX_BPS; ++bb) {
        int mk = 0;
        if (bb < d.bps) {
#pragma unroll
            for (int t = 0; t < T; ++t)
                mk |= (a.bitmaps[bb * T + t] < 0.5f ? 1 : 0) << t;
        }
        mask0[bb] = mk;
    }
    // the tones whose bit sm / 2 is 0 (lanes 0, 2, 4) or 1 (lanes 1, 3, 5),
    // as a mask of the tones each lane takes
    const int bit_of = sm / 2 < LLR_MAX_BPS ? sm / 2 : 0;
    const int mk0 = bit_of == 0 ? mask0[0] : bit_of == 1 ? mask0[1] : mask0[2];
    const int my_mask = (sm & 1) ? (~mk0 & ((1 << T) - 1)) : mk0;
    __syncthreads();
    const C2 r = rot_s, r2 = cmul(r, r), r3 = cmul(r2, r);

    // 3. G data symbols a round
    for (int base = 0; base < d.n_data; base += G) {
        const bool on = base + g < d.n_data;
        const int di = on ? base + g : d.n_data - 1;   // idle groups mirror
        const int s = a.data[di];
        const int ap = a.allow[di], an = a.allow[d.n_data + di];
        const C2 cs = cell(blk, s, sm, d.n_sym, T);
        const C2 cp_sm = cell(blk, s - 1, sm, d.n_sym, T);
        C2 cp[T];
        cell_row<T>(blk, s - 1, d.n_sym, cp);
        float e1p[T], e1n[T];
        e1_row<T>(e1b, s - 1, d.n_sym, ap, e1p);
        e1_row<T>(e1b, s + 1, d.n_sym, an, e1n);
        const float e1s = (s >= 0 && s < d.n_sym) ? e1b[s * T + sm] : 0.f;

        // this lane's column of x_ps and row of x_sn, its row of the
        // shared tables, each cell 2 Re(conj(a) rr b) as the plain version
        float xps[T], xsn[T], row[T];
        {
            const C2 w = cmul(r, cs);
#pragma unroll
            for (int t = 0; t < T; ++t) xps[t] = cross(cp[t], w);
        }
        if constexpr (!COH4) {
            // the next row times r and r^2, a tone a lane, shared
            const C2 cn_sm = cell(blk, s + 1, sm, d.n_sym, T);
            const C2 w1 = cmul(r, cn_sm), w2 = cmul(r2, cn_sm);
            wsh[sm] = make_float4(w1.x, w1.y, w2.x, w2.y);
            __syncwarp();
#pragma unroll
            for (int t = 0; t < T; ++t) {
                const float4 w = wsh[t];
                xsn[t] = cross(cs, C2{w.x, w.y});
                row[t] = cross(cp_sm, C2{w.z, w.w});
            }
            store_row<T>(tab, sm, row);
        } else {
            C2 cn[T], cp2[T], cn2[T];
            cell_row<T>(blk, s + 1, d.n_sym, cn);
            cell_row<T>(blk, s - 2, d.n_sym, cp2);
            cell_row<T>(blk, s + 2, d.n_sym, cn2);
            const C2 cn_sm = cell(blk, s + 1, sm, d.n_sym, T);
            const C2 cp2_sm = cell(blk, s - 2, sm, d.n_sym, T);
#pragma unroll
            for (int t = 0; t < T; ++t) {
                xsn[t] = cross(cs, cmul(r, cn[t]));
                row[t] = cross(cp_sm, cmul(r2, cn[t]));
            }
            store_row<T>(tab, sm, row);                           // x_pn
#pragma unroll
            for (int t = 0; t < T; ++t)
                row[t] = cross(cp_sm, cmul(r3, cn2[t]));
            store_row<T>(tab + TT, sm, row);                      // x_p_nn
#pragma unroll
            for (int t = 0; t < T; ++t)
                row[t] = cross(cn_sm, cmul(r, cn2[t]));
            store_row<T>(tab + 2 * TT, sm, row);                  // x_n_nn
#pragma unroll
            for (int t = 0; t < T; ++t)
                row[t] = cross(cp2_sm, cmul(r, cp[t]));
            store_row<T>(tab + 3 * TT, sm, row);                  // x_pp_p
#pragma unroll
            for (int t = 0; t < T; ++t)
                row[t] = cross(cp2_sm, cmul(r3, cn[t]));
            store_row<T>(tab + 4 * TT, sm, row);                  // x_pp_n
        }
        __syncwarp();

        // the metrics of tone sm, each window's terms summed in the plain
        // version's order
        float e2p = -INFINITY, e2n = -INFINITY, e3 = -INFINITY;
#pragma unroll
        for (int i = 0; i < T; ++i) e2p = fmaxf(e2p, e1p[i] + xps[i]);
        e2p = e1s + e2p;
#pragma unroll
        for (int j = 0; j < T; ++j) e2n = fmaxf(e2n, e1n[j] + xsn[j]);
        e2n = e1s + e2n;
        {
            // a maximum a neighbour tone p, then over p: max is exact, so
            // the eight chains may run side by side
            float mp[T];
#pragma unroll
            for (int p = 0; p < T; ++p) {
                float xpn[T];
                tab_row<T>(tab, p, xpn);
                const float h = e1p[p] + e1s;
                mp[p] = -INFINITY;
#pragma unroll
                for (int n = 0; n < T; ++n)
                    mp[p] = fmaxf(mp[p], h + e1n[n] + xps[p] + xsn[n]
                                             + xpn[n]);
            }
#pragma unroll
            for (int p = 0; p < T; ++p) e3 = fmaxf(e3, mp[p]);
        }
        float m[NM];
        m[0] = e1s;
        m[1] = e2p;
        m[2] = e2n;
        m[3] = e3;
        if constexpr (COH4) {
            const int ap2 = a.allow[2 * d.n_data + di];
            const int an2 = a.allow[3 * d.n_data + di];
            float e1p2[T], e1n2[T], xsnn[T], xpps[T];
            e1_row<T>(e1b, s - 2, d.n_sym, ap2, e1p2);
            e1_row<T>(e1b, s + 2, d.n_sym, an2, e1n2);
            {
                C2 cp2[T], cn2[T];
                cell_row<T>(blk, s - 2, d.n_sym, cp2);
                cell_row<T>(blk, s + 2, d.n_sym, cn2);
                const C2 w2 = cmul(r2, cs);
#pragma unroll
                for (int t = 0; t < T; ++t) {
                    xsnn[t] = cross(cs, cmul(r2, cn2[t]));
                    xpps[t] = cross(cp2[t], w2);
                }
            }
            // window [s-1, s, s+1, s+2]: axes (p, self, n, q)
            float e4n = -INFINITY;
#pragma unroll
            for (int p = 0; p < T; ++p) {
                float xpn[T], xpnn[T];
                tab_row<T>(tab, p, xpn);
                tab_row<T>(tab + TT, p, xpnn);
#pragma unroll
                for (int n = 0; n < T; ++n) {
                    float xnnn[T];
                    tab_row<T>(tab + 2 * TT, n, xnnn);
                    const float h = e1p[p] + e1s + e1n[n];
#pragma unroll
                    for (int q = 0; q < T; ++q)
                        e4n = fmaxf(e4n, h + e1n2[q] + xps[p] + xpn[n]
                                             + xpnn[q] + xsn[n] + xsnn[q]
                                             + xnnn[q]);
                }
            }
            // window [s-2, s-1, s, s+1]: axes (q2, p, self, n)
            float e4p = -INFINITY;
#pragma unroll
            for (int q2 = 0; q2 < T; ++q2) {
                float xppp[T], xppn[T];
                tab_row<T>(tab + 3 * TT, q2, xppp);
                tab_row<T>(tab + 4 * TT, q2, xppn);
#pragma unroll
                for (int p = 0; p < T; ++p) {
                    float xpn[T];
                    tab_row<T>(tab, p, xpn);
                    const float h = e1p2[q2] + e1p[p] + e1s;
#pragma unroll
                    for (int n = 0; n < T; ++n)
                        e4p = fmaxf(e4p, h + e1n[n] + xppp[p] + xpps[q2]
                                             + xppn[n] + xps[p] + xpn[n]
                                             + xsn[n]);
                }
            }
            m[4] = e4n;
            m[5] = e4p;
        }
        // the bit LLRs: lane 2 b + z < 2 bps of the group takes the
        // maxima of the metrics over the tones whose bit b is z, and lane
        // 2 b subtracts its partner's, metric by metric in the plain
        // version's order
#pragma unroll
        for (int j = 0; j < NM; ++j) met[sm * MS + j] = m[j];
        __syncwarp();
        float mx[NM];
#pragma unroll
        for (int j = 0; j < NM; ++j) mx[j] = -1e30f;
        if (sm < 2 * d.bps) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
                if (!((my_mask >> t) & 1)) continue;
#pragma unroll
                for (int j = 0; j < NM; ++j)
                    mx[j] = fmaxf(mx[j], met[t * MS + j]);
            }
        }
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < NM; ++j) {
            const float m1 = __shfl_down_sync(FULL, mx[j], 1, T);
            l = j == 0 ? mx[0] - m1 : l + (mx[j] - m1);
        }
        if (on && sm < 2 * d.bps && !(sm & 1)) llr_s[di * d.bps + sm / 2] = l;
        __syncwarp();
    }
    __syncthreads();

    // 4. warp 0: divide by the candidate's peak |LLR|, then scale to std 3
    if (tid < 32) {
        const int nb = d.n_data * d.bps;
        float pk = 0.f;
        for (int i = tid; i < nb; i += 32) pk = fmaxf(pk, fabsf(llr_s[i]));
        const float den = warp_max(pk) + 1e-20f;
        float sum = 0.f;
        for (int i = tid; i < nb; i += 32) sum += llr_s[i] / den;
        const float mean = warp_sum(sum) / static_cast<float>(nb);
        float sq = 0.f;
        for (int i = tid; i < nb; i += 32) {
            const float v = llr_s[i] / den - mean;
            sq += v * v;
        }
        const float sd = sqrtf(warp_sum(sq) / static_cast<float>(nb));
        float* o = a.out + static_cast<size_t>(mc) * nb;
        for (int i = tid; i < nb; i += 32)
            o[i] = llr_s[i] / den / (sd + 1e-20f) * 3.f;
    }
}

template <int T, bool COH4>
cudaError_t llr_start(const LlrDims& d, const LlrArgs& a, cudaStream_t st) {
    const int smem = llr_smem_bytes<T, COH4>(d.n_sym, d.n_data * d.bps);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            k_llr<T, COH4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return err;
    }
    k_llr<T, COH4><<<d.B * d.K, LLR_THREADS, smem, st>>>(d, a);
    return cudaGetLastError();
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
int gfsk_llr_max_sym() { return LLR_MAX_SYM; }

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

// Coherent LLRs of B * K candidates on `stream`, one launch.
// dims [13]: B, K, H, F, n_sym, n_tones, n_data, bps, os_t, os_f,
// fmin_bin, n_pairs, coh4.  spec [B, H, F] complex64 as float pairs; tt
// and f0 [B, K] int64 start hop and bin (null: 0); rot [B * K] complex64
// (null: exp(-2j pi (f0 + fmin_bin) / os_f)); bitmaps [bps, n_tones]
// float32; data [n_data] int32 symbol indices; allow [4, n_data] uint8
// masks of the tones a previous / next / second previous / second next
// neighbour may hold; pairs [n_pairs, 3] int32 (symbol, its tone, the next
// symbol's tone) of the sync pairs folded into the rotation; out [B * K,
// n_data * bps] float32.  Returns the cudaError_t (0 = success).
int gfsk_llr_launch(const int* dims, const void* spec, const void* tt,
                    const void* f0, const void* rot, const void* bitmaps,
                    const void* data, const void* allow, const void* pairs,
                    void* out, void* stream) {
    LlrDims d;
    d.B = dims[0];
    d.K = dims[1];
    d.H = dims[2];
    d.F = dims[3];
    d.n_sym = dims[4];
    const int n_tones = dims[5];
    d.n_data = dims[6];
    d.bps = dims[7];
    d.os_t = dims[8];
    d.os_f = dims[9];
    d.fmin_bin = dims[10];
    d.n_pairs = dims[11];
    const int coh4 = dims[12];
    if (d.B < 1 || d.K < 1 || d.B > 2147483647 / d.K || d.H < 1 || d.F < 1
        || d.n_sym < 1 || d.n_sym > LLR_MAX_SYM || d.n_data < 1
        || d.n_data > LLR_MAX_DATA || d.bps < 2 || d.bps > LLR_MAX_BPS
        || !(n_tones == 4 || n_tones == 8) || (1 << d.bps) > n_tones
        || (coh4 && n_tones != 4) || d.os_t < 1 || d.os_f < 1
        || ceil_div(d.H, d.os_t) < d.n_sym || ceil_div(d.F, d.os_f) < n_tones
        || d.H > 2147483647 / (d.os_t + 1) || d.F > 2147483647 / (d.os_f + 1)
        || d.n_pairs < 0 || d.n_pairs >= d.n_sym || (d.n_pairs && !pairs))
        return static_cast<int>(cudaErrorInvalidValue);
    LlrArgs a;
    a.spec = static_cast<const C2*>(spec);
    a.tt = static_cast<const int64_t*>(tt);
    a.f0 = static_cast<const int64_t*>(f0);
    a.rot = static_cast<const C2*>(rot);
    a.bitmaps = static_cast<const float*>(bitmaps);
    a.data = static_cast<const int32_t*>(data);
    a.allow = static_cast<const uint8_t*>(allow);
    a.pairs = static_cast<const int32_t*>(pairs);
    a.out = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (n_tones == 8)
        err = llr_start<8, false>(d, a, st);
    else if (coh4)
        err = llr_start<4, true>(d, a, st);
    else
        err = llr_start<4, false>(d, a, st);
    return static_cast<int>(err);
}

}  // extern "C"
