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
//     correlation cumsums and the twist (cos and sin again): ~160 float
//     operations with range-reduced trig counted as tens each, ~0.1 ms of
//     FP32 issue at ~6 bursts a window.  Operations bound it.  What costs
//     in practice is the chain: each burst's fit needs the whole span's
//     cumsums before the next stage, and each window's bursts run in order.
//   - llr at FT8's 12,288 candidates reads 62 MB of symbol spectra and
//     writes 8.5 MB (~0.021 ms); its ~4,300 operations per (candidate, data
//     symbol) over the 512 triples take ~0.046 ms of FP32 issue: operations
//     bound it.
//
// The design.
//
//   - subtract: windows are independent and a window's bursts sequential,
//     so a call issues, for each burst step, ten stream-ordered launches
//     over every window at once (setup; per fit pass: phase up-sweep,
//     phase scan, correlation pass, estimate; the subtraction): 1 + 10 M
//     launches for M bursts, all from one host call, no host sync.  A
//     window stops at its own first invalid burst (valid bursts come
//     first, select_subtract_params): its blocks return at once, which is
//     the reference's while_loop exactly, since an invalid burst subtracts
//     zero there.  The span-wide passes run one block of 256 threads per
//     4096 samples of a window's span, so FST4-1800's 21.6 M-sample spans
//     spread over ~5,300 blocks a window and FT8's over 38.
//   - The reference's cumsum order is a fixed tree (subtract.py _cumsum):
//     sequential float32 adds within blocks of 16, the block totals scanned
//     the same way, each block's exclusive prefix added last.  A thread
//     owns one level-0 block of 16 samples: its sequential sum is V1, a
//     block's 16 V1 sums (sequential) are V2 and its 16 V2 sums V3, one V3
//     entry a block.  One block per window scans V3 in the tree's order
//     (tree_scan), and any level-1 or level-2 prefix is the tree's
//     E + W (exclusive prefix of the level above plus the sequential
//     within-block sum) read back from V1, V2 and that scan (p1_point).
//     So the phase, and the per-symbol correlations read at the symbol
//     boundaries, round exactly as the plain version's; the library is
//     built with --fmad=false, so no product and sum contract into an FMA.
//     The phase is never stored: the subtraction pass rebuilds it from the
//     same sums.
//   - cosf, sinf and atan2f are CUDA's, with full range reduction (the
//     phase reaches ~2.4e5 rad in an FT8 burst, ~1e7 at FST4-1800), within
//     2 ulp of the CPU's; the shift rounds half to even (rintf) as
//     torch.round.  The short per-symbol sums of the estimators run in
//     their own order, so dt, df1 and df2 may differ from the plain
//     version's in the last bits.
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
constexpr int SMALL_THREADS = 256;     // per-window blocks
constexpr int SUB_MAX_SYM = 256;
constexpr int SUB_MAX_INFO = 128;
constexpr int SUB_MAX_PAR = 256;
constexpr int SUB_MAX_BURSTS = 64;
constexpr int SUB_MAX_LEVELS = 12;
constexpr int MOV_TMP = 64;            // tree_scan scratch of n_sym + 7
constexpr int LLR_MAX_DATA = 128;
constexpr int LLR_MAX_BPS = 3;
constexpr int GAIN_SMOOTH = 7;         // subtract.py GAIN_SMOOTH_SYMS

// per-window state
enum { SI_ALIVE, SI_ACTIVE, SI_FINE, SI_M, SI_START0, SI_BLK1, SI_START1,
       SI_N };
enum { SF_F0, SF_CF, SF_CDF2, SF_N };

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
    int32_t* si;
    float* sf;
    float *tones, *g_re, *g_im;
    float *ph_v1, *ph_v2, *ph_v3, *ph_p3, *ph_tmp;
    float *cr_v1, *cr_v2, *cr_v3, *cr_p3, *cr_tmp;
    float *ci_v1, *ci_v2, *ci_v3, *ci_p3, *ci_tmp;
    float *bw_re, *bw_im;
    int32_t* shifts;          // [B, m_bursts] or null: each step's shift
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

// The tree's inclusive prefix at level 2 (index i of V2) and level 1
// (index i of V1), from V1, V2 and the scan P3 of V3.  Levels 1 and 2 hold
// more than 16 values (S > CHUNK), so each is E + W.
__device__ float p2_point(const float* v2, const float* p3, int i) {
    const int blk = i / SCAN;
    const float e = blk == 0 ? 0.f : p3[blk - 1];
    float w = v2[blk * SCAN];
    for (int k = blk * SCAN + 1; k <= i; ++k) w = w + v2[k];
    return e + w;
}

__device__ float p1_point(const float* v1, const float* v2, const float* p3,
                          int i) {
    const int blk = i / SCAN;
    const float e = blk == 0 ? 0.f : p2_point(v2, p3, blk - 1);
    float w = v1[blk * SCAN];
    for (int k = blk * SCAN + 1; k <= i; ++k) w = w + v1[k];
    return e + w;
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

// V1 (each thread's), V2 and V3 of a span block from the threads' level-0
// block sums: v1s is SPAN_THREADS floats of shared memory, v2s SCAN.
__device__ void span_levels(const SubDims& d, float s, float* v1s, float* v2s,
                            float* v1, float* v2, float* v3, int c) {
    const int j = c * SPAN_THREADS + threadIdx.x;
    v1s[threadIdx.x] = s;
    if (j < d.n1) v1[j] = s;
    __syncthreads();
    if (threadIdx.x < SCAN) {
        const float* x = v1s + threadIdx.x * SCAN;
        float s2 = x[0];
        for (int k = 1; k < SCAN; ++k) s2 = s2 + x[k];
        v2s[threadIdx.x] = s2;
        const int q = c * SCAN + threadIdx.x;
        if (q < d.n2) v2[q] = s2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s3 = v2s[0];
        for (int k = 1; k < SCAN; ++k) s3 = s3 + v2s[k];
        v3[c] = s3;
    }
}

__global__ void k_init(SubDims d, SubBufs b) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w < d.B) {
        b.si[w * SI_N + SI_ALIVE] = 1;
        b.si[w * SI_N + SI_ACTIVE] = 0;
    }
}

// Burst mi of every window: stop the window at its first invalid burst,
// else its tones from the info bits and the first pass's alignment.
__global__ void __launch_bounds__(SMALL_THREADS)
k_setup(SubDims d, SubBufs b, int mi) {
    __shared__ float par[SUB_MAX_PAR];
    __shared__ int alive_s;
    const int w = blockIdx.x;
    int32_t* si = b.si + w * SI_N;
    float* sf = b.sf + w * SF_N;
    const int32_t* p = b.params
        + (static_cast<size_t>(w) * d.m_bursts + mi) * (d.k_info + 3);
    if (threadIdx.x == 0) {
        int alive = si[SI_ALIVE];
        if (alive && p[d.k_info + 2] == 0) alive = 0;
        si[SI_ALIVE] = alive;
        si[SI_ACTIVE] = alive;
        if (alive) {
            const int t0 = p[d.k_info];
            si[SI_START0] = t0 * d.hop;
            si[SI_FINE] = 0;
            si[SI_M] = min(max(t0 + d.margin, 0), d.nb_pad - d.n_blk_seg);
            const float f0 = static_cast<float>(p[d.k_info + 1]) * d.bin_hz;
            sf[SF_F0] = f0;
            sf[SF_CF] = d.c_w * f0;
        }
        alive_s = alive;
    }
    __syncthreads();
    if (!alive_s) return;
    for (int j = threadIdx.x; j < d.n_par; j += blockDim.x) {
        float acc = 0.f;               // exact: sums of 0/1 products
        for (int i = 0; i < d.k_info; ++i)
            acc = acc + static_cast<float>(p[i]) * b.gen_par[i * d.n_par + j];
        par[j] = fmodf(acc, 2.f);
    }
    float* tones = b.tones + w * d.n_sym;
    for (int s = threadIdx.x; s < d.n_sym; s += blockDim.x)
        tones[s] = b.templ[s];
    __syncthreads();
    for (int k = threadIdx.x; k < d.n_data; k += blockDim.x) {
        int v = 0;
        for (int bb = 0; bb < d.bps; ++bb) {
            const int c = k * d.bps + bb;
            const float bit = c < d.k_info ? static_cast<float>(p[c])
                                           : par[c - d.k_info];
            v = 2 * v + static_cast<int>(bit);
        }
        tones[b.data_idx[k]] = static_cast<float>(b.gray[v]);
    }
}

// Level sums of the phase increments of the current pass.
__global__ void __launch_bounds__(SPAN_THREADS)
k_phase_up(SubDims d, SubBufs b) {
    __shared__ float v1s[SPAN_THREADS];
    __shared__ float v2s[SCAN];
    const int w = blockIdx.y, c = blockIdx.x;
    if (!b.si[w * SI_N + SI_ACTIVE]) return;
    const int fine = b.si[w * SI_N + SI_FINE];
    const float cf = b.sf[w * SF_N + SF_CF];
    const float* tones = b.tones + w * d.n_sym;
    const int j = c * SPAN_THREADS + threadIdx.x;
    float s = 0.f;
    for (int i = 0; i < SCAN; ++i) {
        const int u = j * SCAN + i;
        const float x = u < d.S ? dphi_at(d, b, tones, u, fine, cf) : 0.f;
        s = i == 0 ? x : s + x;
    }
    span_levels(d, s, v1s, v2s, b.ph_v1 + static_cast<size_t>(w) * d.n1,
                b.ph_v2 + static_cast<size_t>(w) * d.n2,
                b.ph_v3 + static_cast<size_t>(w) * d.n3, c);
}

__global__ void __launch_bounds__(SMALL_THREADS)
k_phase_scan(SubDims d, SubBufs b) {
    const int w = blockIdx.x;
    if (!b.si[w * SI_N + SI_ACTIVE]) return;
    tree_scan(b.ph_v3 + static_cast<size_t>(w) * d.n3, d.n3,
              b.ph_p3 + static_cast<size_t>(w) * d.n3,
              b.ph_tmp + static_cast<size_t>(w) * d.scan_tmp);
}

// The phase of the span samples of this thread's level-0 block, in order;
// calls f(u, phase) for each sample u < S.
template <typename F>
__device__ __forceinline__ void for_phase(const SubDims& d, const SubBufs& b,
                                          int w, int j, int fine, float cf,
                                          F&& f) {
    const float* tones = b.tones + w * d.n_sym;
    float e0 = 0.f;
    if (j > 0 && j < d.n1)
        e0 = p1_point(b.ph_v1 + static_cast<size_t>(w) * d.n1,
                      b.ph_v2 + static_cast<size_t>(w) * d.n2,
                      b.ph_p3 + static_cast<size_t>(w) * d.n3, j - 1);
    float wp = 0.f;
    for (int i = 0; i < SCAN; ++i) {
        const int u = j * SCAN + i;
        if (u >= d.S) {
            f(u, 0.f, false);
            continue;
        }
        const float x = dphi_at(d, b, tones, u, fine, cf);
        wp = i == 0 ? x : wp + x;
        f(u, e0 + wp, true);
    }
}

// Masked reference cos/sin at the current pass's alignment, its products
// with the extracted span and their level sums; the within-block prefix at
// each symbol boundary fine + sps*k - 1.
__global__ void __launch_bounds__(SPAN_THREADS)
k_corr_up(SubDims d, SubBufs b) {
    __shared__ float v1s[SPAN_THREADS];
    __shared__ float v2s[SCAN];
    const int w = blockIdx.y, c = blockIdx.x;
    if (!b.si[w * SI_N + SI_ACTIVE]) return;
    const int fine = b.si[w * SI_N + SI_FINE];
    const int m = b.si[w * SI_N + SI_M];
    const float cf = b.sf[w * SF_N + SF_CF];
    const float* seg = b.res + static_cast<size_t>(w) * d.row
        + static_cast<size_t>(m) * d.hop;
    float* bw_re = b.bw_re + w * (d.n_sym + 1);
    float* bw_im = b.bw_im + w * (d.n_sym + 1);
    const int j = c * SPAN_THREADS + threadIdx.x;
    float wr = 0.f, wi = 0.f;
    int i = 0;
    for_phase(d, b, w, j, fine, cf, [&](int u, float ph, bool in) {
        float ar = 0.f, ai = 0.f;
        if (in) {
            const float mk = (u >= fine && u < fine + d.L) ? 1.f : 0.f;
            const float zr = cosf(ph) * mk;
            const float zi = sinf(ph) * mk;
            const float sg = seg[u];
            ar = sg * zr;
            ai = (-sg) * zi;
        }
        wr = i == 0 ? ar : wr + ar;
        wi = i == 0 ? ai : wi + ai;
        ++i;
        if (in) {
            const int bp = u + 1 - fine;
            if (bp >= 0 && bp % d.sps == 0 && bp / d.sps <= d.n_sym) {
                bw_re[bp / d.sps] = wr;
                bw_im[bp / d.sps] = wi;
            }
        }
    });
    const size_t w1 = static_cast<size_t>(w) * d.n1;
    const size_t w2 = static_cast<size_t>(w) * d.n2;
    const size_t w3 = static_cast<size_t>(w) * d.n3;
    span_levels(d, wr, v1s, v2s, b.cr_v1 + w1, b.cr_v2 + w2, b.cr_v3 + w3, c);
    __syncthreads();
    span_levels(d, wi, v1s, v2s, b.ci_v1 + w1, b.ci_v2 + w2, b.ci_v3 + w3, c);
}

// Sum of x[0, n) in order, by thread 0 of the block.
__device__ float seq_sum(const float* x, int n) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s = s + x[i];
    return s;
}

// movsum over GAIN_SMOOTH symbols (subtract.py movsum): the tree cumsum of
// x padded with 4 zeros before and 3 after, differenced 7 apart.
__device__ void movsum(const float* x, int n, float* xp, float* cs,
                       float* tmp, float* out) {
    const int half = GAIN_SMOOTH / 2;
    for (int i = threadIdx.x; i < n + GAIN_SMOOTH; i += blockDim.x)
        xp[i] = (i > half && i <= half + n) ? x[i - half - 1] : 0.f;
    __syncthreads();
    tree_scan(xp, n + GAIN_SMOOTH, cs, tmp);
    for (int s = threadIdx.x; s < n; s += blockDim.x)
        out[s] = cs[s + GAIN_SMOOTH] - cs[s];
    __syncthreads();
}

// The per-symbol correlations of the current pass, then pass 0: df1 and dt,
// the refined start and the second pass's alignment; pass 1: df2 and the
// smoothed complex gain.
__global__ void __launch_bounds__(SMALL_THREADS)
k_estimate(SubDims d, SubBufs b, int pass, int mi) {
    __shared__ float vr[SUB_MAX_SYM + 1], vi[SUB_MAX_SYM + 1];
    __shared__ float cr[SUB_MAX_SYM], ci[SUB_MAX_SYM], tn[SUB_MAX_SYM];
    __shared__ float pr[SUB_MAX_SYM], pi[SUB_MAX_SYM];
    __shared__ float ta[SUB_MAX_SYM], tb[SUB_MAX_SYM], tc[SUB_MAX_SYM];
    __shared__ float xp[SUB_MAX_SYM + GAIN_SMOOTH];
    __shared__ float cs[SUB_MAX_SYM + GAIN_SMOOTH];
    __shared__ float tmp[MOV_TMP];
    __shared__ float ms[3][SUB_MAX_SYM];
    __shared__ float df_s;
    const int w = blockIdx.x;
    int32_t* si = b.si + w * SI_N;
    float* sf = b.sf + w * SF_N;
    if (!si[SI_ACTIVE]) return;
    const size_t w1 = static_cast<size_t>(w) * d.n1;
    const size_t w2 = static_cast<size_t>(w) * d.n2;
    const size_t w3 = static_cast<size_t>(w) * d.n3;
    const size_t wt = static_cast<size_t>(w) * d.scan_tmp;
    tree_scan(b.cr_v3 + w3, d.n3, b.cr_p3 + w3, b.cr_tmp + wt);
    tree_scan(b.ci_v3 + w3, d.n3, b.ci_p3 + w3, b.ci_tmp + wt);
    const int n_sym = d.n_sym;
    const int fine = si[SI_FINE];
    const float* bw_re = b.bw_re + w * (n_sym + 1);
    const float* bw_im = b.bw_im + w * (n_sym + 1);
    // the cumsums at the boundaries fine + sps*k - 1 (0 where that is < 0)
    for (int k = threadIdx.x; k <= n_sym; k += blockDim.x) {
        const int bpos = fine + d.sps * k;
        float a = 0.f, bb = 0.f;
        if (bpos > 0) {
            const int blk = (bpos - 1) / SCAN;
            float er = 0.f, ei = 0.f;
            if (blk > 0) {
                er = p1_point(b.cr_v1 + w1, b.cr_v2 + w2, b.cr_p3 + w3,
                              blk - 1);
                ei = p1_point(b.ci_v1 + w1, b.ci_v2 + w2, b.ci_p3 + w3,
                              blk - 1);
            }
            a = er + bw_re[k];
            bb = ei + bw_im[k];
        }
        vr[k] = a;
        vi[k] = bb;
    }
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x)
        tn[s] = b.tones[w * n_sym + s];
    __syncthreads();
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x) {
        cr[s] = vr[s + 1] - vr[s];
        ci[s] = vi[s + 1] - vi[s];
    }
    __syncthreads();
    // df from same-tone pairs (df_same)
    const int np = n_sym - 1;
    for (int s = threadIdx.x; s < np; s += blockDim.x) {
        const float p_r = cr[s + 1] * cr[s] + ci[s + 1] * ci[s];
        const float p_i = ci[s + 1] * cr[s] - cr[s + 1] * ci[s];
        const float same = (tn[s + 1] - tn[s]) == 0.f ? 1.f : 0.f;
        pr[s] = p_r;
        pi[s] = p_i;
        ta[s] = p_r * same;
        tb[s] = p_i * same;
        tc[s] = same;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const float srr = seq_sum(ta, np), sri = seq_sum(tb, np);
        const float df = atan2f(sri, srr) / d.c_df;
        const bool keep = seq_sum(tc, np) > 0.f && fabsf(df) < d.bin_hz;
        df_s = keep ? df : 0.f;
    }
    __syncthreads();
    const float df = df_s;
    if (pass == 0) {
        // dt from tone-change pairs, df1 removed analytically
        const float ang = d.two_pi * df * d.t_sym;
        for (int s = threadIdx.x; s < np; s += blockDim.x) {
            const float dtone = tn[s + 1] - tn[s];
            const float adt = fabsf(dtone);
            const float sel = (adt >= 1.f && adt <= 3.f) ? 1.f : 0.f;
            float th = atan2f(pi[s], pr[s]) - ang;
            th = atan2f(sinf(th), cosf(th));
            const float wgt = sqrtf(pr[s] * pr[s] + pi[s] * pi[s]) * sel;
            ta[s] = wgt * dtone * dtone;
            tb[s] = wgt * th * dtone;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            const float den = d.c_den * seq_sum(ta, np);
            const float dt = seq_sum(tb, np) / fmaxf(den, 1e-20f);
            int shift = static_cast<int>(rintf(dt * d.sr));
            shift = min(max(shift, -(d.sps - 1)), d.sps - 1);
            if (b.shifts) b.shifts[w * d.m_bursts + mi] = shift;
            const int start1 = si[SI_START0] - shift;
            const int blk1 = start1 >= 0 ? start1 / d.hop
                                         : -ceil_div(-start1, d.hop);
            si[SI_FINE] = start1 - blk1 * d.hop;
            si[SI_M] = min(max(blk1 + d.margin, 0), d.nb_pad - d.n_blk_seg);
            si[SI_BLK1] = blk1;
            si[SI_START1] = start1;
            const float f1 = sf[SF_F0] + df;
            sf[SF_CF] = d.c_w * f1;
        }
        return;
    }
    // pass 1: the gain, each correlation twisted by df2 at its symbol centre
    const float cdf2 = d.c_w * df;
    const int start1 = si[SI_START1];
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x) {
        const float uc = static_cast<float>(fine)
            + (static_cast<float>(s) + 0.5f) * d.sps_f;
        const float thc = cdf2 * (uc + 1.f);
        const float cc = cosf(thc), sc = sinf(thc);
        ta[s] = cr[s] * cc + ci[s] * sc;
        tb[s] = ci[s] * cc - cr[s] * sc;
        const int lo = start1 + s * d.sps;
        tc[s] = static_cast<float>(min(max(lo + d.sps, 0), d.T)
                                   - min(max(lo, 0), d.T));
    }
    __syncthreads();
    movsum(tc, n_sym, xp, cs, tmp, ms[0]);
    movsum(ta, n_sym, xp, cs, tmp, ms[1]);
    movsum(tb, n_sym, xp, cs, tmp, ms[2]);
    for (int s = threadIdx.x; s < n_sym; s += blockDim.x) {
        const float den = fmaxf(ms[0][s], 1.f);
        b.g_re[w * n_sym + s] = 2.f * ms[1][s] / den;
        b.g_im[w * n_sym + s] = 2.f * ms[2][s] / den;
    }
    if (threadIdx.x == 0) sf[SF_CDF2] = cdf2;
}

// Subtract the refit burst: the second pass's reference twisted by df2,
// times the gain of its symbol, masked to the window.
__global__ void __launch_bounds__(SPAN_THREADS)
k_apply(SubDims d, SubBufs b) {
    const int w = blockIdx.y, c = blockIdx.x;
    if (!b.si[w * SI_N + SI_ACTIVE]) return;
    const int fine = b.si[w * SI_N + SI_FINE];
    const int m = b.si[w * SI_N + SI_M];
    const int blk1 = b.si[w * SI_N + SI_BLK1];
    const float cf = b.sf[w * SF_N + SF_CF];
    const float cdf2 = b.sf[w * SF_N + SF_CDF2];
    const float* g_re = b.g_re + w * d.n_sym;
    const float* g_im = b.g_im + w * d.n_sym;
    float* seg = b.res + static_cast<size_t>(w) * d.row
        + static_cast<size_t>(m) * d.hop;
    const int j = c * SPAN_THREADS + threadIdx.x;
    for_phase(d, b, w, j, fine, cf, [&](int u, float ph, bool in) {
        if (!in) return;
        const float mk = (u >= fine && u < fine + d.L) ? 1.f : 0.f;
        const float zr = cosf(ph) * mk;
        const float zi = sinf(ph) * mk;
        const float th2 = cdf2 * (static_cast<float>(u) + 1.f);
        const float ct = cosf(th2), st = sinf(th2);
        const float zr2 = zr * ct - zi * st;
        const float zi2 = zi * ct + zr * st;
        const int q = u / d.sps;
        const int r = u - q * d.sps;
        const int gk = r >= fine ? q : q - 1;   // gain_pad index - 1
        const bool gin = gk >= 0 && gk < d.n_sym;
        const float ar = gin ? g_re[gk] : 0.f;
        const float ai = gin ? g_im[gk] : 0.f;
        float sub = ar * zr2 - ai * zi2;
        const long long pos = static_cast<long long>(blk1) * d.hop + u;
        sub = sub * ((pos >= 0 && pos < d.T) ? 1.f : 0.f);
        seg[u] = seg[u] - sub;
    });
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
    return 3LL * d.n_sym + 2LL * (d.n_sym + 1)
        + 3LL * (d.n1 + d.n2 + 2LL * d.n3 + d.scan_tmp) + SF_N;
}

SubBufs make_bufs(const SubDims& d, float* f, int32_t* si) {
    SubBufs b{};
    const size_t B = static_cast<size_t>(d.B);
    auto take = [&](size_t n) {
        float* p = f;
        f += n;
        return p;
    };
    b.sf = take(B * SF_N);
    b.tones = take(B * d.n_sym);
    b.g_re = take(B * d.n_sym);
    b.g_im = take(B * d.n_sym);
    b.bw_re = take(B * (d.n_sym + 1));
    b.bw_im = take(B * (d.n_sym + 1));
    float** sets[3][5] = {{&b.ph_v1, &b.ph_v2, &b.ph_v3, &b.ph_p3, &b.ph_tmp},
                          {&b.cr_v1, &b.cr_v2, &b.cr_v3, &b.cr_p3, &b.cr_tmp},
                          {&b.ci_v1, &b.ci_v2, &b.ci_v3, &b.ci_p3, &b.ci_tmp}};
    for (auto& s : sets) {
        *s[0] = take(B * d.n1);
        *s[1] = take(B * d.n2);
        *s[2] = take(B * d.n3);
        *s[3] = take(B * d.n3);
        *s[4] = take(B * d.scan_tmp);
    }
    b.si = si;
    return b;
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
    *n_int = static_cast<long long>(d.B) * SI_N;
    return static_cast<long long>(d.B) * sub_floats_per_window(d);
}

// Subtract every window's known bursts from res [B, row] in place, on
// `stream`: 1 + 10 * m_bursts launches, no host sync.  shifts, if not
// null, is [B, m_bursts] int32 and takes each fitted step's integer time
// shift.  Returns the first cudaError_t of the launches (0 = success).
int gfsk_subtract_launch(const int* dims, const float* consts, void* res,
                         const void* params, const void* gen_par,
                         const void* pulse, const void* templ,
                         const void* data_idx, const void* gray,
                         void* scratch_f, void* scratch_i, void* shifts,
                         void* stream) {
    const SubDims d = make_dims(dims, consts);
    if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
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
    const dim3 span(d.n3, d.B);
    k_init<<<ceil_div(d.B, 128), 128, 0, st>>>(d, b);
    cudaError_t err = cudaGetLastError();
    for (int mi = 0; mi < d.m_bursts && err == cudaSuccess; ++mi) {
        k_setup<<<d.B, SMALL_THREADS, 0, st>>>(d, b, mi);
        for (int pass = 0; pass < 2; ++pass) {
            k_phase_up<<<span, SPAN_THREADS, 0, st>>>(d, b);
            k_phase_scan<<<d.B, SMALL_THREADS, 0, st>>>(d, b);
            k_corr_up<<<span, SPAN_THREADS, 0, st>>>(d, b);
            k_estimate<<<d.B, SMALL_THREADS, 0, st>>>(d, b, pass, mi);
        }
        k_apply<<<span, SPAN_THREADS, 0, st>>>(d, b);
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
