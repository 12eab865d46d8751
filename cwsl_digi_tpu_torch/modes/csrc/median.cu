// The exact median of each row of a map (median_rows), with no host sync:
// the q-ary modes' (JT65, Q65-30) sync-map and prior medians, WSPR's and
// the GFSK engine's SNR medians.
//
// It replaces jnp.median at cwsl_digi_tpu/modes/qary_engine.py:136 and
// :168, wspr.py:507 and gfsk_engine.py:676 (a full sort of each row).  Its
// plain version is modes/gfsk_engine.py:_median_rows_plain, a full
// torch.sort of each row.
//
// What bounds it on an H100: it reads each row once (JT65's 64-window sync
// map: 955 MB, ~0.29 ms of HBM) and writes one float a row, so bytes bound
// it.  The radix selection reads the row three times (an 11-bit digit a
// pass).
//
// The design: a radix selection on order-mapped 32-bit keys (-0.0 read as
// 0.0, as jnp.median's sort does), three passes of 11, 11 and 10 bits,
// each a launch of enough blocks a row to fill the card.  A block counts
// the digits of its part of the row that match the prefix found so far in
// shared memory, adds its histogram to the row's in device memory, and the
// row's last block (a ticket counter after __threadfence) finds the digit
// of the two middle ranks by a block scan and writes the prefix for the
// next pass.  The last pass writes the median: the middle key's value, or
// 0.5f * (a + b) of the two middle values for an even count; a row that
// holds a NaN has the median NaN, as jnp.median (its NaN keys fill the
// first pass's top bin).  Bitwise the plain version's.
//
// Built with --fmad=false and without fast math, so 0.5f * (a + b) is the
// IEEE float operations written here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;      // per-device settings kept

// The ascending order of float32 as uint32: -0.0 read as 0.0, every NaN
// above +inf.
__device__ __forceinline__ uint32_t order_key(float x) {
    if (x != x) return 0xffffffffu;
    const uint32_t u = x == 0.0f ? 0u : __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a non-NaN order key (a zero key gives +0.0).
__device__ __forceinline__ float key_value(uint32_t k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr int MED_THREADS = 512;
constexpr int MED_BINS = 2048;                   // 11-bit digits
constexpr int MED_PER = MED_BINS / MED_THREADS;  // bins a thread in a scan
// a row's workspace (uint32, zeroed before the first pass): the digit
// histograms of the two middle ranks [2][2048], the blocks done in this
// pass, the prefixes [2] and ranks [2] found so far, the NaN flag
constexpr int MED_WS_DONE = 2 * MED_BINS;
constexpr int MED_WS_PREFIX = MED_WS_DONE + 1;
constexpr int MED_WS_RANK = MED_WS_PREFIX + 2;
constexpr int MED_WS_NAN = MED_WS_RANK + 2;
constexpr int MED_WS_WORDS = MED_WS_NAN + 3;
constexpr int MED_UNROLL = 4;

// The digit d of `rank` in the row's histogram h (nbins, in device
// memory, read past L1): the first d whose inclusive count exceeds rank;
// returns d and writes rank less the count below d.  A block scan; every
// thread gets the result.
__device__ uint32_t find_digit(const uint32_t* h, int nbins, uint32_t rank,
                               uint32_t* rank_in, uint32_t* s_warp,
                               uint32_t* s_res) {
    const int per = nbins / MED_THREADS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t c[MED_PER];
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < MED_PER; ++j) {
        c[j] = j < per ? __ldcg(h + threadIdx.x * per + j) : 0u;
        mine += c[j];
    }
    uint32_t inc = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t o = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += o;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < MED_THREADS / 32 ? s_warp[lane] : 0u;
        uint32_t wi = w;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const uint32_t o = __shfl_up_sync(FULL, wi, off);
            if (lane >= off) wi += o;
        }
        if (lane < MED_THREADS / 32) s_warp[lane] = wi - w;   // exclusive
    }
    __syncthreads();
    uint32_t below = s_warp[warp] + inc - mine;
    if (below <= rank && rank < below + mine) {
#pragma unroll
        for (int j = 0; j < MED_PER; ++j) {
            if (j < per && rank < below + c[j]) {
                s_res[0] = threadIdx.x * per + j;
                s_res[1] = rank - below;
                break;
            }
            below += c[j];
        }
    }
    __syncthreads();
    const uint32_t d = s_res[0];
    *rank_in = s_res[1];
    __syncthreads();
    return d;
}

__global__ void __launch_bounds__(MED_THREADS, 2)
k_median_pass(const float* __restrict__ x, long long n, int pass,
              uint32_t* __restrict__ ws_all, float* __restrict__ out) {
    __shared__ uint32_t hist[2][MED_BINS];
    __shared__ uint32_t s_warp[MED_THREADS / 32];
    __shared__ uint32_t s_res[2];
    __shared__ int s_last;
    const int row = blockIdx.y;
    uint32_t* ws = ws_all + static_cast<long long>(row) * MED_WS_WORDS;
    const float* xr = x + static_cast<long long>(row) * n;
    const int shift_lo = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
    const int bits = pass == 2 ? 10 : 11;
    const int shift_hi = shift_lo + bits;
    const uint32_t dmask = (1u << bits) - 1u;
    uint32_t p0 = 0, p1 = 0;
    if (pass > 0) {
        if (ws[MED_WS_NAN]) return;
        p0 = ws[MED_WS_PREFIX];
        p1 = ws[MED_WS_PREFIX + 1];
    }
    const bool split = p0 != p1;
    for (int i = threadIdx.x; i < 2 * MED_BINS; i += MED_THREADS)
        (&hist[0][0])[i] = 0u;
    __syncthreads();

    // this block's part of the row, whole warps stepping together
    const long long per = (n + gridDim.x - 1) / gridDim.x;
    const long long lo = blockIdx.x * per;
    const long long hi = lo + per < n ? lo + per : n;
    const int lane = threadIdx.x & 31;
    const long long step = static_cast<long long>(MED_THREADS) * MED_UNROLL;
    for (long long base = lo + (threadIdx.x - lane); base < hi;
         base += step) {
        float v[MED_UNROLL];
#pragma unroll
        for (int u = 0; u < MED_UNROLL; ++u) {
            const long long i = base + static_cast<long long>(u) * MED_THREADS
                + lane;
            v[u] = i < hi ? __ldg(xr + i) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < MED_UNROLL; ++u) {
            const long long i = base + static_cast<long long>(u) * MED_THREADS
                + lane;
            if (i >= hi) continue;
            const uint32_t k = order_key(v[u]);
            const uint32_t dg = (k >> shift_lo) & dmask;
            if (pass == 0) {
                atomicAdd(&hist[0][dg], 1u);
            } else {
                const uint32_t pre = k >> shift_hi;
                if (pre == p0)
                    atomicAdd(&hist[0][dg], 1u);
                else if (split && pre == p1)
                    atomicAdd(&hist[1][dg], 1u);
            }
        }
    }
    __syncthreads();
    const int nbins = 1 << bits;
    for (int i = threadIdx.x; i < nbins; i += MED_THREADS) {
        if (hist[0][i]) atomicAdd(ws + i, hist[0][i]);
        if (split && hist[1][i]) atomicAdd(ws + MED_BINS + i, hist[1][i]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(ws + MED_WS_DONE, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    // the row's last block: the two middle ranks' digits
    const uint32_t k0 = static_cast<uint32_t>((n - 1) / 2);
    const uint32_t k1 = static_cast<uint32_t>(n / 2);
    if (pass == 0 && __ldcg(ws + MED_BINS - 1) != 0u) {
        // the top bin holds only NaN keys: the median is NaN
        if (threadIdx.x == 0) {
            ws[MED_WS_NAN] = 1u;
            out[row] = __uint_as_float(0x7fc00000u);
        }
        return;
    }
    const uint32_t r0 = pass == 0 ? k0 : ws[MED_WS_RANK];
    const uint32_t r1 = pass == 0 ? k1 : ws[MED_WS_RANK + 1];
    uint32_t n0, n1;
    const uint32_t d0 = find_digit(ws, nbins, r0, &n0, s_warp, s_res);
    const uint32_t d1 = find_digit(ws + (split ? MED_BINS : 0), nbins, r1,
                                   &n1, s_warp, s_res);
    const uint32_t q0 = (p0 << bits) | d0, q1 = (p1 << bits) | d1;
    for (int i = threadIdx.x; i < 2 * MED_BINS; i += MED_THREADS) ws[i] = 0u;
    if (threadIdx.x == 0) {
        ws[MED_WS_DONE] = 0u;
        ws[MED_WS_PREFIX] = q0;
        ws[MED_WS_PREFIX + 1] = q1;
        ws[MED_WS_RANK] = n0;
        ws[MED_WS_RANK + 1] = n1;
        if (pass == 2) {
            const float a = key_value(q0), b = key_value(q1);
            out[row] = (n & 1) ? a : 0.5f * (a + b);
        }
    }
}

// Blocks a row: enough to put about four blocks on every SM, at least
// 4096 entries a block.
int median_chunks(long long rows, long long n) {
    static int sms[MAX_DEVICES] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
        return -1;
    if (sms[dev] == 0 &&
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
        return -1;
    const long long want = (4LL * sms[dev] + rows - 1) / rows;
    const long long most = (n + 4095) / 4096;
    long long c = want < most ? want : most;
    if (c < 1) c = 1;
    if (c > 65535) c = 65535;
    return static_cast<int>(c);
}

}  // namespace

extern "C" {

int median_ws_words() { return MED_WS_WORDS; }

// Median of each of `rows` rows of n float32 (x [rows, n]) into out
// [rows]: ws [rows, MED_WS_WORDS] uint32, zeroed by the caller; three
// launches on `stream`.  Returns the cudaError_t.
int median_rows_launch(long long rows, long long n, const void* x, void* ws,
                       void* out, void* stream) {
    if (rows < 1 || rows > 65535 || n < 1 || n > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const int chunks = median_chunks(rows, n);
    if (chunks < 1) return static_cast<int>(cudaErrorInvalidDevice);
    const dim3 grid(chunks, static_cast<unsigned>(rows));
    for (int pass = 0; pass < 3; ++pass) {
        k_median_pass<<<grid, MED_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x), n, pass,
            static_cast<uint32_t*>(ws), static_cast<float*>(out));
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
}

// The kernel's registers a thread, local (spilled) bytes a thread, static
// shared bytes and threads a block at most (cudaFuncGetAttributes).  out
// [4].  Returns the cudaError_t.
int median_kernel_attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, k_median_pass);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = a.maxThreadsPerBlock;
    return 0;
}

}  // extern "C"
