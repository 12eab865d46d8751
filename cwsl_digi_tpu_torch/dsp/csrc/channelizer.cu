// Channelizer as one complex GEMM on the tensor cores, for every channel of
// a receiver.
//
// Replaces the TPU kernel cwsl_digi_tpu/dsp/pallas_channelizer.py:_kernel
// (launched by _pallas_call at :138, wrapped by PallasChannelizer).  With
// the NCO mix folded into the taps, G[c,k] = filt[k]*exp(j*pd_c*k) (built
// once on the host in float64), one streamed block is
//
//     Y[c,t]   = sum_{k<FO} G[c,k] * iq_ext[t*BS + k]         (complex GEMM)
//     out[c,t] = Re(R[c,t] * Y[c,t] * (j*sign)^(out_phase+t))
//     R[c,t]   = exp(j*pd_c*(A0 + t*BS)) = rot[tile,c] * coarse[c, t-t0]
//
// and in real form [Yr; Yi] = [[Gr, -Gi], [Gi, Gr]] @ [Xr; Xi], with
// X[k,t] = iq_ext[t*BS + k] the Hankel view of the IQ, shared by every
// channel: M = 2C, N = n_out, K = 2*FO.
//
// What bounds it on an H100: 8*C*FO*n_out FLOP per block (0.81 GFLOP for
// 64 channels x 3072 outputs at 192 kHz) against ~1.2 MB of IQ and audio:
// compute-bound.  The design:
//
//   - tensor cores, mma.sync.m16n8k16 in bf16 with float32 accumulation,
//     three products per pair (split-bf16: a_hi*b_hi + a_hi*b_lo +
//     a_lo*b_hi, each operand the sum of two bf16) so the sums keep ~16
//     bits where one bf16 product keeps 8: the kernel is held to 1e-4 of its
//     float32 plain version.  On an H100 mma.sync runs bf16 at twice the
//     rate of TF32 per FLOP, so this does the work of 3xTF32 in half the
//     tensor time.  The taps are split on the host, once; the IQ once per
//     block, as it is staged;
//   - a block (128 threads) owns 16 channels x N_TILE = 48 outputs; its 4
//     warps split K (the taps) four ways and meet in shared memory at the
//     end, with no atomics.  A 64-channel receiver's 3072-output chunk is
//     64 x 4 = 256 blocks, 1.94 per SM of 132 (64-output tiles would give
//     192 blocks, two on some SMs and one on others);
//   - A (the taps, the large operand: 8*C*FO bytes with hi and lo) goes
//     from L2 straight into registers, pre-arranged on the host in mma
//     fragment order (two 16-byte loads per lane per 16 taps), prefetched
//     one k-step ahead; each A fragment is read once per block and reused
//     across the block's N_TILE outputs.  The Xi half of A is the Xr half
//     with rows swapped and negated, so only [Gr | Gi] is stored;
//   - B (the IQ) is one contiguous span of (N_TILE-1)*BS + FO samples per
//     block, stored polyphase in shared memory by pairs of phases:
//     s[p][b] = {re hi, re lo, im hi, im lo}, each a bf16 pair of samples
//     b*BS + 2p and b*BS + 2p + 1.  X[k,t] = s[(k%BS)/2][t + k/BS] half
//     k%2, so a B fragment (taps 2q, 2q+1 of output g) is one 16-byte load
//     of the span as staged, with no expansion, and the row pitch (= 2 mod
//     8 entries) puts each quarter-warp of a load on 8 distinct 16-byte
//     slots;
//   - rows are ordered so one thread's accumulators hold the real and
//     imaginary parts of the same (channel, output); the epilogue applies R
//     (two float32 unit phasors from float64 host angles: no phase is
//     accumulated on the device), selects the real part and writes float32
//     audio, coalesced.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchannelizer.so channelizer.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_TILE = 48;     // outputs per block
constexpr int NJ = N_TILE / 8; // n8 tiles per block
constexpr int JG = 3;          // n8 tiles whose B fragments are held at once
constexpr int C_TILE = 16;     // channels per block (two m16 tiles)
constexpr int WARPS = 4;       // split of K inside the block
constexpr int THREADS = 32 * WARPS;
constexpr int RED_PITCH = N_TILE + 8;   // float2 row pitch of the reduction

// smallest pitch >= n that is 2 mod 8, in 16-byte entries: lane (g, q) of a
// fragment load reads entry q*pitch + g (+ a constant), so each quarter-warp
// (g even and odd, q = 0..3) meets 8 distinct 16-byte slots
__host__ __device__ inline int iq_pitch(int n) {
    return n + (((2 - n) % 8) + 8) % 8;
}

// (x0, x1) as two bf16x2 words: hi = the pair rounded to bf16, lo = the
// rest rounded to bf16 (x0 in the low halves)
__device__ __forceinline__ uint2 split_bf16(float x0, float x1) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        x0 - __low2float(hi), x1 - __high2float(hi));
    return make_uint2(*reinterpret_cast<const uint32_t*>(&hi),
                      *reinterpret_cast<const uint32_t*>(&lo));
}

// d += a * b on one m16n8k16 bf16 tile, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
channelize_kernel(const float2* __restrict__ iq,      // [n_ext]
                  const uint4* __restrict__ taps,     // [C_pad/8, FO/16, 32, 2]
                  const float2* __restrict__ coarse,  // [C, N_TILE]
                  const float2* __restrict__ rot,     // [n_tiles, C]
                  float* __restrict__ out,            // [C, n_out]
                  int n_ch, int n_ext, int n_out, int bs, int fo,
                  int out_phase, float sign) {
    extern __shared__ uint4 smem_raw[];
    const int nws = fo / bs;
    const int nb = N_TILE + nws - 1;       // BS-blocks spanned by one tile
    const int n_pairs = bs / 2;            // phase pairs per BS-block
    const int pitch = iq_pitch(nb);
    const uint4* s_iq = smem_raw;          // [n_pairs][pitch]
    float2* s_red = reinterpret_cast<float2*>(smem_raw + n_pairs * pitch);
                                            // [WARPS][C_TILE][RED_PITCH]

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int tile = blockIdx.x;
    const int t0 = tile * N_TILE;
    const int c0 = blockIdx.y * C_TILE;
    const int n_ks = fo >> 4;              // k-steps of 16 taps
    const int ks_per_warp = n_ks / WARPS;
    const int ks0 = warp * ks_per_warp;

    // A fragments of this warp's first k-step, for both m16 tiles
    const uint4* a_ptr[2];
    uint4 a_next[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        a_ptr[mt] = taps + ((static_cast<long>(blockIdx.y * 2 + mt) * n_ks
                             + ks0) * 32 + lane) * 2;
        a_next[mt][0] = __ldg(a_ptr[mt]);
        a_next[mt][1] = __ldg(a_ptr[mt] + 1);
    }

    // the tile's IQ span, by phase pairs, split into bf16 hi and lo
    {
        const float4* iq2 = reinterpret_cast<const float4*>(iq);
        const long base2 = static_cast<long>(t0) * n_pairs;  // in pairs
        const long n_ext2 = n_ext / 2;
        uint4* s_w = smem_raw;
        const int span2 = nb * n_pairs;
#pragma unroll 4
        for (int u = tid; u < span2; u += THREADS) {
            const long i = base2 + u;
            const float4 v = i < n_ext2 ? iq2[i]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
            const int b = u / n_pairs;
            const int p = u - b * n_pairs;
            const uint2 re = split_bf16(v.x, v.z);
            const uint2 im = split_bf16(v.y, v.w);
            s_w[p * pitch + b] = make_uint4(re.x, re.y, im.x, im.y);
        }
    }
    __syncthreads();

    float acc[2][NJ][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    for (int s = 0; s < ks_per_warp; ++s) {
        // A operands: Xr half (a0..a3 = Gr,Gi at taps 2q,2q+1; Gr,Gi at
        // taps 2q+8,2q+9) and Xi half (-a1, a0, -a3, a2), each hi and lo
        constexpr uint32_t NEG = 0x80008000u;
        uint32_t ar_hi[2][4], ar_lo[2][4], ai_hi[2][4], ai_lo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            const uint4 h = a_next[mt][0], l = a_next[mt][1];
            ar_hi[mt][0] = h.x; ar_hi[mt][1] = h.y;
            ar_hi[mt][2] = h.z; ar_hi[mt][3] = h.w;
            ar_lo[mt][0] = l.x; ar_lo[mt][1] = l.y;
            ar_lo[mt][2] = l.z; ar_lo[mt][3] = l.w;
            ai_hi[mt][0] = h.y ^ NEG; ai_hi[mt][1] = h.x;
            ai_hi[mt][2] = h.w ^ NEG; ai_hi[mt][3] = h.z;
            ai_lo[mt][0] = l.y ^ NEG; ai_lo[mt][1] = l.x;
            ai_lo[mt][2] = l.w ^ NEG; ai_lo[mt][3] = l.z;
        }
        if (s + 1 < ks_per_warp) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                a_next[mt][0] = __ldg(a_ptr[mt] + (s + 1) * 64);
                a_next[mt][1] = __ldg(a_ptr[mt] + (s + 1) * 64 + 1);
            }
        }
        // B rows of this lane: taps k0+2q,+1 and k0+2q+8,+9 of output g,
        // at s[(k%bs)/2][k/bs + t]
        const int ka = (ks0 + s) * 16 + 2 * q;
        const int kb = ka + 8;
        const uint4* b_a = s_iq + ((ka % bs) >> 1) * pitch + ka / bs + g;
        const uint4* b_b = s_iq + ((kb % bs) >> 1) * pitch + kb / bs + g;
#pragma unroll
        for (int jh = 0; jh < NJ / JG; ++jh) {
            // B fragments of JG n8 tiles: {re hi, re lo, im hi, im lo} at
            // both rows
            uint4 xa[JG], xb[JG];
#pragma unroll
            for (int jj = 0; jj < JG; ++jj) {
                xa[jj] = b_a[(jh * JG + jj) * 8];
                xb[jj] = b_b[(jh * JG + jj) * 8];
            }
            // 2*JG independent accumulators between dependent mmas
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int jj = 0; jj < JG; ++jj)
                    mma_bf16(acc[mt][jh * JG + jj], ar_lo[mt], xa[jj].x,
                             xb[jj].x);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int jj = 0; jj < JG; ++jj)
                    mma_bf16(acc[mt][jh * JG + jj], ai_lo[mt], xa[jj].z,
                             xb[jj].z);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int jj = 0; jj < JG; ++jj)
                    mma_bf16(acc[mt][jh * JG + jj], ar_hi[mt], xa[jj].y,
                             xb[jj].y);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int jj = 0; jj < JG; ++jj)
                    mma_bf16(acc[mt][jh * JG + jj], ai_hi[mt], xa[jj].w,
                             xb[jj].w);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int jj = 0; jj < JG; ++jj)
                    mma_bf16(acc[mt][jh * JG + jj], ar_hi[mt], xa[jj].x,
                             xb[jj].x);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int jj = 0; jj < JG; ++jj)
                    mma_bf16(acc[mt][jh * JG + jj], ai_hi[mt], xa[jj].z,
                             xb[jj].z);
        }
    }

    // the warps' partial sums meet in shared memory: (re, im) pairs of
    // channel mt*8+g at outputs 8j+2q and 8j+2q+1
    float2* red = s_red + warp * C_TILE * RED_PITCH;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            *reinterpret_cast<float4*>(
                red + (mt * 8 + g) * RED_PITCH + j * 8 + 2 * q) =
                make_float4(acc[mt][j][0], acc[mt][j][2],
                            acc[mt][j][1], acc[mt][j][3]);
    __syncthreads();

    for (int idx = tid; idx < C_TILE * N_TILE; idx += THREADS) {
        const int cl = idx / N_TILE;
        const int tl = idx - cl * N_TILE;
        const int c = c0 + cl;
        const int t = t0 + tl;
        if (c >= n_ch || t >= n_out) continue;
        float2 y = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float2 p = s_red[(w * C_TILE + cl) * RED_PITCH + tl];
            y.x += p.x;
            y.y += p.y;
        }
        const float2 rc = rot[static_cast<long>(tile) * n_ch + c];
        const float2 co = coarse[static_cast<long>(c) * N_TILE + tl];
        const float2 r = make_float2(rc.x * co.x - rc.y * co.y,
                                     rc.x * co.y + rc.y * co.x);
        const float zr = r.x * y.x - r.y * y.y;
        const float zi = r.x * y.y + r.y * y.x;
        const int ph = (out_phase + t) & 3;
        float val;
        if (ph == 0) val = zr;
        else if (ph == 1) val = -sign * zi;
        else if (ph == 2) val = -zr;
        else val = sign * zi;
        out[static_cast<long>(c) * n_out + t] = val;
    }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (bs, fo) filter, in bytes.
int channelize_smem_bytes(int bs, int fo) {
    const int pitch = iq_pitch(N_TILE + fo / bs - 1);
    return (bs / 2) * pitch * static_cast<int>(sizeof(uint4))
           + WARPS * C_TILE * RED_PITCH * static_cast<int>(sizeof(float2));
}

int channelize_tile_out() { return N_TILE; }
int channelize_tile_channels() { return C_TILE; }
int channelize_warps() { return WARPS; }

// Let the kernel use `smem` bytes of dynamic shared memory on the current
// device; returns the cudaError_t (0 = success).  The caller does this once
// per device and larger need, before launching (dsp/_kernels.py).
int channelize_allow_smem(int smem) {
    return static_cast<int>(cudaFuncSetAttribute(
        channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int channelize_launch(const void* iq, const void* taps, const void* coarse,
                      const void* rot, void* out, int n_ch, int n_ext,
                      int n_out, int bs, int fo, int out_phase, float sign,
                      void* stream) {
    const int smem = channelize_smem_bytes(bs, fo);
    const dim3 grid((n_out + N_TILE - 1) / N_TILE,
                    (n_ch + C_TILE - 1) / C_TILE);
    channelize_kernel<<<grid, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<const uint4*>(taps),
        static_cast<const float2*>(coarse), static_cast<const float2*>(rot),
        static_cast<float*>(out), n_ch, n_ext, n_out, bs, fo, out_phase,
        sign);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
