// Fused NCO mix + polyphase FIR decimation for every channel of a receiver.
//
// Replaces the TPU kernel cwsl_digi_tpu/dsp/pallas_channelizer.py:_kernel
// (launched by _pallas_call at :138, wrapped by PallasChannelizer).  It
// computes, for each channel c and output t of one streamed block,
//
//     buf[i]   = iq[i] * exp(j*pd_c*(A0 + i))          (raw tail + block)
//     y[t]     = sum_{k<FO} filt[k] * buf[t*BS + k]
//     out[c,t] = Re(y[t] * (j*sign)^(out_phase + t))
//
// What bounds it on an H100: at 192 kHz (BS=16, FO=512) each output costs
// FO complex-by-real taps, ~26 MFLOP of FP32 FMA per channel-second, against
// 48 KB of float32 output and 1.5 MB of IQ shared by every channel.  That is
// hundreds of operations per byte: compute-bound on the CUDA cores, and the
// design keeps the FIR's operands on chip:
//
//   - one block takes one time tile (TILE_OUT outputs) for TILE_C channels;
//     the tile's raw IQ, with its FO-BS halo, is read from device memory
//     ONCE into shared memory and reused by all TILE_C channels;
//   - per channel, the block mixes the tile with the NCO tone into shared
//     memory (the mixed signal never goes to device memory), then every
//     thread runs the FO-tap FIR of one output from shared memory;
//   - shared arrays are stored transposed as [BS][blocks] so the FIR's
//     reads of consecutive outputs hit consecutive addresses (no bank
//     conflicts), and the taps are read as a broadcast;
//   - the NCO phase is never accumulated on the device: the tone of local
//     sample u = b*BS + r is rot[tile,c] * coarse[c,b] * fine[c,r], three
//     unit phasors each built from float64 host angles wrapped to [-pi, pi),
//     so phase error is a few float32 roundings at any stream length.
//
// Simple first: no tensor cores, TMA or register blocking yet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libchannelizer.so channelizer.cu

#include <cuda_runtime.h>

namespace {

constexpr int TILE_OUT = 256;   // outputs per block, one per thread
constexpr int TILE_C = 8;       // channels per block

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(TILE_OUT)
channelize_kernel(const float2* __restrict__ iq,      // [n_ext]
                  const float2* __restrict__ coarse,  // [C, nb]
                  const float2* __restrict__ fine,    // [C, bs]
                  const float2* __restrict__ rot,     // [n_tiles, C]
                  const float* __restrict__ filt,     // [fo]
                  float* __restrict__ out,            // [C, n_out]
                  int n_ch, int n_ext, int n_out, int bs, int fo,
                  int out_phase, float sign) {
    extern __shared__ float4 smem_raw[];
    const int nws = fo / bs;
    const int nb = TILE_OUT + nws - 1;     // BS-blocks spanned by one tile
    const int nbp = nb | 1;                // odd row pitch (see the load)
    float2* s_iq = reinterpret_cast<float2*>(smem_raw);   // [bs][nbp]
    float2* s_mix = s_iq + bs * nbp;                      // [bs][nbp]
    float* s_filt = reinterpret_cast<float*>(s_mix + bs * nbp);  // [fo]

    const int tid = threadIdx.x;
    const int tile = blockIdx.x;
    const int t0 = tile * TILE_OUT;        // first output of the tile
    const long base = static_cast<long>(t0) * bs;   // first iq sample
    const int span = nb * bs;

    for (int k = tid; k < fo; k += blockDim.x) s_filt[k] = filt[k];
    // coalesced global read; transposed shared write (odd pitch keeps the
    // stride-nbp writes of a half-warp on distinct banks)
    for (int u = tid; u < span; u += blockDim.x) {
        const long i = base + u;
        const float2 v = i < n_ext ? iq[i] : make_float2(0.f, 0.f);
        const int b = u / bs;
        s_iq[(u - b * bs) * nbp + b] = v;
    }

    const int t = t0 + tid;
    const int ph = (out_phase + t) & 3;
    const int c_end = min(n_ch, (blockIdx.y + 1) * TILE_C);
    for (int c = blockIdx.y * TILE_C; c < c_end; ++c) {
        const float2 rc = rot[static_cast<long>(tile) * n_ch + c];
        const float2* co = coarse + static_cast<long>(c) * nb;
        const float2* fi = fine + static_cast<long>(c) * bs;
        __syncthreads();   // s_iq loaded / previous channel's FIR finished
        for (int idx = tid; idx < span; idx += blockDim.x) {
            const int r = idx / nb;
            const int b = idx - r * nb;
            const float2 tone = cmul(cmul(rc, co[b]), fi[r]);
            s_mix[r * nbp + b] = cmul(s_iq[r * nbp + b], tone);
        }
        __syncthreads();
        if (t < n_out) {
            float acc_re = 0.f, acc_im = 0.f;
            for (int s = 0; s < nws; ++s) {
                const float* h = s_filt + s * bs;
                const float2* m = s_mix + tid + s;
                for (int r = 0; r < bs; ++r) {
                    const float2 v = m[r * nbp];
                    acc_re = fmaf(h[r], v.x, acc_re);
                    acc_im = fmaf(h[r], v.y, acc_im);
                }
            }
            float val;
            if (ph == 0) val = acc_re;
            else if (ph == 1) val = -sign * acc_im;
            else if (ph == 2) val = -acc_re;
            else val = sign * acc_im;
            out[static_cast<long>(c) * n_out + t] = val;
        }
    }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (bs, fo) filter, in bytes.
int channelize_smem_bytes(int bs, int fo) {
    const int nb = TILE_OUT + fo / bs - 1;
    const int nbp = nb | 1;
    return 2 * bs * nbp * static_cast<int>(sizeof(float2))
           + fo * static_cast<int>(sizeof(float));
}

int channelize_tile_out() { return TILE_OUT; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int channelize_launch(const void* iq, const void* coarse, const void* fine,
                      const void* rot, const void* filt, void* out,
                      int n_ch, int n_ext, int n_out, int bs, int fo,
                      int out_phase, float sign, void* stream) {
    const int smem = channelize_smem_bytes(bs, fo);
    cudaError_t err = cudaFuncSetAttribute(
        channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_out + TILE_OUT - 1) / TILE_OUT,
                    (n_ch + TILE_C - 1) / TILE_C);
    channelize_kernel<<<grid, TILE_OUT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<const float2*>(coarse),
        static_cast<const float2*>(fine), static_cast<const float2*>(rot),
        static_cast<const float*>(filt), static_cast<float*>(out),
        n_ch, n_ext, n_out, bs, fo, out_phase, sign);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
