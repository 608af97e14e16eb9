// Fused OFDM symbol demodulation, in the two modes of its TPU original.
//
// Replaces the TPU kernel lte_cell_scanner_tpu/ops/fd_demod_pallas.py
// `_kernel` in both of its modes, from one kernel body templated on the
// sample type and on where the bulk phase goes:
//
//   MIB mode (fd_demod_launch): f32 capture samples, bulk phase before the
//     DFT (pre_bpo=True), the 128->72 DFT of ops/mib_torch.py::_dft72;
//     the MIB chain's extract_tfg (search path).
//   stream mode (fd_demod_stream_launch): the tracker's raw u8 I/Q stream,
//     converted (v - 127)/128 in registers, bulk phase after the DFT
//     (pre_bpo=False), the DFT of tracker/batch_frontend.py::_dft_mats
//     (2-sample rotation folded in); the tracker engine's symbol demod.
//
// For every window n starting at sample idx[n]:
//
//   a = floor(idx/128), b = idx mod 128
//   g[c]  = s[row(c)*128 + c], row(c) = clamp(c >= b ? a : a+1)  (blend)
//   j[c]  = c - b + 128*(c < b)                  (true in-window index)
//   x[c]  = g[c] * exp(i*(bpo + foc*j[c]))       MIB mode
//         = g[c] * exp(i*foc*j[c])               stream mode
//   y[k]  = sum_c x[c] * W[c, k]                  (128 -> 72 bins)
//   out[k] = y[k] * exp(-i*2*pi*(late - b)*cn[k]/128)          MIB mode
//          = y[k] * exp(i*(bpo - (2*pi/128)*(late - b)*cn[k]))  stream mode
//
// (the expression orders of fd_demod_pallas.py:86 and :98-101). The row
// gather happens inside the kernel, with the pad of the TPU path past the
// end of the samples (0.0 for f32; the u8 value 127, which converts to
// 0.0) and the row clamp of ops/sync_torch.py::_aligned_wins.
//
// Bound on the H100: operations. 128*72*8 flops of f32 DFT per window:
// at the tracker's full width (96 cells x 300 ms, N = 403,200 windows)
// 29.7 GFLOP (~0.44 ms at 67 TFLOP/s) against ~240 MB of stream,
// parameters and output (~0.07 ms at 3.35 TB/s); at the MIB batch of 64
// candidates (N = 25,216) 1.86 GFLOP against ~16 MB. Design: the two
// 128x72 DFT matrices (73.7 KB) are staged once per block in dynamic
// shared memory, and each block walks over groups of 16 windows
// (grid-stride). A group's rotated windows go to shared memory; thread
// (k, q) then accumulates bin k of four windows, so each matrix element
// read from shared memory feeds 16 FMAs. Precise sincosf throughout: the
// post-DFT angle reaches 2*pi*127*36/128 ~ 224 rad in stream mode.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 72;
constexpr int kWin = 128;
constexpr int kWinPerGroup = 16;
constexpr int kWinPerThread = 4;
constexpr int kThreads = kBins * (kWinPerGroup / kWinPerThread);   // 288
constexpr int kRowStride = kWin + 1;   // float2 pad: no bank conflicts
constexpr size_t kSmemBytes =
    2 * kWin * kBins * sizeof(float) +
    kWinPerGroup * kRowStride * sizeof(float2);

__device__ __forceinline__ int floor_div128(int s)
{
    return s >= 0 ? s / kWin : -((-s + kWin - 1) / kWin);
}

__device__ __forceinline__ float2 load_sample(const float2* s, int p, int n)
{
    return p < n ? s[p] : make_float2(0.f, 0.f);
}

__device__ __forceinline__ float2 load_sample(const uchar2* s, int p, int n)
{
    const uchar2 v = p < n ? s[p] : make_uchar2(127, 127);
    return make_float2(((float)v.x - 127.f) * (1.f / 128.f),
                       ((float)v.y - 127.f) * (1.f / 128.f));
}

template <typename Sample, bool kPreBpo>
__global__ void __launch_bounds__(kThreads)
fd_demod_kernel(const Sample* __restrict__ cap, int n_cap, int n_rows,
                const int* __restrict__ idx, const float* __restrict__ foc,
                const float* __restrict__ bpo, const float* __restrict__ late,
                const float* __restrict__ wr_g, const float* __restrict__ wi_g,
                const float* __restrict__ cn_g, int n_win,
                float2* __restrict__ out)
{
    extern __shared__ float4 smem_raw[];
    float* wr = reinterpret_cast<float*>(smem_raw);
    float* wi = wr + kWin * kBins;
    float2* xs = reinterpret_cast<float2*>(wi + kWin * kBins);

    const int tid = threadIdx.x;
    for (int i = tid; i < kWin * kBins; i += kThreads) {
        wr[i] = wr_g[i];
        wi[i] = wi_g[i];
    }
    const int k = tid % kBins;
    const int q = tid / kBins;
    const float cnk = cn_g[k];

    const int n_groups = (n_win + kWinPerGroup - 1) / kWinPerGroup;
    for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
        __syncthreads();   // matrices staged; previous group's reads done
        for (int i = tid; i < kWinPerGroup * kWin; i += kThreads) {
            const int w = i / kWin, c = i % kWin;
            const int n = grp * kWinPerGroup + w;
            float2 v = make_float2(0.f, 0.f);
            if (n < n_win) {
                const int s = idx[n];
                const int a = floor_div128(s);
                const int b = s - a * kWin;
                int row = c >= b ? a : a + 1;
                row = row < 0 ? 0 : (row > n_rows - 1 ? n_rows - 1 : row);
                const float2 g = load_sample(cap, row * kWin + c, n_cap);
                const float j = (float)(c - b + (c >= b ? 0 : kWin));
                const float ph = kPreBpo ? bpo[n] + foc[n] * j : foc[n] * j;
                float sn, cs;
                sincosf(ph, &sn, &cs);
                v.x = g.x * cs - g.y * sn;
                v.y = g.x * sn + g.y * cs;
            }
            xs[w * kRowStride + c] = v;
        }
        __syncthreads();

        float yr[kWinPerThread], yi[kWinPerThread];
#pragma unroll
        for (int u = 0; u < kWinPerThread; ++u) {
            yr[u] = 0.f;
            yi[u] = 0.f;
        }
#pragma unroll 4
        for (int c = 0; c < kWin; ++c) {
            const float a = wr[c * kBins + k];
            const float b = wi[c * kBins + k];
#pragma unroll
            for (int u = 0; u < kWinPerThread; ++u) {
                const float2 x = xs[(q * kWinPerThread + u) * kRowStride + c];
                yr[u] += x.x * a - x.y * b;
                yi[u] += x.x * b + x.y * a;
            }
        }
#pragma unroll
        for (int u = 0; u < kWinPerThread; ++u) {
            const int n = grp * kWinPerGroup + q * kWinPerThread + u;
            if (n < n_win) {
                const int s = idx[n];
                const float b = (float)(s - floor_div128(s) * kWin);
                const float ang = kPreBpo
                    ? -6.283185307179586f * (late[n] - b) * cnk / 128.0f
                    : bpo[n] - (6.283185307179586f / 128.0f)
                          * (late[n] - b) * cnk;
                float sn, cs;
                sincosf(ang, &sn, &cs);
                out[(size_t)n * kBins + k] =
                    make_float2(yr[u] * cs - yi[u] * sn,
                                yr[u] * sn + yi[u] * cs);
            }
        }
    }
}

template <typename Sample, bool kPreBpo>
int launch(const Sample* cap, int n_cap, const int* idx, const float* foc,
           const float* bpo, const float* late, const float* wr,
           const float* wi, const float* cn, int n_win, float* out,
           void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        fd_demod_kernel<Sample, kPreBpo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const int n_groups = (n_win + kWinPerGroup - 1) / kWinPerGroup;
    int grid = 2 * n_sm;
    if (grid > n_groups) grid = n_groups;
    if (grid < 1) grid = 1;
    const int n_rows = (n_cap + kWin - 1) / kWin;
    fd_demod_kernel<Sample, kPreBpo>
        <<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
            cap, n_cap, n_rows, idx, foc, bpo, late, wr, wi, cn, n_win,
            reinterpret_cast<float2*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

// MIB mode: cap (n_cap, 2) f32.
extern "C" int fd_demod_launch(const float* cap, int n_cap, const int* idx,
                               const float* foc, const float* bpo,
                               const float* late, const float* wr,
                               const float* wi, const float* cn, int n_win,
                               float* out, void* stream)
{
    return launch<float2, true>(reinterpret_cast<const float2*>(cap), n_cap,
                                idx, foc, bpo, late, wr, wi, cn, n_win, out,
                                stream);
}

// Stream mode: seg (n_seg, 2) u8 raw I/Q.
extern "C" int fd_demod_stream_launch(const unsigned char* seg, int n_seg,
                                      const int* idx, const float* foc,
                                      const float* bpo, const float* late,
                                      const float* wr, const float* wi,
                                      const float* cn, int n_win, float* out,
                                      void* stream)
{
    return launch<uchar2, false>(reinterpret_cast<const uchar2*>(seg), n_seg,
                                 idx, foc, bpo, late, wr, wi, cn, n_win, out,
                                 stream);
}
