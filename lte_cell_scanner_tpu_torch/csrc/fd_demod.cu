// Fused OFDM symbol demodulation, in the two modes of its TPU original,
// with the 128 -> 72 DFT computed as a 128-point FFT.
//
// Replaces the TPU kernel lte_cell_scanner_tpu/ops/fd_demod_pallas.py
// `_kernel` in both of its modes, from one kernel body templated on the
// sample type and on where the bulk phase goes:
//
//   MIB mode (fd_demod_launch): f32 capture samples, bulk phase before the
//     DFT (pre_bpo=True), the DFT MIB_DFT (shift 0); the MIB chain's
//     extract_tfg (search path).
//   stream mode (fd_demod_stream_launch): the tracker's raw u8 I/Q stream,
//     converted (v - 127)/128 in registers, bulk phase after the DFT
//     (pre_bpo=False), the DFT TRACKER_DFT (its 2-sample rotation is the
//     shift); the tracker engine's symbol demod.
//
// The DFT is named by its 72 output bins and the cyclic shift of its input
// (tracker/batch_frontend.py::SubcarrierDFT). For every window n starting
// at sample idx[n]:
//
//   a = floor(idx/128), b = idx mod 128
//   g[c]  = s[row(c)*128 + c], row(c) = clamp(c >= b ? a : a+1)  (blend)
//   j[c]  = c - b + 128*(c < b)                  (true in-window index)
//   x[c]  = g[c] * exp(i*(bpo + foc*j[c]))       MIB mode
//         = g[c] * exp(i*foc*j[c])               stream mode
//   X     = FFT_128(x)
//   y[k]  = X[bins[k]] * exp(+2*pi*i*shift*bins[k]/128) / sqrt(128)
//   out[k] = y[k] * exp(-i*2*pi*(late - b)*cn[k]/128)          MIB mode
//          = y[k] * exp(i*(bpo - (2*pi/128)*(late - b)*cn[k]))  stream mode
//
// with cn[k] the signed subcarrier index of bins[k] (the expression orders
// of fd_demod_pallas.py:86 and :98-101). The row gather happens inside the
// kernel, with the pad of the TPU path past the end of the samples (0.0
// for f32; the u8 value 127, which converts to 0.0) and the row clamp of
// ops/sync_torch.py::_aligned_wins.
//
// Bound on the H100: bytes. The FFT does ~3.2k flops per window (against
// 73.7k for the dense 128x72 product it replaces), ~5.4-5.9k with the
// rotations: at the tracker's full width (96 cells x 300 ms, N = 403,200
// windows) 2.4 GFLOP, ~0.035 ms at 67 TFLOP/s, against ~240 MB of stream,
// parameters and output, ~0.072 ms at 3.35 TB/s. At the MIB batch of 64
// candidates (N = 25,216) ~16 MB, ~0.005 ms. The precise sincosf of the
// 200 rotations per window (not counted in the bound) are about half of
// the instructions.
//
// Design: 8 threads per window, 16 windows per block of 128 threads, one
// block per 16 windows (so a tracker-path launch of a few hundred windows
// spreads over tens of SMs). With n = t + 8*m and k = k1 + 16*k2:
//   1. thread t gathers and rotates x[t + 8m], m = 0..15, straight into
//      registers (lane c is sample idx + j[c] unless a row is clamped);
//   2. a 16-point FFT over m in registers (radix-2 DIF down to radix-4
//      butterflies, twiddles as constants), then the twiddle W128^(t*k1)
//      from a 128-entry shared table (sincospif, whose reduction is exact);
//   3. a transpose through a padded shared tile (within the warp); thread
//      t then runs the 8-point FFTs over t for k1 = 2t and 2t+1, and
//      writes X[k1 + 16*k2] back in natural order;
//   4. the block's 16 x 72 outputs (contiguous, 9,216 B) are formed from
//      the tile, the per-bin shift factor and the post-rotation, and
//      stored as float4 by consecutive threads.
// Precise sincosf for both rotations: the post-FFT angle reaches
// 2*pi*127*36/128 ~ 224 rad in stream mode.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 72;
constexpr int kWin = 128;
constexpr int kLanes = 8;                     // threads per window
constexpr int kPts = kWin / kLanes;           // 16 points per thread
constexpr int kWinPerBlock = 16;
constexpr int kThreads = kLanes * kWinPerBlock;   // 128
constexpr int kRow = 9;                       // transpose row: 8 + 1 pad
constexpr int kTile = 153;                    // >= 16 * kRow; 9 mod 16
constexpr float kScale = 0.08838834764831845f;    // 1/sqrt(128)

// W16^n = exp(-2*pi*i*n/16), n = 0..7, rounded from float64.
__constant__ float2 kW16[8] = {
    {1.0f, 0.0f},
    {0.92387953251128674f, -0.38268343236508977f},
    {0.70710678118654752f, -0.70710678118654752f},
    {0.38268343236508977f, -0.92387953251128674f},
    {0.0f, -1.0f},
    {-0.38268343236508977f, -0.92387953251128674f},
    {-0.70710678118654752f, -0.70710678118654752f},
    {-0.92387953251128674f, -0.38268343236508977f},
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b)
{
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b)
{
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b)
{
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * W16^n for a compile-time n (after unrolling): 1 and -i are free.
__device__ __forceinline__ float2 rot16(float2 a, int n)
{
    if (n == 0) return a;
    if (n == 4) return make_float2(a.y, -a.x);
    return cmul(a, kW16[n]);
}

// In-place 4-point DFT, natural order.
__device__ __forceinline__ void fft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3)
{
    const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
    const float2 t2 = cadd(a1, a3), t3 = rot16(csub(a1, a3), 4);
    a0 = cadd(t0, t2);
    a1 = cadd(t1, t3);
    a2 = csub(t0, t2);
    a3 = csub(t1, t3);
}

// x = DFT_8(a), natural order (one radix-2 DIF step, then two radix-4).
__device__ __forceinline__ void fft8(const float2 (&a)[8], float2 (&x)[8])
{
    float2 e[4], o[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        e[n] = cadd(a[n], a[n + 4]);
        o[n] = rot16(csub(a[n], a[n + 4]), 2 * n);
    }
    fft4(e[0], e[1], e[2], e[3]);
    fft4(o[0], o[1], o[2], o[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        x[2 * k] = e[k];
        x[2 * k + 1] = o[k];
    }
}

// x = DFT_16(a), natural order (one radix-2 DIF step, then two DFT_8).
__device__ __forceinline__ void fft16(const float2 (&a)[16], float2 (&x)[16])
{
    float2 e[8], o[8], xe[8], xo[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        e[n] = cadd(a[n], a[n + 8]);
        o[n] = rot16(csub(a[n], a[n + 8]), n);
    }
    fft8(e, xe);
    fft8(o, xo);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        x[2 * k] = xe[k];
        x[2 * k + 1] = xo[k];
    }
}

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
                const int* __restrict__ bins, int shift, int n_win,
                float2* __restrict__ out)
{
    __shared__ float2 tw[kWin];                  // W128^m
    __shared__ float2 fac[kBins];                // shift factor / sqrt(128)
    __shared__ int bin_s[kBins];
    __shared__ float cn_s[kBins];
    __shared__ float late_b[kWinPerBlock];       // late - b
    __shared__ float post_bpo[kWinPerBlock];
    __shared__ __align__(16) float2 tile[kWinPerBlock * kTile];

    const int tid = threadIdx.x;
    {
        float sn, cs;
        sincospif((float)tid / 64.f, &sn, &cs);  // kThreads == kWin
        tw[tid] = make_float2(cs, -sn);
    }
    if (tid < kBins) {
        const int bin = bins[tid];
        float sn, cs;
        sincospif((float)((shift * bin) & (kWin - 1)) / 64.f, &sn, &cs);
        fac[tid] = make_float2(cs * kScale, sn * kScale);
        bin_s[tid] = bin;
        cn_s[tid] = (float)(bin < kWin / 2 ? bin : bin - kWin);
    }

    // ---- 1. gather, blend and pre-rotate x[t + 8m] into registers.
    const int w = tid / kLanes, t = tid % kLanes;
    const int n0 = blockIdx.x * kWinPerBlock;
    const int n = n0 + w;
    float2 v[kPts];
    if (n < n_win) {
        const int s = idx[n];
        const int a = floor_div128(s);
        const int b = s - a * kWin;
        const float f = foc[n];
        const float p0 = kPreBpo ? bpo[n] : 0.f;
        // Lane c reads row a (c >= b) or a+1 (c < b): sample s + j[c]
        // unless a row must be clamped.
        const bool inside = a >= 0 && a + 1 <= n_rows - 1;
#pragma unroll
        for (int m = 0; m < kPts; ++m) {
            const int c = t + kLanes * m;
            const int jc = c - b + (c >= b ? 0 : kWin);
            int p = s + jc;
            if (!inside) {
                int row = c >= b ? a : a + 1;
                row = row < 0 ? 0 : (row > n_rows - 1 ? n_rows - 1 : row);
                p = row * kWin + c;
            }
            const float2 g = load_sample(cap, p, n_cap);
            const float j = (float)jc;
            const float ph = kPreBpo ? p0 + f * j : f * j;
            float sn, cs;
            sincosf(ph, &sn, &cs);
            v[m] = make_float2(g.x * cs - g.y * sn, g.x * sn + g.y * cs);
        }
        if (t == 0) {
            late_b[w] = late[n] - (float)b;
            post_bpo[w] = kPreBpo ? 0.f : bpo[n];
        }
    } else {
#pragma unroll
        for (int m = 0; m < kPts; ++m) v[m] = make_float2(0.f, 0.f);
    }
    __syncthreads();   // twiddle tables ready

    // ---- 2. DFT_16 over m, twiddle W128^(t*k1), transpose.
    float2* tl = tile + w * kTile;
    {
        float2 z[kPts];
        fft16(v, z);
        tl[t] = z[0];
#pragma unroll
        for (int k1 = 1; k1 < kPts; ++k1)
            tl[k1 * kRow + t] = cmul(z[k1], tw[t * k1]);
    }
    __syncwarp();   // a window's 8 threads lie in one warp

    // ---- 3. DFT_8 over t for k1 = 2t, 2t+1: X[k1 + 16*k2].
    float2 y[2][kLanes];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        float2 col[kLanes];
#pragma unroll
        for (int q = 0; q < kLanes; ++q) col[q] = tl[(2 * t + e) * kRow + q];
        fft8(col, y[e]);
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k2 = 0; k2 < kLanes; ++k2)
            tl[2 * t + e + kPts * k2] = y[e][k2];
    __syncthreads();

    // ---- 4. bins, shift factor, post-rotation; coalesced float4 stores.
    const int n_here = min(kWinPerBlock, n_win - n0);
    float4* o4 = reinterpret_cast<float4*>(out + (size_t)n0 * kBins);
    for (int i = tid; i < n_here * (kBins / 2); i += kThreads) {
        const int ww = i / (kBins / 2);
        const int p = 2 * (i - ww * (kBins / 2));
        const float2* yrow = tile + ww * kTile;
        float2 r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int k = p + e;
            const float2 yk = cmul(yrow[bin_s[k]], fac[k]);
            const float ang = kPreBpo
                ? -6.283185307179586f * late_b[ww] * cn_s[k] / 128.0f
                : post_bpo[ww] - (6.283185307179586f / 128.0f)
                      * late_b[ww] * cn_s[k];
            float sn, cs;
            sincosf(ang, &sn, &cs);
            r[e] = make_float2(yk.x * cs - yk.y * sn, yk.x * sn + yk.y * cs);
        }
        o4[i] = make_float4(r[0].x, r[0].y, r[1].x, r[1].y);
    }
}

template <typename Sample, bool kPreBpo>
int launch(const Sample* cap, int n_cap, const int* idx, const float* foc,
           const float* bpo, const float* late, const int* bins, int shift,
           int n_win, float* out, void* stream)
{
    const int n_rows = (n_cap + kWin - 1) / kWin;
    if (n_rows < 1 || n_win < 1) return (int)cudaErrorInvalidValue;
    const int grid = (n_win + kWinPerBlock - 1) / kWinPerBlock;
    fd_demod_kernel<Sample, kPreBpo>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            cap, n_cap, n_rows, idx, foc, bpo, late, bins, shift, n_win,
            reinterpret_cast<float2*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

// MIB mode: cap (n_cap, 2) f32.
extern "C" int fd_demod_launch(const float* cap, int n_cap, const int* idx,
                               const float* foc, const float* bpo,
                               const float* late, const int* bins, int shift,
                               int n_win, float* out, void* stream)
{
    return launch<float2, true>(reinterpret_cast<const float2*>(cap), n_cap,
                                idx, foc, bpo, late, bins, shift, n_win, out,
                                stream);
}

// Stream mode: seg (n_seg, 2) u8 raw I/Q.
extern "C" int fd_demod_stream_launch(const unsigned char* seg, int n_seg,
                                      const int* idx, const float* foc,
                                      const float* bpo, const float* late,
                                      const int* bins, int shift, int n_win,
                                      float* out, void* stream)
{
    return launch<uchar2, false>(reinterpret_cast<const uchar2*>(seg), n_seg,
                                 idx, foc, bpo, late, bins, shift, n_win, out,
                                 stream);
}
