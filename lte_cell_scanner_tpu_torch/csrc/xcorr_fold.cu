// PSS correlation bank + k_factor-aligned incoherent half-frame fold.
//
// Replaces the TPU kernels lte_cell_scanner_tpu/ops/xcorr_pallas.py
// `_kernel_tea` (K1, template-embedded alignment) and `_kernel` (K2, roll
// layout). Both compute, for every PSS root t (3), lag (9600) and
// frequency hypothesis f (n_f):
//
//   single[f*3+t, lag] = (1/n_comb) * sum_{m < n_comb}
//                        |sum_{j < 137} tpl[f, t, j] * cap[starts[f, m] + lag + j]|^2
//
// The TPU versions exist in two layouts only because Mosaic needs
// 128-aligned lane slices: the per-hypothesis fold alignment starts[f, m]
// was baked either into per-fold template banks (K1) or into rolls after
// the matmul (K2). Here a block loads the capture span of its own
// hypothesis at the exact sample offset, so one kernel serves both plans.
//
// Bound on the H100: operations. At full width (n_f = 31, n_comb = 15) the
// work is 93 x 9600 x 15 x 137 complex MACs = 14.7 GFLOP of f32 FMA
// (~0.22 ms at 67 TFLOP/s), while the capture in (1.2 MB) and the fold out
// (3.6 MB) move in ~1.5 us. Design: one block owns a 512-lag tile of one
// hypothesis (all three roots share its fold starts). Its three 137-tap
// templates sit in shared memory and are read as warp broadcasts; for each
// fold m, in ascending order as in the JAX fold, the block stages the
// capture span it needs in shared memory and every thread correlates four
// lags (stride 128, so shared reads are conflict-free). |xc|^2 accumulates
// in registers and is written once: no atomics, a deterministic result.
// Plain f32 FMA, no tensor cores: the peak tables must match the f32
// reference.

#include <cuda_runtime.h>

namespace {

constexpr int kHalfFrame = 9600;
constexpr int kTaps = 137;
constexpr int kThreads = 128;
constexpr int kLagsPerThread = 4;
constexpr int kTile = kThreads * kLagsPerThread;   // 512 lags per block
constexpr int kSpan = kTile + kTaps - 1;           // capture samples per fold

__global__ void __launch_bounds__(kThreads)
xcorr_fold_kernel(const float* __restrict__ cap_re,
                  const float* __restrict__ cap_im, int n_cap,
                  const float* __restrict__ tpl,     // (n_f, 3, 2, 137)
                  const int* __restrict__ starts,    // (n_f, n_comb)
                  int n_comb, float* __restrict__ out)  // (n_f * 3, 9600)
{
    __shared__ float t_re[3][kTaps];
    __shared__ float t_im[3][kTaps];
    __shared__ float x_re[kSpan];
    __shared__ float x_im[kSpan];

    const int f = blockIdx.y;
    const int lag0 = blockIdx.x * kTile;
    const int tid = threadIdx.x;

    const float* tp = tpl + (size_t)f * 3 * 2 * kTaps;
    for (int i = tid; i < 3 * kTaps; i += kThreads) {
        const int c = i / kTaps, j = i % kTaps;
        t_re[c][j] = tp[(2 * c) * kTaps + j];
        t_im[c][j] = tp[(2 * c + 1) * kTaps + j];
    }

    float acc[3][kLagsPerThread];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int l = 0; l < kLagsPerThread; ++l) acc[c][l] = 0.f;

    for (int m = 0; m < n_comb; ++m) {
        const int base = starts[f * n_comb + m] + lag0;
        __syncthreads();   // the previous fold's readers are done
        for (int i = tid; i < kSpan; i += kThreads) {
            const int s = base + i;
            const bool ok = s >= 0 && s < n_cap;
            x_re[i] = ok ? cap_re[s] : 0.f;
            x_im[i] = ok ? cap_im[s] : 0.f;
        }
        __syncthreads();

        float xr[3][kLagsPerThread], xi[3][kLagsPerThread];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int l = 0; l < kLagsPerThread; ++l) {
                xr[c][l] = 0.f;
                xi[c][l] = 0.f;
            }
#pragma unroll 4
        for (int j = 0; j < kTaps; ++j) {
            float a[kLagsPerThread], b[kLagsPerThread];
#pragma unroll
            for (int l = 0; l < kLagsPerThread; ++l) {
                a[l] = x_re[tid + l * kThreads + j];
                b[l] = x_im[tid + l * kThreads + j];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float tr = t_re[c][j], ti = t_im[c][j];
#pragma unroll
                for (int l = 0; l < kLagsPerThread; ++l) {
                    xr[c][l] += tr * a[l] - ti * b[l];
                    xi[c][l] += ti * a[l] + tr * b[l];
                }
            }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int l = 0; l < kLagsPerThread; ++l)
                acc[c][l] += xr[c][l] * xr[c][l] + xi[c][l] * xi[c][l];
    }

    const float n = (float)n_comb;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int l = 0; l < kLagsPerThread; ++l) {
            const int lag = lag0 + tid + l * kThreads;
            if (lag < kHalfFrame)
                out[(size_t)(f * 3 + c) * kHalfFrame + lag] = acc[c][l] / n;
        }
}

}  // namespace

extern "C" int xcorr_fold_launch(const float* cap, int n_cap,
                                 const float* tpl, const int* starts,
                                 int n_f, int n_comb, float* out,
                                 void* stream)
{
    const dim3 grid((kHalfFrame + kTile - 1) / kTile, n_f);
    xcorr_fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        cap, cap + n_cap, n_cap, tpl, starts, n_comb, out);
    return (int)cudaGetLastError();
}
