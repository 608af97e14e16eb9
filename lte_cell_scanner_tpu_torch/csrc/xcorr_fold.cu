// PSS correlation bank + k_factor-aligned incoherent half-frame fold.
//
// Replaces the TPU kernels lte_cell_scanner_tpu/ops/xcorr_pallas.py
// `_kernel_tea` (K1, template-embedded alignment), `_kernel` (K2, roll
// layout) and `_kernel_tea3` (K3, Karatsuba). All compute, for every PSS
// root t (3), lag (9600) and frequency hypothesis f (n_f):
//
//   single[f*3+t, lag] = (1/n_comb) * sum_{m < n_comb}
//                        |sum_{j < 137} tpl[f, t, j] * cap[starts[f, m] + lag + j]|^2
//
// The TPU versions exist in two layouts only because Mosaic needs
// 128-aligned lane slices: the per-hypothesis fold alignment starts[f, m]
// was baked either into per-fold template banks (K1, K3) or into rolls
// after the matmul (K2). Here a block loads the capture span of its own
// hypothesis at the exact sample offset, so one kernel serves every plan.
//
// Two modes of one body (template parameter kKaratsuba):
// - 2x2 (K1/K2, launcher xcorr_fold_launch): re = sum tr*a - ti*b,
//   im = sum ti*a + tr*b, four real products per tap.
// - Karatsuba (K3, launcher xcorr_fold3_launch): three real products per
//   tap, k1 = sum tr*a, k2 = sum ti*b, k3 = sum (tr+ti)*(a+b), then
//   re = k1 - k2, im = (k3 - k1) - k2, the recombination order of the TPU
//   kernel. The template sum tr+ti is a third template plane and the
//   capture sum a+b a third capture plane, both formed by the caller, so
//   the bf16 mode can round each at the TPU kernel's rounding points
//   (the sums are rounded after the add) with the same f32 kernel.
//
// Bound on the H100: operations. At full width (n_f = 31, n_comb = 15) the
// 2x2 mode does 93 x 9600 x 15 x 137 complex MACs = 14.7 GFLOP of f32 FMA
// (~0.22 ms at 67 TFLOP/s), the Karatsuba mode 3/4 of that (~0.17 ms),
// while the capture in (1.2-1.8 MB) and the fold out (3.6 MB) move in
// ~1.5 us. Design: one block owns a 512-lag tile of one hypothesis (all
// three roots share its fold starts). Its three templates sit in shared
// memory and are read as warp broadcasts; for each fold m, in ascending
// order as in the JAX fold, the block stages the capture span it needs in
// shared memory and every thread correlates four lags (stride 128, so
// shared reads are conflict-free). |xc|^2 accumulates in registers and is
// written once: no atomics, a deterministic result. Plain f32 FMA, no
// tensor cores: the peak tables must match the f32 reference.

#include <cuda_runtime.h>

namespace {

constexpr int kHalfFrame = 9600;
constexpr int kTaps = 137;
constexpr int kThreads = 128;
constexpr int kLagsPerThread = 4;
constexpr int kTile = kThreads * kLagsPerThread;   // 512 lags per block
constexpr int kSpan = kTile + kTaps - 1;           // capture samples per fold

// cap: kPlanes planes of n_cap samples (re, im[, re+im]);
// tpl: (n_f, 3, kPlanes, 137) with the same planes.
template <bool kKaratsuba>
__global__ void __launch_bounds__(kThreads)
xcorr_fold_kernel(const float* __restrict__ cap, int n_cap,
                  const float* __restrict__ tpl,
                  const int* __restrict__ starts,    // (n_f, n_comb)
                  int n_comb, float* __restrict__ out)  // (n_f * 3, 9600)
{
    constexpr int kPlanes = kKaratsuba ? 3 : 2;
    __shared__ float t[kPlanes][3][kTaps];
    __shared__ float x[kPlanes][kSpan];

    const int f = blockIdx.y;
    const int lag0 = blockIdx.x * kTile;
    const int tid = threadIdx.x;

    const float* tp = tpl + (size_t)f * 3 * kPlanes * kTaps;
    for (int i = tid; i < 3 * kPlanes * kTaps; i += kThreads) {
        const int c = i / (kPlanes * kTaps);
        const int p = (i / kTaps) % kPlanes;
        t[p][c][i % kTaps] = tp[i];
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
#pragma unroll
            for (int p = 0; p < kPlanes; ++p)
                x[p][i] = ok ? cap[(size_t)p * n_cap + s] : 0.f;
        }
        __syncthreads();

        if constexpr (kKaratsuba) {
            float k1[3][kLagsPerThread], k2[3][kLagsPerThread],
                k3[3][kLagsPerThread];
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int l = 0; l < kLagsPerThread; ++l) {
                    k1[c][l] = 0.f;
                    k2[c][l] = 0.f;
                    k3[c][l] = 0.f;
                }
#pragma unroll 4
            for (int j = 0; j < kTaps; ++j) {
                float a[kLagsPerThread], b[kLagsPerThread], s[kLagsPerThread];
#pragma unroll
                for (int l = 0; l < kLagsPerThread; ++l) {
                    a[l] = x[0][tid + l * kThreads + j];
                    b[l] = x[1][tid + l * kThreads + j];
                    s[l] = x[2][tid + l * kThreads + j];
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float tr = t[0][c][j], ti = t[1][c][j],
                                ts = t[2][c][j];
#pragma unroll
                    for (int l = 0; l < kLagsPerThread; ++l) {
                        k1[c][l] = fmaf(tr, a[l], k1[c][l]);
                        k2[c][l] = fmaf(ti, b[l], k2[c][l]);
                        k3[c][l] = fmaf(ts, s[l], k3[c][l]);
                    }
                }
            }
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int l = 0; l < kLagsPerThread; ++l) {
                    const float re = k1[c][l] - k2[c][l];
                    const float im = (k3[c][l] - k1[c][l]) - k2[c][l];
                    acc[c][l] += re * re + im * im;
                }
        } else {
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
                    a[l] = x[0][tid + l * kThreads + j];
                    b[l] = x[1][tid + l * kThreads + j];
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float tr = t[0][c][j], ti = t[1][c][j];
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

template <bool kKaratsuba>
int launch(const float* cap, int n_cap, const float* tpl, const int* starts,
           int n_f, int n_comb, float* out, void* stream)
{
    const dim3 grid((kHalfFrame + kTile - 1) / kTile, n_f);
    xcorr_fold_kernel<kKaratsuba><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        cap, n_cap, tpl, starts, n_comb, out);
    return (int)cudaGetLastError();
}

}  // namespace

// cap (2, n_cap) re/im; tpl (n_f, 3, 2, 137).
extern "C" int xcorr_fold_launch(const float* cap, int n_cap,
                                 const float* tpl, const int* starts,
                                 int n_f, int n_comb, float* out,
                                 void* stream)
{
    return launch<false>(cap, n_cap, tpl, starts, n_f, n_comb, out, stream);
}

// cap (3, n_cap) re/im/re+im; tpl (n_f, 3, 3, 137) re/im/re+im.
extern "C" int xcorr_fold3_launch(const float* cap, int n_cap,
                                  const float* tpl, const int* starts,
                                  int n_f, int n_comb, float* out,
                                  void* stream)
{
    return launch<true>(cap, n_cap, tpl, starts, n_f, n_comb, out, stream);
}
