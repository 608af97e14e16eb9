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
// with cap = 0 outside the capture. The TPU versions exist in two layouts
// only because Mosaic needs 128-aligned lane slices: the per-hypothesis
// fold alignment starts[f, m] was baked either into per-fold template
// banks (K1, K3) or into rolls after the matmul (K2). Here a block reads
// the capture at each hypothesis's exact fold start, so one kernel serves
// every plan.
//
// Two kernels:
//
// - K1/K2 (launcher xcorr_fold_launch): tensor cores, mma.sync m16n8k8
//   TF32 with 3xTF32 products. Hypotheses go 8 to a group (24 channels,
//   48 real output columns; n_f is padded with zero templates). For fold m
//   and group h, base = min_{f in h} starts[f, m], d_f = starts[f, m] -
//   base, W = 137 + max d_f rounded up to 4 taps. Then C = A B with
//     A[r][k] = X[2r + k],  X[2s + p] = cap_p[base + lag0 + s]   (Toeplitz)
//     B[2i + p][2c + q] = tpl of channel c at ii = i - d_f, 0 unless
//                         0 <= ii < 137: (q, p) = (0, 0) tr, (0, 1) -ti,
//                         (1, 0) ti, (1, 1) tr
//   so re = C[r][2c], im = C[r][2c + 1], and |xc|^2 adds up in registers
//   fold by fold in ascending m. Each operand is split into hi = tf32(x)
//   and lo = tf32(x - hi) (cvt.rna) and D += A_lo B_hi, D += A_hi B_lo,
//   D += A_hi B_hi. Plain TF32 would flip near-tie argmaxes downstream;
//   the split keeps the error near float32's (against a float64
//   reference: PERF.md), and the products are exact for bf16-rounded
//   inputs (lo = 0).
// - K3 (launcher xcorr_fold3_launch): CUDA cores, three real products per
//   tap, k1 = sum tr*a, k2 = sum ti*b, k3 = sum (tr+ti)*(a+b), then
//   re = k1 - k2, im = (k3 - k1) - k2, the recombination order of the TPU
//   kernel. The template sum tr+ti is a third template plane and the
//   capture sum a+b a third capture plane, both formed by the caller, so
//   the bf16 mode can round each at the TPU kernel's rounding points.
//
// Bound on the H100: operations. The function is 3 n_f x 9600 x n_comb x
// 137 complex MACs: at full width (n_f = 31, n_comb = 15) 14.7 GFLOP, three
// TF32 products each, 44.0 GFLOP, ~0.089 ms at 495 TFLOP/s dense TF32 (the
// same function on the CUDA cores: ~0.22 ms of f32 FMA at 67 TFLOP/s). The
// capture in (1.2 MB) and the fold out (3.6 MB) move in ~1.5 us. The
// kernel runs more than the function needs: W is 137 plus its group's
// spread, and a padded group's zero templates are multiplied too. Only
// `wgmma` reaches the dense rate; the `mma.sync` products of this kernel
// run at well under half of it (its time against the bound: PERF.md).
// Design:
// - A block of 4 warps owns 160 lags x one group (24 channels, 8
//   hypotheses; 60 x ceil(n_f / 8) blocks, 240 at 31 hypotheses, so the
//   132 SMs carry 1 or 2 blocks each). Warps: 2 along the lags, 2 along
//   the columns, each 5 m-tiles x 3 n-tiles, 45 mma per k-step against 10
//   A and 6 B fragment values.
// - The group's templates sit in shared memory (26.3 KB, unsplit). Every
//   B value is one predicated load at (k0 + t)/2 - d_f, with a sign and
//   plane fixed per lane, split in registers. The split rounds with two
//   integer operations (the bits of cvt.rna, whose expansion by ptxas
//   adds a NaN/Inf guard that made the kernel measurably slower).
// - Each fold's capture span is staged in shared memory already split
//   into hi and lo, interleaved re/im, so an A value is one conflict-free
//   load (18 distinct words per warp load). Spans longer than kChunk taps
//   (a wide spread, as from an unsorted grid) are staged in passes.
// - Per fold, one warp finds base, W and d_f with shuffles; three
//   barriers a fold. Loading the next fold's span during this fold's
//   products measured no better on the card, so the block stages in turn.
// - Each output is written once: no atomics, a deterministic result.
//
// K3 bound: 3/4 of the f32 FMA count (~0.17 ms). One block owns a 512-lag
// tile of one hypothesis; its three templates sit in shared memory and are
// read as warp broadcasts; for each fold the block stages the span it needs
// and every thread correlates four lags (stride 128, conflict-free).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kHalfFrame = 9600;
constexpr int kTaps = 137;

// ---- K1/K2: tensor cores, 3xTF32.

constexpr int kGroup = 8;                    // hypotheses per block
constexpr int kCh = 3 * kGroup;              // 24 channels per block
constexpr int kMT = 5;                       // m-tiles (16 lags) per warp
constexpr int kNT = 3;                       // n-tiles (4 channels) per warp
constexpr int kWM = 2;                       // warps along the lags
constexpr int kWN = kCh / 4 / kNT;           // warps along the columns
constexpr int kTcThreads = 32 * kWM * kWN;
constexpr int kLagTile = 16 * kMT * kWM;     // lags per block
constexpr int kChunk = 160;                  // taps staged per pass
constexpr int kSpan = kLagTile + kChunk;     // samples staged per pass
constexpr int kTplFloats = kCh * 2 * kTaps;
static_assert(kHalfFrame % kLagTile == 0 && kWN * kNT * 4 == kCh, "");

// TF32 of a finite float, rounded to nearest with ties away from zero: the
// bits of cvt.rna.tf32.f32, which ptxas expands into these two integer
// operations behind a NaN/Inf test that finite data never takes.
__device__ __forceinline__ uint32_t tf32_rna(float x)
{
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cap (2, n_cap) re/im; tpl (n_f, 3, 2, 137); starts (n_f, n_comb);
// out (n_f * 3, 9600). Grid (9600 / kLagTile, ceil(n_f / 8)): block (x, y)
// owns lags [x kLagTile, +kLagTile) of the 8 hypotheses (24 channels) of
// group y.
__global__ void __launch_bounds__(kTcThreads)
xcorr_fold_tc_kernel(const float* __restrict__ cap, int n_cap,
                     const float* __restrict__ tpl,
                     const int* __restrict__ starts, int n_f, int n_comb,
                     float* __restrict__ out)
{
    __shared__ float ts[kTplFloats];       // [24 channels][2 planes][137]
    __shared__ float xh[2 * kSpan];        // tf32 hi, re/im interleaved
    __shared__ float xl[2 * kSpan];        // tf32 lo
    __shared__ int s_d[kGroup];
    __shared__ int s_base, s_w;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp % kWM, wn = warp / kWM;
    const int lag0 = blockIdx.x * kLagTile;
    const int f0 = blockIdx.y * kGroup;
    const int nf = min(kGroup, n_f - f0);  // the group's real hypotheses

    // The group's templates; a padded hypothesis has zero templates.
    const float* tp = tpl + (size_t)f0 * 3 * 2 * kTaps;
    const int n_real = 3 * nf * 2 * kTaps;
    for (int i = tid; i < kTplFloats; i += kTcThreads)
        ts[i] = i < n_real ? tp[i] : 0.f;

    // B fragment of this lane: b0 = B[k0 + t][n0 + g], b1 = row + 4. Its
    // parity p = t & 1 and column q = g & 1 are fixed, so is its template
    // plane (p ^ q) and sign; n-tile j reads channel 4 (kNT wn + j) + g / 2.
    const int p = t & 1, q = g & 1;
    const float sgn = (q == 0 && p == 1) ? -1.f : 1.f;
    const int cb = 4 * kNT * wn + (g >> 1);
    const float* tb = ts + cb * 2 * kTaps + (p ^ q) * kTaps;
    // A rows of this lane: r = 16 kMT wm + 16 im + g (+ 8).
    const int row0 = 16 * kMT * wm;
    const int a_off = 2 * (row0 + g) + t;

    float acc[kMT][kNT][2];
#pragma unroll
    for (int im = 0; im < kMT; ++im)
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[im][j][0] = acc[im][j][1] = 0.f;

    for (int m = 0; m < n_comb; ++m) {
        __syncthreads();   // the previous fold's readers are done
        if (warp == 0) {
            const int s = lane < nf ? starts[(size_t)(f0 + lane) * n_comb + m]
                                    : INT_MAX;
            int lo = s;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            const int d = lane < nf ? s - lo : 0;
            int hi = d;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
            if (lane < kGroup) s_d[lane] = d;
            if (lane == 0) {
                s_base = lo;
                s_w = (kTaps + hi + 3) & ~3;
            }
        }
        __syncthreads();
        const int base = s_base + lag0;
        const int w = s_w;
        int dj[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j) dj[j] = s_d[(cb + 4 * j) / 3];

        float c[kMT][kNT][4];
#pragma unroll
        for (int im = 0; im < kMT; ++im)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) c[im][j][e] = 0.f;

        for (int tap0 = 0; tap0 < w; tap0 += kChunk) {
            const int nt = min(kChunk, w - tap0);   // a multiple of 4
            if (tap0 > 0) __syncthreads();
            // X[2s + p] = cap_p[base + tap0 + s], split into hi and lo.
            for (int i = tid; i < 2 * (kLagTile + nt); i += kTcThreads) {
                const int s = base + tap0 + (i >> 1);
                const float v = (s >= 0 && s < n_cap)
                                    ? cap[(size_t)(i & 1) * n_cap + s] : 0.f;
                uint32_t h, l;
                split_tf32(v, h, l);
                xh[i] = __uint_as_float(h);
                xl[i] = __uint_as_float(l);
            }
            __syncthreads();
            const uint32_t* xhu = reinterpret_cast<const uint32_t*>(xh);
            const uint32_t* xlu = reinterpret_cast<const uint32_t*>(xl);
#pragma unroll 2
            for (int k0 = 0; k0 < 2 * nt; k0 += 8) {
                uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
                for (int im = 0; im < kMT; ++im) {
                    const int o = a_off + 32 * im + k0;
                    ah[im][0] = xhu[o];
                    ah[im][1] = xhu[o + 16];
                    ah[im][2] = xhu[o + 4];
                    ah[im][3] = xhu[o + 20];
                    al[im][0] = xlu[o];
                    al[im][1] = xlu[o + 16];
                    al[im][2] = xlu[o + 4];
                    al[im][3] = xlu[o + 20];
                }
                const int i0 = tap0 + (k0 >> 1) + (t >> 1);
                uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
                for (int j = 0; j < kNT; ++j) {
                    const int ii = i0 - dj[j];
                    const float* tj = tb + j * 4 * 2 * kTaps;
                    const float v0 = (unsigned)ii < (unsigned)kTaps
                                         ? tj[ii] : 0.f;
                    const float v1 = (unsigned)(ii + 2) < (unsigned)kTaps
                                         ? tj[ii + 2] : 0.f;
                    split_tf32(sgn * v0, bh[j][0], bl[j][0]);
                    split_tf32(sgn * v1, bh[j][1], bl[j][1]);
                }
                // The three products in three sweeps over the tiles, small
                // terms first.
#pragma unroll
                for (int j = 0; j < kNT; ++j)
#pragma unroll
                    for (int im = 0; im < kMT; ++im)
                        mma_tf32(c[im][j], al[im], bh[j][0], bh[j][1]);
#pragma unroll
                for (int j = 0; j < kNT; ++j)
#pragma unroll
                    for (int im = 0; im < kMT; ++im)
                        mma_tf32(c[im][j], ah[im], bl[j][0], bl[j][1]);
#pragma unroll
                for (int j = 0; j < kNT; ++j)
#pragma unroll
                    for (int im = 0; im < kMT; ++im)
                        mma_tf32(c[im][j], ah[im], bh[j][0], bh[j][1]);
            }
        }
        // c0, c1: re, im of channel 4 (kNT wn + j) + t at row g;
        // c2, c3 at row g + 8.
#pragma unroll
        for (int im = 0; im < kMT; ++im)
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
                acc[im][j][0] += c[im][j][0] * c[im][j][0]
                                 + c[im][j][1] * c[im][j][1];
                acc[im][j][1] += c[im][j][2] * c[im][j][2]
                                 + c[im][j][3] * c[im][j][3];
            }
    }

    const float n = (float)n_comb;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
        const int ch = 4 * (kNT * wn + j) + t;
        if (ch >= 3 * nf) continue;
        float* o = out + (size_t)(3 * f0 + ch) * kHalfFrame + lag0 + row0 + g;
#pragma unroll
        for (int im = 0; im < kMT; ++im) {
            o[16 * im] = acc[im][j][0] / n;
            o[16 * im + 8] = acc[im][j][1] / n;
        }
    }
}

// ---- K3: CUDA cores, Karatsuba.

constexpr int kThreads = 128;
constexpr int kLagsPerThread = 4;
constexpr int kTile = kThreads * kLagsPerThread;   // 512 lags per block
constexpr int kKSpan = kTile + kTaps - 1;          // capture samples per fold
constexpr int kPlanes = 3;

// cap: 3 planes of n_cap samples (re, im, re+im);
// tpl: (n_f, 3, 3, 137) with the same planes.
__global__ void __launch_bounds__(kThreads)
xcorr_fold3_kernel(const float* __restrict__ cap, int n_cap,
                   const float* __restrict__ tpl,
                   const int* __restrict__ starts,    // (n_f, n_comb)
                   int n_comb, float* __restrict__ out)  // (n_f * 3, 9600)
{
    __shared__ float t[kPlanes][3][kTaps];
    __shared__ float x[kPlanes][kKSpan];

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
        for (int i = tid; i < kKSpan; i += kThreads) {
            const int s = base + i;
            const bool ok = s >= 0 && s < n_cap;
#pragma unroll
            for (int p = 0; p < kPlanes; ++p)
                x[p][i] = ok ? cap[(size_t)p * n_cap + s] : 0.f;
        }
        __syncthreads();

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

// cap (2, n_cap) re/im; tpl (n_f, 3, 2, 137).
extern "C" int xcorr_fold_launch(const float* cap, int n_cap,
                                 const float* tpl, const int* starts,
                                 int n_f, int n_comb, float* out,
                                 void* stream)
{
    const dim3 grid(kHalfFrame / kLagTile, (n_f + kGroup - 1) / kGroup);
    xcorr_fold_tc_kernel<<<grid, kTcThreads, 0, (cudaStream_t)stream>>>(
        cap, n_cap, tpl, starts, n_f, n_comb, out);
    return (int)cudaGetLastError();
}

// cap (3, n_cap) re/im/re+im; tpl (n_f, 3, 3, 137) re/im/re+im.
extern "C" int xcorr_fold3_launch(const float* cap, int n_cap,
                                  const float* tpl, const int* starts,
                                  int n_f, int n_comb, float* out,
                                  void* stream)
{
    const dim3 grid((kHalfFrame + kTile - 1) / kTile, n_f);
    xcorr_fold3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        cap, n_cap, tpl, starts, n_comb, out);
    return (int)cudaGetLastError();
}
