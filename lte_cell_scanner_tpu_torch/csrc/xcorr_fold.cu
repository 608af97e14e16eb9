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
// - K1/K2 (launcher xcorr_fold_launch, over a stack of B captures, each
//   with its own fold starts and a template bank picked by index, as the
//   TPU sweep maps K1 over its captures with a per-capture bank row):
//   tensor cores, mma.sync m16n8k8
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
// - K3 (launchers xcorr_fold3_launch, float32, and
//   xcorr_fold3_bf16_launch, bfloat16): tensor cores, Karatsuba: three
//   real products per tap, k1 = sum tr*a, k2 = sum ti*b, k3 = sum
//   (tr+ti)*(a+b), then re = k1 - k2, im = (k3 - k1) - k2, the
//   recombination order of the TPU kernel. The template sum tr+ti is a
//   third template plane and the capture sum a+b a third capture plane,
//   both formed by the caller, so the bf16 mode can round each at the TPU
//   kernel's rounding points. The same base, d_f and passes as K1, over
//   groups of 16 channels, with one product per plane and no signs; the
//   templates are the A operand and the capture the Toeplitz B (details
//   above the kernel). The float32 mode runs 3xTF32 m16n8k8 (W rounded
//   up to 8 taps); the bfloat16 mode one bf16 m16n8k16 product with
//   float32 sums (W rounded up to 16), exact for bf16 inputs.
//
// K1 bound on the H100: operations. The function is 3 n_f x 9600 x n_comb x
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
//   hypotheses) of one capture: 60 x ceil(n_f / 8) x B blocks. One capture
//   at 31 hypotheses is 240 blocks, fewer than the 396 that the 132 SMs
//   hold at once (3 each at 157 registers a thread); a sweep's stack of 64
//   captures is 15,360 blocks in one launch. Warps: 2 along
//   the lags, 2 along the columns, each 5 m-tiles x 3 n-tiles, 45 mma per
//   k-step against 10 A and 6 B fragment values.
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
// K3 bound: the function's 93 channels x 9600 lags x 15 folds x 137
// complex taps take three real MACs each, 11.0 GFLOP at full width: in
// float32 three TF32 products each, 33.0 GFLOP, ~0.067 ms at 495 TFLOP/s;
// in bf16 one product, ~0.011 ms at 989 TFLOP/s (the f32 FMA bound of the
// CUDA cores: ~0.17 ms). At 241 hypotheses K1 and K3 run their TF32
// `mma.sync` work at about 40% of the dense rate, as every build tried did
// (PERF.md); `wgmma` would be the next step.

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

// Warp 0's plan of fold m for the nf hypotheses of the group at f0:
// base = min_f starts[f, m], d_f = starts[f, m] - base (0 for a padded
// hypothesis) and W = 137 + max d_f taps rounded up to `align`.
__device__ __forceinline__ void plan_fold(const int* __restrict__ starts,
                                          int f0, int nf, int n_comb, int m,
                                          int align, int lane, int* s_d,
                                          int* s_base, int* s_w)
{
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
        *s_base = lo;
        *s_w = (kTaps + hi + align - 1) & -align;
    }
}

// cap (B, 2, n_cap) re/im; tpl (n_bank, n_f, 3, 2, 137); bank_idx (B,),
// or null for bank b of capture b; starts (B, n_f, n_comb); out (B, n_f *
// 3, 9600). Grid (9600 / kLagTile, ceil(n_f / 8), B): block (x, y, z)
// owns lags [x kLagTile, +kLagTile) of the 8 hypotheses (24 channels) of
// group y of capture z. A bank index outside [0, n_bank) reads nothing:
// the block writes NaN.
__global__ void __launch_bounds__(kTcThreads)
xcorr_fold_tc_kernel(const float* __restrict__ cap, int n_cap,
                     const float* __restrict__ tpl, int n_bank,
                     const int* __restrict__ bank_idx,
                     const int* __restrict__ starts, int n_f, int n_comb,
                     float* __restrict__ out)
{
    // This block's capture, its bank, fold starts and output.
    {
        const int b = blockIdx.z;
        const int bank = bank_idx != nullptr ? bank_idx[b] : b;
        out += (size_t)b * 3 * n_f * kHalfFrame;
        if ((unsigned)bank >= (unsigned)n_bank) {
            const int c0 = 3 * blockIdx.y * kGroup;
            const int nc = min(3 * kGroup, 3 * n_f - c0);
            for (int i = threadIdx.x; i < nc * kLagTile; i += kTcThreads)
                out[(size_t)(c0 + i / kLagTile) * kHalfFrame
                    + blockIdx.x * kLagTile + i % kLagTile] = __int_as_float(
                    0x7fc00000);
            return;
        }
        cap += (size_t)b * 2 * n_cap;
        tpl += (size_t)bank * n_f * 3 * 2 * kTaps;
        starts += (size_t)b * n_f * n_comb;
    }

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
        if (warp == 0)
            plan_fold(starts, f0, nf, n_comb, m, 4, lane, s_d, &s_base, &s_w);
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

// ---- K3: tensor cores, Karatsuba, in two modes.
//
// M = channels, N = lags: per fold and plane p (a, b, a+b of the capture
// against tr, ti, tr+ti of the templates), M_p = T_p X_p with
//   T_p[c][k] = tpl_p[c][k - d_f(c)], 0 unless 0 <= k - d_f < 137,
//   X_p[k][l] = x_p[base + lag0 + l + k]                  (Toeplitz)
// so that the capture is the B operand. A B fragment is a register pair
// (b0, b1) = (X[k0 + t][n], X[k0 + t + 4][n]) in TF32, (X[k0 + 2t, +1][n],
// X[k0 + 2t + 8, +9][n]) in bf16, and n-tile j at k-step k + 1 reads the
// very pair that n-tile j + 1 (TF32) or j + 2 (bf16) read at k-step k.
// The span is staged as pair words Y[s] = (x[s], x[s + 4]) (TF32, hi and
// lo) or Q[s] = ((x[s], x[s+1]), (x[s+8], x[s+9])) (bf16), so a warp
// keeps its n-tiles' pairs in a ring of registers that turns with the
// unrolled k-steps: one (TF32) or two (bf16) 64-bit loads per k-step and
// plane bring the pairs that enter, and no pair is moved. (With the
// capture as the A operand instead, as in K1, consecutive k-steps share
// values at other places of the fragment, and ptxas spent a move per
// value to assemble each A quad; that build ran slower on the card, most
// at 241 hypotheses.) In bf16 a pair word also answers the alignment of
// a bf16 fragment register, which holds two neighbouring taps that start
// at an odd sample for half the lags: no 32-bit load of the plane could
// fetch it.
//
// The A fragment (templates, one row per channel) is four predicated
// loads a k-step from the templates in shared memory, split in registers
// in TF32; in bf16 the template rows are kept as pair words (word i + 1 =
// taps i, i + 1), so that each A register is one load. (A table of the
// fragments, built once per pass by the block for its four warps, made
// the bf16 mode slower on the card: the build costs more than the loads
// it saves.)
//
// A block owns 16 channels (one m-tile; the 3 n_f channels are cut into
// groups of 16, the last padded with zero templates) x 160 lags: 4 warps,
// each 5 n-tiles of 8 lags. Per fold, base = min starts over the
// hypotheses of its channels (at most 6) and d_f = starts - base. The
// three accumulators m1, m2, m3 of an output fragment sit at the same
// tile position, so one thread forms re = m1 - m2, im = (m3 - m1) - m2
// and adds re^2 + im^2 to the fold sum in registers: 80 accumulator
// floats a thread.

constexpr int k3Rows = 16;                     // channels per block
constexpr int k3NT = 5;                        // n-tiles (8 lags) per warp
constexpr int k3Warps = 4;                     // warps along the lags
constexpr int k3Threads = 32 * k3Warps;
constexpr int k3LagTile = 8 * k3NT * k3Warps;  // lags per block
constexpr int k3Span = k3LagTile + kChunk;     // pair words staged per pass
constexpr int k3Row = 140;                     // template row stride
constexpr int k3Tpl = k3Rows * 3 * k3Row;      // [channel][plane][tap]
static_assert(kHalfFrame % k3LagTile == 0 && kChunk % 16 == 0, "");

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One plane of a staged pass in TF32, 3xTF32 products: nks k-steps of 8
// taps. yh, yl: the hi and lo pair words at this lane's first B pair
// (lag 40 warp + g, tap t); t0, t1: the plane's template rows g and g + 8,
// i0, i1 their first A taps (t - d_f of the row, from the pass start).
__device__ __forceinline__ void plane_tf32(const uint2* yh, const uint2* yl,
                                           const float* t0, const float* t1,
                                           int i0, int i1, int nks,
                                           float (&c)[k3NT][4])
{
    // n-tile j at k-step k reads pair v = j + k, kept at slot v % k3NT.
    uint2 rh[k3NT], rl[k3NT];
#pragma unroll
    for (int j = 0; j < k3NT; ++j) {
        rh[j] = yh[8 * j];
        rl[j] = yl[8 * j];
    }
    for (int ks = 0; ks < nks; ks += k3NT) {
#pragma unroll
        for (int u = 0; u < k3NT; ++u) {
            const int k = ks + u;
            if (k >= nks) break;
            const int a = i0 + 8 * k, b = i1 + 8 * k;
            const float v[4] = {
                (unsigned)a < (unsigned)kTaps ? t0[a] : 0.f,
                (unsigned)b < (unsigned)kTaps ? t1[b] : 0.f,
                (unsigned)(a + 4) < (unsigned)kTaps ? t0[a + 4] : 0.f,
                (unsigned)(b + 4) < (unsigned)kTaps ? t1[b + 4] : 0.f};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[e], al[e]);
            // Small terms first, as K1 sums them.
#pragma unroll
            for (int j = 0; j < k3NT; ++j)
                mma_tf32(c[j], al, rh[(u + j) % k3NT].x,
                         rh[(u + j) % k3NT].y);
#pragma unroll
            for (int j = 0; j < k3NT; ++j)
                mma_tf32(c[j], ah, rl[(u + j) % k3NT].x,
                         rl[(u + j) % k3NT].y);
#pragma unroll
            for (int j = 0; j < k3NT; ++j)
                mma_tf32(c[j], ah, rh[(u + j) % k3NT].x,
                         rh[(u + j) % k3NT].y);
            if (k + 1 < nks) {   // the pair that enters at k-step k + 1
                rh[u] = yh[8 * (k + k3NT)];
                rl[u] = yl[8 * (k + k3NT)];
            }
        }
    }
}

// One plane of a staged pass in bf16: nks k-steps of 16 taps. q: the
// pair words at this lane's first B pair (lag 40 warp + g, tap 2t); t0, t1:
// the plane's template pair-word rows g and g + 8 (word i + 1 holds taps
// i, i + 1), i0, i1 their first A taps (2t - d_f of the row).
__device__ __forceinline__ void plane_bf16(const uint2* q,
                                           const uint32_t* t0,
                                           const uint32_t* t1, int i0,
                                           int i1, int nks,
                                           float (&c)[k3NT][4])
{
    // n-tile j at k-step k reads pair v = j + 2k, kept at slot v % S; S is
    // even and above k3NT, so the ring turns every S / 2 k-steps.
    constexpr int S = k3NT + 1 + (k3NT & 1 ? 0 : 1);
    uint2 r[S];
#pragma unroll
    for (int j = 0; j < k3NT; ++j) r[j] = q[8 * j];
    for (int ks = 0; ks < nks; ks += S / 2) {
#pragma unroll
        for (int u = 0; u < S / 2; ++u) {
            const int k = ks + u;
            if (k >= nks) break;
            const int a = i0 + 16 * k + 1, b = i1 + 16 * k + 1;
            constexpr unsigned kW = kTaps + 1;   // words -1 .. 136
            const uint32_t av[4] = {
                (unsigned)a < kW ? t0[a] : 0u,
                (unsigned)b < kW ? t1[b] : 0u,
                (unsigned)(a + 8) < kW ? t0[a + 8] : 0u,
                (unsigned)(b + 8) < kW ? t1[b + 8] : 0u};
#pragma unroll
            for (int j = 0; j < k3NT; ++j)
                mma_bf16(c[j], av, r[(2 * u + j) % S].x,
                         r[(2 * u + j) % S].y);
            if (k + 1 < nks) {   // the two pairs that enter at k + 1
                const int v = 2 * k + k3NT;
                r[(2 * u + k3NT) % S] = q[8 * v];
                r[(2 * u + k3NT + 1) % S] = q[8 * (v + 1)];
            }
        }
    }
}

// Both modes: cap (3, n_cap) planes a, b, a+b; tpl (n_f, 3, 3, 137) planes
// tr, ti, tr+ti; starts (n_f, n_comb); out (n_f * 3, 9600). T = float
// (f32 mode, 3xTF32) or uint16_t (bf16 bits, one bf16 product). Grid
// (9600 / k3LagTile, ceil(3 n_f / 16)).
template <typename T>
__global__ void __launch_bounds__(k3Threads)
xcorr_fold3_tc_kernel(const T* __restrict__ cap, int n_cap,
                      const T* __restrict__ tpl,
                      const int* __restrict__ starts, int n_f, int n_comb,
                      float* __restrict__ out)
{
    constexpr bool kBf16 = sizeof(T) == 2;
    // Templates: float32 taps, or bf16 pair words (word i + 1 = taps i,
    // i + 1, zero outside the 137 taps).
    __shared__ uint32_t ts[k3Tpl];
    // The span: f32 hi and lo pair words Y, or bf16 Q.
    __shared__ uint2 xs[kBf16 ? 1 : 2][3][k3Span];
    __shared__ int s_d[kGroup];
    __shared__ int s_base, s_w;

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int lag0 = blockIdx.x * k3LagTile;
    const int c0 = blockIdx.y * k3Rows;
    const int n_ch = min(k3Rows, 3 * n_f - c0);   // the block's channels
    const int h0 = c0 / 3;                        // and their hypotheses
    const int nh = (c0 + n_ch - 1) / 3 - h0 + 1;

    for (int i = tid; i < k3Tpl; i += k3Threads) {
        const int row = i / k3Row, j = i % k3Row;   // row = 3 channel + plane
        const T* tr = tpl + (size_t)(3 * c0 + row) * kTaps;
        const bool in = row < 3 * n_ch;
        if constexpr (kBf16) {
            const uint32_t lo = in && (unsigned)(j - 1) < (unsigned)kTaps
                                    ? tr[j - 1] : 0u;
            const uint32_t hi = in && j < kTaps ? tr[j] : 0u;
            ts[i] = lo | (hi << 16);
        } else {
            ts[i] = __float_as_uint(in && j < kTaps ? tr[j] : 0.f);
        }
    }

    const int lane_s = 8 * k3NT * warp + g + (kBf16 ? 2 * t : t);
    const int hyp0 = (c0 + g) / 3 - h0, hyp1 = (c0 + g + 8) / 3 - h0;

    float acc[k3NT][4];
#pragma unroll
    for (int j = 0; j < k3NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int m = 0; m < n_comb; ++m) {
        __syncthreads();   // the previous fold's readers are done
        if (warp == 0)
            plan_fold(starts, h0, nh, n_comb, m, kBf16 ? 16 : 8, lane, s_d,
                      &s_base, &s_w);
        __syncthreads();
        const int base = s_base + lag0;
        const int w = s_w;
        const int d0 = s_d[hyp0], d1 = s_d[hyp1];

        float mk[3][k3NT][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int j = 0; j < k3NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) mk[p][j][e] = 0.f;

        for (int tap0 = 0; tap0 < w; tap0 += kChunk) {
            const int nt = min(kChunk, w - tap0);   // a multiple of 8 or 16
            if (tap0 > 0) __syncthreads();
            for (int i = tid; i < k3LagTile + nt; i += k3Threads) {
                const int s = base + tap0 + i;
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                    const T* cp = cap + (size_t)p * n_cap;
                    auto x = [&](int o) {
                        return (s + o >= 0 && s + o < n_cap) ? cp[s + o]
                                                             : T(0);
                    };
                    if constexpr (kBf16) {
                        xs[0][p][i] = make_uint2(
                            x(0) | ((uint32_t)x(1) << 16),
                            x(8) | ((uint32_t)x(9) << 16));
                    } else {
                        uint32_t h, l;
                        split_tf32(x(0), h, l);
                        uint32_t* yh = reinterpret_cast<uint32_t*>(xs[0][p]);
                        uint32_t* yl = reinterpret_cast<uint32_t*>(xs[1][p]);
                        yh[2 * i] = h;
                        yl[2 * i] = l;
                        if (i >= 4) {   // Y[s - 4] = (x[s - 4], x[s])
                            yh[2 * i - 7] = h;
                            yl[2 * i - 7] = l;
                        }
                    }
                }
            }
            __syncthreads();
#pragma unroll
            for (int p = 0; p < 3; ++p) {
                const uint32_t* tp = ts + p * k3Row;
                const uint32_t* r0 = tp + (3 * g) * k3Row;
                const uint32_t* r1 = tp + (3 * (g + 8)) * k3Row;
                if constexpr (kBf16)
                    plane_bf16(xs[0][p] + lane_s, r0, r1,
                               tap0 + 2 * t - d0, tap0 + 2 * t - d1,
                               nt / 16, mk[p]);
                else
                    plane_tf32(xs[0][p] + lane_s, xs[1][p] + lane_s,
                               reinterpret_cast<const float*>(r0),
                               reinterpret_cast<const float*>(r1),
                               tap0 + t - d0, tap0 + t - d1, nt / 8, mk[p]);
            }
        }
        // The recombination order of the JAX kernel and the plain version.
#pragma unroll
        for (int j = 0; j < k3NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float re = mk[0][j][e] - mk[1][j][e];
                const float im = (mk[2][j][e] - mk[0][j][e]) - mk[1][j][e];
                acc[j][e] += re * re + im * im;
            }
    }

    // c0, c1: channel g, lags 2t, 2t + 1 of n-tile j; c2, c3: channel g + 8.
    const float n = (float)n_comb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int ch = g + 8 * h;
        if (ch >= n_ch) continue;
        float* o = out + (size_t)(c0 + ch) * kHalfFrame + lag0
                   + 8 * k3NT * warp + 2 * t;
#pragma unroll
        for (int j = 0; j < k3NT; ++j)
            *reinterpret_cast<float2*>(o + 8 * j) =
                make_float2(acc[j][2 * h] / n, acc[j][2 * h + 1] / n);
    }
}

}  // namespace

// cap (n_batch, 2, n_cap) re/im; tpl (n_bank, n_f, 3, 2, 137); bank_idx
// (n_batch,) in [0, n_bank), or null (n_bank = n_batch); starts (n_batch,
// n_f, n_comb); out (n_batch, n_f * 3, 9600). One capture is n_batch = 1.
extern "C" int xcorr_fold_launch(const float* cap, int n_cap,
                                 const float* tpl, int n_bank,
                                 const int* bank_idx, const int* starts,
                                 int n_f, int n_comb, int n_batch, float* out,
                                 void* stream)
{
    const dim3 grid(kHalfFrame / kLagTile, (n_f + kGroup - 1) / kGroup,
                    n_batch);
    xcorr_fold_tc_kernel<<<grid, kTcThreads, 0, (cudaStream_t)stream>>>(
        cap, n_cap, tpl, n_bank, bank_idx, starts, n_f, n_comb, out);
    return (int)cudaGetLastError();
}

// cap (3, n_cap) a, b, a+b; tpl (n_f, 3, 3, 137) tr, ti, tr+ti; float32.
extern "C" int xcorr_fold3_launch(const float* cap, int n_cap,
                                  const float* tpl, const int* starts,
                                  int n_f, int n_comb, float* out,
                                  void* stream)
{
    const dim3 grid(kHalfFrame / k3LagTile, (3 * n_f + k3Rows - 1) / k3Rows);
    xcorr_fold3_tc_kernel<float><<<grid, k3Threads, 0,
                                   (cudaStream_t)stream>>>(
        cap, n_cap, tpl, starts, n_f, n_comb, out);
    return (int)cudaGetLastError();
}

// The same planes as bfloat16 bits.
extern "C" int xcorr_fold3_bf16_launch(const void* cap, int n_cap,
                                       const void* tpl, const int* starts,
                                       int n_f, int n_comb, float* out,
                                       void* stream)
{
    const dim3 grid(kHalfFrame / k3LagTile, (3 * n_f + k3Rows - 1) / k3Rows);
    xcorr_fold3_tc_kernel<uint16_t><<<grid, k3Threads, 0,
                                      (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(cap), n_cap,
        static_cast<const uint16_t*>(tpl), starts, n_f, n_comb, out);
    return (int)cudaGetLastError();
}
