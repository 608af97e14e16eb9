// Greedy peak search over the PSS scan's collapsed tables, one capture a
// block, every trip on the card.
//
// Replaces no TPU kernel: the JAX package runs this loop as plain JAX
// (lte_cell_scanner_tpu/ops/peak_jax.py::peak_search_device, a
// lax.while_loop), and the port ran it as ~50 eager PyTorch operations a
// trip (ops/peak_torch.py::peak_search_plain, kept as the plain version).
// It was added because those launches, and a host read of the stop flag,
// set the cell search's peak stage. Reference: src/searcher.cpp:422-510.
// Per capture, with working = the three collapsed pow rows (3 x 9600):
//
//   trip:  flat = first argmax working (NaN above every number, ties to
//                 the lowest n2 * 9600 + ind, as torch.argmax)
//          pp = working[n2, ind]; stop unless pp >= r_norm * sp[ind]
//                 (a float32 product) and pp > 0
//          foi = (int) frq[n2, ind]; refined = the first argmax over
//                 k = 0..2 arm of single[n2, (ind + k - arm) mod 9600, foi]
//          record [pp, refined, foi, n2]
//          cancel: 0 where |lag - ind| (cyclic) <= 274 on row n2, where it
//                 is <= 274 and below pp * DB8 on the other rows, and
//                 wherever below pp * DB12 (float32 products)
//
// The slots from the first failed trip on are written as zeros. Every
// comparison and product is the plain version's, in float32, so the table
// is the same to the bit.
//
// Bound on the H100: bytes. Each capture's 115,200 bytes of pow rows are
// read once (3.35 TB/s: ~34 ns a capture, 4.2 us at B = 121); the trips
// after the first touch only shared memory and a few words of the frq,
// sp and single rows. The loop is sequential, so a trip's latency (a pass
// over shared memory, two block barriers, two dependent global reads)
// sets a capture with peaks. Design: one block of 1024 threads a capture.
//   - The pow rows are loaded once into 112.5 KB of dynamic shared memory
//     (float4 loads) with the first trip's argmax in the same pass.
//   - Each thread keeps a (value, index) argmax over its elements in
//     ascending index; warp shuffles and one barrier reduce the block.
//   - Warp 0 tests the peak, refines it (a lane a lag, a warp argmax) and
//     writes the record; a second barrier hands the peak to the block.
//   - A trip's cancellation and the next trip's argmax are one pass over
//     shared memory; a float4 is written back only where a lane changed.
//   - A block returns at its first failed trip: captures without a cell
//     (band17's 120 of 121) cost one pass and one load.
// One block fills an SM's shared memory: at B = 121 one wave, at B = 271
// three.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kLags = 9600;              // HALF_FRAME
constexpr int kRows = 3;                 // PSS roots
constexpr int kPacked = 7;               // pow x 3, frq x 3, sp
constexpr int kVec = kLags / 4;          // float4 a row
constexpr int kNear = 2 * 137;           // the cancellation window
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "the block reduction takes one warp");

// a (index ia) ranks above b (index ib) in torch.argmax's order.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib)
{
    if (a != a) return b == b || ia < ib;
    if (b != b) return false;
    return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(kFull, v, o);
        const int oi = __shfl_down_sync(kFull, i, o);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
}

// The cancellation of one element at ``lag`` after a peak at ``ind`` on
// this row (``same``) or another: the plain version's three masks.
__device__ __forceinline__ void cancel(float& v, int lag, int ind, bool same,
                                       float t8, float t12, bool& changed)
{
    int d = abs(lag - ind);
    d = min(d, kLags - d);
    if ((d <= kNear && (same || v < t8)) || v < t12) {
        v = 0.0f;
        changed = true;
    }
}

__device__ __forceinline__ float neg_inf()
{
    return __int_as_float(0xff800000);
}

__device__ __forceinline__ int wrap_lag(int lag)
{
    return lag < 0 ? lag + kLags : (lag >= kLags ? lag - kLags : lag);
}

__global__ void __launch_bounds__(kThreads, 1)
peak_greedy_kernel(const float* __restrict__ packed,   // (B, 7, 9600)
                   const float* __restrict__ single,   // (B, 3, 9600, n_f)
                   long long s_b, long long s_r, long long s_l,
                   long long s_f,                      // single's strides
                   float r_norm, int arm, int max_peaks, float db8,
                   float db12,
                   float* __restrict__ out)            // (B, max_peaks, 4)
{
    extern __shared__ float4 work[];                   // (3, 2400) float4
    __shared__ float red_v[kWarps];
    __shared__ int red_i[kWarps];
    __shared__ float s_pp;
    __shared__ int s_flat, s_valid;

    const int b = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float* cap = packed + (size_t)b * kPacked * kLags;
    const float* sgl = single + b * s_b;
    float* tab = out + (size_t)b * max_peaks * 4;

    float bv = neg_inf();
    int bi = INT_MAX;
    const float4* pow4 = reinterpret_cast<const float4*>(cap);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        for (int q = tid; q < kVec; q += kThreads) {
            const float4 x = __ldg(pow4 + r * kVec + q);
            work[r * kVec + q] = x;
            const int f = r * kLags + 4 * q;
            if (better(x.x, f, bv, bi)) { bv = x.x; bi = f; }
            if (better(x.y, f + 1, bv, bi)) { bv = x.y; bi = f + 1; }
            if (better(x.z, f + 2, bv, bi)) { bv = x.z; bi = f + 2; }
            if (better(x.w, f + 3, bv, bi)) { bv = x.w; bi = f + 3; }
        }
    }

    for (int trip = 0;; ) {
        warp_best(bv, bi);
        if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
        __syncthreads();
        if (warp == 0) {
            bv = red_v[lane];
            bi = red_i[lane];
            warp_best(bv, bi);
            bv = __shfl_sync(kFull, bv, 0);
            bi = __shfl_sync(kFull, bi, 0);
            const int n2 = bi / kLags, ind = bi - n2 * kLags;
            const float sp = __ldg(cap + 6 * kLags + ind);
            const float frq = __ldg(cap + (kRows + n2) * kLags + ind);
            const bool valid = bv >= __fmul_rn(r_norm, sp) && bv > 0.0f;
            if (valid) {
                const int foi = (int)frq;
                const float* col = sgl + n2 * s_r + foi * s_f;
                float rv = neg_inf();
                int rk = INT_MAX;
                for (int k = lane; k <= 2 * arm; k += 32) {
                    const float v = col[wrap_lag(ind + k - arm) * s_l];
                    if (better(v, k, rv, rk)) { rv = v; rk = k; }
                }
                warp_best(rv, rk);
                if (lane == 0)
                    reinterpret_cast<float4*>(tab)[trip] = make_float4(
                        bv, (float)wrap_lag(ind + rk - arm), (float)foi,
                        (float)n2);
            }
            if (lane == 0) { s_pp = bv; s_flat = bi; s_valid = valid; }
        }
        __syncthreads();
        if (!s_valid) {
            for (int k = 4 * trip + tid; k < 4 * max_peaks; k += kThreads)
                tab[k] = 0.0f;
            return;
        }
        if (++trip == max_peaks) return;

        // This trip's cancellation, fused with the next trip's argmax.
        const float pp = s_pp;
        const int n2 = s_flat / kLags, ind = s_flat - n2 * kLags;
        const float t8 = __fmul_rn(pp, db8), t12 = __fmul_rn(pp, db12);
        bv = neg_inf();
        bi = INT_MAX;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const bool same = r == n2;
            for (int q = tid; q < kVec; q += kThreads) {
                float4 x = work[r * kVec + q];
                const int f = r * kLags + 4 * q;
                bool changed = false;
                cancel(x.x, 4 * q, ind, same, t8, t12, changed);
                cancel(x.y, 4 * q + 1, ind, same, t8, t12, changed);
                cancel(x.z, 4 * q + 2, ind, same, t8, t12, changed);
                cancel(x.w, 4 * q + 3, ind, same, t8, t12, changed);
                if (changed) work[r * kVec + q] = x;
                if (better(x.x, f, bv, bi)) { bv = x.x; bi = f; }
                if (better(x.y, f + 1, bv, bi)) { bv = x.y; bi = f + 1; }
                if (better(x.z, f + 2, bv, bi)) { bv = x.z; bi = f + 2; }
                if (better(x.w, f + 3, bv, bi)) { bv = x.w; bi = f + 3; }
            }
        }
    }
}

}  // namespace

extern "C" int peak_greedy_launch(const float* packed, const float* single,
                                  int B, long long s_b, long long s_r,
                                  long long s_l, long long s_f,
                                  float r_norm, int arm, int max_peaks,
                                  float db8, float db12, float* out,
                                  void* stream)
{
    if (B < 1 || arm < 0 || arm >= kLags || max_peaks < 1)
        return (int)cudaErrorInvalidValue;
    const int smem = (int)(sizeof(float) * kRows * kLags);
    // The attribute belongs to the current device's context: set it on
    // every launch (cheap next to the kernel) rather than cache it.
    const cudaError_t err = cudaFuncSetAttribute(
        peak_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    peak_greedy_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        packed, single, s_b, s_r, s_l, s_f, r_norm, arm, max_peaks, db8,
        db12, out);
    return (int)cudaGetLastError();
}
