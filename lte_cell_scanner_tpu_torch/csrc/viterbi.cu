// Exact-ML tail-biting Viterbi decoder of the LTE K=7 rate-1/3
// convolutional code, four trellis steps fused per pass.
//
// Replaces the TPU kernel lte_cell_scanner_tpu/models/viterbi_pallas.py
// `_kernel` (entries lte_conv_decode_pallas_tl / lte_conv_decode_pallas).
// For every codeword lane:
//
//   adds[p]   = sum_{k=0..11} A[k, p] * llr[t, k]      (p = s*16 + j)
//   joint:      m[s, ss] = max_j m[pred(s, j), ss] + adds[s*16 + j],
//               pred(s, j) = ((s << 4) & 63) | j
//   start     = first argmax_ss m[ss, ss]
//   replay:     m1[s], bp[t, s] = max / first argmax_j m1[pred(s, j)] + adds
//   traceback:  j = bp[t, state]; bits = BITS[state, j];
//               state = ((state << 4) & 63) | j
//
// The branch sums are added in the row order k = 0..11, the same order as
// the plain PyTorch version, and every comparison breaks ties to the first
// index, so the decoded bits are bit-identical to it.
//
// Bound on the H100: latency. At the MIB batch (L = 768 codewords) the
// joint pass is ~0.5 G add/max operations (~7 us at the card's integer and
// f32 issue rate) on 64 KB of LLRs, but each codeword is a chain of 20
// dependent trellis passes separated by block barriers. Design: one block
// of 256 threads per codeword; the (64 x 64) joint metric is ping-ponged in
// shared memory with the start state fastest, so thread (ss, g) reads the
// 16 predecessors of its start ss in group g conflict-free, keeps them in
// registers, and reuses them for the 16 current states of that group; the
// branch sums of a step are read as float4 broadcasts. The replay's 10 x 64
// backpointers stay in shared memory for the traceback.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kStates = 64;
constexpr int kChains = 16;              // 2^4 chains per fused step
constexpr int kBranches = kStates * kChains;
constexpr int kRows = 12;                // 4 steps x 3 coded bits
constexpr int kThreads = 256;
constexpr int kMaxSteps = 32;

__device__ __forceinline__ void branch_sums(const float* __restrict__ A,
                                            const float* l12, float* adds,
                                            int tid)
{
    for (int p = tid; p < kBranches; p += kThreads) {
        float acc = A[p] * l12[0];
#pragma unroll
        for (int k = 1; k < kRows; ++k) acc = acc + A[k * kBranches + p] * l12[k];
        adds[p] = acc;
    }
}

__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ llr,   // (n_steps, 12, L)
               int n_steps, int L,
               const float* __restrict__ A,     // (12, 1024), entries +-1
               const int* __restrict__ bits_tab,  // (1024, 4)
               float* __restrict__ out)         // (4 * n_steps, L)
{
    __shared__ float ma[kStates * kStates];     // [state][start]
    __shared__ float mb[kStates * kStates];
    __shared__ __align__(16) float adds[kBranches];
    __shared__ float l12[kRows];
    __shared__ float m1[kStates];
    __shared__ unsigned char bps[kMaxSteps * kStates];
    __shared__ int start_sh;

    const int lane = blockIdx.x;
    const int tid = threadIdx.x;

    for (int i = tid; i < kStates * kStates; i += kThreads)
        ma[i] = (i / kStates == i % kStates) ? 0.f : -CUDART_INF_F;

    // ---- joint (current, start) metric pass.
    float* cur = ma;
    float* nxt = mb;
    const int ss = tid & (kStates - 1);
    const int g = tid >> 6;                     // predecessor group s & 3
    for (int t = 0; t < n_steps; ++t) {
        if (tid < kRows) l12[tid] = llr[((size_t)t * kRows + tid) * L + lane];
        __syncthreads();
        branch_sums(A, l12, adds, tid);
        __syncthreads();
        float mv[kChains];
#pragma unroll
        for (int j = 0; j < kChains; ++j)
            mv[j] = cur[(g * kChains + j) * kStates + ss];
#pragma unroll 4
        for (int r = 0; r < kStates / 4; ++r) {
            const int s = r * 4 + g;
            const float4* ad = reinterpret_cast<const float4*>(adds + s * kChains);
            float best = -CUDART_INF_F;
#pragma unroll
            for (int q = 0; q < kChains / 4; ++q) {
                const float4 a = ad[q];
                best = fmaxf(best, mv[4 * q] + a.x);
                best = fmaxf(best, mv[4 * q + 1] + a.y);
                best = fmaxf(best, mv[4 * q + 2] + a.z);
                best = fmaxf(best, mv[4 * q + 3] + a.w);
            }
            nxt[s * kStates + ss] = best;
        }
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    // ---- tail-biting start: first argmax of the diagonal.
    if (tid == 0) {
        int best = 0;
        float bv = cur[0];
        for (int s = 1; s < kStates; ++s) {
            const float v = cur[s * kStates + s];
            if (v > bv) {
                bv = v;
                best = s;
            }
        }
        start_sh = best;
    }
    __syncthreads();
    const int start = start_sh;
    if (tid < kStates) m1[tid] = tid == start ? 0.f : -CUDART_INF_F;

    // ---- single-start replay with first-argmax backpointers.
    for (int t = 0; t < n_steps; ++t) {
        if (tid < kRows) l12[tid] = llr[((size_t)t * kRows + tid) * L + lane];
        __syncthreads();
        branch_sums(A, l12, adds, tid);
        __syncthreads();
        float nm = 0.f;
        if (tid < kStates) {
            const int s = tid;
            const int base = (s & 3) * kChains;
            float best = m1[base] + adds[s * kChains];
            int bj = 0;
            for (int j = 1; j < kChains; ++j) {
                const float c = m1[base + j] + adds[s * kChains + j];
                if (c > best) {
                    best = c;
                    bj = j;
                }
            }
            nm = best;
            bps[t * kStates + s] = (unsigned char)bj;
        }
        __syncthreads();
        if (tid < kStates) m1[tid] = nm;
    }
    __syncthreads();

    // ---- traceback.
    if (tid == 0) {
        int state = start;
        for (int t = n_steps - 1; t >= 0; --t) {
            const int j = bps[t * kStates + state];
            const int* bt = bits_tab + (state * kChains + j) * 4;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                out[(size_t)(4 * t + i) * L + lane] = (float)bt[i];
            state = ((state << 4) & (kStates - 1)) | j;
        }
    }
}

}  // namespace

extern "C" int viterbi_launch(const float* llr, int n_steps, int L,
                              const float* A, const int* bits_tab,
                              float* out, void* stream)
{
    if (n_steps < 1 || n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
    viterbi_kernel<<<L, kThreads, 0, (cudaStream_t)stream>>>(
        llr, n_steps, L, A, bits_tab, out);
    return (int)cudaGetLastError();
}
