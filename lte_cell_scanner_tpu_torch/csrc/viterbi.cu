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
// A is +-1 (models/convcode.py::chain_tables), so A[k, p] * l equals l with
// its sign bit flipped where A[k, p] = -1, bit for bit. The kernel reads a
// 1024-entry 12-bit sign mask instead of A and adds the flipped LLRs in the
// row order k = 0..11, the order of the plain PyTorch version; every
// comparison breaks ties to the first index, so the decoded bits are
// bit-identical to it.
//
// Bound on the H100: operations. Per codeword the joint pass takes, for
// each of the 64 x 64 (state, start) pairs, 1, 4 and then 16 finite
// candidates per step, an add and a max each; the branch sums 11 x 1024
// adds per step; the replay 16, 256 and then 1024 candidates per step. At
// the MIB batch (L = 768, 10 steps) ~0.94 G operations, ~0.014 ms when
// each is held to 67 T/s (the f32 FMA peak counting 2 per FMA, so an add
// or a max, one instruction each, is held to twice its issue rate), on
// 0.5 MB of LLRs and tables. Design: one block of 256 threads per codeword.
//   - The codeword's 10 x 12 LLRs are loaded once, by 120 threads at
//     once; the branch sums of all steps are computed once, up front (each
//     thread keeps the sign words of its 4 branches in registers and runs
//     them as 4 independent chains), and stay in shared memory (n_steps x
//     4 KB) for the joint pass and the replay.
//   - The (64 x 64) joint metric is one shared buffer, [state][start]:
//     thread (ss, g) reads the 16 predecessors of its start ss in group g
//     conflict-free into registers, a barrier, then writes the 16 current
//     states of that group; a step's branch sums are float4 broadcasts.
//     The first two steps take only their finite candidates (1 and 4 of
//     16), which the diagonal start fixes.
//   - The start is a warp reduction on (value, index), first index on ties.
//   - The replay runs on all 256 threads: 4 per state, 4 candidates each,
//     reduced across the 4 lanes by shuffles, first index on ties.
//   - The traceback walks the 10 backpointers in shared memory (a chain of
//     dependent reads, one thread), and 40 threads then write the bits.
// Shared memory at 10 steps: 40 KB of branch sums, 16 KB of metric,
// ~1.7 KB of LLRs, replay metrics and backpointers: 3 blocks per SM.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kStates = 64;
constexpr int kChains = 16;              // 2^4 chains per fused step
constexpr int kBranches = kStates * kChains;
constexpr int kRows = 12;                // 4 steps x 3 coded bits
constexpr int kThreads = 256;
constexpr int kBranchPerThread = kBranches / kThreads;
constexpr int kMaxSteps = 32;

size_t smem_bytes(int n_steps)
{
    return sizeof(float) * ((size_t)n_steps * kBranches   // adds
                            + kStates * kStates           // joint metric
                            + (size_t)n_steps * kRows     // LLRs
                            + 2 * kStates)                // replay metric
           + (size_t)n_steps * kStates;                   // backpointers
}

__device__ __forceinline__ float flip(float x, unsigned int sign)
{
    return __uint_as_float(__float_as_uint(x) ^ sign);
}

__global__ void __launch_bounds__(kThreads, 3)
viterbi_kernel(const float* __restrict__ llr,   // (n_steps, 12, L)
               int n_steps, int L,
               const int* __restrict__ sign_mask,  // (1024,) bit k: A[k,p]<0
               const int* __restrict__ bits_tab,   // (1024, 4)
               float* __restrict__ out)            // (4 * n_steps, L)
{
    extern __shared__ float4 smem_raw[];
    float* adds = reinterpret_cast<float*>(smem_raw);   // [t][p]
    float* m = adds + (size_t)n_steps * kBranches;      // [state][start]
    float* l = m + kStates * kStates;                   // [t][k]
    float* m1 = l + n_steps * kRows;                    // 2 x [state]
    unsigned char* bps =
        reinterpret_cast<unsigned char*>(m1 + 2 * kStates);   // [t][state]
    __shared__ int start_sh;
    __shared__ int path_sh[kMaxSteps];                  // state*16 + j

    const int lane = blockIdx.x;
    const int tid = threadIdx.x;

    for (int i = tid; i < n_steps * kRows; i += kThreads)
        l[i] = llr[(size_t)i * L + lane];
    __syncthreads();

    // ---- branch sums of every step, in the row order k = 0..11; the
    // thread's 4 branches p = tid + 256q are 4 independent chains.
    {
        unsigned int sg[kBranchPerThread][kRows];
#pragma unroll
        for (int q = 0; q < kBranchPerThread; ++q) {
            const unsigned int mask =
                (unsigned int)sign_mask[tid + q * kThreads];
#pragma unroll
            for (int k = 0; k < kRows; ++k)
                sg[q][k] = ((mask >> k) & 1u) << 31;
        }
        for (int t = 0; t < n_steps; ++t) {
            const float4* l4 = reinterpret_cast<const float4*>(l + t * kRows);
            const float4 a = l4[0], b = l4[1], c = l4[2];
            const float lk[kRows] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                     b.z, b.w, c.x, c.y, c.z, c.w};
            float acc[kBranchPerThread];
#pragma unroll
            for (int q = 0; q < kBranchPerThread; ++q)
                acc[q] = flip(lk[0], sg[q][0]);
#pragma unroll
            for (int k = 1; k < kRows; ++k)
#pragma unroll
                for (int q = 0; q < kBranchPerThread; ++q)
                    acc[q] = acc[q] + flip(lk[k], sg[q][k]);
#pragma unroll
            for (int q = 0; q < kBranchPerThread; ++q)
                adds[t * kBranches + tid + q * kThreads] = acc[q];
        }
    }
    __syncthreads();

    // ---- joint (current, start) metric pass, from m = 0 on the diagonal
    // and -inf elsewhere. Thread (ss, g) makes the states s = 4r + g of
    // start ss, whose predecessors are pred(s, j) = 16g + j. Only finite
    // candidates can win a max, so step 0 takes the one finite candidate
    // of s, pred = ss (j = ss & 15, when g = ss >> 4), and step 1 the four
    // with pred & 3 = ss >> 4 (j = (ss >> 4) + 4i): the same values as the
    // full 16-way max.
    const int ss = tid & (kStates - 1);
    const int g = tid >> 6;                     // predecessor group s & 3
    {
        const bool mine = (ss >> 4) == g;
#pragma unroll 4
        for (int r = 0; r < kStates / 4; ++r) {
            const int s = r * 4 + g;
            m[s * kStates + ss] = mine ? 0.f + adds[s * kChains + (ss & 15)]
                                       : -CUDART_INF_F;
        }
        __syncthreads();
    }
    if (n_steps > 1) {
        const int j0 = ss >> 4;
        float mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            mv[i] = m[(g * kChains + j0 + 4 * i) * kStates + ss];
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < kStates / 4; ++r) {
            const int s = r * 4 + g;
            const float* ad = adds + kBranches + s * kChains + j0;
            float best = mv[0] + ad[0];
            best = fmaxf(best, mv[1] + ad[4]);
            best = fmaxf(best, mv[2] + ad[8]);
            best = fmaxf(best, mv[3] + ad[12]);
            m[s * kStates + ss] = best;
        }
        __syncthreads();
    }
    for (int t = 2; t < n_steps; ++t) {
        float mv[kChains];
#pragma unroll
        for (int j = 0; j < kChains; ++j)
            mv[j] = m[(g * kChains + j) * kStates + ss];
        __syncthreads();                        // every read before a write
        const float* ad_t = adds + t * kBranches;
#pragma unroll 4
        for (int r = 0; r < kStates / 4; ++r) {
            const int s = r * 4 + g;
            const float4* ad =
                reinterpret_cast<const float4*>(ad_t + s * kChains);
            float best = mv[0] + ad[0].x;
#pragma unroll
            for (int q = 0; q < kChains / 4; ++q) {
                const float4 a = ad[q];
                if (q > 0) best = fmaxf(best, mv[4 * q] + a.x);
                best = fmaxf(best, mv[4 * q + 1] + a.y);
                best = fmaxf(best, mv[4 * q + 2] + a.z);
                best = fmaxf(best, mv[4 * q + 3] + a.w);
            }
            m[s * kStates + ss] = best;
        }
        __syncthreads();
    }

    // ---- tail-biting start: first argmax of the diagonal (warp 0).
    if (tid < 32) {
        const float v0 = m[tid * (kStates + 1)];
        const float v1 = m[(tid + 32) * (kStates + 1)];
        float bv = v1 > v0 ? v1 : v0;
        int bi = v1 > v0 ? tid + 32 : tid;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, bv, off);
            const int oi = __shfl_down_sync(0xffffffffu, bi, off);
            if (ov > bv || (ov == bv && oi < bi)) {
                bv = ov;
                bi = oi;
            }
        }
        if (tid == 0) start_sh = bi;
    }
    __syncthreads();
    const int start = start_sh;
    if (tid < kStates) m1[tid] = tid == start ? 0.f : -CUDART_INF_F;
    __syncthreads();

    // ---- single-start replay with first-argmax backpointers: thread
    // (s, q) takes candidates j = 4q..4q+3 of state s.
    {
        const int s = tid >> 2, q = tid & 3;
        float* cur = m1;
        float* nxt = m1 + kStates;
        for (int t = 0; t < n_steps; ++t) {
            const float4 a = *reinterpret_cast<const float4*>(
                adds + t * kBranches + s * kChains + 4 * q);
            const float4 mp = *reinterpret_cast<const float4*>(
                cur + (s & 3) * kChains + 4 * q);
            float best = mp.x + a.x;
            int bj = 4 * q;
            float c = mp.y + a.y;
            if (c > best) { best = c; bj = 4 * q + 1; }
            c = mp.z + a.z;
            if (c > best) { best = c; bj = 4 * q + 2; }
            c = mp.w + a.w;
            if (c > best) { best = c; bj = 4 * q + 3; }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, best, off);
                const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
                if (ov > best || (ov == best && oj < bj)) {
                    best = ov;
                    bj = oj;
                }
            }
            if (q == 0) {
                nxt[s] = best;
                bps[t * kStates + s] = (unsigned char)bj;
            }
            __syncthreads();
            float* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
    }

    // ---- traceback: the state walk, then 40 threads write the bits.
    if (tid == 0) {
        int state = start;
        for (int t = n_steps - 1; t >= 0; --t) {
            const int j = bps[t * kStates + state];
            path_sh[t] = state * kChains + j;
            state = ((state << 4) & (kStates - 1)) | j;
        }
    }
    __syncthreads();
    if (tid < 4 * n_steps) {
        const int t = tid >> 2, i = tid & 3;
        out[(size_t)tid * L + lane] = (float)bits_tab[path_sh[t] * 4 + i];
    }
}

}  // namespace

extern "C" int viterbi_launch(const float* llr, int n_steps, int L,
                              const int* sign_mask, const int* bits_tab,
                              float* out, void* stream)
{
    if (n_steps < 1 || n_steps > kMaxSteps || L < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(n_steps);
    // The attribute belongs to the current device's context: set it on
    // every launch (cheap next to the kernel) rather than cache it.
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    viterbi_kernel<<<L, kThreads, smem, (cudaStream_t)stream>>>(
        llr, n_steps, L, sign_mask, bits_tab, out);
    return (int)cudaGetLastError();
}
