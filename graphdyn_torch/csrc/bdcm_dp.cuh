// The BDCM class update of one edge, shared by the per-class kernel
// (bdcm_contract.cu) and the one-launch sweep kernel (bdcm_sweep.cu): the
// ρ-lattice DP, the contraction against the tilted factor, the ε-clamp, the
// normalisation and the damping. Both entries run these bodies, so a class
// computed either way has the same bits.
//
// For edge e and destination trajectory x_i (K = 2^T, M = (d+1)^T):
//   LL[x_i, ρ] = Σ over the d incoming source trajectories x_k(D) of
//                Π_D chi_in[e, D, x_k(D), x_i]   with ρ = Σ_D x_k(D)
//   (flat mixed-radix shift DP: trajectory k moves the flat lattice index by
//   off_k = Σ_t b_t (d+1)^(T-1-t); no carry, every coordinate stays ≤ d)
//   chi2[x_i, x_j] = max(Σ_m A_tilted[x_i, x_j, m] LL[x_i, m], eps)
//   out = damp · chi2 / max(Σ chi2, tiny) + (1 − damp) · chi_old
//
// - reg_edge: the register path (M ≤ 32, d ≤ 8). One thread per (edge,
//   x_i); the K threads of an edge are adjacent lanes of one warp (K ≤ 16
//   divides 32). The lattice row and the accumulator live in registers,
//   with (D, T) template constants, so every shift-FMA has a constant
//   register index. z is reduced over the edge's K lanes with warp
//   shuffles, so every lane of the warp must call it, live or not.
// - block_edge: the block path (every larger lattice up to what one block's
//   shared memory holds). The block's threads own the lattice entries
//   m ≡ threadIdx.x (mod blockDim.x) of two rows in shared memory and run
//   the edge's K destination rows one after another; every thread of the
//   block must call it.
// Each thread's order of operations depends on neither the number of edges
// nor the grid, so grouped and serial runs give the same bits.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace bdcm {

constexpr int kThreads = 256;          // at most, per block
constexpr int kRegMaxM = 32;           // the register path's lattices
constexpr int kRegMaxD = 8;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 232448;       // per block, after the opt-in attribute

__host__ __device__ constexpr int ipow(int b, int e)
{
    return e == 0 ? 1 : b * ipow(b, e - 1);
}

// flat lattice shift of trajectory k (product([1, 0]) order: bit t of the
// trajectory is 1 - bit (T-1-t) of k)
__host__ __device__ constexpr int flat_offset(int k, int d, int T)
{
    int off = 0;
    for (int t = 0; t < T; ++t) off = off * (d + 1) + (1 - ((k >> (T - 1 - t)) & 1));
    return off;
}

template <typename F> __device__ __forceinline__ F tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny_of<double>() { return DBL_MIN; }

template <typename F> __device__ __forceinline__ F fmax_of(F a, F b) { return a > b ? a : b; }

// z over the K lanes of one edge, the remaining contraction and damping;
// v[] holds this thread's clamped row chi2[x_i, ·]
template <typename F, int K>
__device__ __forceinline__ void finish(const F (&v)[K], F zpart, bool live,
                                       const F* __restrict__ old,
                                       F* __restrict__ out, F damp, F omd)
{
    F z = zpart;
#pragma unroll
    for (int o = K / 2; o >= 1; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    const F inv = F(1) / fmax_of(z, tiny_of<F>());
    if (!live) return;
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = damp * v[j] * inv + omd * old[j];
}

// One (edge, x_i) on the register path. ci: the edge's inputs [D, K, K]
// (global or shared memory; read only when live); arow: the factor rows
// A_tilted[x_i, ·, ·] ([K, M], shared memory); old/out: row x_i of the
// edge's chi_old and output ([K] each).
template <typename F, int D, int T>
__device__ __forceinline__ void reg_edge(const F* ci, const F* arow, int xi,
                                         bool live, const F* old, F* out,
                                         F damp, F omd, F eps)
{
    constexpr int K = 1 << T;
    constexpr int M = ipow(D + 1, T);
    F ll[M];
#pragma unroll
    for (int m = 0; m < M; ++m) ll[m] = F(0);
    ll[0] = F(1);
#pragma unroll
    for (int s = 0; s < D; ++s) {
        F acc[M];
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] = F(0);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int off = flat_offset(k, D, T);
            const F w = live ? ci[(s * K + k) * K + xi] : F(0);
#pragma unroll
            for (int m = 0; m < M; ++m)
                if (m >= off) acc[m] += ll[m - off] * w;
        }
#pragma unroll
        for (int m = 0; m < M; ++m) ll[m] = acc[m];
    }

    F v[K];
    F zpart = F(0);
#pragma unroll
    for (int j = 0; j < K; ++j) {
        F sum = F(0);
#pragma unroll
        for (int m = 0; m < M; ++m) sum += arow[j * M + m] * ll[m];
        v[j] = fmax_of(sum, eps);
        zpart += v[j];
    }
    finish<F, K>(v, zpart, live, old, out, damp, omd);
}

// Shared bytes the block path indexes: two lattice rows, the edge's K·K
// clamped outputs, one K-row of partial sums per warp.
__host__ __device__ inline long long block_smem_elems(long long M, int K, int threads)
{
    return 2 * M + (long long)K * K + (long long)(threads / 32) * K;
}

// One edge on the block path. w_of(s, k, xi) returns the edge's input
// chi_in[s, k, xi]; a_g: the edge's factor [K, K, M] (global memory);
// old/out: the edge's chi_old and output rows ([K, K] each); smem: at least
// block_smem_elems(M, K, blockDim.x) elements.
template <typename F, int T, typename WOf>
__device__ __forceinline__ void block_edge(WOf w_of, const F* __restrict__ a_g,
                                           int d, int M, const F* old, F* out,
                                           F damp, F omd, F eps, F* smem)
{
    constexpr int K = 1 << T;
    F* ll = smem;                             // [M] the row being built
    F* acc = ll + M;                          // [M] the next one
    F* chi2 = acc + M;                        // [K, K] the edge's clamped rows
    F* part = chi2 + K * K;                   // [warps, K] contraction partials
    const int warps = blockDim.x / 32;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    int offs[K];
#pragma unroll
    for (int k = 0; k < K; ++k) offs[k] = flat_offset(k, d, T);

    for (int xi = 0; xi < K; ++xi) {
        for (int m = threadIdx.x; m < M; m += blockDim.x)
            ll[m] = m == 0 ? F(1) : F(0);
        __syncthreads();
        for (int s = 0; s < d; ++s) {
            F w[K];
#pragma unroll
            for (int k = 0; k < K; ++k) w[k] = w_of(s, k, xi);
            for (int m = threadIdx.x; m < M; m += blockDim.x) {
                F sum = F(0);
#pragma unroll
                for (int k = 0; k < K; ++k)
                    if (m >= offs[k]) sum += ll[m - offs[k]] * w[k];
                acc[m] = sum;
            }
            __syncthreads();
            F* tmp = ll; ll = acc; acc = tmp;
        }
        const F* arow = a_g + (long long)xi * K * M;
        F c[K];
#pragma unroll
        for (int j = 0; j < K; ++j) c[j] = F(0);
        for (int m = threadIdx.x; m < M; m += blockDim.x) {
            const F l = ll[m];
#pragma unroll
            for (int j = 0; j < K; ++j) c[j] += __ldg(arow + j * M + m) * l;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
#pragma unroll
            for (int o = 16; o >= 1; o >>= 1)
                c[j] += __shfl_xor_sync(0xffffffffu, c[j], o);
        }
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < K; ++j) part[warp * K + j] = c[j];
        }
        __syncthreads();
        if (threadIdx.x < K) {
            F sum = F(0);
            for (int w2 = 0; w2 < warps; ++w2) sum += part[w2 * K + threadIdx.x];
            chi2[xi * K + threadIdx.x] = fmax_of(sum, eps);
        }
    }
    __syncthreads();
    F z = F(0);
    for (int j = 0; j < K * K; ++j) z += chi2[j];
    const F inv = F(1) / fmax_of(z, tiny_of<F>());
    for (int j = threadIdx.x; j < K * K; j += blockDim.x)
        out[j] = damp * chi2[j] * inv + omd * old[j];
    __syncthreads();
}

}  // namespace bdcm
