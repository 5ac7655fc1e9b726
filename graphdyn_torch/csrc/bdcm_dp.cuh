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
// - reg_edge: the register path (M ≤ 32, d ≤ 8, T ≤ 4). One thread per (edge,
//   x_i); the K threads of an edge are adjacent lanes of one warp (K ≤ 16
//   divides 32). The lattice row and the accumulator live in registers,
//   with (D, T) template constants, so every shift-FMA has a constant
//   register index. z is reduced over the edge's K lanes with warp
//   shuffles, so every lane of the warp must call it, live or not.
// - lattice_edge: the block path (the two lattice rows in shared memory,
//   every larger lattice up to what one block's shared memory holds) and
//   the global path (the two rows in the block's slot of a device
//   workspace, every lattice beyond). The block's threads own the lattice
//   entries m ≡ threadIdx.x (mod blockDim.x) of the two rows and run the
//   edge's K destination rows one after another; on the block path the
//   source weights of several DP steps are loaded together into shared
//   memory, from K = 32 the offsets sit there too, and the contraction runs
//   in register tiles of at most 16 columns, so no thread holds 64 values
//   at T = 6; every thread of the block must call it.
// Each thread's order of operations depends on neither the number of edges
// nor the grid nor the path's memory, so grouped and serial runs give the
// same bits, and a class gives the same bits on the block and global paths.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace bdcm {

constexpr int kThreads = 256;          // at most, per block
constexpr int kRegMaxM = 32;           // the register path's lattices
constexpr int kRegMaxD = 8;
constexpr int kRegMaxT = 4;            // K ≤ 16 lanes of one warp per edge
constexpr int kMaxT = 6;               // the instantiated horizons, 1..6
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

// Source weights staged per buffer on the block and global paths: the
// weights of kWStage / K consecutive DP steps, loaded together.
constexpr int kWStage = 256;

// Shared elements the block and global paths index besides the two lattice
// rows: the edge's K·K clamped outputs, one K-row of partial sums per warp,
// two buffers of staged source weights (2·kWStage) and the K flat offsets
// (ints in element slots).
__host__ __device__ inline long long edge_smem_elems(int K, int threads)
{
    return (long long)K * K + (long long)(threads / 32) * K + 2LL * kWStage
         + K;
}

// Shared elements of the block path: the two lattice rows and the above.
__host__ __device__ inline long long block_smem_elems(long long M, int K, int threads)
{
    return 2 * M + edge_smem_elems(K, threads);
}

// One edge on the block path (rows in shared memory) or the global path
// (rows in the block's slot of a device workspace). w_of(s, k, xi) returns
// the edge's input chi_in[s, k, xi]; a_g: the edge's factor [K, K, M]
// (global memory); old/out: the edge's chi_old and output rows ([K, K]
// each); rows: the two [M] lattice rows; smem: edge_smem_elems(K,
// blockDim.x) shared elements. Every thread of the block must call it.
//
// kStage (the block path): the source weights of kWStage / K consecutive
// DP steps (all of them, for d ≤ kWStage / K) are loaded together into a
// shared buffer, so a chain of dependent loads behind a weight (the sweep
// kernel's in-edge, class id, row and bias) costs its latency once per
// chunk of steps, not once per step; two buffers alternate, so one barrier
// per step suffices. Without it (the global path, where staging measured
// slower) each step loads its own K weights before the step's barrier. No
// thread
// keeps more than 16 values of a K-vector: up to K = 16 (T ≤ 4) each
// thread copies the step's K weights and holds the K offsets in registers;
// from K = 32 both are read from shared memory. The contraction runs the K
// destination columns in register tiles of JT ≤ 16.
// The sums per lattice entry and per output run in the same order on both
// paths and at every K: per m the K shifted entries in trajectory order;
// per column j the thread's entries m ≡ threadIdx.x (mod blockDim.x) in
// order, then the warp's butterfly, then the warps in order.
template <typename F, int T, bool kStage, typename WOf>
__device__ __forceinline__ void lattice_edge(WOf w_of, const F* __restrict__ a_g,
                                             int d, int M, const F* old, F* out,
                                             F damp, F omd, F eps, F* rows,
                                             F* smem)
{
    constexpr int K = 1 << T;
    constexpr int JT = K < 16 ? K : 16;       // destination columns per tile
    constexpr bool kRegW = K <= 16;           // step weights in registers
    constexpr int SC = kWStage / K;           // DP steps per staged chunk
    const int warps = blockDim.x / 32;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    F* ll = rows;                             // [M] the row being built
    F* acc = rows + M;                        // [M] the next one
    F* chi2 = smem;                           // [K, K] the edge's clamped rows
    F* part = chi2 + K * K;                   // [warps, K] contraction partials
    F* wst = part + warps * K;                // [2, kWStage] staged weights
    int* offs = reinterpret_cast<int*>(wst + 2 * kWStage);  // [K] offsets
    int roffs[kRegW ? K : 1];
    if constexpr (kRegW) {
#pragma unroll
        for (int k = 0; k < K; ++k) roffs[k] = flat_offset(k, d, T);
    } else {
        for (int k = threadIdx.x; k < K; k += blockDim.x)
            offs[k] = flat_offset(k, d, T);
    }

    for (int xi = 0; xi < K; ++xi) {
        for (int m = threadIdx.x; m < M; m += blockDim.x)
            ll[m] = m == 0 ? F(1) : F(0);
        for (int s = 0; s < d; ++s) {
            const F* w;
            F wr[kRegW ? K : 1];
            if constexpr (kStage) {
                const int q = s / SC;         // the chunk of step s
                F* buf = wst + (q & 1) * kWStage;
                if (s == q * SC) {
                    // steps s .. s + SC - 1 (those < d): every load in
                    // flight at once. The buffer's last readers ran chunk
                    // q - 2, done by every thread before the barrier of
                    // step s - 1.
                    const int n = (d - s < SC ? d - s : SC) * K;
                    for (int t = threadIdx.x; t < n; t += blockDim.x)
                        buf[t] = w_of(s + t / K, t % K, xi);
                }
                w = buf + (s - q * SC) * K;
            } else {
                // step s's weights only: each thread's own copy up to
                // K = 16, a shared buffer (two, alternating) from K = 32
                F* buf = wst + (s & 1) * kWStage;
                if constexpr (kRegW) {
#pragma unroll
                    for (int k = 0; k < K; ++k) wr[k] = w_of(s, k, xi);
                } else {
                    for (int k = threadIdx.x; k < K; k += blockDim.x)
                        buf[k] = w_of(s, k, xi);
                }
                w = buf;
            }
            // step s - 1 done by every thread: its row is complete, the row
            // it read is free, and step s's weights are staged
            __syncthreads();
            if constexpr (kRegW && kStage) {
#pragma unroll
                for (int k = 0; k < K; ++k) wr[k] = w[k];
            }
            for (int m = threadIdx.x; m < M; m += blockDim.x) {
                F sum = F(0);
                if constexpr (kRegW) {
#pragma unroll
                    for (int k = 0; k < K; ++k)
                        if (m >= roffs[k]) sum += ll[m - roffs[k]] * wr[k];
                } else {
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        const int o = offs[k];
                        if (m >= o) sum += ll[m - o] * w[k];
                    }
                }
                acc[m] = sum;
            }
            F* tmp = ll; ll = acc; acc = tmp;
        }
        __syncthreads();
        const F* arow = a_g + (long long)xi * K * M;
        for (int j0 = 0; j0 < K; j0 += JT) {
            F c[JT];
#pragma unroll
            for (int j = 0; j < JT; ++j) c[j] = F(0);
            for (int m = threadIdx.x; m < M; m += blockDim.x) {
                const F l = ll[m];
#pragma unroll
                for (int j = 0; j < JT; ++j)
                    c[j] += __ldg(arow + (long long)(j0 + j) * M + m) * l;
            }
#pragma unroll
            for (int j = 0; j < JT; ++j) {
#pragma unroll
                for (int o = 16; o >= 1; o >>= 1)
                    c[j] += __shfl_xor_sync(0xffffffffu, c[j], o);
            }
            if (lane == 0) {
#pragma unroll
                for (int j = 0; j < JT; ++j) part[warp * K + j0 + j] = c[j];
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < K; j += blockDim.x) {
            F sum = F(0);
            for (int w2 = 0; w2 < warps; ++w2) sum += part[w2 * K + j];
            chi2[xi * K + j] = fmax_of(sum, eps);
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
