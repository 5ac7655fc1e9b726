// The BDCM class update of G instances: ρ-lattice DP, contraction against
// the tilted factor, ε-clamp, normalisation, damping.
//
// Replaces the Pallas TPU kernel of the JAX package
//   K3  graphdyn/ops/pallas_bdcm.py:200  dp_contract_grouped
//       (kernel body _dp_contract_kernel, :130; dp_contract :307 is its
//       G=1 instance)
// and computes what graphdyn_torch/ops/bdcm.py:dp_contract_grouped_plain
// computes, up to the order of the sums.
//
// For edge e of group g and destination trajectory x_i:
//   LL[x_i, ρ] = Σ over the d incoming source trajectories x_k(D) of
//                Π_D chi_in[g, e, D, x_k(D), x_i]   with ρ = Σ_D x_k(D)
//   (flat mixed-radix shift DP: trajectory k moves the flat lattice index by
//   off_k = Σ_t b_t (d+1)^(T-1-t); no carry, every coordinate stays ≤ d)
//   chi2[x_i, x_j] = max(Σ_m A_tilted[x_i, x_j, m] LL[x_i, m], eps)
//   out = damp · chi2 / max(Σ chi2, tiny) + (1 − damp) · chi_old
// with A_tilted shared [K, K, M] or per group [G, K, K, M]; K = 2^T,
// M = (d+1)^T.
//
// What bounds it on an H100. At config 2 of the HPr solver (union of 256
// copies of a d=3 RRG, n=1e5: Ed = 7.68e7, D=2, T=2, M=9) one launch reads
// chi_in (Ed·D·K² values) and chi_old and writes out, 19.7 GB in f32, about
// 5.9 ms at 3.35 TB/s, against about 1 ms of f32 arithmetic: bytes bound
// it. At the reference shape (n=1e4, d=4: Ed = 4e4, D=3, M=16) a launch
// moves 12.8 MB, about 4 µs, so launch latency sets the pace there.
//
// Design. Row-major layouts as PyTorch holds them, no transposes: one edge's
// D·K·K inputs are contiguous. Three paths, chosen by the caller's launch plan
// (launch_plan in graphdyn_torch/ops/bdcm_cuda.py):
// - register path (M ≤ 32, D ≤ 8, T ≤ 4: the HPr main paths' classes). One
//   thread per (edge, x_i); an edge's K threads are adjacent lanes of one
//   warp (K ≤ 16 divides 32), so each load of chi_in[e, D, k, ·] is K
//   adjacent values. The thread keeps its lattice row LL[x_i, 0..M) and the
//   accumulator in registers, with (D, T) template constants, so every
//   shift-FMA has a constant register index; the factor rows are staged in
//   shared memory per block (the block's group slab in the per-group
//   variant). z is reduced over the edge's K lanes with warp shuffles, then
//   multiplied by its reciprocal, as the Pallas kernel does.
// - block path (every larger lattice up to what one block's shared memory
//   holds: all of T ≤ 4, D ≤ 8, and T = 5, 6 at small D). One block per
//   (edge, group), grid-strided over the edges. The block's threads own the
//   lattice entries m ≡ threadIdx.x (mod blockDim.x) of two rows in shared
//   memory and run the edge's K destination rows one after another: each DP
//   step sums, per m, the K shifted entries in trajectory order (the step's
//   K weights staged in shared memory); the contraction runs in register
//   tiles of columns and is reduced over the block, and the edge's clamped
//   chi2 waits in shared memory for z.
// - global path (every lattice whose two rows exceed a block's shared
//   memory): the same per-edge body with the two rows in a device workspace
//   of ws_slots × 2M elements from the caller; a 1-D grid of min(G·Ed,
//   ws_slots) blocks walks the (group, edge) members, block b in slot b.
// The per-edge bodies of the paths live in bdcm_dp.cuh, shared with the
// one-launch sweep kernel (bdcm_sweep.cu), which runs the main paths; this
// entry is the per-class counterpart of the JAX package's public
// dp_contract_grouped. Grid: (⌈Ed·K / block⌉, G), (min(Ed, 2^31−1), G) or
// (min(G·Ed, ws_slots)) by path; T = 1..6 instantiated on the block and
// global paths.
// Each thread's order of operations does not depend on G or Ed. Templated
// on float and double: the reference solver runs in float64. No tensor
// cores: the contraction is a short dot product.
//
// C interface (bound with ctypes): graphdyn_bdcm_contract takes the launch
// plan (path, threads per block, dynamic shared bytes) from the caller,
// checks it against the kernel's bounds, and returns the cudaError_t of the
// launch, 0 on success, cudaErrorInvalidValue for a plan or shape outside
// them. It launches on the given stream and does not synchronise.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bdcm_dp.cuh"

namespace {

using namespace bdcm;

template <typename F, int D, int T>
__global__ void __launch_bounds__(kThreads)
dp_contract_reg(const F* __restrict__ chi_in, const F* __restrict__ a,
                const F* __restrict__ chi_old, F* __restrict__ out,
                long long Ed, long long a_group_stride, F damp, F omd, F eps)
{
    constexpr int K = 1 << T;
    constexpr int M = ipow(D + 1, T);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    F* a_s = reinterpret_cast<F*>(smem_raw);
    const long long g = blockIdx.y;
    const F* a_g = a + g * a_group_stride;
    for (int i = threadIdx.x; i < K * K * M; i += blockDim.x) a_s[i] = a_g[i];
    __syncthreads();

    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long e = tid / K;
    const int xi = (int)(tid % K);
    const bool live = e < Ed;
    const long long row = g * Ed + (live ? e : 0);
    reg_edge<F, D, T>(chi_in + row * (long long)(D * K * K), a_s + xi * K * M,
                      xi, live, chi_old + row * (K * K) + xi * K,
                      out + row * (K * K) + xi * K, damp, omd, eps);
}

template <typename F, int T>
__global__ void __launch_bounds__(kThreads)
dp_contract_block(const F* __restrict__ chi_in, const F* __restrict__ a,
                  const F* __restrict__ chi_old, F* __restrict__ out,
                  long long Ed, long long a_group_stride, int d, int M,
                  F damp, F omd, F eps)
{
    constexpr int K = 1 << T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    F* smem = reinterpret_cast<F*>(smem_raw);
    const long long g = blockIdx.y;
    const F* a_g = a + g * a_group_stride;
    for (long long e = blockIdx.x; e < Ed; e += gridDim.x) {
        const long long row = g * Ed + e;
        const F* ci = chi_in + row * (long long)d * K * K;
        lattice_edge<F, T, true>(
            [ci](int s, int k, int xi) { return __ldg(ci + (s * K + k) * K + xi); },
            a_g, d, M, chi_old + row * (K * K), out + row * (K * K), damp, omd,
            eps, smem, smem + 2 * M);
    }
}

// the global path: members m = g·Ed + e over a 1-D grid of at most
// ws_slots blocks, block b's lattice rows in slot b of ws
template <typename F, int T>
__global__ void __launch_bounds__(kThreads)
dp_contract_global(const F* __restrict__ chi_in, const F* __restrict__ a,
                   const F* __restrict__ chi_old, F* __restrict__ out,
                   long long G, long long Ed, long long a_group_stride, int d,
                   int M, F damp, F omd, F eps, F* ws)
{
    constexpr int K = 1 << T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    F* smem = reinterpret_cast<F*>(smem_raw);
    F* rows = ws + (long long)blockIdx.x * 2 * M;
    for (long long row = blockIdx.x; row < G * Ed; row += gridDim.x) {
        const long long g = row / Ed;
        const F* ci = chi_in + row * (long long)d * K * K;
        lattice_edge<F, T, false>(
            [ci](int s, int k, int xi) { return __ldg(ci + (s * K + k) * K + xi); },
            a + g * a_group_stride, d, M, chi_old + row * (K * K),
            out + row * (K * K), damp, omd, eps, rows, smem);
    }
}

struct Launch {
    const void* chi_in;
    const void* a;
    const void* chi_old;
    void* out;
    long long G, Ed;
    long long a_stride;
    int d, M;
    void* ws;
    double damp, eps;
    dim3 grid;
    int threads, smem;
    cudaStream_t stream;
};

template <typename F, int D, int T>
cudaError_t launch_reg(const Launch& L)
{
    dp_contract_reg<F, D, T><<<L.grid, L.threads, L.smem, L.stream>>>(
        static_cast<const F*>(L.chi_in), static_cast<const F*>(L.a),
        static_cast<const F*>(L.chi_old), static_cast<F*>(L.out), L.Ed,
        L.a_stride, (F)L.damp, (F)(1.0 - L.damp), (F)L.eps);
    return cudaSuccess;
}

template <typename F, int T>
cudaError_t launch_block(const Launch& L)
{
    if (L.smem > kSmemDefault) {
        const cudaError_t rc = cudaFuncSetAttribute(
            dp_contract_block<F, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            L.smem);
        if (rc != cudaSuccess) return rc;
    }
    dp_contract_block<F, T><<<L.grid, L.threads, L.smem, L.stream>>>(
        static_cast<const F*>(L.chi_in), static_cast<const F*>(L.a),
        static_cast<const F*>(L.chi_old), static_cast<F*>(L.out), L.Ed,
        L.a_stride, L.d, L.M, (F)L.damp, (F)(1.0 - L.damp), (F)L.eps);
    return cudaSuccess;
}

template <typename F, int T>
cudaError_t launch_global(const Launch& L)
{
    if (L.smem > kSmemDefault) {
        const cudaError_t rc = cudaFuncSetAttribute(
            dp_contract_global<F, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
        if (rc != cudaSuccess) return rc;
    }
    dp_contract_global<F, T><<<L.grid, L.threads, L.smem, L.stream>>>(
        static_cast<const F*>(L.chi_in), static_cast<const F*>(L.a),
        static_cast<const F*>(L.chi_old), static_cast<F*>(L.out), L.G, L.Ed,
        L.a_stride, L.d, L.M, (F)L.damp, (F)(1.0 - L.damp), (F)L.eps,
        static_cast<F*>(L.ws));
    return cudaSuccess;
}

// an uninstantiated T (outside 1..6) or a register class outside the
// instantiated (D, T) is refused, never run on another instantiation
template <typename F>
cudaError_t dispatch(const Launch& L, int path, int T)
{
    if (path == 1) {
        switch (T) {
            case 1: return launch_block<F, 1>(L);
            case 2: return launch_block<F, 2>(L);
            case 3: return launch_block<F, 3>(L);
            case 4: return launch_block<F, 4>(L);
            case 5: return launch_block<F, 5>(L);
            case 6: return launch_block<F, 6>(L);
            default: return cudaErrorInvalidValue;
        }
    }
    if (path == 2) {
        switch (T) {
            case 1: return launch_global<F, 1>(L);
            case 2: return launch_global<F, 2>(L);
            case 3: return launch_global<F, 3>(L);
            case 4: return launch_global<F, 4>(L);
            case 5: return launch_global<F, 5>(L);
            case 6: return launch_global<F, 6>(L);
            default: return cudaErrorInvalidValue;
        }
    }
    switch (T * 16 + L.d) {
        case 17: return launch_reg<F, 1, 1>(L);
        case 18: return launch_reg<F, 2, 1>(L);
        case 19: return launch_reg<F, 3, 1>(L);
        case 20: return launch_reg<F, 4, 1>(L);
        case 21: return launch_reg<F, 5, 1>(L);
        case 22: return launch_reg<F, 6, 1>(L);
        case 23: return launch_reg<F, 7, 1>(L);
        case 24: return launch_reg<F, 8, 1>(L);
        case 33: return launch_reg<F, 1, 2>(L);
        case 34: return launch_reg<F, 2, 2>(L);
        case 35: return launch_reg<F, 3, 2>(L);
        case 36: return launch_reg<F, 4, 2>(L);
        case 49: return launch_reg<F, 1, 3>(L);
        case 50: return launch_reg<F, 2, 3>(L);
        case 65: return launch_reg<F, 1, 4>(L);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// path 0: the register path, 1: the block path, 2: the global path (ws:
// ws_slots × 2M elements); threads per block and dynamic shared bytes as
// launch_plan computes them
extern "C" int graphdyn_bdcm_contract(
    const void* chi_in, const void* a, const void* chi_old, void* out,
    long long G, long long Ed, int d, int T, int is_double, int per_group_a,
    double damp, double eps, int path, int threads, int smem, void* ws,
    long long ws_slots, void* stream)
{
    if (!chi_in || !a || !chi_old || !out || G < 1 || G > 65535 || Ed < 1
        || T < 1 || T > kMaxT || d < 1 || threads < 32 || threads > kThreads
        || threads % 32 != 0 || smem < 0 || smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
    const int K = 1 << T;
    const long long esize = is_double ? 8 : 4;
    long long M = 1;
    for (int t = 0; t < T && M <= INT_MAX; ++t) M *= d + 1;
    if (M > INT_MAX) return (int)cudaErrorInvalidValue;
    // the shared bytes each path indexes
    const long long need = path == 0 ? K * K * M * esize
                         : path == 1 ? block_smem_elems(M, K, threads) * esize
                         : edge_smem_elems(K, threads) * esize;
    if (path < 0 || path > 2
        || (path == 0 && (M > kRegMaxM || d > kRegMaxD || T > kRegMaxT))
        || (path == 2 && (!ws || ws_slots < 1)) || need > smem)
        return (int)cudaErrorInvalidValue;
    Launch L;
    L.threads = threads;
    L.smem = smem;
    L.M = (int)M;
    long long blocks = path == 0 ? (Ed * K + threads - 1) / threads
                     : path == 1 ? (Ed < INT_MAX ? Ed : INT_MAX)
                     : (G * Ed < ws_slots ? G * Ed : ws_slots);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    L.chi_in = chi_in;
    L.a = a;
    L.chi_old = chi_old;
    L.out = out;
    L.G = G;
    L.Ed = Ed;
    L.a_stride = per_group_a ? (long long)K * K * M : 0;
    L.d = d;
    L.ws = ws;
    L.damp = damp;
    L.eps = eps;
    L.grid = path == 2 ? dim3((unsigned)blocks)
                       : dim3((unsigned)blocks, (unsigned)G);
    L.stream = static_cast<cudaStream_t>(stream);
    const cudaError_t rc = is_double ? dispatch<double>(L, path, T)
                                     : dispatch<float>(L, path, T);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}
