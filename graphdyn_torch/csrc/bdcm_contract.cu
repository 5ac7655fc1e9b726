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
// D·K·K inputs are contiguous. Two paths, chosen by the caller's launch plan
// (launch_plan in graphdyn_torch/ops/bdcm_cuda.py):
// - register path (M ≤ 32, D ≤ 8: every class of the HPr main paths). One
//   thread per (edge, x_i); an edge's K threads are adjacent lanes of one
//   warp (K ≤ 16 divides 32), so each load of chi_in[e, D, k, ·] is K
//   adjacent values. The thread keeps its lattice row LL[x_i, 0..M) and the
//   accumulator in registers, with (D, T) template constants, so every
//   shift-FMA has a constant register index; the factor rows are staged in
//   shared memory per block (the block's group slab in the per-group
//   variant). z is reduced over the edge's K lanes with warp shuffles, then
//   multiplied by its reciprocal, as the Pallas kernel does.
// - block path (every larger lattice up to what one block's shared memory
//   holds: all of T ≤ 4, D ≤ 8 and beyond). One block per (edge, group),
//   grid-strided over the edges. The block's threads own the lattice entries
//   m ≡ threadIdx.x (mod blockDim.x) of two rows in shared memory and run the
//   edge's K destination rows one after another: each DP step sums, per m,
//   the K shifted entries in trajectory order; the contraction is reduced
//   over the block, and the edge's clamped chi2 waits in shared memory for z.
// Grid: (⌈Ed·K / block⌉, G) or (min(Ed, 2^31−1), G). Each thread's order of
// operations does not depend on G or Ed. Templated on float and double: the
// reference solver runs in float64. No tensor cores: the contraction is a
// short dot product.
//
// C interface (bound with ctypes): graphdyn_bdcm_contract takes the launch
// plan (path, threads per block, dynamic shared bytes) from the caller,
// checks it against the kernel's bounds, and returns the cudaError_t of the
// launch, 0 on success, cudaErrorInvalidValue for a plan or shape outside
// them. It launches on the given stream and does not synchronise.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // at most, per block
constexpr int kRegMaxM = 32;           // the register path's lattices
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
    const F* ci = chi_in + row * (long long)(D * K * K);

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

    const F* arow = a_s + xi * K * M;
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
    finish<F, K>(v, zpart, live, chi_old + row * (K * K) + xi * K,
                 out + row * (K * K) + xi * K, damp, omd);
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
    F* ll = reinterpret_cast<F*>(smem_raw);   // [M] the row being built
    F* acc = ll + M;                          // [M] the next one
    F* chi2 = acc + M;                        // [K, K] the edge's clamped rows
    F* part = chi2 + K * K;                   // [warps, K] contraction partials
    const int warps = blockDim.x / 32;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const long long g = blockIdx.y;
    const F* a_g = a + g * a_group_stride;
    int offs[K];
#pragma unroll
    for (int k = 0; k < K; ++k) offs[k] = flat_offset(k, d, T);

    for (long long e = blockIdx.x; e < Ed; e += gridDim.x) {
        const long long row = g * Ed + e;
        const F* ci = chi_in + row * (long long)(d * K * K);
        for (int xi = 0; xi < K; ++xi) {
            for (int m = threadIdx.x; m < M; m += blockDim.x)
                ll[m] = m == 0 ? F(1) : F(0);
            __syncthreads();
            for (int s = 0; s < d; ++s) {
                F w[K];
#pragma unroll
                for (int k = 0; k < K; ++k) w[k] = __ldg(ci + (s * K + k) * K + xi);
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
            out[row * (K * K) + j] = damp * chi2[j] * inv + omd * chi_old[row * (K * K) + j];
        __syncthreads();
    }
}

struct Launch {
    const void* chi_in;
    const void* a;
    const void* chi_old;
    void* out;
    long long Ed;
    long long a_stride;
    int d, M;
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

template <typename F>
cudaError_t dispatch(const Launch& L, int path, int T)
{
    if (path == 1) {
        switch (T) {
            case 1: return launch_block<F, 1>(L);
            case 2: return launch_block<F, 2>(L);
            case 3: return launch_block<F, 3>(L);
            case 4: return launch_block<F, 4>(L);
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

// path 0: the register path, 1: the block path; threads per block and
// dynamic shared bytes as launch_plan computes them
extern "C" int graphdyn_bdcm_contract(
    const void* chi_in, const void* a, const void* chi_old, void* out,
    long long G, long long Ed, int d, int T, int is_double, int per_group_a,
    double damp, double eps, int path, int threads, int smem, void* stream)
{
    if (!chi_in || !a || !chi_old || !out || G < 1 || G > 65535 || Ed < 1
        || T < 1 || T > 4 || d < 1 || threads < 32 || threads > kThreads
        || threads % 32 != 0 || smem < 0 || smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
    const int K = 1 << T;
    const long long esize = is_double ? 8 : 4;
    long long M = 1;
    for (int t = 0; t < T && M <= kSmemMax; ++t) M *= d + 1;
    // the shared bytes each path indexes
    const long long need = path == 0 ? K * K * M * esize
                         : (2 * M + K * K + threads / 32 * K) * esize;
    if ((path != 0 && path != 1) || (path == 0 && (M > kRegMaxM || d > 8))
        || need > smem)
        return (int)cudaErrorInvalidValue;
    Launch L;
    L.threads = threads;
    L.smem = smem;
    L.M = (int)M;
    const long long blocks = path == 0 ? (Ed * K + threads - 1) / threads
                                       : (Ed < INT_MAX ? Ed : INT_MAX);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    L.chi_in = chi_in;
    L.a = a;
    L.chi_old = chi_old;
    L.out = out;
    L.Ed = Ed;
    L.a_stride = per_group_a ? (long long)K * K * M : 0;
    L.d = d;
    L.damp = damp;
    L.eps = eps;
    L.grid = dim3((unsigned)blocks, (unsigned)G);
    L.stream = static_cast<cudaStream_t>(stream);
    const cudaError_t rc = is_double ? dispatch<double>(L, path, T)
                                     : dispatch<float>(L, path, T);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}
