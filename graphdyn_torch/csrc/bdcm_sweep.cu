// One Gauss-Seidel BDCM sweep of G instances in one cooperative launch: every
// edge-degree class in order, the gathers of the class inputs, the bias or
// the validity mask, the DP and contraction, and the write of the updated
// rows, with a grid barrier between two classes.
//
// Replaces, on the main paths, the class loop around the Pallas TPU kernel
//   K3  graphdyn/ops/pallas_bdcm.py:200  dp_contract_grouped
// that the JAX package's sweep runs (graphdyn/ops/bdcm.py:330-372: XLA
// gathers, the kernel, a scatter, per class), and computes what
// graphdyn_torch/ops/bdcm.py:_sweep_core computes on the CPU, up to the
// order of the sums inside the DP (the per-edge bodies are those of
// bdcm_contract.cu, shared through bdcm_dp.cuh).
//
// Semantics. Jacobi inside a class, Gauss-Seidel across classes: class c
// reads the rows that classes < c updated in this sweep and the pre-sweep
// rows of every other. The kernel reads by class id (cid: one int16 per row,
// 32767 for a row in no class): a row with cid < c is read from the output,
// where an earlier phase wrote it; any other from the input, which nothing
// writes. Each class writes its members' rows straight into the output, and
// the rows in no class (leaf edges, ghost rows, pad rows) are copied through
// once, so there is no scratch buffer and no scatter. A member whose output
// row's cid is not c is a padding member (it points at a ghost row): it
// computes nothing and writes nothing. Rows read from the output use L2-only
// loads (ld.global.cg), since they were written by other blocks earlier in
// the same launch; rows and tables of the input use the read-only path.
//
// What bounds it on an H100. The work a sweep needs: chi read once and
// written once, the int32 tables and the class ids, the bias or mask, the
// factors, and the DP's FMAs. At HPr config 2 (union of 256 copies of a d=3
// RRG, n=1e5: 7.68e7 rows of 64 bytes, one class, d=2, T=2) that is about
// 11 GB, 3.3 ms at 3.35 TB/s; the in-edges' rows are random 64-byte reads,
// two per edge. At config 4 (64 ER(1000, 1.5) instances, 8 classes) a sweep
// moves ~10 MB: latency, the launch and the 7 grid barriers set the pace.
// At T = 5 (HPr with p=4, c=1 on RRG d=4, n=1e4: one class, D=3, K=32,
// M=1024) an edge needs D·K·M·K ≈ 3.1e6 DP FMAs and K·K·M ≈ 1.0e6 for the
// contraction, ~1.7e11 FMAs per sweep over 4e4 rows: operations bound it
// (~5 ms at 67 TFLOP/s f32, ~10 ms at 34 TFLOP/s f64), not the 0.3 GB of
// chi.
//
// Design.
// - One launch per sweep, a grid sized by occupancy (cooperative launch),
//   the phases in class order separated by cg::this_grid().sync().
// - Register path (M ≤ 32, d ≤ 8; templated on (D, T)): blocks walk tiles
//   of blockDim/K edges of one group. The block first gathers the tile's
//   d·K·K inputs from chi through in_edges with 16-byte vector loads (a
//   K×K row is 16 B at T=1 f32, 64 B at T=2 f32, 128 B at T=2 f64), weighs
//   each value by its bias and mask in registers and stages it in shared
//   memory (one edge's inputs padded so the K lanes of the 32/K edges of a
//   warp read distinct banks); then each thread runs reg_edge for its
//   (edge, x_i). The factor is staged once per phase (shared) or whenever
//   the tile's group changes (per group).
// - Block path (larger lattices): one edge per block, grid-strided, the
//   inputs read straight from chi through in_edges into lattice_edge, the
//   two lattice rows in shared memory.
// - Global path (lattices whose two rows exceed a block's shared memory:
//   T = 4 from d = 13 in f32 and d = 10 in f64, T = 5 from d = 7 / 6, T = 6
//   from d = 5 in f32 and d = 4 in f64): the same lattice_edge with the two
//   rows in a device workspace of ws_slots × 2M elements that the caller
//   allocates; the first min(ws_slots, gridDim.x) blocks walk the class's
//   edges, block b in slot b, the others wait at the next barrier. The K·K
//   outputs and the partial sums stay in shared memory. A class gives the
//   same bits on either path.
// - Horizons T = 1..6 are instantiated (K ≤ 64), the register path only up
//   to T = 4 (an edge's K lanes within one warp). Each horizon has one
//   instantiation per set of paths a sweep may need (register; register
//   and block; all three; at T = 5, 6 block; block and global), and a
//   sweep runs the smallest that holds its classes: a kernel's registers
//   are those of its widest phase, so the register path would otherwise
//   run at the block or global phase's register count (128 against 100 at
//   T = 2 in f64, ptxas). An uninstantiated T is refused at the C entry.
// - Bias. Per-row weights bias[r, k] (bias_src null, stride K, col(k) = k)
//   or the node form: biases[src[r], col(k)] with col(k) = 0 where the
//   source trajectory starts at +1 (stride 2), so no per-edge bias tensor
//   exists; the caller packs col(k) of the node form into bit k of
//   bias_cols.
//   The product (chi · bias) · valid[k] is taken before the DP in the order
//   and type of the plain version.
// - Each edge's order of operations depends neither on G nor on the grid,
//   so grouped and serial sweeps agree bit for bit.
//
// C interface (bound with ctypes): graphdyn_bdcm_sweep takes the per-class
// descriptors (tables, factor, sizes, path) twice, on the host for its
// checks and in device memory for the kernel, so the class count is bounded
// only by the int16 class id; and the block size and the dynamic shared
// bytes from the caller's plan (graphdyn_torch/ops/bdcm_sweep.py), and the
// global path's lattice workspace, which the caller allocates (the kernel
// allocates nothing). It checks them against the kernel's bounds and
// returns the cudaError_t of the launch, 0 on success,
// cudaErrorInvalidValue for a plan outside them or a T with no
// instantiation. It launches on the given stream and does not synchronise.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bdcm_dp.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bdcm;

// class ids are int16; kNoClass marks a row in no class
constexpr int kNoClass = 32767;
constexpr int kMaxClasses = kNoClass;

// one class's descriptor: seven 64-bit words, as the wrapper packs them
struct ClassDesc {
    const int32_t* idx;       // [G·Ed] output rows, ids into the [G·rows] rows
    const int32_t* in_edges;  // [G·Ed, d] incoming rows
    const void* a;            // tilted factor [K, K, M] or [G, K, K, M]
    long long Ed;             // members per group
    long long a_stride;       // elements from one group's factor to the next
    long long d;
    long long path;           // 0: register, 1: block, 2: global
};
static_assert(sizeof(ClassDesc) == 7 * sizeof(long long), "descriptor words");

struct Params {
    const void* chi_in;
    void* chi_out;
    const int16_t* cid;            // [G·rows]
    const int32_t* pass_rows;      // [n_pass] rows in no class
    long long n_pass;
    const void* bias;              // null: no bias
    const int32_t* bias_src;       // null: one bias row per chi row
    long long bias_stride;
    unsigned long long bias_cols;  // bit k: the node-bias column of x_k
    int masked;                    // multiply by valid[k]
    unsigned long long valid_bits; // bit k: valid[k]
    long long G;
    int n_classes;
    double damp, eps;
    const ClassDesc* cls;          // [n_classes], device memory
    void* ws;                      // global path: [ws_slots, 2M] lattice rows
    long long ws_slots;
};

template <typename F> struct Vec16;
template <> struct Vec16<float> { using T = float4; };
template <> struct Vec16<double> { using T = double2; };

// 16 bytes of chi at p into v: the output through L2 only (written by
// earlier phases of this launch), the input through the read-only path
template <typename F>
__device__ __forceinline__ void load16(const F* p, bool from_out,
                                       F (&v)[16 / sizeof(F)])
{
    using V = typename Vec16<F>::T;
    const V* q = reinterpret_cast<const V*>(p);
    const V t = from_out ? __ldcg(q) : __ldg(q);
    if constexpr (sizeof(F) == 4) {
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
        v[0] = t.x; v[1] = t.y;
    }
}

template <typename F>
__device__ __forceinline__ F load1(const F* p, bool from_out)
{
    return from_out ? __ldcg(p) : __ldg(p);
}

// chi[r, k, ·] as the DP consumes it: times the bias of the source, then
// times valid[k] (the plain version's two multiplies, in its order)
template <typename F>
__device__ __forceinline__ F weigh(const Params& p, F x, long long r, int k)
{
    if (p.bias) {
        const long long br = p.bias_src ? (long long)__ldg(p.bias_src + r) : r;
        const int col = p.bias_src ? (int)((p.bias_cols >> k) & 1u) : k;
        x = x * __ldg(static_cast<const F*>(p.bias) + br * p.bias_stride + col);
    }
    if (p.masked) x = x * F((p.valid_bits >> k) & 1u);
    return x;
}

// edge stride of the register path's staging, in elements: the edge's
// D·K·K inputs padded to ≡ K (mod 32), so the 32/K edges of a warp start
// K banks apart
__host__ __device__ constexpr int stage_stride(int D, int K)
{
    return D * K * K + ((K - (D * K * K) % 32) % 32 + 32) % 32;
}

template <typename F, int D, int T>
__device__ void reg_phase(const Params& p, const ClassDesc& cd, int c, F* smem)
{
    constexpr int K = 1 << T;
    constexpr int KK = K * K;
    constexpr int M = ipow(D + 1, T);
    constexpr int V = 16 / sizeof(F);          // values per 16-byte chunk
    constexpr int RC = KK / V;                 // chunks per K×K row
    constexpr int ES = stage_stride(D, K);
    const int Et = blockDim.x / K;             // edges per tile
    F* stage = smem;                           // [Et, ES]
    F* a_s = smem + Et * ES;                   // [K, K, M]
    const F* in = static_cast<const F*>(p.chi_in);
    F* out = static_cast<F*>(p.chi_out);
    const long long Ed = cd.Ed;
    const long long tpg = (Ed + Et - 1) / Et;  // tiles per group
    const long long tiles = p.G * tpg;
    const F damp = (F)p.damp, omd = (F)(1.0 - p.damp), eps = (F)p.eps;
    long long staged = -1;

    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long g = tile / tpg;
        const long long e0 = (tile - g * tpg) * Et;
        const long long ag = cd.a_stride ? g : 0;
        if (ag != staged) {
            __syncthreads();
            const F* a_g = static_cast<const F*>(cd.a) + ag * cd.a_stride;
            for (int i = threadIdx.x; i < KK * M; i += blockDim.x)
                a_s[i] = __ldg(a_g + i);
            staged = ag;
        }
        for (int q = threadIdx.x; q < Et * D * RC; q += blockDim.x) {
            const int el = q / (D * RC);
            const int rem = q - el * (D * RC);
            const int s = rem / RC, ch = rem - s * RC;
            const long long e = e0 + el;
            F v[V];
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = F(0);
            if (e < Ed) {
                // the member's row and its in-edge are independent loads,
                // then the class ids and the chi row; no row has a class
                // before the first, so phase 0 reads the input unchecked.
                // A padding member's in-edges are ghost rows, which exist:
                // its row is loaded and dropped.
                const long long m = g * Ed + e;
                const long long row = __ldg(cd.idx + m);
                const long long r = __ldg(cd.in_edges + m * D + s);
                const bool upd = c > 0 && __ldg(p.cid + r) < c;
                const bool live = __ldg(p.cid + row) == c;
                load16<F>((upd ? out : in) + r * KK + ch * V, upd, v);
#pragma unroll
                for (int j = 0; j < V; ++j)
                    v[j] = live ? weigh<F>(p, v[j], r, (ch * V + j) / K)
                                : F(0);
            }
            F* dst = stage + el * ES + s * KK + ch * V;
#pragma unroll
            for (int j = 0; j < V; ++j) dst[j] = v[j];
        }
        __syncthreads();
        const int el = threadIdx.x / K;
        const int xi = threadIdx.x - el * K;
        const long long e = e0 + el;
        bool live = false;
        long long row = 0;
        if (e < Ed) {
            row = __ldg(cd.idx + g * Ed + e);
            live = __ldg(p.cid + row) == c;
        }
        reg_edge<F, D, T>(stage + el * ES, a_s + xi * K * M, xi, live,
                          in + row * KK + xi * K, out + row * KK + xi * K,
                          damp, omd, eps);
        __syncthreads();
    }
}

template <typename F, int T>
__device__ void reg_dispatch(const Params& p, const ClassDesc& cd, int c,
                             F* smem)
{
    // the instantiations are exactly the classes with M ≤ 32, d ≤ 8 and
    // T ≤ 4, which the C entry checks
    if constexpr (T == 1) {
        switch (cd.d) {
            case 1: reg_phase<F, 1, 1>(p, cd, c, smem); break;
            case 2: reg_phase<F, 2, 1>(p, cd, c, smem); break;
            case 3: reg_phase<F, 3, 1>(p, cd, c, smem); break;
            case 4: reg_phase<F, 4, 1>(p, cd, c, smem); break;
            case 5: reg_phase<F, 5, 1>(p, cd, c, smem); break;
            case 6: reg_phase<F, 6, 1>(p, cd, c, smem); break;
            case 7: reg_phase<F, 7, 1>(p, cd, c, smem); break;
            default: reg_phase<F, 8, 1>(p, cd, c, smem); break;
        }
    } else if constexpr (T == 2) {
        switch (cd.d) {
            case 1: reg_phase<F, 1, 2>(p, cd, c, smem); break;
            case 2: reg_phase<F, 2, 2>(p, cd, c, smem); break;
            case 3: reg_phase<F, 3, 2>(p, cd, c, smem); break;
            default: reg_phase<F, 4, 2>(p, cd, c, smem); break;
        }
    } else if constexpr (T == 3) {
        if (cd.d == 1) reg_phase<F, 1, 3>(p, cd, c, smem);
        else reg_phase<F, 2, 3>(p, cd, c, smem);
    } else if constexpr (T == 4) {
        reg_phase<F, 1, 4>(p, cd, c, smem);
    }
}

// the block path (global = false: the lattice rows in shared memory, one
// edge per block over the whole grid) or the global path (the rows in slot
// b of the workspace, one edge per block over the first ws_slots blocks)
template <typename F, int T, bool global>
__device__ void lattice_phase(const Params& p, const ClassDesc& cd, int c,
                              F* smem)
{
    constexpr int K = 1 << T;
    constexpr int KK = K * K;
    const int d = (int)cd.d;
    int M = 1;
    for (int t = 0; t < T; ++t) M *= d + 1;
    const long long stride = global && p.ws_slots < gridDim.x
        ? p.ws_slots : (long long)gridDim.x;
    if (blockIdx.x >= stride) return;
    F* rows = global ? static_cast<F*>(p.ws) + (long long)blockIdx.x * 2 * M
                     : smem;
    F* edge_smem = global ? smem : smem + 2 * M;
    const F* in = static_cast<const F*>(p.chi_in);
    F* out = static_cast<F*>(p.chi_out);
    const F damp = (F)p.damp, omd = (F)(1.0 - p.damp), eps = (F)p.eps;
    const long long members = p.G * cd.Ed;
    for (long long m = blockIdx.x; m < members; m += stride) {
        const long long g = m / cd.Ed;
        const long long row = __ldg(cd.idx + m);
        if (__ldg(p.cid + row) != c) continue;     // padding: the whole block
        const int32_t* ie = cd.in_edges + m * d;
        auto w_of = [&](int s, int k, int xi) {
            const long long r = __ldg(ie + s);
            const bool upd = __ldg(p.cid + r) < c;
            const long long o = r * KK + k * K + xi;
            return weigh<F>(p, load1<F>((upd ? out : in) + o, upd), r, k);
        };
        lattice_edge<F, T, !global>(w_of,
                           static_cast<const F*>(cd.a) + g * cd.a_stride,
                           d, M, in + row * KK, out + row * KK, damp, omd, eps,
                           rows, edge_smem);
    }
}

// kPaths: the paths compiled in (bit 0 register, bit 1 block, bit 2
// global). A sweep runs the smallest instantiation that holds its classes'
// paths (variant), so a phase never shares its registers with a phase the
// sweep does not run.
template <typename F, int T, int kPaths>
__global__ void __launch_bounds__(kThreads)
bdcm_sweep_kernel(const __grid_constant__ Params p)
{
    constexpr int KK = (1 << T) * (1 << T);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    F* smem = reinterpret_cast<F*>(smem_raw);
    cg::grid_group grid = cg::this_grid();
    const F* in = static_cast<const F*>(p.chi_in);
    F* out = static_cast<F*>(p.chi_out);
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    for (long long i = tid; i < p.n_pass * KK; i += nthreads) {
        const long long r = __ldg(p.pass_rows + i / KK);
        out[r * KK + i % KK] = __ldg(in + r * KK + i % KK);
    }
    for (int c = 0; c < p.n_classes; ++c) {
        if (c > 0) grid.sync();
        const ClassDesc cd = p.cls[c];
        if constexpr ((kPaths & 1) != 0)
            if (cd.path == 0) reg_dispatch<F, T>(p, cd, c, smem);
        if constexpr ((kPaths & 2) != 0)
            if (cd.path == 1) lattice_phase<F, T, false>(p, cd, c, smem);
        if constexpr ((kPaths & 4) != 0)
            if (cd.path == 2) lattice_phase<F, T, true>(p, cd, c, smem);
    }
}

using KernelFn = void (*)(const Params);

// the instantiation of horizon T for a sweep whose classes take the paths
// in `need` (bit 0 register, bit 1 block, bit 2 global): up to T = 4 the
// register path alone, register and block, or all three; at T = 5, 6 (no
// register path) block, or block and global
template <typename F, int T>
KernelFn variant(int need)
{
    if constexpr (T <= kRegMaxT) {
        if ((need & ~1) == 0) return bdcm_sweep_kernel<F, T, 1>;
        if ((need & 4) == 0) return bdcm_sweep_kernel<F, T, 3>;
        return bdcm_sweep_kernel<F, T, 7>;
    } else {
        if ((need & 4) == 0) return bdcm_sweep_kernel<F, T, 2>;
        return bdcm_sweep_kernel<F, T, 6>;
    }
}

// null for a T that has no instantiation
template <typename F>
KernelFn kernel_for(int T, int need)
{
    switch (T) {
        case 1: return variant<F, 1>(need);
        case 2: return variant<F, 2>(need);
        case 3: return variant<F, 3>(need);
        case 4: return variant<F, 4>(need);
        case 5: return variant<F, 5>(need);
        case 6: return variant<F, 6>(need);
        default: return nullptr;
    }
}

// M = (d + 1)^T, or -1 past INT_MAX (no such class is admitted)
long long lattice_size(long long d, int T)
{
    long long M = 1;
    for (int t = 0; t < T; ++t) {
        M *= d + 1;
        if (M > INT_MAX) return -1;
    }
    return M;
}

// the shared elements a class needs at this block size
long long class_smem_elems(long long M, int d, int T, int path, int threads)
{
    const int K = 1 << T;
    if (path == 1) return block_smem_elems(M, K, threads);
    if (path == 2) return edge_smem_elems(K, threads);
    return (long long)(threads / K) * stage_stride(d, K) + (long long)K * K * M;
}

}  // namespace

// cls_host: n_classes × (idx, in_edges, a, Ed, a_stride, d, path), the
// ClassDesc words, read here for the checks and the grid; cls_dev: the same
// words in device memory, which the kernel reads. threads and smem are the
// plan's (graphdyn_torch/ops/bdcm_sweep.py:build_plan); ws: ws_slots × 2M
// elements of the widest global-path class (null when no class takes that
// path). The grid is the co-resident one, capped by the widest phase's
// work. T outside the instantiated 1..6 is refused.
extern "C" int graphdyn_bdcm_sweep(
    const void* chi_in, void* chi_out, const void* cid, const void* pass_rows,
    long long n_pass, const void* bias, const void* bias_src,
    long long bias_stride, unsigned long long bias_cols, int masked,
    unsigned long long valid_bits, long long G, int T, int is_double,
    int n_classes, const long long* cls_host, const void* cls_dev,
    double damp, double eps, int threads, int smem, void* ws,
    long long ws_slots, void* stream)
{
    if (!chi_in || !chi_out || !cid || (n_pass > 0 && !pass_rows) || n_pass < 0
        || G < 1 || T < 1 || T > kMaxT || n_classes < 0
        || n_classes > kMaxClasses || (n_classes > 0 && (!cls_host || !cls_dev))
        || threads < 32 || threads > kThreads || threads % 32 != 0 || smem < 0
        || smem > kSmemMax || (bias && bias_stride < 1) || ws_slots < 0)
        return (int)cudaErrorInvalidValue;
    int need = 0;                  // the classes' paths, one bit each
    for (int c = 0; c < n_classes; ++c) {
        const long long path =
            reinterpret_cast<const ClassDesc*>(cls_host)[c].path;
        if (path < 0 || path > 2) return (int)cudaErrorInvalidValue;
        need |= 1 << path;
    }
    const KernelFn fn = is_double ? kernel_for<double>(T, need)
                                  : kernel_for<float>(T, need);
    if (!fn) return (int)cudaErrorInvalidValue;
    const int K = 1 << T;
    const long long esize = is_double ? 8 : 4;
    Params p;
    p.chi_in = chi_in;
    p.chi_out = chi_out;
    p.cid = static_cast<const int16_t*>(cid);
    p.pass_rows = static_cast<const int32_t*>(pass_rows);
    p.n_pass = n_pass;
    p.bias = bias;
    p.bias_src = static_cast<const int32_t*>(bias_src);
    p.bias_stride = bias_stride;
    p.bias_cols = bias_cols;
    p.masked = masked;
    p.valid_bits = valid_bits;
    p.G = G;
    p.n_classes = n_classes;
    p.damp = damp;
    p.eps = eps;
    p.cls = static_cast<const ClassDesc*>(cls_dev);
    p.ws = ws;
    p.ws_slots = ws_slots;
    // no more blocks than the widest phase has work for
    long long want = (n_pass * K * K + threads - 1) / threads;
    for (int c = 0; c < n_classes; ++c) {
        const ClassDesc& cd =
            reinterpret_cast<const ClassDesc*>(cls_host)[c];
        const long long M = cd.d >= 1 ? lattice_size(cd.d, T) : -1;
        if (cd.Ed < 0 || M < 1 || cd.a_stride < 0
            || (cd.Ed > 0 && (!cd.idx || !cd.in_edges || !cd.a))
            || cd.path < 0 || cd.path > 2
            || class_smem_elems(M, (int)cd.d, T, (int)cd.path, threads) * esize
                   > smem)
            return (int)cudaErrorInvalidValue;
        if (cd.path == 0
            && (M > kRegMaxM || cd.d > kRegMaxD || T > kRegMaxT))
            return (int)cudaErrorInvalidValue;
        if (cd.path == 2 && (!ws || ws_slots < 1))
            return (int)cudaErrorInvalidValue;
        const long long members = G * cd.Ed;
        const long long items = cd.path == 0
            ? G * ((cd.Ed + threads / K - 1) / (threads / K))
            : cd.path == 1 ? members
            : (members < ws_slots ? members : ws_slots);
        if (items > want) want = items;
    }
    cudaError_t err;
    if (smem > kSmemDefault) {
        err = cudaFuncSetAttribute((const void*)fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
    }
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const long long cap = (long long)per_sm * sms;
    const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                      dim3(threads), args, (size_t)smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
