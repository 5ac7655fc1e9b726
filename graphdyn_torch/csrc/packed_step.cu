// One synchronous packed majority/minority step on the ghost-extended state.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  graphdyn/ops/pallas_packed.py  pallas_packed_step  (uniform odd degree)
//   K2  graphdyn/ops/pallas_packed.py  _general_step_ext   (any degree, all
//       four (rule, tie) pairs, ghost slots, ghost-carried state)
// and stands in for the XLA per-slot program
// graphdyn/ops/packed.py:_packed_rollout_device, which computes the same words.
//
// Layout. 32 replicas per word: replica r of node i is bit r%32 of word
// state[i, r/32]. A launch updates rows [0, n) of dst from src and, when
// zero_tail is set, writes 0 to row n; it touches no other row. Two layouts
// use it:
// - the ghost-extended state [n+1, W] (zero_tail set): a ghost-padded
//   neighbor slot (index n) reads the zero row and adds nothing; under
//   tie=change the ghost (degree 0, its count always ties) would otherwise
//   flip to all-ones;
// - the halo shard layout of graphdyn/parallel/halo.py:17-30 (ported in
//   graphdyn_torch/parallel/halo.py): owned rows (interior, then boundary,
//   then inert pad rows), ghost rows, replicated hub rows, a trash row and
//   the zero row last. n is the shard's count of real owned rows and
//   zero_tail is clear: the two ping-pong buffers start as copies of one
//   state, pad and zero rows are never written (the pad rows' inertness is
//   the JAX package's where(real, out, sp[:nm]), halo.py:392), and the hub
//   update and the exchange refresh the hub and ghost rows (the trash row
//   takes the pad receive lanes) after each launch.
//
// What bounds it on an H100: HBM bytes. The floor is each input read once
// and the output written once:
//   4*W*(n + rows read as neighbours only)  +  4*W*n  (state in and out)
//   +  4*sum(deg)  (+ 4*n for deg, general path)
// The arithmetic is a few dozen 32-bit logic ops per word, far below the
// card's ALU rate.
//
// Design.
// - Node order. Thread t of the launch takes vector t % VPR of row t / VPR
//   (VPR = W / U vectors per row), so the threads of a warp read consecutive
//   pieces of each neighbour row they gather. A slab-major order (every row
//   for one slab of S words, then the next slab) was measured on an H100 at
//   the headline (n = 1e6, W = 512; PERF.md) and bought nothing:
//   S = 4 and 8 words read and write 16- and 32-byte pieces of random rows,
//   below HBM's access granularity, and ran 3-12x slower; S = 32..512 ran
//   within 4% of one another, S = 512 being this node order.
// - 16-byte vectors. Where W is a multiple of 4 and the rows are 16-byte
//   aligned a thread carries one uint4 (U = 4 consecutive words of one row);
//   else, and at W < 4, one word (U = 1). Two or four uint4s per thread
//   measured slower than one.
// - Loads ahead of the fold. The d neighbours are taken in batches of
//   kBatch: the batch's indices are loaded, then all its rows' vectors (the
//   slots past the degree predicated off), then folded into NP >=
//   bit_length(dmax) bit planes with the carry-save ripple, so a thread has
//   kBatch vector loads in flight rather than one. NP is bit_length(dmax)
//   up to 6 (dmax 63); past it the next of 8, 16 and 32 planes, so every
//   int32 degree runs (three instantiations keep the build short). A hub row is one thread's serial loop over its
//   degree: the padded layout on a power-law graph is as slow as its
//   layout makes it (the degree-bucketed kernel, bucketed_step.cu, splits
//   hub rows over warps).
// - The comparator against deg/2 and the rule/tie epilogue are those of
//   graphdyn/ops/packed.py (_compare_planes, _rule_tie_combine).
// The index map (row and words of each thread) is mirrored in Python by
// graphdyn_torch/ops/packed_cuda.py:launch_plan/index_map, which the CPU
// tests check covers every (row, word) of rows [0, n + zero_tail) exactly
// once.
//
// C interface (bound with ctypes): graphdyn_packed_step returns the
// cudaError_t of the launch, 0 on success. It launches on the given stream
// and does not synchronise.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // per block
constexpr int kBatch = 4;        // neighbour rows whose loads issue together

// U words per thread: 4 (one uint4) or 1
template <int U> struct Words {
    uint32_t w[U];
};

template <int U>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p,
                                           Words<U>& v)
{
    if constexpr (U == 4) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
        v.w[0] = t.x; v.w[1] = t.y; v.w[2] = t.z; v.w[3] = t.w;
    } else {
        v.w[0] = __ldg(p);
    }
}

template <int U>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p,
                                            const Words<U>& v)
{
    if constexpr (U == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2],
                                                  v.w[3]);
    } else {
        p[0] = v.w[0];
    }
}

template <int NP, bool FAST, bool MINORITY, bool CHANGE, int U>
__global__ void __launch_bounds__(kThreads)
packed_step_kernel(const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ deg,
                   const uint32_t* __restrict__ src,
                   uint32_t* __restrict__ dst,
                   int64_t n, int zero_tail, int dmax, int64_t W,
                   int d_uniform, int64_t vpr)
{
    // the index map of packed_cuda.py:index_map
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (t >= (n + zero_tail) * vpr) return;
    const int64_t row = t / vpr;
    const int64_t w0 = (t - row * vpr) * U;
    const size_t idx = (size_t)row * (size_t)W + (size_t)w0;
    Words<U> out;
    if (row == n) {              // the zero row stays zero
#pragma unroll
        for (int i = 0; i < U; ++i) out.w[i] = 0u;
        store_words<U>(dst + idx, out);
        return;
    }

    const int32_t* nb = nbr + (size_t)row * (size_t)dmax;
    const int d = FAST ? d_uniform : __ldg(deg + row);
    Words<U> own;
    if (!FAST) load_words<U>(src + idx, own);

    uint32_t planes[NP][U];
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int i = 0; i < U; ++i) planes[k][i] = 0u;
    for (int j0 = 0; j0 < d; j0 += kBatch) {
        int nj[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
            nj[q] = j0 + q < d ? __ldg(nb + j0 + q) : -1;
        Words<U> v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            if (nj[q] >= 0) {
                load_words<U>(src + (size_t)nj[q] * (size_t)W + (size_t)w0,
                              v[q]);
            } else {
#pragma unroll
                for (int i = 0; i < U; ++i) v[q].w[i] = 0u;
            }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
#pragma unroll
            for (int i = 0; i < U; ++i) {    // ripple one addend into the planes
                uint32_t carry = v[q].w[i];
#pragma unroll
                for (int k = 0; k < NP; ++k) {
                    const uint32_t next = planes[k][i] & carry;
                    planes[k][i] ^= carry;
                    carry = next;
                }
            }
        }
    }

    // bitwise comparator of the per-replica count against thr = d/2
    const int thr = d >> 1;
#pragma unroll
    for (int i = 0; i < U; ++i) {
        uint32_t gt = 0u, eq = 0xFFFFFFFFu;
#pragma unroll
        for (int k = NP - 1; k >= 0; --k) {
            const uint32_t tk = ((thr >> k) & 1) ? 0xFFFFFFFFu : 0u;
            gt |= eq & planes[k][i] & ~tk;
            eq &= ~(planes[k][i] ^ tk);
        }
        if (FAST) {              // odd degree: no ties, no own-row read
            out.w[i] = MINORITY ? ~gt : gt;
        } else {                 // _rule_tie_combine of graphdyn/ops/packed.py
            const uint32_t tie_mask = (d & 1) ? 0u : eq;
            const uint32_t tie_bit = CHANGE ? ~own.w[i] : own.w[i];
            out.w[i] = MINORITY ? (~(gt | tie_mask) | (tie_mask & tie_bit))
                                : (gt | (tie_mask & tie_bit));
        }
    }
    store_words<U>(dst + idx, out);
}

struct Launch {
    const int32_t* nbr;
    const int32_t* deg;
    const uint32_t* src;
    uint32_t* dst;
    int64_t n;
    int zero_tail;
    int dmax;
    int64_t W;
    int d_uniform;
    int64_t vpr;
    dim3 grid;
    cudaStream_t stream;
};

template <int NP, bool FAST, bool MINORITY, bool CHANGE>
void launch_width(const Launch& a, int U)
{
    if (U == 4)
        packed_step_kernel<NP, FAST, MINORITY, CHANGE, 4>
            <<<a.grid, kThreads, 0, a.stream>>>(
                a.nbr, a.deg, a.src, a.dst, a.n, a.zero_tail, a.dmax, a.W,
                a.d_uniform, a.vpr);
    else
        packed_step_kernel<NP, FAST, MINORITY, CHANGE, 1>
            <<<a.grid, kThreads, 0, a.stream>>>(
                a.nbr, a.deg, a.src, a.dst, a.n, a.zero_tail, a.dmax, a.W,
                a.d_uniform, a.vpr);
}

template <int NP>
void launch_planes(const Launch& a, int fast, int minority, int change, int U)
{
    if (fast) {
        if (minority) launch_width<NP, true, true, false>(a, U);
        else launch_width<NP, true, false, false>(a, U);
    } else if (minority) {
        if (change) launch_width<NP, false, true, true>(a, U);
        else launch_width<NP, false, true, false>(a, U);
    } else {
        if (change) launch_width<NP, false, false, true>(a, U);
        else launch_width<NP, false, false, false>(a, U);
    }
}

}  // namespace

// U: words per thread, 4 (a uint4; needs W % 4 == 0 and 16-byte aligned
// states) or 1. The caller's plan (packed_cuda.py:launch_plan) chooses it;
// the grid follows from it here as it does there. Rows [0, n) are updated
// from nbr/deg (which hold at least n rows); with zero_tail, row n is
// written 0. A launch with no row to write launches nothing.
extern "C" int graphdyn_packed_step(
    const void* nbr, const void* deg, const void* src, void* dst,
    long long n, int zero_tail, int dmax, long long W, int n_planes,
    int fast, int d_uniform, int minority, int change, int U, void* stream)
{
    if (n < 0 || (zero_tail != 0 && zero_tail != 1) || W < 1 || dmax < 1
        || n_planes < 1 || n_planes > 32 || (U != 1 && U != 4)
        || (U == 4 && (W % 4 != 0 || (uintptr_t)src % 16 != 0
                       || (uintptr_t)dst % 16 != 0)))
        return (int)cudaErrorInvalidValue;
    Launch a;
    a.nbr = static_cast<const int32_t*>(nbr);
    a.deg = static_cast<const int32_t*>(deg);
    a.src = static_cast<const uint32_t*>(src);
    a.dst = static_cast<uint32_t*>(dst);
    a.n = n;
    a.zero_tail = zero_tail;
    a.dmax = dmax;
    a.W = W;
    a.d_uniform = d_uniform;
    a.vpr = W / U;
    const long long blocks = ((n + zero_tail) * a.vpr + kThreads - 1)
                             / kThreads;
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    a.grid = dim3((unsigned)blocks);
    a.stream = static_cast<cudaStream_t>(stream);
    switch (n_planes) {
        case 1: launch_planes<1>(a, fast, minority, change, U); break;
        case 2: launch_planes<2>(a, fast, minority, change, U); break;
        case 3: launch_planes<3>(a, fast, minority, change, U); break;
        case 4: launch_planes<4>(a, fast, minority, change, U); break;
        case 5: launch_planes<5>(a, fast, minority, change, U); break;
        case 6: launch_planes<6>(a, fast, minority, change, U); break;
        default:
            // past dmax 63 the count takes the next instantiation up: the
            // extra planes stay zero and the threshold's bits there are
            // zero, so no comparison changes
            if (n_planes <= 8) launch_planes<8>(a, fast, minority, change, U);
            else if (n_planes <= 16)
                launch_planes<16>(a, fast, minority, change, U);
            else launch_planes<32>(a, fast, minority, change, U);
            break;
    }
    return (int)cudaGetLastError();
}
