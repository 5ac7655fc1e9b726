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
// state[i, r/32]. The state is [n+1, W]; row n is the ghost row, always zero,
// so a ghost-padded neighbor slot (index n) contributes nothing. Every step
// writes 0 to row n: under tie=change the ghost (degree 0, so its count
// always ties) would otherwise flip to all-ones.
//
// What bounds it on an H100: HBM bytes. The floor is each input read once
// and the output written once:
//   8*W*(n+1)  (state in and out)  +  4*sum(deg)  (+ 4*n for deg, general path)
// A design with no reuse of gathered rows moves instead
//   4*W*(sum(deg) + n_own + n)  bytes  (+ the same tables)
// where the first term is the neighbor-row gathers, n_own = n on the general
// path (the node's own row supplies the tie bit) and 0 on the uniform-odd fast
// path, and the last term is the write; the gap between the two is what L2
// reuse of neighbor rows can win. The arithmetic is a few dozen 32-bit logic
// ops per word, far below the card's ALU rate.
//
// Design. One thread per (row, word); neighbouring threads take neighbouring
// words of the same row, so each gathered neighbor row is one coalesced read
// once W >= 32 (for W < 32 several rows share a block). A thread folds its d
// neighbor words into NP = bit_length(dmax) bit planes with the carry-save
// ripple, all in registers, compares the planes with deg/2 bitwise, and writes
// one word: no [n, d, W] intermediate exists anywhere. The loop runs to the
// node's true degree, so ER's ghost slots (dmax is about 3x the mean degree)
// cost nothing. The TPU kernels' per-row DMA ring has no counterpart: the
// gathers are ordinary loads, kept in flight by the warps the SM holds.
//
// C interface (bound with ctypes): graphdyn_packed_step returns the
// cudaError_t of the launch, 0 on success. It launches on the given stream
// and does not synchronise.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int NP, bool FAST, bool MINORITY, bool CHANGE>
__global__ void __launch_bounds__(kThreads)
packed_step_kernel(const int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ deg,
                   const uint32_t* __restrict__ src,
                   uint32_t* __restrict__ dst,
                   int64_t n, int dmax, int64_t W, int d_uniform,
                   unsigned tpr, unsigned rpb, unsigned wpb)
{
    // block = rpb rows x tpr words; wpb blocks cover one row's W words
    const unsigned r_local = threadIdx.x / tpr;
    const unsigned w_in = threadIdx.x - r_local * tpr;
    const unsigned rb = blockIdx.x / wpb;
    const unsigned wb = blockIdx.x - rb * wpb;
    const int64_t row = (int64_t)rb * rpb + r_local;
    const int64_t w = (int64_t)wb * tpr + w_in;
    if (row > n || w >= W) return;
    const size_t idx = (size_t)row * (size_t)W + (size_t)w;
    if (row == n) {              // the ghost row stays zero
        dst[idx] = 0u;
        return;
    }

    const int32_t* nb = nbr + (size_t)row * (size_t)dmax;
    const int d = FAST ? d_uniform : deg[row];

    uint32_t planes[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) planes[k] = 0u;
    for (int j = 0; j < d; ++j) {
        uint32_t carry = __ldg(src + (size_t)nb[j] * (size_t)W + (size_t)w);
#pragma unroll
        for (int k = 0; k < NP; ++k) {   // ripple one addend into the planes
            const uint32_t next = planes[k] & carry;
            planes[k] ^= carry;
            carry = next;
        }
    }

    // bitwise comparator of the per-replica count against thr = d/2
    const int thr = d >> 1;
    uint32_t gt = 0u, eq = 0xFFFFFFFFu;
#pragma unroll
    for (int k = NP - 1; k >= 0; --k) {
        const uint32_t tk = ((thr >> k) & 1) ? 0xFFFFFFFFu : 0u;
        gt |= eq & planes[k] & ~tk;
        eq &= ~(planes[k] ^ tk);
    }

    uint32_t out;
    if (FAST) {                  // odd degree: no ties, no own-row read
        out = MINORITY ? ~gt : gt;
    } else {                     // _rule_tie_combine of graphdyn/ops/packed.py
        const uint32_t own = src[idx];
        const uint32_t tie_mask = (d & 1) ? 0u : eq;
        const uint32_t tie_bit = CHANGE ? ~own : own;
        out = MINORITY ? (~(gt | tie_mask) | (tie_mask & tie_bit))
                       : (gt | (tie_mask & tie_bit));
    }
    dst[idx] = out;
}

struct Launch {
    const int32_t* nbr;
    const int32_t* deg;
    const uint32_t* src;
    uint32_t* dst;
    int64_t n;
    int dmax;
    int64_t W;
    int d_uniform;
    unsigned tpr, rpb, wpb;
    dim3 grid, block;
    cudaStream_t stream;
};

template <int NP, bool FAST, bool MINORITY, bool CHANGE>
void launch_one(const Launch& a)
{
    packed_step_kernel<NP, FAST, MINORITY, CHANGE>
        <<<a.grid, a.block, 0, a.stream>>>(
            a.nbr, a.deg, a.src, a.dst, a.n, a.dmax, a.W, a.d_uniform,
            a.tpr, a.rpb, a.wpb);
}

template <int NP>
void launch_planes(const Launch& a, int fast, int minority, int change)
{
    if (fast) {
        if (minority) launch_one<NP, true, true, false>(a);
        else          launch_one<NP, true, false, false>(a);
    } else if (minority) {
        if (change) launch_one<NP, false, true, true>(a);
        else        launch_one<NP, false, true, false>(a);
    } else {
        if (change) launch_one<NP, false, false, true>(a);
        else        launch_one<NP, false, false, false>(a);
    }
}

}  // namespace

extern "C" int graphdyn_packed_step(
    const void* nbr, const void* deg, const void* src, void* dst,
    long long n, int dmax, long long W, int n_planes, int fast,
    int d_uniform, int minority, int change, void* stream)
{
    if (n < 0 || W < 1 || dmax < 1 || n_planes < 1 || n_planes > 6)
        return (int)cudaErrorInvalidValue;
    Launch a;
    a.nbr = static_cast<const int32_t*>(nbr);
    a.deg = static_cast<const int32_t*>(deg);
    a.src = static_cast<const uint32_t*>(src);
    a.dst = static_cast<uint32_t*>(dst);
    a.n = n;
    a.dmax = dmax;
    a.W = W;
    a.d_uniform = d_uniform;
    a.tpr = (unsigned)(W < kThreads ? W : kThreads);
    a.rpb = kThreads / a.tpr;
    a.wpb = (unsigned)((W + a.tpr - 1) / a.tpr);
    const long long rows = n + 1;
    const long long row_blocks = (rows + a.rpb - 1) / a.rpb;
    const long long blocks = row_blocks * (long long)a.wpb;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    a.grid = dim3((unsigned)blocks);
    a.block = dim3(a.tpr * a.rpb);
    a.stream = static_cast<cudaStream_t>(stream);
    switch (n_planes) {
        case 1: launch_planes<1>(a, fast, minority, change); break;
        case 2: launch_planes<2>(a, fast, minority, change); break;
        case 3: launch_planes<3>(a, fast, minority, change); break;
        case 4: launch_planes<4>(a, fast, minority, change); break;
        case 5: launch_planes<5>(a, fast, minority, change); break;
        default: launch_planes<6>(a, fast, minority, change); break;
    }
    return (int)cudaGetLastError();
}
