// KB: one synchronous packed majority/minority step over every degree
// bucket of a power-law graph (or over one streamed chunk), in one launch.
//
// Replaces the JAX package's XLA programs (no Pallas kernel stands behind
// them):
//   graphdyn/ops/bucketed.py  _bucketed_rollout_device  (one step's body)
//   graphdyn/ops/streamed.py  _stream_chunk_device      (one chunk's step)
// and computes the same words.
//
// Layout. 32 replicas per word (replica r of node i is bit r%32 of word
// src[i, r/32]). The launch walks a table of up to kMaxSeg segments, each a
// block of rows with one neighbour table:
//   block0   first block of the segment in the grid
//   rows     rows of the segment
//   out_row0 the segment's first output row (and first own row, unless a
//            self table is given)
//   width    row stride of its neighbour table (its padded width)
//   cpr      0 for a narrow segment (width <= 32); else the slot chunks per
//            row of a wide (hub) segment, ceil(width / chunk)
//   ws_row0  the segment's first row in the count workspace (wide segments
//            whose rows can span several chunks), else -1
//   nbr, deg, self   int32 tables (self = 0 when the own row is out_row0+r)
// Segments start on block boundaries, so a block belongs to one segment.
// The Python side builds the table (graphdyn_torch/ops/bucketed_cuda.py:
// launch_table, wide_geometry) and enumerates its index map for the CPU
// tests (index_map). Every row reads only src and writes only dst (src and
// dst are distinct buffers), so the step is synchronous. ghost_row >= 0
// names a row of dst that is written zero (the bucketed state's ghost row).
//
// What bounds it on an H100: HBM bytes, then 32-bit logic. The floor is each
// input read once and the output written once: the state in and out (8·W
// per row), the neighbour indices each row reads (4·deg), degrees (4 per
// row); the neighbour rows are gathers of the state, which stays in the
// 50 MB L2 at the bench shape (n = 10^5, W = 32: 12.8 MB). Each gathered
// word costs 2 logic ops per bit plane.
//
// Design.
// - Narrow segments: one thread per (row, U-word vector), as K1/K2' in
//   packed_step.cu: the row's neighbours in batches of kBatch loads, then
//   folded into bit_length(width) carry-save bit planes (one instantiation
//   per width 1..32), the comparator against deg/2 and the rule/tie
//   epilogue.
// - Wide segments (the hubs): a row's slots are cut into chunks of
//   kSlotsPerLane * slanes slots, one warp per (row, vector group, chunk).
//   The warp's lanes are vlanes vector lanes (consecutive U-word vectors of
//   the row, so a slot's row is read as one coalesced piece) times slanes
//   slot lanes; each lane folds its kSlotsPerLane slots into seven planes,
//   and the slot lanes' plane numbers are added bit-sliced with
//   __shfl_xor_sync (log2(slanes) rounds of a ripple adder). A row that
//   fits one chunk (256 slots at W = 32) is decided there. A longer row
//   (the hub of 19,617 slots is 77 chunks at W = 32) adds its chunks'
//   integer counts into a count workspace with atomics; the chunk that
//   takes the row's last ticket reads the counts back from L2 (and zeroes
//   them, and the ticket, so the workspace is ready for the next step),
//   compares 2·count with the degree and writes the words. Integer
//   addition is exact and order-free, so the words equal the JAX
//   package's whatever order the chunks finish in. Measured on an H100
//   (PERF.md, the KB rows): the count atomics (W·32 per chunk) set the wide
//   segments' time, not the chunks' chains of loads: 16-slot chunks of
//   single words ran the wide segments 4x slower than 128-slot chunks of
//   uint4s, and 256-slot chunks 28% faster again.
// - Grid order: the launch table puts the wide segments first (widest
//   first), so the hubs' chunks start with the launch and the narrow blocks
//   fill the card behind them.
//
// C interface (bound with ctypes): graphdyn_bucketed_step returns the
// cudaError_t of the launch, 0 on success. It launches on the given stream
// and does not synchronise.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // per block
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;         // loads issued together
constexpr int kMaxSeg = 32;       // widths 2^0 .. 2^31
constexpr int kSlotsPerLane = 64; // a wide lane's slots per chunk
constexpr int kLanePlanes = 7;    // a lane's count, up to 64
constexpr int kChunkPlanes = kLanePlanes + 5;  // a chunk's count, up to 2048
constexpr int kCols = 10;         // int64 columns of a segment descriptor

struct Seg {
    long long block0, rows, out_row0, width, cpr, ws_row0, nbr, deg, self;
};

struct Table {
    Seg seg[kMaxSeg];
    int n_seg;
};

// the wide path's lane geometry: vlanes vector lanes (a power of two) times
// slanes = 32 / vlanes slot lanes; G vector groups per row; chunk slots
struct Geo {
    int vlanes, vshift, G, chunk;
};

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

// ripple one 1-bit addend into NP carry-save planes (top carry dropped)
template <int NP>
__device__ __forceinline__ void csa_add(uint32_t (&planes)[NP], uint32_t carry)
{
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        const uint32_t next = planes[k] & carry;
        planes[k] ^= carry;
        carry = next;
    }
}

// _rule_tie_combine of graphdyn/ops/packed.py
template <bool MINORITY, bool CHANGE>
__device__ __forceinline__ uint32_t combine(uint32_t gt, uint32_t tie_mask,
                                            uint32_t own)
{
    const uint32_t tie_bit = CHANGE ? ~own : own;
    return MINORITY ? (~(gt | tie_mask) | (tie_mask & tie_bit))
                    : (gt | (tie_mask & tie_bit));
}

// the comparator of graphdyn/ops/packed.py:_compare_planes against thr =
// d/2, then the epilogue
template <int NP, bool MINORITY, bool CHANGE>
__device__ __forceinline__ uint32_t decide(const uint32_t (&planes)[NP],
                                           int d, uint32_t own)
{
    const int thr = d >> 1;
    uint32_t gt = 0u, eq = 0xFFFFFFFFu;
#pragma unroll
    for (int k = NP - 1; k >= 0; --k) {
        const uint32_t tk = ((thr >> k) & 1) ? 0xFFFFFFFFu : 0u;
        gt |= eq & planes[k] & ~tk;
        eq &= ~(planes[k] ^ tk);
    }
    return combine<MINORITY, CHANGE>(gt, (d & 1) ? 0u : eq, own);
}

__device__ __forceinline__ long long own_row(const Seg& s, long long r)
{
    return s.self
        ? (long long)__ldg(reinterpret_cast<const int32_t*>(s.self) + r)
        : s.out_row0 + r;
}

template <int NP, bool MINORITY, bool CHANGE, int U>
__device__ void narrow_rows(const Seg& s, long long local,
                            const uint32_t* __restrict__ src,
                            uint32_t* __restrict__ dst, long long W,
                            long long vpr)
{
    if (local >= s.rows * vpr) return;
    const long long r = local / vpr;
    const long long w0 = (local - r * vpr) * U;
    const int32_t* nb = reinterpret_cast<const int32_t*>(s.nbr) + r * s.width;
    const int d = __ldg(reinterpret_cast<const int32_t*>(s.deg) + r);
    Words<U> own;
    load_words<U>(src + own_row(s, r) * W + w0, own);

    uint32_t planes[U][NP];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
        for (int k = 0; k < NP; ++k) planes[i][k] = 0u;
    for (int j0 = 0; j0 < d; j0 += kBatch) {
        int nj[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
            nj[q] = j0 + q < d ? __ldg(nb + j0 + q) : -1;
        Words<U> v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            if (nj[q] >= 0) {
                load_words<U>(src + (long long)nj[q] * W + w0, v[q]);
            } else {
#pragma unroll
                for (int i = 0; i < U; ++i) v[q].w[i] = 0u;
            }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
            for (int i = 0; i < U; ++i) csa_add<NP>(planes[i], v[q].w[i]);
    }
    Words<U> out;
#pragma unroll
    for (int i = 0; i < U; ++i)
        out.w[i] = decide<NP, MINORITY, CHANGE>(planes[i], d, own.w[i]);
    store_words<U>(dst + (s.out_row0 + r) * W + w0, out);
}

template <bool MINORITY, bool CHANGE, int U>
__device__ void narrow_dispatch(const Seg& s, long long local,
                                const uint32_t* __restrict__ src,
                                uint32_t* __restrict__ dst, long long W,
                                long long vpr)
{
    // bit_length(width): the planes a count of up to width needs
    switch (s.width) {
        case 1: narrow_rows<1, MINORITY, CHANGE, U>(s, local, src, dst, W,
                                                    vpr); break;
        case 2: narrow_rows<2, MINORITY, CHANGE, U>(s, local, src, dst, W,
                                                    vpr); break;
        case 4: narrow_rows<3, MINORITY, CHANGE, U>(s, local, src, dst, W,
                                                    vpr); break;
        case 8: narrow_rows<4, MINORITY, CHANGE, U>(s, local, src, dst, W,
                                                    vpr); break;
        case 16: narrow_rows<5, MINORITY, CHANGE, U>(s, local, src, dst, W,
                                                     vpr); break;
        default: narrow_rows<6, MINORITY, CHANGE, U>(s, local, src, dst, W,
                                                     vpr); break;
    }
}

template <bool MINORITY, bool CHANGE, int U>
__device__ void wide_rows(const Seg& s, long long block_in_seg,
                          const uint32_t* __restrict__ src,
                          uint32_t* __restrict__ dst, long long W,
                          long long vpr, const Geo& geo,
                          int* __restrict__ counts, int* __restrict__ tickets)
{
    const int lane = threadIdx.x & 31;
    const long long item = block_in_seg * kWarps + (threadIdx.x >> 5);
    const int cpr = (int)s.cpr;
    const long long per_row = (long long)geo.G * cpr;
    if (item >= s.rows * per_row) return;               // the whole warp
    const long long r = item / per_row;
    const int rest = (int)(item - r * per_row);
    const int g = rest / cpr;
    const int c = rest - g * cpr;
    const int32_t* nb = reinterpret_cast<const int32_t*>(s.nbr) + r * s.width;
    const int d = __ldg(reinterpret_cast<const int32_t*>(s.deg) + r);
    // a degree-0 row (a streamed chunk's rows share its width) is one
    // empty chunk, decided like any other
    const int n_chunks = d > 0 ? (d + geo.chunk - 1) / geo.chunk : 1;
    if (c >= n_chunks) return;                          // the whole warp
    const int slanes = 32 >> geo.vshift;
    const int vl = lane & (geo.vlanes - 1);
    const int sl = lane >> geo.vshift;
    const long long vec = (long long)g * geo.vlanes + vl;
    const bool vlive = vec < vpr;
    const long long w0 = (vlive ? vec : 0) * U;

    uint32_t part[U][kLanePlanes];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
        for (int k = 0; k < kLanePlanes; ++k) part[i][k] = 0u;
    const int j_first = c * geo.chunk + sl;
    for (int t0 = 0; t0 < kSlotsPerLane; t0 += kBatch) {
        int nj[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int j = j_first + (t0 + q) * slanes;
            nj[q] = (vlive && j < d) ? __ldg(nb + j) : -1;
        }
        Words<U> v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            if (nj[q] >= 0) {
                load_words<U>(src + (long long)nj[q] * W + w0, v[q]);
            } else {
#pragma unroll
                for (int i = 0; i < U; ++i) v[q].w[i] = 0u;
            }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
            for (int i = 0; i < U; ++i) csa_add<kLanePlanes>(part[i],
                                                             v[q].w[i]);
    }
    // the chunk's count: the slot lanes' plane numbers added bit-sliced,
    // log2(slanes) butterfly rounds of a ripple adder
    uint32_t sum[U][kChunkPlanes];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
        for (int k = 0; k < kChunkPlanes; ++k)
            sum[i][k] = k < kLanePlanes ? part[i][k < kLanePlanes ? k : 0]
                                        : 0u;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
        if (off < geo.vlanes) break;                    // uniform
#pragma unroll
        for (int i = 0; i < U; ++i) {
            uint32_t cy = 0u;
#pragma unroll
            for (int k = 0; k < kChunkPlanes; ++k) {
                const uint32_t a = sum[i][k];
                const uint32_t b = __shfl_xor_sync(0xFFFFFFFFu, a, off);
                sum[i][k] = a ^ b ^ cy;
                cy = (a & b) | (cy & (a ^ b));
            }
        }
    }
    const bool writer = sl == 0 && vlive;
    if (n_chunks == 1) {                                // decided here
        if (!writer) return;
        Words<U> own, out;
        load_words<U>(src + own_row(s, r) * W + w0, own);
#pragma unroll
        for (int i = 0; i < U; ++i)
            out.w[i] = decide<kChunkPlanes, MINORITY, CHANGE>(sum[i], d,
                                                              own.w[i]);
        store_words<U>(dst + (s.out_row0 + r) * W + w0, out);
        return;
    }
    // a row of several chunks: integer counts into the workspace, then the
    // chunk that takes the last ticket decides
    int* cnt = counts + (s.ws_row0 + r) * (W * 32);
    if (writer) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
#pragma unroll 8
            for (int b = 0; b < 32; ++b) {
                int v = 0;
#pragma unroll
                for (int k = 0; k < kChunkPlanes; ++k)
                    v |= (int)((sum[i][k] >> b) & 1u) << k;
                if (v) atomicAdd(cnt + (w0 + i) * 32 + b, v);
            }
        }
    }
    __threadfence();
    __syncwarp();
    int* ticket = tickets + (s.ws_row0 + r) * geo.G + g;
    int last = 0;
    if (lane == 0) last = atomicAdd(ticket, 1) == n_chunks - 1;
    last = __shfl_sync(0xFFFFFFFFu, last, 0);
    if (!last) return;
    __threadfence();
    if (writer) {
        // the row's counts, complete since every chunk's atomics came
        // before its ticket: read from L2 sixteen bytes at a time (all in
        // flight together), then zeroed for the next step
        Words<U> own, out;
        load_words<U>(src + own_row(s, r) * W + w0, own);
#pragma unroll
        for (int i = 0; i < U; ++i) {
            int4* c4 = reinterpret_cast<int4*>(cnt + (w0 + i) * 32);
            int4 q[8];
#pragma unroll
            for (int h = 0; h < 8; ++h) q[h] = __ldcg(c4 + h);
            uint32_t gt = 0u, tie = 0u;
#pragma unroll
            for (int h = 0; h < 8; ++h) {
                const int two[4] = {2 * q[h].x, 2 * q[h].y, 2 * q[h].z,
                                    2 * q[h].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    gt |= (uint32_t)(two[e] > d) << (4 * h + e);
                    tie |= (uint32_t)(two[e] == d) << (4 * h + e);
                }
                c4[h] = make_int4(0, 0, 0, 0);
            }
            out.w[i] = combine<MINORITY, CHANGE>(gt, tie, own.w[i]);
        }
        store_words<U>(dst + (s.out_row0 + r) * W + w0, out);
    }
    if (lane == 0) *ticket = 0;                         // ready for next step
}

template <bool MINORITY, bool CHANGE, int U>
__global__ void __launch_bounds__(kThreads)
bucketed_step_kernel(const __grid_constant__ Table table, Geo geo,
                     const uint32_t* __restrict__ src,
                     uint32_t* __restrict__ dst, long long W,
                     long long ghost_row, int* __restrict__ counts,
                     int* __restrict__ tickets)
{
    const long long vpr = W / U;
    if (blockIdx.x == 0 && ghost_row >= 0)
        for (long long w = threadIdx.x; w < W; w += kThreads)
            dst[ghost_row * W + w] = 0u;
    int si = 0;
    while (si + 1 < table.n_seg
           && (long long)blockIdx.x >= table.seg[si + 1].block0) ++si;
    const Seg& s = table.seg[si];
    const long long block_in_seg = (long long)blockIdx.x - s.block0;
    if (s.cpr == 0)
        narrow_dispatch<MINORITY, CHANGE, U>(
            s, block_in_seg * kThreads + threadIdx.x, src, dst, W, vpr);
    else
        wide_rows<MINORITY, CHANGE, U>(s, block_in_seg, src, dst, W, vpr,
                                       geo, counts, tickets);
}

template <bool MINORITY, bool CHANGE>
void launch_width(const Table& t, const Geo& geo, const uint32_t* src,
                  uint32_t* dst, long long W, long long ghost_row,
                  int* counts, int* tickets, unsigned blocks, int U,
                  cudaStream_t stream)
{
    if (U == 4)
        bucketed_step_kernel<MINORITY, CHANGE, 4>
            <<<blocks, kThreads, 0, stream>>>(t, geo, src, dst, W, ghost_row,
                                              counts, tickets);
    else
        bucketed_step_kernel<MINORITY, CHANGE, 1>
            <<<blocks, kThreads, 0, stream>>>(t, geo, src, dst, W, ghost_row,
                                              counts, tickets);
}

}  // namespace

// descs: n_seg rows of kCols int64 (block0, rows, out_row0, width, cpr,
// ws_row0, nbr, deg, self, unused), in host memory, copied into the
// launch's parameters. total_blocks: the grid. U: words per thread or
// lane, 4 (a uint4: W % 4 == 0 and 16-byte aligned states) or 1. vlanes,
// G, chunk: the wide lane geometry (bucketed_cuda.py:wide_geometry). counts, tickets:
// the zeroed workspace of the rows that span several chunks (ws_rows x
// W*32 and ws_rows x G int32; null when there are none), left zeroed.
extern "C" int graphdyn_bucketed_step(
    const long long* descs, int n_seg, long long total_blocks,
    const void* src, void* dst, long long W, long long ghost_row,
    int minority, int change, int U, int vlanes, int G, int chunk,
    void* counts, void* tickets, void* stream)
{
    if (n_seg < 1 || n_seg > kMaxSeg || W < 1 || (U != 1 && U != 4)
        || W % U != 0 || total_blocks < 1 || total_blocks > INT_MAX
        || vlanes < 1 || vlanes > 32 || (vlanes & (vlanes - 1)) != 0
        || G < 1 || (long long)G * vlanes < W / U
        || chunk != (32 / vlanes) * kSlotsPerLane
        || (U == 4 && ((uintptr_t)src % 16 != 0 || (uintptr_t)dst % 16 != 0))
        || src == dst)
        return (int)cudaErrorInvalidValue;
    Geo geo;
    geo.vlanes = vlanes;
    geo.vshift = __builtin_ctz(vlanes);
    geo.G = G;
    geo.chunk = chunk;
    Table t;
    t.n_seg = n_seg;
    for (int s = 0; s < n_seg; ++s) {
        const long long* d = descs + kCols * s;
        Seg& g = t.seg[s];
        g.block0 = d[0]; g.rows = d[1]; g.out_row0 = d[2]; g.width = d[3];
        g.cpr = d[4]; g.ws_row0 = d[5]; g.nbr = d[6]; g.deg = d[7];
        g.self = d[8];
        const bool narrow_ok = g.cpr == 0 && g.width <= 32;
        const bool wide_ok = g.width > 32
            && g.cpr == (g.width + chunk - 1) / chunk
            && (g.cpr == 1 || (g.ws_row0 >= 0 && counts && tickets));
        if (!(narrow_ok || wide_ok) || g.rows < 0 || g.width < 1
            || g.nbr == 0 || g.deg == 0
            || g.block0 < (s ? t.seg[s - 1].block0 : 0)
            || g.block0 >= total_blocks)
            return (int)cudaErrorInvalidValue;
    }
    if (t.seg[0].block0 != 0) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)total_blocks;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* s = static_cast<const uint32_t*>(src);
    uint32_t* d = static_cast<uint32_t*>(dst);
    int* cn = static_cast<int*>(counts);
    int* tk = static_cast<int*>(tickets);
    if (minority) {
        if (change) launch_width<true, true>(t, geo, s, d, W, ghost_row, cn,
                                             tk, blocks, U, st);
        else launch_width<true, false>(t, geo, s, d, W, ghost_row, cn, tk,
                                       blocks, U, st);
    } else {
        if (change) launch_width<false, true>(t, geo, s, d, W, ghost_row, cn,
                                              tk, blocks, U, st);
        else launch_width<false, false>(t, geo, s, d, W, ghost_row, cn, tk,
                                        blocks, U, st);
    }
    return (int)cudaGetLastError();
}
