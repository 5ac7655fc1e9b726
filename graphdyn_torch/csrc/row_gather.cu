// Random-row gather: out[i, :] = src[idx[i], :] for 4-byte words.
//
// Replaces the Pallas TPU kernel of the JAX package
//   P  scripts/pallas_gather_probe.py:63  pallas_gather  (pallas_call :104)
// and computes what graphdyn_torch/ops/gather.py:row_gather_plain computes
// (src.index_select(0, idx)), bit for bit: it only moves words.
//
// What bounds it on an H100. Each output row is one random row of the
// source: at least each distinct source row read once (n_distinct·W·4
// bytes), n_idx·W·4 bytes written, and n_idx·4 bytes of indices. At the
// probe's shapes (n_src = 1e6, 1.54 GB of gathered rows at every width,
// about n_src·(1 − e^(−n_idx/n_src)) distinct rows) that is 0.6–0.85 ms of
// HBM traffic at 3.35 TB/s, so bytes bound it (the read-once bound). A
// source row gathered twice is read twice from HBM unless L2 still holds
// it, and at uniform-random indices over a 0.5–4 GB source it does not (L2
// is 50 MB): so the bound a gather in output order can approach is the
// all-reads bound, n_idx·W·4 read and the same written (3.07 GB, 0.917 ms at
// the probe's W=512). A narrow row (W ≤ 8
// words, 32 bytes, one sector) moves a whole sector per access, so there
// the rate of independent accesses the memory system sustains is the real
// limit, not the byte count.
//
// Design. The Pallas kernel rings depth-S row DMAs through VMEM because a TPU
// core issues one copy at a time; on Hopper the memory-level parallelism
// comes from many threads with several independent loads each:
// - a row of W words is V vectors: 16-byte int4 vectors when W % 4 == 0 and
//   both arrays are 16-byte aligned, else single words. L = min(32,
//   next power of two ≥ V) adjacent lanes of a warp share a row: one warp per
//   row when V ≥ 32 (rows of 128 words or more), 32 / L rows per warp below,
//   so every warp issues full-width loads;
// - each thread carries DEPTH rows at once: it reads their DEPTH indices,
//   then for each of its vector columns issues DEPTH loads before DEPTH
//   stores. Loads take the read-only path (__ldg); stores are streaming
//   (__stcs) or write-back, by the plan;
// - a block of 256 threads owns DEPTH·(8·32/L) consecutive output rows; the
//   grid covers n_idx with a grid-stride loop, so any n_idx is taken (the
//   Pallas kernel asserts n_idx % block == 0).
// Measured on an H100 (PERF.md): HBM is saturated by the warps alone at
// these shapes, and more rows in flight only costs DRAM efficiency — depth
// 1 with write-back stores at rows of 2 KB or more, depth 2 at 128–512 B,
// depth 4 at 64 B, where the first version ran depth 8 at every width. A
// TMA version (one 1-D bulk copy per row into an mbarrier-counted ring of
// shared-memory stages, one bulk store per slab) measured slower than this
// path at every width from 64 B to 4 KB, and is not kept.
// Indices must lie in [0, n_src): the kernel does not check them, as the
// Pallas kernel does not. A duplicate source row is read again from HBM
// (or L2): an order by source row is later work.
//
// C interface (bound with ctypes): graphdyn_row_gather launches on the given
// stream, does not synchronise, and returns the cudaError_t of the launch,
// 0 on success, cudaErrorInvalidValue for an argument outside its bounds.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename VT>
__device__ __forceinline__ VT zero();
template <>
__device__ __forceinline__ int zero<int>() { return 0; }
template <>
__device__ __forceinline__ int4 zero<int4>() { return make_int4(0, 0, 0, 0); }

template <typename VT, int DEPTH>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const VT* __restrict__ src, const int* __restrict__ idx,
                  VT* __restrict__ out, long long n_idx, int V, int lanes_log2,
                  bool streaming)
{
    const int L = 1 << lanes_log2;                 // lanes per row
    const int lane = threadIdx.x & 31;
    const int rows_per_warp = 32 >> lanes_log2;
    const int c0 = lane & (L - 1);
    const long long rows_per_step =
        (long long)(blockDim.x >> 5) * rows_per_warp;
    const long long tile_rows = rows_per_step * DEPTH;
    const long long first = (long long)blockIdx.x * tile_rows
                          + (threadIdx.x >> 5) * rows_per_warp
                          + (lane >> lanes_log2);
    for (long long r0 = first; r0 < n_idx;
         r0 += (long long)gridDim.x * tile_rows) {
        long long row[DEPTH];
        long long from[DEPTH];
        bool live[DEPTH];
#pragma unroll
        for (int k = 0; k < DEPTH; ++k) {
            row[k] = r0 + k * rows_per_step;
            live[k] = row[k] < n_idx;
            from[k] = live[k] ? (long long)__ldg(idx + row[k]) * V : 0;
        }
        for (int c = c0; c < V; c += L) {
            VT v[DEPTH];
#pragma unroll
            for (int k = 0; k < DEPTH; ++k)
                v[k] = live[k] ? __ldg(src + from[k] + c) : zero<VT>();
#pragma unroll
            for (int k = 0; k < DEPTH; ++k) {
                if (!live[k]) continue;
                if (streaming) __stcs(out + row[k] * V + c, v[k]);
                else out[row[k] * V + c] = v[k];
            }
        }
    }
}

template <typename VT>
cudaError_t launch(const void* src, const int* idx, void* out,
                   long long n_idx, int V, int lanes_log2, int depth,
                   bool streaming, cudaStream_t stream)
{
    const long long rows_per_step = (long long)(kThreads / 32)
                                  * (32 >> lanes_log2);
    const long long tile = rows_per_step * depth;
    long long blocks = (n_idx + tile - 1) / tile;
    if (blocks > INT_MAX) blocks = INT_MAX;        // grid-stride covers it
    const dim3 grid((unsigned)blocks);
    const VT* s = static_cast<const VT*>(src);
    VT* o = static_cast<VT*>(out);
    switch (depth) {
    case 1: row_gather_kernel<VT, 1><<<grid, kThreads, 0, stream>>>(
                s, idx, o, n_idx, V, lanes_log2, streaming); break;
    case 2: row_gather_kernel<VT, 2><<<grid, kThreads, 0, stream>>>(
                s, idx, o, n_idx, V, lanes_log2, streaming); break;
    case 4: row_gather_kernel<VT, 4><<<grid, kThreads, 0, stream>>>(
                s, idx, o, n_idx, V, lanes_log2, streaming); break;
    case 8: row_gather_kernel<VT, 8><<<grid, kThreads, 0, stream>>>(
                s, idx, o, n_idx, V, lanes_log2, streaming); break;
    case 16: row_gather_kernel<VT, 16><<<grid, kThreads, 0, stream>>>(
                s, idx, o, n_idx, V, lanes_log2, streaming); break;
    default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// src: int32[n_src, W] (any 4-byte words), idx: int32[n_idx] in [0, n_src),
// out: int32[n_idx, W]; vec = 1 moves int4 vectors (W % 4 == 0, both arrays
// 16-byte aligned), vec = 0 single words; depth in {1, 2, 4, 8, 16};
// streaming (1) or write-back (0) stores.
extern "C" int graphdyn_row_gather(const void* src, const void* idx,
                                   void* out, long long n_src,
                                   long long n_idx, int W, int vec, int depth,
                                   int streaming, void* stream)
{
    if (!src || !idx || !out || n_src < 1 || n_idx < 1 || W < 1
        || (vec != 0 && vec != 1))
        return (int)cudaErrorInvalidValue;
    if (vec && (W % 4 != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0
                 || reinterpret_cast<uintptr_t>(out) % 16 != 0))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* ix = static_cast<const int*>(idx);
    const int V = vec ? W / 4 : W;
    int lanes_log2 = 0;
    while ((1 << lanes_log2) < V && lanes_log2 < 5) ++lanes_log2;
    const cudaError_t rc =
        vec ? launch<int4>(src, ix, out, n_idx, V, lanes_log2, depth,
                           streaming != 0, s)
            : launch<int>(src, ix, out, n_idx, V, lanes_log2, depth,
                          streaming != 0, s);
    return (int)rc;
}
