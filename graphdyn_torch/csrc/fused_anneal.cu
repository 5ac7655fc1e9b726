// One chunk of the fused SA annealer: up to chunk_steps class steps in ONE
// cooperative launch, each class step one pass over the class rows.
//
// Replaces the Pallas TPU kernel of the JAX package
//   K4  graphdyn/ops/pallas_anneal.py:433  fused_chunk_pallas
// (loop body _fused_cond_body -> _fused_class_step -> lut_one_step +
// accept_apply), and computes what its XLA twin fused_chunk_xla computes, bit
// for bit: the same Threefry-2x32 uniforms, the same f32 operations for
// dE = ((-2a)s - b*dsend) * (1/n), expf, the same int32 sums.
//
// Layout. 32 replicas per word: replica R is bit R%32 of word R/32. The state
// sp is [n+1, W]; row n is the ghost row, always zero, and ghost-padded table
// slots (index n) read it. Per-replica vectors have Rp = 32W entries; pad
// replicas start inactive and stay so.
//
// One class step, c = steps mod chi, is one pass and one grid barrier:
//   pass. Every (class row i, word w): for each ball row b of {i} + N(i)
//      (nbr_self[i]), end_b = LUT step of s and end_all_b = LUT step of
//      s ^ mask_c at b, in registers, from one gather of b's neighbour words
//      (the class mask XORed in on the fly) and one read of b's LUT masks
//      for both; a ghost slot counts 0. Then up/dn = end_all & ~end /
//      end & ~end_all, carry-save popcounts over the ball, per replica bit
//      dsend and dE, the Threefry uniform (one block per replica pair,
//      counter (step, node)) and acc = u < expf(-dE) & active; the flip
//      word is XORed into sp[i] in place. This is exact without a barrier
//      between evaluation and accept: the colouring is one of G^2, so two
//      rows of a class are at distance >= 3; the rows a class row reads (at
//      distance <= 2 from it) hold no other class row, and nothing else is
//      written in the pass (ops/fused.fused_device_tables refuses class masks
//      whose balls overlap). Per-replica dsend*acc and the accepted count go
//      into integer accumulators (shared memory per block, bit-major, then
//      global atomics): exact, so the result does not depend on order.
//   bookkeeping. The last block to finish its pass (a ticket counter behind
//      __threadfence) does sum_end += dsend, the anneal (cap checked before
//      the multiply), steps, first passage and freeze, accepted; it clears
//      the accumulators and the ticket and writes the loop flag
//      any(active) && steps - steps0 < chunk_steps
//                  && !(stop_on_first && any(t_target >= 0)),
//      which every block reads after the barrier.
// The host reads nothing within a chunk; the state buffers are updated in
// place (the reference's input/output aliasing, pallas_anneal.py:474-476).
//
// Threads. A class word's 32 replicas are 16 Threefry pairs. At small W the
// lanes of a word split them (lanes = 16 at W = 1: one Threefry block and two
// expf per lane) and split the ball rows too: lane q evaluates ball rows q,
// q + lanes, ... and the words are shared by shuffles; the flip word is an
// OR over the word's lanes. With one lane per word (W >= 17) the thread
// walks its ball rows itself. A class row takes row_threads = (W padded to a
// power of two below 32, to a multiple of 32 above) x lanes threads, so a
// warp covers whole class rows or consecutive words of one: at W >= 32 the
// index, LUT and mask loads are warp-uniform and the state loads whole
// 128-byte rows. The host chooses lanes and row_threads
// (graphdyn_torch/ops/fused_cuda.lane_plan). Degrees up to 8 get a kernel
// with dmax compiled in: the ball and neighbour loops unroll and their
// loads are in flight together; at the scale shape that shortens the pass
// more than any other change measured beside it (PERF.md, PR 6).
//
// What bounds it on an H100. At the scale shape (n = 1e6, d = 5, W = 32,
// chi = 16) operations: the LUT logic over the ball rows' words (6/16 of the
// rows) and the class sites' Threefry blocks, about 5e9 32-bit integer ops
// per class step (0.32 ms), against 0.13 GB of bytes. Evaluating only the
// balls, and both LUT steps from one neighbour gather, removes the work the
// first design spent on every row (its phase A: 0.9 of 1.29 ms) and the two
// [n+1, W] scratch planes; the ball evaluation is still the larger part of
// the pass. At search-regime sizes (n = 1e4, W = 1) latency: one chain of
// dependent loads (class row, ball row, neighbour, word), one Threefry block
// and two expf per lane, the flush and fence, the ticket, the bookkeeping of
// one block and one grid barrier per class step, where the first design had
// three barriers and one serial chain of 16 blocks and 32 expf per class
// word. A barrier of the kernel's own (the ticket's last block releasing the
// others after the bookkeeping) measured slower than cooperative groups'.
//
// Floats: compiled with --fmad=false, and every f32 operation of dE is an
// explicit round-to-nearest intrinsic, so no multiply-add is contracted.
// expf is the accurate CUDA expf (never __expf / --use_fast_math), the
// function PyTorch's exp computes for f32 on the card.
//
// Tracing: given a trace buffer, the first trace_steps class steps stamp the
// global timer at four points: the start (block 0), the end of the pass (the
// last block, when its ticket shows every block done), the end of the
// bookkeeping (the same block) and after the barrier (block 0). One
// predicated store per point when off.
//
// C interface (bound with ctypes): graphdyn_fused_chunk returns the
// cudaError_t of the launch, 0 on success, cudaErrorInvalidValue for sizes
// or a lane plan outside the kernel's bounds; it launches on the given
// stream and does not synchronise. graphdyn_fused_grid reports the
// co-resident grid.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kStreamTag = 0x464C5554u;   // FUSED_STREAM_TAG, b"FLUT"
// per-replica inputs and accumulators staged in shared memory up to W = 96
// (13 bytes per replica, within the 48 KB a block gets without opting in)
constexpr int kSmemReplicas = 3072;

struct Params {
    uint32_t* sp;               // [n+1, W] state, updated in place
    int32_t* sum_end;           // [Rp]
    float* a;                   // [Rp]
    float* b;                   // [Rp]
    int32_t* t_target;          // [Rp]
    uint8_t* active;            // [Rp] (torch.bool)
    int32_t* steps;             // [1]
    int32_t* accepted;          // [1]
    const uint32_t* masks;      // [chi, n+1]
    const float* facs;          // [chi, 2]
    const int32_t* nbr_ext;     // [n+1, dmax]
    const int32_t* nbr_self;    // [n+1, dmax+1]
    const uint32_t* lut;        // [dmax+1, 2, n+1]
    const float* a_caps;        // [Rp]
    const float* b_caps;        // [Rp]
    const int32_t* class_ptr;   // [chi+1]
    const int32_t* class_rows;  // [n*chi at most]
    int32_t* work;              // [Rp + 3] zeroed: dsend sums, accepted,
                                // loop flag, ticket
    long long n;
    int W;
    int dmax;
    int chi;
    int Rp;
    int lanes;                  // threads per class word
    int row_threads;            // threads per class row
    int target_sum;
    int chunk_steps;
    int stop_on_first;
    uint32_t seed;
    float inv_n;
    unsigned long long* trace;  // [trace_steps, 4] or null: timestamps
    int trace_steps;
};

template <typename T>
__device__ __forceinline__ T ld_cg(const T* p) { return __ldcg(p); }

__device__ __forceinline__ uint8_t ld_cg_u8(const uint8_t* p)
{
    return *reinterpret_cast<const volatile uint8_t*>(p);
}

// the global timer (ns) into slot `slot` of class step k's trace row:
// [start, end of pass, end of bookkeeping, after the barrier]
__device__ __forceinline__ void stamp(const Params& p, int k, int slot)
{
    if (p.trace == nullptr || k >= p.trace_steps) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.trace[4 * k + slot] = t;
}

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

// the degree bound the loops run to: DM when the kernel is instantiated for
// it (fully unrolled loops, their loads in flight together), else dmax
template <int DM>
__device__ __forceinline__ int degree_bound(const Params& p)
{
    return DM > 0 ? DM : p.dmax;
}

// end and end_all of ball row b, word w: graphdyn/ops/lut.py:lut_one_step
// applied to s and to s ^ mask_c at one row, from one gather of its
// neighbours' words and one read of its LUT masks.
//
// With dmax compiled in (DM > 0) both loops run to it, unrolled. With dmax
// at run time both stop at the row's own degree, which is exact, bit for
// bit: a row's ghost slots (index n) come after its neighbours
// (ops/fused.fused_device_tables checks it), the ghost word and the ghost
// column of every class mask are 0, so a ghost slot adds nothing to either
// count; and no neighbour count exceeds the degree, so the equality tests
// for larger counts are all false and add nothing to e or ea. At a leaf of
// a graph with hubs this cuts the LUT walk from dmax + 1 counts to
// deg + 1.
template <int NP, int DM>
__device__ __forceinline__ void end_pair(const Params& p,
                                         const uint32_t* mask_c, long long b,
                                         int w, uint32_t& e, uint32_t& ea)
{
    const long long n1 = p.n + 1;
    const int dmax = degree_bound<DM>(p);
    const int32_t* nb = p.nbr_ext + b * dmax;
    uint32_t pl0[NP], pl1[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) pl0[k] = pl1[k] = 0u;
    int deg = dmax;
#pragma unroll
    for (int j = 0; j < dmax; ++j) {
        const long long v = __ldg(nb + j);
        if (DM == 0 && v == p.n) {
            deg = j;
            break;
        }
        const uint32_t x = ld_cg(p.sp + v * p.W + w);
        csa_add<NP>(pl0, x);
        csa_add<NP>(pl1, x ^ __ldg(mask_c + v));
    }
    const uint32_t own = ld_cg(p.sp + b * p.W + w);
    const uint32_t own_all = own ^ __ldg(mask_c + b);
    e = ea = 0u;
#pragma unroll
    for (int cnt = 0; cnt <= deg; ++cnt) {
        uint32_t eq0 = kFull, eq1 = kFull;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const bool one = (cnt >> k) & 1;
            eq0 &= one ? pl0[k] : ~pl0[k];
            eq1 &= one ? pl1[k] : ~pl1[k];
        }
        const uint32_t m0 = __ldg(p.lut + (2 * (long long)cnt) * n1 + b);
        const uint32_t m1 = __ldg(p.lut + (2 * (long long)cnt + 1) * n1 + b);
        e |= eq0 & ((own & m1) | (~own & m0));
        ea |= eq1 & ((own_all & m1) | (~own_all & m0));
    }
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& y0, uint32_t& y1)
{
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
    for (int d = 0; d < 5; ++d) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x0 += x1;
            x1 = __funnelshift_l(x1, x1, rot[d % 2][i]) ^ x0;
        }
        x0 += ks[(d + 1) % 3];
        x1 += ks[(d + 2) % 3] + (uint32_t)(d + 1);
    }
    y0 = x0;
    y1 = x1;
}

// NP, NB: bit planes of a neighbour count (<= dmax) and of a ball count
// (<= dmax + 1); DM: dmax itself for dmax <= kMaxDM, 0 above (loops to the
// runtime dmax)
template <int NP, int NB, int DM>
__global__ void __launch_bounds__(kThreads)
fused_anneal_kernel(Params p)
{
    // when Rp <= kSmemReplicas, the pass stages a, b and active and sums
    // dsend in shared memory, bit-major (entry bit*W + w for replica
    // 32w + bit), so the words of a warp touch consecutive entries
    extern __shared__ int32_t smem[];
    int32_t* s_dsend = smem;                                   // [Rp]
    float* s_a = reinterpret_cast<float*>(smem + p.Rp);        // [Rp]
    float* s_b = s_a + p.Rp;                                   // [Rp]
    uint8_t* s_act = reinterpret_cast<uint8_t*>(s_b + p.Rp);   // [Rp]
    __shared__ uint32_t s_count;
    __shared__ int s_last;
    cg::grid_group grid = cg::this_grid();
    const long long n = p.n, n1 = p.n + 1;
    const int W = p.W, Rp = p.Rp, L = p.lanes, RT = p.row_threads;
    const int slots = degree_bound<DM>(p) + 1;
    const bool use_smem = Rp <= kSmemReplicas;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    int32_t* acc_dsend = p.work;
    uint32_t* acc_count = reinterpret_cast<uint32_t*>(p.work + Rp);
    int32_t* go_flag = p.work + Rp + 1;
    uint32_t* ticket = reinterpret_cast<uint32_t*>(p.work + Rp + 2);
    const int steps0 = ld_cg(p.steps);

    // the loop condition on the state as it stands: every block evaluates
    // it (nothing is written before every block has passed this point)
    bool go;
    {
        bool act = false, hit = false;
        for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
            act |= ld_cg_u8(p.active + r) != 0;
            hit |= ld_cg(p.t_target + r) >= 0;
        }
        act = __syncthreads_or(act);
        hit = __syncthreads_or(hit);
        go = act && p.chunk_steps > 0 && !(p.stop_on_first && hit);
    }

    // a, b and active as the next pass reads them (bit-major, zeroed dsend)
    auto stage = [&]() {
        if (!use_smem) return;
        for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
            const int j = (r & 31) * W + (r >> 5);
            s_dsend[j] = 0;
            s_a[j] = ld_cg(p.a + r);
            s_b[j] = ld_cg(p.b + r);
            s_act[j] = ld_cg_u8(p.active + r);
        }
    };
    stage();

    for (int k = 0; go; ++k) {
        const int step = steps0 + k;
        const int c = step % p.chi;
        if (blockIdx.x == 0 && threadIdx.x == 0) stamp(p, k, 0);
        const uint32_t* mask_c = p.masks + (long long)c * n1;

        // ---- the pass: accepts of the class rows -------------------------
        if (threadIdx.x == 0) s_count = 0u;
        __syncthreads();
        const int lo = __ldg(p.class_ptr + c), hi = __ldg(p.class_ptr + c + 1);
        const long long items = (long long)(hi - lo) * RT;
        // whole warps run every iteration, so a word's lanes can shuffle
        const long long span = (items + 31) & ~31LL;
        for (long long i = tid; i < span; i += nthreads) {
            const long long kr = i / RT;
            const int r = (int)(i - kr * RT);
            const int w = r / L;
            const int q = r - w * L;
            const bool live = i < items && w < W;
            const long long row = live ? __ldg(p.class_rows + lo + kr) : 0;
            // the class row's own word: no other item writes it
            const uint32_t own = live ? ld_cg(p.sp + row * W + w) : 0u;
            uint32_t up[NB], dn[NB];
#pragma unroll
            for (int t = 0; t < NB; ++t) up[t] = dn[t] = 0u;
            if (L == 1) {
                // one thread per class word walks its ball rows
                if (live) {
#pragma unroll
                    for (int j = 0; j < slots; ++j) {
                        const long long b =
                            __ldg(p.nbr_self + row * slots + j);
                        // ghost slots are the row's suffix (end_pair)
                        if (b == n) {
                            if (DM == 0) break;
                            continue;
                        }
                        uint32_t e, ea;
                        end_pair<NP, DM>(p, mask_c, b, w, e, ea);
                        csa_add<NB>(up, ea & ~e);
                        csa_add<NB>(dn, e & ~ea);
                    }
                }
            } else {
                // the word's lanes split the ball rows, shared by shuffles
                for (int base = 0; base < slots; base += L) {
                    uint32_t e = 0u, ea = 0u;
                    long long b = n;
                    if (live && base + q < slots) {
                        b = __ldg(p.nbr_self + row * slots + base + q);
                        if (b != n) end_pair<NP, DM>(p, mask_c, b, w, e, ea);
                    }
                    // with dmax at run time the warp stops at the first
                    // block of slots that is ghost for all its rows (ghosts
                    // are each row's suffix: the rest adds nothing)
                    if (DM == 0 && !__any_sync(kFull, b != n)) break;
                    const int m = slots - base < L ? slots - base : L;
                    for (int t = 0; t < m; ++t) {
                        const uint32_t et = __shfl_sync(kFull, e, t, L);
                        const uint32_t eat = __shfl_sync(kFull, ea, t, L);
                        csa_add<NB>(up, eat & ~et);
                        csa_add<NB>(dn, et & ~eat);
                    }
                }
            }
            uint32_t flips = 0u;
            if (live) {
                for (int pw = q; pw < 16; pw += L) {
                    uint32_t y[2];
                    threefry2x32(p.seed, kStreamTag + (uint32_t)(w * 16 + pw),
                                 (uint32_t)step, (uint32_t)row, y[0], y[1]);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int bit = 2 * pw + h;
                        const int R = w * 32 + bit;
                        const int j = bit * W + w;
                        if (!(use_smem ? s_act[j] : ld_cg_u8(p.active + R)))
                            continue;
                        int cu = 0, cd = 0;
#pragma unroll
                        for (int t = 0; t < NB; ++t) {
                            cu |= (int)((up[t] >> bit) & 1u) << t;
                            cd |= (int)((dn[t] >> bit) & 1u) << t;
                        }
                        const int dsend = 2 * (cu - cd);
                        const float s = ((own >> bit) & 1u) ? 1.0f : -1.0f;
                        const float av = use_smem ? s_a[j] : ld_cg(p.a + R);
                        const float bv = use_smem ? s_b[j] : ld_cg(p.b + R);
                        const float t2 = __fmul_rn(__fmul_rn(-2.0f, av), s);
                        const float t3 = __fmul_rn(bv, (float)dsend);
                        const float de = __fmul_rn(__fsub_rn(t2, t3), p.inv_n);
                        const float u =
                            (float)(y[h] >> 8) * 5.9604644775390625e-08f;
                        if (u < expf(-de)) {
                            flips |= 1u << bit;
                            if (dsend != 0) {
                                if (use_smem) atomicAdd(s_dsend + j, dsend);
                                else atomicAdd(acc_dsend + R, dsend);
                            }
                        }
                    }
                }
            }
            // the word's lanes are one aligned segment of the warp
            for (int off = 1; off < L; off <<= 1)
                flips |= __shfl_xor_sync(kFull, flips, off);
            if (live && q == 0 && flips) {
                p.sp[row * W + w] = own ^ flips;
                atomicAdd(&s_count, (uint32_t)__popc(flips));
            }
        }
        __syncthreads();
        if (use_smem) {
            for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
                const int v = s_dsend[(r & 31) * W + (r >> 5)];
                if (v != 0) atomicAdd(acc_dsend + r, v);
            }
        }
        if (threadIdx.x == 0 && s_count != 0u) atomicAdd(acc_count, s_count);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0)
            s_last = atomicAdd(ticket, 1u) == gridDim.x - 1u;
        __syncthreads();

        // ---- bookkeeping: the last block to finish the pass ---------------
        if (s_last) {
            __threadfence();
            if (threadIdx.x == 0) stamp(p, k, 1);
            // the counters' loads in flight with the per-replica ones
            uint32_t count = 0u, accepted = 0u;
            if (threadIdx.x == 0) {
                count = ld_cg(acc_count);
                accepted = (uint32_t)ld_cg(p.accepted);
            }
            const float fa = __ldg(p.facs + 2 * c);
            const float fb = __ldg(p.facs + 2 * c + 1);
            bool any_act = false, any_hit = false;
            for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
                const bool act = ld_cg_u8(p.active + r) != 0;
                const int se = ld_cg(p.sum_end + r) + ld_cg(acc_dsend + r);
                acc_dsend[r] = 0;
                const float av = ld_cg(p.a + r), bv = ld_cg(p.b + r);
                if (act && av < __ldg(p.a_caps + r)) p.a[r] = __fmul_rn(av, fa);
                if (act && bv < __ldg(p.b_caps + r)) p.b[r] = __fmul_rn(bv, fb);
                p.sum_end[r] = se;
                const bool hit = act && se >= p.target_sum;
                int tt = ld_cg(p.t_target + r);
                if (hit) {
                    tt = step + 1;
                    p.t_target[r] = tt;
                }
                const bool still = act && !hit;
                p.active[r] = still ? 1 : 0;
                any_act |= still;
                any_hit |= tt >= 0;
            }
            any_act = __syncthreads_or(any_act);
            any_hit = __syncthreads_or(any_hit);
            if (threadIdx.x == 0) {
                *p.steps = step + 1;
                *p.accepted = (int32_t)(accepted + count);
                *acc_count = 0u;
                *ticket = 0u;
                *go_flag = any_act && k + 1 < p.chunk_steps
                           && !(p.stop_on_first && any_hit);
                stamp(p, k, 2);
            }
        }
        grid.sync();
        // the flag and the next pass's staging, their loads in flight
        // together (staging past the last step reads and is not used)
        go = ld_cg(go_flag) != 0;
        stage();
        if (blockIdx.x == 0 && threadIdx.x == 0) stamp(p, k, 3);
    }
}

using KernelFn = void (*)(Params);

constexpr int bit_length(int v)
{
    return v > 0 ? 1 + bit_length(v >> 1) : 0;
}

// degrees up to kMaxDM get a kernel with dmax compiled in; above it the
// kernels by bit planes, with dmax at run time: the tight plane pairs up to
// dmax 63, then 8, 16 and 32 planes, so every int32 degree has a kernel
constexpr int kMaxDM = 8;

template <int DM>
constexpr KernelFn fixed_degree()
{
    return fused_anneal_kernel<bit_length(DM), bit_length(DM + 1), DM>;
}

KernelFn pick(int dmax)
{
    switch (dmax) {
        case 1: return fixed_degree<1>();
        case 2: return fixed_degree<2>();
        case 3: return fixed_degree<3>();
        case 4: return fixed_degree<4>();
        case 5: return fixed_degree<5>();
        case 6: return fixed_degree<6>();
        case 7: return fixed_degree<7>();
        case 8: return fixed_degree<8>();
        default: break;
    }
    const int np = bit_length(dmax), nb = bit_length(dmax + 1);
#define GRAPHDYN_FUSED_CASE(A, B) \
    if (np == A && nb == B) return fused_anneal_kernel<A, B, 0>;
    GRAPHDYN_FUSED_CASE(4, 4) GRAPHDYN_FUSED_CASE(4, 5)
    GRAPHDYN_FUSED_CASE(5, 5) GRAPHDYN_FUSED_CASE(5, 6)
    GRAPHDYN_FUSED_CASE(6, 6) GRAPHDYN_FUSED_CASE(6, 7)
#undef GRAPHDYN_FUSED_CASE
    // a ball count (<= dmax + 1) needs nb planes, a neighbour count np <= nb
    if (nb <= 8) return fused_anneal_kernel<8, 8, 0>;
    if (nb <= 16) return fused_anneal_kernel<16, 16, 0>;
    if (nb <= 32) return fused_anneal_kernel<32, 32, 0>;
    return nullptr;
}

size_t smem_bytes(int Rp)
{
    return Rp <= kSmemReplicas ? 13 * (size_t)Rp : 0;
}

// the co-resident grid of the kernel for this dmax and Rp: blocks per SM
// (occupancy) and the SM count of the current device
cudaError_t grid_info(int dmax, int Rp, KernelFn* fn, int* per_sm, int* sms)
{
    *fn = pick(dmax);
    if (*fn == nullptr) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, *fn, kThreads, smem_bytes(Rp));
}

// the lane plan's bounds: lanes a power of two up to 16 that divides
// row_threads; row_threads covers W words of `lanes` threads and is a power
// of two up to 32 or a multiple of 32, so each warp holds whole rows or a
// run of one row's words, and a word's lanes one aligned segment of a warp
bool lane_plan_ok(long long W, int lanes, int row_threads)
{
    if (lanes < 1 || lanes > 16 || (lanes & (lanes - 1)) != 0) return false;
    if (row_threads < lanes || row_threads % lanes != 0) return false;
    if ((long long)(row_threads / lanes) < W) return false;
    if (row_threads <= 32) return (row_threads & (row_threads - 1)) == 0;
    return row_threads % 32 == 0;
}

}  // namespace

extern "C" int graphdyn_fused_grid(int dmax, int Rp, int* per_sm, int* sms)
{
    KernelFn fn;
    return (int)grid_info(dmax, Rp, &fn, per_sm, sms);
}

extern "C" int graphdyn_fused_chunk(
    void* sp, void* sum_end, void* a, void* b, void* t_target, void* active,
    void* steps, void* accepted,
    const void* masks, const void* facs, const void* nbr_ext,
    const void* nbr_self, const void* lut, const void* a_caps,
    const void* b_caps, const void* class_ptr, const void* class_rows,
    void* work,
    long long n, long long W, int dmax, int chi, long long max_class,
    int lanes, int row_threads, int target_sum,
    int chunk_steps, int stop_on_first, unsigned int seed, float inv_n,
    void* trace, int trace_steps, int* grid_blocks, void* stream)
{
    if (n < 1 || n >= 2147483647LL || W < 1 || dmax < 1 || chi < 1
        || W * 32 > (1 << 30) || max_class < 0 || max_class > n
        || !lane_plan_ok(W, lanes, row_threads))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.sp = static_cast<uint32_t*>(sp);
    p.sum_end = static_cast<int32_t*>(sum_end);
    p.a = static_cast<float*>(a);
    p.b = static_cast<float*>(b);
    p.t_target = static_cast<int32_t*>(t_target);
    p.active = static_cast<uint8_t*>(active);
    p.steps = static_cast<int32_t*>(steps);
    p.accepted = static_cast<int32_t*>(accepted);
    p.masks = static_cast<const uint32_t*>(masks);
    p.facs = static_cast<const float*>(facs);
    p.nbr_ext = static_cast<const int32_t*>(nbr_ext);
    p.nbr_self = static_cast<const int32_t*>(nbr_self);
    p.lut = static_cast<const uint32_t*>(lut);
    p.a_caps = static_cast<const float*>(a_caps);
    p.b_caps = static_cast<const float*>(b_caps);
    p.class_ptr = static_cast<const int32_t*>(class_ptr);
    p.class_rows = static_cast<const int32_t*>(class_rows);
    p.work = static_cast<int32_t*>(work);
    p.n = n;
    p.W = (int)W;
    p.dmax = dmax;
    p.chi = chi;
    p.Rp = (int)(W * 32);
    p.lanes = lanes;
    p.row_threads = row_threads;
    p.target_sum = target_sum;
    p.chunk_steps = chunk_steps;
    p.stop_on_first = stop_on_first;
    p.seed = seed;
    p.inv_n = inv_n;
    p.trace = static_cast<unsigned long long*>(trace);
    p.trace_steps = trace_steps;

    KernelFn fn;
    int per_sm = 0, sms = 0;
    cudaError_t err = grid_info(dmax, p.Rp, &fn, &per_sm, &sms);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    // no more blocks than the largest class has work for
    const long long items = max_class * row_threads;
    const long long want = (items + kThreads - 1) / kThreads;
    const long long cap = (long long)per_sm * sms;
    const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
    *grid_blocks = blocks;
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                      dim3(kThreads), args, smem_bytes(p.Rp),
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
