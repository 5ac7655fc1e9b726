// One chunk of the fused SA annealer: up to chunk_steps class steps in ONE
// cooperative launch.
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
// One class step, c = steps mod chi, is three phases with a grid barrier
// (cooperative_groups::this_grid().sync()) after each:
//   A. every (row, word) of [n+1, W]: end = LUT step of s and end_all = LUT
//      step of s ^ mask_c, from ONE gather of the neighbour words (the class
//      mask of the neighbour is XORed in on the fly); both written to scratch.
//      The ghost row is written 0.
//   B. every (class row, word): up/dn = end_all & ~end / end & ~end_all,
//      carry-save popcounts over the ball {i} + N(i), per replica bit dsend,
//      dE, the Threefry uniform (one block per replica pair, counter
//      (step, node)) and acc = u < expf(-dE) & active; the flip word is XORed
//      into the state row in place (class rows' balls are disjoint, and the
//      phase reads no other row of the state). Per-replica dsend*acc and the
//      accepted count go into integer accumulators (shared memory per block,
//      then global atomics): exact, so the result does not depend on order.
//      Each block first stages a, b and active in shared memory bit-major
//      (entry bit*W + w), so the 32 words of a warp read, and add into, 32
//      consecutive entries; read straight from global memory word-major, the
//      same accesses are 32 scattered sectors per warp instruction.
//   C. block 0: sum_end += dsend, the anneal (cap checked before the
//      multiply), steps, first passage and freeze, accepted; it clears the
//      accumulators and writes the loop flag every block reads next:
//      any(active) && steps - steps0 < chunk_steps
//                  && !(stop_on_first && any(t_target >= 0)).
// The host reads nothing within a chunk; the state buffers are updated in
// place (the reference's input/output aliasing, pallas_anneal.py:474-476).
//
// What bounds it on an H100. The least time is set by operations at the
// scale shape (n = 1e6, W = 32): the LUT word logic over every word and the
// class sites' Threefry blocks, about 8e9 integer ops per class step, against
// about 0.23 GB of bytes (state read once, class rows written once, tables
// read once). The kernel spends most of its time in phase A, which reads the
// whole state through d random neighbour gathers and writes two [n+1, W]
// scratch planes per class step. Phase B's Threefry blocks and expf run only
// for the class sites (n/chi rows). At search-regime sizes (n = 1e4, W = 1)
// the three grid barriers per class step and one class word's serial chain
// bound it instead.
// The design keeps the loop and all state on the device for the whole chunk
// (no launch or host round trip per class step) and generates uniforms only
// where they are consumed. Sharing the gathers of A through shared memory,
// skipping rows no class ball reaches, and fewer barriers are later work.
//
// Floats: compiled with --fmad=false, and every f32 operation of dE is an
// explicit round-to-nearest intrinsic, so no multiply-add is contracted.
// expf is the accurate CUDA expf (never __expf / --use_fast_math), the
// function PyTorch's exp computes for f32 on the card.
//
// Tracing: given a trace buffer, block 0 stamps the global timer after the
// barrier that ends each phase of the first trace_steps class steps (one
// predicated store per phase when off).
//
// C interface (bound with ctypes): graphdyn_fused_chunk returns the
// cudaError_t of the launch, 0 on success; it launches on the given stream
// and does not synchronise. graphdyn_fused_grid reports the co-resident grid.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
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
    const int32_t* class_rows;  // [n]
    uint32_t* end;              // [2, n+1, W] scratch
    int32_t* work;              // [Rp + 2] zeroed: dsend sums, accepted, flag
    long long n;
    long long W;
    int dmax;
    int chi;
    int Rp;
    int target_sum;
    int chunk_steps;
    int stop_on_first;
    uint32_t seed;
    float inv_n;
    unsigned long long* trace;  // [trace_steps, 4] or null: phase timestamps
    int trace_steps;
};

template <typename T>
__device__ __forceinline__ T ld_cg(const T* p) { return __ldcg(p); }

// block 0's thread 0 stamps the global timer (ns) at a phase boundary of
// the first trace_steps class steps of the chunk: [start, A, B, C]
__device__ __forceinline__ void stamp(const Params& p, int k, int slot)
{
    if (p.trace == nullptr || k >= p.trace_steps || blockIdx.x != 0
        || threadIdx.x != 0)
        return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.trace[4 * k + slot] = t;
}

__device__ __forceinline__ uint8_t ld_cg_u8(const uint8_t* p)
{
    return *reinterpret_cast<const volatile uint8_t*>(p);
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

// the LUT application of graphdyn/ops/lut.py:lut_one_step for one word
template <int NP>
__device__ __forceinline__ uint32_t lut_select(const uint32_t (&planes)[NP],
                                               uint32_t x, const uint32_t* lut,
                                               long long row, long long n1,
                                               int dmax)
{
    uint32_t out = 0u;
    for (int cnt = 0; cnt <= dmax; ++cnt) {
        uint32_t eq = 0xFFFFFFFFu;
#pragma unroll
        for (int k = 0; k < NP; ++k)
            eq &= ((cnt >> k) & 1) ? planes[k] : ~planes[k];
        const uint32_t m0 = __ldg(lut + (2 * (long long)cnt) * n1 + row);
        const uint32_t m1 = __ldg(lut + (2 * (long long)cnt + 1) * n1 + row);
        out |= eq & ((x & m1) | (~x & m0));
    }
    return out;
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

// block 0: the loop condition of _fused_cond_body, from the state as it is
__device__ void write_go(const Params& p, int steps_now, int steps0,
                         bool any_active, bool any_hit)
{
    const bool go = any_active && (steps_now - steps0 < p.chunk_steps)
                    && !(p.stop_on_first && any_hit);
    p.work[p.Rp + 1] = go ? 1 : 0;
}

template <int NP, int NB>
__global__ void __launch_bounds__(kThreads)
fused_anneal_kernel(Params p)
{
    // when Rp <= kSmemReplicas, phase B stages a, b and active and sums dsend
    // in shared memory, bit-major (entry bit*W + w for replica 32w + bit),
    // so a warp's 32 words touch 32 consecutive entries: no bank conflicts
    extern __shared__ int32_t smem[];
    int32_t* s_dsend = smem;                                   // [Rp]
    float* s_a = reinterpret_cast<float*>(smem + p.Rp);        // [Rp]
    float* s_b = s_a + p.Rp;                                   // [Rp]
    uint8_t* s_act = reinterpret_cast<uint8_t*>(s_b + p.Rp);   // [Rp]
    __shared__ uint32_t smem_count;
    cg::grid_group grid = cg::this_grid();
    const long long n = p.n, W = p.W, n1 = p.n + 1;
    const int Rp = p.Rp;
    const bool use_smem = Rp <= kSmemReplicas;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    int32_t* acc_dsend = p.work;
    uint32_t* acc_count = reinterpret_cast<uint32_t*>(p.work + Rp);
    const int32_t* go_flag = p.work + Rp + 1;
    uint32_t* end0 = p.end;
    uint32_t* end1 = p.end + n1 * W;
    const int steps0 = ld_cg(p.steps);

    if (blockIdx.x == 0) {
        bool act = false, hit = false;
        for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
            act |= ld_cg_u8(p.active + r) != 0;
            hit |= ld_cg(p.t_target + r) >= 0;
        }
        act = __syncthreads_or(act);
        hit = __syncthreads_or(hit);
        if (threadIdx.x == 0) write_go(p, steps0, steps0, act, hit);
    }
    grid.sync();

    while (ld_cg(go_flag)) {
        const int step = ld_cg(p.steps);
        const int c = step % p.chi;
        stamp(p, step - steps0, 0);
        const uint32_t* mask_c = p.masks + (long long)c * n1;

        // ---- phase A: end(s) and end(s ^ class) for every row ----------
        for (long long i = tid; i < n1 * W; i += nthreads) {
            const long long row = i / W;
            const long long w = i - row * W;
            if (row == n) {
                end0[i] = 0u;
                end1[i] = 0u;
                continue;
            }
            const int32_t* nb = p.nbr_ext + row * p.dmax;
            uint32_t pl0[NP], pl1[NP];
#pragma unroll
            for (int k = 0; k < NP; ++k) pl0[k] = pl1[k] = 0u;
            for (int j = 0; j < p.dmax; ++j) {
                const long long node = __ldg(nb + j);
                const uint32_t x = ld_cg(p.sp + node * W + w);
                csa_add<NP>(pl0, x);
                csa_add<NP>(pl1, x ^ __ldg(mask_c + node));
            }
            const uint32_t own = ld_cg(p.sp + i);
            end0[i] = lut_select<NP>(pl0, own, p.lut, row, n1, p.dmax);
            end1[i] = lut_select<NP>(pl1, own ^ __ldg(mask_c + row), p.lut,
                                     row, n1, p.dmax);
        }
        grid.sync();
        stamp(p, step - steps0, 1);

        // ---- phase B: accepts of the class rows --------------------------
        if (use_smem) {
            for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
                const int j = (r & 31) * (int)W + (r >> 5);
                s_dsend[j] = 0;
                s_a[j] = ld_cg(p.a + r);
                s_b[j] = ld_cg(p.b + r);
                s_act[j] = ld_cg_u8(p.active + r);
            }
        }
        if (threadIdx.x == 0) smem_count = 0u;
        __syncthreads();
        const int lo = __ldg(p.class_ptr + c), hi = __ldg(p.class_ptr + c + 1);
        const long long items = (long long)(hi - lo) * W;
        for (long long i = tid; i < items; i += nthreads) {
            const long long k = i / W;
            const long long w = i - k * W;
            const long long row = __ldg(p.class_rows + lo + k);
            const int32_t* ns = p.nbr_self + row * (p.dmax + 1);
            uint32_t up[NB], dn[NB];
#pragma unroll
            for (int q = 0; q < NB; ++q) up[q] = dn[q] = 0u;
            for (int j = 0; j <= p.dmax; ++j) {
                const long long node = __ldg(ns + j);
                const uint32_t e = ld_cg(end0 + node * W + w);
                const uint32_t ea = ld_cg(end1 + node * W + w);
                csa_add<NB>(up, ea & ~e);
                csa_add<NB>(dn, e & ~ea);
            }
            const uint32_t own = ld_cg(p.sp + row * W + w);
            uint32_t flips = 0u;
            for (int r2 = 0; r2 < 32; r2 += 2) {
                const int pair = (int)(w * 16) + r2 / 2;
                uint32_t y[2];
                threefry2x32(p.seed, kStreamTag + (uint32_t)pair,
                             (uint32_t)step, (uint32_t)row, y[0], y[1]);
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int bit = r2 + q;
                    const int R = (int)(w * 32) + bit;
                    const int j = bit * (int)W + (int)w;
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
                    const float u = (float)(y[q] >> 8) * 5.9604644775390625e-08f;
                    if (u < expf(-de)) {
                        flips |= 1u << bit;
                        if (dsend != 0) {
                            if (use_smem) atomicAdd(s_dsend + j, dsend);
                            else atomicAdd(acc_dsend + R, dsend);
                        }
                    }
                }
            }
            if (flips) {
                p.sp[row * W + w] = own ^ flips;
                atomicAdd(&smem_count, (uint32_t)__popc(flips));
            }
        }
        __syncthreads();
        if (use_smem) {
            for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
                const int v = s_dsend[(r & 31) * (int)W + (r >> 5)];
                if (v != 0) atomicAdd(acc_dsend + r, v);
            }
        }
        if (threadIdx.x == 0 && smem_count != 0u)
            atomicAdd(acc_count, smem_count);
        grid.sync();
        stamp(p, step - steps0, 2);

        // ---- phase C: per-replica bookkeeping (block 0) --------------------
        if (blockIdx.x == 0) {
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
                *p.accepted = (int32_t)((uint32_t)ld_cg(p.accepted)
                                        + ld_cg(acc_count));
                *acc_count = 0u;
                write_go(p, step + 1, steps0, any_act, any_hit);
            }
        }
        grid.sync();
        stamp(p, step - steps0, 3);
    }
}

using KernelFn = void (*)(Params);

KernelFn pick(int np, int nb)
{
#define GRAPHDYN_FUSED_CASE(A, B) \
    if (np == A && nb == B) return fused_anneal_kernel<A, B>;
    GRAPHDYN_FUSED_CASE(1, 1) GRAPHDYN_FUSED_CASE(1, 2)
    GRAPHDYN_FUSED_CASE(2, 2) GRAPHDYN_FUSED_CASE(2, 3)
    GRAPHDYN_FUSED_CASE(3, 3) GRAPHDYN_FUSED_CASE(3, 4)
    GRAPHDYN_FUSED_CASE(4, 4) GRAPHDYN_FUSED_CASE(4, 5)
    GRAPHDYN_FUSED_CASE(5, 5) GRAPHDYN_FUSED_CASE(5, 6)
    GRAPHDYN_FUSED_CASE(6, 6) GRAPHDYN_FUSED_CASE(6, 7)
#undef GRAPHDYN_FUSED_CASE
    return nullptr;
}

int bit_length(int v)
{
    int b = 0;
    while (v > 0) { ++b; v >>= 1; }
    return b;
}

size_t smem_bytes(int Rp)
{
    return Rp <= kSmemReplicas ? 13 * (size_t)Rp : 0;
}

// the co-resident grid of the kernel for this dmax and Rp: blocks per SM
// (occupancy) and the SM count of the current device
cudaError_t grid_info(int dmax, int Rp, KernelFn* fn, int* per_sm, int* sms)
{
    const int np = bit_length(dmax) > 0 ? bit_length(dmax) : 1;
    *fn = pick(np, bit_length(dmax + 1));
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
    void* end, void* work,
    long long n, long long W, int dmax, int chi, int target_sum,
    int chunk_steps, int stop_on_first, unsigned int seed, float inv_n,
    void* trace, int trace_steps, int* grid_blocks, void* stream)
{
    if (n < 1 || n >= 2147483647LL || W < 1 || dmax < 1 || dmax > 63 || chi < 1
        || W * 32 > (1 << 30))
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
    p.end = static_cast<uint32_t*>(end);
    p.work = static_cast<int32_t*>(work);
    p.n = n;
    p.W = W;
    p.dmax = dmax;
    p.chi = chi;
    p.Rp = (int)(W * 32);
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
    // no more blocks than phase A (the widest phase) has work for
    const long long want = ((n + 1) * W + kThreads - 1) / kThreads;
    const long long cap = (long long)per_sm * sms;
    const int blocks = (int)(want < cap ? want : cap);
    *grid_blocks = blocks;
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel((const void*)fn, dim3(blocks),
                                      dim3(kThreads), args, smem_bytes(p.Rp),
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
