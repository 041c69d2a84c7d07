// Ranked chunk sweep with early termination, a per-lane box gate and winner
// fetch (kernel K1).
//
// Replaces radarays_ros_tpu/trace/pallas_trace.py:_trace_kernel_v3 (the
// Pallas TPU kernel launched at :879-920). The lanes of a ray block walk
// the block's ranked supergroups front to back (order/entry from the
// culling prep, trace/cuda_trace.py), intersect every triangle of a
// visited chunk that the gate keeps, keep each lane's nearest t and
// winner, and then fetch the winner's 16-float record by its global index.
//
// What bounds it on the card: f32 operations. One (ray, triangle) test is
// ~56 multiplies and adds (the plane distance, the three edge numerators
// and the min chain of _chunk_t), against the published 67 TFLOP/s. The
// least work is, per lane, the chunks its own slab test keeps with an
// entry <= min(best_t, t_last), times the chunk's triangles. The
// -fmad=false build (kept for bit-equality with the plain version) issues
// every multiply and add as an instruction of its own, so this kernel can
// reach at most half of that rate.
//
// Design, against what held the block-per-CTA version back:
//  1. Occupancy and balance: the lanes of a block are split over CTAs of
//     128 threads that walk the SAME ranked list of their block (the
//     block's entries are a min over its lanes, so the list does not
//     depend on which CTA holds which lane). Each lane's rows are split in
//     turn over P threads (P row slices, P in {1, 2, 4, 8}, a template
//     argument): thread t serves lane t / P and slice t % P, so a CTA holds
//     128 / P lanes and a 2048-ray block is 16 P CTAs. The wrapper picks P
//     from the launch's shape (trace/cuda_trace.py:_sweep_split): the
//     largest P whose CTAs the card still holds at once (5 an SM by shared
//     memory). At batch 4 or more, 640 and more CTAs already fill the card
//     and P = 1; one frame's 10 blocks make 160 CTAs of 4 warps on 132
//     SMs, where the warps' chains of dependent rounded operations have
//     nothing to hide their latency behind, and P = 4 puts 640 there.
//     Slice s tests the row pairs j with j % P == s: a warp's float4 reads
//     of P consecutive pairs (44 floats apart) fall in disjoint banks.
//     After a stage, the P slices of a lane merge by __shfl_xor_sync (least
//     t, then lowest row) and the merged winner replaces the lane's best
//     only on a strict `<`: the sequential rule below, so every P gives
//     the same winner.
//  2. Termination per warp (every decision is warp-uniform), that is per
//     aligned group of 32 / P consecutive lanes: a group stops once the
//     next ranked entry exceeds max over its lanes of min(best_t, t_last),
//     and is not started when the first entry already does; a CTA stops
//     when all its groups have. This is the reference's exactness argument
//     (pallas_trace.py:112-120) applied per lane; the block-wide rule is
//     the same argument at 2048 lanes. A finer group visits no chunk a
//     coarser one skips; only a lane with no hit within its budget can see
//     its (beyond-budget) result move with the group, and the trace counts
//     those as misses. Lanes that keep no chunk (budget 0: padding and
//     dead waves) have t_last = -inf and never hold a group.
//  3. The division t = -so/sd is computed only where the inside test
//     passes (the hit needs both), not for every (ray, triangle) pair; the
//     inside tests of two rows run branch-free first, so their chains
//     interleave, then the divisions in row order.
//  4. The box gate: a block's ranked list is the union of its 2,048
//     lanes' chunks (a wedge of ~41 beams), while a warp holds 32 / P
//     samples of one beam. A lane needs stage s (chunk c = its supergroup's
//     sub-chunk) when its own slab test keeps c's box (slab.cuh, the
//     prep's test on the scene's chunk boxes, with the lane's 1/d and cap
//     = min(t_max, budget)) with an entry tn0 <= its best_t: its nearest
//     hit within budget lies in a chunk it keeps, entered before that hit,
//     and a chunk entered beyond best_t cannot hold a nearer one. A warp
//     tests the stage only if one of its lanes needs it (__any_sync, on
//     the current best_t), else skips the tests and the wait on its copy.
//     The gate changes which stages a warp tests, not how far it walks
//     (note 2); results move only on lanes with no hit within budget. The
//     prep's t_last is left out of the gate: at group 1 keep already
//     implies tn0 <= t_last, and at group > 1 t_last is a supergroup's
//     entry, which a sub-chunk's own entry may pass.
//  5. Staging overlaps compute: each stage (one chunk's tc x 22 f32
//     coefficients, contiguous, 16-byte aligned for even tc) arrives by a
//     TMA 1-D bulk copy (cp.async.bulk) into one of two shared buffers,
//     completing on an mbarrier; the next copy is in flight while the
//     current stage is tested. A stage that no warp of the CTA needs is
//     not copied: the CTA decides stage s + 1 at the barrier that ends
//     stage s - 1 (an OR of the warps' votes, each on its lanes' best_t
//     then, which only falls, so the vote keeps every stage a warp can
//     need later), and thread 0 issues the copy at the start of stage s.
//     Copies, buffers and barrier phases count the copies issued, not the
//     stages. Thread 0 waits for a buffer's previous copy before reusing
//     it, and for every copy it started before the CTA exits, early
//     termination included.
//  Kept: rows are tested in order and a lane updates only on a strict `<`
//  (the reference's tie-break: earliest visited chunk, then lowest row);
//  every product and sum is rounded separately (__fmul_rn/__fadd_rn and the
//  -fmad=false build) in the operation order of _sweep_plain, with
//  NaN-propagating mins, so kernel and plain version agree bit for bit; the
//  winner record is loaded by index after the sweep (a select, never an
//  accumulation, so duplicate visits cannot change it).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "slab.cuh"

namespace {

constexpr int kCoef = 22;     // floats per triangle: n, c, A_0..2, B_0..2
constexpr int kFetch = 16;    // floats per winner record
constexpr int kLanes = 128;    // lanes (threads) per CTA
constexpr int kWarps = kLanes / 32;
static_assert(kWarps == 4, "cta_vote reads the warps' votes as one int4");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ((a0*b0 + a1*b1) + a2*b2), each op rounded
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// ---- mbarrier and TMA bulk copy (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the one arrival of a phase, announcing `bytes` of transfer
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` contiguous (16-byte aligned, multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Lane {
  float ox, oy, oz, dx, dy, dz, wx, wy, wz, bt, tl;
  int bi;
};

// NaN-propagating min (PTX min.NaN, sm_80+), as torch.minimum; the sign
// of a zero result cannot change the inside test below
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the inside test of one (ray, triangle) pair, q = the triangle's 22
// coefficients: min_k(N_k * sd) + eps * sd^2 >= 0 (false on NaN); sets the
// plane terms so (signed origin distance) and sd (direction cosine)
__device__ __forceinline__ bool inside(const float* q, const Lane& r,
                                       float eps, float* so, float* sd) {
  *so = add(dot3(q[0], q[1], q[2], r.ox, r.oy, r.oz), q[3]);
  *sd = dot3(q[0], q[1], q[2], r.dx, r.dy, r.dz);
  float pmin = 0.f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* A = q + 4 + 3 * e;
    const float* B = q + 13 + 3 * e;
    const float bd = dot3(B[0], B[1], B[2], r.dx, r.dy, r.dz);
    const float nk = add(add(add(bd, mul(A[0], r.wx)), mul(A[1], r.wy)),
                         mul(A[2], r.wz));
    const float p = mul(nk, *sd);
    pmin = e == 0 ? p : min_nan(pmin, p);
  }
  return add(pmin, mul(eps, mul(*sd, *sd))) >= 0.f;
}

// one row pair (rows `row` and `row` + 1 of a staged chunk) against the
// lane: the pair is read as 11 float4 (176 bytes, 16-byte aligned), its
// inside tests run branch-free, then the division t = -so/sd only where a
// test passed, rows in order; (bt, bi) take a hit nearer than bt (strict
// `<`) with bi = base + its row
__device__ __forceinline__ void test_pair(const float4* s4, int row,
                                          const Lane& ln, int base,
                                          float t_min, float eps, float& bt,
                                          int& bi) {
  float q[2 * kCoef];
#pragma unroll
  for (int i = 0; i < 2 * kCoef / 4; ++i) {
    const float4 v = s4[(row / 2) * (2 * kCoef / 4) + i];
    q[4 * i] = v.x; q[4 * i + 1] = v.y; q[4 * i + 2] = v.z;
    q[4 * i + 3] = v.w;
  }
  float so[2], sd[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    in[h] = inside(q + h * kCoef, ln, eps, &so[h], &sd[h]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (in[h]) {
      const float t = __fdiv_rn(-so[h], sd[h]);
      if (t >= t_min && t < bt) {
        bt = t;
        bi = base + row + h;
      }
    }
}

// every row of one staged chunk against the thread's lane, rows in order
__device__ __forceinline__ void test_chunk(const float* sc, int tc, Lane& ln,
                                           int tri0, float t_min, float eps) {
  const float4* s4 = reinterpret_cast<const float4*>(sc);
  for (int row = 0; row < tc; row += 2)
    test_pair(s4, row, ln, tri0, t_min, eps, ln.bt, ln.bi);
}

// the P row slices of a lane (P > 1): slice `slice` tests the row pairs j
// with j % P == slice, rows in order, into the stage's own nearest (the
// lowest row of its least t); the P slices, consecutive threads, then
// merge to the least t and on equal t the lowest row, and the merged row
// replaces the lane's best on a strict `<`, as test_chunk's sequential
// walk would. Called by the whole warp
template <int P>
__device__ __forceinline__ void test_chunk_split(const float* sc, int tc,
                                                 Lane& ln, int tri0,
                                                 float t_min, float eps,
                                                 int slice) {
  const float4* s4 = reinterpret_cast<const float4*>(sc);
  float bt = CUDART_INF_F;
  int bi = tc;
  for (int row = 2 * slice; row < tc; row += 2 * P)
    test_pair(s4, row, ln, 0, t_min, eps, bt, bi);
#pragma unroll
  for (int off = 1; off < P; off <<= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, bt, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
    if (t2 < bt || (t2 == bt && i2 < bi)) {
      bt = t2;
      bi = i2;
    }
  }
  if (bt < ln.bt) {
    ln.bt = bt;
    ln.bi = tri0 + bi;
  }
}

// should the warp's group keep sweeping? its lanes' worst min(best_t,
// t_last) against the next ranked entry (warp-uniform)
__device__ __forceinline__ bool group_continues(const Lane& r, float e_next) {
  float worst = fminf(r.bt, r.tl);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    worst = fmaxf(worst, __shfl_xor_sync(0xffffffffu, worst, off));
  return !(e_next > worst);
}

// the box of stage s: chunk ord[s / group] * group + s % group (the first
// box past the last stage, which no lane needs)
struct Box {
  float lo[3], hi[3];
};

__device__ __forceinline__ Box stage_box(const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         const int* ord, int group, int s,
                                         int n_stages) {
  const long long c =
      s < n_stages ? (long long)ord[s / group] * group + s % group : 0;
  Box bx;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bx.lo[k] = __ldg(lo + 3 * c + k);
    bx.hi[k] = __ldg(hi + 3 * c + k);
  }
  return bx;
}

// a lane's gate for one stage: its slab test of the stage's box
struct Gate {
  bool keep;
  float tn0;
};

__device__ __forceinline__ Gate gate_of(const Box& bx, const Ray& ray,
                                        bool real) {
  Gate gt;
  gt.keep = slab_keep(bx.lo, bx.hi, ray, &gt.tn0) && real;
  return gt;
}

// does a lane of the warp need the stage at its current best t?
// (warp-uniform)
__device__ __forceinline__ bool warp_needs(const Gate& gt, const Lane& ln) {
  return __any_sync(0xffffffffu, gt.keep && gt.tn0 <= ln.bt);
}

// the OR of the CTA's warp-uniform `bits`, one barrier: each warp writes
// its vote into slot `slot`, which alternates, so a slot is written again
// only after the next barrier, when every thread has read it
__device__ __forceinline__ int cta_vote(int (*votes)[kWarps], int& slot,
                                        int bits) {
  if ((threadIdx.x & 31) == 0) votes[slot][threadIdx.x >> 5] = bits;
  __syncthreads();
  const int4 v = *reinterpret_cast<const int4*>(votes[slot]);
  slot ^= 1;
  return v.x | v.y | v.z | v.w;
}

// P threads per lane (P row slices); the warp is the lane group
template <int P>
__global__ void __launch_bounds__(kLanes)
sweep_kernel(const int* __restrict__ nvisit, const int* __restrict__ order,
             const float* __restrict__ entry, int ce,
             const float* __restrict__ orig, const float* __restrict__ dir,
             const float* __restrict__ t_last,
             const float* __restrict__ coef, const float* __restrict__ fetch,
             const float* __restrict__ idv, const float* __restrict__ bud,
             const float* __restrict__ lo, const float* __restrict__ hi,
             int tc, int group, int ctas_per_block, float t_min, float t_max,
             float eps, float* __restrict__ best_t_out,
             int* __restrict__ best_idx_out, float* __restrict__ rows_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int votes[2][kWarps];
  const int stage_floats = tc * kCoef;
  float* buf = reinterpret_cast<float*>(smem);          // 2 stages
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * stage_floats * 4);
  const int b = blockIdx.x / ctas_per_block;
  const int tid = threadIdx.x;
  const long long r = (long long)blockIdx.x * (blockDim.x / P) + tid / P;

  Lane ln;
  ln.ox = orig[3 * r]; ln.oy = orig[3 * r + 1]; ln.oz = orig[3 * r + 2];
  ln.dx = dir[3 * r]; ln.dy = dir[3 * r + 1]; ln.dz = dir[3 * r + 2];
  // w = o x d, the ray line's moment
  ln.wx = __fsub_rn(mul(ln.oy, ln.dz), mul(ln.oz, ln.dy));
  ln.wy = __fsub_rn(mul(ln.oz, ln.dx), mul(ln.ox, ln.dz));
  ln.wz = __fsub_rn(mul(ln.ox, ln.dy), mul(ln.oy, ln.dx));
  ln.bt = CUDART_INF_F;
  ln.bi = -1;
  ln.tl = t_last[r];
  const Ray ray = load_ray(orig, idv, bud, r, t_max);

  const int n = nvisit[b];
  const int* ord = order + (long long)b * ce;
  const float* ent = entry + (long long)b * ce;
  const int n_stages = n * group;
  const uint32_t stage_bytes = (uint32_t)stage_floats * 4u;
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a group starts only if its lanes can reach the first ranked entry;
  // the CTA copies stages 0 and 1 if a starting warp needs them (this
  // vote also publishes the barriers)
  bool act = n > 0 && group_continues(ln, ent[0]);
  Gate cur = gate_of(stage_box(lo, hi, ord, group, 0, n_stages), ray, n > 0);
  Gate nxt = gate_of(stage_box(lo, hi, ord, group, 1, n_stages), ray,
                     1 < n_stages);
  int slot = 0;
  int vote = cta_vote(votes, slot,
                      (act ? 1 : 0) | (act && warp_needs(cur, ln) ? 2 : 0) |
                          (act && warp_needs(nxt, ln) ? 4 : 0));
  bool go = vote & 1, copy_cur = vote & 2, copy_nxt = vote & 4;

  // thread 0 issues the copies: the j-th copy goes to buffer j & 1 and
  // completes phase j >> 1 of its barrier; it first waits for the
  // buffer's copy j - 2, whose stage every thread finished before the
  // barrier that ended it
  int issued = 0;
  auto issue = [&](int s) {
    const int j = issued++;
    uint64_t* bar = &full[j & 1];
    if (j >= 2) {
      mbar_wait(bar, (uint32_t)(((j - 2) >> 1) & 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    const long long tri0 =
        ((long long)ord[s / group] * group + s % group) * tc;
    mbar_expect_tx(bar, stage_bytes);
    bulk_load(buf + (j & 1) * stage_floats, coef + tri0 * kCoef, stage_bytes,
              bar);
  };
  if (go && copy_cur && tid == 0) issue(0);

  int consumed = 0;      // copies of the stages passed (the same everywhere)
  for (int s = 0; go && s < n_stages; ++s) {
    const int k = s / group, g = s - k * group;
    if (tid == 0 && copy_nxt) issue(s + 1);
    // the box two stages ahead, loaded while this stage is tested
    const Box ahead = stage_box(lo, hi, ord, group, s + 2, n_stages);
    if (copy_cur) {
      const int j = consumed++;
      if (act && warp_needs(cur, ln)) {
        mbar_wait(&full[j & 1], (uint32_t)((j >> 1) & 1));
        const float* sc = buf + (j & 1) * stage_floats;
        const int tri0 = (ord[k] * group + g) * tc;
        if constexpr (P == 1)
          test_chunk(sc, tc, ln, tri0, t_min, eps);
        else
          test_chunk_split<P>(sc, tc, ln, tri0, t_min, eps, tid % P);
      }
    }
    if (act && g + 1 == group)
      act = k + 1 < n && group_continues(ln, ent[k + 1]);
    cur = nxt;
    nxt = gate_of(ahead, ray, s + 2 < n_stages);
    vote = cta_vote(votes, slot,
                    (act ? 1 : 0) | (act && warp_needs(nxt, ln) ? 2 : 0));
    go = vote & 1;
    copy_cur = copy_nxt;
    copy_nxt = vote & 2;
  }
  // drain: each barrier's last copy must land before the CTA's shared
  // memory is released (every earlier one was waited for before its
  // buffer was reused)
  if (tid == 0)
    for (int j = issued < 2 ? 0 : issued - 2; j < issued; ++j)
      mbar_wait(&full[j & 1], (uint32_t)((j >> 1) & 1));

  const bool live = ln.bt < CUDART_INF_F;
  if constexpr (P == 1) {
    best_t_out[r] = ln.bt;
    best_idx_out[r] = live ? ln.bi : -1;
    float4* dst = reinterpret_cast<float4*>(rows_out + r * kFetch);
    if (live) {
      const float4* s4 =
          reinterpret_cast<const float4*>(fetch + (long long)ln.bi * kFetch);
      for (int i = 0; i < kFetch / 4; ++i) dst[i] = s4[i];
    } else {
      for (int i = 0; i < kFetch / 4; ++i)
        dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    // each slice writes its 16 / P floats of the winner record
    constexpr int kPart = kFetch / P;
    const int slice = tid % P;
    if (slice == 0) {
      best_t_out[r] = ln.bt;
      best_idx_out[r] = live ? ln.bi : -1;
    }
    float2* dst =
        reinterpret_cast<float2*>(rows_out + r * kFetch + slice * kPart);
    if (live) {
      const float2* s2 = reinterpret_cast<const float2*>(
          fetch + (long long)ln.bi * kFetch + slice * kPart);
      for (int i = 0; i < kPart / 2; ++i) dst[i] = s2[i];
    } else {
      for (int i = 0; i < kPart / 2; ++i) dst[i] = make_float2(0.f, 0.f);
    }
  }
}

using Kernel = decltype(&sweep_kernel<1>);

// sweep_kernel<P> for split P in {1, 2, 4, 8}, else null
Kernel kernel_for(int split) {
  switch (split) {
    case 1: return sweep_kernel<1>;
    case 2: return sweep_kernel<2>;
    case 4: return sweep_kernel<4>;
    case 8: return sweep_kernel<8>;
    default: return nullptr;
  }
}

// the two stages and their barriers at chunk size tc, allowed to kernel k
// past the default 48 KB
cudaError_t stage_smem(Kernel k, int tc, size_t* smem) {
  *smem = (size_t)2 * tc * kCoef * sizeof(float) + 16;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// nvisit (B,) i32; order (B, ce) i32 ranked supergroups; entry (B, ce) f32
// ranked entries with +inf after the last; o, d (B*RB, 3); t_last (B*RB,);
// coef (T, 22) with a 16-byte aligned base; fetch (T, 16); the gate's
// inputs: idv (B*RB, 3) the lanes' 1/d and bud (B*RB,) their budgets (the
// prep's), lo, hi (T / tc, 3) the chunk boxes. tc even, RB a multiple of
// 128, split (P, row slices a lane) 1, 2, 4 or 8. Outputs best_t (B*RB,),
// best_idx (B*RB,) (-1 on miss), rows (B*RB, 16) (zeros on miss). A
// block's lanes go to RB * P / 128 CTAs.
extern "C" int rr_sweep(const int* nvisit, const int* order,
                        const float* entry, int ce, const float* o,
                        const float* d, const float* t_last, const float* coef,
                        const float* fetch, const float* idv,
                        const float* bud, const float* lo, const float* hi,
                        int n_blocks, int ray_block, int tc, int group,
                        float t_min, float t_max, float eps, float* best_t,
                        int* best_idx, float* rows, int split,
                        cudaStream_t stream) {
  const Kernel kernel = kernel_for(split);
  if (ray_block % 128 != 0 || tc < 2 || tc % 2 != 0 || group < 1 ||
      kernel == nullptr || (reinterpret_cast<uintptr_t>(coef) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return cudaSuccess;
  const int ctas_per_block = ray_block / kLanes * split;
  size_t smem;
  const cudaError_t e = stage_smem(kernel, tc, &smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks * ctas_per_block, kLanes, smem, stream>>>(
      nvisit, order, entry, ce, o, d, t_last, coef, fetch, idv, bud, lo, hi,
      tc, group, ctas_per_block, t_min, t_max, eps, best_t, best_idx, rows);
  return (int)cudaGetLastError();
}

// The CTAs of K1 at chunk size tc and `split` row slices a lane that one
// SM holds at once (the occupancy calculator: shared memory, registers,
// threads), on the current device.
extern "C" int rr_sweep_occupancy(int tc, int split, int* ctas_per_sm) {
  const Kernel kernel = kernel_for(split);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t e = stage_smem(kernel, tc, &smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, kLanes, smem);
}
