// Culling prep for the chunk sweep (kernels K3, K2 and K4).
//
// Replaces radarays_ros_tpu/trace/pallas_trace.py:_coarse_kernel (K3,
// launched at :615 in _coarse_bitmap), :_prep_kernel_hier (K2, launched
// at :673-709 in _run_prep_kernel) and :_prep_kernel (K4, the flat prep for
// scenes under 256 supergroups, launched at :714-742). All slab-test rays
// against boxes with the reference's _slab_keep (:466-485; slab.cuh, which
// K1's box gate shares): per axis t0/t1 = (lo/hi - o) / dir, t_near =
// max_k min(t0, t1), t_far = min_k max(t0, t1), tn0 = max(t_near, 0),
// keep = t_far >= tn0 and t_near <= cap and cap > 0 with cap = min(t_max,
// budget).
//
//  * K3 rr_coarse_words: one flag per (ray tile, supergroup of 32 chunks) —
//    does any lane of the tile keep the supergroup's AABB? — packed into
//    int32 words, bit s of word w for supergroup 32w + s (bit 31 is the
//    sign bit). CTAs of 128 lanes, each covering all of its lanes'
//    supergroups: the supergroup box table staged in shared memory as
//    float4, in slices of up to 1,536 supergroups (48 KB; the main path's
//    128 take one, and a larger table is walked slice by slice, so any
//    size launches), each ray loaded once, a 32-bit mask of one word's
//    keeps per thread, one __reduce_or_sync per word and warp, and a global
//    atomicOr into the tile's word (zeroed by the entry point before the
//    launch; OR is order-free, so the words are exact). A warp never spans
//    two tiles (the tile is a multiple of 32 lanes), so the tile stays the
//    reference's unit of a word and K2 reads the words unchanged. On the
//    main path (80 tiles of 1024 lanes) that is 640 CTAs, one wave on 132
//    SMs.
//  * K2 rr_prep_hier: the (ray tile, set supergroup) pairs run in
//    parallel across the card, one CTA each (256 threads, up to 4 lanes a
//    thread), each slab-testing its lanes against the supergroup's 32 chunk
//    boxes (staged in shared memory); a CTA whose coarse bit is unset exits
//    at once. A chunk's block entry is the min over the lanes that keep it
//    of tn0 (+inf when none): a thread min over its lanes, a warp min, a
//    shared atomicMin, then one global atomicMin per chunk into the block's
//    entry row, which the caller pre-fills with +inf. Entries are >= +0 or
//    +inf, so the int order of their bits is the float order and the min is
//    exact in any order (tn0 is canonicalized to +0, never -0). t_last of a
//    lane is the max tn0 over the chunks it keeps (-inf when none), folded
//    over the supergroups by a global atomicMax on the int bits into a row
//    the caller pre-fills with -inf: its bits are negative and every tn0's
//    are >= 0, so that max too is exact in any order. Results do not depend
//    on the tile width or on the order the CTAs run in.
//  * K4 rr_prep_flat: every lane of a ray block against every box, with no
//    coarse gate, one thread-block cluster per ray block. The block's
//    tiles (at most 8, the portable cluster size) are the cluster's CTAs
//    of 128 threads, 2 lanes a thread (a 256-lane tile). Each CTA stages
//    the box table (at most 1,024 boxes, float4 in shared memory) and walks
//    it 8 boxes at a time: 16 independent slab tests a thread, then one
//    __reduce_min_sync (redux.sync) a box on the int bits of tn0 (entries
//    are >= +0 or +inf, so int order is float order), the 8 warp minima
//    gathered into lanes 0-7 and folded into the CTA's row by one shared
//    atomicMin instruction. A CTA whose tile has more lanes takes it in
//    passes (blocks of more than 8 tiles: the tile grows and each thread
//    takes more lanes, so the cluster stays portable). Trials on the card
//    (PERF.md) put this shape ahead of 256 threads of one lane, of 64
//    threads of 4, of one 1,024-thread CTA a block, of groups of 16 boxes
//    and of per-warp rows in plain stores. After cluster.sync() the CTAs
//    split the boxes, and each folds its share over the cluster's rows
//    through distributed shared memory (map_shared_rank) and writes the
//    block's entries with plain stores: every element once, no pre-fill,
//    no global atomics. A second
//    cluster.sync() keeps each CTA's row alive until its peers have read
//    it. t_last is one plain store a lane. The reference writes per-tile
//    partials and takes their min in XLA (:741); the min is exact in any
//    order, so the values are the same.
//
// What bounds it on the card: f32 operations, ~20 per tested (lane, box)
// pair (6 sub+mul, the min/max chain, the keep test); rays, boxes and the
// outputs are a few MB. The coarse pass gates K2 to the supergroups a tile
// can reach, as on the TPU, so K2's work is (set bits x 32 x lanes) tests.
// The earlier K2 ran one CTA of 1024 lanes per tile (80 CTAs on the main
// path, on 80 of 132 SMs) looping serially over the set bits with two
// block barriers each; the pairs now fill the card. The flat prep K4 runs
// only where the whole table is small (40 boxes on the 10k frames: 3.3 M
// slab tests, ~1 us of f32 work at the published rate), so its launch,
// staging and cluster barriers weigh as much as its tests; it keeps them
// to one launch, one staged table and two cluster barriers a block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "slab.cuh"

// K3's supergroups staged in shared memory at a time (48 KB of float4 lo
// and hi: no opt-in to a larger block)
#define RR_COARSE_SLICE 1536
// K4: threads a CTA at most, lanes a thread per pass, boxes a group
#define RR_FLAT_THREADS 128
#define RR_FLAT_LANES 2
#define RR_FLAT_GROUP 8

namespace {

// K3: 128 threads a CTA, one lane each, n_lanes / 128 CTAs (rounded up);
// dynamic shared memory: a slice of up to RR_COARSE_SLICE supergroups,
// float4 lo, then float4 hi; the table is walked slice by slice
__global__ void __launch_bounds__(128)
coarse_words_kernel(const float* __restrict__ slo,
                    const float* __restrict__ shi, int n_super,
                    const float* __restrict__ o,
                    const float* __restrict__ idv,
                    const float* __restrict__ bud, long long n_lanes,
                    int rbt, float t_max, int* __restrict__ words) {
  extern __shared__ float4 sm_box4[];
  const int slice = min(n_super, RR_COARSE_SLICE);
  float4* s_lo = sm_box4;
  float4* s_hi = sm_box4 + slice;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < n_lanes;         // whole warps: n_lanes % 32 == 0
  // a lane past the last tile keeps no box (cap 0), so its warp ORs nothing
  Ray ray = load_ray(o, idv, bud, live ? r : 0, t_max);
  if (!live) ray.cap = 0.f;
  int* wrow = words + (live ? r / rbt : 0) * (n_super >> 5);
  for (int s0 = 0; s0 < n_super; s0 += slice) {
    const int m = min(n_super - s0, slice);       // a multiple of 32
    __syncthreads();                    // every warp is done with the last
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float* l = slo + 3 * (long long)(s0 + i);
      const float* h = shi + 3 * (long long)(s0 + i);
      s_lo[i] = make_float4(l[0], l[1], l[2], 0.f);
      s_hi[i] = make_float4(h[0], h[1], h[2], 0.f);
    }
    __syncthreads();
    for (int w = 0; w < m >> 5; ++w) {
      unsigned int mask = 0u;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const float4 l4 = s_lo[w * 32 + s], h4 = s_hi[w * 32 + s];
        const float lo[3] = {l4.x, l4.y, l4.z}, hi[3] = {h4.x, h4.y, h4.z};
        float tn0;
        if (slab_keep(lo, hi, ray, &tn0)) mask |= 1u << s;
      }
      mask = __reduce_or_sync(0xffffffffu, mask);
      if ((threadIdx.x & 31) == 0 && mask)
        atomicOr(&wrow[(s0 >> 5) + w], (int)mask);
    }
  }
}

// K2: grid (n_tiles, n_super): one CTA per (ray tile, supergroup) pair,
// which exits at once when the tile's coarse bit for the supergroup is
// unset; nt = rbt / RPT threads, RPT lanes each
template <int RPT>
__global__ void __launch_bounds__(256)
prep_hier_kernel(const int* __restrict__ words, int n_words,
                 const float* __restrict__ lo, const float* __restrict__ hi,
                 int cp, const float* __restrict__ o,
                 const float* __restrict__ idv, const float* __restrict__ bud,
                 int rbt, int tiles_per_block, float t_max,
                 float* __restrict__ entry, float* __restrict__ t_last) {
  __shared__ int sm_entry[32];
  __shared__ float sm_box[2 * 3 * 32];   // the supergroup's 32 lo, then hi
  const int g = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int nt = blockDim.x;
  const unsigned int word =
      (unsigned int)words[(long long)g * n_words + (s >> 5)];
  if (!((word >> (s & 31)) & 1u)) return;     // CTA-uniform
  const int inf_bits = __float_as_int(CUDART_INF_F);
  if (tid < 32) sm_entry[tid] = inf_bits;
  if (tid < 96) {
    sm_box[tid] = lo[(long long)s * 96 + tid];
    sm_box[96 + tid] = hi[(long long)s * 96 + tid];
  }
  Ray ray[RPT];
  float tl[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    ray[j] = load_ray(o, idv, bud, (long long)g * rbt + j * nt + tid, t_max);
    tl[j] = -CUDART_INF_F;
  }
  __syncthreads();
  for (int c = 0; c < 32; ++c) {
    float m = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float tn0;
      if (slab_keep(sm_box + 3 * c, sm_box + 96 + 3 * c, ray[j], &tn0)) {
        tl[j] = fmaxf(tl[j], tn0);
        m = fminf(m, tn0);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0 && m < CUDART_INF_F)
      atomicMin(&sm_entry[c], __float_as_int(m));
  }
  __syncthreads();
  if (tid < 32) {
    const int v = sm_entry[tid];
    int* entry_row = reinterpret_cast<int*>(entry) +
                     (long long)(g / tiles_per_block) * cp;
    if (v != inf_bits) atomicMin(&entry_row[s * 32 + tid], v);
  }
  // t_last folds in over the supergroups by an int max on the float's
  // bits: the caller pre-fills -inf (negative bits), every tn0 is >= +0
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if (tl[j] > -CUDART_INF_F)
      atomicMax(reinterpret_cast<int*>(t_last) + (long long)g * rbt +
                    j * nt + tid,
                __float_as_int(tl[j]));
}

// K4: grid (n_tiles) in clusters of tiles_per_block CTAs, one cluster per
// ray block; a CTA's rbt lanes in passes of blockDim.x * RR_FLAT_LANES;
// dynamic shared memory: the cp boxes as float4 lo, then hi, then the
// CTA's cp int entries
__global__ void __launch_bounds__(RR_FLAT_THREADS)
prep_flat_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                 int cp, const float* __restrict__ o,
                 const float* __restrict__ idv, const float* __restrict__ bud,
                 int rbt, int tiles_per_block, float t_max,
                 float* __restrict__ entry, float* __restrict__ t_last) {
  namespace cg = cooperative_groups;
  extern __shared__ float4 sm_flat[];
  float4* s_lo = sm_flat;
  float4* s_hi = sm_flat + cp;
  int* s_entry = reinterpret_cast<int*>(sm_flat + 2 * cp);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int inf_bits = __float_as_int(CUDART_INF_F);
  for (int i = tid; i < cp; i += nt) {
    s_lo[i] = make_float4(lo[3 * i], lo[3 * i + 1], lo[3 * i + 2], 0.f);
    s_hi[i] = make_float4(hi[3 * i], hi[3 * i + 1], hi[3 * i + 2], 0.f);
    s_entry[i] = inf_bits;
  }
  __syncthreads();
  const long long first = (long long)blockIdx.x * rbt;
  for (int p0 = 0; p0 < rbt; p0 += nt * RR_FLAT_LANES) {
    Ray ray[RR_FLAT_LANES];
    float tl[RR_FLAT_LANES];
#pragma unroll
    for (int j = 0; j < RR_FLAT_LANES; ++j) {
      // a thread past the tile's last lane keeps no box (cap 0) and
      // stores nothing, but takes part in its warp's reductions
      const int i = p0 + j * nt + tid;
      ray[j] = load_ray(o, idv, bud, first + (i < rbt ? i : 0), t_max);
      if (i >= rbt) ray[j].cap = 0.f;
      tl[j] = -CUDART_INF_F;
    }
    for (int c0 = 0; c0 < cp; c0 += RR_FLAT_GROUP) {
      int mine = inf_bits;          // lane u: the warp's min for box c0 + u
#pragma unroll
      for (int u = 0; u < RR_FLAT_GROUP; ++u) {
        // past the last box the group repeats it: the same keep and tn0,
        // so t_last is unchanged, and its min is never folded in
        const float4 l4 = s_lo[min(c0 + u, cp - 1)];
        const float4 h4 = s_hi[min(c0 + u, cp - 1)];
        const float bl[3] = {l4.x, l4.y, l4.z}, bh[3] = {h4.x, h4.y, h4.z};
        int m = inf_bits;
#pragma unroll
        for (int j = 0; j < RR_FLAT_LANES; ++j) {
          float tn0;
          if (slab_keep(bl, bh, ray[j], &tn0)) {
            tl[j] = fmaxf(tl[j], tn0);
            m = min(m, __float_as_int(tn0));
          }
        }
        m = __reduce_min_sync(0xffffffffu, m);
        if (lane == u) mine = m;
      }
      if (lane < RR_FLAT_GROUP && c0 + lane < cp && mine != inf_bits)
        atomicMin(&s_entry[c0 + lane], mine);
    }
#pragma unroll
    for (int j = 0; j < RR_FLAT_LANES; ++j) {
      const int i = p0 + j * nt + tid;
      if (i < rbt) t_last[first + i] = tl[j];
    }
  }
  cluster.sync();             // every CTA's row is complete and visible
  const int q = (int)cluster.block_rank();
  float* entry_row = entry + (long long)(blockIdx.x / tiles_per_block) * cp;
  for (int c = q + tid * tiles_per_block; c < cp;
       c += nt * tiles_per_block) {
    int v = inf_bits;
    for (int r = 0; r < tiles_per_block; ++r)
      v = min(v, cluster.map_shared_rank(s_entry, r)[c]);
    entry_row[c] = __int_as_float(v);
  }
  cluster.sync();             // no CTA's row goes while a peer reads it
}

}  // namespace

// slo/shi (n_super, 3) supergroup boxes, n_super % 32 == 0; o/idv
// (G*rbt, 3); bud (G*rbt,). Output words (G, n_super / 32) int32, zeroed
// here and then folded into by atomicOr.
extern "C" int rr_coarse_words(const float* slo, const float* shi,
                               int n_super, const float* o, const float* idv,
                               const float* bud, int n_tiles, int rbt,
                               float t_max, int* words, cudaStream_t stream) {
  if (n_super % 32 != 0 || rbt % 32 != 0 || rbt < 32)
    return (int)cudaErrorInvalidValue;
  const int n_words = n_super / 32;
  if (n_tiles == 0 || n_words == 0) return cudaSuccess;
  const cudaError_t e = cudaMemsetAsync(
      words, 0, (size_t)n_tiles * n_words * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(n_super < RR_COARSE_SLICE ? n_super
                                                         : RR_COARSE_SLICE) *
                      2 * sizeof(float4);
  const long long n_lanes = (long long)n_tiles * rbt;
  coarse_words_kernel<<<(unsigned)((n_lanes + 127) / 128), 128, smem,
                        stream>>>(slo, shi, n_super, o, idv, bud, n_lanes,
                                  rbt, t_max, words);
  return (int)cudaGetLastError();
}

// words (G, n_words); lo/hi (cp, 3) chunk boxes, every supergroup with a
// set bit complete (32 * (s + 1) <= cp); o/idv/bud per lane; G = B * I
// tiles, I = tiles_per_block. entry (B, cp) must be pre-filled with +inf
// and t_last (G * rbt,) with -inf; both are folded into by atomics.
extern "C" int rr_prep_hier(const int* words, int n_words, const float* lo,
                            const float* hi, int cp, const float* o,
                            const float* idv, const float* bud, int n_tiles,
                            int rbt, int tiles_per_block, float t_max,
                            float* entry, float* t_last, cudaStream_t stream) {
  if (rbt % 128 != 0 || rbt > 1024 || tiles_per_block < 1 || n_words > 2047)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0 || n_words == 0) return cudaSuccess;
  const int nt = rbt < 256 ? rbt : 256;
  const dim3 grid(n_tiles, n_words * 32);
#define RR_PREP_HIER_CASE(R)                                                \
  case R:                                                                   \
    prep_hier_kernel<R><<<grid, nt, 0, stream>>>(                           \
        words, n_words, lo, hi, cp, o, idv, bud, rbt, tiles_per_block,      \
        t_max, entry, t_last);                                              \
    break;
  switch (rbt / nt) {
    RR_PREP_HIER_CASE(1)
    RR_PREP_HIER_CASE(2)
    RR_PREP_HIER_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RR_PREP_HIER_CASE
  return (int)cudaGetLastError();
}

// lo/hi (cp, 3) boxes, cp <= 1024 (the table lives in shared memory);
// o/idv/bud per lane; G = B * I tiles of rbt lanes (a multiple of 32), I =
// tiles_per_block <= 8 CTAs a cluster, one cluster per ray block. Writes
// every element of entry (B, cp) and t_last (G * rbt,): neither needs a
// fill. A refused launch (cluster, grid or shared memory) comes back as
// the error.
extern "C" int rr_prep_flat(const float* lo, const float* hi, int cp,
                            const float* o, const float* idv,
                            const float* bud, int n_tiles, int rbt,
                            int tiles_per_block, float t_max, float* entry,
                            float* t_last, cudaStream_t stream) {
  if (rbt % 32 != 0 || rbt < 32 || tiles_per_block < 1 ||
      tiles_per_block > 8 || n_tiles % tiles_per_block != 0 || cp < 1 ||
      cp > 1024)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return cudaSuccess;
  // threads: the tile's lanes over RR_FLAT_LANES, in whole warps, at most
  // RR_FLAT_THREADS (a wider tile takes several passes)
  const int per = (rbt + RR_FLAT_LANES - 1) / RR_FLAT_LANES;
  const int nt = per < RR_FLAT_THREADS ? (per + 31) / 32 * 32
                                       : RR_FLAT_THREADS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_tiles);
  cfg.blockDim = dim3((unsigned)nt);
  cfg.dynamicSmemBytes = (size_t)cp * (2 * sizeof(float4) + sizeof(int));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)tiles_per_block;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, prep_flat_kernel, lo, hi, cp, o, idv, bud,
                         rbt, tiles_per_block, t_max, entry, t_last);
  const cudaError_t last = cudaGetLastError();   // and clear it
  return (int)(e != cudaSuccess ? e : last);
}
