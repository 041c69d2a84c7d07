// The backward of the fused material-table lookup (sim/lookup.py): the
// (M, 4) table gradient from the (n, 4) cotangents of the rows gathered at
// idx, out[m, j] = sum over i with idx[i] == m of g[i, j].
//
// Replaces no Pallas kernel: it is the card's counterpart of XLA's
// transpose of the reference's material gathers (radarays_ros_tpu/sim/
// pipeline.py:69-77, 175), a scatter-add outside any kernel there.
// PyTorch differentiates advanced indexing as index_put_(accumulate=True),
// which on CUDA sorts the indices and accumulates each run of equal ones in
// one warp: with a table of M ~ 3 rows and 10^5 indices that serialises.
// Its fast path, index_add_, sums with float atomics, in another order on
// every run.
//
// What bounds it on the card: bytes (8 B of index and 16 B of cotangent a
// row, read once; a few hundred adds a row at most). The design keeps the
// sum order fixed, so that two launches on the same inputs give the same
// bits and a plain torch version (sim/lookup.py:_table_grad_plain) gives
// them too:
//
//  * Stage 1, one CTA of 256 threads (8 warps) a slice of 1,024 rows.
//    Row q of a slice, q = e * 256 + w * 32 + l, goes to lane l of warp w
//    as its e-th row (e = 0..3): every load is coalesced. For each material
//    m, each column j, a thread takes v_e = (idx == m ? g[j] : +0) and
//    sums (v_0 + v_2) + (v_1 + v_3); the warp halves its 32 sums with
//    __shfl_down_sync (16, 8, 4, 2, 1); lane 0 keeps the warp's sum in a
//    shared-memory bin per (warp, m, j), and the bins of the 8 warps are
//    halved in turn (4, 2, 1). That is the pairwise tree of the slice along
//    e, then l, then w. A material no row of a warp holds sums to +0 there
//    (every term is +0), so the warp skips it and its bin stays +0. Padding
//    rows past n hold no material.
//  * Stage 2 (a second launch, one thread a (m, j)): the slices' partials
//    in slice order, acc = P[0] + P[1] + ... from the first, each sum
//    rounded once. No float atomics anywhere.
//
// M is capped at RR_TABLE_MAX_M (the bins of one CTA live in shared
// memory); the wrapper refuses a larger table before launch.

#include <cuda_runtime.h>

#define RR_TABLE_MAX_M 256
#define RR_TG_THREADS 256
#define RR_TG_WARPS (RR_TG_THREADS / 32)
#define RR_TG_ROWS 4                       // rows a thread holds
#define RR_TG_SLICE (RR_TG_THREADS * RR_TG_ROWS)

namespace {

// grid = ceil(n / RR_TG_SLICE) CTAs of RR_TG_THREADS; dynamic shared
// memory: RR_TG_WARPS x M x 4 floats of bins. part: (grid, M, 4).
__global__ void table_grad_kernel(const long long* __restrict__ idx,
                                  const float4* __restrict__ g, long long n,
                                  int M, float* __restrict__ part) {
  extern __shared__ float bins[];            // [warp][m][j]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * RR_TG_SLICE;
  for (int k = tid; k < RR_TG_WARPS * M * 4; k += RR_TG_THREADS)
    bins[k] = 0.f;
  long long mi[RR_TG_ROWS];
  float4 gv[RR_TG_ROWS];
#pragma unroll
  for (int e = 0; e < RR_TG_ROWS; ++e) {
    const long long q = base + e * RR_TG_THREADS + tid;
    mi[e] = q < n ? idx[q] : -1;
    gv[e] = q < n ? g[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();                           // bins zeroed
  for (int m = 0; m < M; ++m) {
    const bool h0 = mi[0] == m, h1 = mi[1] == m, h2 = mi[2] == m,
               h3 = mi[3] == m;
    if (!__any_sync(0xffffffffu, h0 || h1 || h2 || h3)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v0 = h0 ? (&gv[0].x)[j] : 0.f;
      const float v1 = h1 ? (&gv[1].x)[j] : 0.f;
      const float v2 = h2 ? (&gv[2].x)[j] : 0.f;
      const float v3 = h3 ? (&gv[3].x)[j] : 0.f;
      float x = __fadd_rn(__fadd_rn(v0, v2), __fadd_rn(v1, v3));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
      if (lane == 0) bins[(warp * M + m) * 4 + j] = x;
    }
  }
  __syncthreads();
  float* out = part + (long long)blockIdx.x * M * 4;
  const int stride = M * 4;
  for (int k = tid; k < stride; k += RR_TG_THREADS) {
    float b[RR_TG_WARPS];
#pragma unroll
    for (int w = 0; w < RR_TG_WARPS; ++w) b[w] = bins[w * stride + k];
#pragma unroll
    for (int h = RR_TG_WARPS / 2; h > 0; h >>= 1)
#pragma unroll
      for (int w = 0; w < h; ++w) b[w] = __fadd_rn(b[w], b[w + h]);
    out[k] = b[0];
  }
}

// one thread a (m, j): the slices' partials in slice order
__global__ void table_fold_kernel(const float* __restrict__ part, int slices,
                                  int width, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= width) return;
  float acc = part[k];
  for (int b = 1; b < slices; ++b)
    acc = __fadd_rn(acc, part[(long long)b * width + k]);
  out[k] = acc;
}

}  // namespace

// idx (n,) i64 (an entry outside [0, M) belongs to no row); g (n, 4) f32,
// 16-byte aligned; part (ceil(n / 1024), M, 4) f32 scratch; out (M, 4)
// f32. 0 < M <= RR_TABLE_MAX_M.
extern "C" int rr_table_grad(const long long* idx, const float* g,
                             long long n, int M, float* part, float* out,
                             cudaStream_t stream) {
  if (M < 1 || M > RR_TABLE_MAX_M || n < 0) return (int)cudaErrorInvalidValue;
  const int width = M * 4;
  if (n == 0) {
    const cudaError_t e = cudaMemsetAsync(out, 0, width * sizeof(float),
                                          stream);
    return (int)e;
  }
  const long long slices = (n + RR_TG_SLICE - 1) / RR_TG_SLICE;
  if (slices > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)RR_TG_WARPS * width * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t ea = cudaFuncSetAttribute(
        table_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (ea != cudaSuccess) return (int)ea;
  }
  table_grad_kernel<<<(unsigned)slices, RR_TG_THREADS, smem, stream>>>(
      idx, reinterpret_cast<const float4*>(g), n, M, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  table_fold_kernel<<<(width + 255) / 256, 256, 0, stream>>>(
      part, (int)slices, width, out);
  return (int)cudaGetLastError();
}
