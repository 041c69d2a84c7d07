// Ranked chunk sweep with early termination and winner fetch (kernel K1).
//
// Replaces radarays_ros_tpu/trace/pallas_trace.py:_trace_kernel_v3 (the
// Pallas TPU kernel launched at :879-920). One CUDA block per ray block:
// the block walks its ranked supergroups front to back (order/entry from
// the culling prep, trace/cuda_trace.py), intersects every triangle of a
// visited chunk with every ray, keeps each ray's nearest t and winner, and
// stops once the next ranked entry exceeds max_lanes min(best_t, t_last)
// (the exactness argument is in the reference kernel's docstring). It then
// fetches the winner's 16-float record by its global index.
//
// What bounds it on the card: f32 arithmetic. Per (ray, triangle) the test
// is ~30 flops on 22 coefficients; coefficients come from shared memory as
// warp-wide broadcasts, so the inner loop issues no global loads. The TPU
// kernel turned the test into bf16 split-exact matmuls for its matrix
// unit; here it is plain f32 scalar code on the CUDA cores, which is the
// exact arithmetic the plain torch version (_sweep_plain) does.
//
// Design:
//  * each visited chunk's 256 x 22 f32 coefficients (22.5 KB) are staged
//    in shared memory once and reused by all RB rays of the block; each
//    thread owns RPT rays (RB = 2048 -> 512 threads x 4 rays) in registers;
//  * rows are tested in order and a ray updates only on a strict `<`, which
//    is the reference's tie-break (earliest visited chunk, then lowest row);
//  * termination is a block max-reduction after every visit, read only
//    after a __syncthreads, so no thread reads it before all have finished
//    the visit; entry[] carries a +inf sentinel after the last ranked entry;
//  * the winner record is loaded directly by index after the sweep (a
//    select, never an accumulation, so duplicate visits cannot change it);
//  * every product and sum is rounded separately (__fmul_rn/__fadd_rn and
//    the -fmad=false build), in the operation order of _sweep_plain, so
//    the kernel and its plain version agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCoef = 22;     // floats per triangle: n, c, A_0..2, B_0..2
constexpr int kFetch = 16;    // floats per winner record

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// torch.minimum semantics: NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// ((a0*b0 + a1*b1) + a2*b2), each op rounded
__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

template <int RPT>
__global__ void __launch_bounds__(512)
sweep_kernel(const int* __restrict__ nvisit, const int* __restrict__ order,
             const float* __restrict__ entry, int ce,
             const float* __restrict__ orig, const float* __restrict__ dir,
             const float* __restrict__ t_last,
             const float* __restrict__ coef, const float* __restrict__ fetch,
             int tc, int group, float t_min, float eps,
             float* __restrict__ best_t_out, int* __restrict__ best_idx_out,
             float* __restrict__ rows_out) {
  extern __shared__ float smem[];
  float* sc = smem;                  // tc * kCoef staged coefficients
  float* red = smem + tc * kCoef;    // 32 warp partials + the block result
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const long long ray0 = (long long)b * nt * RPT;

  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT];
  float wx[RPT], wy[RPT], wz[RPT], bt[RPT], tl[RPT];
  int bi[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const long long r = ray0 + tid + j * nt;
    ox[j] = orig[3 * r]; oy[j] = orig[3 * r + 1]; oz[j] = orig[3 * r + 2];
    dx[j] = dir[3 * r]; dy[j] = dir[3 * r + 1]; dz[j] = dir[3 * r + 2];
    // w = o x d, the ray line's moment
    wx[j] = __fsub_rn(mul(oy[j], dz[j]), mul(oz[j], dy[j]));
    wy[j] = __fsub_rn(mul(oz[j], dx[j]), mul(ox[j], dz[j]));
    wz[j] = __fsub_rn(mul(ox[j], dy[j]), mul(oy[j], dx[j]));
    bt[j] = CUDART_INF_F;
    bi[j] = -1;
    tl[j] = t_last[r];
  }

  const int n = nvisit[b];
  for (int k = 0; k < n; ++k) {
    const int c = order[(long long)b * ce + k];
    for (int g = 0; g < group; ++g) {
      const long long tri0 = (long long)(c * group + g) * tc;
      const float* src = coef + tri0 * kCoef;
      __syncthreads();   // every thread is done with the previous chunk
      for (int i = tid; i < tc * kCoef; i += nt) sc[i] = src[i];
      __syncthreads();
      for (int row = 0; row < tc; ++row) {
        const float* q = sc + row * kCoef;
        const float n0 = q[0], n1 = q[1], n2 = q[2], cc = q[3];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float so = add(dot3(n0, n1, n2, ox[j], oy[j], oz[j]), cc);
          const float sd = dot3(n0, n1, n2, dx[j], dy[j], dz[j]);
          float pmin = 0.f;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float* A = q + 4 + 3 * e;
            const float* B = q + 13 + 3 * e;
            const float bd = dot3(B[0], B[1], B[2], dx[j], dy[j], dz[j]);
            const float nk = add(add(add(bd, mul(A[0], wx[j])),
                                     mul(A[1], wy[j])), mul(A[2], wz[j]));
            const float p = mul(nk, sd);
            pmin = e == 0 ? p : nan_min(pmin, p);
          }
          const float t = __fdiv_rn(-so, sd);
          const float meps = mul(eps, mul(sd, sd));
          const bool hit = (add(pmin, meps) >= 0.f) && (t >= t_min);
          if (hit && t < bt[j]) {
            bt[j] = t;
            bi[j] = (int)(tri0 + row);
          }
        }
      }
    }
    // early termination: ranked entries are non-decreasing, so the block
    // stops once the next entry exceeds every lane's min(best_t, t_last)
    float worst = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < RPT; ++j) worst = fmaxf(worst, fminf(bt[j], tl[j]));
    for (int off = 16; off > 0; off >>= 1)
      worst = fmaxf(worst, __shfl_xor_sync(0xffffffffu, worst, off));
    if ((tid & 31) == 0) red[tid >> 5] = worst;
    __syncthreads();
    if (tid == 0) {
      float m = red[0];
      for (int i = 1; i < nt / 32; ++i) m = fmaxf(m, red[i]);
      red[32] = m;
    }
    __syncthreads();
    if (entry[(long long)b * ce + k + 1] > red[32]) break;   // block-uniform
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const long long r = ray0 + tid + j * nt;
    const bool live = bt[j] < CUDART_INF_F;
    best_t_out[r] = bt[j];
    best_idx_out[r] = live ? bi[j] : -1;
    float4* dst = reinterpret_cast<float4*>(rows_out + r * kFetch);
    if (live) {
      const float4* s4 =
          reinterpret_cast<const float4*>(fetch + (long long)bi[j] * kFetch);
      for (int i = 0; i < kFetch / 4; ++i) dst[i] = s4[i];
    } else {
      for (int i = 0; i < kFetch / 4; ++i)
        dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int RPT>
cudaError_t launch(int n_blocks, int nt, size_t smem, cudaStream_t stream,
                   const int* nvisit, const int* order, const float* entry,
                   int ce, const float* o, const float* d, const float* t_last,
                   const float* coef, const float* fetch, int tc, int group,
                   float t_min, float eps, float* best_t, int* best_idx,
                   float* rows) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  sweep_kernel<RPT><<<n_blocks, nt, smem, stream>>>(
      nvisit, order, entry, ce, o, d, t_last, coef, fetch, tc, group, t_min,
      eps, best_t, best_idx, rows);
  return cudaGetLastError();
}

}  // namespace

// nvisit (B,) i32; order (B, ce) i32 ranked supergroups; entry (B, ce) f32
// ranked entries with +inf after the last; o, d (B*RB, 3); t_last (B*RB,);
// coef (T, 22); fetch (T, 16). Outputs best_t (B*RB,), best_idx (B*RB,)
// (-1 on miss), rows (B*RB, 16) (zeros on miss).
extern "C" int rr_sweep(const int* nvisit, const int* order,
                        const float* entry, int ce, const float* o,
                        const float* d, const float* t_last, const float* coef,
                        const float* fetch, int n_blocks, int ray_block,
                        int tc, int group, float t_min, float eps,
                        float* best_t, int* best_idx, float* rows,
                        cudaStream_t stream) {
  const size_t smem = ((size_t)tc * kCoef + 33) * sizeof(float);
  if (n_blocks == 0) return cudaSuccess;
  for (int rpt = 1; rpt <= 8; rpt *= 2) {
    const int nt = ray_block / rpt;
    if (ray_block % rpt != 0 || nt > 512 || nt % 32 != 0) continue;
#define RR_SWEEP_CASE(R)                                                     \
  case R:                                                                    \
    return (int)launch<R>(n_blocks, nt, smem, stream, nvisit, order, entry,  \
                          ce, o, d, t_last, coef, fetch, tc, group, t_min,   \
                          eps, best_t, best_idx, rows);
    switch (rpt) {
      RR_SWEEP_CASE(1)
      RR_SWEEP_CASE(2)
      RR_SWEEP_CASE(4)
      RR_SWEEP_CASE(8)
    }
#undef RR_SWEEP_CASE
  }
  return (int)cudaErrorInvalidValue;
}
