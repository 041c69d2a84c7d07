// Signal binning with the fused denoise taps (kernel K5, forward).
//
// Replaces radarays_ros_tpu/image/pallas_draw.py:_bin_kernel (launched by
// _bin_impl at :207). Bins a row's N (cell, strength) signals into
// n_cells range cells — combine "sum" (optionally followed by the W
// denoise taps img[c] += w[k] * point[c - (k - mode)]) or "max" clamped at
// >= 0. Invalid signals arrive with a cell outside [0, n_cells). Cell 0 is
// zeroed by the caller in denoise mode (image/draw.py).
//
// What bounds it on the card: the serial per-row sum. One block per (frame,
// azimuth) row keeps the row's n_cells floats in shared memory (13.7 KB at
// the KAIST preset's 3424 cells); one thread accumulates the N signals in
// signal order, which is exactly the f32 summation order of the TPU kernel
// (a one-hot accumulate over signals, pallas_draw.py:52-58) and of the
// plain version — an atomicAdd would sum in another order every run. At
// N = 200 signals per row that is ~200 shared read-modify-writes. All
// threads then apply the taps in k = 0..W-1 order starting from 0.0, each
// product and sum rounded separately (__fmul_rn/__fadd_rn, -fmad=false),
// the order of image/draw.py:145-149, and write the row once.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void bin_kernel(const int* __restrict__ cell,
                           const float* __restrict__ s, int n, int n_cells,
                           const float* __restrict__ w, int n_taps, int mode,
                           int combine_max, float* __restrict__ out) {
  extern __shared__ float row[];
  const long long a = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float init = combine_max ? -CUDART_INF_F : 0.f;
  for (int c = tid; c < n_cells; c += nt) row[c] = init;
  __syncthreads();
  if (tid == 0) {
    const int* cr = cell + a * n;
    const float* sr = s + a * n;
    for (int i = 0; i < n; ++i) {
      const int c = cr[i];
      if (c < 0 || c >= n_cells) continue;
      row[c] = combine_max ? fmaxf(row[c], sr[i]) : __fadd_rn(row[c], sr[i]);
    }
  }
  __syncthreads();
  float* orow = out + a * n_cells;
  for (int c = tid; c < n_cells; c += nt) {
    float v;
    if (n_taps > 0) {
      v = 0.f;
      for (int k = 0; k < n_taps; ++k) {
        const int src = c - (k - mode);
        const float p = (src >= 0 && src < n_cells) ? row[src] : 0.f;
        v = __fadd_rn(v, __fmul_rn(w[k], p));
      }
    } else {
      v = combine_max ? fmaxf(row[c], 0.f) : row[c];
    }
    orow[c] = v;
  }
}

}  // namespace

// cell (rows, n) i32; s (rows, n) f32; w (n_taps,) f32 device taps or null
// with n_taps == 0; combine_max 0 = sum, 1 = max. Output out (rows, n_cells).
extern "C" int rr_bin(const int* cell, const float* s, int rows, int n,
                      int n_cells, const float* w, int n_taps, int mode,
                      int combine_max, float* out, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  const size_t smem = (size_t)n_cells * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bin_kernel<<<rows, 256, smem, stream>>>(cell, s, n, n_cells, w, n_taps,
                                          mode, combine_max, out);
  return (int)cudaGetLastError();
}
