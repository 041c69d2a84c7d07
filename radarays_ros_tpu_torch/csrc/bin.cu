// Signal binning with the fused denoise taps (kernel K5, forward and
// backward).
//
// Replaces radarays_ros_tpu/image/pallas_draw.py:_bin_kernel (launched by
// _bin_impl at :207) and the backward of its custom VJP, _bin_bwd
// (:111-146, XLA there). The forward bins a row's N (cell, strength)
// signals into n_cells range cells — combine "sum" (optionally followed by
// the W denoise taps img[c] += w[k] * point[c - (k - mode)]) or "max"
// clamped at >= 0. Invalid signals arrive with a cell outside
// [0, n_cells). Cell 0 is zeroed by the caller in denoise mode
// (image/draw.py).
//
// What bounds it on the card: bytes. At the KAIST preset the forward
// writes 1,600 rows x 3,424 f32 cells (21.9 MB) and reads 2.6 MB of
// signals; dense taps, 2 x 35 operations a cell, would come close behind.
// The design keeps the work to what the data needs:
//
//  * Binning in signal order, in parallel: one CTA of 128 threads per
//    (frame, azimuth) row keeps the row in shared memory, and its threads
//    stage the row's signals there too, up to 1,024 at a time (a longer
//    row is walked slice by slice, so any N launches). Warp 0 then walks
//    the staged signals 32 at a time; __match_any_sync groups the lanes
//    that share a cell and the group's lowest lane folds its peers'
//    strengths into row[c] in lane order, which is signal order, each sum
//    rounded once (__fadd_rn). That is the
//    f32 sum order of the TPU kernel (a one-hot accumulate over signals,
//    pallas_draw.py:52-58) and of the plain version; an atomicAdd would sum
//    in another order every run. Max takes fmaxf in the same order.
//  * Only the terms of touched cells: the fold marks each cell it writes
//    in a bitmask. Output c sums w[k] * point[c - k + mode] over
//    k = 0..W-1 from +0.0; a term whose point value is +-0 is +-0 (finite
//    taps), and adding +-0 leaves a nonzero sum as it is and a +0 sum at
//    +0 (a sum from +0 is never -0). So summing only the terms whose cell
//    is marked (every cell not marked holds +0), still in k order, gives
//    the bits of the dense sum, and an output whose window
//    [c - (W-1-mode), c + mode] holds no marked cell is +0. A row's
//    signals (50 cone samples of one beam on each bounce) cluster in a few
//    cells, so most windows are empty and the rest hold a few terms, not W.
//  * Strips: each thread writes 4 consecutive outputs (one 16-byte store
//    when the row is 16-byte aligned). It walks the marked cells of the
//    strip's window from the highest down, which is k order for each of
//    the 4 outputs, and adds w[k] * point to those whose window holds the
//    cell, each product and sum rounded separately (__fmul_rn/__fadd_rn,
//    -fmad=false), the order of image/draw.py:145-149.
//  * The taps travel by value in the launch's parameter block
//    (__grid_constant__), so a call copies nothing from host to device.
//
// The backward computes, per signal with a valid cell c,
// ds = sum_k w[k] * g[a, c + k - mode] (0 outside [0, n_cells)) in k order
// from 0.0, each product and sum rounded separately: the terms and order of
// _bin_bwd's adjoint correlation at the one cell it gathers, so it is
// bit-equal to it, with 2W operations a signal instead of 2W a cell and no
// (rows, n_cells) temporaries. Without taps ds = g[a, c]; for max,
// g[a, c] where s == out[a, c] (ties take all); invalid cells get 0.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <string.h>

#define RR_MAX_TAPS 256
#define RR_BIN_THREADS 128   // a row a CTA
#define RR_BIN_SLICE 1024    // signals staged in shared memory at a time

namespace {

struct Taps {
  float w[RR_MAX_TAPS];
  int n;       // 0: no taps
  int mode;
};

__device__ __forceinline__ void load_taps(const Taps& taps, float* sw) {
  for (int k = threadIdx.x; k < taps.n; k += blockDim.x) sw[k] = taps.w[k];
}

// block = RR_BIN_THREADS threads, one row; dynamic shared memory: the
// row's n_cells floats, its bitmask of touched cells, the taps, then a
// slice of up to RR_BIN_SLICE of the row's cells and strengths
__global__ void bin_kernel(const int* __restrict__ cell,
                           const float* __restrict__ s, int n, int n_cells,
                           const __grid_constant__ Taps taps,
                           int combine_max, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n_words = (n_cells + 31) >> 5;
  const int W = taps.n, mode = taps.mode;
  float* row = smem;
  unsigned* nz = reinterpret_cast<unsigned*>(smem + n_cells);
  float* sw = smem + n_cells + n_words;
  int* sc = reinterpret_cast<int*>(sw + W);
  float* ss = reinterpret_cast<float*>(sc + min(n, RR_BIN_SLICE));
  const long long a = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const float init = combine_max ? -CUDART_INF_F : 0.f;
  for (int c = tid; c < n_cells; c += nt) row[c] = init;
  for (int w = tid; w < n_words; w += nt) nz[w] = 0u;
  load_taps(taps, sw);

  for (int i0 = 0; i0 < n; i0 += RR_BIN_SLICE) {
    const int m = min(n - i0, RR_BIN_SLICE);
    __syncthreads();                    // warp 0 is done with the last slice
    for (int i = tid; i < m; i += nt) {
      sc[i] = cell[a * n + i0 + i];
      ss[i] = s[a * n + i0 + i];
    }
    __syncthreads();
    if (tid < 32) {
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int i = j0 + lane;
        int c = i < m ? sc[i] : -1;
        const float v = i < m ? ss[i] : 0.f;
        const bool ok = c >= 0 && c < n_cells;
        if (!ok) c = -1;
        const unsigned peers = __match_any_sync(0xffffffffu, c);
        const bool leader = ok && __ffs(peers) - 1 == lane;
        float acc = leader ? row[c] : 0.f;
        // fold the group's strengths into its leader, in lane order
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float sj = __shfl_sync(0xffffffffu, v, j);
          if (leader && ((peers >> j) & 1u))
            acc = combine_max ? fmaxf(acc, sj) : __fadd_rn(acc, sj);
        }
        if (leader) {
          row[c] = acc;
          atomicOr(&nz[c >> 5], 1u << (c & 31));
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  float* orow = out + a * n_cells;
  const bool vec = (n_cells & 3) == 0;
  const int n_strips = (n_cells + 3) >> 2;
  for (int st = tid; st < n_strips; st += nt) {
    const int c0 = st << 2;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
    if (W > 0) {
      // the marked cells of the strip's window, highest first: output
      // c0 + j takes cell src with tap k0 + j, k0 = c0 + mode - src
      const int lo = max(c0 - (W - 1 - mode), 0);
      const int hi = min(c0 + 3 + mode, n_cells - 1);
      for (int wd = hi >> 5; lo <= hi && wd >= lo >> 5; --wd) {
        unsigned b = nz[wd];
        if (wd == hi >> 5) b &= 0xffffffffu >> (31 - (hi & 31));
        if (wd == lo >> 5) b &= 0xffffffffu << (lo & 31);
        while (b) {
          const int bit = 31 - __clz(b);
          b ^= 1u << bit;
          const int src = (wd << 5) + bit;
          const float x = row[src];
          const int k0 = c0 + mode - src;
          if (k0 >= 0 && k0 < W) v0 = __fadd_rn(v0, __fmul_rn(sw[k0], x));
          if (k0 >= -1 && k0 < W - 1)
            v1 = __fadd_rn(v1, __fmul_rn(sw[k0 + 1], x));
          if (k0 >= -2 && k0 < W - 2)
            v2 = __fadd_rn(v2, __fmul_rn(sw[k0 + 2], x));
          if (k0 >= -3 && k0 < W - 3)
            v3 = __fadd_rn(v3, __fmul_rn(sw[k0 + 3], x));
        }
      }
    } else {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = c0 + j < n_cells ? row[c0 + j] : 0.f;
        x[j] = combine_max ? fmaxf(r, 0.f) : r;
      }
      v0 = x[0];
      v1 = x[1];
      v2 = x[2];
      v3 = x[3];
    }
    if (vec) {
      reinterpret_cast<float4*>(orow)[st] = make_float4(v0, v1, v2, v3);
    } else {
      const float v[4] = {v0, v1, v2, v3};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < n_cells) orow[c0 + j] = v[j];
    }
  }
}

// one thread per signal
__global__ void bin_bwd_kernel(const int* __restrict__ cell,
                               const float* __restrict__ s,
                               const float* __restrict__ out,
                               const float* __restrict__ g, long long total,
                               int n, int n_cells,
                               const __grid_constant__ Taps taps,
                               int combine_max, float* __restrict__ ds) {
  __shared__ float sw[RR_MAX_TAPS];
  load_taps(taps, sw);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long a = i / n;
  const int c = cell[i];
  float v = 0.f;
  if (c >= 0 && c < n_cells) {
    const float* grow = g + a * n_cells;
    if (taps.n > 0) {
      for (int k = 0; k < taps.n; ++k) {
        const int src = c + k - taps.mode;
        const float p = (src >= 0 && src < n_cells) ? grow[src] : 0.f;
        v = __fadd_rn(v, __fmul_rn(sw[k], p));
      }
    } else if (!combine_max || s[i] == out[a * n_cells + c]) {
      v = grow[c];
    }
  }
  ds[i] = v;
}

// the launch's taps from host memory w (n_taps floats; null when 0)
int make_taps(const float* w, int n_taps, int mode, Taps* taps) {
  if (n_taps < 0 || n_taps > RR_MAX_TAPS || (n_taps > 0 && w == nullptr))
    return (int)cudaErrorInvalidValue;
  memset(taps, 0, sizeof(Taps));
  if (n_taps > 0) memcpy(taps->w, w, (size_t)n_taps * sizeof(float));
  taps->n = n_taps;
  taps->mode = mode;
  return (int)cudaSuccess;
}

}  // namespace

// cell (rows, n) i32; s (rows, n) f32; w (n_taps,) f32 taps in HOST memory,
// or null with n_taps == 0; combine_max 0 = sum, 1 = max. Output out
// (rows, n_cells); the row and its bitmask live in a block's shared memory.
extern "C" int rr_bin(const int* cell, const float* s, int rows, int n,
                      int n_cells, const float* w, int n_taps, int mode,
                      int combine_max, float* out, cudaStream_t stream) {
  Taps taps;
  const int e = make_taps(w, n_taps, mode, &taps);
  if (e != cudaSuccess) return e;
  if (n_cells < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const size_t smem = ((size_t)n_cells + (n_cells + 31) / 32 + n_taps +
                       2 * (size_t)(n < RR_BIN_SLICE ? n : RR_BIN_SLICE)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t ea = cudaFuncSetAttribute(
        bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (ea != cudaSuccess) return (int)ea;
  }
  bin_kernel<<<rows, RR_BIN_THREADS, smem, stream>>>(cell, s, n, n_cells,
                                                     taps, combine_max, out);
  return (int)cudaGetLastError();
}

// The backward for the cotangent g (rows, n_cells): ds (rows, n) f32.
// out (rows, n_cells) is the forward's output (read for max only); w as
// in rr_bin.
extern "C" int rr_bin_bwd(const int* cell, const float* s, const float* out,
                          const float* g, int rows, int n, int n_cells,
                          const float* w, int n_taps, int mode,
                          int combine_max, float* ds, cudaStream_t stream) {
  Taps taps;
  const int e = make_taps(w, n_taps, mode, &taps);
  if (e != cudaSuccess) return e;
  const long long total = (long long)rows * n;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  bin_bwd_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   stream>>>(cell, s, out, g, total, n, n_cells, taps,
                             combine_max, ds);
  return (int)cudaGetLastError();
}
