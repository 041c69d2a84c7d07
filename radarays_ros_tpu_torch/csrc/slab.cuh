// The reference's slab test of a ray against an axis-aligned box, shared by
// the culling prep (prep.cu: K2, K3, K4) and the sweep's per-lane box gate
// (sweep.cu: K1), so that both keep the same boxes with the same entries
// bit for bit (radarays_ros_tpu/trace/pallas_trace.py:_slab_keep, :466-485;
// its plain version is trace/cuda_trace.py:_slab_keep).
#pragma once

#include <cuda_runtime.h>

namespace {

struct Ray {
  float o[3], idv[3], cap;
};

// lane r's origin, 1/d and cap = min(t_max, budget)
__device__ __forceinline__ Ray load_ray(const float* o, const float* idv,
                                        const float* bud, long long r,
                                        float t_max) {
  Ray ray;
  for (int k = 0; k < 3; ++k) {
    ray.o[k] = o[3 * r + k];
    ray.idv[k] = idv[3 * r + k];
  }
  ray.cap = fminf(t_max, bud[r]);
  return ray;
}

// the reference's _slab_keep for one (ray, box); returns keep, sets tn0
__device__ __forceinline__ bool slab_keep(const float* lo, const float* hi,
                                          const Ray& ray, float* tn0) {
  float t_near = 0.f, t_far = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = __fmul_rn(__fsub_rn(lo[k], ray.o[k]), ray.idv[k]);
    const float t1 = __fmul_rn(__fsub_rn(hi[k], ray.o[k]), ray.idv[k]);
    const float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    t_near = k == 0 ? tn : fmaxf(t_near, tn);
    t_far = k == 0 ? tf : fminf(t_far, tf);
  }
  *tn0 = t_near > 0.f ? t_near : 0.f;
  return (t_far >= *tn0) && (t_near <= ray.cap) && (ray.cap > 0.f);
}

}  // namespace
