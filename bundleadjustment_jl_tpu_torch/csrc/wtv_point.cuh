// Device code shared by K3's point pass (matvec.cu) and K5's point
// direction (seg_block_reduce.cu): one point's segment of the point-sorted
// rows, reduced and optionally folded with its damped inverse block,
//
//   s   = sum_{k in p} W_k' v[cam_k]  (+ add_p)
//   out = sign * Hpp_inv_p s   (sign * s when hpp_inv is null)
//
// One thread per point walks that point's contiguous rows (pnt_starts).
// W is read in its storage type T (w_store.cuh) and widened at the load.
#pragma once

#include "chain.cuh"
#include "w_store.cuh"

template <class T>
__device__ __forceinline__ void ba_wtv_point(
    int p, const T* __restrict__ W, const float* __restrict__ v,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_starts,
    const float* __restrict__ hpp_inv, const float* __restrict__ add,
    float sign, long long n, float* __restrict__ out) {
  float s[3] = {0.f, 0.f, 0.f};
  const int end = pnt_starts[p + 1];
  for (int row = pnt_starts[p]; row < end; ++row) {
    const float* vc = v + 9 * cam_idx[row];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 9; ++a)
        acc += ba_ldw(W, (3 * a + b) * n + row) * vc[a];
      s[b] += acc;
    }
  }
  if (add != nullptr) {
    s[0] += add[3 * p];
    s[1] += add[3 * p + 1];
    s[2] += add[3 * p + 2];
  }
  if (hpp_inv == nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * p + a] = sign * s[a];
    return;
  }
  const float* h = hpp_inv + 9 * (size_t)p;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    out[3 * p + a] =
        sign * (h[3 * a] * s[0] + h[3 * a + 1] * s[1] + h[3 * a + 2] * s[2]);
}
