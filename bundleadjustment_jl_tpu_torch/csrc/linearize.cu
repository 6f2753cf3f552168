// Kernel K7: the linearization, one observation row per thread.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_linearize.py`
// `_linearize_kernel` (dispatched by `linearize_w_kminor`). Per row it runs
// the chain (`linearize_chain`, chain.cuh) and writes
//
//   JR (26, n): rows 0-17 Jc (9 i + a), 18-23 Jp (18 + 3 i + b),
//               24-25 the weighted residual
//   W  (27, n): row 3 a + b = sum_i Jc[9 i + a] Jp[3 i + b]
//
// the JAX package's `JR_t[:26]` and `W_t[:27]`. Padding rows (w = 0) and
// rows with z = 0 give exact zeros through the chain's `valid` factor.
//
// Design: structure-of-arrays output, so the 32 threads of a warp store
// 32 neighbouring floats of each of the 53 planes; the camera and point
// of a row are gathered loads (9 + 3 floats, mostly cached).
//
// Bound: writes 53 floats = 212 B a row (288 MB at Dubrovnik-356,
// n = 1,360,384) and reads ~32 B of problem data; ~300 FLOP a row.
#include "chain.cuh"

namespace {

__global__ void ba_linearize_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    long long n, float* __restrict__ JR, float* __restrict__ W) {
  const long long row = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (row >= n) return;
  const BaCam cam = ba_load_cam(cams + 9 * cam_idx[row]);
  const float* x = points + 3 * pnt_idx[row];
  const float X[3] = {x[0], x[1], x[2]};
  float Jc[18], Jp[6], res[2];
  ba_linearize(cam, X, pt2d[2 * row], pt2d[2 * row + 1], w[row], Jc, Jp,
               res);
#pragma unroll
  for (int k = 0; k < 18; ++k) JR[k * n + row] = Jc[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) JR[(18 + k) * n + row] = Jp[k];
  JR[24 * n + row] = res[0];
  JR[25 * n + row] = res[1];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      W[(3 * a + b) * n + row] = Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b];
}

}  // namespace

// cams (ncams, 9); points (npnts, 3); JR (26, n) and W (27, n) out.
extern "C" int ba_linearize_rows(const float* cams, const float* points,
                                 const float* pt2d, const float* w,
                                 const int* cam_idx, const int* pnt_idx,
                                 long long n, float* JR, float* W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    ba_linearize_kernel<<<(unsigned)((n + BA_BLOCK - 1) / BA_BLOCK),
                          BA_BLOCK, 0, s>>>(cams, points, pt2d, w, cam_idx,
                                            pnt_idx, n, JR, W);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}
