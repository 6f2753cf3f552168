// Kernel K7: the linearization, one observation row per thread; and K8,
// its W-only form over the camera order.
//
// K7 replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_linearize.py`
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
// K8 replaces `_linearize_w_only_kernel` (dispatched by `linearize_w_only`):
// the camera-sorted W of the huge-n route with camera scatter off,
// W_cam (27, n) with column j = W of row cam_perm[j], re-linearized rather
// than permuted. The same chain on the same row gives the same values as
// K7's W[:, cam_perm]. The TPU side builds camera-sorted (16, n) operand
// copies in two half slices first; here each thread reads its row's
// camera, point, observation and weight through cam_perm itself.
//
// Design: structure-of-arrays output, so the 32 threads of a warp store
// 32 neighbouring floats of each plane; the camera and point of a row are
// gathered loads (9 + 3 floats, mostly cached). K8's row data (pt2d, w,
// the indices) are gathered through cam_perm too, its stores coalesced.
//
// W is stored as float, bf16 or f16 (w_store.cuh; the TPU kernels'
// `w_dtype`): computed in float, rounded once at the store. JR stays
// float.
//
// Bound: K7 writes 53 floats = 212 B a row in f32 (288 MB at
// Dubrovnik-356, n = 1,360,384; 158 B a row with a 2-byte W) and reads
// ~32 B of problem data; ~300 FLOP a row. K8 writes 108 B a row in f32,
// 54 B in bf16 / f16 (1.0 / 0.5 GB at Final-4585) and reads the same
// ~32 B, scattered.
#include "chain.cuh"
#include "w_store.cuh"

namespace {

template <class T>
__global__ void ba_linearize_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    long long n, float* __restrict__ JR, T* __restrict__ W) {
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
      ba_stw(W, (3 * a + b) * n + row,
             Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b]);
}

template <class T>
__global__ void ba_linearize_w_only_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    const int* __restrict__ cam_perm, long long n,
    T* __restrict__ W_cam) {
  const long long j = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (j >= n) return;
  const int row = cam_perm[j];
  const BaCam cam = ba_load_cam(cams + 9 * cam_idx[row]);
  const float* x = points + 3 * pnt_idx[row];
  const float X[3] = {x[0], x[1], x[2]};
  float Jc[18], Jp[6], res[2];
  ba_linearize(cam, X, pt2d[2 * row], pt2d[2 * row + 1], w[row], Jc, Jp,
               res);
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      ba_stw(W_cam, (3 * a + b) * n + j,
             Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b]);
}

}  // namespace

// cams (ncams, 9); points (npnts, 3); JR (26, n) and W (27, n) out, W in
// storage w_dtype (w_store.cuh).
extern "C" int ba_linearize_rows(const float* cams, const float* points,
                                 const float* pt2d, const float* w,
                                 const int* cam_idx, const int* pnt_idx,
                                 long long n, float* JR, void* W, int w_dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    ba_linearize_kernel<T><<<(unsigned)((n + BA_BLOCK - 1) / BA_BLOCK),
                             BA_BLOCK, 0, s>>>(cams, points, pt2d, w,
                                               cam_idx, pnt_idx, n, JR,
                                               static_cast<T*>(W));
    BA_RETURN_IF_LAUNCH_FAILED();
    return 0;
  });
}

// cams (ncams, 9); points (npnts, 3); W_cam (27, n) out, camera order, in
// storage w_dtype.
extern "C" int ba_linearize_w_only(const float* cams, const float* points,
                                   const float* pt2d, const float* w,
                                   const int* cam_idx, const int* pnt_idx,
                                   const int* cam_perm, long long n,
                                   void* W_cam, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    ba_linearize_w_only_kernel<T>
        <<<(unsigned)((n + BA_BLOCK - 1) / BA_BLOCK), BA_BLOCK, 0, s>>>(
            cams, points, pt2d, w, cam_idx, pnt_idx, cam_perm, n,
            static_cast<T*>(W_cam));
    BA_RETURN_IF_LAUNCH_FAILED();
    return 0;
  });
}
