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
// copies in two half slices first. Here the problem's row data come in
// camera order from a plan built once per problem (`ops/plans.py`
// CamRowPlan: pt2d[cam_perm], w[cam_perm], cam_idx[cam_perm] and
// pnt_idx[cam_perm]), so every per-row field is a coalesced read (20 B a
// row). An earlier K8 read them through cam_perm: four loads at a random
// row (a 32 B sector each for 4-8 B) behind the cam_perm load, then the
// camera and point behind those; at Final-4585 the row arrays (37-74 MB)
// miss the 50 MB L2, and it ran at 0.27 of its bound (PERF.md, K8).
//
// Design: structure-of-arrays output, so the 32 threads of a warp store
// 32 neighbouring values of each plane; the camera and point of a row are
// gathered loads (9 + 3 floats: a warp's columns are almost always one
// camera, and the points, 16 MB at Final-4585, stay in L2). A K8 thread
// takes one column: two a thread, so that a 2-byte W stores 4 B a plane,
// measured slower (PERF.md, K8).
//
// W is stored as float, bf16 or f16 (w_store.cuh; the TPU kernels'
// `w_dtype`): computed in float, rounded once at the store. JR stays
// float.
//
// Bound: K7 writes 53 floats = 212 B a row in f32 (288 MB at
// Dubrovnik-356, n = 1,360,384; 158 B a row with a 2-byte W) and reads
// ~32 B of problem data; ~300 FLOP a row. K8 writes 108 B a row in f32,
// 54 B in bf16 / f16 (1.0 / 0.5 GB at Final-4585), and reads 20 B a row
// of the plan plus the gathered camera and point: the bytes bound both.
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

// K8's row data in camera order (ops/plans.py:CamRowPlan).
struct BaCamRows {
  const float* pt2d;   // (n, 2) pt2d[cam_perm]
  const float* w;      // (n,) w[cam_perm]
  const int* cam;      // (n,) cam_idx[cam_perm]
  const int* pnt;      // (n,) pnt_idx[cam_perm]
};

// A thread per camera-order column j: the chain at its camera and point,
// its row data read coalesced.
template <class T>
__global__ void __launch_bounds__(BA_BLOCK) ba_linearize_w_only_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    BaCamRows rows, long long n, T* __restrict__ W_cam) {
  const long long j = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (j >= n) return;
  const BaCam cam = ba_load_cam(cams + 9 * rows.cam[j]);
  const float* x = points + 3 * rows.pnt[j];
  const float X[3] = {x[0], x[1], x[2]};
  const float2 o = reinterpret_cast<const float2*>(rows.pt2d)[j];
  float Jc[18], Jp[6], res[2];
  ba_linearize(cam, X, o.x, o.y, rows.w[j], Jc, Jp, res);
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

// cams (ncams, 9); points (npnts, 3); the plan's camera-order rows
// pt2d_cam (n, 2), w_cam (n,), cam_col (n,), cam_pnt (n,); W_cam (27, n)
// out, camera order, in storage w_dtype.
extern "C" int ba_linearize_w_only(const float* cams, const float* points,
                                   const float* pt2d_cam, const float* w_cam,
                                   const int* cam_col, const int* cam_pnt,
                                   long long n, void* W_cam, int w_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const BaCamRows rows{pt2d_cam, w_cam, cam_col, cam_pnt};
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    ba_linearize_w_only_kernel<T>
        <<<(unsigned)((n + BA_BLOCK - 1) / BA_BLOCK), BA_BLOCK, 0, s>>>(
            cams, points, rows, n, static_cast<T*>(W_cam));
    BA_RETURN_IF_LAUNCH_FAILED();
    return 0;
  });
}
