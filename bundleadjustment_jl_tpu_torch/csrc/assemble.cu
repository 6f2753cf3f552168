// Kernel K1: fused linearization and Gauss-Newton assembly.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_assemble.py`
// `_assemble_kernel` (dispatched by `assemble_scatter`). Per observation row
// it runs the linearization chain and writes W_k = Jc_k' Jp_k; per point it
// sums [Hpp | g_p], per camera [Hcc | g_c], and the objective 1/2 |r|^2.
//
// Design. The rows are point-sorted, so the point pass is one thread per
// point walking that point's contiguous rows (pnt_starts), accumulating
// [Hpp | g_p] in registers; no reduction across threads is needed. The
// camera-direction sums (~3.8k rows into each of 356 cameras at
// Dubrovnik-356) are done deterministically without atomics: one block per
// camera walks its rows through cam_perm / cam_starts, recomputes the
// chain for them (~300 FLOP a row) and block-reduces 45 + 9 + 1 values.
// The objective is the sum of the per-camera partials, in a fixed order.
//
// W is stored as float, bf16 or f16 (w_store.cuh; the TPU kernel's
// `out_dtype`): computed in float, rounded once at the store.
//
// Bound: the point pass writes W, 27 values = 108 B a row in f32, 54 B in
// bf16 / f16 (147 / 73 MB at Dubrovnik-356, n = 1,360,384), and reads
// ~24 B a row of problem data; the camera pass reads ~24 B a row plus a
// gathered point (12 B).
#include "chain.cuh"
#include "w_store.cuh"

namespace {

template <class T>
__global__ void ba_assemble_point_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_starts,
    int npnts, long long n, T* __restrict__ W,
    float* __restrict__ hp12) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npnts) return;
  const float X[3] = {points[3 * p], points[3 * p + 1], points[3 * p + 2]};
  float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // (00, 01, 02, 11, 12, 22)
  float g[3] = {0.f, 0.f, 0.f};
  const int end = pnt_starts[p + 1];
  for (int row = pnt_starts[p]; row < end; ++row) {
    const BaCam cam = ba_load_cam(cams + 9 * cam_idx[row]);
    float Jc[18], Jp[6], res[2];
    ba_linearize(cam, X, pt2d[2 * row], pt2d[2 * row + 1], w[row], Jc, Jp,
                 res);
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        ba_stw(W, (3 * a + b) * n + row,
               Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b]);
    int q = 0;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int e = b; e < 3; ++e)
        h[q++] += Jp[b] * Jp[e] + Jp[3 + b] * Jp[3 + e];
      g[b] += Jp[b] * res[0] + Jp[3 + b] * res[1];
    }
  }
  float* o = hp12 + 12 * (size_t)p;
  o[0] = h[0]; o[1] = h[1]; o[2] = h[2];
  o[3] = h[1]; o[4] = h[3]; o[5] = h[4];
  o[6] = h[2]; o[7] = h[4]; o[8] = h[5];
  o[9] = g[0]; o[10] = g[1]; o[11] = g[2];
}

__global__ void __launch_bounds__(BA_BLOCK) ba_assemble_camera_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ pnt_idx, const int* __restrict__ cam_perm,
    const int* __restrict__ cam_starts, float* __restrict__ hc90,
    float* __restrict__ obj_part) {
  const int c = blockIdx.x;
  const BaCam cam = ba_load_cam(cams + 9 * c);
  // 45 upper-triangle Hcc entries (ba_tri9 order), 9 g_c, 1 objective.
  float acc[55];
#pragma unroll
  for (int k = 0; k < 55; ++k) acc[k] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK) {
    const int row = cam_perm[j];
    const int p = pnt_idx[row];
    const float X[3] = {points[3 * p], points[3 * p + 1], points[3 * p + 2]};
    float Jc[18], Jp[6], res[2];
    ba_linearize(cam, X, pt2d[2 * row], pt2d[2 * row + 1], w[row], Jc, Jp,
                 res);
    int q = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a) {
#pragma unroll
      for (int d = a; d < 9; ++d)
        acc[q++] += Jc[a] * Jc[d] + Jc[9 + a] * Jc[9 + d];
      acc[45 + a] += Jc[a] * res[0] + Jc[9 + a] * res[1];
    }
    acc[54] += 0.5f * (res[0] * res[0] + res[1] * res[1]);
  }
  __shared__ float tot[55];
  ba_block_sum<55>(acc, tot);
  __syncthreads();
  for (int k = threadIdx.x; k < 90; k += BA_BLOCK) {
    float v;
    if (k < 81) {
      const int a = k / 9, d = k % 9;
      v = tot[a <= d ? ba_tri9(a, d) : ba_tri9(d, a)];
    } else {
      v = tot[45 + (k - 81)];
    }
    hc90[90 * (size_t)c + k] = v;
  }
  if (threadIdx.x == 0) obj_part[c] = tot[54];
}

}  // namespace

extern "C" const char* ba_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// W (27, n): row-major planes, W[(3a+b) n + row], storage w_dtype
// (w_store.cuh); hp12 (npnts, 12); hc90 (ncams, 90); obj_part (ncams,)
// scratch; obj (1,).
extern "C" int ba_assemble(const float* cams, const float* points,
                           const float* pt2d, const float* w,
                           const int* cam_idx, const int* pnt_idx,
                           const int* pnt_starts, const int* cam_perm,
                           const int* cam_starts, int ncams, int npnts,
                           long long n, void* W, int w_dtype, float* hp12,
                           float* hc90, float* obj_part, float* obj,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npnts > 0) {
    const int rc = ba_with_w_type(w_dtype, [&](auto tag) {
      using T = BA_W_TYPE(tag);
      ba_assemble_point_kernel<T>
          <<<(npnts + BA_BLOCK - 1) / BA_BLOCK, BA_BLOCK, 0, s>>>(
              cams, points, pt2d, w, cam_idx, pnt_starts, npnts, n,
              static_cast<T*>(W), hp12);
      BA_RETURN_IF_LAUNCH_FAILED();
      return 0;
    });
    if (rc != 0) return rc;
  }
  ba_assemble_camera_kernel<<<ncams, BA_BLOCK, 0, s>>>(
      cams, points, pt2d, w, pnt_idx, cam_perm, cam_starts, hc90, obj_part);
  BA_RETURN_IF_LAUNCH_FAILED();
  ba_sum_rows_kernel<<<1, BA_BLOCK, 0, s>>>(obj_part, ncams, obj);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
