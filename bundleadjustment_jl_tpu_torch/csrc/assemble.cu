// Kernel K1: fused linearization and Gauss-Newton assembly.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_assemble.py`
// `_assemble_kernel` (dispatched by `assemble_scatter`, :284). Per
// observation row it runs the linearization chain and writes W_k = Jc_k'
// Jp_k; per point it sums [Hpp | g_p], per camera [Hcc | g_c], and the
// objective 1/2 |r|^2.
//
// Design, two passes over the point-sorted rows:
//
//   point pass (plan `ops/plans.py:point_blocks`): one block per ~1024-row
//     point range and one thread per row (wtv_point.cuh ba_point_walk, K5's
//     walk): the row's chain runs once, W is stored with lanes on
//     neighbouring rows (coalesced, in the storage type), and the row's
//     [Jp'Jp (6) | Jp'r (3)] goes through shared memory to its point's
//     owner thread, summed in row order (a point longer than a chunk
//     carries its sum). An earlier thread-per-point pass stored its 27 planes
//     with lanes ~6 rows apart, ~24 sectors a warp store: the stores, not
//     the bytes, bound it (bf16 W halved its time with the same stores);
//   camera pass: one block per camera walks its rows through cam_perm /
//     cam_starts, evaluates the chain for them and block-reduces 45 Hcc
//     upper + 9 g_c + 1 objective in a fixed order. Each camera's rows
//     ascend in cam_perm, so a block's gathers of pt2d, w, pnt_idx and
//     points move forward through each array. K2's point-order tiles with
//     per-run partials (55 floats a run) took 4x longer at Dubrovnik-356
//     and 3.3x at Final-4585 (PERF.md, K1), their partials alone 1.9 GB
//     a launch at Final-4585, so this pass stays.
//
// The objective is the sum of the per-camera partials in camera order. No
// atomics: deterministic, repeats bit-identical. W is stored as float,
// bf16 or f16 (w_store.cuh; the TPU kernel's `out_dtype`): computed in
// float, rounded once at the store.
//
// Bound: W written once, 108 B a row in f32, 54 B in bf16 / f16 (147 / 73
// MB at Dubrovnik-356, n = 1,360,384), the rows' problem data read once
// (~24 B a row, then ~24 B plus a point again by the camera pass); both
// passes evaluate the chain (~300 operations a row).
#include "wtv_point.cuh"

// Rows a thread of K1's point pass takes in one chunk: a chunk of 1280 rows
// holds a ~1024-row point range and most last points in one pass, and its
// nine values a row fit in 46 KB of static shared memory.
constexpr int BA_ASM_ROWS_PER_THREAD = 5;

namespace {

template <class T>
__global__ void __launch_bounds__(BA_BLOCK) ba_assemble_point_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    const int* __restrict__ pnt_starts, const int* __restrict__ block_pnts,
    long long n, T* __restrict__ W, float* __restrict__ hp12) {
  ba_point_walk<9, BA_ASM_ROWS_PER_THREAD>(
      pnt_idx, pnt_starts, block_pnts,
      [&](int row, float (&y)[9]) {
        const float* Xp = points + 3 * (size_t)pnt_idx[row];
        const float X[3] = {Xp[0], Xp[1], Xp[2]};
        const BaCam cam = ba_load_cam(cams + 9 * (size_t)cam_idx[row]);
        float Jc[18], Jp[6], res[2];
        ba_linearize(cam, X, pt2d[2 * (size_t)row], pt2d[2 * (size_t)row + 1],
                     w[row], Jc, Jp, res);
#pragma unroll
        for (int a = 0; a < 9; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            ba_stw(W, (3 * a + b) * n + row,
                   Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b]);
        int q = 0;  // Jp'Jp upper (00, 01, 02, 11, 12, 22), then Jp'r
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int e = b; e < 3; ++e)
            y[q++] = Jp[b] * Jp[e] + Jp[3 + b] * Jp[3 + e];
          y[6 + b] = Jp[b] * res[0] + Jp[3 + b] * res[1];
        }
      },
      [&](int p, float (&s)[9]) {
        float* o = hp12 + 12 * (size_t)p;
        o[0] = s[0]; o[1] = s[1]; o[2] = s[2];
        o[3] = s[1]; o[4] = s[3]; o[5] = s[4];
        o[6] = s[2]; o[7] = s[4]; o[8] = s[5];
        o[9] = s[6]; o[10] = s[7]; o[11] = s[8];
      });
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
// (w_store.cuh); block_pnts (nblocks+1,) point ranges; hp12 (npnts, 12);
// hc90 (ncams, 90); obj_part (ncams,) scratch; obj (1,).
extern "C" int ba_assemble(const float* cams, const float* points,
                           const float* pt2d, const float* w,
                           const int* cam_idx, const int* pnt_idx,
                           const int* pnt_starts, const int* block_pnts,
                           int nblocks, const int* cam_perm,
                           const int* cam_starts, int ncams, long long n,
                           void* W, int w_dtype, float* hp12, float* hc90,
                           float* obj_part, float* obj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    const int rc = ba_with_w_type(w_dtype, [&](auto tag) {
      using T = BA_W_TYPE(tag);
      ba_assemble_point_kernel<T><<<nblocks, BA_BLOCK, 0, s>>>(
          cams, points, pt2d, w, cam_idx, pnt_idx, pnt_starts, block_pnts, n,
          static_cast<T*>(W), hp12);
      BA_RETURN_IF_LAUNCH_FAILED();
      return 0;
    });
    if (rc != 0) return rc;
  }
  if (ncams > 0) {
    ba_assemble_camera_kernel<<<ncams, BA_BLOCK, 0, s>>>(
        cams, points, pt2d, w, pnt_idx, cam_perm, cam_starts, hc90,
        obj_part);
    BA_RETURN_IF_LAUNCH_FAILED();
    ba_sum_rows_kernel<<<1, BA_BLOCK, 0, s>>>(obj_part, ncams, obj);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}
