// Kernel K3: the Schur coupling product over W, in two passes.
//
// Replaces the TPU kernels `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_mv_scatter_kernel` / `_mv_scatter_fac_kernel` (dispatched by
// `matvec_cam_scatter`):
//
//   t_p   = sign * Hpp_inv_p (sum_{k in p} W_k' v[cam_k] + g_p)
//   out_c = sum_{cam_k = c} W_k t[pnt_k]
//
// With g_p = 0, sign = +1 this is the W Hpp_inv W' v term of S v; with
// g_p, sign = -1, t is the back-substituted point step dp and out the
// |J d|^2 cross term's camera sums.
//
// Design. Point pass: one thread per point walks its contiguous rows and
// writes t_p (12 B a point). Camera pass: one block per camera walks its
// rows through cam_perm / cam_starts and block-reduces 9 sums — no atomics,
// deterministic, no bound on the camera count. The TPU kernel keeps a
// tile's W in VMEM between the two directions; here W is read once per
// pass.
//
// Bound: streams W twice, 2 x 108 B a row = 294 MB per product at
// Dubrovnik-356 (n = 1,360,384); the camera pass's loads are gathered by
// cam_perm. ~54 FMA a row.
#include "chain.cuh"

namespace {

__global__ void ba_matvec_point_kernel(
    const float* __restrict__ W, const float* __restrict__ v,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_starts,
    const float* __restrict__ hpp_inv, const float* __restrict__ gp,
    float sign, int npnts, long long n, float* __restrict__ t) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npnts) return;
  float s[3] = {0.f, 0.f, 0.f};
  const int end = pnt_starts[p + 1];
  for (int row = pnt_starts[p]; row < end; ++row) {
    const float* vc = v + 9 * cam_idx[row];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 9; ++a) acc += W[(3 * a + b) * n + row] * vc[a];
      s[b] += acc;
    }
  }
  if (gp != nullptr) {
    s[0] += gp[3 * p];
    s[1] += gp[3 * p + 1];
    s[2] += gp[3 * p + 2];
  }
  const float* h = hpp_inv + 9 * (size_t)p;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    t[3 * p + a] =
        sign * (h[3 * a] * s[0] + h[3 * a + 1] * s[1] + h[3 * a + 2] * s[2]);
}

__global__ void __launch_bounds__(BA_BLOCK) ba_matvec_camera_kernel(
    const float* __restrict__ W, const int* __restrict__ pnt_idx,
    const int* __restrict__ cam_perm, const int* __restrict__ cam_starts,
    const float* __restrict__ t, long long n, float* __restrict__ out) {
  const int c = blockIdx.x;
  float acc[9];
#pragma unroll
  for (int a = 0; a < 9; ++a) acc[a] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK) {
    const int row = cam_perm[j];
    const int p = pnt_idx[row];
    const float tp[3] = {t[3 * p], t[3 * p + 1], t[3 * p + 2]};
#pragma unroll
    for (int a = 0; a < 9; ++a)
      acc[a] += W[(3 * a) * n + row] * tp[0] +
                W[(3 * a + 1) * n + row] * tp[1] +
                W[(3 * a + 2) * n + row] * tp[2];
  }
  ba_block_sum<9>(acc, out + 9 * (size_t)c);
}

}  // namespace

// W (27, n) planes; v (ncams, 9); hpp_inv (npnts, 9); gp (npnts, 3) or
// null; t (npnts, 3) out; out (ncams, 9).
extern "C" int ba_matvec(const float* W, const float* v, const int* cam_idx,
                         const int* pnt_idx, const int* pnt_starts,
                         const int* cam_perm, const int* cam_starts,
                         const float* hpp_inv, const float* gp, float sign,
                         int ncams, int npnts, long long n, float* t,
                         float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npnts > 0) {
    ba_matvec_point_kernel<<<(npnts + BA_BLOCK - 1) / BA_BLOCK, BA_BLOCK, 0,
                             s>>>(W, v, cam_idx, pnt_starts, hpp_inv, gp,
                                  sign, npnts, n, t);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  ba_matvec_camera_kernel<<<ncams, BA_BLOCK, 0, s>>>(W, pnt_idx, cam_perm,
                                                     cam_starts, t, n, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
