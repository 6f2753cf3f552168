// Kernel K2: per-camera [sum W C W' (81) | sum W t (9)].
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_cam_scatter_kernel` as dispatched by `cam_scatter_reduce` with the
// product `_prod_wcw_rhs` (d_out = 90), where C_p is the damped Hpp_inv of
// the row's point and t_p = Hpp_inv_p g_p. The first 81 give the exact
// Schur diagonal (S_cc = Hcc_l - sum W C W'), the last 9 the reduced
// right-hand side (b = -g_c + sum W t).
//
// Design: one block per camera walks that camera's rows through cam_perm /
// cam_starts; each thread keeps 45 (upper triangle) + 9 sums in registers,
// then a deterministic block reduction. No atomics, no shared-memory
// camera table, so no bound on the camera count.
//
// Bound: reads W once (108 B a row, 147 MB at Dubrovnik-356) — gathered
// by cam_perm, so each row's 27 planes are scattered loads — plus the
// row's point operand (12 floats); ~250 FMA a row.
#include "chain.cuh"

namespace {

__global__ void __launch_bounds__(BA_BLOCK) ba_cam_reduce_kernel(
    const float* __restrict__ W, const int* __restrict__ pnt_idx,
    const int* __restrict__ cam_perm, const int* __restrict__ cam_starts,
    const float* __restrict__ hpp_inv, const float* __restrict__ t,
    long long n, float* __restrict__ out) {
  const int c = blockIdx.x;
  float acc[54];
#pragma unroll
  for (int k = 0; k < 54; ++k) acc[k] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK) {
    const int row = cam_perm[j];
    const int p = pnt_idx[row];
    float Wr[27];
#pragma unroll
    for (int e = 0; e < 27; ++e) Wr[e] = W[e * n + row];
    // C = Hpp_inv_p, read as its packed symmetric upper triangle.
    const float* h = hpp_inv + 9 * (size_t)p;
    const float C[3][3] = {{h[0], h[1], h[2]},
                           {h[1], h[4], h[5]},
                           {h[2], h[5], h[8]}};
    const float tp[3] = {t[3 * p], t[3 * p + 1], t[3 * p + 2]};
    float Y[9][3];  // Y = W C
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        Y[a][cc] = Wr[3 * a] * C[0][cc] + Wr[3 * a + 1] * C[1][cc] +
                   Wr[3 * a + 2] * C[2][cc];
    int q = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a) {
#pragma unroll
      for (int d = a; d < 9; ++d)
        acc[q++] += Y[a][0] * Wr[3 * d] + Y[a][1] * Wr[3 * d + 1] +
                    Y[a][2] * Wr[3 * d + 2];
      acc[45 + a] += Wr[3 * a] * tp[0] + Wr[3 * a + 1] * tp[1] +
                     Wr[3 * a + 2] * tp[2];
    }
  }
  __shared__ float tot[54];
  ba_block_sum<54>(acc, tot);
  __syncthreads();
  for (int k = threadIdx.x; k < 90; k += BA_BLOCK) {
    float v;
    if (k < 81) {
      const int a = k / 9, d = k % 9;
      v = tot[a <= d ? ba_tri9(a, d) : ba_tri9(d, a)];
    } else {
      v = tot[45 + (k - 81)];
    }
    out[90 * (size_t)c + k] = v;
  }
}

}  // namespace

// W (27, n) planes; hpp_inv (npnts, 9); t (npnts, 3); out (ncams, 90).
extern "C" int ba_cam_reduce_wcw_rhs(const float* W, const int* pnt_idx,
                                     const int* cam_perm,
                                     const int* cam_starts,
                                     const float* hpp_inv, const float* t,
                                     int ncams, long long n, float* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ba_cam_reduce_kernel<<<ncams, BA_BLOCK, 0, s>>>(
      W, pnt_idx, cam_perm, cam_starts, hpp_inv, t, n, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
