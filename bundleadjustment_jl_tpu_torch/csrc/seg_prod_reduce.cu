// Kernel K6: segment sums of a per-row product, three products.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_prod_reduce_kernel` (dispatched by `seg_prod_reduce`) with the products
// the camera-sorted route runs:
//
//   jtj_pnt  (`_prod_pnt12`): [Jp'Jp (9) | Jp'r (3)] per point over the
//            point-sorted JR rows                          -> (npnts, 12)
//   jtj_cam  (`_prod_cam90`): [Jc'Jc (81) | Jc'r (9)] per camera over the
//            camera-sorted JR rows                         -> (ncams, 90)
//   wcw_cam  (`_prod_wcw`):   sum W C W' (81) per camera over the
//            camera-sorted W rows, C = Hpp_inv[pnt_k]       -> (ncams, 81)
//
// JR is (26, n) structure-of-arrays: rows 0-17 Jc (9 i + a), 18-23 Jp
// (18 + 3 i + b), 24-25 r; W is (27, n), row 3 a + b.
//
// Design. Point segments hold a few rows (~6 at Dubrovnik-356), so one
// thread per point walks its contiguous rows and sums in registers. Camera
// segments hold thousands, so one block per camera strides over its rows
// (neighbouring threads on neighbouring columns: coalesced), keeps the 45
// upper-triangle sums of the symmetric 9x9 (plus 9 for Jc'r) in
// registers, and reduces them in a fixed order (ba_block_sum): no atomics,
// deterministic, a camera without rows gives exact zeros. The TPU kernel's
// sequential grid and VMEM accumulator have no counterpart.
//
// Bound: each product reads its rows once: 32 B a row for jtj_pnt, 80 B
// for jtj_cam, 108 B of W plus a gathered 24 B of Hpp_inv for wcw_cam
// (147 MB of W at Dubrovnik-356); ~170 FMA a row for the 9x9 products.
#include "chain.cuh"

namespace {

__global__ void ba_jtj_pnt_kernel(const float* __restrict__ JR,
                                  const int* __restrict__ pnt_starts,
                                  int npnts, long long n,
                                  float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npnts) return;
  float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // (00, 01, 02, 11, 12, 22)
  float g[3] = {0.f, 0.f, 0.f};
  const int end = pnt_starts[p + 1];
  for (int row = pnt_starts[p]; row < end; ++row) {
    float Jp[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) Jp[k] = JR[(18 + k) * n + row];
    const float r0 = JR[24 * n + row], r1 = JR[25 * n + row];
    int q = 0;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int e = b; e < 3; ++e)
        h[q++] += Jp[b] * Jp[e] + Jp[3 + b] * Jp[3 + e];
      g[b] += Jp[b] * r0 + Jp[3 + b] * r1;
    }
  }
  float* o = out + 12 * (size_t)p;
  o[0] = h[0]; o[1] = h[1]; o[2] = h[2];
  o[3] = h[1]; o[4] = h[3]; o[5] = h[4];
  o[6] = h[2]; o[7] = h[4]; o[8] = h[5];
  o[9] = g[0]; o[10] = g[1]; o[11] = g[2];
}

// [Jc'Jc upper (45) | Jc'r (9)] of camera-sorted column j.
struct ProdCam90 {
  static constexpr int K = 54;
  const float* JR;
  long long n;
  __device__ __forceinline__ void add(float (&acc)[K], int j) const {
    float Jc[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) Jc[k] = JR[k * n + j];
    const float r0 = JR[24 * n + j], r1 = JR[25 * n + j];
    int q = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a) {
#pragma unroll
      for (int d = a; d < 9; ++d)
        acc[q++] += Jc[a] * Jc[d] + Jc[9 + a] * Jc[9 + d];
      acc[45 + a] += Jc[a] * r0 + Jc[9 + a] * r1;
    }
  }
};

// W C W' upper (45) of camera-sorted column j, C = Hpp_inv of its point
// read as the packed upper triangle (the TPU kernel's sym6 operand).
struct ProdWcw81 {
  static constexpr int K = 45;
  const float* W;
  const int* pnt_idx;
  const int* cam_perm;
  const float* hpp_inv;
  long long n;
  __device__ __forceinline__ void add(float (&acc)[K], int j) const {
    float Wr[27];
#pragma unroll
    for (int e = 0; e < 27; ++e) Wr[e] = W[e * n + j];
    const float* h = hpp_inv + 9 * (size_t)pnt_idx[cam_perm[j]];
    const float C[3][3] = {{h[0], h[1], h[2]},
                           {h[1], h[4], h[5]},
                           {h[2], h[5], h[8]}};
    float Y[9][3];  // Y = W C
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        Y[a][cc] = Wr[3 * a] * C[0][cc] + Wr[3 * a + 1] * C[1][cc] +
                   Wr[3 * a + 2] * C[2][cc];
    int q = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a)
#pragma unroll
      for (int d = a; d < 9; ++d)
        acc[q++] += Y[a][0] * Wr[3 * d] + Y[a][1] * Wr[3 * d + 1] +
                    Y[a][2] * Wr[3 * d + 2];
  }
};

// One block per camera: out row c = [the symmetric 9x9 from the 45 upper
// sums (81) | the remaining K - 45 sums].
template <class Prod>
__global__ void __launch_bounds__(BA_BLOCK) ba_cam_prod_kernel(
    Prod prod, const int* __restrict__ cam_starts, float* __restrict__ out) {
  constexpr int K = Prod::K, D_OUT = 81 + (K - 45);
  const int c = blockIdx.x;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK)
    prod.add(acc, j);
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  for (int k = threadIdx.x; k < D_OUT; k += BA_BLOCK) {
    float v;
    if (k < 81) {
      const int a = k / 9, d = k % 9;
      v = tot[a <= d ? ba_tri9(a, d) : ba_tri9(d, a)];
    } else {
      v = tot[45 + (k - 81)];
    }
    out[D_OUT * (size_t)c + k] = v;
  }
}

}  // namespace

// JR (26, n) point-sorted; out (npnts, 12).
extern "C" int ba_jtj_pnt_reduce(const float* JR, const int* pnt_starts,
                                 int npnts, long long n, float* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npnts > 0) {
    ba_jtj_pnt_kernel<<<(npnts + BA_BLOCK - 1) / BA_BLOCK, BA_BLOCK, 0, s>>>(
        JR, pnt_starts, npnts, n, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// JR_cam (26, n) camera-sorted; out (ncams, 90).
extern "C" int ba_jtj_cam_reduce(const float* JR_cam, const int* cam_starts,
                                 int ncams, long long n, float* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncams > 0) {
    ba_cam_prod_kernel<ProdCam90><<<ncams, BA_BLOCK, 0, s>>>(
        ProdCam90{JR_cam, n}, cam_starts, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// W_cam (27, n) camera-sorted; hpp_inv (npnts, 9); out (ncams, 81).
extern "C" int ba_wcw_cam_reduce(const float* W_cam, const int* pnt_idx,
                                 const int* cam_perm, const int* cam_starts,
                                 const float* hpp_inv, int ncams, long long n,
                                 float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncams > 0) {
    ba_cam_prod_kernel<ProdWcw81><<<ncams, BA_BLOCK, 0, s>>>(
        ProdWcw81{W_cam, pnt_idx, cam_perm, hpp_inv, n}, cam_starts, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}
