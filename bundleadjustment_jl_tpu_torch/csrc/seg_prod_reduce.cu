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
// deterministic, a camera without rows gives exact zeros. The camera
// products are K2's (cam_prod.cuh); their kernel, ba_launch_cam_prod,
// reads the camera-sorted copy where K2 reads point-order tiles. The TPU
// kernel's sequential grid and VMEM accumulator have no counterpart.
//
// Bound: each product reads its rows once: 32 B a row for jtj_pnt, 80 B
// for jtj_cam, 108 B of W (54 B stored as bf16 / f16, w_store.cuh) plus a
// gathered 24 B of Hpp_inv for wcw_cam (147 MB of f32 W at Dubrovnik-356);
// ~170 FMA a row for the 9x9 products.
#include "cam_prod.cuh"

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
extern "C" int ba_jtj_cam_reduce(const float* JR_cam, const int* cam_perm,
                                 const int* cam_starts, int ncams,
                                 long long n, float* out, void* stream) {
  return ba_launch_cam_prod<ProdCam90>(
      BaRows<float>{JR_cam, n, nullptr, nullptr, nullptr}, cam_perm,
      cam_starts, ncams, out, stream);
}

// W_cam (27, n) camera-sorted, in storage w_dtype; hpp_inv (npnts, 9);
// out (ncams, 81).
extern "C" int ba_wcw_cam_reduce(const void* W_cam, int w_dtype,
                                 const int* pnt_idx, const int* cam_perm,
                                 const int* cam_starts, const float* hpp_inv,
                                 int ncams, long long n, float* out,
                                 void* stream) {
  return ba_with_w_rows(W_cam, w_dtype, n, pnt_idx, hpp_inv, nullptr,
                        [&](auto in) {
                          return ba_launch_cam_prod<ProdWcw81>(
                              in, cam_perm, cam_starts, ncams, out, stream);
                        });
}
