// Kernel K5: segment sums of the 9x3 W blocks against a gathered vector,
// in both directions.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_seg_reduce_kernel` (dispatched by `_seg_block_reduce`) as reached by
//
//   wtv_point_reduce: out_p = sign * Hpp_inv_p (sum_{k in p} W_k' v[cam_k]
//                     + add_p), the fold and add optional   -> (npnts, 3)
//   wt_cam_reduce:    out_c = sum_{cam_k = c} W_k t[pnt_k]    -> (ncams, 9)
//                     over the camera-sorted W
//
// The camera-sorted route's two-pass Schur matvec is the point direction
// with the fold, then the camera direction; back-substitution is the
// point direction with add = g_p and sign = -1; the reduced right-hand
// side and the |J d|^2 cross term are the camera direction.
//
// Design. Point direction: one thread per point over its contiguous
// point-sorted rows, v[cam_k] an indexed load (ba_wtv_point, shared with
// K3's point pass). Camera direction: one block per camera strides over
// its camera-sorted columns of W (coalesced), t[pnt_k] an indexed load
// through pnt_idx[cam_perm[j]], then a fixed-order block sum: no atomics,
// deterministic, a camera without rows gives exact zeros: K2's W op
// product (cam_prod.cuh) over the camera-sorted copy instead of through
// cam_perm. The TPU kernel's camera table, its pre-gathered (16, n)
// operand and the (8, n) handoff layout have no counterpart.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; operands and sums are float.
//
// Bound: each direction streams W once, 108 B a row in f32, 54 B in bf16 /
// f16 (147 / 73 MB at Dubrovnik-356, n = 1,360,384), plus 4-8 B of
// indices; ~54 FMA a row.
// The point direction's stride-(rows per point) loads are uncoalesced.
#include "cam_prod.cuh"
#include "wtv_point.cuh"

namespace {

template <class T>
__global__ void ba_wtv_point_kernel(
    const T* __restrict__ W, const float* __restrict__ v,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_starts,
    const float* __restrict__ hpp_inv, const float* __restrict__ add,
    float sign, int npnts, long long n, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npnts) return;
  ba_wtv_point(p, W, v, cam_idx, pnt_starts, hpp_inv, add, sign, n, out);
}

}  // namespace

// W (27, n) point-sorted, in storage w_dtype; v (ncams, 9); hpp_inv
// (npnts, 9) or null; add (npnts, 3) or null; out (npnts, 3).
extern "C" int ba_wtv_point_reduce(const void* W, int w_dtype,
                                   const float* v, const int* cam_idx,
                                   const int* pnt_starts,
                                   const float* hpp_inv, const float* add,
                                   float sign, int npnts, long long n,
                                   float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    if (npnts > 0) {
      ba_wtv_point_kernel<T>
          <<<(npnts + BA_BLOCK - 1) / BA_BLOCK, BA_BLOCK, 0, s>>>(
              static_cast<const T*>(W), v, cam_idx, pnt_starts, hpp_inv, add,
              sign, npnts, n, out);
      BA_RETURN_IF_LAUNCH_FAILED();
    }
    return 0;
  });
}

// W_cam (27, n) camera-sorted, in storage w_dtype; t (npnts, 3); out
// (ncams, 9).
extern "C" int ba_wt_cam_reduce(const void* W_cam, int w_dtype,
                                const float* t, const int* pnt_idx,
                                const int* cam_perm, const int* cam_starts,
                                int ncams, long long n, float* out,
                                void* stream) {
  return ba_launch_w_prod<false, ProdWOp>(W_cam, w_dtype, cam_perm,
                                          cam_starts, ncams, out, stream,
                                          pnt_idx, t, n);
}
