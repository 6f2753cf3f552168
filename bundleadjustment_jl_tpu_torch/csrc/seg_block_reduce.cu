// Kernel K5: segment sums of the 9x3 W blocks against a gathered vector,
// in both directions.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_seg_reduce_kernel` (dispatched by `_seg_block_reduce`, :647) as reached
// by
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
// Design. Point direction (wtv_point.cuh, shared with K3's point pass): one
// block per contiguous point range of ~1024 rows (plan
// `ops/plans.py:point_blocks`), one thread per row, so lanes read
// neighbouring rows and every plane load is coalesced; the rows' 3-vectors
// go through shared memory to each point's owner thread, which sums them
// in row order and folds. Camera direction: one block per camera strides
// over its camera-sorted columns of W (coalesced), t[pnt_k] an indexed load
// through pnt_idx[cam_perm[j]], then a fixed-order block sum: no atomics,
// deterministic, a camera without rows gives exact zeros (cam_prod.cuh's W
// op product over the camera-sorted copy). The TPU kernel's camera table,
// its pre-gathered (16, n) operand and the (8, n) handoff layout have no
// counterpart.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; operands and sums are float.
//
// Bound: each direction streams W once, 108 B a row in f32, 54 B in bf16 /
// f16 (147 / 73 MB at Dubrovnik-356, n = 1,360,384), plus 4-8 B of
// indices; ~54 FMA a row. Both directions now read W coalesced: the bytes
// bound them.
#include "cam_prod.cuh"
#include "wtv_point.cuh"

// W (27, n) point-sorted, in storage w_dtype; v (ncams, 9); block_pnts
// (nblocks+1,) point ranges; hpp_inv (npnts, 9) or null; add (npnts, 3) or
// null; out (npnts, 3).
extern "C" int ba_wtv_point_reduce(const void* W, int w_dtype,
                                   const float* v, const int* cam_idx,
                                   const int* pnt_idx, const int* pnt_starts,
                                   const int* block_pnts, int nblocks,
                                   const float* hpp_inv, const float* add,
                                   float sign, long long n, float* out,
                                   void* stream) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return ba_launch_wtv_point(static_cast<const T*>(W), v, cam_idx, pnt_idx,
                               pnt_starts, block_pnts, nblocks, hpp_inv, add,
                               sign, n, out, stream);
  });
}

// W_cam (27, n) camera-sorted, in storage w_dtype; t (npnts, 3); out
// (ncams, 9).
extern "C" int ba_wt_cam_reduce(const void* W_cam, int w_dtype,
                                const float* t, const int* pnt_idx,
                                const int* cam_perm, const int* cam_starts,
                                int ncams, long long n, float* out,
                                void* stream) {
  return ba_with_w_rows(W_cam, w_dtype, n, pnt_idx, t, nullptr,
                        [&](auto in) {
                          return ba_launch_cam_prod<ProdWOp>(
                              in, cam_perm, cam_starts, ncams, out, stream);
                        });
}
