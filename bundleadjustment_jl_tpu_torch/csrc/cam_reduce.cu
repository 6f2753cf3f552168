// Kernel K2: per-camera sums of a per-row product over the POINT-sorted
// rows, read through cam_perm — four products.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_cam_scatter_kernel` as dispatched by `cam_scatter_reduce`, with each
// product it is given:
//
//   wcw_rhs (`_prod_wcw_rhs`): [sum W C W' (81) | sum W t (9)], C the
//           damped Hpp_inv of the row's point, t = Hpp_inv g_p: the exact
//           Schur diagonal and the reduced right-hand side in one pass
//                                                             -> (ncams, 90)
//   w_op    (`_prod_w_op`):   sum W op[pnt]: the reduced right-hand side,
//           the two-pass matvec's camera pass and the |J d|^2 cross term
//           when there is no camera-sorted W                  -> (ncams, 9)
//   wcw     (`_prod_wcw`):    sum W C W': the Schur diagonal   -> (ncams, 81)
//   cam90   (`_prod_cam90`):  [Jc'Jc (81) | Jc'r (9)] over JR: [Hcc | g_c]
//           of the split assembly                             -> (ncams, 90)
//
// Design (cam_prod.cuh): one block per camera walks its rows through
// cam_perm / cam_starts, each thread keeps its sums in registers (45 upper
// triangle + 9 for the d90 products), then a fixed-order block sum. No
// atomics, no camera table, so no bound on the camera count. K6's camera
// products are the same template over a camera-sorted copy.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; sums are float.
//
// Bound: reads each row's W (108 B in f32, 54 B in bf16 / f16) or Jc + r
// (80 B) once, gathered by cam_perm, so each of a row's planes is a
// scattered 4 or 2 B load (147 MB of f32 W at Dubrovnik-356, 1.0 GB at
// Final-4585), plus the row's point operand (12-48 B, cached); ~250 FMA a
// row for the 9x9 products, 27 for w_op.
// The gathers, not the arithmetic, bound it: the camera-sorted K6 / K5
// read the same bytes coalesced.
#include "cam_prod.cuh"

// W (27, n) planes in storage w_dtype; hpp_inv (npnts, 9); t (npnts, 3);
// out (ncams, 90).
extern "C" int ba_cam_reduce_wcw_rhs(const void* W, int w_dtype,
                                     const int* pnt_idx, const int* cam_perm,
                                     const int* cam_starts,
                                     const float* hpp_inv, const float* t,
                                     int ncams, long long n, float* out,
                                     void* stream) {
  return ba_launch_w_prod<true, ProdWcwRhs>(W, w_dtype, cam_perm, cam_starts,
                                            ncams, out, stream, pnt_idx,
                                            hpp_inv, t, n);
}

// W (27, n) in storage w_dtype; op (npnts, 3); out (ncams, 9).
extern "C" int ba_cam_reduce_w_op(const void* W, int w_dtype,
                                  const int* pnt_idx, const int* cam_perm,
                                  const int* cam_starts, const float* op,
                                  int ncams, long long n, float* out,
                                  void* stream) {
  return ba_launch_w_prod<true, ProdWOp>(W, w_dtype, cam_perm, cam_starts,
                                         ncams, out, stream, pnt_idx, op, n);
}

// W (27, n) in storage w_dtype; hpp_inv (npnts, 9); out (ncams, 81).
extern "C" int ba_cam_reduce_wcw(const void* W, int w_dtype,
                                 const int* pnt_idx, const int* cam_perm,
                                 const int* cam_starts, const float* hpp_inv,
                                 int ncams, long long n, float* out,
                                 void* stream) {
  return ba_launch_w_prod<true, ProdWcw81>(W, w_dtype, cam_perm, cam_starts,
                                           ncams, out, stream, pnt_idx,
                                           hpp_inv, n);
}

// JR (26, n) point-sorted; out (ncams, 90).
extern "C" int ba_cam_reduce_cam90(const float* JR, const int* cam_perm,
                                   const int* cam_starts, int ncams,
                                   long long n, float* out, void* stream) {
  return ba_launch_cam_prod<true>(ProdCam90{JR, n}, cam_perm, cam_starts,
                                  ncams, out, stream);
}
