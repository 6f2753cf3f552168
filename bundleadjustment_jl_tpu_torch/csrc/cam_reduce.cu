// Kernel K2: per-camera sums of a per-row product over the POINT-sorted
// rows, read through cam_perm — four products.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_cam_scatter_kernel` as dispatched by `cam_scatter_reduce` (:1109), with
// each product it is given:
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
// Design (cam_prod.cuh, ba_launch_cam_tiles): the rows are read in point
// order, one block per tile of BA_TILE_ROWS rows, staged in shared memory
// with coalesced 16 B copies; a thread per run (one camera's rows within
// the tile) sums in registers and writes K partial sums per run (45 + 9
// for the d90 products, 45 for wcw, 9 for w_op); a second pass sums each
// camera's runs in a fixed order. No atomics, no camera table, so no bound
// on the camera count; plan `ops/plans.py:TilePlan`, built once per
// problem. R = 512 and why: cam_prod.cuh. The TPU kernel's one-hot camera
// scatter into a VMEM accumulator has no counterpart.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; sums are float.
//
// Bound: the least traffic reads each row's W (108 B in f32, 54 B in bf16 /
// f16) or Jc + r (80 B) once (147 MB of f32 W at Dubrovnik-356, 1.0 GB at
// Final-4585), plus the point operands; ~250 FMA a row for the 9x9
// products, 27 for w_op. This design adds the run partials, 2 K 4 B a run:
// at Final-4585 about one run a row, so 72 B a row for w_op and 432 B for
// the d90 products, which then bound it.
#include "cam_prod.cuh"

// W (27, n) planes in storage w_dtype; hpp_inv (npnts, 9); t (npnts, 3);
// partial (nruns, 54) scratch; out (ncams, 90).
extern "C" int ba_cam_reduce_wcw_rhs(const void* W, int w_dtype,
                                     const int* pnt_idx,
                                     const float* hpp_inv, const float* t,
                                     const BaTilePlan* plan, int ncams,
                                     long long n, float* partial, float* out,
                                     void* stream) {
  return ba_with_w_rows(W, w_dtype, n, pnt_idx, hpp_inv, t, [&](auto in) {
    return ba_launch_cam_tiles<ProdWcwRhs>(in, plan, partial, ncams, out,
                                           stream);
  });
}

// W (27, n) in storage w_dtype; op (npnts, 3); partial (nruns, 9)
// scratch; out (ncams, 9).
extern "C" int ba_cam_reduce_w_op(const void* W, int w_dtype,
                                  const int* pnt_idx, const float* op,
                                  const BaTilePlan* plan, int ncams,
                                  long long n, float* partial, float* out,
                                  void* stream) {
  return ba_with_w_rows(W, w_dtype, n, pnt_idx, op, nullptr, [&](auto in) {
    return ba_launch_cam_tiles<ProdWOp>(in, plan, partial, ncams, out,
                                        stream);
  });
}

// W (27, n) in storage w_dtype; hpp_inv (npnts, 9); partial (nruns, 45)
// scratch; out (ncams, 81).
extern "C" int ba_cam_reduce_wcw(const void* W, int w_dtype,
                                 const int* pnt_idx, const float* hpp_inv,
                                 const BaTilePlan* plan, int ncams,
                                 long long n, float* partial, float* out,
                                 void* stream) {
  return ba_with_w_rows(W, w_dtype, n, pnt_idx, hpp_inv, nullptr,
                        [&](auto in) {
                          return ba_launch_cam_tiles<ProdWcw81>(
                              in, plan, partial, ncams, out, stream);
                        });
}

// JR (26, n) point-sorted; partial (nruns, 54) scratch; out (ncams, 90).
extern "C" int ba_cam_reduce_cam90(const float* JR, const BaTilePlan* plan,
                                   int ncams, long long n, float* partial,
                                   float* out, void* stream) {
  return ba_launch_cam_tiles<ProdCam90>(
      BaRows<float>{JR, n, nullptr, nullptr, nullptr}, plan, partial, ncams,
      out, stream);
}
