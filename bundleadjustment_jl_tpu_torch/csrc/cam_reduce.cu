// Kernel K2: per-camera sums of a per-row product over the POINT-sorted
// rows, read through cam_perm — four products.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_cam_scatter_kernel` as dispatched by `cam_scatter_reduce` (:1109), with
// each product it is given (``form``, ops/fused_schur.py:FORMS):
//
//   0 wcw_rhs (`_prod_wcw_rhs`): [sum W C W' (81) | sum W t (9)], C the
//           damped Hpp_inv of the row's point, t = Hpp_inv g_p: the exact
//           Schur diagonal and the reduced right-hand side in one pass
//                                                             -> (ncams, 90)
//   1 w_op  (`_prod_w_op`):   sum W op[pnt]: the reduced right-hand side,
//           the two-pass matvec's camera pass and the |J d|^2 cross term
//           when there is no camera-sorted W                  -> (ncams, 9)
//   2 wcw   (`_prod_wcw`):    sum W C W': the Schur diagonal   -> (ncams, 81)
//   3 cam90 (`_prod_cam90`):  [Jc'Jc (81) | Jc'r (9)] over JR: [Hcc | g_c]
//           of the split assembly                             -> (ncams, 90)
//
// Design (cam_pass.cuh, ba_launch_cam_pass): point-order tiles cut at
// point boundaries, staged with cp.async, walked by a fixed
// number of blocks that keep per-camera sums of their own in shared
// memory, then summed per camera in block order. Past shared memory, W op
// writes each run's sums in tile order and sums each camera's runs, and
// the 45- and 54-sum products write each row's planes as a record in tile
// order and reduce each camera's records a block a camera: in a solve
// route A's W C W' | W t only (W from K1). No solve runs cam90 here, nor
// route B1's W C W' | W t: they sum by re-deriving each row's Jc and r,
// or its W, in camera order (linearize.cu), and these records are those
// walks' references. The path is
// chosen per call from the problem's sizes (ops/plans.py:cam_pass_path). No atomics, no
// camera table, so no bound on the camera count; plan
// `ops/plans.py:TilePlan`, built once per problem.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; sums are float.
//
// Bound: the least traffic reads each row's W (108 B in f32, 54 B in bf16 /
// f16) or Jc + r (80 B) once, plus the point operands; ~250 FMA a row for
// the 9x9 products, 27 for w_op. The per-block sums add 2 G ncams K 4 B a
// call; the per-run sums 36 B a run, written and read; the records a
// 32 B-rounded record a row, written and read (64 B for bf16 W, 128 B for
// f32 W, 96 B for Jc | r), and a gather of the point operands.
#include "cam_pass.cuh"

namespace {

// f.template operator()<Prod>() for the product of ``form``.
template <class F>
int ba_with_form(int form, F&& f) {
  switch (form) {
    case 0:
      return f(ProdWcwRhs{});
    case 1:
      return f(ProdWOp{});
    case 2:
      return f(ProdWcw81{});
    case 3:
      return f(ProdCam90{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(tag) for the storage type of X: W's types, or float alone for cam90
// (JR).
template <class F>
int ba_with_x_type(int form, int x_dtype, F&& f) {
  if (form == 3) {
    if (x_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return f(static_cast<float*>(nullptr));
  }
  return ba_with_w_type(x_dtype, f);
}

}  // namespace

// X: W (27, n) in storage x_dtype (forms 0-2) or JR (26, n) float (form
// 3), point-sorted; a, b the per-point operands of the form (wcw_rhs:
// hpp_inv (npnts, 9), t (npnts, 3); w_op: op (npnts, 3); wcw: hpp_inv;
// cam90: none); path and nblocks of ops/plans.py:cam_pass_path; scratch
// the path's (nblocks, ncams, K) f32 slices, (nruns, 9) f32 partials or
// (n, record bytes) records; out (ncams, d_out).
extern "C" int ba_cam_reduce(int form, const void* X, int x_dtype,
                             const int* pnt_idx, const float* a,
                             const float* b, const BaTilePlan* plan,
                             int ncams, long long n, int path, int nblocks,
                             void* scratch, float* out, void* stream) {
  return ba_with_form(form, [&](auto prod) {
    using Prod = decltype(prod);
    return ba_with_x_type(form, x_dtype, [&](auto tag) {
      using T = BA_W_TYPE(tag);
      if constexpr (std::is_same<Prod, ProdCam90>::value &&
                    !std::is_same<T, float>::value) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        return ba_launch_cam_pass<Prod, T>(
            BaRows<T>{static_cast<const T*>(X), n, pnt_idx, a, b}, *plan,
            ncams, path, nblocks, scratch, out, stream);
      }
    });
  });
}

// Sizes of a K2 form in storage x_dtype: which 0, the dynamic shared memory
// of its stages and per-row values (the shared accumulators come on top);
// 1, the most dynamic shared memory its block pass may take on this card;
// 2, a record's bytes (0 for a form without records). -1 for an unknown
// form or storage.
extern "C" long long ba_cam_pass_bytes(int form, int x_dtype, int which) {
  long long got = -1;
  ba_with_form(form, [&](auto prod) {
    using Prod = decltype(prod);
    return ba_with_x_type(form, x_dtype, [&](auto tag) {
      using T = BA_W_TYPE(tag);
      if constexpr (std::is_same<Prod, ProdCam90>::value &&
                    !std::is_same<T, float>::value) {
        return 0;
      } else {
        if (which == 0)
          got = BaStage<Prod, T, false>::ALL;
        else if (which == 1)
          got = (long long)ba_smem_limit(
              ba_cam_pass_kernel<Prod, T, BA_EMIT_ACC>);
        else if (which == 2)
          got = Prod::K > 9 ? BaRec<Prod, T>::BYTES : 0;
        return 0;
      }
    });
  });
  return got;
}
