// Kernel K3: the Schur coupling product over W, in two passes.
//
// Replaces the TPU kernels `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_mv_scatter_kernel` / `_mv_scatter_fac_kernel` (dispatched by
// `matvec_cam_scatter`, :1550):
//
//   t_p   = sign * Hpp_inv_p (sum_{k in p} W_k' v[cam_k] + g_p)
//   out_c = sum_{cam_k = c} W_k t[pnt_k]
//
// With g_p = 0, sign = +1 this is the W Hpp_inv W' v term of S v; with
// g_p, sign = -1, t is the back-substituted point step dp and out the
// |J d|^2 cross term's camera sums.
//
// Design: K5's point pass, then K2's W op product, launched back to back
// with no design of their own. Point pass (wtv_point.cuh): one block per
// point range of ~1024 rows, one thread per row (coalesced), the rows'
// 3-vectors summed per point in row order through shared memory; writes
// t_p (12 B a point). Camera pass (cam_prod.cuh, ba_launch_cam_tiles): one
// block per tile of 512 point-sorted rows staged in shared memory, a
// thread per run (one camera's rows within the tile) writes 9 partial
// sums, then one block per camera sums its runs in a fixed order — no
// atomics, deterministic, no bound on the camera count. Plans:
// `ops/plans.py`. The TPU kernel keeps a tile's W in VMEM between the two
// directions; here W is read once per pass.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; t, the sums and the fold are float.
//
// Bound: the least traffic reads W once (108 B a row in f32, 147 MB at
// Dubrovnik-356, n = 1,360,384; half that in bf16 / f16). The two passes
// read it twice, both coalesced, plus the camera pass's run partials
// (72 B a run; ~0.5 runs a row at Dubrovnik-356). ~54 FMA a row a pass.
#include "cam_prod.cuh"
#include "wtv_point.cuh"

// W (27, n) planes in storage w_dtype; v (ncams, 9); block_pnts
// (nblocks+1,) point ranges; plan: the K2 tiles; hpp_inv (npnts, 9); gp
// (npnts, 3) or null; t (npnts, 3) out; partial (nruns, 9) scratch; out
// (ncams, 9).
extern "C" int ba_matvec(const void* W, int w_dtype, const float* v,
                         const int* cam_idx, const int* pnt_idx,
                         const int* pnt_starts, const int* block_pnts,
                         int nblocks, const BaTilePlan* plan,
                         const float* hpp_inv, const float* gp, float sign,
                         int ncams, long long n, float* t, float* partial,
                         float* out, void* stream) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    const T* Wt = static_cast<const T*>(W);
    const int rc =
        ba_launch_wtv_point(Wt, v, cam_idx, pnt_idx, pnt_starts, block_pnts,
                            nblocks, hpp_inv, gp, sign, n, t, stream);
    if (rc != 0) return rc;
    return ba_launch_cam_tiles<ProdWOp>(
        BaRows<T>{Wt, n, pnt_idx, t, nullptr}, plan, partial, ncams, out,
        stream);
  });
}
