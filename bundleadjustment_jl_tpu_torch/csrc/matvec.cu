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
// deterministic, no bound on the camera count (K2's W op product,
// cam_prod.cuh). The TPU kernel keeps a
// tile's W in VMEM between the two directions; here W is read once per
// pass.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; t, the sums and the fold are float.
//
// Bound: streams W twice, 2 x 108 B a row = 294 MB per product at
// Dubrovnik-356 (n = 1,360,384) in f32, half that in bf16 / f16; the least
// traffic reads W once. The camera pass's loads are gathered by cam_perm.
// ~54 FMA a row.
#include "cam_prod.cuh"
#include "wtv_point.cuh"

namespace {

template <class T>
__global__ void ba_matvec_point_kernel(
    const T* __restrict__ W, const float* __restrict__ v,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_starts,
    const float* __restrict__ hpp_inv, const float* __restrict__ gp,
    float sign, int npnts, long long n, float* __restrict__ t) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npnts) return;
  ba_wtv_point(p, W, v, cam_idx, pnt_starts, hpp_inv, gp, sign, n, t);
}

}  // namespace

// W (27, n) planes in storage w_dtype; v (ncams, 9); hpp_inv (npnts, 9);
// gp (npnts, 3) or null; t (npnts, 3) out; out (ncams, 9).
extern "C" int ba_matvec(const void* W, int w_dtype, const float* v,
                         const int* cam_idx, const int* pnt_idx,
                         const int* pnt_starts, const int* cam_perm,
                         const int* cam_starts, const float* hpp_inv,
                         const float* gp, float sign, int ncams, int npnts,
                         long long n, float* t, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    const T* Wt = static_cast<const T*>(W);
    if (npnts > 0) {
      ba_matvec_point_kernel<T>
          <<<(npnts + BA_BLOCK - 1) / BA_BLOCK, BA_BLOCK, 0, s>>>(
              Wt, v, cam_idx, pnt_starts, hpp_inv, gp, sign, npnts, n, t);
      BA_RETURN_IF_LAUNCH_FAILED();
    }
    return ba_launch_cam_prod<true>(ProdWOp<T>{Wt, pnt_idx, t, n}, cam_perm,
                                    cam_starts, ncams, out, stream);
  });
}
