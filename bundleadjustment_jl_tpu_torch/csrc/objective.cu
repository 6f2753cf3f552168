// Kernel K4: trial objectives 1/2 |r|^2 at S trial states in one launch.
//
// Replaces the TPU kernels `bundleadjustment_jl_tpu/ops/pallas_assemble.py`
// `_obj_kernel` / `_obj_fac_kernel` (dispatched by `objective_scatter`):
// objective s is evaluated at cams_all[s] = cams + scale_s dc and
// pts_all[s] = points + scale_s dp, through the forward projection chain
// (`project_chain`, chain.cuh).
//
// Design: grid (row blocks, S), one thread per row and scale; each block
// reduces its rows into one partial, and a second single-block pass per
// scale sums the partials in a fixed order (deterministic, no atomics).
//
// Bound: reads ~32 B a row of problem data plus the gathered camera and
// point (48 B, mostly cached) per scale; ~60 FLOP a row.
#include "chain.cuh"

namespace {

__global__ void ba_objective_kernel(
    const float* __restrict__ cams_all, const float* __restrict__ pts_all,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    int ncams, int npnts, long long n, float* __restrict__ partials) {
  const int s = blockIdx.y;
  const long long row = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  float acc[1] = {0.f};
  if (row < n) {
    const BaCam cam =
        ba_load_cam(cams_all + ((size_t)s * ncams + cam_idx[row]) * 9);
    const float* x = pts_all + ((size_t)s * npnts + pnt_idx[row]) * 3;
    const float X[3] = {x[0], x[1], x[2]};
    float res[2];
    ba_project_residual(cam, X, pt2d[2 * row], pt2d[2 * row + 1], w[row],
                        res);
    acc[0] = 0.5f * (res[0] * res[0] + res[1] * res[1]);
  }
  ba_block_sum<1>(acc, partials + (size_t)s * gridDim.x + blockIdx.x);
}

}  // namespace

// Number of per-scale partial sums ba_objective writes.
extern "C" long long ba_objective_blocks(long long n) {
  return (n + BA_BLOCK - 1) / BA_BLOCK;
}

// cams_all (S, ncams, 9); pts_all (S, npnts, 3); partials (S, nblocks)
// scratch; out (S,).
extern "C" int ba_objective(const float* cams_all, const float* pts_all,
                            const float* pt2d, const float* w,
                            const int* cam_idx, const int* pnt_idx, int S,
                            int ncams, int npnts, long long n,
                            float* partials, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblocks = ba_objective_blocks(n);
  ba_objective_kernel<<<dim3((unsigned)nblocks, (unsigned)S), BA_BLOCK, 0,
                        st>>>(cams_all, pts_all, pt2d, w, cam_idx, pnt_idx,
                              ncams, npnts, n, partials);
  BA_RETURN_IF_LAUNCH_FAILED();
  ba_sum_rows_kernel<<<S, BA_BLOCK, 0, st>>>(partials, (int)nblocks, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
