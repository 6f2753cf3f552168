// Kernel K4: trial objectives 1/2 |r|^2 at S trial states in one call.
//
// Replaces the TPU kernels `bundleadjustment_jl_tpu/ops/pallas_assemble.py`
// `_obj_kernel` / `_obj_fac_kernel` (dispatched by `objective_scatter`):
// objective s is evaluated at cams_all[s] = cams + scale_s dc and
// pts_all[s] = points + scale_s dp, through the forward projection chain
// (`project_chain`, chain.cuh).
//
// Design: a block per BA_OBJ_ROWS rows and scale, a constant and not the
// SM count, so the order of the sums is the same on every card; block b
// takes scale b / nblocks and row block b % nblocks (a 1-D grid: any S).
// Each thread adds its rows' 1/2 |r|^2 in turn; the block sums them in a
// fixed order (ba_block_sum) into partials[s][block], and a second pass,
// a block per scale, adds a scale's partials in a fixed order. No
// atomics: deterministic, repeats bit-identical.
//
// Each row and scale gathers its camera (nine floats at a random address)
// and rebuilds its rotation terms; that gather, paid S times, is K4's
// time on an H100. Reading the row data once for every scale, and a
// table of each camera's rotation terms per scale, measured no faster
// (PERF.md, K4).
//
// Bound: the rows once (20 B: pt2d, w, cam_idx, pnt_idx) plus S states
// (36 B a camera, 12 B a point); ~60 FLOP a row and scale.
#include "chain.cuh"

// Rows a block, chosen by measurement (`python -m
// bundleadjustment_jl_tpu_torch.tile_sweep --sweep objective`, PERF.md).
constexpr int BA_OBJ_ROWS = 1024;

static_assert(BA_OBJ_ROWS % BA_BLOCK == 0, "whole rows a thread");

namespace {

__global__ void __launch_bounds__(BA_BLOCK) ba_objective_kernel(
    const float* __restrict__ cams_all, const float* __restrict__ pts_all,
    const float2* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    int ncams, int npnts, long long n, long long nblocks,
    float* __restrict__ partials) {
  const long long s = blockIdx.x / nblocks;
  const long long r0 = (blockIdx.x - s * nblocks) * BA_OBJ_ROWS;
  const long long r1 = min(r0 + BA_OBJ_ROWS, n);
  const float* cams = cams_all + s * ncams * 9;
  const float* pts = pts_all + s * npnts * 3;
  float acc[1] = {0.f};
  for (long long row = r0 + threadIdx.x; row < r1; row += BA_BLOCK) {
    const BaCam cam = ba_load_cam(cams + 9 * (size_t)cam_idx[row]);
    const float* x = pts + 3 * (size_t)pnt_idx[row];
    const float X[3] = {x[0], x[1], x[2]};
    const float2 o = pt2d[row];
    float res[2];
    ba_project_residual(cam, X, o.x, o.y, w[row], res);
    acc[0] += 0.5f * (res[0] * res[0] + res[1] * res[1]);
  }
  ba_block_sum<1>(acc, partials + blockIdx.x);
}

}  // namespace

// Number of per-scale partial sums ba_objective writes.
extern "C" long long ba_objective_blocks(long long n) {
  return (n + BA_OBJ_ROWS - 1) / BA_OBJ_ROWS;
}

// cams_all (S, ncams, 9); pts_all (S, npnts, 3); pt2d (n, 2), 8 B aligned;
// partials (S, nblocks) scratch; out (S,).
extern "C" int ba_objective(const float* cams_all, const float* pts_all,
                            const float* pt2d, const float* w,
                            const int* cam_idx, const int* pnt_idx, int S,
                            int ncams, int npnts, long long n,
                            float* partials, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0) return 0;
  const long long nblocks = ba_objective_blocks(n);
  if (nblocks > 0) {
    ba_objective_kernel<<<(unsigned)(S * nblocks), BA_BLOCK, 0, st>>>(
        cams_all, pts_all, reinterpret_cast<const float2*>(pt2d), w,
        cam_idx, pnt_idx, ncams, npnts, n, nblocks, partials);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  ba_sum_rows_kernel<<<S, BA_BLOCK, 0, st>>>(partials, (int)nblocks, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
